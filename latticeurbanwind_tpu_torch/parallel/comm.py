"""Several processes: their set-up and the transport of tensors between them.

Counterpart of `latticeurbanwind_tpu/parallel/mesh.py::ensure_distributed`
(:26-53).  The JAX package joins several hosts through `jax.distributed`
and lets XLA move the halos; here the processes join a `torch.distributed`
group and `Transport` moves each stage's tensors between them:

  * the environment contract is the JAX package's: `LUW_COORDINATOR` (or
    `COORDINATOR_ADDRESS`) as `host:port`, `LUW_NUM_PROCESSES` and
    `LUW_PROCESS_ID` (default 0).  torch cannot ask a cluster for the
    process count, so a coordinator without `LUW_NUM_PROCESSES` raises;
  * the default group is gloo over TCP, the control group: barriers and
    small objects.  Every call on it, and the set-up itself, fails after
    `LUW_DIST_TIMEOUT` seconds (default 600) instead of hanging on a dead
    peer;
  * the data backend is chosen once per mesh, from its devices: NCCL when
    every shard is on a card and no two processes' shards share a physical
    card (the cards' UUIDs are compared over the control group), else gloo
    through host buffers (CPU shards, or processes sharing one card, which
    NCCL refuses).  A NCCL failure raises: gloo is never taken in its place.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# one pair of a stage: (source rank, destination rank, the source tensor on
# its rank else None, the destination tensor on its rank else None)
Pair = Tuple[int, int, Optional[torch.Tensor], Optional[torch.Tensor]]
_ALIGN = 16             # bytes: each tensor's place in a packed buffer


def ensure_distributed() -> bool:
    """Join the processes of a run when the coordination environment is set
    (`LUW_COORDINATOR` or `COORDINATOR_ADDRESS`, `LUW_NUM_PROCESSES`,
    `LUW_PROCESS_ID`); idempotent; without the environment it touches
    nothing.  True when the run spans several processes.  The groups are
    destroyed at exit: one left to the interpreter's teardown can abort
    the process ("terminate called without an active exception") after
    its work is done."""
    coord = os.environ.get("LUW_COORDINATOR") or os.environ.get(
        "COORDINATOR_ADDRESS")
    if not coord:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    count = os.environ.get("LUW_NUM_PROCESSES")
    if not count:
        raise ValueError(
            f"coordinator {coord} is set but LUW_NUM_PROCESSES is not: torch "
            "cannot ask the cluster for the process count")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coord}",
        world_size=int(count), rank=int(os.environ.get("LUW_PROCESS_ID", "0")),
        timeout=timedelta(seconds=timeout_s()))
    atexit.register(_leave)
    return dist.get_world_size() > 1


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
        _NCCL_GROUP.clear()


def timeout_s() -> float:
    return float(os.environ.get("LUW_DIST_TIMEOUT") or DEFAULT_TIMEOUT_S)


def rank_and_size() -> Tuple[int, int]:
    """(this process's rank, the process count); (0, 1) alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every process of the run (nothing alone)."""
    if rank_and_size()[1] > 1:
        dist.barrier()


def all_gather_object(obj) -> list:
    """Every process's `obj`, in rank order ([obj] alone)."""
    size = rank_and_size()[1]
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


_NCCL_GROUP: Dict[str, object] = {}


def _nccl_group(device: torch.device):
    """The NCCL group of every process, made once and warmed up by one
    collective (every rank's first NCCL call must be collective)."""
    if "group" not in _NCCL_GROUP:
        torch.cuda.set_device(device)
        group = dist.new_group(backend="nccl")
        one = torch.ones(1, device=device)
        dist.all_reduce(one, group=group)
        if int(one.item()) != dist.get_world_size():
            raise RuntimeError(f"NCCL all_reduce gave {one.item()}")
        _NCCL_GROUP["group"] = group
    return _NCCL_GROUP["group"]


def data_backend(local_devices: Sequence[torch.device]) -> str:
    """"nccl" when every process's shards are on cards and no card holds
    shards of two processes, else "gloo" (a collective call)."""
    cuda = all(d.type == "cuda" for d in local_devices)
    cards = sorted({str(torch.cuda.get_device_properties(d).uuid)
                    for d in local_devices}) if cuda else None
    every = all_gather_object(cards)
    if any(c is None for c in every):
        return "gloo"
    flat = [u for c in every for u in c]
    return "nccl" if len(flat) == len(set(flat)) else "gloo"


def _layout(tensors) -> Tuple[List[int], int]:
    """Each tensor's byte offset in a packed buffer, and its size."""
    offsets, size = [], 0
    for t in tensors:
        offsets.append(size)
        size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offsets, size


def _view(buf: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    """The part of a packed byte buffer that holds `like`, as `like`."""
    n = like.numel() * like.element_size()
    return buf[offset:offset + n].view(like.dtype).view(like.shape)


class Transport:
    """Moves the tensors of one stage between the processes of a mesh.

    `move(stage, pairs)` takes every pair of the stage in the same order in
    every process (`Pair`).  A pair inside this process is one `copy_`.
    The pairs that cross processes are packed per peer, in that order, into
    one byte buffer each way, and the stage's buffers go as one
    `dist.batch_isend_irecv`: one message per peer and direction, so no two
    messages between two processes are in flight at once.  Buffers live
    where the backend reads them: with NCCL on this process's first card
    (one device per rank), with gloo on the host (pinned for CUDA tensors;
    the cards' streams are synchronised before the batch reads them).
    `staged_bytes` counts the bytes that went through host buffers (each
    D2H and H2D copy), for measurement."""

    def __init__(self, local_devices: Sequence[torch.device]):
        self.rank = rank_and_size()[0]
        self.home = local_devices[0]
        self.backend = data_backend(local_devices)
        self.group = (_nccl_group(self.home) if self.backend == "nccl"
                      else None)
        self.buffers: Dict[Tuple[str, int, str], torch.Tensor] = {}
        self.staged_bytes = 0

    def _buffer(self, key, size: int, cuda: bool, cache: bool) -> torch.Tensor:
        buf = self.buffers.get(key) if cache else None
        if buf is None or buf.numel() != size:
            if self.backend == "nccl":
                buf = torch.empty(size, dtype=torch.uint8, device=self.home)
            else:
                buf = torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
            if cache:
                self.buffers[key] = buf
        return buf

    def move(self, stage: str, pairs: Sequence[Pair], *, cache: bool = True) -> None:
        sends: Dict[int, list] = {}
        recvs: Dict[int, list] = {}
        for src_rank, dst_rank, src, dst in pairs:
            if src_rank == dst_rank:
                if src_rank == self.rank:
                    dst.copy_(src)
            elif src_rank == self.rank:
                sends.setdefault(dst_rank, []).append(src)
            elif dst_rank == self.rank:
                recvs.setdefault(src_rank, []).append(dst)
        if not sends and not recvs:
            return
        gloo = self.backend == "gloo"
        ops: List[dist.P2POp] = []
        synced = set()
        for peer, srcs in sorted(sends.items()):
            offsets, size = _layout(srcs)
            cuda = any(t.device.type == "cuda" for t in srcs)
            buf = self._buffer((stage, peer, "send"), size, cuda, cache)
            for off, t in zip(offsets, srcs):
                _view(buf, off, t).copy_(t, non_blocking=True)
                if gloo and t.device.type == "cuda":
                    self.staged_bytes += t.numel() * t.element_size()
                    synced.add(t.device)
            ops.append(dist.P2POp(dist.isend, buf, peer, group=self.group))
        landing = []
        for peer, dsts in sorted(recvs.items()):
            offsets, size = _layout(dsts)
            cuda = any(t.device.type == "cuda" for t in dsts)
            buf = self._buffer((stage, peer, "recv"), size, cuda, cache)
            if gloo:
                # the last H2D copies out of this buffer must be done
                synced.update(t.device for t in dsts if t.device.type == "cuda")
            landing.append((buf, offsets, dsts))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=self.group))
        for dev in synced:
            torch.cuda.current_stream(dev).synchronize()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for buf, offsets, dsts in landing:
            for off, t in zip(offsets, dsts):
                t.copy_(_view(buf, off, t), non_blocking=True)
                if gloo and t.device.type == "cuda":
                    self.staged_bytes += t.numel() * t.element_size()
