"""Domain decomposition of the lattice over devices and processes: the deck's
n_gpu split.

Counterpart of `latticeurbanwind_tpu/parallel/mesh.py` (`domain_mesh`
:56-72, `state_sharding`, `shard_state`; `ensure_distributed` :26-53 is
`parallel/comm.py`'s).  The reference splits the lattice into Dx x Dy x Dz
subdomains, one per GPU of one host, in one process (lbm.cpp:1067-1125);
the JAX package shards its arrays over a device mesh that may span hosts.
Here every shard is a separate set of tensors held by one process:

  * shard i of a (Dx, Dy, Dz) split has its own box, z0 + [0, Zl), y0 +
    [0, Yl), x0 + [0, Xl), shards numbered in (z, y, x) order as the JAX
    mesh's axes ('z', 'y', 'x').  Each axis is cut as `numpy.array_split`
    cuts it: the sizes differ by at most one and the first shards take the
    extra cells (79 planes over 4 slabs: 20, 20, 20, 19), so any grid
    splits and nothing is padded.  Neighbours along an axis share the other
    two extents, so their ghost rows and halo planes keep their shapes;
  * a split axis y or x gives the shard's arrays one ghost row or lane on
    each side (the JAX package's width 1; its 16-row y ghosts exist only for
    the TPU's y tiling); z carries no ghosts: a slab's z neighbours are the
    halo planes of `parallel/halo.py`;
  * processes (`parallel/comm.py::ensure_distributed`): the shards are
    dealt to the processes in contiguous blocks in process order, as the
    JAX mesh lays the global devices, so z slabs land across processes
    (`DomainMesh.ranks`, `.local`).  A process holds the tensors of its own
    shards only; what crosses processes goes through the mesh's
    `Transport`, and gathers go to process 0.  More processes than shards
    raise;
  * device rule (`domain_mesh`), within each process: "cuda" puts the
    process's j-th shard on its card j and needs a card per shard; "cuda:k"
    puts all of them on card k; "cpu" on the CPU.  In one process
    `run_case` takes "cuda" with fewer cards than shards as a single-device
    run (`run/sizing.py::effective_ngpu`), as the JAX package's does; over
    several processes that raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lbm.state import LBMState, raw_bits as _bits
from .comm import Transport, ensure_distributed, rank_and_size


@dataclass(frozen=True)
class DomainMesh:
    """A (Dx, Dy, Dz) split of a (Z, Y, X) grid, each shard's device and,
    over several processes, each shard's process."""

    split: Tuple[int, int, int]            # deck order (Dx, Dy, Dz)
    shape: Tuple[int, int, int]            # global (Z, Y, X)
    # per shard, (z, y, x) order; a shard of another process: the device
    # that process puts it on, as it names it
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...] = ()            # per shard its process; () all 0
    rank: int = 0                          # this process
    # moves the tensors that cross processes; None in one process
    transport: Optional[Transport] = field(default=None, compare=False,
                                           repr=False)

    def owner(self, i: int) -> int:
        """The process that holds shard i."""
        return self.ranks[i] if self.ranks else 0

    def is_local(self, i: int) -> bool:
        return self.owner(i) == self.rank

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process holds, in shard order."""
        return tuple(i for i in range(self.n) if self.is_local(i))

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.devices[i] for i in self.local)

    @property
    def processes(self) -> int:
        return max(self.ranks) + 1 if self.ranks else 1

    @property
    def counts(self) -> Tuple[int, int, int]:
        """Shards along (z, y, x)."""
        dx, dy, dz = self.split
        return dz, dy, dx

    @property
    def n(self) -> int:
        return len(self.devices)

    def edges(self, axis: int) -> Tuple[int, ...]:
        """The cuts along axis 0 (z), 1 (y) or 2 (x), numpy.array_split's:
        shard k of the axis owns [edges[k], edges[k + 1])."""
        size, count = self.shape[axis], self.counts[axis]
        q, r = divmod(size, count)
        return tuple(k * q + min(k, r) for k in range(count + 1))

    def box(self, i: int) -> Tuple[int, int, int]:
        """(Zl, Yl, Xl): the cells shard i owns along each axis."""
        return tuple(self.edges(a)[c + 1] - self.edges(a)[c]
                     for a, c in enumerate(self.coords(i)))

    @property
    def ghosts(self) -> Tuple[int, int]:
        """(gy, gx): one ghost row / lane on each side of a split axis."""
        _, ny, nx = self.counts
        return int(ny > 1), int(nx > 1)

    def local_shape(self, i: int) -> Tuple[int, int, int]:
        """Shard i's ghost-extended (Z, Y, X)."""
        (zl, yl, xl), (gy, gx) = self.box(i), self.ghosts
        return zl, yl + 2 * gy, xl + 2 * gx

    def coords(self, i: int) -> Tuple[int, int, int]:
        """(zi, yi, xi) of shard i."""
        _, ny, nx = self.counts
        return i // (ny * nx), (i // nx) % ny, i % nx

    def index(self, zi: int, yi: int, xi: int) -> int:
        nz, ny, nx = self.counts
        return ((zi % nz) * ny + yi % ny) * nx + xi % nx

    def neighbour(self, i: int, axis: int, step: int) -> int:
        """The shard `step` away along axis 0 (z), 1 (y) or 2 (x), wrapping
        at the domain's edge as the single-device kernel does."""
        c = list(self.coords(i))
        c[axis] += step
        return self.index(*c)

    def origin(self, i: int) -> Tuple[int, int, int]:
        """(z0, y0, x0) of shard i's box."""
        return tuple(self.edges(a)[c] for a, c in enumerate(self.coords(i)))

    def ghost_index(self, i: int, axis: int, edge: bool = False) -> torch.Tensor:
        """Global indices along y (axis 1) or x (axis 2) of shard i's
        ghost-extended extent: the periodic neighbours in the ghosts, or with
        `edge` the box's own edge values (the FaceBC targets' padding)."""
        size, b0, bl = self.shape[axis], self.origin(i)[axis], self.box(i)[axis]
        g = self.ghosts[axis - 1]
        idx = torch.arange(b0 - g, b0 + bl + g)
        return idx.clamp(b0, b0 + bl - 1) if edge else idx % size


class ShardedState(NamedTuple):
    """A lattice state split over a mesh: each shard's ghost-extended
    `LBMState` on its device, in the mesh's shard order; None in the place
    of a shard another process holds."""

    mesh: DomainMesh
    shards: Tuple[Optional[LBMState], ...]

    def local(self) -> LBMState:
        """The first shard this process holds."""
        return self.shards[self.mesh.local[0]]


def domain_mesh(split, shape, device: torch.device | str = "cuda") -> DomainMesh:
    """The mesh of the deck's [Dx, Dy, Dz] split over the (Z, Y, X) grid.
    It joins the run's processes first (`ensure_distributed`) and deals the
    shards to them in contiguous blocks in process order.  Device rule,
    within a process: "cuda" (no index) puts its j-th shard on card j and
    needs a card per shard; "cuda:k" puts its shards on card k; "cpu" on
    the CPU.  Any split of a grid with at least one cell per shard along
    each axis: a split that does not divide the grid gives shards of sizes
    one apart (`DomainMesh.edges`)."""
    dx, dy, dz = (int(v) for v in split)
    Z, Y, X = (int(v) for v in shape)
    if min(dx, dy, dz) < 1 or Z < dz or Y < dy or X < dx:
        raise ValueError(f"grid {X}x{Y}x{Z} (X x Y x Z) cannot be split "
                         f"n_gpu=[{dx}, {dy}, {dz}]: a shard needs a cell "
                         "along each axis")
    n = dx * dy * dz
    ensure_distributed()
    rank, size = rank_and_size()
    if size > n:
        raise ValueError(f"{size} processes for n_gpu=[{dx}, {dy}, {dz}]: "
                         f"{n} shards, and every process needs one")
    ranks = tuple(int(r) for r, part in enumerate(np.array_split(np.arange(n), size))
                  for _ in part)
    first = {r: ranks.index(r) for r in range(size)}   # each process's first shard
    mine = ranks.count(rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count < mine:
            where = "" if size == 1 else f" in process {rank} ({mine} shards)"
            raise ValueError(f"n_gpu=[{dx}, {dy}, {dz}] on \"cuda\" needs "
                             f"{mine} cards{where}, {count} visible")
        devices = tuple(torch.device("cuda", i - first[ranks[i]])
                        for i in range(n))
    else:
        devices = (dev,) * n
    local = [devices[i] for i in range(n) if ranks[i] == rank]
    return DomainMesh(split=(dx, dy, dz), shape=(Z, Y, X), devices=devices,
                      ranks=ranks if size > 1 else (), rank=rank,
                      transport=Transport(local) if size > 1 else None)


def move_between_shards(mesh: DomainMesh, stage: str, pairs) -> None:
    """Copy each pair's source into its destination, `pairs` being every
    (source shard, destination shard, source fn, destination fn) of one
    stage in the same order in every process; a fn gives its shard's tensor
    and is called only where that shard is held.  In one process: one
    `copy_` each; across processes: the mesh's `Transport`."""
    if mesh.transport is None:
        for _, _, src, dst in pairs:
            dst().copy_(src())
        return
    items = []
    for s, d, src, dst in pairs:
        here_s, here_d = mesh.is_local(s), mesh.is_local(d)
        if here_s or here_d:
            items.append((mesh.owner(s), mesh.owner(d),
                          src() if here_s else None, dst() if here_d else None))
    mesh.transport.move(stage, items)


def shard_tensor(a: torch.Tensor, mesh: DomainMesh, i: int) -> torch.Tensor:
    """Shard i's ghost-extended part of a global (..., Z, Y, X) tensor, on
    its device, its ghosts filled from the periodic neighbours."""
    z0 = mesh.origin(i)[0]
    zl = mesh.box(i)[0]
    src = _bits(a)[..., z0:z0 + zl, :, :]
    iy = mesh.ghost_index(i, 1).to(a.device)
    ix = mesh.ghost_index(i, 2).to(a.device)
    part = src.index_select(-2, iy).index_select(-1, ix)
    return part.to(mesh.devices[i]).view(a.dtype)


def shard_state(state: LBMState, mesh: DomainMesh) -> ShardedState:
    """Split a global state (on the host or one device) into the mesh's
    ghost-extended shards, each on its device; this process's shards only
    (the others None)."""
    shards = []
    for i in range(mesh.n):
        shards.append(LBMState(*(None if a is None else shard_tensor(a, mesh, i)
                                 for a in state)) if mesh.is_local(i) else None)
    return ShardedState(mesh=mesh, shards=tuple(shards))


def interior(a: torch.Tensor, mesh: DomainMesh, i: int) -> torch.Tensor:
    """The view of shard i's tensor (..., Z, Y, X) without its ghosts."""
    (_, yl, xl), (gy, gx) = mesh.box(i), mesh.ghosts
    return a[..., gy:gy + yl, gx:gx + xl]


def gather_tensors(parts, mesh: DomainMesh,
                   device: torch.device | str = "cpu") -> Optional[torch.Tensor]:
    """One global (..., Z, Y, X) tensor on `device` from the shards' parts
    (None for another process's shard), their ghosts stripped: in process
    0; None in the others.  A part of another process crosses on its own,
    so no more than one shard is in flight."""
    first = parts[mesh.local[0]]
    out = None
    if mesh.rank == 0:
        out = torch.empty((*first.shape[:-3], *mesh.shape),
                          dtype=_bits(first).dtype, device=device)

    def box(i):
        (z0, y0, x0), (zl, yl, xl) = mesh.origin(i), mesh.box(i)
        return out[..., z0:z0 + zl, y0:y0 + yl, x0:x0 + xl]

    for i, p in enumerate(parts):
        if mesh.owner(i) == 0:
            if mesh.rank == 0:
                box(i).copy_(interior(_bits(p), mesh, i))
            continue
        here = mesh.is_local(i)
        if here or mesh.rank == 0:
            mesh.transport.move("gather", [(
                mesh.owner(i), 0,
                interior(_bits(p), mesh, i) if here else None,
                box(i) if mesh.rank == 0 else None)], cache=False)
    return None if out is None else out.view(first.dtype)


def gather_state(sstate: ShardedState,
                 device: torch.device | str = "cpu") -> Optional[LBMState]:
    """The global state on `device` (the host by default), ghosts stripped:
    in process 0; None in the others."""
    mesh = sstate.mesh
    fields = []
    for k in range(len(LBMState._fields)):
        parts = [None if s is None else s[k] for s in sstate.shards]
        fields.append(None if parts[mesh.local[0]] is None
                      else gather_tensors(parts, mesh, device))
    return LBMState(*fields) if mesh.rank == 0 else None


def column_reader(mesh: DomainMesh, ys: Sequence[int], xs: Sequence[int]
                  ) -> Callable[[ShardedState], Optional[np.ndarray]]:
    """A function of a `ShardedState` of `mesh` giving the (3, Z, P) u
    columns at the global (ys[p], xs[p]) on the host: each column read from
    the shards that own it (one per z slab), never from a gathered field;
    one indexed readback per shard that holds a column.  Over several
    processes the columns go to process 0 (one gather of the (3, Z, P)
    array over the control group); the others get None."""
    gy, gx = mesh.ghosts
    ey, ex, ez = mesh.edges(1), mesh.edges(2), mesh.edges(0)
    # shard column (yi, xi) -> the column numbers it owns
    owners: Dict[Tuple[int, int], list] = {}
    for k, (y, x) in enumerate(zip(ys, xs)):
        yi = int(np.searchsorted(ey, y, side="right")) - 1
        xi = int(np.searchsorted(ex, x, side="right")) - 1
        owners.setdefault((yi, xi), []).append(k)
    plan = []
    for (yi, xi), ks in owners.items():
        for zi in range(mesh.counts[0]):
            i = mesh.index(zi, yi, xi)
            ly = lx = None
            if mesh.is_local(i):
                dev = mesh.devices[i]
                ly = torch.tensor([ys[k] - ey[yi] + gy for k in ks], device=dev)
                lx = torch.tensor([xs[k] - ex[xi] + gx for k in ks], device=dev)
            plan.append((i, slice(ez[zi], ez[zi + 1]), ks, ly, lx))

    def read(sstate: ShardedState) -> Optional[np.ndarray]:
        out = np.zeros((3, mesh.shape[0], len(ys)), np.float32)
        for i, zs, ks, ly, lx in plan:
            if ly is not None:
                out[:, zs, ks] = sstate.shards[i].u[:, :, ly, lx].cpu().numpy()
        if mesh.transport is None:
            return out
        mine = torch.from_numpy(out)
        every = ([torch.empty_like(mine) for _ in range(mesh.processes)]
                 if mesh.rank == 0 else None)
        torch.distributed.gather(mine, every, dst=0)
        if mesh.rank:
            return None
        for i, zs, ks, _, _ in plan:
            out[:, zs, ks] = every[mesh.owner(i)].numpy()[:, zs, ks]
        return out

    return read


def sync(devices) -> None:
    """Wait for every CUDA device among `devices`."""
    for dev in sorted({d for d in devices if d.type == "cuda"},
                      key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)
