"""Solver checkpoint/resume, in the JAX package's v2 file format.

Counterpart of `latticeurbanwind_tpu/run/checkpoint.py` (a capability the
reference lacks: a killed run restarts from step 0).  The file is the same
`np.savez_compressed` archive, so either package reads the other's:

  * entries `fi`, `rho`, `u`, `flags`, `gi`/`T` (thermal), `fbc_<face>`
    (the runner's carried FaceBC), `avg_mean_u`, `avg_m2_u`,
    `avg_mean_rho`[, `avg_mean_T`], `avg_count`, `probe<i>_times` /
    `probe<i>_series`, and `header`: the JSON of `version`, `step`,
    `avg_samples`, `thermal`, `shape`, `n_probes`, `n_processes`,
    `global_shapes`, `dtypes` and `meta`;
  * bf16 arrays are stored as raw 2-byte voids (`V2`) under the dtype name
    "bfloat16", as numpy stores the JAX package's; fp16c is `uint16` and
    f16 numpy's `float16`.  The loader views them back without ml_dtypes;
  * a state split over a mesh (`parallel.mesh.ShardedState`) is saved as
    one block per shard, `<name>@<starts>`: the shard's box without its
    ghosts at its offset in the global array (`DomainMesh.origin`), with no
    gathered copy; the per-shard accumulators likewise.  One process writes
    the file (`n_processes` 1): the multi-host writer is not ported.

Loading reads the per-process sibling files of a JAX multi-host save and
refuses a torn one, assembles the global arrays and returns them as host
(CPU) tensors; the driver places them on the run's device or splits them
over its current mesh, so a checkpoint written under one split resumes
under any other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lbm.state import LBMState
from ..ops.stream_collide import FaceBC
from ..parallel.mesh import ShardedState, interior
from .welford import AvgState

FORMAT_VERSION = 2

_FBC_FIELDS = ("uw", "ue", "us", "un", "ut", "ub", "tt")
_SHARD_SEP = "@"   # shard block key: "<name>@<start0>_<start1>_..."
_BF16 = "bfloat16"


def checkpoint_path(parent: Path, datetime_tag: str, prefix: str = "") -> Path:
    return (Path(parent) / "proj_temp" / "checkpoints"
            / f"{prefix}{datetime_tag}.ckpt.npz")


def _sibling_path(path: Path, process_index: int,
                  step: Optional[int] = None) -> Path:
    """Per-process shard file of a JAX multi-host save: step-tagged
    (`.p<k>.s<step>.npz`), or the legacy untagged `.p<k>.npz`."""
    tag = "" if step is None else f".s{int(step)}"
    return path.with_name(f"{path.name}.p{process_index}{tag}.npz")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(contiguous host array as stored, true dtype name) of a tensor; the
    2-byte codes go through int16, which every backend copies."""
    if t.dtype in (torch.bfloat16, torch.uint16):
        a = t.view(torch.int16).contiguous().cpu().numpy()
        if t.dtype == torch.bfloat16:
            return a.view(np.dtype("V2")), _BF16
        return a.view(np.uint16), "uint16"
    a = t.contiguous().cpu().numpy()
    return a, a.dtype.name


def _restore_dtype(arr: np.ndarray, dtype_name: Optional[str]) -> np.ndarray:
    """Undo npz's void-byte storage of bf16: its 16-bit codes as int16."""
    if dtype_name == _BF16:
        return arr.view(np.int16)
    return arr


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A host tensor of the array's true dtype (bf16 from its int16 codes,
    fp16c uint16 through int16)."""
    if dtype_name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    if arr.dtype == np.uint16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.uint16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save_checkpoint(path: Path, state, *, step: int,
                    avg=None, avg_samples: int = 0,
                    probes: Optional[list] = None,
                    meta: Optional[dict] = None,
                    fbc: Optional[FaceBC] = None) -> Path:
    """Write the run at `step` to `path`.

    `state` is an `LBMState` or a `ShardedState`; under a mesh `avg` is the
    tuple of per-shard `AvgState`s (ghosts included; only the boxes are
    saved), else one `AvgState`.  `fbc`: the runner's carried FaceBC (the
    nudge/sponge face targets the VK inlet refreshes), so that a resumed
    VK run continues bit-exactly."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    mesh = state.mesh if isinstance(state, ShardedState) else None

    arrays: Dict[str, object] = {}
    for name in ("fi", "rho", "u", "flags"):
        arrays[name] = (getattr(state, name) if mesh is None
                        else [getattr(s, name) for s in state.shards])
    if fbc is not None:
        for k in _FBC_FIELDS:
            v = getattr(fbc, k)
            if v is not None:
                arrays[f"fbc_{k}"] = v
    thermal = (state.gi if mesh is None else state.shards[0].gi) is not None
    if thermal:
        for name in ("gi", "T"):
            arrays[name] = (getattr(state, name) if mesh is None
                            else [getattr(s, name) for s in state.shards])
    if avg is not None:
        avgs = [avg] if mesh is None else list(avg)
        for name, key in (("avg_mean_u", "mean_u"), ("avg_m2_u", "m2_u"),
                          ("avg_mean_rho", "mean_rho"),
                          ("avg_mean_T", "mean_T")):
            parts = [getattr(a, key) for a in avgs]
            if parts[0] is not None:
                arrays[name] = parts[0] if mesh is None else parts

    payload: Dict[str, np.ndarray] = {}
    global_shapes: Dict[str, list] = {}
    dtypes: Dict[str, str] = {}
    for name, v in arrays.items():
        if isinstance(v, list):                 # one block per shard
            lead = tuple(v[0].shape[:-3])
            global_shapes[name] = [*lead, *mesh.shape]
            for i, part in enumerate(v):
                a, dtypes[name] = _to_numpy(interior(part, mesh, i))
                starts = "_".join(str(s) for s in (0,) * len(lead)
                                  + tuple(mesh.origin(i)))
                payload[f"{name}{_SHARD_SEP}{starts}"] = a
        else:
            payload[name], dtypes[name] = _to_numpy(v)

    if avg is not None:
        payload["avg_count"] = np.asarray(int(avgs[0].count))
    n_probes = 0
    if probes:
        for i, p in enumerate(probes):
            payload[f"probe{i}_times"] = np.asarray(p.times_si, dtype=np.float64)
            payload[f"probe{i}_series"] = (
                np.stack(p.series) if p.series
                else np.zeros((0, len(p.heights_si), 3), dtype=np.float64))
        n_probes = len(probes)

    header = {
        "version": FORMAT_VERSION,
        "step": int(step),
        "avg_samples": int(avg_samples),
        "thermal": thermal,
        "shape": list(mesh.shape if mesh is not None else state.rho.shape),
        "n_probes": n_probes,
        "n_processes": 1,
        "global_shapes": global_shapes,
        "dtypes": dtypes,
        "meta": meta or {},
    }
    payload["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **payload)
    tmp.replace(path)
    return path


def _read_header(z) -> dict:
    return json.loads(bytes(z["header"].tobytes()).decode())


def _assemble(path: Path, z, header: dict, want=None) -> Dict[str, np.ndarray]:
    """Read `want` (or all) array entries of a checkpoint: plain keys as
    they are, shard blocks placed into global buffers at their offset keys;
    a multi-host save's sibling files merged in.  bf16 entries come back as
    their int16 codes."""
    gshapes = header.get("global_shapes") or {}
    dtypes = header.get("dtypes") or {}

    def wanted(name: str) -> bool:
        return want is None or name in want

    out: Dict[str, np.ndarray] = {}

    def take(zf) -> None:
        for key in zf.files:
            if key == "header":
                continue
            name, sep, starts = key.partition(_SHARD_SEP)
            if not wanted(name):
                continue
            if not sep:                      # plain entry
                out[name] = _restore_dtype(zf[key], dtypes.get(name))
                continue
            block = _restore_dtype(zf[key], dtypes.get(name))
            if name not in out:
                out[name] = np.empty(tuple(gshapes[name]), dtype=block.dtype)
            idx = tuple(slice(int(s), int(s) + n)
                        for s, n in zip(starts.split("_"), block.shape))
            out[name][idx] = block

    take(z)
    for i in range(1, int(header.get("n_processes") or 1)):
        # step-tagged sibling (the JAX package's save protocol) first, then
        # the legacy untagged name
        sib = _sibling_path(path, i, int(header.get("step", -1)))
        if not sib.exists():
            sib = _sibling_path(path, i)
        if not sib.exists():
            raise ValueError(f"checkpoint shard file missing: {sib} "
                             "(incomplete multi-host save?)")
        with np.load(sib) as zs:
            if "header" in zs.files:
                sh = _read_header(zs)
                if int(sh.get("step", -1)) != int(header.get("step", -1)):
                    raise ValueError(
                        f"checkpoint shard file {sib} is from step "
                        f"{sh.get('step')} but the main file is step "
                        f"{header.get('step')} — torn multi-host save "
                        "(rank 0 died before rewriting the main file?)")
            take(zs)
    return out


def load_checkpoint(path: Path, *, expect_shape=None,
                    probes: Optional[Sequence] = None,
                    ) -> Tuple[LBMState, int, Optional[AvgState], int, dict]:
    """Returns (state, step, avg_or_None, avg_samples, meta).

    `expect_shape`: the case's grid (Z, Y, X); a checkpoint of another grid
    raises ValueError.  `probes`: GridProbes to refill with the saved
    sample buffers.  Tensors come back on the host whatever mesh they were
    saved under; the caller places them."""
    path = Path(path)
    with np.load(path) as z:
        header = _read_header(z)
        if header.get("version") not in (1, FORMAT_VERSION):
            raise ValueError(
                f"unsupported checkpoint version: {header.get('version')}")
        saved_shape = tuple(header.get("shape") or z["rho"].shape)
        if expect_shape is not None and tuple(expect_shape) != saved_shape:
            raise ValueError(
                f"checkpoint grid {saved_shape} does not match case grid "
                f"{tuple(expect_shape)} — the deck changed since the save")
        arrs = _assemble(path, z, header)
    dtypes = header.get("dtypes") or {}

    def t(name):
        return _to_tensor(arrs[name], dtypes.get(name))

    thermal = header["thermal"]
    state = LBMState(fi=t("fi"), rho=t("rho"), u=t("u"), flags=t("flags"),
                     gi=t("gi") if thermal else None,
                     T=t("T") if thermal else None)
    avg = None
    if "avg_count" in arrs:
        m2 = arrs["avg_m2_u"]
        if m2.ndim == 4:       # pre-trace format stored per-component M2
            m2 = m2.sum(axis=0)
        avg = AvgState(
            count=int(arrs["avg_count"]),
            mean_u=t("avg_mean_u"),
            m2_u=_to_tensor(m2, None),
            mean_rho=t("avg_mean_rho"),
            mean_T=t("avg_mean_T") if "avg_mean_T" in arrs else None)
    if probes is not None and header.get("n_probes"):
        n = min(len(probes), int(header["n_probes"]))
        for i in range(n):
            p = probes[i]
            p.times_si = list(arrs[f"probe{i}_times"])
            p.series = [s for s in arrs[f"probe{i}_series"]]
    return state, header["step"], avg, header["avg_samples"], header["meta"]


def load_fbc(path: Path) -> Optional[FaceBC]:
    """The saved FaceBC carried targets as host tensors, or None if absent."""
    path = Path(path)
    want = {f"fbc_{k}" for k in _FBC_FIELDS}
    with np.load(path) as z:
        header = _read_header(z)
        arrs = _assemble(path, z, header, want=want)
    if "fbc_uw" not in arrs:
        return None
    return FaceBC(**{k: (_to_tensor(arrs[f"fbc_{k}"], None)
                         if f"fbc_{k}" in arrs else None)
                     for k in _FBC_FIELDS})
