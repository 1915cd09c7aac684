"""Fused moments + Welford averaging pass: the CUDA kernel K-AVG and its plain
version.

Counterpart of `latticeurbanwind_tpu/ops/avg_kernel.py::make_avg_update`
(one launch per averaging sample).  One pass reproduces the moments of
`lbm.fields.update_fields` and updates the Welford accumulators in place,
with `inv_n = 1/(n+1)` computed by the caller.  Solid cells hold their
accumulators (`update_fields` + `welford_update` would re-accumulate the
stale value there; outputs mask solids either way).

`avg_update` is the entry point: CPU tensors run `avg_update_plain`, CUDA
tensors launch `csrc/avg_update.cu` or raise.
"""

from __future__ import annotations

import torch

from ..lbm.fields import field_moments
from ..lbm.state import StepConfig, TYPE_S, storage_dtype
from ..run.welford import AvgState
from .stream_collide import _STORAGE_CODE, _check_tensor


def check_config(config: StepConfig) -> None:
    if config.thermal or config.wall_model or config.wall_sides:
        raise NotImplementedError(
            "the averaging pass is ported for non-thermal configurations "
            "without the wall models (ROADMAP kernel items K4 and K7)")
    if config.storage not in _STORAGE_CODE:
        raise NotImplementedError(
            f"{config.storage} storage is not ported yet (ROADMAP kernel "
            "item K5, the f16/fp16c codecs)")


def avg_update_plain(fi: torch.Tensor, flags: torch.Tensor, dyn: torch.Tensor,
                     inv_n: float, avg: AvgState, storage: str) -> None:
    """Plain torch: the fields pass + one Welford step, in place."""
    rho, u = field_moments(fi, flags, dyn, storage)
    solid = (flags & TYPE_S) != 0
    delta = torch.where(solid, 0.0, u - avg.mean_u)
    avg.mean_u.add_(delta * inv_n)
    avg.m2_u.add_((delta * (u - avg.mean_u)).sum(dim=0))
    avg.mean_rho.add_(torch.where(solid, 0.0, rho - avg.mean_rho) * inv_n)


def avg_update(fi: torch.Tensor, flags: torch.Tensor, dyn: torch.Tensor,
               inv_n: float, avg: AvgState, config: StepConfig) -> AvgState:
    """One averaging sample from the DDFs `fi`; updates `avg`'s tensors in
    place and returns it with the count advanced.  CUDA launches count in
    `avg_update.launches`."""
    check_config(config)
    if fi.device.type == "cpu":
        avg_update_plain(fi, flags, dyn, inv_n, avg, config.storage)
        return avg._replace(count=avg.count + 1)
    if fi.device.type != "cuda":
        raise NotImplementedError(f"no averaging kernel for {fi.device}")

    dev = fi.device
    Z, Y, X = (int(v) for v in flags.shape)
    _check_tensor("fi", fi, storage_dtype(config.storage), (19, Z, Y, X), dev)
    _check_tensor("flags", flags, torch.uint8, (Z, Y, X), dev)
    _check_tensor("dyn", dyn, torch.float32, (8,), dev)
    _check_tensor("mean_u", avg.mean_u, torch.float32, (3, Z, Y, X), dev)
    _check_tensor("m2_u", avg.m2_u, torch.float32, (Z, Y, X), dev)
    _check_tensor("mean_rho", avg.mean_rho, torch.float32, (Z, Y, X), dev)

    from ..utils.cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.luw_avg_update(
            fi.data_ptr(), flags.data_ptr(), dyn.data_ptr(), float(inv_n),
            avg.mean_u.data_ptr(), avg.m2_u.data_ptr(), avg.mean_rho.data_ptr(),
            Z, Y, X, _STORAGE_CODE[config.storage], stream)
    if rc != 0:
        raise RuntimeError(f"luw_avg_update launch failed: CUDA error {rc}")
    avg_update.launches += 1
    return avg._replace(count=avg.count + 1)


avg_update.launches = 0
