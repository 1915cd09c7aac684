"""Simulation state and configuration for the PyTorch port.

Counterpart of `latticeurbanwind_tpu/lbm/state.py`: the same cell-type
flags, the same `StepConfig` fields, defaults and checks, and the same
storage codecs, written on torch tensors.

Arrays are indexed [z, y, x] with x innermost (the coalesced axis on the
GPU); vector fields carry a leading component axis.  DDFs are stored in the
perturbation (DDF-shifted) form f_stored = f - w_i.  All arithmetic is fp32
whatever the storage: `f32` is exact, `bf16` and `f16` (range-shifted IEEE
half, scale 2^15) are torch dtypes, `fp16c` (the 1-4-11 custom float) is
carried as raw uint16 bit patterns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

# Cell-type bitmask (reference flag contract, defines.hpp:52-59).
TYPE_S = 0x01  # solid (bounce-back)
TYPE_E = 0x02  # equilibrium boundary (fixed rho/u)
TYPE_T = 0x04  # fixed-temperature cell
TYPE_F = 0x08  # fluid marker (informational)

FP16_SCALE = 32768.0
FP16_INV_SCALE = 1.0 / 32768.0

_STORAGE_DTYPES = {
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "fp16c": torch.uint16,   # 1-4-11 custom float carried as raw bit patterns
}


def storage_dtype(name: str) -> torch.dtype:
    return _STORAGE_DTYPES[name]


def encode_fp16c(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> FP16C (1-4-11, exp-15) bit patterns, RNE with denormals.

    Same integer formula as the JAX package's `encode_fp16c`; overflow
    saturates to the largest finite code."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = b + 0x00000800                       # round-to-nearest-even
    e = (b >> 23) & 0xFF
    m = b & 0x007FFFFF
    sgn = (b >> 16) & 0x8000
    norm = (((e - 112) << 11) & 0x7800) | (m >> 12)
    den = (((0x007FF800 + m) >> torch.clamp(124 - e, 0, 31)) + 1) >> 1
    zero = torch.zeros_like(b)
    h = sgn | torch.where(e > 112, norm, torch.where(e > 100, den, zero))
    h = torch.where(e > 127, sgn | 0x7FFF, h)
    return h.to(torch.uint16)


def decode_fp16c(x: torch.Tensor) -> torch.Tensor:
    """FP16C bit patterns -> fp32 (reference half_to_float_custom)."""
    b = x.to(torch.int32)
    e = (b >> 11) & 0xF
    m = (b & 0x7FF) << 12
    # leading-zero count of the denormal mantissa via the float32 exponent
    # of float(m)
    mf = m.to(torch.float32).view(torch.int32)
    v = (mf >> 23) & 0xFF
    sgn = (b & 0x8000) << 16
    norm = ((e + 112) << 23) | m
    den = ((v - 37) << 23) | ((m << torch.clamp(150 - v, 0, 31)) & 0x007FF000)
    zero = torch.zeros_like(b)
    bits = sgn | torch.where(e != 0, norm, torch.where(m != 0, den, zero))
    return bits.view(torch.float32)


def encode_ddf(x: torch.Tensor, storage: str) -> torch.Tensor:
    """fp32 DDF -> storage representation."""
    if storage == "f32":
        return x
    if storage == "f16":
        return (x * FP16_SCALE).to(torch.float16)
    if storage == "bf16":
        return x.to(torch.bfloat16)
    if storage == "fp16c":
        return encode_fp16c(x)
    raise ValueError(f"unknown storage {storage!r}")


def decode_ddf(x: torch.Tensor, storage: str) -> torch.Tensor:
    """storage representation -> fp32 DDF."""
    if storage == "f32":
        return x
    if storage == "f16":
        return x.to(torch.float32) * FP16_INV_SCALE
    if storage == "bf16":
        return x.to(torch.float32)
    if storage == "fp16c":
        return decode_fp16c(x)
    raise ValueError(f"unknown storage {storage!r}")


class LBMState(NamedTuple):
    """One complete lattice state. `gi`/`T` are None unless thermal."""

    fi: torch.Tensor             # (19, Z, Y, X) storage dtype, DDF-shifted
    rho: torch.Tensor            # (Z, Y, X) f32
    u: torch.Tensor              # (3, Z, Y, X) f32
    flags: torch.Tensor          # (Z, Y, X) uint8
    gi: Optional[torch.Tensor] = None   # (7, Z, Y, X) storage dtype
    T: Optional[torch.Tensor] = None    # (Z, Y, X) f32


class DynParams(NamedTuple):
    """Per-step dynamic parameters."""

    force: torch.Tensor           # (3,) global volume force (gravity), f32
    omega_coriolis: torch.Tensor  # (3,) Coriolis rotation vector, lattice units


def dyn_row(dyn: DynParams, device: torch.device | str) -> torch.Tensor:
    """(8,) f32 [fx, fy, fz, ox, oy, oz, 0, 0] on `device`: the dynamic
    parameters as the kernels read them (the Pallas kernels' dyn row)."""
    row = torch.zeros(8, dtype=torch.float32)
    row[0:3] = torch.as_tensor(dyn.force, dtype=torch.float32).cpu()
    row[3:6] = torch.as_tensor(dyn.omega_coriolis, dtype=torch.float32).cpu()
    return row.to(device)


class Forcing(NamedTuple):
    """Precomputed spatial forcing fields (buffer nudging + top sponge).

    Built once per case by `forcing.build_forcing`; None when disabled.
    """

    nudge_sigma: Optional[torch.Tensor] = None   # (Z, Y, X) f32: w_buf/tau
    nudge_face: Optional[torch.Tensor] = None    # (Z, Y, X) uint8 face id
    nudge_vertical: bool = False
    sponge_sigma_z: Optional[torch.Tensor] = None  # (Z,) f32 profile


@dataclass(frozen=True)
class StepConfig:
    """Static solver configuration (same fields and defaults as the JAX
    package's StepConfig; see there for the physics of each switch)."""

    omega: float                  # SRT relaxation rate 1/tau = 1/(3 nu + 0.5)
    collision: str = "srt"        # "srt" | "trt"
    subgrid: bool = True          # Smagorinsky-Lilly LES
    thermal: bool = False         # D3Q7 temperature sub-lattice
    omega_t: float = 1.0          # thermal relaxation rate
    beta: float = 0.0             # Boussinesq expansion coefficient (lattice)
    t_avg: float = 1.0            # reference temperature (lattice)
    storage: str = "f32"          # DDF storage codec
    equilibrium_boundaries: bool = True
    # False leaves the Guo forcing terms out: no nudge, sponge or thermal,
    # and dyn.force / dyn.omega_coriolis are ignored
    volume_force: bool = True
    wall_model: bool = False      # ground specular + Schumann stress
    wall_cd: float = 0.0
    wall_sides: bool = False      # vertical-face mirrors + side stress
    wall_cd_sides: float = 0.0

    def __post_init__(self):
        assert self.collision in ("srt", "trt")
        assert self.storage in _STORAGE_DTYPES
        if self.wall_model:
            assert self.volume_force, "wall_model needs volume_force=True"
            assert self.wall_cd > 0.0, "wall_model needs wall_cd > 0"
        if self.wall_sides:
            assert self.wall_model, "wall_sides extends wall_model"
            assert self.wall_cd_sides >= 0.0


def equilibrium_planes(rho: torch.Tensor, u: torch.Tensor):
    """Yield (d, feq_d) of the DDF-shifted D3Q19 equilibrium one direction at
    a time, in the JAX package's fp32 evaluation order (bit-identical to its
    host-side `make_initial_state`)."""
    from .lattice import C19, W19

    rhom1 = rho - 1.0
    c3 = -3.0 * (u[0] ** 2 + u[1] ** 2 + u[2] ** 2)
    for d in range(19):
        cx, cy, cz = (int(v) for v in C19[d])
        w = float(W19[d])
        if cx == 0 and cy == 0 and cz == 0:
            yield d, w * (rhom1 + rho * (0.5 * c3))
        else:
            cu = 3.0 * (cx * u[0] + cy * u[1] + cz * u[2])
            yield d, w * (rhom1 + rho * (0.5 * (cu * cu + c3) + cu))


def make_initial_state(
    shape,  # (Z, Y, X)
    *,
    config: StepConfig,
    rho: Optional[np.ndarray] = None,
    u: Optional[np.ndarray] = None,
    flags: Optional[np.ndarray] = None,
    T: Optional[np.ndarray] = None,
    device: torch.device | str = "cpu",
) -> LBMState:
    """DDFs at equilibrium from (rho, u) — the reference initialize kernel
    (kernel.cpp:1370).  The equilibria are built on `device` one direction
    at a time, so the transient footprint is one fp32 plane set."""
    if config.thermal:
        raise NotImplementedError(
            "thermal D3Q7 state is not ported yet (ROADMAP kernel item K7)")
    del T
    Z, Y, X = (int(v) for v in shape)
    dev = torch.device(device)
    rho_t = (torch.ones((Z, Y, X), dtype=torch.float32, device=dev) if rho is None
             else torch.tensor(np.asarray(rho, np.float32), device=dev))
    u_t = (torch.zeros((3, Z, Y, X), dtype=torch.float32, device=dev) if u is None
           else torch.tensor(np.asarray(u, np.float32), device=dev))
    flags_t = (torch.zeros((Z, Y, X), dtype=torch.uint8, device=dev) if flags is None
               else torch.tensor(np.asarray(flags, np.uint8), device=dev))
    scale = FP16_SCALE if config.storage == "f16" else 1.0
    fi = torch.empty((19, Z, Y, X), dtype=storage_dtype(config.storage),
                     device=dev)
    for d, feq in equilibrium_planes(rho_t, u_t):
        feq = feq * scale if scale != 1.0 else feq
        fi[d] = (encode_fp16c(feq) if config.storage == "fp16c"
                 else feq.to(fi.dtype))
    return LBMState(fi=fi, rho=rho_t, u=u_t, flags=flags_t)
