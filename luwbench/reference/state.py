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
    # the control's storage: the 8-bit float below bf16 (never the program's)
    "fp8": torch.float8_e4m3fn,
}


def storage_dtype(name: str) -> torch.dtype:
    return _STORAGE_DTYPES[name]


def encode_fp16c(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> FP16C (1-4-11, exp-15) bit patterns, RNE with denormals.

    Same integer formula as the JAX package's `encode_fp16c`; overflow
    saturates to the largest finite code.  NaN (any payload) saturates to
    sign | 0x7FFF, the Pallas kernel codec's side: the bare formula would
    wrap payloads at or above 0x7FFFF800 to a signed zero.  The device codec
    (csrc/codec.cuh) computes the same bits.  The bit patterns go through
    int16 (the integer type every backend supports) and come back as uint16.
    """
    b0 = x.to(torch.float32).contiguous().view(torch.int32)
    b = b0 + 0x00000800                      # round-to-nearest-even
    e = (b >> 23) & 0xFF
    m = b & 0x007FFFFF
    sgn = (b >> 16) & 0x8000
    norm = (((e - 112) << 11) & 0x7800) | (m >> 12)
    den = (((0x007FF800 + m) >> torch.clamp(124 - e, 0, 31)) + 1) >> 1
    zero = torch.zeros_like(b)
    h = sgn | torch.where(e > 112, norm, torch.where(e > 100, den, zero))
    h = torch.where(e > 127, sgn | 0x7FFF, h)
    h = torch.where((b0 & 0x7F800000) == 0x7F800000,
                    ((b0 >> 16) & 0x8000) | 0x7FFF, h)
    return h.to(torch.int16).view(torch.uint16)


def decode_fp16c(x: torch.Tensor) -> torch.Tensor:
    """FP16C bit patterns -> fp32 (reference half_to_float_custom)."""
    b = x.view(torch.int16).to(torch.int32) & 0xFFFF
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


def raw_bits(t: torch.Tensor) -> torch.Tensor:
    """fp16c bit patterns as int16 (selects, copies and indexing of uint16
    tensors are not supported on every backend); other storages as they
    are."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.int8)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def to_device(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """An exact copy of `t` on `device` (fp16c codes through int16); None
    and non-tensors pass through."""
    if not isinstance(t, torch.Tensor):
        return t
    return raw_bits(t).to(device).view(t.dtype)


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
    if storage == "fp8":
        return x.to(torch.float8_e4m3fn)
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
    if storage == "fp8":
        return x.to(torch.float32)
    raise ValueError(f"unknown storage {storage!r}")


class LBMState(NamedTuple):
    """One complete lattice state. `gi`/`T` are None unless thermal."""

    fi: torch.Tensor             # (19, Z, Y, X) storage dtype, DDF-shifted
    rho: torch.Tensor            # (Z, Y, X) f32
    u: torch.Tensor              # (3, Z, Y, X) f32
    flags: torch.Tensor          # (Z, Y, X) uint8
    gi: Optional[torch.Tensor] = None   # (7, Z, Y, X) storage dtype
    T: Optional[torch.Tensor] = None    # (Z, Y, X) f32


class ZHalo(NamedTuple):
    """The z-halo planes of one z slab of a domain split over devices
    (`parallel/halo.py`): what a step or a fields pass of the slab reads
    where its z neighbours leave [0, Z).  The plane below supplies the 5
    cz = +1 channels (9-13) a cell of the slab's first plane pulls, the
    plane above the 5 cz = -1 channels (14-18) its last plane pulls; the
    wall models' mirror partners of a cz = +-1 direction are cz = +-1
    directions too, so no other channel is read there.  `fp` / `fm` are
    (5, Y, X) with contiguous (Y, X) planes and any channel stride (a view
    into the neighbouring slab's DDFs, or a copy); `flb` / `fla` (Y, X)
    uint8 their flags; `gp` / `gm` (Y, X) the thermal g channel 5 (+z) of
    the plane below and 6 (-z) of the plane above.  `gy` / `gx` are the
    ghost widths of the slab's (Y, X) plane, so the VK inlet sites land on
    the box inside the ghosts."""

    fp: torch.Tensor
    fm: torch.Tensor
    flb: torch.Tensor
    fla: torch.Tensor
    gp: Optional[torch.Tensor] = None
    gm: Optional[torch.Tensor] = None
    gy: int = 0
    gx: int = 0


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


def wall_mode(config: StepConfig) -> int:
    """0 no wall model, 1 the ground (`wall_model`), 2 the ground and the
    vertical faces (`wall_sides`)."""
    return 2 if config.wall_sides else (1 if config.wall_model else 0)


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
    """DDFs at equilibrium from host arrays (rho, u[, T]) — the reference
    initialize kernel (kernel.cpp:1370): the arrays are copied to `device`
    and `equilibrium_state` builds the equilibria there."""
    dev = torch.device(device)

    def put(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a, dtype), device=dev)

    return equilibrium_state(shape, config=config, rho=put(rho, np.float32),
                             u=put(u, np.float32), flags=put(flags, np.uint8),
                             T=put(T, np.float32), device=dev)


def equilibrium_state(
    shape,  # (Z, Y, X)
    *,
    config: StepConfig,
    device: torch.device | str,
    rho: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    flags: Optional[torch.Tensor] = None,
    T: Optional[torch.Tensor] = None,
) -> LBMState:
    """DDFs at equilibrium built on `device` from tensors there (rho = 1,
    u = 0, flags = 0 and T = 1 where not given; a tensor elsewhere is
    moved).  Counterpart of the JAX package's `equilibrium_state` (the
    on-device twin of `make_initial_state`): only (rho, u, flags[, T]) need
    be on the device, and the equilibria are built there one direction at
    a time, so the transient footprint is one fp32 plane set.  A thermal
    configuration also gets the D3Q7 populations `gi` at g_eq(T, u)."""
    from .lattice import C7, W7

    Z, Y, X = (int(v) for v in shape)
    dev = torch.device(device)

    def field(t, lead, dtype, fill):
        if t is None:
            return torch.full((*lead, Z, Y, X), fill, dtype=dtype, device=dev)
        return torch.as_tensor(t).to(device=dev, dtype=dtype)

    rho_t = field(rho, (), torch.float32, 1.0)
    u_t = field(u, (3,), torch.float32, 0.0)
    flags_t = field(flags, (), torch.uint8, 0)
    scale = FP16_SCALE if config.storage == "f16" else 1.0
    fi = torch.empty((19, Z, Y, X), dtype=storage_dtype(config.storage),
                     device=dev)

    def store(buf, d, eq):
        eq = eq * scale if scale != 1.0 else eq
        buf[d] = (encode_fp16c(eq) if config.storage == "fp16c"
                  else eq.to(buf.dtype))

    for d, feq in equilibrium_planes(rho_t, u_t):
        store(fi, d, feq)
    if not config.thermal:
        return LBMState(fi=fi, rho=rho_t, u=u_t, flags=flags_t)
    T_t = field(T, (), torch.float32, 1.0)
    gi = torch.empty((7, Z, Y, X), dtype=fi.dtype, device=dev)
    for d in range(7):
        cx, cy, cz = (int(v) for v in C7[d])
        w = float(W7[d])
        if d == 0:
            geq = w * (T_t - 1.0)
        else:
            cu = cx * u_t[0] + cy * u_t[1] + cz * u_t[2]
            geq = w * (T_t - 1.0) + 4.0 * w * T_t * cu
        store(gi, d, geq)
    return LBMState(fi=fi, rho=rho_t, u=u_t, flags=flags_t, gi=gi, T=T_t)
