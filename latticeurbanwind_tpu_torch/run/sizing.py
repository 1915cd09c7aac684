"""Grid sizing: cell size from a device memory budget + sponge grid extension.

Counterpart of `latticeurbanwind_tpu/run/sizing.py` without the TPU-only
fast-tier Y padding (the CUDA kernel takes any plane).  Re-model of the
reference's VRAM-driven resolution fit
(reference: setup.cpp:371-407 fit_cell_size_to_gpu_memory_request,
setup.cpp:3552-3568 top-sponge grid extension).  The byte model reflects this
framework's actual allocations instead of the OpenCL buffer set:

  per cell: fi storage (19*s bytes, double-buffered under scan) + rho (4)
  + u (12) + flags (1) [+ gi 7*s*2 + T 4 when thermal] + forcing fields.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..parallel.comm import ensure_distributed


def bytes_per_cell(storage: str = "f16", thermal: bool = False) -> float:
    s = {"f32": 4, "f16": 2, "bf16": 2, "fp16c": 2}[storage]
    mult = 2
    # The JAX package's byte model, kept unchanged so that both packages size
    # a deck to the same grid: two DDF buffers, rho/u doubled transiently by
    # update_fields at events, flags, and +6 B/cell of transients.
    total = 19 * s * mult + (4 + 12) * mult + 1 + 6
    total += 5  # nudge sigma (4) + face id (1)
    if thermal:
        total += (7 * s + 4) * mult
    return float(total)


@dataclass(frozen=True)
class GridPlan:
    cell_m: float
    nx: int
    ny: int
    nz_core: int
    nz: int                  # core + sponge extension rows
    sponge_cells: int
    sponge_extended: bool
    side_ref_z_cap: int      # top of the core region (-1 when no extension)
    bytes_per_device: int
    n_devices: int


def _grid_dims(si_size, cell_m: float, sponge_thickness_m: float,
               sponge_enabled: bool) -> Tuple[int, int, int, int, bool]:
    nx = max(1, int(si_size[0] / cell_m + 0.5))
    ny = max(1, int(si_size[1] / cell_m + 0.5))
    nz_core = max(1, int(si_size[2] / cell_m + 0.5))
    sponge_cells = max(1, int(round(sponge_thickness_m / cell_m)))
    extend = sponge_enabled and nz_core > 2
    nz = nz_core + (sponge_cells if extend else 0)
    return nx, ny, nz_core, nz, extend


def plan_grid(
    si_size: Tuple[float, float, float],
    *,
    cell_m: Optional[float] = None,
    memory_mb: Optional[int] = None,
    n_devices: int = 1,
    storage: str = "f16",
    thermal: bool = False,
    sponge_thickness_m: float = 0.0,
    sponge_enabled: bool = False,
) -> GridPlan:
    """Resolve the lattice dimensions from either an explicit cell size or a
    per-device memory budget (bisection, like the reference's mesh_control).
    """
    bpc = bytes_per_cell(storage, thermal)

    def device_bytes(cm: float) -> int:
        nx, ny, _, nz, _ = _grid_dims(si_size, cm, sponge_thickness_m, sponge_enabled)
        cells = nx * ny * nz
        return int(cells * bpc / max(1, n_devices))

    if cell_m is None:
        if not memory_mb or memory_mb <= 0:
            cell_m = 20.0
        else:
            budget = memory_mb * 1024 * 1024
            lo = 0.5   # finest cell we'd ever fit
            hi = max(max(si_size), 1.0)
            while device_bytes(hi) > budget and hi < 1e6:
                hi *= 2.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if device_bytes(mid) <= budget:
                    hi = mid
                else:
                    lo = mid
            cell_m = hi

    nx, ny, nz_core, nz, extended = _grid_dims(
        si_size, cell_m, sponge_thickness_m, sponge_enabled)
    sponge_cells = max(1, int(round(sponge_thickness_m / cell_m)))
    return GridPlan(
        cell_m=float(cell_m),
        nx=nx, ny=ny, nz_core=nz_core, nz=nz,
        sponge_cells=sponge_cells,
        sponge_extended=extended,
        side_ref_z_cap=(nz_core - 1) if extended else -1,
        bytes_per_device=device_bytes(cell_m),
        n_devices=n_devices,
    )


def effective_ngpu(ngpu, device: torch.device | str = "cuda") -> Tuple[int, int, int]:
    """The (Dx, Dy, Dz) split a run uses under the device rule of
    `parallel/mesh.py::domain_mesh`: the deck's n_gpu, except that "cuda"
    (no card index) in one process with fewer visible cards than Dx*Dy*Dz
    is a single-device run, (1, 1, 1), as the JAX package's `run_case`
    does.  Over several processes (`parallel/comm.py::ensure_distributed`)
    the split stays: `domain_mesh` raises in a process with fewer cards
    than its shards.  "cuda:k" and "cpu" keep the split."""
    dx, dy, dz = (int(v) for v in (list(ngpu) + [1, 1, 1])[:3])
    dev = torch.device(device)
    if (dx * dy * dz > 1 and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() < dx * dy * dz
            and not ensure_distributed()):
        return (1, 1, 1)
    return (dx, dy, dz)


def setup_device(ngpu, device: torch.device | str = "cuda") -> torch.device:
    """Where a run builds its whole-domain state and forcing: the host of
    each process when the device rule spreads its shards over several cards
    ("cuda" with enough of them visible, in one process or over several;
    the grid is sized for all of them together, so it may not fit on one),
    else `device` itself."""
    dev = torch.device(device)
    if (math.prod(effective_ngpu(ngpu, dev)) > 1 and dev.type == "cuda"
            and dev.index is None):
        return torch.device("cpu")
    return dev
