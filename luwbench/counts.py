"""The yardstick's work counts and the card's published peaks (frozen).

A kernel's share of its roofline is the least time the card could take for
the work the algorithm needs, over the kernel's measured device time.  The
work follows the deck's shapes, whatever implements it: every input byte
is read once and every output byte written once; only cells that are not
solid count, and that count comes from the flags.  A later kernel that
moves fewer bytes is read against the same work.

K-SC, one step (PERF.md section 3, "Bound"): every DDF written once; the
DDFs of the cells that are not solid, the flags, the forcing fields (the
nudge sigma and face id per cell, the sponge profile per plane), the six
FaceBC target planes and the inlet's site masks read once; 600 float32
operations per cell that is not solid.  The VK site pass, launched with the
step, belongs to the step: its re-reads of the face cells are not work the
step needs, and its 120 operations per site are below 0.3% of the step's,
which are themselves 5-10 times under the bytes bound.

A thermal step (the case's configuration is thermal: the D3Q7 temperature
DDFs stepped in the same launch) adds the 7 D3Q7 DDFs by the D3Q19 rule
(each written once, those of the cells that are not solid read once) and
the sponge's temperature target (one float32 plane, Y x X) read once; 660
float32 operations per cell that is not solid in place of 600.

K-AVG, one sample: the DDFs of the cells that are not solid read once and
the five float32 accumulators of those cells read and written (40 B), the
flags read once; 150 float32 operations per such cell.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .reference.state import TYPE_S, storage_dtype

# NVIDIA H100 SXM data sheet: device memory bandwidth and float32 outside
# the tensor cores, at the card's full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KSC_FLOPS_PER_CELL = 600
KSC_THERMAL_FLOPS_PER_CELL = 660
KAVG_FLOPS_PER_CELL = 150
KAVG_ACC_BYTES = 40          # mean_u (3), m2_u, mean_rho: f32, read + written
F32 = 4


def _site_mask_bytes(shape: Tuple[int, int, int], faces: Sequence[str]) -> int:
    """float32 masks: (Z, 1, Y) for west/east lanes, (Z, 1, X) for
    south/north rows, (Y, X) for the top/bottom planes."""
    Z, Y, X = shape
    size = {"uw": Z * Y, "ue": Z * Y, "us": Z * X, "un": Z * X,
            "ut": Y * X, "ub": Y * X}
    return F32 * sum(size[f] for f in faces)


def ksc_step_bytes(shape: Tuple[int, int, int], live: int, *,
                   storage_bytes: int, nudge: bool, sponge: bool,
                   site_faces: Sequence[str] = (), thermal: bool = False) -> int:
    """Bytes one K-SC step must move at `shape` with `live` cells that are
    not solid."""
    Z, Y, X = shape
    cells = Z * Y * X
    ddf = (26 if thermal else 19) * storage_bytes * (cells + live)
    flags = cells
    forcing = (5 * cells if nudge else 0) + (F32 * Z if sponge else 0)
    fbc = F32 * 3 * (2 * Z * Y + 2 * Z * X + 2 * Y * X)
    if thermal:
        fbc += F32 * Y * X
    return ddf + flags + forcing + fbc + _site_mask_bytes(shape, site_faces)


def ksc_step_flops(live: int, thermal: bool = False) -> int:
    return (KSC_THERMAL_FLOPS_PER_CELL if thermal else KSC_FLOPS_PER_CELL) * live


def kavg_sample_bytes(shape: Tuple[int, int, int], live: int, *,
                      storage_bytes: int) -> int:
    Z, Y, X = shape
    return live * (19 * storage_bytes + KAVG_ACC_BYTES) + Z * Y * X


def kavg_sample_flops(live: int) -> int:
    return KAVG_FLOPS_PER_CELL * live


def least_seconds(nbytes: float, flops: float) -> Dict[str, object]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    if t_bytes >= t_ops:
        return {"seconds": t_bytes, "bound_by": "bytes"}
    return {"seconds": t_ops, "bound_by": "operations"}


def work(shape: Tuple[int, int, int], live: int, *, storage_bytes: int,
         nudge: bool, sponge: bool, site_faces: Sequence[str],
         thermal: bool = False) -> dict:
    """The least seconds of one K-SC step and one K-AVG sample at `shape`
    with `live` cells that are not solid."""
    return {
        "ksc_step_s": least_seconds(
            ksc_step_bytes(shape, live, storage_bytes=storage_bytes,
                           nudge=nudge, sponge=sponge, site_faces=site_faces,
                           thermal=thermal),
            ksc_step_flops(live, thermal))["seconds"],
        "kavg_sample_s": least_seconds(
            kavg_sample_bytes(shape, live, storage_bytes=storage_bytes),
            kavg_sample_flops(live))["seconds"],
    }


def work_of(tables) -> dict:
    """`work` of the case that the reference rebuilt from the deck
    (`reference.setup.Tables`): its shape, its flags, its storage, the
    forcing it has, the faces its inlet sets and whether it is thermal."""
    spec = None if tables.vk is None else tables.vk.kernel_spec
    return work(
        tuple(tables.shape), int(((tables.flags & TYPE_S) == 0).sum()),
        storage_bytes=storage_dtype(tables.config.storage).itemsize,
        nudge=tables.forcing.nudge_sigma is not None,
        sponge=tables.forcing.sponge_sigma_z is not None,
        site_faces=sorted(spec["masks"]) if spec else (),
        thermal=bool(tables.config.thermal))
