"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `latticeurbanwind_tpu_torch/csrc/`, then:

  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions,
     the build time and the kernels' register use;
  2. runs each kernel against its plain PyTorch version on the card: K-SC
     (stream-collide) for 5 steps at an odd shape with the LUW shell, solids,
     nudging, sponge and Coriolis in f32 and bf16 plus the volume-force-off
     flagship config, and again at the main path's grid; K-AVG (averaging)
     for 4 samples against update_fields + welford_update;
  3. times both kernels with CUDA events at 256^3 (the flagship config in
     bf16 and f32, and bf16 with nudging + sponge) against a device-to-device
     copy bandwidth measured here, and the plain versions at the same shapes;
  4. runs the example profile deck at 1.5 m cells (424x424x118 = 21.2M cells,
     bf16, VK inlet off, one angle) through the port's `run_deck`, checks its
     VTKs and that the main path launched K-SC 400 and K-AVG 50 times.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; so
does a machine without CUDA.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
EXAMPLE = REPO / "examples" / "example_ProfileResearch_noDEM"
TOL = {"f32": 6e-6, "bf16": 2e-4}      # the JAX kernel's own (test_pallas_kernel.py)
AVG_TOL = 1e-5                          # the JAX fused pass's own (test_avg_kernel.py)
BYTES_PER_CELL = {"f32": 153, "bf16": 77}   # 2*19*sizeof(storage) + 1 flag byte
NUDGE_BYTES = 5                             # nudge sigma (4) + face id (1)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def make_case(shape, storage, *, forcing=True, seed=0, device="cuda"):
    """LUW-shell case (TYPE_E outer faces, solid ground, solid blocks) from a
    numpy seed: (config, state, forcing, dyn row)."""
    from latticeurbanwind_tpu_torch.lbm.forcing import (
        NudgeSpec, SpongeSpec, build_forcing,
    )
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import (
        DynParams, Forcing, StepConfig, TYPE_E, TYPE_S, dyn_row,
        make_initial_state,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), storage=storage,
                     volume_force=forcing)
    u = (0.02 * rng.standard_normal((3, Z, Y, X))).astype(np.float32)
    rho = (1.0 + 0.001 * rng.standard_normal(shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[(rng.random(shape) < 0.03) & (flags == 0)] = TYPE_S
    flags[2:Z // 3, Y // 4:Y // 2, X // 3:X // 2] = TYPE_S
    state = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags,
                               device=device)
    if forcing:
        frc = build_forcing(shape, nudge=NudgeSpec(n_cells=3, inv_tau=0.02,
                                                   downstream_face=2),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05),
                            device=device)
        dyn = DynParams(force=torch.tensor([1e-5, 0.0, -2e-5]),
                        omega_coriolis=torch.tensor([0.0, 1e-5, 2e-5]))
    else:
        frc = Forcing()
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    return cfg, state, frc, dyn_row(dyn, device)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phases

def phase_card() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("== phase 1: the card")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from latticeurbanwind_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    _, build_log = cuda_build.build()
    cuda_build.load_library()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return {"smi": smi}


def phase_compare(main_shape) -> dict:
    """Kernel against plain version on the card; returns max errors."""
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import DynParams, TYPE_S
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    log("== phase 2: kernels against their plain versions on the card")
    errs = {"stream_collide": 0.0, "avg_update": 0.0}
    runs = [((24, 72, 136), s, f, 5) for s in ("f32", "bf16") for f in (True, False)]
    runs.append((main_shape, "bf16", True, 2))
    for shape, storage, forcing, steps in runs:
        cfg, st, frc, row = make_case(shape, storage, forcing=forcing)
        fbc = build_face_bc(st.u) if forcing else None
        fk = st.fi
        fp = st.fi.clone()
        for _ in range(steps):
            fk = stream_collide(fk, st.flags, row, cfg, frc, fbc)
            fp = stream_collide_plain(fp, st.flags, row, cfg, frc, fbc)
        torch.cuda.synchronize()
        e = max_err(fk, fp)
        ok = e <= TOL[storage] and bool(torch.isfinite(fk.float()).all())
        log(f"K-SC {shape} {storage} volume_force={forcing} {steps} steps: "
            f"max|kernel-plain| = {e:.3e} (tol {TOL[storage]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-SC disagrees with its plain version: {e}")
        errs["stream_collide"] = max(errs["stream_collide"], e)

        # K-AVG: 4 samples from the DDFs of successive kernel steps
        dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
        ak = init_avg(shape, False, "cuda")
        ap = init_avg(shape, False, "cuda")
        fi = fk
        for k in range(4):
            ak = avg_update(fi, st.flags, row, 1.0 / (k + 1), ak, cfg)
            ap = welford_update(ap, update_fields(st._replace(fi=fi), cfg, dyn))
            fi = stream_collide(fi, st.flags, row, cfg, frc, fbc)
        torch.cuda.synchronize()
        fluid = (st.flags & TYPE_S) == 0
        e = max(max_err(ak.mean_u[:, fluid], ap.mean_u[:, fluid]),
                max_err(ak.m2_u[fluid], ap.m2_u[fluid]),
                max_err(ak.mean_rho[fluid], ap.mean_rho[fluid]))
        ok = e <= AVG_TOL and bool(torch.isfinite(ak.mean_u).all())
        log(f"K-AVG {shape} {storage} volume_force={forcing} 4 samples: "
            f"max|kernel-plain| at fluid cells = {e:.3e} (tol {AVG_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-AVG disagrees with its plain version: {e}")
        errs["avg_update"] = max(errs["avg_update"], e)
        del st, fk, fp, fi, ak, ap, frc, fbc
        torch.cuda.empty_cache()
    return errs


def copy_bandwidth() -> float:
    """Device-to-device copy bandwidth in GB/s (read + write of 4 GiB)."""
    src = torch.empty(1 << 30, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10)
    bw = 2 * src.numel() * 4 / (ms * 1e-3) / 1e9
    del src, dst
    torch.cuda.empty_cache()
    return bw


def time_step_kernel(shape, storage, forcing, *, plain_reps=3):
    """(kernel ms/step, plain ms/step) at `shape`."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    cfg, st, frc, row = make_case(shape, storage, forcing=forcing)
    fbc = build_face_bc(st.u) if forcing else None
    bufs = [st.fi, torch.empty_like(st.fi)]

    def step():
        stream_collide(bufs[0], st.flags, row, cfg, frc, fbc, out=bufs[1])
        bufs.reverse()

    ms = cuda_ms(step, reps=50, warmup=5)
    plain = cuda_ms(lambda: stream_collide_plain(bufs[0], st.flags, row, cfg,
                                                 frc, fbc),
                    reps=plain_reps, warmup=1)
    return ms, plain


def time_avg_kernel(shape, storage):
    """(kernel ms/sample, plain ms/sample) at `shape`."""
    from latticeurbanwind_tpu_torch.ops.avg_kernel import (
        avg_update, avg_update_plain,
    )
    from latticeurbanwind_tpu_torch.run.welford import init_avg

    cfg, st, _, row = make_case(shape, storage, forcing=False)
    avg = init_avg(shape, False, "cuda")
    ms = cuda_ms(lambda: avg_update(st.fi, st.flags, row, 0.5, avg, cfg),
                 reps=20, warmup=3)
    plain = cuda_ms(lambda: avg_update_plain(st.fi, st.flags, row, 0.5, avg,
                                             storage),
                    reps=3, warmup=1)
    return ms, plain


def phase_timing(main_shape) -> dict:
    log("== phase 3: timing (CUDA events, after warm-up)")
    bw = copy_bandwidth()
    log(f"device-to-device copy bandwidth: {bw:.1f} GB/s")
    cube = (256, 256, 256)
    cells = float(np.prod(cube))
    out = {"copy_gbps": bw}
    for storage, forcing in (("bf16", False), ("f32", False), ("bf16", True)):
        ms, plain = time_step_kernel(cube, storage, forcing)
        bpc = BYTES_PER_CELL[storage] + (NUDGE_BYTES if forcing else 0)
        mlups = cells / (ms * 1e-3) / 1e6
        roof = mlups * 1e6 * bpc / 1e9 / bw * 100.0
        log(f"K-SC 256^3 {storage} {'nudge+sponge' if forcing else 'flagship'}: "
            f"{ms:.3f} ms/step, {mlups:.0f} MLUPs, {roof:.1f}% of the "
            f"{bpc} B/cell copy roofline; plain version {plain:.2f} ms/step "
            f"({plain / ms:.1f}x the kernel)")
        torch.cuda.empty_cache()
    ms, plain = time_avg_kernel(cube, "bf16")
    log(f"K-AVG 256^3 bf16: {ms:.3f} ms/sample; plain version "
        f"{plain:.2f} ms/sample ({plain / ms:.1f}x the kernel)")
    # at the main path's grid and configuration (these go into the record)
    sc_ms, sc_plain = time_step_kernel(main_shape, "bf16", True)
    av_ms, av_plain = time_avg_kernel(main_shape, "bf16")
    log(f"K-SC {main_shape} bf16 nudge+sponge: {sc_ms:.3f} ms/step "
        f"(plain {sc_plain:.2f}); K-AVG: {av_ms:.3f} ms/sample "
        f"(plain {av_plain:.2f})")
    torch.cuda.empty_cache()
    out.update(sc_ms=sc_ms, sc_plain=sc_plain, av_ms=av_ms, av_plain=av_plain)
    return out


def phase_main_path(work: Path) -> dict:
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    log("== phase 4: the example profile deck at 1.5 m through run_deck")
    case = work / "profile"
    shutil.copytree(EXAMPLE, case)
    deck = load_deck(case / "conf.luwpf")
    deck.set_float("cell_size", 1.5)
    deck.set_text("turb_inflow_enable", "false")
    deck.set_list("angle", [0.0])
    deck.save()

    torch.cuda.reset_peak_memory_stats()
    stream_collide.launches = 0
    avg_update.launches = 0
    t0 = time.perf_counter()
    results = run_deck(case / "conf.luwpf", device="cuda", quiet=False)
    wall = time.perf_counter() - t0
    launches = {"stream_collide": stream_collide.launches,
                "avg_update": avg_update.launches}
    peak = torch.cuda.max_memory_allocated()

    (r,) = results
    shape = tuple(r.state.rho.shape)
    names = sorted(f.name for f in r.files)
    log(f"grid (Z, Y, X) = {shape}, {np.prod(shape) / 1e6:.2f}M cells, "
        f"storage {r.state.fi.dtype}")
    log(f"files: {names}")
    log(f"launches on the main path: {launches}")
    log(f"solver {r.solver_seconds:.2f} s, {r.timing['mlups']:.0f} MLUPs "
        f"(RunInfo calibration), averaging phase "
        f"{r.timing.get('avg_steps_per_second', 0.0):.1f} steps/s, "
        f"voxelizer {r.timing['voxelize_seconds']:.2f} s, whole run_deck "
        f"{wall:.1f} s, peak device memory {peak / 2**30:.2f} GiB")

    want = ["20260101120000_raw_u-000000200.vtk",
            "20260101120000_raw_u-000000400.vtk",
            "20260101120000_raw_rho-000000400.vtk",
            "20260101120000_avg-000000400.vtk"]
    missing = [n for n in want if n not in names]
    if missing:
        raise AssertionError(f"missing outputs {missing}")
    if launches != {"stream_collide": 400, "avg_update": 50}:
        raise AssertionError(f"unexpected launch counts {launches}")
    avg_file = next(f for f in r.files if f.name == want[-1])
    _, fields = read_structured_points(avg_file)
    fluid = fields["fluid"] > 0.5
    for key, arr in fields.items():
        if not np.isfinite(arr[..., fluid]).all():
            raise AssertionError(f"non-finite {key} at fluid cells")
    u_avg = fields["u_avg"]
    if u_avg.shape[1:] != fluid.shape or not u_avg[1][fluid].mean() < -0.5:
        raise AssertionError("u_avg is not the expected -y inflow (angle 0)")
    log(f"_avg VTK: fields {sorted(fields)}, shape {u_avg.shape}, finite at "
        f"fluid cells, mean v = {float(u_avg[1][fluid].mean()):.3f} m/s")
    return {"launches": launches, "shape": shape}


def main() -> int:
    card = phase_card()
    from latticeurbanwind_tpu_torch.utils.cuda_build import BUILD_DIR

    # the main-path grid of phase 4 (cell 1.5 m on the example deck)
    main_shape = (118, 424, 424)
    errs = phase_compare(main_shape)
    timing = phase_timing(main_shape)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=BUILD_DIR))
    try:
        main = phase_main_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if main["shape"] != main_shape:
        raise AssertionError(f"main path grid {main['shape']} != {main_shape}")

    record = {"kernels": [
        {"name": "stream_collide", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide.cu",
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:408",
         "launches": main["launches"]["stream_collide"],
         "max_abs_err": errs["stream_collide"],
         "ms": timing["sc_ms"], "plain_ms": timing["sc_plain"]},
        {"name": "avg_update", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/avg_update.cu",
         "replaces": "latticeurbanwind_tpu/ops/avg_kernel.py:85",
         "launches": main["launches"]["avg_update"],
         "max_abs_err": errs["avg_update"],
         "ms": timing["av_ms"], "plain_ms": timing["av_plain"]},
    ]}
    log(card["smi"])
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
