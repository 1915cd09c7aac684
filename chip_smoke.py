"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `latticeurbanwind_tpu_torch/csrc/` (one
nvcc per source, in parallel), then:

  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions,
     whether `import matplotlib` and `import PIL` work on the machine,
     the build time (each nvcc and the whole build + load) and every kernel
     instance's register count and spill bytes (the tiled body's families
     -- plain, wall models and TRT, thermal, each single-device and halo
     mode -- summed up apart; the VK site pass's and K-AVG's instances,
     none of which may spill), and checks that float32
     matrix products run
     in full float32 (no TF32: the VK inlet's mode sum is one);
  2. runs each kernel against its plain PyTorch version on the card: K-SC
     (stream-collide) for 5 steps at an odd shape with the LUW shell,
     solids, nudging, sponge and Coriolis in all four storages (f32, bf16,
     f16, fp16c) plus the volume-force-off flagship config, and with the
     wall models (`wall_model`; `wall_sides` with Cd_sides 0.004 and 0) and
     TRT (alone and with the wall models), and again at the main path's grid
     in bf16 and fp16c (and bf16 with the wall models and VK sites); K-SC
     with VK inlet sites, random 0/1 masks on the four side faces and the
     top plane, and with a real inlet hook refreshing the FaceBC every step,
     in all four storages and in bf16 and fp16c at the main grid; K-AVG
     (averaging) for 4 samples against update_fields + welford_update after
     each of the K-SC runs without sites (the wall-model K-AVG after the
     wall runs), and at the ragged shape below with solid cells on all six
     boundary planes in every storage without a wall model, with
     `wall_model` and with `wall_sides`; K-SC thermal (the D3Q7 sub-lattice: TYPE_T cells, sponge on
     T, and a global force, expansion coefficient and temperature spread
     large enough that the Boussinesq term moves f by at least 10x the
     tolerance in 5 steps, which is checked against the same steps with
     beta = 0) in all four storages, without and with the wall models and
     TRT, without and with VK sites, and in bf16 with hook sites at the NWP
     deck's grid, both its f and g outputs, the 2-byte storages by their
     stored codes (at most one storage step apart wherever the decoded
     values are further apart than the tolerance, and few such elements);
     the tiled body again at a ragged shape, (13, 37, 141), a multiple of no
     tile edge above 1, without the TYPE_E shell and with solid cells on all
     six boundary planes, so that its flag ring wraps on every axis, 3 steps
     in every storage: the plain family (no wall model, SRT) with and without
     the volume force, each with and without random VK sites, and with
     random VK sites `wall_model`, `wall_sides`, TRT, TRT with `wall_sides`,
     and thermal plain, with `wall_sides` and with TRT;
     K8, the halo mode of K-SC, against its plain version on one z slab
     (no ground, no TYPE_E top) with random halo planes and ghost widths
     (1, 1), 3 steps, in all four storages: without a wall model with and
     without the volume force, with `wall_model`, `wall_sides`, TRT, and
     thermal (the strong-buoyancy case) without a wall model, with
     `wall_sides` and with TRT, each without and with random VK sites (a
     step that wraps inside the slab instead lands 4.8e-2 away); and slabs
     of one plane, of two and of five (thinner than a block's 8 planes, y
     and x ragged) in bf16 and f32, the plain family with and without the
     volume force, `wall_sides`, thermal and thermal TRT with `wall_sides`;
     the sharded
     runner with every shard on card 0 against the single-device runner,
     6 steps with a VK hook over the splits (1,1,2), (1,2,2), (2,1,1),
     (2,2,2) and the uneven (3,5,1) and (1,2,5) (shards one cell apart in
     size), f32 and bf16, bf16 `wall_sides`, thermal bf16 and fp16c: the
     stored DDFs (and g) and the fields pass's rho, u (and T) EQUAL;
     the VK site pass alone (`vk_sites`) against `apply_vk_sites` on the
     same step outputs in every storage, by stored codes (EQUAL), on the
     inlet hook's masks at the main grid and on random masks over all six
     faces of a box one cell inside a slab's y and x edges;
     the device codecs bit for bit against the torch codecs (all 65,536
     fp16c and f16 codes, a dense sweep of every float32 exponent band with
     ties);
  3. times the kernels with CUDA events at 256^3 (the flagship config in
     every storage; bf16 and f32 with nudging + sponge, without a wall
     model, with `wall_model`, with `wall_sides` and with TRT) against a
     device-to-device copy bandwidth measured here, and the plain versions
     at the same shapes; K-SC with VK sites (without and with the wall
     models) and K-AVG (without and with `wall_sides`) at the main grid and
     at 256^3, and without at the NWP deck's grid (K-AVG held there to its
     plain version on two samples, each in its own accumulators, within
     AVG_TOL); the VK site pass alone
     at the main grid and at the NWP deck's grid with the inlet hook's
     sites, beside its element bound and its sector bound (the distinct
     32-byte sectors its DDF elements touch); K-SC (K1-K3) with VK sites at the NWP deck's grid without T
     (`nwp-bf16-300`'s step); K-SC thermal at 256^3 in bf16 and f32 and,
     with VK sites, at the NWP deck's grid, and the thermal `update_fields` (which a thermal
     run takes at every averaging sample) alone at that grid (the tiled
     body's shapes are swept by chip_sweep.py); K8 at the
     split deck's shard (59x214x424 with its ghost rows, bf16, VK sites)
     against the non-halo instance on the same shard, and the whole split
     step of the main grid on one card (n_gpu [1, 2, 2]) against the
     single-device step, with its parts (the four K8 launches, the ghost
     exchange, the FaceBC refresh with its per-shard slices) by device time
     and host enqueue time;
  4a. runs the pre-processing pipeline on this machine (`phase_pipeline`):
     the port's `dispatch makeluw` on a copy of `examples/example_NWP-LBM`,
     each stage timed, the made deck's values equal to
     `examples/example_NWP-LBM_prepared/`'s, its SurfData CSV within 1e-6 of
     each column's largest magnitude and its STL's vertices within 1e-4 m
     (whether the bytes are equal too is printed); the made deck as it
     ships (16 m cells, 300 steps, T on, VK inlet, one probe) through
     `dispatch runluw` on the card (300 K-SC launches, all thermal and with
     sites, counts zeroed just before and read just after), then `dispatch
     vtk2nc` (every NetCDF finite, lon/lat inside the deck's cut box);
     3,000 seeded footprints, a third of them overlapping, through luwcut
     and luwvox, each timed; a seeded DEM of 5,000 lon/lat points through
     luwdem and luwvox with `kriging_gpu`, the card's solve held to the
     CPU's within 1e-3 m; `kriging_interpolate` alone at 100,489 targets
     from 5,000 points, the host KNN and the card's solve timed apart, held
     to the CPU solve within 1e-3 m; `luwenv`'s report; and `luwval`'s
     `gpu_memory` writeback on a deck without `mesh_control`, 85% of the
     card's memory;
  4. runs the example profile deck at 1.5 m cells (424x424x118 = 21.2M
     cells, one angle) through the port's `run_deck` as it ships, with the
     VK inlet on: bf16 for 400 steps (K-SC 400 launches with sites, K-AVG
     50, the inlet on faces {0,1,2,3}, the upstream face's raw u at t = 200
     and 400 off the initial profile by an RMS within [0.3, 3] sigma); the
     same deck split `n_gpu = [1, 2, 2]` with its four shards on card 0
     (`vk-bf16-sharded`: 1600 K8 launches, all with sites, no K-AVG; its
     final DDFs and raw VTKs equal to the unsplit run's, its averages within
     the K-AVG tolerance at cells that are not solid; on a machine with four
     cards also spread over them with `device="cuda"`, else one line says it
     was not run), with its split step timed on the run's own state; every
     one of these runs writes its PNG snapshots at t = steps / 2 and steps
     (the unsplit runs on the card's device path, the split ones on the host
     path from the gathered fields), each timed, each with its `_3d.png`,
     their sizes read from the PNG headers, and the solver seconds given
     with and without them; then
     the inlet-off deck for 100 steps and the inlet-on deck in fp16c for 200
     steps; then the same bf16 400-step deck with the wall models
     (`ground_z0 = 0.055`, `building_z0 = 0.01`: 400 K-SC launches, all
     with sites and all of the wall instances, 50 K-AVG, all wall; its raw u
     at t = 400 off the no-wall run's in the first fluid layer above open
     ground by a mean |du| > 1e-3 m/s) and `frame_output = 200` (two
     960x720 video frames, each timed); then the dataset-generation example
     `.luwdg` as it ships (`case_parallel = true`) at 2 m cells with its
     first two cases, 300 steps each, through the case-parallel batch
     runner (one case per card, in turn on one card: 600 K-SC, 60 K-AVG
     launches, its lines, both cases' `DG_<u>_<a>_` outputs, byte for byte
     those of the same cases run serially on card 0); then the resume
     phase (`resume-dg-bf16-300`): the serial run's second case (inflow 4,
     angle 45) in two legs with a checkpoint every 200 steps, leg 1 split
     [1, 2, 2] on card 0 for 200 steps without averaging (800 K8 launches,
     a checkpoint of one block per shard), leg 2 unsplit resumed to 300
     with no further save (100 K-SC, 30 K-AVG launches), its final DDF
     codes, u, rho and VTKs equal to the serial run's (0 differing codes),
     with the save and load seconds and the file's size; then the
     NWP-coupled standard deck (`.luw`) that phase 4a made, at 3 m cells
     (1017x887x79 =
     71.3M cells) in bf16 as it ships, 300 steps (`nwp-t-bf16-300`: patch-2d
     boundary route, T on, VK inlet on, 300 K-SC launches, all thermal and
     all with sites, no K-AVG launch, `_raw_T` and `T_avg` finite and in the
     CSV's Kelvin range, the probe CSV), and the same with `buoyancy = false`
     and no probes (`nwp-bf16-300`: no thermal launch, 30 K-AVG).  Each run's
     launch counts are zeroed just before it and read just after.  After
     each inlet-on run its step loop is taken apart with the run's own
     configuration, forcing and inlet hook: K-SC without and with sites, the
     site pass alone, the FaceBC refresh and the whole step (refresh + K-SC), each by device time
     and by host enqueue time.
  4b. the examples' routes through the port's dispatcher: before phase 4,
     `dgprepare` on copies of `examples/example_ProfileResearch_noDEM` and
     `examples/example_DatasetGen` with their proj_temp/*.stl removed, the
     made STLs and decks byte for byte as the examples ship them, and
     phase 4's profile and `.luwdg` decks run from these made cases; after
     phase 4, each tool on the outputs the decks wrote, timed (`[post]
     <command> seconds`): on `vk-bf16-400`'s, `luwutmnc` (the deck's copy
     given a site, PROFILE_SITE), `luwcutvis` (a local crop), `luwtkeviz`
     on the averaged VTK, `luwspectra` on the raw u VTK, `luwvideo` over
     the raw series, `buildingscale`; `luwseason` on `dg-bf16-300`'s
     averaged VTKs with a 16-row windrose and profile.dat, its u_avg held
     to the cases weighted by its season_weights.csv; `visluw` on phase
     4a's 16 m run; `visdem` on a seeded DEM grid, `shptester` on the NWP
     example's footprints.  Every file a tool names must exist, every PNG
     read back, every NetCDF variable be finite.  `luwaij` is not run (no
     Case E workbook in the repository).
  4c. the studio (`luwstudio`, `gui/server.py`) served from this process on
     a copy of phase 4a's made 16 m NWP case: `POST /api/run` `runluw
     conf.luw` (a child process of the port's dispatcher, on the card: the
     studio adds no device argument), polled on /api/job until done, exit
     0, its lines naming the card's device, its VTKs byte for byte phase
     4a's direct runluw's (else each within 1e-6, the differences printed);
     the job's averaged VTK through /api/vtkinfo, /api/render in slice, MIP
     and 3d (each a PNG whose title chunk names the file), /api/volinfo and
     every brick of every level of /api/brick; /api/env naming this card
     and the kernels built; each request timed (`[studio] <step> seconds`).
  4d. the several-hosts path (`phase_hosts`): `vk-bf16-sharded`'s deck
     (1.5 m, n_gpu = [1, 2, 2], 400 steps) run by two processes of this
     script (`--hosts-child`, each the port's `cli.run --device cuda:0`
     under LUW_COORDINATOR / LUW_NUM_PROCESSES / LUW_PROCESS_ID on a local
     port, gloo through pinned host buffers between them): each process
     800 K8 launches, all with sites, no K-AVG; process 0's VTKs byte for
     byte `vk-bf16-sharded`'s; the split step in lock-step (whole,
     exchange, K8 launches, FaceBC refresh) and the bytes staged through
     the host per step; then the sharded runner at (24, 72, 136) over both
     processes saving a checkpoint set at steps 7 and 9, which this
     process loads code for code equal to its own split run's state.  A
     process that fails fails the smoke.
  5. the published-value physics checks of `lbm/physics_checks.py` on the
     kernels in f32 (the lid-driven cavity at Re 100 against Ghia et al.,
     the vortex street's Strouhal number, Taylor-Green decay, Poiseuille,
     thermal diffusion, Coriolis, Boussinesq, the Schumann drag rate and
     the vertical-wall model), each value printed beside its published
     value and band, one K-SC launch per step (counted), a value outside
     its band failing the smoke; then each check's simulation stepped 5
     times from its initial state by K-SC and by its plain version on the
     card, which agree within the f32 tolerance at these grids (3 planes
     deep, 4 cells wide).

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; so
does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
EXAMPLE = REPO / "examples" / "example_ProfileResearch_noDEM"
EXAMPLE_DG = REPO / "examples" / "example_DatasetGen"
# the cases phase 4's profile and .luwdg decks copy: the shipped examples
# until phase 4b's dgprepare step puts its own output here
SOURCES = {"profile": EXAMPLE, "datagen": EXAMPLE_DG}
EXAMPLE_NWP = REPO / "examples" / "example_NWP-LBM_prepared"
EXAMPLE_NWP_RAW = REPO / "examples" / "example_NWP-LBM"   # makeluw's inputs
NWP_PREPARED_FILES = ("conf.luw", "proj_temp/SurfData_20260101120000.csv",
                      "proj_temp/NwpDemo_DG.stl")
MADE_CSV_RTOL = 1e-6          # of each CSV column's largest magnitude
MADE_STL_TOL_M = 1e-4
DISTRICT_FOOTPRINTS = 3000
DEM_POINTS = 5000
KRIGING_SIDE = 317            # 317^2 = 100,489 kriging targets
KRIGING_TOL_M = 1e-3          # card solve against the CPU solve, both float32
STORAGES = ("f32", "bf16", "f16", "fp16c")
# the JAX kernel's own tolerances against its reference
# (tests/test_pallas_kernel.py), on decoded values
TOL = {"f32": 6e-6, "bf16": 2e-4, "f16": 2e-5, "fp16c": 2e-5}
AVG_TOL = 1e-5                          # the JAX fused pass's own (test_avg_kernel.py)
WALL_TOL_F32 = 1e-5                     # f32 wall models (test_pallas_kernel.py:165-168)
# thermal, the 2-byte floats: the g populations carry T u / 2, which passes
# 1/32 in these cases (|u| up to ~0.15), where one storage step is 2^-12 =
# 2.44e-4 in bf16 and 2^-15 = 3.05e-5 in f16 and so exceeds the tolerance.
# The kernel (fused multiply-adds) and the plain version may round such a
# value to neighbouring codes.  So the stored codes are compared: an element
# whose decoded values differ by more than TOL must be at most ONE storage
# step apart (below 1/32 a step is under TOL, so there TOL alone holds), and
# no more than THERMAL_STEP_SHARE of a run's elements may be such; nor may
# more than THERMAL_DIFFERING_SHARE of the stored codes differ at all: a
# bias of one code in every cell would fail it.  (An H100 run of these
# cases showed at most 5.2e-5 and 1.9e-2.)
THERMAL_STEP_SHARE = 1e-3
THERMAL_DIFFERING_SHARE = 0.1
# the thermal case's buoyancy: force * beta * (T - t_avg) ~ 5e-3 per step and
# its cell-to-cell spread ~ 2.5e-4, against ~4e-10 with the JAX kernel
# test's force 2e-5, beta 0.002, |T - 1| ~ 0.01, which no tolerance here sees
THERMAL_CASE = dict(omega_t=1.1, beta=0.5, t_avg=0.0)
THERMAL_FORCE = (5e-3, 0.0, -1e-2)
THERMAL_T_SPREAD = 0.05
# the wall-model and TRT configurations (the JAX kernel tests' coefficients)
WALL = dict(wall_model=True, wall_cd=0.0134)
SIDES = dict(WALL, wall_sides=True, wall_cd_sides=0.004)
VARIANTS = {"wall": WALL, "wall+sides": SIDES,
            "wall+sides Cd_sides=0": dict(SIDES, wall_cd_sides=0.0),
            "trt": dict(collision="trt"),
            "trt+wall+sides": dict(SIDES, collision="trt")}
# 2*19*sizeof(storage) + 1 flag byte; thermal adds 2*7*sizeof(storage)
BYTES_PER_CELL = {"f32": 153, "bf16": 77, "f16": 77, "fp16c": 77}
THERMAL_BYTES = {"f32": 56, "bf16": 28, "f16": 28, "fp16c": 28}
NUDGE_BYTES = 5                             # nudge sigma (4) + face id (1)
# the bound's peaks: NVIDIA's H100 SXM data sheet (device memory; float32
# outside the tensor cores), for a card at its full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations per fluid cell update, counted from the kernels'
# arithmetic (moments, forces, Guo, equilibrium, LES, collision; K-AVG:
# moments, forces, Welford): far below the bytes bound either way
FLOPS_PER_CELL = {"stream_collide": 600, "stream_collide_thermal": 660,
                  "avg_update": 150, "vk_site": 120}   # vk_site: per site
MAIN_CELL_M = 1.5                           # the example deck's main-path cells
MAIN_SHAPE = (118, 424, 424)                # its grid at that cell size
CUBE = (256, 256, 256)                      # the flagship timing shape
RAGGED = (13, 37, 141)                      # a multiple of no tile edge > 1
RAGGED_EVEN = (13, 37, 138)                 # the same with X even (paired)
DG_SHAPE = (68, 270, 270)                   # the .luwdg deck's grid at 2 m
# K8 slabs of one plane, of two and thinner than a block's 8 planes
THIN_SLABS = ((1, 37, 141), (2, 37, 141), (5, 37, 141))
DG_CELL_M = 2.0                             # the .luwdg path's cells (~5M)
NWP_CELL_M = 3.0                            # the .luw path's cells
NWP_SHAPE = (79, 887, 1017)                 # its grid there, sponge rows included
NWP_MIN_GIB = 2.0                           # a state below this is no real size
DEVICE = "cuda"
DATETIME = "20260101120000"                 # both example decks' datetime
# the splits of the sharded runner's comparison (tests/test_sharded_pallas.py),
# then two that do not divide its grid (24, 72, 136): x in 46 / 45 / 45 and y
# in 15 / 15 / 14 / 14 / 14 cells; z in 5 / 5 / 5 / 5 / 4 planes (uneven
# shards, numpy.array_split's cuts); and the sharded deck's n_gpu [Dx, Dy,
# Dz]: 4 shards of 59x212x424 cells
SPLITS = ((1, 1, 2), (1, 2, 2), (2, 1, 1), (2, 2, 2), (3, 5, 1), (1, 2, 5))
SHARD_SPLIT = (1, 2, 2)
SHARD_DEVICE = "cuda:0"                     # every shard on one card


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


def tolerance(storage: str, variant: str = "") -> float:
    """The JAX tests' tolerance of a K-SC comparison."""
    wall = VARIANTS.get(variant, {}).get("wall_model", False)
    return WALL_TOL_F32 if storage == "f32" and wall else TOL[storage]


def make_case(shape, storage, *, forcing=True, seed=0, inflow=0.0,
              device=None, variant="", thermal=False, slab=False, wrap=False):
    """LUW-shell case (TYPE_E outer faces, solid ground, solid blocks) from a
    numpy seed, with an optional uniform inflow along x added to the random
    velocities and one of the wall/TRT `VARIANTS`: (config, state, forcing,
    dyn row).  `thermal` adds the D3Q7 sub-lattice (`THERMAL_CASE`, with the
    strong global force `THERMAL_FORCE`): a random T field, TYPE_T on the
    west face, the top plane, every solid cell (as the patch route marks
    them) and a block of fluid cells.  `slab`: a z slab from inside a split
    domain, without the solid ground plane and the TYPE_E top plane, so its
    first and last planes read the halo planes.  `wrap`: no TYPE_E shell
    and no solid ground, but 20% solid cells on each of the six boundary
    planes, so pulls, the wall models' partners and the tiled body's flag
    ring cross the periodic wrap on every axis."""
    from latticeurbanwind_tpu_torch.lbm.forcing import (
        NudgeSpec, SpongeSpec, build_forcing,
    )
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import (
        DynParams, Forcing, StepConfig, TYPE_E, TYPE_S, TYPE_T, dyn_row,
        make_initial_state,
    )

    device = device or DEVICE
    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    cfg = replace(StepConfig(omega=omega_from_nu(0.03), storage=storage,
                             volume_force=forcing), **VARIANTS.get(variant, {}))
    if thermal:
        cfg = replace(cfg, thermal=True, **THERMAL_CASE)
    u = (0.02 * rng.standard_normal((3, Z, Y, X))).astype(np.float32)
    u[0] += np.float32(inflow)
    rho = (1.0 + 0.001 * rng.standard_normal(shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    if wrap:
        edge = np.zeros(shape, bool)
        for ax in range(3):
            for end in (0, -1):
                np.moveaxis(edge, ax, 0)[end] = True
        flags[edge & (rng.random(shape) < 0.2)] = TYPE_S
    if not (slab or wrap):
        flags[-1] = TYPE_E
    if not wrap:
        flags[:, 0, :] |= TYPE_E
        flags[:, -1, :] |= TYPE_E
        flags[:, :, 0] |= TYPE_E
        flags[:, :, -1] |= TYPE_E
    if not (slab or wrap):
        flags[0] = TYPE_S
    flags[(rng.random(shape) < 0.03) & (flags == 0)] = TYPE_S
    flags[2:Z // 3, Y // 4:Y // 2, X // 3:X // 2] = TYPE_S
    T = None
    if thermal:
        flags[:, :, 0] |= TYPE_T
        if not slab:
            flags[-1] |= TYPE_T
        flags[(flags & TYPE_S) != 0] |= TYPE_T
        flags[Z // 2, Y // 2:Y // 2 + 4, X // 2:X // 2 + 6] |= TYPE_T
        T = (1.0 + THERMAL_T_SPREAD
             * rng.standard_normal(shape)).astype(np.float32)
    state = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags,
                               T=T, device=device)
    if forcing:
        frc = build_forcing(shape, nudge=NudgeSpec(n_cells=3, inv_tau=0.02,
                                                   downstream_face=2),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05),
                            device=device)
        dyn = DynParams(force=torch.tensor(THERMAL_FORCE if thermal
                                           else (1e-5, 0.0, -2e-5)),
                        omega_coriolis=torch.tensor([0.0, 1e-5, 2e-5]))
    else:
        frc = Forcing()
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    return cfg, state, frc, dyn_row(dyn, device)


def vk_hook(state, seed=7):
    """A real inlet hook for `state` (all four side faces; stride 2 with
    interpolation, so the carried anchors are exercised too)."""
    from latticeurbanwind_tpu_torch.bc.vk_inlet import (
        VkConfig, build_vk_runtime, make_vk_pre_step,
    )

    cfg = VkConfig(ti=0.08, L_lbm=20.0, nmodes=256, seed=seed,
                   update_stride=2, stride_interpolation=True)
    rt = build_vk_runtime(cfg, state.flags.cpu().numpy(), state.u.cpu().numpy())
    if rt is None:
        raise AssertionError("no active inlet face in the VK case")
    return make_vk_pre_step(cfg, rt, device=state.fi.device), rt


def random_sites(shape, seed=3):
    """Random 0/1 masks on the four side faces and the top plane."""
    Z, Y, X = shape
    rng = np.random.default_rng(seed)

    def m(*s):
        return torch.from_numpy((rng.random(s) < 0.5).astype(np.float32)).to(DEVICE)

    return {"sites": (("lane0", "uw"), ("laneL", "ue"), ("row0", "us"),
                      ("rowL", "un"), ("planeL", "ut")),
            "masks": {"uw": m(Z, 1, Y), "ue": m(Z, 1, Y), "us": m(Z, 1, X),
                      "un": m(Z, 1, X), "ut": m(Y, X)}}


def max_err(a: torch.Tensor, b: torch.Tensor, storage: str = "f32") -> float:
    """Largest difference of the decoded values."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf

    return float((decode_ddf(a, storage).float()
                  - decode_ddf(b, storage).float()).abs().max())


def code_bits(t: torch.Tensor) -> torch.Tensor:
    """The stored codes of a tensor of DDFs as integers (f32: its bits)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def stored_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two tensors of 2-byte stored codes (bf16, f16, fp16c: all
    sign-magnitude floats) in storage steps, element by element."""
    def ordered(t):
        k = t.view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)

    return (ordered(a) - ordered(b)).abs()


def thermal_diff(a: torch.Tensor, b: torch.Tensor, storage: str, tol: float) -> dict:
    """Kernel against plain DDFs of a thermal run: the largest decoded
    difference; `bad`, the elements further apart than `tol` that are not
    within one storage step of each other (f32: all those over `tol`);
    `over`, the share of elements over `tol` (the one-step exceptions);
    `differing`, the share whose stored codes differ at all (f32: 0, its
    last bits are not judged)."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf

    d = (decode_ddf(a, storage).float() - decode_ddf(b, storage).float()).abs()
    over = d > tol
    if storage == "f32":
        bad, differing = over, torch.zeros_like(over)
    else:
        steps = stored_steps(a, b)
        bad, differing = over & (steps > 1), steps > 0
    return {"max_abs": float(d.max()), "bad": int(bad.sum()),
            "over": float(over.float().mean()),
            "differing": float(differing.float().mean())}


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
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("float32 matmuls would run in TF32: the VK mode "
                             "sum needs full float32")
    log("float32 matmul precision: highest, allow_tf32 False")
    # the snapshots are composed without matplotlib or PIL either way
    # (io/png.py); whether this machine has them is recorded
    for mod in ("matplotlib", "PIL"):
        found = subprocess.run([sys.executable, "-c", f"import {mod}"],
                               capture_output=True, timeout=120).returncode == 0
        log(f"import {mod}: {'works' if found else 'fails'} on this machine")
    from latticeurbanwind_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    _, build_log = cuda_build.build()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    nvcc = {k: float(v) for k, v in
            re.findall(r"# nvcc (\S+): ([\d.]+) s", build_log)}
    log(f"kernel build + load ({len(cuda_build.sources())} sources in "
        f"parallel): {build_s:.1f} s; nvcc seconds per unit: {nvcc}")
    regs, spills = kernel_registers(build_log)
    spilled = sorted(k for k, v in spills.items() if any(v))
    log(f"  ptxas: {len(regs)} kernels, registers {min(regs.values(), default=0)}"
        f"-{max(regs.values(), default=0)}, {len(spilled)} with spills")
    for name in sorted(regs):
        st, ld = spills.get(name, (0, 0))
        log(f"  {name}: {regs[name]} registers, spill bytes {st} stores / "
            f"{ld} loads")
    tiled = sorted(k for k in regs if k.startswith("stream_collide_tiled"))
    for family, members in tiled_families(tiled).items():
        log(f"  the tiled body, {family}: {len(members)} instances, registers "
            f"{min((regs[k] for k in members), default=0)}-"
            f"{max((regs[k] for k in members), default=0)}, "
            f"{sum(1 for k in members if any(spills.get(k, (0, 0))))} with "
            f"spills")
    # the site pass and K-AVG: every instance, and none may spill
    passes = sorted(k for k in regs if k.startswith(("vk_site", "avg_update")))
    for name in passes:
        log(f"  {name}: {regs[name]} registers, spill bytes "
            f"{spills.get(name, (0, 0))}")
    if len(passes) != 16 or any(any(spills.get(k, (0, 0))) for k in passes):
        raise AssertionError(f"the site pass and K-AVG: {len(passes)} "
                             f"instances (want 4 + 12), spills "
                             f"{ {k: spills.get(k) for k in passes} }")
    return {"smi": smi, "build_s": build_s, "nvcc_s": nvcc, "registers": regs,
            "spill_bytes": {k: spills.get(k, (0, 0)) for k in tiled + passes}}


def tiled_families(names) -> dict:
    """{family: [instance]} of the tiled body's instances, by their template
    arguments <codec, force, nudge, sponge, wall, trt, thermal, halo>: the
    plain family (no wall model, SRT, not thermal), the
    wall-model and TRT one and the thermal one, each single-device or halo
    mode (K8); and the plain family's paired instances."""
    out = {}
    for k in names:
        if k.startswith("stream_collide_tiled_kernel_pair<"):
            out.setdefault("plain, paired (bf16, f16, X even)", []).append(k)
        if not k.startswith("stream_collide_tiled_kernel<"):
            continue
        a = k.rstrip(">").split("<")[1].split(",")
        fam = ("thermal" if a[6] == "1" else
               "wall models and TRT" if a[4] != "0" or a[5] == "1" else
               "plain (no wall model, SRT)")
        if len(a) > 7 and a[7] == "1":
            fam += ", halo mode (K8)"
        out.setdefault(fam, []).append(k)
    return out


def kernel_registers(build_log: str):
    """({instance: registers}, {instance: (spill store bytes, spill load
    bytes)}) from ptxas's -v output.  An instance is named by its kernel,
    its codec and its other template arguments, e.g.
    stream_collide_tiled_kernel<BF16,1,1,1,0,0,0,0> (force, nudge, sponge,
    wall, trt, thermal, halo), stream_collide_tiled_kernel_pair<BF16,1,1,2>
    (force, nudge, sponge) or avg_update_kernel<BF16,2>."""
    regs, spills, name = {}, {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            m = re.search(r"(stream_collide_tiled|stream_collide|avg_update|"
                          r"vk_site|encode|decode)_kernel(_pair)?I(.*)",
                          mangled)
            if m is None:
                name = mangled
                continue
            codec = re.search(r"(\d+)(Codec\w+)", m.group(3))
            args = [codec.group(2)[5:int(codec.group(1))]] if codec else []
            args += re.findall(r"L[bi](\d+)E", m.group(3))
            name = f"{m.group(1)}_kernel{m.group(2) or ''}<{','.join(args)}>"
        elif "Used" in line and "registers" in line and name:
            regs[name] = int(line.split("Used")[1].split("registers")[0])
        elif "spill stores" in line and name:
            b = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            spills[name] = tuple(int(v) for v, _ in b)
    return regs, spills


def compare_steps(shape, storage, forcing, steps, *, vk=None, hook=False,
                  inflow=0.0, variant="", thermal=False, wrap=False):
    """K-SC against its plain version over `steps` steps; returns the max
    decoded difference of f, whether the kernel's DDFs are finite, the case
    with the kernel's DDFs, and of a thermal run the `thermal_diff` of f and
    of g at the storage's tolerance (else None)."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    cfg, st, frc, row = make_case(shape, storage, forcing=forcing, inflow=inflow,
                                  variant=variant, thermal=thermal, wrap=wrap)
    pre = None
    if hook:
        pre, _ = vk_hook(st)
        vk = pre.ddf.kernel_spec
    fbc = build_face_bc(st.u, st.T) if (forcing or vk is not None) else None
    fk = st.fi
    fp = st.fi.clone()
    # g: kernel and plain pairs (current, next); all None without T
    gk = [st.gi, torch.empty_like(st.gi)] if thermal else [None, None]
    gp = [st.gi.clone(), torch.empty_like(st.gi)] if thermal else [None, None]
    aux = pre.ddf.init_aux(0) if pre is not None else None
    for t in range(steps):
        if pre is not None:
            fbc, aux = pre.ddf(fbc, t, aux)
        fk = stream_collide(fk, st.flags, row, cfg, frc, fbc, vk=vk,
                            gi=gk[0], gi_out=gk[1])
        fp = stream_collide_plain(fp, st.flags, row, cfg, frc, fbc, vk=vk,
                                  gi=gp[0], gi_out=gp[1])
        gk.reverse()
        gp.reverse()
    torch.cuda.synchronize()
    e = max_err(fk, fp, storage)
    finite = bool(torch.isfinite(decode_ddf(fk, storage)).all())
    diffs = None
    if thermal:
        if not float(decode_ddf(gk[0], storage).abs().max()) > 1e-4:
            raise AssertionError("the thermal case's g populations are trivial")
        finite = finite and bool(torch.isfinite(decode_ddf(gk[0], storage)).all())
        tol = tolerance(storage, variant)
        diffs = {"f": thermal_diff(fk, fp, storage, tol),
                 "g": thermal_diff(gk[0], gp[0], storage, tol)}
    return e, finite, (cfg, st, frc, row, fbc, fk), diffs


def buoyancy_effect(shape, storage, steps) -> float:
    """Largest decoded difference of the kernel's f after `steps` thermal
    steps with the case's beta and with beta = 0: what the Boussinesq term
    contributes there."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide,
    )

    cfg, st, frc, row = make_case(shape, storage, thermal=True)
    fbc = build_face_bc(st.u, st.T)
    outs = []
    for c in (cfg, replace(cfg, beta=0.0)):
        f, g = st.fi, [st.gi, torch.empty_like(st.gi)]
        for _ in range(steps):
            f = stream_collide(f, st.flags, row, c, frc, fbc, gi=g[0],
                               gi_out=g[1])
            g.reverse()
        outs.append(decode_ddf(f, storage).float())
    return float((outs[0] - outs[1]).abs().max())


def compare_thermal(small) -> tuple:
    """K-SC thermal against its plain version on the card: ({config: max
    decoded difference over f and g}, {config: shares of elements over the
    tolerance and with differing codes})."""
    errs, shares = {}, {}
    # K-SC thermal.  First: the case's Boussinesq term moves f by 10x the
    # tolerance and more, so a kernel without it, with its sign flipped or
    # with the wrong T fails the comparisons that follow
    for storage in STORAGES:
        moved = buoyancy_effect(small, storage, 5)
        ok = moved >= 10 * TOL[storage]
        log(f"K-SC {storage} thermal {small} 5 steps: max|f(beta) - f(beta=0)|"
            f" = {moved:.3e} (10x tol {10 * TOL[storage]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the thermal case's buoyancy is below what "
                                 f"the comparison resolves: {moved}")
    # then f and g against the plain version
    th_runs = [(small, s, kind, 5, v) for s in STORAGES
               for kind, v in (("", ""), ("random", ""), ("hook", ""),
                               ("", "wall"), ("", "wall+sides"), ("", "trt"),
                               ("hook", "trt+wall+sides"))]
    th_runs += [(NWP_SHAPE, "bf16", "hook", 2, "")]
    for shape, storage, kind, steps, variant in th_runs:
        vk = random_sites(shape) if kind == "random" else None
        _, finite, _, diffs = compare_steps(shape, storage, True, steps, vk=vk,
                                            hook=kind == "hook",
                                            inflow=0.05 if kind else 0.0,
                                            variant=variant, thermal=True)
        name = (f"{storage} thermal nudge+sponge{' ' + variant if variant else ''}"
                f"{' VK ' + kind + ' sites' if kind else ''} {shape}")
        tol = tolerance(storage, variant)
        ok = finite and all(d["bad"] == 0 and d["over"] <= THERMAL_STEP_SHARE
                            and d["differing"] <= THERMAL_DIFFERING_SHARE
                            for d in diffs.values())
        log(f"K-SC {name} {steps} steps, tol {tol:.0e}: " + "; ".join(
            f"{k} max|kernel-plain| = {d['max_abs']:.3e}, {d['bad']} elements "
            f"over tol and more than one storage step apart, {d['over']:.2e} "
            f"of the elements over tol (limit {THERMAL_STEP_SHARE:.0e}), "
            f"{d['differing']:.2e} with differing codes (limit "
            f"{THERMAL_DIFFERING_SHARE:.0e})"
            for k, d in diffs.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-SC thermal disagrees with its plain "
                                 f"version: {diffs}")
        errs[name] = max(d["max_abs"] for d in diffs.values())
        shares[name] = {k: {"over": d["over"], "differing": d["differing"]}
                        for k, d in diffs.items()}
        torch.cuda.empty_cache()
    return errs, shares


def compare_ragged() -> tuple:
    """The tiled body against its plain version at RAGGED, a shape that is a
    multiple of no tile edge above 1, with no TYPE_E shell and solid cells
    on all six boundary planes (the flag ring's and the pulls'
    periodic wrap on every axis), 3 steps in every storage: the plain family
    (no wall model, SRT) with and without the volume force
    (nudge + sponge), each with and without random VK sites; and, with
    random VK sites, `wall`, `wall_sides`, TRT, TRT with `wall_sides`;
    thermal plain, with `wall_sides` and with TRT (by stored codes).
    ({config: max decoded difference} of the plain, of the wall / TRT and of
    the thermal runs, {config: thermal code shares})."""
    plain, wall, therm, shares = {}, {}, {}, {}
    for storage in STORAGES:
        for variant, thermal, forcing, sites in (
                ("", False, True, False), ("", False, True, True),
                ("", False, False, False), ("", False, False, True),
                ("wall", False, True, True), ("wall+sides", False, True, True),
                ("trt", False, True, True), ("trt+wall+sides", False, True, True),
                ("", True, True, True), ("wall+sides", True, True, True),
                ("trt", True, True, True)):
            e, finite, _, diffs = compare_steps(
                RAGGED, storage, forcing, 3,
                vk=random_sites(RAGGED) if sites else None,
                inflow=0.05 if sites else 0.0, variant=variant,
                thermal=thermal, wrap=True)
            name = (f"{storage} {'nudge+sponge' if forcing else 'flagship'}"
                    f"{' thermal' if thermal else ''}"
                    f"{' ' + variant if variant else ''}"
                    f"{' VK random sites' if sites else ''}, "
                    f"solids on the boundary planes {RAGGED}")
            tol = tolerance(storage, variant)
            if thermal:
                ok = finite and all(
                    d["bad"] == 0 and d["over"] <= THERMAL_STEP_SHARE
                    and d["differing"] <= THERMAL_DIFFERING_SHARE
                    for d in diffs.values())
                e = max(d["max_abs"] for d in diffs.values())
                shares[name] = {k: {"over": d["over"], "differing": d["differing"]}
                                for k, d in diffs.items()}
            else:
                ok = finite and e <= tol
            log(f"K-SC {name} 3 steps: max|kernel-plain| = {e:.3e} (tol {tol:.0e}"
                f"{', thermal by stored codes' if thermal else ''}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the tiled body disagrees with its plain "
                                     f"version: {name}: {diffs or e}")
            (therm if thermal else wall if variant else plain)[name] = e
    return plain, wall, therm, shares


def compare_pair(big: bool = True) -> dict:
    """K-SC's paired instance (the plain family in bf16 and f16 with X even:
    two cells per thread along x) against the plain version, 3 steps from
    each case: at RAGGED_EVEN with the LUW shell and with solid cells on all
    six boundary planes (so columns 0 and X - 1 hold solids: the x-wrap and
    the bounce-back inside a pair), in both storages, with nudge + sponge
    and random VK sites, without them and without the volume force; with
    `big` also at the profile deck's grid (the VK hook's sites) and the
    `.luwdg` deck's, bf16.  RAGGED (X odd) must take the single-cell body:
    every case counts its paired launches in `stream_collide.launches_pair`
    and raises where that is not every step with X even and none with X
    odd.  {config: max decoded difference}."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    runs = [(shape, s, forcing, sites, wrap, False)
            for shape in (RAGGED_EVEN, RAGGED) for s in ("bf16", "f16")
            for forcing, sites in ((True, True), (True, False), (False, False))
            for wrap in (False, True)]
    if big:
        runs += [(MAIN_SHAPE, "bf16", True, False, False, True),
                 (DG_SHAPE, "bf16", True, False, False, False)]
    out = {}
    for shape, storage, forcing, sites, wrap, hook in runs:
        p0, l0 = stream_collide.launches_pair, stream_collide.launches
        e, finite, _, _ = compare_steps(
            shape, storage, forcing, 3,
            vk=random_sites(shape) if sites else None, hook=hook,
            inflow=0.05 if sites or hook else 0.0, wrap=wrap)
        paired = stream_collide.launches_pair - p0
        want = stream_collide.launches - l0 if shape[2] % 2 == 0 else 0
        name = (f"{storage} {'nudge+sponge' if forcing else 'flagship'}"
                f"{' VK random sites' if sites else ''}"
                f"{' VK hook sites' if hook else ''}"
                f"{', solids on the boundary planes' if wrap else ''} {shape}")
        tol = tolerance(storage)
        ok = finite and e <= tol and paired == want
        log(f"K-SC paired {name} 3 steps: max|kernel-plain| = {e:.3e} (tol "
            f"{tol:.0e}), paired launches {paired} (want {want}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the paired instance: {name}: {e}, "
                                 f"{paired} paired launches of {want}")
        out[name] = e
        torch.cuda.empty_cache()
    return out


def random_halo(shape, storage, thermal, seed=11, gy=1, gx=1):
    """Random z-halo planes for a slab of `shape`: both sides' 5 channels as
    views with a channel stride of three planes (the kernel takes any), flag
    planes 15% solid, and the g planes of a thermal slab.  They are not the
    slab's own edge planes, so a kernel that wraps instead of reading them
    disagrees with the plain version."""
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S, ZHalo, encode_ddf

    _, Y, X = shape
    rng = np.random.default_rng(seed)

    def ddf(*s):
        v = torch.from_numpy((0.01 * rng.standard_normal(s)).astype(np.float32))
        return encode_ddf(v.to(DEVICE), storage)

    def flag():
        return torch.from_numpy(np.where(rng.random((Y, X)) < 0.15, TYPE_S, 0)
                                .astype(np.uint8)).to(DEVICE)

    below, above = ddf(19, 3, Y, X), ddf(19, 3, Y, X)
    return ZHalo(fp=below[9:14, 1], fm=above[14:19, 1], flb=flag(), fla=flag(),
                 gp=ddf(Y, X) if thermal else None,
                 gm=ddf(Y, X) if thermal else None, gy=gy, gx=gx)


def compare_halo(small) -> tuple:
    """K8, the halo mode of K-SC, against its plain version on one slab with
    random halo planes and ghost widths (1, 1), 3 steps: every storage; the
    no-wall step with and without the volume force, `wall_model`,
    `wall_sides`, TRT, and thermal (the strong-buoyancy case) without a wall
    model, with `wall_sides` and with TRT; each with nudge + sponge without
    and with random VK sites (the sites then sit on the box inside the
    ghosts); and slabs of one plane (both halos at once), of two and of five
    (thinner than a block's planes, y and x ragged: THIN_SLABS) in bf16 and
    f32: the plain family with and without the volume force, `wall_sides`,
    thermal and thermal TRT with `wall_sides`.  ({config: max decoded
    difference}, {config: thermal code shares})."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    errs, shares = {}, {}
    families = [("", True, False), ("", False, False), ("wall", True, False),
                ("wall+sides", True, False), ("trt", True, False),
                ("", True, True), ("wall+sides", True, True), ("trt", True, True)]
    runs = [(small, storage, variant, forcing, thermal, sites)
            for storage in STORAGES for variant, forcing, thermal in families
            for sites in ((False, True) if forcing else (False,))]
    # slabs of one plane (both halos at once), of two, and one thinner than
    # a block's planes with a ragged tail on y and x
    runs += [(thin, storage, variant, forcing, thermal, forcing)
             for thin in THIN_SLABS for storage in ("bf16", "f32")
             for variant, forcing, thermal in (
                 ("", True, False), ("", False, False), ("wall+sides", True, False),
                 ("", True, True), ("trt+wall+sides", True, True))]
    for shape, storage, variant, forcing, thermal, sites in runs:
        cfg, st, frc, row = make_case(shape, storage, forcing=forcing,
                                      inflow=0.05 if sites else 0.0,
                                      variant=variant, thermal=thermal,
                                      slab=True)
        vk = random_sites(shape) if sites else None
        fbc = build_face_bc(st.u, st.T) if (forcing or sites) else None
        h = random_halo(shape, storage, thermal)
        fk, fp = st.fi, st.fi.clone()
        gk = [st.gi, torch.empty_like(st.gi)] if thermal else [None, None]
        gp = ([st.gi.clone(), torch.empty_like(st.gi)] if thermal
              else [None, None])
        for _ in range(3):
            fk = stream_collide(fk, st.flags, row, cfg, frc, fbc, vk=vk,
                                gi=gk[0], gi_out=gk[1], halo=h)
            fp = stream_collide_plain(fp, st.flags, row, cfg, frc, fbc,
                                      vk=vk, gi=gp[0], gi_out=gp[1],
                                      halo=h)
            gk.reverse()
            gp.reverse()
        torch.cuda.synchronize()
        name = (f"{storage} {'nudge+sponge' if forcing else 'flagship'}"
                f"{' thermal' if thermal else ''}"
                f"{' ' + variant if variant else ''}"
                f"{' VK random sites' if sites else ''} {shape}")
        tol = tolerance(storage, variant)
        finite = bool(torch.isfinite(decode_ddf(fk, storage)).all())
        if thermal:
            diffs = {"f": thermal_diff(fk, fp, storage, tol),
                     "g": thermal_diff(gk[0], gp[0], storage, tol)}
            ok = finite and all(
                d["bad"] == 0 and d["over"] <= THERMAL_STEP_SHARE
                and d["differing"] <= THERMAL_DIFFERING_SHARE
                for d in diffs.values())
            e = max(d["max_abs"] for d in diffs.values())
            shares[name] = {k: {"over": d["over"],
                                "differing": d["differing"]}
                            for k, d in diffs.items()}
        else:
            e = max_err(fk, fp, storage)
            ok = finite and e <= tol
        log(f"K8 {name} 3 steps: max|kernel-plain| = {e:.3e} (tol "
            f"{tol:.0e}{', thermal by stored codes' if thermal else ''})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K8 disagrees with its plain version: "
                                 f"{name}: {e}")
        errs[name] = e
        torch.cuda.empty_cache()
    # the halo planes matter: the plain step of the same slab that wraps
    # inside it instead of reading them lands far outside the tolerance
    cfg, st, frc, row = make_case(small, "f32", slab=True)
    fbc = build_face_bc(st.u)
    h = random_halo(small, "f32", False)
    moved = max_err(stream_collide_plain(st.fi, st.flags, row, cfg, frc, fbc,
                                         halo=h),
                    stream_collide_plain(st.fi, st.flags, row, cfg, frc, fbc))
    log(f"K8 f32 {small}: one step with the random halos against the step that "
        f"wraps inside the slab: max difference {moved:.3e}")
    if not moved > 100 * TOL["f32"]:
        raise AssertionError("the random halo planes do not move the step")
    return errs, shares


def all_face_sites(shape, seed=5):
    """Random 0/1 masks on all six faces."""
    spec = random_sites(shape, seed)
    Y, X = shape[1:]
    rng = np.random.default_rng(seed + 1)
    spec["masks"]["ub"] = torch.from_numpy(
        (rng.random((Y, X)) < 0.5).astype(np.float32)).to(DEVICE)
    spec["sites"] += (("plane0", "ub"),)
    return spec


def compare_vk_sites() -> dict:
    """The VK site pass alone (`vk_sites`, K6) against `apply_vk_sites` on
    the same encoded step outputs, in every storage: on the inlet hook's
    masks at the main grid (the four side faces the deck's inlet takes)
    and on random masks over all six faces of a slab's box one cell inside
    its y and x edges (gy = gx = 1).  The kernel rounds each site's
    equilibrium and blend as the plain version does, one multiply or add
    at a time, so the stored codes must be EQUAL; returns {config:
    (differing codes (0), codes the sites set, largest decoded
    difference (0))}."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        apply_vk_sites, build_face_bc, stream_collide, vk_sites, _inner_box,
    )

    out = {}
    hook_st = None
    for shape, kind, gy, gx in ((MAIN_SHAPE, "hook", 0, 0),
                                ((24, 72, 136), "all six faces", 1, 1)):
        for storage in STORAGES:
            cfg, st, frc, row = make_case(shape, storage, inflow=0.05)
            if kind == "hook":
                if hook_st is None:
                    hook_st = vk_hook(st)[0].ddf.kernel_spec
                vk = hook_st
            else:
                vk = all_face_sites(shape)
            fbc = build_face_bc(st.u)
            step = stream_collide(st.fi, st.flags, row, cfg, frc, fbc)
            before = vk_sites.launches
            got = vk_sites(step.clone(), fbc, vk, storage, gy=gy, gx=gx)
            want = step.clone()
            apply_vk_sites(*_inner_box(want, fbc, vk, gy, gx), storage)
            torch.cuda.synchronize()
            moved = int((code_bits(got) != code_bits(step)).sum())
            differing = int((code_bits(got) != code_bits(want)).sum())
            e = max_err(got, want, storage)
            ok = vk_sites.launches == before + 1 and moved > 0 and differing == 0
            name = f"{storage} {kind} {shape} gy={gy} gx={gx}"
            log(f"vk_sites {name}: {moved} codes set by the sites, "
                f"{differing} codes differ from apply_vk_sites, "
                f"max|kernel-plain| = {e:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the VK site pass disagrees with "
                                     f"apply_vk_sites: {name}: {differing} "
                                     f"codes, {e}")
            out[name] = {"differing": differing, "set": moved, "max_abs": e}
            del st, step, got, want
            torch.cuda.empty_cache()
    return out


def codes_apart(a: torch.Tensor, b: torch.Tensor) -> dict:
    """How two tensors of stored values differ: the number of differing
    elements and the largest distance in storage steps (f32: decoded)."""
    if a.dtype == torch.float32:
        d = (a - b).abs()
        return {"differing": int((d > 0).sum()), "max": float(d.max())}
    steps = stored_steps(a, b)
    return {"differing": int((steps > 0).sum()), "max": int(steps.max())}


def compare_sharded() -> dict:
    """The sharded runner with every shard on cuda:0 (one K8 launch per
    shard and step, the ghost exchange and halo views between) against the
    single-device runner (K-SC) on the same case, 6 steps in two calls with
    the case's VK hook, over the four splits: f32 and bf16 nudge + sponge,
    bf16 `wall_sides`, thermal bf16 and fp16c.  Each cell runs the same
    arithmetic on the same inputs, so the stored DDFs (and g), and rho, u
    (and T) from the fields pass, must be EQUAL; returns their differences
    (all zero)."""
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    shape = (24, 72, 136)
    out = {}
    for storage, variant, thermal in (("f32", "", False), ("bf16", "", False),
                                      ("bf16", "wall+sides", False),
                                      ("bf16", "", True), ("fp16c", "", True)):
        cfg, st, frc, row = make_case(shape, storage, inflow=0.05,
                                      variant=variant, thermal=thermal)
        dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
        pre, _ = vk_hook(st)
        run, _ = make_runner(cfg, frc, shape=shape, device=DEVICE, pre_step=pre)
        single = run(st._replace(fi=st.fi.clone(),
                                 gi=None if st.gi is None else st.gi.clone()),
                     dyn, 0, 6)
        single = update_fields(single, cfg, dyn)
        for split in SPLITS:
            mesh = domain_mesh(split, shape, SHARD_DEVICE)
            srun, impl = make_sharded_runner(cfg, frc, mesh, pre_step=pre,
                                             init_u=st.u, init_T=st.T)
            halo0 = stream_collide.launches_halo
            ss = srun(shard_state(st, mesh), dyn, 0, 3)
            ss = srun(ss, dyn, 3, 3)
            got = gather_state(update_fields_sharded(ss, cfg, dyn), DEVICE)
            torch.cuda.synchronize()
            launched = stream_collide.launches_halo - halo0
            diff = {k: codes_apart(getattr(got, k), getattr(single, k))
                    for k in ("fi", "gi", "rho", "u", "T")
                    if getattr(single, k) is not None}
            name = (f"{storage} nudge+sponge{' thermal' if thermal else ''}"
                    f"{' ' + variant if variant else ''} hook sites {shape} "
                    f"split {list(split)}")
            ok = (impl == "cuda-sharded" and launched == 6 * mesh.n
                  and all(d["differing"] == 0 for d in diff.values()))
            log(f"sharded runner {name}, 6 steps ({launched} K8 launches) "
                f"against the single-device kernel: differing elements "
                + ", ".join(f"{k} {d['differing']}" for k, d in diff.items())
                + f" {'equal' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the sharded runner differs from the "
                                     f"single-device kernel: {name}: {diff}")
            out[name] = diff
        del st, single, ss, got
        torch.cuda.empty_cache()
    return out


def compare_avg(name, cfg, st, frc, row, fbc, fi) -> float:
    """K-AVG against update_fields + welford_update: 4 samples from `fi` and
    the DDFs of the kernel steps after it; returns the largest difference
    of the accumulators at fluid cells (raises beyond AVG_TOL)."""
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import DynParams, TYPE_S
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    shape = tuple(st.flags.shape)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    ak = init_avg(shape, False, DEVICE)
    ap = init_avg(shape, False, DEVICE)
    for k in range(4):
        ak = avg_update(fi, st.flags, row, 1.0 / (k + 1), ak, cfg)
        ap = welford_update(ap, update_fields(st._replace(fi=fi), cfg, dyn))
        fi = stream_collide(fi, st.flags, row, cfg, frc, fbc)
    torch.cuda.synchronize()
    fluid = (st.flags & TYPE_S) == 0
    e = max(float((ak.mean_u[:, fluid] - ap.mean_u[:, fluid]).abs().max()),
            float((ak.m2_u[fluid] - ap.m2_u[fluid]).abs().max()),
            float((ak.mean_rho[fluid] - ap.mean_rho[fluid]).abs().max()))
    ok = e <= AVG_TOL and bool(torch.isfinite(ak.mean_u).all())
    log(f"K-AVG {name} 4 samples: max|kernel-plain| at fluid cells = "
        f"{e:.3e} (tol {AVG_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K-AVG disagrees with its plain version: {e}")
    return e


def compare_avg_ragged() -> dict:
    """K-AVG at RAGGED, a shape that is a multiple of no tile edge above 1,
    with no TYPE_E shell and solid cells on all six boundary planes (its
    flag ring's and its pulls' periodic wrap on every axis), in every
    storage, without a wall model, with `wall_model` and with
    `wall_sides`: {config: max difference at fluid cells}."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import build_face_bc

    out = {}
    for storage in STORAGES:
        for variant in ("", "wall", "wall+sides"):
            cfg, st, frc, row = make_case(RAGGED, storage, inflow=0.05,
                                          variant=variant, wrap=True)
            name = (f"{storage} nudge+sponge{' ' + variant if variant else ''}"
                    f", solids on the boundary planes {RAGGED}")
            out[name] = compare_avg(name, cfg, st, frc, row,
                                    build_face_bc(st.u), st.fi)
    return out


def phase_compare() -> dict:
    """Kernels against plain versions on the card; returns the errors."""
    log("== phase 2: kernels against their plain versions on the card")
    errs = {"stream_collide": {}, "stream_collide_wall": {},
            "avg_update": {}}
    small = (24, 72, 136)
    runs = [(small, s, f, 5, "") for s in STORAGES for f in (True, False)]
    runs += [(small, s, True, 5, v) for s in STORAGES for v in VARIANTS]
    runs += [(MAIN_SHAPE, s, True, 2, "") for s in ("bf16", "fp16c")]
    for shape, storage, forcing, steps, variant in runs:
        e, finite, (cfg, st, frc, row, fbc, fk), _ = compare_steps(
            shape, storage, forcing, steps, variant=variant)
        name = (f"{storage} {'nudge+sponge' if forcing else 'flagship'}"
                f"{' ' + variant if variant else ''} {shape}")
        tol = tolerance(storage, variant)
        ok = e <= tol and finite
        log(f"K-SC {name} {steps} steps: max|kernel-plain| = {e:.3e} "
            f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-SC disagrees with its plain version: {e}")
        errs["stream_collide_wall" if variant else "stream_collide"][name] = e

        errs["avg_update"][name] = compare_avg(name, cfg, st, frc, row, fbc,
                                               fk)
        del st, fk, frc, fbc
        torch.cuda.empty_cache()
    errs["avg_update"].update(compare_avg_ragged())

    # K-SC with VK inlet sites
    vk_runs = [(small, s, kind, 5, "") for s in STORAGES
               for kind in ("random", "hook")]
    vk_runs += [(MAIN_SHAPE, s, "hook", 2, "") for s in ("bf16", "fp16c")]
    vk_runs += [(MAIN_SHAPE, "bf16", "hook", 2, "wall+sides")]
    for shape, storage, kind, steps, variant in vk_runs:
        vk = random_sites(shape) if kind == "random" else None
        e, finite, _, _ = compare_steps(shape, storage, True, steps, vk=vk,
                                        hook=kind == "hook", inflow=0.05,
                                        variant=variant)
        name = (f"{storage} nudge+sponge{' ' + variant if variant else ''} "
                f"VK {kind} sites {shape}")
        tol = tolerance(storage, variant)
        ok = e <= tol and finite
        log(f"K-SC {name} {steps} steps: max|kernel-plain| = {e:.3e} "
            f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K-SC with VK sites disagrees: {e}")
        errs["stream_collide_wall" if variant else "stream_collide"][name] = e
        torch.cuda.empty_cache()

    errs["stream_collide_thermal"], errs["thermal_code_shares"] = \
        compare_thermal(small)
    plain, wall, therm, shares = compare_ragged()
    errs["stream_collide"].update(plain)
    errs["stream_collide_wall"].update(wall)
    errs["stream_collide_thermal"].update(therm)
    errs["thermal_code_shares"].update(shares)
    errs["stream_collide_pair"] = compare_pair()
    errs["stream_collide_halo"], errs["halo_code_shares"] = compare_halo(small)
    errs["sharded"] = compare_sharded()
    errs["vk_sites"] = compare_vk_sites()
    phase_codecs()
    return errs


def f32_sweep() -> np.ndarray:
    """Every float32 exponent band at a stride through the mantissa, the
    round-to-nearest-even ties and their neighbours at the fp16c (bit 11)
    and f16/bf16 cut points, both signs, infinities and NaNs."""
    exps = np.arange(0, 256, dtype=np.uint32) << 23
    ties = np.array([0x7FF, 0x800, 0x801, 0xFFF, 0x1000, 0x1800, 0x17FF,
                     0x1801, 0xFFF, 0x2000, 0x3000, 0x6000, 0x7FFF, 0x8000,
                     0x8001, 0xFFFF, 0x10000, 0x18000, 0x7FFFFF, 0, 1],
                    np.uint32)
    mants = np.unique(np.concatenate([np.arange(0, 1 << 23, 509, dtype=np.uint32),
                                      ties,
                                      (np.arange(1 << 11, dtype=np.uint32) << 12)
                                      | 0x800]))
    bits = (exps[:, None] | mants[None, :]).ravel()
    bits = np.concatenate([bits, bits | np.uint32(0x80000000)])
    return bits.view(np.float32)


def phase_codecs() -> None:
    """The device codecs against lbm/state.py, bit for bit."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf, encode_ddf
    from latticeurbanwind_tpu_torch.ops import codec

    x = torch.from_numpy(f32_sweep())
    xd = x.to(DEVICE)
    codes = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.uint16)
    for storage in STORAGES:
        want = encode_ddf(x, storage)
        got = codec.encode(xd, storage).cpu()
        if storage in ("f16", "bf16"):     # NaN payloads: compare NaN-ness
            nan = torch.isnan(x)
            same = bool(torch.equal(got[~nan].view(torch.int16),
                                    want[~nan].view(torch.int16))
                        and torch.isnan(got[nan].float()).all())
        else:
            same = torch.equal(got.view(torch.int16 if storage == "fp16c"
                                        else torch.int32),
                               want.view(torch.int16 if storage == "fp16c"
                                         else torch.int32))
        n_enc = x.numel()
        dec_note = ""
        if storage in ("f16", "fp16c"):
            bits = codes.view(torch.float16) if storage == "f16" else codes
            dw = decode_ddf(bits, storage)
            dg = codec.decode(bits.to(DEVICE), storage).cpu()
            nan = torch.isnan(dw)
            dsame = bool(torch.equal(dg[~nan].view(torch.int32),
                                     dw[~nan].view(torch.int32))
                         and torch.isnan(dg[nan]).all())
            dec_note = f", decode of all 65536 codes {'bit-exact' if dsame else 'DIFFERS'}"
            same = same and dsame
        log(f"codec {storage}: encode of {n_enc} float32 values "
            f"{'bit-exact' if same else 'DIFFERS'}{dec_note}")
        if not same:
            raise AssertionError(f"device codec {storage} is not bit-exact")


def copy_bandwidth() -> float:
    """Device-to-device copy bandwidth in GB/s (read + write of 4 GiB)."""
    src = torch.empty(1 << 30, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10)
    bw = 2 * src.numel() * 4 / (ms * 1e-3) / 1e9
    del src, dst
    torch.cuda.empty_cache()
    return bw


def bound(kernel: str, nbytes: float, cells: int) -> dict:
    """The least time the card could take: the larger of the bytes the call
    must move over the device memory rate and its float32 operations over
    the card's float32 rate (the published peaks)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_CELL[kernel] * cells / PEAK_F32_FLOPS * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def step_bound(st, frc, fbc, spec, halo=None) -> dict:
    """K-SC's bound on this case: every DDF written once, the DDFs of the
    cells that are not solid read once (a solid cell only writes zeros), the
    flags, the forcing fields, the FaceBC targets and the site masks read
    once; a thermal step moves the 7 g populations the same way; K8 also
    reads its halo planes once (5 channels and a flag plane each side, and
    the thermal g channel)."""
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S

    live = int(((st.flags & TYPE_S) == 0).sum())
    thermal = st.gi is not None
    per = (26 if thermal else 19) * st.fi.element_size()
    nbytes = (per * (st.flags.numel() + live) + _nbytes(
        st.flags, frc.nudge_sigma, frc.nudge_face, frc.sponge_sigma_z,
        *(fbc or ()), *((spec or {}).get("masks", {}).values()),
        *(() if halo is None else
          (halo.fp, halo.fm, halo.flb, halo.fla, halo.gp, halo.gm))))
    return bound("stream_collide_thermal" if thermal else "stream_collide",
                 nbytes, live)


SITE_FACE = {"planeL": (-1,), "plane0": (0,), "row0": (slice(None), 0),
             "rowL": (slice(None), -1), "lane0": (Ellipsis, 0),
             "laneL": (Ellipsis, -1)}


def site_faces(spec, shape, only_set=False) -> torch.Tensor:
    """(Z, Y, X) bool on the host: the cells on the faces that carry a site
    of `spec` (with `only_set`, only those whose mask is set)."""
    on = torch.zeros(shape, dtype=torch.bool)
    for kind, field in spec["sites"]:
        if not only_set:
            on[SITE_FACE[kind]] = True
            continue
        m = spec["masks"][field].cpu() != 0
        on[SITE_FACE[kind]] |= m if kind.startswith("plane") else m[:, 0]
    return on


def time_site_pass(shape, storage) -> dict:
    """The VK site pass alone (`vk_sites`) at `shape` with the inlet hook's
    sites (the faces the deck's inlet takes), by CUDA events, against its
    plain version, with two bounds.  The element bound: the DDFs of every
    cell on a masked face read and written once, and per site of a cell its
    mask value and the FaceBC velocity (3 f32) read once; 120 operations
    per site.  The sector bound: the same, but the DDFs moved as the
    distinct 32-byte sectors their elements lie in (read and written), as
    the SoA layout places them: a lane face's (x = 0 or X-1) neighbours
    along y lie X elements apart, while the east cell of row y and the west
    cell of row y + 1 may share a sector."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        apply_vk_sites, build_face_bc, vk_sites,
    )

    cfg, st, frc, row = make_case(shape, storage, inflow=0.05)
    pre, _ = vk_hook(st)
    spec = pre.ddf.kernel_spec
    fbc = build_face_bc(st.u)
    on = site_faces(spec, shape)
    sites = sum(on[SITE_FACE[kind]].numel() for kind, _ in spec["sites"])
    lanes = on.clone()
    lanes[..., 1:-1] = False
    for kind, _ in spec["sites"]:
        if not kind.startswith("lane"):
            lanes[SITE_FACE[kind]] = False
    cells = int(on.sum())
    elem = st.fi.element_size()
    site_bytes = sites * 4 * 4
    nbytes = cells * 2 * 19 * elem + site_bytes
    # the sectors of the 19 channels' elements of every face cell, offsets
    # from the tensor's (512-byte aligned) base
    cell = torch.nonzero(on.flatten()).flatten().to(DEVICE)
    chan = torch.arange(19, device=DEVICE)[:, None] * on.numel()
    sectors = int(torch.unique(((chan + cell[None]) * elem) // 32).numel())
    sector_bytes = sectors * 32 * 2 + site_bytes
    out = st.fi
    ms = cuda_ms(lambda: vk_sites(out, fbc, spec, storage), reps=50, warmup=5)
    plain = cuda_ms(lambda: apply_vk_sites(out, fbc, spec, storage), reps=3,
                    warmup=1)
    sector = bound("vk_site", sector_bytes, sites)
    del st, pre, out, cell
    torch.cuda.empty_cache()
    return dict(bound("vk_site", nbytes, sites), ms=ms, plain_ms=plain,
                cells=cells, lane_cells=int(lanes.sum()), sites=sites,
                sectors=sectors, sector_bound_ms=sector["bound_ms"],
                sector_bound_by=sector["bound_by"])


def avg_bound(st) -> dict:
    """K-AVG's bound: the DDFs and the five f32 accumulators (read and
    written) of the cells that are not solid, and the flags."""
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S

    live = int(((st.flags & TYPE_S) == 0).sum())
    nbytes = live * (19 * st.fi.element_size() + 2 * 5 * 4) + st.flags.numel()
    return bound("avg_update", nbytes, live)


def time_step_kernel(shape, storage, forcing, *, vk=None, plain_reps=3,
                     variant="", thermal=False):
    """{ms, plain_ms, bound_ms, bound_by}: K-SC and its plain version per
    step at `shape`."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    cfg, st, frc, row = make_case(shape, storage, forcing=forcing,
                                  inflow=0.05 if vk else 0.0, variant=variant,
                                  thermal=thermal)
    spec = None
    if vk:
        pre, _ = vk_hook(st)
        spec = pre.ddf.kernel_spec
    fbc = build_face_bc(st.u, st.T) if (forcing or spec) else None
    bufs = [st.fi, torch.empty_like(st.fi)]
    gbufs = [st.gi, torch.empty_like(st.gi)] if thermal else [None, None]

    def step():
        stream_collide(bufs[0], st.flags, row, cfg, frc, fbc, out=bufs[1],
                       vk=spec, gi=gbufs[0], gi_out=gbufs[1])
        bufs.reverse()
        gbufs.reverse()

    ms = cuda_ms(step, reps=50, warmup=5)
    plain = cuda_ms(lambda: stream_collide_plain(bufs[0], st.flags, row, cfg,
                                                 frc, fbc, vk=spec,
                                                 gi=gbufs[0], gi_out=gbufs[1]),
                    reps=plain_reps, warmup=1)
    return {"ms": ms, "plain_ms": plain, **step_bound(st, frc, fbc, spec)}


def time_thermal_fields(shape, storage) -> dict:
    """{ms, peak_gib}: the thermal `update_fields` (plain torch; a thermal
    run takes it at every averaging sample) alone at `shape`, by CUDA
    events, and the device memory it peaks at above the resident state."""
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import DynParams

    cfg, st, _, row = make_case(shape, storage, thermal=True)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: update_fields(st, cfg, dyn), reps=5, warmup=1)
    return {"ms": ms,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def time_avg_kernel(shape, storage, variant=""):
    """{ms, plain_ms, bound_ms, bound_by, max_abs_err}: K-AVG and its plain
    version per sample at `shape`, and the kernel held to the plain version
    there: two samples (the case's DDFs, then them shifted by a cell
    along x) into separate accumulators, compared at fluid cells (raises
    beyond AVG_TOL)."""
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S
    from latticeurbanwind_tpu_torch.ops.avg_kernel import (
        avg_update, avg_update_plain,
    )
    from latticeurbanwind_tpu_torch.run.welford import init_avg

    cfg, st, _, row = make_case(shape, storage, forcing=bool(variant),
                                variant=variant)
    ak = init_avg(shape, False, DEVICE)
    ap = init_avg(shape, False, DEVICE)
    shifted = torch.roll(code_bits(st.fi), 1, dims=3).view(st.fi.dtype)
    for k, fi in enumerate((st.fi, shifted)):
        avg_update(fi, st.flags, row, 1.0 / (k + 1), ak, cfg)
        avg_update_plain(fi, st.flags, row, 1.0 / (k + 1), ap, cfg)
    del fi, shifted
    torch.cuda.synchronize()
    fluid = (st.flags & TYPE_S) == 0
    e = max(float((ak.mean_u[:, fluid] - ap.mean_u[:, fluid]).abs().max()),
            float((ak.m2_u[fluid] - ap.m2_u[fluid]).abs().max()),
            float((ak.mean_rho[fluid] - ap.mean_rho[fluid]).abs().max()))
    ok = e <= AVG_TOL and bool(torch.isfinite(ak.mean_u).all()) and bool(
        (ak.m2_u[fluid] > 0).any())
    log(f"K-AVG {shape} {storage} {variant or 'no wall'} 2 samples: "
        f"max|kernel-plain| at fluid cells = {e:.3e} (tol {AVG_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K-AVG disagrees with its plain version at "
                             f"{shape} {storage} {variant}: {e}")
    del ap, fluid
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: avg_update(st.fi, st.flags, row, 0.5, ak, cfg),
                 reps=20, warmup=3)
    plain = cuda_ms(lambda: avg_update_plain(st.fi, st.flags, row, 0.5, ak,
                                             cfg),
                    reps=3, warmup=1)
    return {"ms": ms, "plain_ms": plain, "max_abs_err": e, **avg_bound(st)}


def run_ahead(fn, n: int = 16, sleep_cycles: int = 400_000_000):
    """(host ms, device ms) per call of `fn`: n calls enqueued behind a
    device sleep (~0.2 s), so the host runs ahead of the card and the events
    around the calls time the device work alone.  Raises when the sleep
    ended before the host had enqueued the n calls.  The n calls' launches
    must fit the card's queue of pending launches (~1000): beyond it a
    launch waits for the device and the host no longer runs ahead."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    ahead = not a.query()
    b.record()
    b.synchronize()
    if not ahead:
        raise AssertionError("the device sleep ended before the host had "
                             f"enqueued {n} calls ({host_ms:.3f} ms each)")
    return host_ms, a.elapsed_time(b) / n


def step_loop_breakdown(case, final) -> dict:
    """The deck's step loop taken apart with the run's own configuration,
    forcing and inlet hook, from its `final` state's DDFs (f, and g of a
    thermal run): ms/step of K-SC without and with the sites and of the whole
    step (refresh + K-SC with sites, as the stepper runs it) by CUDA events,
    and the refresh, the K-SC call and the whole step by host enqueue time
    and device time; thermal: `update_fields` per averaging sample too."""
    from latticeurbanwind_tpu_torch.lbm.state import dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, vk_sites,
    )

    pre = case.pre_step.ddf
    spec = pre.kernel_spec
    row = dyn_row(case.dyn, DEVICE)
    flags = case.state.flags
    thermal = case.config.thermal
    bufs = [final.fi.clone(), torch.empty_like(final.fi)]
    gbufs = ([final.gi.clone(), torch.empty_like(final.gi)] if thermal
             else [None, None])
    cell = {"fbc": build_face_bc(case.state.u, case.state.T if thermal else None),
            "aux": pre.init_aux(0), "t": 0}

    def refresh():
        cell["fbc"], cell["aux"] = pre(cell["fbc"], cell["t"], cell["aux"])
        cell["t"] += 1

    def step(vk=spec, config=case.config):
        stream_collide(bufs[0], flags, row, config, case.forcing,
                       cell["fbc"], out=bufs[1], vk=vk, gi=gbufs[0],
                       gi_out=gbufs[1])
        bufs.reverse()
        gbufs.reverse()

    def whole():
        refresh()
        step()

    out = {"sc_novk_ms": cuda_ms(lambda: step(None), reps=50, warmup=3),
           "sc_vk_ms": cuda_ms(step, reps=50, warmup=3),
           "step_ms": cuda_ms(whole, reps=100, warmup=5),
           # the site pass alone on the run's state
           "sites_ms": cuda_ms(lambda: vk_sites(bufs[0], cell["fbc"], spec,
                                                case.config.storage),
                               reps=50, warmup=3)}
    for name, fn in (("refresh", refresh), ("sc_vk", step), ("step", whole)):
        out[f"{name}_host_ms"], out[f"{name}_device_ms"] = run_ahead(fn)
    if case.config.wall_model:
        # K-SC with sites on this state with less of the wall model: where
        # the wall instances' time goes
        plain = replace(case.config, wall_model=False, wall_cd=0.0,
                        wall_sides=False, wall_cd_sides=0.0)
        ground = replace(case.config, wall_sides=False, wall_cd_sides=0.0)
        mirrors = replace(case.config, wall_cd_sides=0.0)
        for name, cfg in (("sc_vk_nowall_ms", plain), ("sc_vk_ground_ms", ground),
                          ("sc_vk_sides_cd0_ms", mirrors)):
            out[name] = cuda_ms(lambda c=cfg: step(config=c), reps=50, warmup=3)
    if thermal:
        from latticeurbanwind_tpu_torch.lbm.fields import update_fields

        st = final._replace(fi=bufs[0], gi=gbufs[0])
        out["update_fields_ms"] = cuda_ms(
            lambda: update_fields(st, case.config, case.dyn), reps=5, warmup=1)
    del bufs, gbufs
    torch.cuda.empty_cache()
    return out


def time_halo_kernel(local) -> dict:
    """K8 at a shard's ghost-extended shape `local` (bf16, nudge + sponge,
    the VK hook's sites) with random halo planes (ghosts on y, as the split
    deck's shards have them): one step held against its plain version at
    the bf16 tolerance (`max_abs_err`; raises when it disagrees), then ms
    per step with and without the sites against the non-halo K-SC instance
    on the same shard and the plain version, and the bound of the K8 call."""
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    cfg, st, frc, row = make_case(local, "bf16", inflow=0.05, slab=True)
    pre, _ = vk_hook(st)
    spec = pre.ddf.kernel_spec
    fbc = build_face_bc(st.u)
    h = random_halo(local, "bf16", False, gy=1, gx=0)
    got = stream_collide(st.fi, st.flags, row, cfg, frc, fbc, vk=spec, halo=h)
    want = stream_collide_plain(st.fi, st.flags, row, cfg, frc, fbc, vk=spec,
                                halo=h)
    torch.cuda.synchronize()
    err, tol = max_err(got, want, "bf16"), tolerance("bf16")
    ok = err <= tol and bool(torch.isfinite(decode_ddf(got, "bf16")).all())
    log(f"K8 bf16 nudge+sponge VK hook sites {local} (the split deck's shard, "
        f"random halos) 1 step: max|kernel-plain| = {err:.3e} (tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K8 disagrees with its plain version at the "
                             f"split deck's shard {local}: {err}")
    del got, want
    bufs = [st.fi, torch.empty_like(st.fi)]

    def step(halo, vk):
        stream_collide(bufs[0], st.flags, row, cfg, frc, fbc, out=bufs[1],
                       vk=vk, halo=halo)
        bufs.reverse()

    out = {"ms": cuda_ms(lambda: step(h, spec), reps=50, warmup=5),
           "ms_no_sites": cuda_ms(lambda: step(h, None), reps=50, warmup=5),
           "non_halo_ms": cuda_ms(lambda: step(None, spec), reps=50, warmup=5),
           "non_halo_ms_no_sites": cuda_ms(lambda: step(None, None), reps=50,
                                           warmup=5),
           "plain_ms": cuda_ms(lambda: stream_collide_plain(
               bufs[0], st.flags, row, cfg, frc, fbc, vk=spec, halo=h),
               reps=3, warmup=1),
           "max_abs_err": err,
           **step_bound(st, frc, fbc, spec, h)}
    out["halo_bytes"] = _nbytes(h.fp, h.fm, h.flb, h.fla)
    del bufs, st
    torch.cuda.empty_cache()
    return out


def kernels_per_call(fn, calls: int = 3) -> float:
    """Device operations (kernels and copies) per call of `fn`, counted by
    torch.profiler's CUDA activity over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls


def time_sharded_step() -> dict:
    """The whole step of the deck's split (SHARD_SPLIT, 4 shards on cuda:0)
    at the main grid (bf16, nudge + sponge, a VK hook), against the
    single-device step on the same case, and its parts, the runner's own
    stages (`run.stages`): ms per step by CUDA events, and host enqueue /
    device ms per call of the whole step, of the four K8 launches alone, of
    the ghost exchange with the z halos alone and of the FaceBC refresh with
    its per-shard slicing alone."""
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.halo import make_sharded_runner

    cfg, st, frc, row = make_case(MAIN_SHAPE, "bf16", inflow=0.05)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    pre, _ = vk_hook(st)
    run, _ = make_runner(cfg, frc, shape=MAIN_SHAPE, device=DEVICE, pre_step=pre)
    mesh = domain_mesh(SHARD_SPLIT, MAIN_SHAPE, SHARD_DEVICE)
    srun, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    one = {"s": st._replace(fi=st.fi.clone()), "t": 0}
    split = {"s": shard_state(st, mesh), "t": 0}

    def single_step():
        one["s"] = run(one["s"], dyn, one["t"], 1)
        one["t"] += 1

    def sharded_step():
        split["s"] = srun(split["s"], dyn, split["t"], 1)
        split["t"] += 1

    out = {"single_step_ms": cuda_ms(single_step, reps=50, warmup=5),
           "sharded_step_ms": cuda_ms(sharded_step, reps=50, warmup=5)}

    def enqueue(name, fn):
        # 8 calls: a one-step run() call of the split step enqueues the
        # inlet's anchors and refresh, the FaceBC slices, the exchange and 4
        # K8 with their site passes (`*_device_ops`); 16 calls overflow the
        # launch queue
        out[f"{name}_host_ms"], out[f"{name}_device_ms"] = run_ahead(fn, n=8)
        out[f"{name}_device_ops"] = kernels_per_call(fn)

    enqueue("single_step", single_step)
    enqueue("sharded_step", sharded_step)
    # the stages last: they step into the runner's spare buffers
    stage = srun.stages(split["s"], dyn, split["t"])
    for fn in (stage.refresh, stage.exchange, stage.kernels):
        fn()
    for key, fn in (("k8_x4", stage.kernels), ("exchange", stage.exchange),
                    ("refresh_slice", stage.refresh)):
        out[f"{key}_ms"] = cuda_ms(fn, reps=50, warmup=5)
        enqueue(key, fn)
    del one, split, stage, st
    torch.cuda.empty_cache()
    return out


def phase_timing() -> dict:
    log("== phase 3: timing (CUDA events, after warm-up)")
    bw = copy_bandwidth()
    log(f"device-to-device copy bandwidth: {bw:.1f} GB/s")
    cube = CUBE
    cells = float(np.prod(cube))
    out = {"copy_gbps": bw, "configs": {}}
    runs = [(s, False, "") for s in STORAGES]
    runs += [(s, True, v) for s in ("bf16", "f32")
             for v in ("", "wall", "wall+sides", "trt")]
    for storage, forcing, variant in runs:
        t = time_step_kernel(cube, storage, forcing, variant=variant)
        ms, plain = t["ms"], t["plain_ms"]
        bpc = BYTES_PER_CELL[storage] + (NUDGE_BYTES if forcing else 0)
        mlups = cells / (ms * 1e-3) / 1e6
        roof = mlups * 1e6 * bpc / 1e9 / bw * 100.0
        name = (f"{cube[0]}^3 {storage} {'nudge+sponge' if forcing else 'flagship'}"
                f"{' ' + variant if variant else ''}")
        log(f"K-SC {name}: {ms:.3f} ms/step, {mlups:.0f} MLUPs, {roof:.1f}% of "
            f"the {bpc} B/cell copy roofline; bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}); plain version {plain:.2f} ms/step "
            f"({plain / ms:.1f}x the kernel)")
        out["configs"][f"K-SC {name}"] = dict(t, roofline_pct=roof)
        torch.cuda.empty_cache()
    for storage, variant in (("bf16", ""), ("fp16c", ""), ("bf16", "wall+sides")):
        t = time_avg_kernel(cube, storage, variant)
        name = f"K-AVG {cube[0]}^3 {storage}{' ' + variant if variant else ''}"
        log(f"{name}: {t['ms']:.3f} ms/sample; bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}); plain version {t['plain_ms']:.2f} ms/sample "
            f"({t['plain_ms'] / t['ms']:.1f}x the kernel)")
        out["configs"][name] = t
        torch.cuda.empty_cache()
    # at the main path's grid and configuration (these go into the record)
    for key, variant in (("sc", ""), ("sc_wall", "wall+sides")):
        t = time_step_kernel(MAIN_SHAPE, "bf16", True, vk=True, variant=variant)
        name = f"K-SC {MAIN_SHAPE} bf16 nudge+sponge{' ' + variant if variant else ''} VK sites"
        log(f"{name}: {t['ms']:.3f} ms/step, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.2f}")
        out["configs"][name] = out[key] = t
        torch.cuda.empty_cache()
    for key, shape in (("sites", MAIN_SHAPE), ("sites_nwp", NWP_SHAPE)):
        t = time_site_pass(shape, "bf16")
        name = f"VK site pass {shape} bf16, the inlet hook's sites"
        log(f"{name}: {t['cells']} cells ({t['lane_cells']} on a lane face "
            f"alone), {t['sites']} sites, {t['sectors']} DDF sectors; "
            f"{t['ms']:.4f} ms alone; element "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), sector bound "
            f"{t['sector_bound_ms']:.4f} ms; plain {t['plain_ms']:.2f}")
        out["configs"][name] = out[key] = t
    for key, variant in (("av", ""), ("av_wall", "wall+sides")):
        t = time_avg_kernel(MAIN_SHAPE, "bf16", variant)
        name = f"K-AVG {MAIN_SHAPE} bf16{' ' + variant if variant else ''}"
        log(f"{name}: {t['ms']:.3f} ms/sample, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.2f}")
        out["configs"][name] = out[key] = t
        torch.cuda.empty_cache()
    t = time_avg_kernel(NWP_SHAPE, "bf16")
    name = f"K-AVG {NWP_SHAPE} bf16"
    log(f"{name} (nwp-bf16-300's samples): {t['ms']:.3f} ms/sample, bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}), plain {t['plain_ms']:.2f}")
    out["configs"][name] = out["av_nwp"] = t
    torch.cuda.empty_cache()
    # K-SC thermal: 256^3, then the NWP deck's grid with VK sites (the record)
    for storage in ("bf16", "f32"):
        t = time_step_kernel(cube, storage, True, thermal=True)
        bpc = BYTES_PER_CELL[storage] + THERMAL_BYTES[storage] + NUDGE_BYTES
        mlups = cells / (t["ms"] * 1e-3) / 1e6
        roof = mlups * 1e6 * bpc / 1e9 / bw * 100.0
        name = f"K-SC {cube[0]}^3 {storage} thermal nudge+sponge"
        log(f"{name}: {t['ms']:.3f} ms/step, {mlups:.0f} MLUPs, {roof:.1f}% of "
            f"the {bpc} B/cell copy roofline; bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}); plain version {t['plain_ms']:.2f} ms/step")
        out["configs"][name] = dict(t, roofline_pct=roof)
        torch.cuda.empty_cache()
    # K1-K3 (the plain family) at the NWP deck's grid without T, as
    # `nwp-bf16-300` runs it
    t = time_step_kernel(NWP_SHAPE, "bf16", True, vk=True, plain_reps=1)
    name = f"K-SC {NWP_SHAPE} bf16 nudge+sponge VK sites"
    log(f"{name}: {t['ms']:.3f} ms/step, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}), plain {t['plain_ms']:.2f}")
    out["configs"][name] = out["sc_nwp"] = t
    torch.cuda.empty_cache()
    t = time_step_kernel(NWP_SHAPE, "bf16", True, vk=True, thermal=True,
                         plain_reps=2)
    name = f"K-SC {NWP_SHAPE} bf16 thermal nudge+sponge VK sites"
    log(f"{name}: {t['ms']:.3f} ms/step, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}), plain {t['plain_ms']:.2f}")
    out["configs"][name] = out["sc_thermal"] = t
    torch.cuda.empty_cache()
    t = time_thermal_fields(NWP_SHAPE, "bf16")
    log(f"update_fields thermal {NWP_SHAPE} bf16 (plain torch, every averaging "
        f"sample of a thermal run): {t['ms']:.2f} ms, transient peak "
        f"{t['peak_gib']:.2f} GiB above the state")
    out["thermal_fields"] = t
    torch.cuda.empty_cache()
    # K8 at the sharded deck's shard (SHARD_SPLIT of the main grid, ghost rows
    # on y), then the whole sharded step on one card
    from latticeurbanwind_tpu_torch.parallel import domain_mesh

    local = domain_mesh(SHARD_SPLIT, MAIN_SHAPE, "cpu").local_shape(0)
    t = time_halo_kernel(local)
    t["name"] = f"bf16 nudge+sponge VK hook sites {local}"
    name = f"K8 {local} bf16 nudge+sponge VK sites"
    log(f"{name}: {t['ms']:.3f} ms/step ({t['ms_no_sites']:.3f} without "
        f"sites) against the non-halo instance on the same shard "
        f"{t['non_halo_ms']:.3f} ({t['non_halo_ms_no_sites']:.3f}); bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}, halo planes "
        f"{t['halo_bytes'] / 1e6:.2f} MB); plain {t['plain_ms']:.2f}")
    out["configs"][name] = out["halo"] = t
    t = time_sharded_step()
    log(f"sharded step n_gpu={list(SHARD_SPLIT)} at {MAIN_SHAPE} bf16 "
        f"nudge+sponge VK hook, device operations per step "
        f"{t['sharded_step_device_ops']:.0f} (single-device step "
        f"{t['single_step_device_ops']:.0f}), ms/step by events: whole {t['sharded_step_ms']:.4f} "
        f"against the single-device step {t['single_step_ms']:.4f}; 4 K8 "
        f"{t['k8_x4_ms']:.4f}, ghost exchange {t['exchange_ms']:.4f}, FaceBC "
        f"refresh + slices {t['refresh_slice_ms']:.4f}; host enqueue / device "
        f"ms per call: whole {t['sharded_step_host_ms']:.4f} / "
        f"{t['sharded_step_device_ms']:.4f}, single-device step "
        f"{t['single_step_host_ms']:.4f} / {t['single_step_device_ms']:.4f}, "
        f"4 K8 {t['k8_x4_host_ms']:.4f} / {t['k8_x4_device_ms']:.4f}, "
        f"exchange {t['exchange_host_ms']:.4f} / {t['exchange_device_ms']:.4f}, "
        f"refresh + slices {t['refresh_slice_host_ms']:.4f} / "
        f"{t['refresh_slice_device_ms']:.4f}")
    out["sharded_step"] = t
    return out


def zero_launches() -> None:
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    stream_collide.launches = 0
    stream_collide.launches_vk = 0
    stream_collide.launches_wall = 0
    stream_collide.launches_thermal = 0
    stream_collide.launches_halo = 0
    stream_collide.launches_pair = 0
    avg_update.launches = 0
    avg_update.launches_wall = 0


def read_launches() -> dict:
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    return {"stream_collide": stream_collide.launches,
            "stream_collide_vk": stream_collide.launches_vk,
            "stream_collide_wall": stream_collide.launches_wall,
            "stream_collide_thermal": stream_collide.launches_thermal,
            "stream_collide_halo": stream_collide.launches_halo,
            "stream_collide_pair": stream_collide.launches_pair,
            "avg_update": avg_update.launches,
            "avg_update_wall": avg_update.launches_wall}


@contextlib.contextmanager
def timed_renders():
    """Spies on the driver's snapshot and frame writers for the run inside:
    each call's seconds on the host clock between two synchronisations of
    the card, its file and its path ("device": the fields on the card;
    "host": a split run's fields gathered to the host)."""
    import latticeurbanwind_tpu_torch.run.driver as driver

    renders = []
    real = {"snapshot": driver.write_snapshot, "frame": driver.write_frame}

    def spy(kind):
        def call(state, out_path, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = real[kind](state, out_path, **kw)
            torch.cuda.synchronize()
            renders.append({"kind": kind, "file": Path(path).name,
                            "seconds": time.perf_counter() - t0,
                            "path": ("device" if state.u.device.type == "cuda"
                                     else "host")})
            return path
        return call

    driver.write_snapshot, driver.write_frame = spy("snapshot"), spy("frame")
    try:
        yield renders
    finally:
        driver.write_snapshot, driver.write_frame = real["snapshot"], real["frame"]


def check_renders(tag: str, files: dict, renders: list, shape, nz_out: int,
                  snaps=(), frames=(), frame_every: int = 0,
                  path: str = "device") -> None:
    """Every snapshot PNG (at the steps `snaps`) with its `_3d.png` beside
    it, and every frame (at the steps `frames`) is among the run's files
    (`files`: name -> path), written on
    `path`, with the size its header gives: the panels 2 X + the Q
    projection's X + two gaps wide and as high as the tallest panel, the
    3-D images and the frames the camera's 960x720."""
    from latticeurbanwind_tpu_torch.io.png import png_size
    from latticeurbanwind_tpu_torch.run import snapshots

    Z, Y, X = shape
    cells = Z * Y * X
    qs = (int(np.ceil((cells / snapshots.Q_MAX_CELLS) ** (1.0 / 3.0)))
          if cells > snapshots.Q_MAX_CELLS else 1)
    panels = (2 * X + -(-X // qs) + 2 * snapshots.PANEL_GAP,
              max(Y, nz_out or Z, -(-Y // qs)))
    want = {}
    for t in snaps:
        want[f"{DATETIME}_{t:09d}.png"] = panels
        want[f"{DATETIME}_{t:09d}_3d.png"] = (960, 720)
    for t in frames:
        want[f"{DATETIME}_{t // frame_every:06d}.png"] = (960, 720)
    # the driver lists a snapshot's PNG; its `_3d.png` lies beside it
    files = dict(files)
    for t in snaps:
        base = files.get(f"{DATETIME}_{t:09d}.png")
        third = base and base.with_name(f"{DATETIME}_{t:09d}_3d.png")
        if third and third.exists():
            files[third.name] = third
    got = {name: png_size(files[name]) for name in want if name in files}
    timed = sorted(r["file"] for r in renders)
    paths = {r["path"] for r in renders}
    log(f"[{tag}] renders: " + ", ".join(
        f"{r['kind']} {r['file']} {r['seconds']:.3f} s ({r['path']})"
        for r in renders) + "; PNG sizes " + ", ".join(
        f"{k} {w}x{h}" for k, (w, h) in sorted(got.items())))
    if got != want:
        raise AssertionError(f"[{tag}] PNGs {got} != {want}")
    if timed != sorted(k for k in want if not k.endswith("_3d.png")) or \
            paths - {path}:
        raise AssertionError(f"[{tag}] renders {renders} (want {path} path)")


def run_example_deck(work: Path, tag: str, *, storage: str, steps: int,
                     vk: bool, walls=None, n_gpu=None, device=None,
                     keep=False, frames=0) -> dict:
    """The example deck at 1.5 m, angle 0, through run_deck on the card,
    with the launch counts zeroed just before and read just after; `walls`
    are deck settings of the wall models (`ground_z0`, `building_z0`);
    `n_gpu` a split [Dx, Dy, Dz] (Dx = 1: every shard then owns inlet
    sites), run on `device`; `keep` returns the final DDFs, u and rho on the
    host and the output files too; `frames` sets `frame_output`.  The
    snapshots at steps / 2 and steps (and the frames) are checked and each
    is timed (`timed_renders`)."""
    import latticeurbanwind_tpu_torch.run.modes as modes
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points

    device = device or DEVICE
    case = work / tag
    shutil.copytree(SOURCES["profile"], case)
    deck = load_deck(case / "conf.luwpf")
    if deck.get_raw("turb_inflow_enable") is not None:
        raise AssertionError("the example deck sets turb_inflow_enable")
    deck.set_float("cell_size", MAIN_CELL_M)
    deck.set_text("lbm_storage", storage)
    deck.set_list("angle", [0.0])
    if not vk:
        deck.set_text("turb_inflow_enable", "false")
    for key, value in (walls or {}).items():
        deck.set_float(key, value)
    if n_gpu:
        deck.set_raw("n_gpu", str(list(n_gpu)))
    purge = {400: 100, 200: 40, 100: 20}[steps]   # the deck: 400 and 100
    deck.set_int("run_nstep", steps)
    deck.set_int("unsteady_output", steps // 2)
    deck.set_int("purge_avg", purge)
    if frames:
        deck.set_int("frame_output", frames)
    deck.save()

    # record what the run builds for its inlet (configuration and runtime)
    # and the case it solves
    seen = {}
    real_cfg, real_rt = modes.vk_config_from_deck, modes.build_vk_runtime
    real_run = modes.run_case

    def cfg_spy(deck_, *, units, downstream_bc):
        seen.update(units=units, downstream=downstream_bc)
        return real_cfg(deck_, units=units, downstream_bc=downstream_bc)

    def rt_spy(cfg, flags, u):
        rt = real_rt(cfg, flags, u)
        seen.update(cfg=cfg, rt=rt, u0=np.array(u))
        return rt

    def run_spy(case_, **kw):
        seen["case"] = case_
        return real_run(case_, **kw)

    modes.vk_config_from_deck, modes.build_vk_runtime = cfg_spy, rt_spy
    modes.run_case = run_spy
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with timed_renders() as renders:
            results = modes.run_deck(case / "conf.luwpf", device=device,
                                     quiet=False)
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        modes.vk_config_from_deck, modes.build_vk_runtime = real_cfg, real_rt
        modes.run_case = real_run
    peak = torch.cuda.max_memory_allocated()

    (r,) = results
    shape = tuple(r.state.rho.shape)
    names = sorted(f.name for f in r.files)
    log(f"[{tag}] grid (Z, Y, X) = {shape}, {np.prod(shape) / 1e6:.2f}M cells, "
        f"storage {r.state.fi.dtype}; launches {launches}")
    log(f"[{tag}] solver {r.solver_seconds:.2f} s, {r.timing['mlups']:.0f} MLUPs "
        f"(RunInfo calibration), averaging phase "
        f"{r.timing.get('avg_steps_per_second', 0.0):.1f} steps/s, voxelizer "
        f"{r.timing['voxelize_seconds']:.2f} s, whole run_deck {wall:.1f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if shape != MAIN_SHAPE:
        raise AssertionError(f"deck grid {shape} != {MAIN_SHAPE}")

    half = steps // 2
    pre = DATETIME
    want = [f"{pre}_raw_u-{half:09d}.vtk", f"{pre}_raw_u-{steps:09d}.vtk",
            f"{pre}_raw_rho-{steps:09d}.vtk", f"{pre}_avg-{steps:09d}.vtk"]
    missing = [n for n in want if n not in names]
    if missing:
        raise AssertionError(f"[{tag}] missing outputs {missing}")
    n_avg = purge // 2                  # stride 2; the last step is no sample
    on_wall = bool(walls)
    shards = int(np.prod(n_gpu)) if n_gpu else 1
    if n_gpu and n_gpu[0] != 1:
        raise AssertionError("a split deck here keeps Dx = 1")
    launched = steps * shards           # one launch per shard and step
    fused = n_avg if shards == 1 else 0     # no K-AVG under a mesh
    expect = {"stream_collide": launched,
              "stream_collide_vk": launched if vk else 0,
              "stream_collide_wall": launched if on_wall else 0,
              "stream_collide_thermal": 0,
              "stream_collide_halo": launched if shards > 1 else 0,
              "avg_update": fused, "avg_update_wall": fused if on_wall else 0}
    cfg = seen["case"].config
    if (cfg.wall_model, cfg.wall_sides) != ("ground_z0" in (walls or {}),
                                            "building_z0" in (walls or {})):
        raise AssertionError(f"[{tag}] wall models of the run: {cfg}")
    if launches != expect:
        raise AssertionError(f"[{tag}] launch counts {launches} != {expect}")
    files = {f.name: f for f in r.files}
    _, fields = read_structured_points(files[want[-1]])
    fluid = fields["fluid"] > 0.5
    for key, arr in fields.items():
        if not np.isfinite(arr[..., fluid]).all():
            raise AssertionError(f"[{tag}] non-finite {key} at fluid cells")
    u_avg = fields["u_avg"]
    if u_avg.shape[1:] != fluid.shape or not u_avg[1][fluid].mean() < -0.5:
        raise AssertionError(f"[{tag}] u_avg is not the expected -y inflow")
    log(f"[{tag}] _avg VTK: fields {sorted(fields)}, shape {u_avg.shape}, "
        f"finite at fluid cells, mean v = {float(u_avg[1][fluid].mean()):.3f} m/s")

    frame_steps = range(frames, steps + 1, frames) if frames else ()
    check_renders(tag, files, renders, shape, seen["case"].nz_out,
                  snaps=(half, steps), frames=frame_steps, frame_every=frames,
                  path="host" if n_gpu else "device")
    render_s = sum(r.timing.get(f"{k}_seconds", 0.0) for k in ("snapshot", "frame"))
    log(f"[{tag}] solver {r.solver_seconds:.2f} s with its snapshots and frames "
        f"({r.timing.get('snapshot_seconds', 0.0):.2f} s snapshots, "
        f"{r.timing.get('frame_seconds', 0.0):.2f} s frames), "
        f"{r.solver_seconds - render_s:.2f} s without")
    out = {"launches": launches, "solver_seconds": r.solver_seconds,
           "solver_seconds_without_renders": r.solver_seconds - render_s,
           "snapshot_seconds": r.timing.get("snapshot_seconds", 0.0),
           "frame_seconds": r.timing.get("frame_seconds", 0.0),
           "renders": renders,
           "mlups": r.timing["mlups"], "wall": wall, "peak_gib": peak / 2**30,
           "raw_u": files[want[1]], "flags": r.state.flags.cpu()}
    if keep:
        out.update(fi=r.state.fi.cpu(), u=r.state.u.cpu(), rho=r.state.rho.cpu(),
                   files=files,
                   u_factor=seen["units"].si_u(1.0),
                   rho_factor=seen["units"].si_rho(1.0))
    if not vk:
        if seen.get("rt") is not None:
            raise AssertionError(f"[{tag}] the inlet is active with it off")
        return out
    rt = seen["rt"]
    faces = sorted(set(rt.face_of.tolist()))
    if faces != [0, 1, 2, 3]:
        raise AssertionError(f"[{tag}] inlet faces {faces} != [0, 1, 2, 3]")
    # the upstream face: opposite the downstream one ("-y" at angle 0)
    upstream = {"-x": 1, "+x": 0, "-y": 3, "+y": 2}[seen["downstream"]]
    u_si = seen["units"].si_u(1.0)
    sel = rt.face_of == upstream
    zi, yi, xi = (a[sel] for a in rt.idx)
    keep = zi < fields["u_avg"].shape[1]        # outputs crop the sponge rows
    zi, yi, xi = zi[keep], yi[keep], xi[keep]
    base = seen["u0"][:, zi, yi, xi] * u_si
    sigma = float(rt.sigma[sel][keep].mean()) * u_si
    ratios = {}
    for t in (half, steps):
        _, raw = read_structured_points(files[f"{pre}_raw_u-{t:09d}.vtk"])
        du = raw["data"][:, zi, yi, xi] - base
        ratios[t] = float(np.sqrt((du ** 2).sum(axis=0).mean())) / sigma
    log(f"[{tag}] inlet: {len(rt.sigma)} points on faces {faces}; upstream "
        f"face {upstream}: raw u RMS off the initial profile / sigma "
        f"(sigma = TI |u| = {sigma:.4f} m/s) = "
        + ", ".join(f"{v:.3f} at t={t}" for t, v in ratios.items()))
    if not all(0.3 < v < 3.0 for v in ratios.values()):
        raise AssertionError(f"[{tag}] upstream RMS/sigma {ratios} outside [0.3, 3]")
    stride = seen["cfg"].update_stride
    if n_gpu:
        out["sharded_loop"] = sharded_loop(seen["case"], r.state, n_gpu, device)
        loop = out["sharded_loop"]
        log(f"[{tag}] sharded step on {device}, ms/step by events on the "
            f"first card {loop['step_ms']:.4f}, by the host clock between "
            f"synchronisations of every card {loop['step_wall_ms']:.4f}"
            + ("" if "step_host_ms" not in loop else
               f"; host enqueue / device ms per step {loop['step_host_ms']:.4f}"
               f" / {loop['step_device_ms']:.4f}; device operations per step "
               f"{loop['step_device_ops']:.0f}"))
        return out
    loop = step_loop_breakdown(seen["case"], r.state)
    log(f"[{tag}] step loop ({len(rt.sigma)} inlet points, {seen['cfg'].nmodes} "
        f"modes, stride {stride}), ms/step by events: K-SC without sites "
        f"{loop['sc_novk_ms']:.4f}, with sites {loop['sc_vk_ms']:.4f}, the "
        f"site pass alone {loop['sites_ms']:.4f}, whole "
        f"step (refresh + K-SC) {loop['step_ms']:.4f}; host enqueue / device "
        f"ms per call: refresh {loop['refresh_host_ms']:.4f} / "
        f"{loop['refresh_device_ms']:.4f}, K-SC with sites "
        f"{loop['sc_vk_host_ms']:.4f} / {loop['sc_vk_device_ms']:.4f}, whole "
        f"step {loop['step_host_ms']:.4f} / {loop['step_device_ms']:.4f}"
        + ("" if "sc_vk_nowall_ms" not in loop else
           f"; K-SC with sites on this state without a wall model "
           f"{loop['sc_vk_nowall_ms']:.4f}, ground only "
           f"{loop['sc_vk_ground_ms']:.4f}, ground + side mirrors without the "
           f"side stress {loop['sc_vk_sides_cd0_ms']:.4f}"))
    out.update(faces=faces, rms_over_sigma=ratios, points=int(len(rt.sigma)),
               update_stride=stride, step_loop=loop)
    return out


def sharded_loop(case, final, n_gpu, device) -> dict:
    """The split deck's step on `device` (the device rule of
    `parallel/mesh.py`) with the run's own configuration, forcing and inlet
    hook, from its `final` (host) state: ms per step by CUDA events (on the
    first card's stream) and host enqueue / device ms per step."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.halo import make_sharded_runner

    mesh = domain_mesh(n_gpu, tuple(final.rho.shape), device)
    run, _ = make_sharded_runner(case.config, case.forcing, mesh,
                                 pre_step=case.pre_step, init_u=final.u,
                                 init_T=final.T)
    cell = {"s": shard_state(final, mesh), "t": 0}

    def step():
        cell["s"] = run(cell["s"], case.dyn, cell["t"], 1)
        cell["t"] += 1

    from latticeurbanwind_tpu_torch.parallel.mesh import sync

    out = {"step_ms": cuda_ms(step, reps=50, warmup=5)}
    sync(mesh.devices)
    t0 = time.perf_counter()
    for _ in range(50):
        step()
    sync(mesh.devices)
    out["step_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    if len(set(mesh.devices)) == 1:   # the device sleep holds one card only
        out["step_host_ms"], out["step_device_ms"] = run_ahead(step, n=8)
        out["step_device_ops"] = kernels_per_call(step)
    del cell
    torch.cuda.empty_cache()
    return out


def compare_split_deck(split: dict, main: dict, tag: str) -> dict:
    """The split deck against the unsplit one: final DDFs and raw VTKs
    EQUAL (each shard's cell runs the same arithmetic on the same inputs);
    the averages within the fused averaging pass's tolerance at cells that
    are not solid (the unsplit run samples through K-AVG, the split one
    through update_fields + welford_update, as the JAX package's `run_case`
    does)."""
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points

    fi_same = torch.equal(split["fi"].view(torch.int16),
                          main["fi"].view(torch.int16))
    a, b = ({k: v for k, v in d["files"].items() if k.endswith(".vtk")}
            for d in (split, main))             # name -> path
    if sorted(a) != sorted(b):
        raise AssertionError(f"[{tag}] outputs {sorted(a)} != {sorted(b)}")
    # the averages back in lattice units, where the tolerance is stated
    uf, rf = main["u_factor"], main["rho_factor"]
    unit = {"u_avg": uf, "rho_avg": rf, "tke": uf * uf}
    raw_same, avg_err = {}, {}
    for name in sorted(b):
        _, fa = read_structured_points(a[name])
        _, fb = read_structured_points(b[name])
        if "_avg-" in name:
            fluid = fb["fluid"] > 0.5
            for key, f in unit.items():
                d = np.abs(fa[key][..., fluid] - fb[key][..., fluid]) / f
                avg_err[key] = float(d.max())
        else:
            raw_same[name] = bool(np.array_equal(fa["data"], fb["data"]))
    ok = (fi_same and all(raw_same.values())
          and all(v <= AVG_TOL for v in avg_err.values()))
    log(f"[{tag}] against vk-bf16-400: final DDFs {'equal' if fi_same else 'DIFFER'}"
        f", raw VTKs " + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                                   for k, v in raw_same.items())
        + "; averaged VTK at cells that are not solid, max |split - unsplit| "
        "in lattice units: " + ", ".join(f"{k} {v:.3e}" for k, v in avg_err.items())
        + f" (tol {AVG_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the split deck differs from the unsplit one")
    return {"fi_equal": fi_same, "raw_equal": raw_same, "avg_max_abs": avg_err}


def run_resume_phase(work: Path, ref: dict, tag: str = "resume-dg-bf16-300") -> dict:
    """The example `.luwdg` deck at 2 m in bf16, its case (inflow 4, angle
    45) run serially in two legs through `run_deck` (`checkpoint_interval`
    is a `RunSettings` field, not a deck key: set on the case the port
    builds, as the JAX package's tests set it).  Leg 1: split n_gpu =
    SHARD_SPLIT on SHARD_DEVICE, 200 steps, no averaging, a checkpoint
    every 200 steps; its checkpoint holds one block per shard.  Leg 2:
    unsplit on DEVICE, resumed to 300 with the deck's own averaging and the
    interval past its end.  Its final DDF codes, u and rho and its VTKs
    equal those of dg-bf16-300's serial run of the same case (`ref`; the
    deck keeps both inflows, so the case's units are that run's)."""
    import latticeurbanwind_tpu_torch.run.modes as modes
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.run.checkpoint import checkpoint_path

    case = work / tag
    shutil.copytree(SOURCES["datagen"], case)
    deck_path = case / "conf.luwdg"
    inflow, angle = ref["case"]
    ckpt = checkpoint_path(case, DATETIME, f"DG_{modes._format_tag(inflow)}_"
                                           f"{modes._format_tag(angle)}_")
    purge_avg = load_deck(deck_path).get_int("purge_avg", 0)
    real_run = modes.run_case
    seen = {}

    def run_spy(case_, **kw):
        case_.settings.checkpoint_interval = seen["every"]
        return real_run(case_, **kw)

    legs = {}
    modes.run_case = run_spy
    try:
        for leg, n_gpu, steps, purge, device, every in (
                ("leg 1", SHARD_SPLIT, 200, 0, SHARD_DEVICE, 200),
                ("leg 2", (1, 1, 1), 300, purge_avg, DEVICE, 1000)):
            seen["every"] = every
            deck = load_deck(deck_path)
            if inflow not in deck.get_float_list("inflow"):
                raise AssertionError(f"[{tag}] inflow {inflow} not in the deck")
            deck.set_float("cell_size", DG_CELL_M)
            deck.set_text("lbm_storage", "bf16")
            deck.set_bool("case_parallel", False)
            deck.set_list("angle", [angle])
            deck.set_raw("n_gpu", str(list(n_gpu)))
            deck.set_int("run_nstep", steps)
            deck.set_int("purge_avg", purge)
            deck.save()
            zero_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                (r,) = modes.run_deck(deck_path, device=device, quiet=False,
                                      max_cases=1)
            wall = time.perf_counter() - t0
            legs[leg] = {"r": r, "launches": read_launches(), "wall": wall,
                         "printed": buf.getvalue()}
            if leg == "leg 1":
                with np.load(ckpt) as z:
                    keys = list(z.files)
                legs[leg]["ckpt_bytes"] = ckpt.stat().st_size
                legs[leg]["fi_blocks"] = sum(k.startswith("fi@") for k in keys)
                legs[leg]["fi_plain"] = "fi" in keys
    finally:
        modes.run_case = real_run

    one, two = legs["leg 1"], legs["leg 2"]
    r = two["r"]
    log(one["printed"].rstrip())
    log(two["printed"].rstrip())
    shards = int(np.prod(SHARD_SPLIT))
    expect = {
        "leg 1": {"stream_collide": 200 * shards, "stream_collide_vk": 0,
                  "stream_collide_wall": 0, "stream_collide_thermal": 0,
                  "stream_collide_halo": 200 * shards, "avg_update": 0,
                  "avg_update_wall": 0},
        "leg 2": {"stream_collide": 100, "stream_collide_vk": 0,
                  "stream_collide_wall": 0, "stream_collide_thermal": 0,
                  "stream_collide_halo": 0, "avg_update": ref["n_avg"],
                  "avg_update_wall": 0}}
    for leg in legs:
        if legs[leg]["launches"] != expect[leg]:
            raise AssertionError(f"[{tag}] {leg} launches "
                                 f"{legs[leg]['launches']} != {expect[leg]}")
    if (one["fi_blocks"], one["fi_plain"]) != (shards, False):
        raise AssertionError(f"[{tag}] leg 1's checkpoint: {one['fi_blocks']} fi "
                             f"blocks, plain fi {one['fi_plain']}")
    if "| Checkpoint      | resumed from step 200" not in two["printed"] or \
            r.total_steps != 300:
        raise AssertionError(f"[{tag}] leg 2 did not resume from step 200")
    files = {f.name: f for f in r.files if f.suffix == ".vtk"}
    if not files or sorted(files) != sorted(ref["files"]):
        raise AssertionError(f"[{tag}] leg 2 wrote {sorted(files)}, the "
                             f"uninterrupted run {sorted(ref['files'])}")
    differing = int((r.state.fi.cpu().view(torch.int16)
                     != ref["fi"].view(torch.int16)).sum())
    same = {"u": torch.equal(r.state.u.cpu(), ref["u"]),
            "rho": torch.equal(r.state.rho.cpu(), ref["rho"])}
    same.update({k: files[k].read_bytes() == ref["files"][k].read_bytes()
                 for k in sorted(files)})
    t1, t2 = one["r"].timing, r.timing
    log(f"[{tag}] leg 1 ({list(SHARD_SPLIT)} on {SHARD_DEVICE}, 200 steps): "
        f"checkpoint {one['ckpt_bytes'] / 2**20:.1f} MiB ({one['fi_blocks']} fi "
        f"blocks), saved in {t1['checkpoint_save_seconds']:.2f} s; solver "
        f"{one['r'].solver_seconds:.2f} s, whole run_deck {one['wall']:.1f} s. "
        f"Leg 2 (unsplit, 200 -> 300): loaded in "
        f"{t2['checkpoint_load_seconds']:.2f} s; solver {r.solver_seconds:.2f} s, "
        f"whole run_deck {two['wall']:.1f} s. Against dg-bf16-300's serial run "
        f"of the case: {differing} differing DDF codes; " + ", ".join(
            f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()))
    if differing or not all(same.values()):
        raise AssertionError(f"[{tag}] the resumed run differs from dg-bf16-300's")
    return {"launches": {leg: legs[leg]["launches"] for leg in legs},
            "checkpoint_bytes": one["ckpt_bytes"],
            "save_seconds": t1["checkpoint_save_seconds"],
            "load_seconds": t2["checkpoint_load_seconds"],
            "solver_seconds": [one["r"].solver_seconds, r.solver_seconds],
            "wall": [one["wall"], two["wall"]],
            "differing_codes": differing, "equal": same}


def first_layer_du(a: Path, b: Path, flags: torch.Tensor) -> float:
    """Mean |u_a - u_b| (m/s) of two raw u VTKs over the first fluid layer
    above open ground: the lowest fluid cell of every interior column whose
    only solid cells are the ground's (no building), the TYPE_E faces
    left out."""
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S

    solid = ((flags & TYPE_S) != 0).numpy()
    height = solid.sum(axis=0)                     # solid cells per column
    ground = height.min()
    first = np.argmin(solid, axis=0)               # lowest fluid cell
    open_ = (height == ground) & (first == ground)
    open_[0, :] = open_[-1, :] = open_[:, 0] = open_[:, -1] = False
    ys, xs = np.nonzero(open_)
    _, ua = read_structured_points(a)
    _, ub = read_structured_points(b)
    du = ua["data"][:, ground, ys, xs] - ub["data"][:, ground, ys, xs]
    return float(np.sqrt((du ** 2).sum(axis=0)).mean())


def run_datagen_deck(work: Path, tag: str, *, storage: str, steps: int,
                     cases: int, device=None, angles=None) -> dict:
    """The example `.luwdg` deck as it ships (`case_parallel = true`) at
    2 m cells with its first `cases` cases, through run_deck on the card:
    the case-parallel batch runner, one case per card (`device` "cuda": every
    visible card), with the launch counts zeroed just before and read just
    after; then the same cases with `case_parallel = false` through the
    serial driver on card 0, whose files the batch's equal byte for byte.
    `angles` replaces the deck's angles and keeps its first inflow."""
    import latticeurbanwind_tpu_torch.run.modes as modes
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points
    from latticeurbanwind_tpu_torch.run.batch import case_devices

    device = device or DEVICE
    out = {}
    for kind in ("case-parallel", "serial"):
        case = work / f"{tag}-{kind}"
        shutil.copytree(SOURCES["datagen"], case)
        deck = load_deck(case / "conf.luwdg")
        if not deck.get_bool("case_parallel", False):
            raise AssertionError("the example .luwdg deck does not set case_parallel")
        deck.set_float("cell_size", DG_CELL_M)
        deck.set_text("lbm_storage", storage)
        deck.set_int("run_nstep", steps)
        if angles is not None:
            deck.set_list("angle", list(angles))
            deck.set_list("inflow", deck.get_float_list("inflow")[:1])
        if kind == "serial":
            deck.set_bool("case_parallel", False)
        deck.save()
        zero_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results = modes.run_deck(
                case / "conf.luwdg", quiet=False, max_cases=cases,
                device=device if kind == "case-parallel"
                else case_devices(device)[0])
        out[kind] = {"results": results, "wall": time.perf_counter() - t0,
                     "launches": read_launches(), "printed": buf.getvalue()}
    par, serial = out["case-parallel"], out["serial"]
    results, launches, printed = par["results"], par["launches"], par["printed"]
    purge = deck.get_int("purge_avg", 0)
    log(printed.rstrip())
    shape = tuple(results[-1].state.rho.shape)
    log(f"[{tag}] {len(results)} cases, grid (Z, Y, X) = {shape}, "
        f"{np.prod(shape) / 1e6:.2f}M cells; launches {launches}; solver "
        + ", ".join(f"{r.solver_seconds:.2f} s ({r.timing['mlups']:.0f} MLUPs)"
                    for r in results) + f"; whole run_deck {par['wall']:.1f} s "
        f"(serial on {case_devices(device)[0]}: {serial['wall']:.1f} s)")
    D = min(len(case_devices(device)), cases)
    tier = "cuda" if torch.device(device).type == "cuda" else "plain"
    line = (f"| Case-parallel   | {cases} cases over {D} device(s), tier={tier}, "
            f"{steps} steps (avg window {purge} @ stride 2)")
    if line not in printed or printed.count("| Case-parallel   | batch of ") \
            != -(-cases // D):
        raise AssertionError(f"[{tag}] no batch-runner lines ({line!r})")
    n_avg = purge // 2
    expect = {"stream_collide": cases * steps, "stream_collide_vk": 0,
              "stream_collide_wall": 0, "stream_collide_thermal": 0,
              "stream_collide_halo": 0,
              "avg_update": cases * n_avg, "avg_update_wall": 0}
    if D == 1 and launches != expect:     # threads on several cards may
        raise AssertionError(                # lose counts to one another
            f"[{tag}] launch counts {launches} != {expect}")
    if serial["launches"] != expect:
        raise AssertionError(f"[{tag}] serial launch counts "
                             f"{serial['launches']} != {expect}")
    inflows = deck.get_float_list("inflow")
    angles = deck.get_float_list("angle")
    prefixes = [f"DG_{modes._format_tag(u)}_{modes._format_tag(a)}_"
                for u in inflows for a in angles][:cases]
    same = {}
    for r, rs, prefix in zip(results, serial["results"], prefixes):
        names = sorted(f.name for f in r.files)
        want = [f"{prefix}{DATETIME}_{k}-{steps:09d}.vtk"
                for k in ("avg", "raw_rho", "raw_u")]
        if names != want or sorted(f.name for f in rs.files) != want:
            raise AssertionError(f"[{tag}] outputs {names} != {want}")
        _, fields = read_structured_points(r.files[-1])
        fluid = fields["fluid"] > 0.5
        if not all(np.isfinite(v[..., fluid]).all() for v in fields.values()):
            raise AssertionError(f"[{tag}] non-finite {prefix} averages")
        theirs = {f.name: f for f in rs.files}
        same.update({f.name: f.read_bytes() == theirs[f.name].read_bytes()
                     for f in r.files})
    log(f"[{tag}] outputs of {prefixes}: raw u, raw rho and _avg each, "
        "finite at fluid cells; against the serial run: " + ", ".join(
            f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()))
    if not all(same.values()):
        raise AssertionError(f"[{tag}] the case-parallel outputs differ from "
                             "the serial run's")
    last = serial["results"][-1]     # the one case whose state is kept
    return {"launches": launches, "wall": par["wall"],
            "serial_wall": serial["wall"], "devices": D,
            "solver_seconds": [r.solver_seconds for r in results],
            "mlups": [r.timing["mlups"] for r in results],
            "equal_to_serial": same,
            "last": {"case": [(u, a) for u in inflows for a in angles][cases - 1],
                     "n_avg": n_avg, "fi": last.state.fi.cpu(),
                     "u": last.state.u.cpu(), "rho": last.state.rho.cpu(),
                     "files": {f.name: f for f in last.files
                               if f.suffix == ".vtk"}}}


def run_nwp_deck(work: Path, tag: str, *, steps: int, thermal: bool,
                 source: Path) -> dict:
    """The prepared NWP-coupled standard deck (`.luw`, the case in `source`:
    the pipeline phase's own makeluw output) at 3 m cells in bf16,
    otherwise as it ships (patch-2d boundary samples with a T column, VK
    inlet, Coriolis, nudging, top sponge, one probe column), through
    run_deck on the card with the launch counts zeroed just before and read
    just after.  `thermal=False` sets `buoyancy = false` and takes the
    probes out: with a probe each averaging sample needs the fields, and no
    sample would reach the fused averaging pass."""
    import latticeurbanwind_tpu_torch.run.modes as modes
    import latticeurbanwind_tpu_torch.run.standard as standard
    from latticeurbanwind_tpu_torch.bc.samples import read_surfdata_csv
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points
    from latticeurbanwind_tpu_torch.run.sizing import bytes_per_cell

    case = work / tag
    shutil.copytree(source, case)
    deck = load_deck(case / "conf.luw")
    if deck.get_int("run_nstep") != steps or deck.get_raw("probes") != "[center]":
        raise AssertionError("the prepared deck is not the one this phase expects")
    deck.set_float("cell_size", NWP_CELL_M)
    deck.set_text("lbm_storage", "bf16")
    if not thermal:
        deck.set_bool("buoyancy", False)
        deck.set_raw("probes", "[]")
    deck.save()
    purge, stride = deck.get_int("purge_avg"), deck.get_int("purge_avg_stride")

    seen = {}
    real_run = standard.run_case

    def run_spy(case_, **kw):
        seen["case"] = case_
        return real_run(case_, **kw)

    standard.run_case = run_spy
    buf = io.StringIO()
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            (r,) = modes.run_deck(case / "conf.luw", device=DEVICE)
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        standard.run_case = real_run
        log(buf.getvalue().rstrip())
    printed = buf.getvalue()
    peak = torch.cuda.max_memory_allocated()

    grid = tuple(r.state.rho.shape)
    cells = int(np.prod(grid))
    model_gib = cells * bytes_per_cell("bf16", thermal) / 2**30
    setup = {k: v for k, v in r.timing.items()
             if k.startswith("setup_") or k == "voxelize_seconds"}
    log(f"[{tag}] grid (Z, Y, X) = {grid}, {cells / 1e6:.2f}M cells, storage "
        f"{r.state.fi.dtype}, sizing model {model_gib:.2f} GiB; launches {launches}")
    log(f"[{tag}] solver {r.solver_seconds:.2f} s, {r.timing['mlups']:.0f} MLUPs "
        f"(RunInfo calibration), averaging phase "
        f"{r.timing.get('avg_steps_per_second', 0.0):.1f} steps/s, set-up by "
        f"stage {({k: round(v, 2) for k, v in setup.items()})}, whole run "
        f"{wall:.1f} s, peak device memory {peak / 2**30:.2f} GiB")
    if grid != NWP_SHAPE:
        raise AssertionError(f"[{tag}] deck grid {grid} != {NWP_SHAPE}")
    if model_gib < NWP_MIN_GIB:
        raise AssertionError(f"[{tag}] a {model_gib:.2f} GiB state is no real size")
    for want in ("bc=patch-2d", f"T={'on' if thermal else 'off'}",
                 "| VK inlet        | active:"):
        if want not in printed:
            raise AssertionError(f"[{tag}] the run did not print {want!r}")
    cfg = seen["case"].config
    if cfg.thermal != thermal or (r.state.gi is not None) != thermal:
        raise AssertionError(f"[{tag}] thermal state of the run: {cfg}")
    n_avg = len(range(steps - purge + 1, steps, stride))   # the last step is no sample
    expect = {"stream_collide": steps, "stream_collide_vk": steps,
              "stream_collide_wall": 0,
              "stream_collide_thermal": steps if thermal else 0,
              "stream_collide_halo": 0,
              "avg_update": 0 if thermal else n_avg, "avg_update_wall": 0}
    if launches != expect:
        raise AssertionError(f"[{tag}] launch counts {launches} != {expect}")
    if r.avg.count != n_avg or (r.avg.mean_T is not None) != thermal:
        raise AssertionError(f"[{tag}] averaging: {r.avg.count} samples")

    names = sorted(f.name for f in r.files)
    want = [f"{DATETIME}_{k}-{steps:09d}.vtk"
            for k in ("avg", "raw_rho", "raw_u") + (("raw_T",) if thermal else ())]
    if thermal:
        want.append("121.324_31.12.csv")
    if names != sorted(want):
        raise AssertionError(f"[{tag}] outputs {names} != {sorted(want)}")
    files = {f.name: f for f in r.files}
    _, fields = read_structured_points(files[want[0]])
    fluid = fields["fluid"] > 0.5
    for key, arr in fields.items():
        if not np.isfinite(arr[..., fluid]).all():
            raise AssertionError(f"[{tag}] non-finite {key} at fluid cells")
    if ("T_avg" in fields) != thermal:
        raise AssertionError(f"[{tag}] fields {sorted(fields)}")
    mean_u = float(fields["u_avg"][0][fluid].mean())
    # the interior starts at rest and 300 steps of 3 m cells are 15 s of flow:
    # the mean is far below the deck's um_vol of (5.4, 1.3) m/s, but along +x
    if not mean_u > 0.3:
        raise AssertionError(f"[{tag}] u_avg is not the +x flow: {mean_u}")
    log(f"[{tag}] _avg VTK: fields {sorted(fields)}, shape "
        f"{fields['u_avg'].shape}, finite at fluid cells, mean u = {mean_u:.3f} m/s")
    out = {"launches": launches, "solver_seconds": r.solver_seconds,
           "mlups": r.timing["mlups"], "wall": wall, "setup": setup,
           "avg_steps_per_second": r.timing.get("avg_steps_per_second", 0.0),
           "peak_gib": peak / 2**30, "cells": cells}
    if thermal:
        # the CSV's temperature is one value (a uniform 288.15 K), so its
        # range is a point: the lattice T leaves it by the divergence of the
        # advecting velocity; held to a band of +-5 K around the CSV's range,
        # with the fluid mean within 0.5 K of it
        tmin, tmax = read_surfdata_csv(
            case / "proj_temp" / f"SurfData_{DATETIME}.csv").temperature_range()
        _, raw_t = read_structured_points(files[f"{DATETIME}_raw_T-{steps:09d}.vtk"])
        for name, arr in (("raw T", raw_t["data"]), ("T_avg", fields["T_avg"])):
            lo, hi = float(arr[fluid].min()), float(arr[fluid].max())
            mean = float(arr[fluid].mean())
            log(f"[{tag}] {name} at fluid cells: [{lo:.3f}, {hi:.3f}] K, mean "
                f"{mean:.4f} K; the CSV's range [{tmin:.2f}, {tmax:.2f}] K")
            if not (np.isfinite(arr).all() and tmin - 5.0 <= lo and hi <= tmax + 5.0
                    and tmin - 0.5 <= mean <= tmax + 0.5):
                raise AssertionError(f"[{tag}] {name} outside the CSV's range band")
            out[name.replace(" ", "_") + "_range_K"] = [lo, hi, mean]
        rows = files["121.324_31.12.csv"].read_text().splitlines()
        cells0 = rows[1].split(",")
        if len(cells0) != 1 + n_avg or len(rows) < 4:
            raise AssertionError(f"[{tag}] probe CSV: {len(rows)} rows, "
                                 f"{len(cells0)} columns")
        log(f"[{tag}] probe CSV: {len(rows) - 1} heights x {n_avg} samples")
    loop = step_loop_breakdown(seen["case"], r.state)
    log(f"[{tag}] step loop, ms/step by events: K-SC without sites "
        f"{loop['sc_novk_ms']:.4f}, with sites {loop['sc_vk_ms']:.4f}, the "
        f"site pass alone {loop['sites_ms']:.4f}, whole "
        f"step (refresh + K-SC) {loop['step_ms']:.4f}; host enqueue / device "
        f"ms per call: refresh {loop['refresh_host_ms']:.4f} / "
        f"{loop['refresh_device_ms']:.4f}, whole step "
        f"{loop['step_host_ms']:.4f} / {loop['step_device_ms']:.4f}"
        + (f"; update_fields per sample {loop['update_fields_ms']:.2f} ms"
           if thermal else ""))
    out["step_loop"] = loop
    shutil.rmtree(case, ignore_errors=True)     # ~3 GB of VTKs per run
    return out


def run_dispatch(args) -> tuple:
    """(exit code, printed text, wall seconds) of one command of the port's
    dispatcher, run in this process with its output captured."""
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dispatch(list(args))
    return rc, buf.getvalue(), time.perf_counter() - t0


def stage_seconds(printed: str) -> dict:
    return {k: float(v) for k, v in
            re.findall(r"\[(\w+)\] stage seconds: ([\d.]+)", printed)}


def hold_made_files(made: Path) -> dict:
    """The made deck's values equal the prepared example's; its SurfData
    CSV's columns within MADE_CSV_RTOL of each column's largest magnitude;
    its STL's vertices within MADE_STL_TOL_M.  Whether the bytes are equal
    too is recorded (this machine's numpy and scipy may print a last digit
    apart)."""
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.geometry import read_stl

    same_bytes = {name: (made / name).read_bytes()
                  == (EXAMPLE_NWP / name).read_bytes()
                  for name in NWP_PREPARED_FILES}
    got, want = load_deck(made / "conf.luw").to_dict(), \
        load_deck(EXAMPLE_NWP / "conf.luw").to_dict()
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        raise AssertionError(f"the made deck's values differ: {diff}")
    csv = NWP_PREPARED_FILES[1]
    heads = [(d / csv).read_text().split("\n", 1)[0] for d in (made, EXAMPLE_NWP)]
    a = np.loadtxt(made / csv, delimiter=",", skiprows=1)
    b = np.loadtxt(EXAMPLE_NWP / csv, delimiter=",", skiprows=1)
    if heads[0] != heads[1] or a.shape != b.shape:
        raise AssertionError(f"made CSV {heads[0]!r} {a.shape} against "
                             f"{heads[1]!r} {b.shape}")
    csv_rel = float((np.abs(a - b) / np.maximum(np.abs(b).max(axis=0), 1e-30)).max())
    ta = read_stl(made / NWP_PREPARED_FILES[2]).tris.astype(np.float64)
    tb = read_stl(EXAMPLE_NWP / NWP_PREPARED_FILES[2]).tris.astype(np.float64)
    if ta.shape != tb.shape:
        raise AssertionError(f"made STL {ta.shape} against {tb.shape}")
    stl_m = float(np.abs(ta - tb).max())
    log(f"[makeluw] made against examples/example_NWP-LBM_prepared: deck values "
        f"equal; CSV {a.shape}, largest difference {csv_rel:.3g} of its "
        f"column's scale (limit {MADE_CSV_RTOL}); STL {ta.shape[0]} triangles, "
        f"vertices within {stl_m:.3g} m (limit {MADE_STL_TOL_M}); bytes equal: "
        f"{same_bytes}")
    if not (csv_rel <= MADE_CSV_RTOL and stl_m <= MADE_STL_TOL_M):
        raise AssertionError("the made CSV or STL is off the prepared example")
    return {"csv_rel_err": csv_rel, "stl_max_m": stl_m, "bytes_equal": same_bytes}


def make_example(work: Path) -> tuple:
    """(a) `dispatch makeluw` on a copy of examples/example_NWP-LBM, each
    stage timed, the made files held to the prepared example."""
    made = work / "nwp-made"
    shutil.copytree(EXAMPLE_NWP_RAW, made)
    rc, printed, wall = run_dispatch(["makeluw", str(made / "conf.luw"),
                                      "--device", DEVICE])
    log(printed.rstrip())
    stages = stage_seconds(printed)
    log(f"[makeluw] exit {rc}, {wall:.2f} s; seconds by stage {stages}")
    if rc != 0 or len(stages) != 6:
        raise AssertionError(f"makeluw failed: exit {rc}, stages {stages}")
    return made, {"seconds": wall, "stage_seconds": stages,
                  **hold_made_files(made)}


def read_nc(path: Path) -> dict:
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "r", mmap=False) as nc:
        return {k: np.array(v[:]) for k, v in nc.variables.items()}


def run_made_route(work: Path, made: Path) -> dict:
    """(b) the made deck as it ships (16 m cells, 300 steps, T on, VK inlet,
    one probe) through `dispatch runluw` on the card, the launch counts
    zeroed just before and read just after, then `dispatch vtk2nc`: every
    NetCDF parses back finite with its lon/lat inside the deck's cut box."""
    from latticeurbanwind_tpu_torch.deck import load_deck

    tag = "nwp-made-16m"
    case = work / tag
    shutil.copytree(made, case)
    deck = load_deck(case / "conf.luw")
    steps = deck.get_int("run_nstep")
    zero_launches()
    rc, printed, wall = run_dispatch(["runluw", str(case / "conf.luw"),
                                      "--device", DEVICE])
    launches = read_launches()
    log(printed.rstrip())
    expect = {"stream_collide": steps, "stream_collide_vk": steps,
              "stream_collide_wall": 0, "stream_collide_thermal": steps,
              "stream_collide_halo": 0, "avg_update": 0, "avg_update_wall": 0}
    log(f"[{tag}] runluw exit {rc}, {wall:.2f} s, launches {launches}")
    if rc != 0 or launches != expect:
        raise AssertionError(f"[{tag}] runluw exit {rc}, launches {launches} "
                             f"!= {expect}")
    rc, printed, nc_wall = run_dispatch(["vtk2nc", str(case / "conf.luw")])
    log(printed.rstrip())
    ncs = sorted((case / "RESULTS").glob("*.nc"))
    vtks = sorted((case / "RESULTS" / "vtk").glob("*.vtk"))
    if rc != 0 or len(ncs) != len(vtks) or not ncs:
        raise AssertionError(f"[{tag}] vtk2nc exit {rc}: {len(ncs)} NetCDF "
                             f"for {len(vtks)} VTK")
    lon_box, lat_box = deck.get_pair("cut_lon_manual"), deck.get_pair("cut_lat_manual")
    shapes = {}
    for path in ncs:
        nc = read_nc(path)
        for name, arr in nc.items():
            if not np.isfinite(arr).all():
                raise AssertionError(f"[{tag}] {path.name}: non-finite {name}")
        if not (lon_box[0] <= nc["lon"].min() and nc["lon"].max() <= lon_box[1]
                and lat_box[0] <= nc["lat"].min() and nc["lat"].max() <= lat_box[1]):
            raise AssertionError(f"[{tag}] {path.name}: lon/lat outside the cut box")
        shapes[path.name] = {k: list(v.shape) for k, v in nc.items()
                             if k not in ("lon", "lat", "z")}
    log(f"[{tag}] vtk2nc {nc_wall:.2f} s: {len(ncs)} NetCDF files, finite, "
        f"lon/lat inside the cut box; variables {shapes}")
    return {"launches": launches, "runluw_seconds": wall,
            "vtk2nc_seconds": nc_wall, "netcdf": shapes}


def district_rings(n: int, lon_box, lat_box, seed: int = 0):
    """n seeded footprints (star-shaped rings of 4-8 vertices, ~6-12 m
    across) inside the cut box; every third overlaps the one before it.
    Returns (rings, heights)."""
    rng = np.random.default_rng(seed)
    size = 6e-5
    rings, heights = [], []
    for i in range(n):
        if i % 3 == 2:
            cx, cy = rings[-1].mean(axis=0) + rng.uniform(-0.8, 0.8, 2) * size
        else:
            cx = rng.uniform(lon_box[0] + 3 * size, lon_box[1] - 3 * size)
            cy = rng.uniform(lat_box[0] + 3 * size, lat_box[1] - 3 * size)
        k = int(rng.integers(4, 9))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = size * rng.uniform(0.5, 1.0, k)
        rings.append(np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1))
        heights.append(float(rng.uniform(8.0, 80.0)))
    return rings, heights


def hill(xy: np.ndarray, rng) -> np.ndarray:
    """A 100 m Gaussian hill over the NWP example's box with 1 m of noise."""
    return (100.0 * np.exp(-(((xy[:, 0] - 1500.0) / 700.0) ** 2
                             + ((xy[:, 1] - 1300.0) / 600.0) ** 2))
            + rng.normal(0.0, 1.0, len(xy)))


def run_district(work: Path, made: Path) -> dict:
    """(c) on another copy of the made case: DISTRICT_FOOTPRINTS seeded
    footprints through luwcut and luwvox, each timed; a seeded DEM of
    DEM_POINTS lon/lat points through luwdem and luwvox with `kriging_gpu`,
    its card solve held to the CPU solve within KRIGING_TOL_M; and
    kriging_interpolate alone at KRIGING_SIDE^2 targets from DEM_POINTS
    points, the KNN and the solve timed apart."""
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.pre import terrain
    from latticeurbanwind_tpu_torch.pre.shp_reader import write_polygon_shp

    case = work / "district"
    shutil.copytree(made, case)
    deck_path = case / "conf.luw"
    deck = load_deck(deck_path)
    lon_box, lat_box = deck.get_pair("cut_lon_manual"), deck.get_pair("cut_lat_manual")
    shutil.rmtree(case / "building_db")
    for old in (case / "proj_temp").glob("*buildings*"):
        old.unlink()                       # luwcut keeps a buildings.csv it finds
    rings, heights = district_rings(DISTRICT_FOOTPRINTS, lon_box, lat_box)
    (case / "building_db").mkdir()
    write_polygon_shp(case / "building_db" / "district.shp", rings, heights=heights)
    out, printed = {}, {}
    for cmd, extra in (("luwcut", []), ("luwvox", ["--device", DEVICE])):
        rc, printed[cmd], secs = run_dispatch([cmd, str(deck_path), *extra])
        log(printed[cmd].rstrip())
        log(f"[district] {cmd}: exit {rc}, {secs:.3f} s")
        if rc != 0:
            raise AssertionError(f"[district] {cmd} failed")
        out[f"{cmd}_seconds"] = secs
    cut = re.search(r"buildings\.csv: (\d+) footprints, (\d+) merged",
                    printed["luwcut"])
    if not cut or int(cut[1]) != DISTRICT_FOOTPRINTS or int(cut[2]) == 0:
        raise AssertionError(f"[district] luwcut kept or merged too few: {cut}")
    out["merged_into_clusters"] = int(cut[2])

    rng = np.random.default_rng(7)
    lon = rng.uniform(lon_box[0] - 0.002, lon_box[1] + 0.002, DEM_POINTS)
    lat = rng.uniform(lat_box[0] - 0.002, lat_box[1] + 0.002, DEM_POINTS)
    span = np.stack([(lon - lon.min()) / (lon.max() - lon.min()) * 3052.0,
                     (lat - lat.min()) / (lat.max() - lat.min()) * 2660.0], 1)
    (case / "database").mkdir()
    np.savetxt(case / "database" / "hill_dem.csv",
               np.column_stack([lon, lat, hill(span, rng)]), delimiter=",",
               header="lon,lat,elev", comments="", fmt="%.8f")
    deck.set_text("terr_voxel_approach", "kriging_gpu", quoted=True)
    deck.save()
    rc, text, secs = run_dispatch(["luwdem", str(deck_path)])
    log(text.rstrip())
    if rc != 0:
        raise AssertionError("[district] luwdem failed")
    out["luwdem_seconds"] = secs
    dem = {}
    for dev in (DEVICE, "cpu"):
        rc, text, secs = run_dispatch(["luwvox", str(deck_path), "--device", dev])
        log(text.rstrip())
        if rc != 0 or "terrain: kriging_gpu" not in text:
            raise AssertionError(f"[district] luwvox kriging_gpu on {dev} failed")
        dem[dev] = np.loadtxt(case / "proj_temp" / "interpolated_dem.csv",
                              delimiter=",", skiprows=1)
        out[f"luwvox_kriging_gpu_{dev}_seconds"] = secs
    dem_err = float(np.abs(dem[DEVICE] - dem["cpu"]).max())
    log(f"[district] luwvox kriging_gpu: {len(dem['cpu'])} grid points, the "
        f"{DEVICE} solve against the cpu solve within {dem_err:.3g} m (limit "
        f"{KRIGING_TOL_M}); seconds {out}")
    if not dem_err <= KRIGING_TOL_M:
        raise AssertionError("[district] the card's kriging is off the CPU's")
    out["dem_max_err_m"] = dem_err

    # kriging_interpolate alone: the host KNN and the device solve apart
    pts = np.random.default_rng(3).uniform(0, [3052.0, 2660.0], (DEM_POINTS, 2))
    z = hill(pts, np.random.default_rng(4))
    gx, gy = np.meshgrid(np.linspace(0, 3052.0, KRIGING_SIDE),
                         np.linspace(0, 2660.0, KRIGING_SIDE))
    targets = np.stack([gx.ravel(), gy.ravel()], axis=1)
    spent, kept = {}, {}
    real_knn, real_solve = terrain._knn, terrain.solve_systems

    def knn_spy(*a, **kw):
        t0 = time.perf_counter()
        kept["knn"] = real_knn(*a, **kw)
        spent["knn_s"] = time.perf_counter() - t0
        return kept["knn"]

    def solve_spy(A, b, device):
        t0 = time.perf_counter()
        sol = real_solve(A, b, device)      # returns on the host: synchronised
        kind = torch.device(device).type
        spent[f"solve_{kind}_s"] = time.perf_counter() - t0
        kept["Ab"], kept[f"sol_{kind}"] = (A, b), sol
        return sol

    terrain._knn, terrain.solve_systems = knn_spy, solve_spy
    try:
        t0 = time.perf_counter()
        est = terrain.kriging_interpolate(pts, z, targets, device=DEVICE)
        spent["whole_s"] = time.perf_counter() - t0
        terrain._knn = lambda *a, **kw: kept["knn"]      # the same neighbours
        est_cpu = terrain.kriging_interpolate(pts, z, targets, device="cpu")
    finally:
        terrain._knn, terrain.solve_systems = real_knn, real_solve
    A, b = kept["Ab"]
    At = torch.as_tensor(A, dtype=torch.float32, device=DEVICE)
    bt = torch.as_tensor(b, dtype=torch.float32, device=DEVICE).unsqueeze(-1)
    spent["solve_events_ms"] = (cuda_ms(lambda: torch.linalg.solve_ex(At, bt), 5)
                                if At.is_cuda else None)
    err = float(np.abs(est - est_cpu).max())
    sols = [kept[f"sol_{torch.device(d).type}"] for d in (DEVICE, "cpu")]
    spent["weights_max_diff"] = float(np.abs(sols[0] - sols[1]).max())
    spent["weights_differing"] = int((sols[0] != sols[1]).sum())
    log(f"[kriging] {len(targets)} targets from {DEM_POINTS} points, "
        f"{A.shape[1]}x{A.shape[2]} systems: KNN (host numpy) "
        f"{spent['knn_s']:.3f} s, solve on {DEVICE} {spent.get('solve_cuda_s', spent.get('solve_cpu_s')):.3f} s "
        f"with the copies (by events, solve_ex alone: {spent['solve_events_ms']} ms), "
        f"whole call {spent['whole_s']:.3f} s; the same solve on the cpu "
        f"{spent['solve_cpu_s']:.3f} s; estimates within {err:.3g} m of the cpu "
        f"solve's (limit {KRIGING_TOL_M}); the weights {spent['weights_differing']} "
        f"of {sols[0].size} apart, by at most {spent['weights_max_diff']:.3g}")
    if not (np.isfinite(est).all() and err <= KRIGING_TOL_M):
        raise AssertionError("[kriging] the card's solve is off the CPU's")
    out["kriging"] = {"targets": len(targets), "points": DEM_POINTS, **spent,
                      "max_err_m": err}
    shutil.rmtree(case, ignore_errors=True)
    return out


def run_probes(work: Path, made: Path) -> dict:
    """(d) luwenv's report, and luwval's gpu_memory writeback on a deck
    without mesh_control beside the card's total memory."""
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.utils.accelerator import probe_cuda_environment

    env = probe_cuda_environment()
    log(f"[luwenv] {json.dumps(env)}")
    case = work / "val"
    shutil.copytree(made, case)
    deck_path = case / "conf.luw"
    deck_path.write_text(deck_path.read_text().replace('mesh_control = "cell_size"\n', ""))
    rc, printed, _ = run_dispatch(["luwval", str(deck_path)])
    log(printed.rstrip())
    deck = load_deck(deck_path)
    mib = deck.get_int("gpu_memory")
    total = torch.cuda.get_device_properties(0).total_memory
    want = int(total * 0.85 / 2**20)
    log(f"[luwval] gpu_memory written {mib} MiB; the card's total "
        f"{total / 2**20:.0f} MiB, 85% = {want} MiB; validation = "
        f"{deck.get_text('validation')}")
    if rc != 0 or mib != want or deck.get_text("validation") != "pass":
        raise AssertionError("[luwval] the gpu_memory writeback or the gate failed")
    shutil.rmtree(case, ignore_errors=True)
    return {"luwenv": env, "gpu_memory_mib": mib, "total_mib": total / 2**20}


def phase_pipeline(work: Path) -> tuple:
    """The pre-processing pipeline on the card's machine: (made case,
    results of (a)-(d))."""
    log("== phase 4a: the pre-processing pipeline (makeluw -> runluw -> vtk2nc)")
    t0 = time.perf_counter()
    made, out = make_example(work)
    out = {"makeluw": out}
    out["route"] = run_made_route(work, made)
    out["district"] = run_district(work, made)
    out["probes"] = run_probes(work, made)
    out["seconds"] = time.perf_counter() - t0
    log(f"[pipeline] phase seconds {out['seconds']:.1f}")
    return made, out


def phase_main_path(work: Path, made: Path) -> dict:
    """The decks through run_deck; the NWP decks from `made`, the pipeline
    phase's makeluw output."""
    log("== phase 4: the example decks through run_deck")
    main = run_example_deck(work, "vk-bf16-400", storage="bf16", steps=400,
                            vk=True, keep=True)
    # the same deck split n_gpu = SHARD_SPLIT, every shard on card 0
    split = run_example_deck(work, "vk-bf16-sharded", storage="bf16",
                             steps=400, vk=True, n_gpu=SHARD_SPLIT,
                             device=SHARD_DEVICE, keep=True)
    split["against_unsplit"] = compare_split_deck(split, main, "vk-bf16-sharded")
    # phase_hosts runs the same deck over processes against these VTKs
    sharded = {"case": work / "vk-bf16-sharded",
               "vtks": {k: v for k, v in split["files"].items()
                        if k.endswith(".vtk")}}
    paths = {"vk-bf16-sharded": split}
    if torch.cuda.device_count() >= int(np.prod(SHARD_SPLIT)):
        spread = run_example_deck(work, "vk-bf16-sharded-4cards", storage="bf16",
                                  steps=400, vk=True, n_gpu=SHARD_SPLIT,
                                  device="cuda", keep=True)
        spread["against_unsplit"] = compare_split_deck(
            spread, main, "vk-bf16-sharded-4cards")
        paths["vk-bf16-sharded-4cards"] = spread
    else:
        log(f"[vk-bf16-sharded-4cards] not run: {torch.cuda.device_count()} "
            f"card(s) visible, n_gpu={list(SHARD_SPLIT)} on device=\"cuda\" "
            f"needs {int(np.prod(SHARD_SPLIT))}")
    for p in (main, *paths.values()):
        for k in ("fi", "u", "rho", "files"):
            p.pop(k, None)
    torch.cuda.empty_cache()
    off = run_example_deck(work, "novk-bf16-100", storage="bf16", steps=100, vk=False)
    fp16c = run_example_deck(work, "vk-fp16c-200", storage="fp16c", steps=200,
                             vk=True)
    wall = run_example_deck(work, "wall-vk-bf16-400", storage="bf16", steps=400,
                            vk=True, walls={"ground_z0": 0.055,
                                            "building_z0": 0.01}, frames=200)
    du = first_layer_du(wall["raw_u"], main["raw_u"], wall["flags"])
    log(f"[wall-vk-bf16-400] raw u at t=400 against vk-bf16-400's in the first "
        f"fluid layer above open ground: mean |du| = {du:.4f} m/s")
    if not du > 1e-3:
        raise AssertionError(f"the wall models changed the near-ground flow by "
                             f"only {du} m/s")
    wall["near_ground_du"] = du
    dg = run_datagen_deck(work, "dg-bf16-300", storage="bf16", steps=300, cases=2)
    torch.cuda.empty_cache()
    resume = run_resume_phase(work, dg.pop("last"))
    torch.cuda.empty_cache()
    nwp_t = run_nwp_deck(work, "nwp-t-bf16-300", steps=300, thermal=True,
                         source=made)
    torch.cuda.empty_cache()
    nwp = run_nwp_deck(work, "nwp-bf16-300", steps=300, thermal=False,
                       source=made)
    paths.update({"vk-bf16-400": main, "novk-bf16-100": off,
                  "vk-fp16c-200": fp16c, "wall-vk-bf16-400": wall,
                  "dg-bf16-300": dg, "nwp-t-bf16-300": nwp_t,
                  "nwp-bf16-300": nwp})
    for p in paths.values():
        p.pop("raw_u", None)
        p.pop("flags", None)
    return {"paths": paths, "resume": resume, "sharded": sharded}


PREPARED = {"profile": ("conf.luwpf", "CityDemo_PF.stl"),
            "datagen": ("conf.luwdg", "BlockDemo_DG.stl")}
# a site for the profile case's copy that luwutmnc converts (the deck has no
# geographic frame): the 636 m box at Niigata, the AIJ Case E city
PROFILE_SITE = ('cut_lon_manual = [139.0400, 139.0480]\n'
                'cut_lat_manual = [37.9170, 37.9230]\n'
                'utm_crs = "EPSG:32654"\nrotate_deg = 0.0\n')
WINDROSE_PROBS = (2, 2, 3, 3, 4, 5, 6, 8, 10, 14, 16, 11, 7, 4, 3, 2)
SEASON_TOL = 1e-6


def phase_dgprepare(work: Path) -> dict:
    """Phase 4b, first half: the port's `dispatch dgprepare` on copies of
    both examples with their proj_temp/*.stl removed; the made STL and deck
    byte for byte as the examples ship them.  Phase 4's profile and .luwdg
    decks then copy these made cases (SOURCES)."""
    log("== phase 4b (1/2): dgprepare makes the profile and .luwdg cases")
    out = {}
    for kind, shipped in (("profile", EXAMPLE), ("datagen", EXAMPLE_DG)):
        deck, stl = PREPARED[kind]
        made = work / f"{kind}-made"
        shutil.copytree(shipped, made)
        for old in (made / "proj_temp").glob("*.stl"):
            old.unlink()
        rc, printed, secs = run_dispatch(["dgprepare", str(made / deck)])
        log(printed.rstrip())
        same = {rel: (made / rel).read_bytes() == (shipped / rel).read_bytes()
                for rel in (deck, f"proj_temp/{stl}")}
        log(f"[post] dgprepare seconds {secs:.3f} ({kind}: exit {rc}; byte for "
            f"byte as shipped: {same})")
        if rc != 0 or not all(same.values()):
            raise AssertionError(f"[dgprepare] {kind}: exit {rc}, equal {same}")
        SOURCES[kind] = made
        out[kind] = {"seconds": secs, "equal_to_shipped": same}
    return out


def post_tool(seconds: dict, args, *, want=()) -> str:
    """One tool through the dispatcher: it must exit 0 and write every
    file in `want`; its seconds are logged as `[post] <command> seconds`."""
    rc, printed, secs = run_dispatch([str(a) for a in args])
    log(printed.rstrip())
    cmd = str(args[0])
    seconds[cmd] = seconds.get(cmd, 0.0) + secs
    log(f"[post] {cmd} seconds {secs:.3f}")
    missing = [str(p) for p in want if not Path(p).is_file()]
    if rc != 0 or missing:
        raise AssertionError(f"[post] {cmd} exit {rc}, missing {missing}")
    return printed


def hold_pngs(pngs) -> list:
    from latticeurbanwind_tpu_torch.io.png import png_size

    pngs = sorted(pngs)
    sizes = [png_size(p) for p in pngs]
    if not pngs or min(min(s) for s in sizes) < 1:
        raise AssertionError(f"[post] PNGs {pngs} sizes {sizes}")
    return sizes


def hold_netcdf(ncs) -> dict:
    shapes = {}
    for path in ncs:
        nc = read_nc(path)
        for name, arr in nc.items():
            if not np.isfinite(arr).all():
                raise AssertionError(f"[post] {path.name}: non-finite {name}")
        shapes[path.name] = {k: list(v.shape) for k, v in nc.items()}
    if not shapes:
        raise AssertionError("[post] no NetCDF written")
    return shapes


def season_against_cases(home: Path, dt: str) -> float:
    """The largest |u_avg| of SEASON_<dt>_avg.vtk off the sum of the case
    VTKs weighted by season_weights.csv (velocity weights), beside the
    limit: SEASON_TOL plus what the CSV's 6 decimals may round away."""
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points
    from latticeurbanwind_tpu_torch.post.season_average import discover_directional_avgs

    rows = np.loadtxt(home / "RESULTS" / "season_weights.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    avgs = discover_directional_avgs(home, dt)
    want, rounding = 0.0, 0.0
    for angle, vw, _, _ in rows:
        u = read_structured_points(avgs[float(angle)])[1]["u_avg"].astype(np.float64)
        want = want + vw * u
        rounding += 5e-7 * float(np.abs(u).max())
    _, season = read_structured_points(home / "RESULTS" / "vtk" / f"SEASON_{dt}_avg.vtk")
    err = float(np.abs(season["u_avg"] - want).max())
    log(f"[luwseason] season u_avg against the cases weighted by "
        f"season_weights.csv ({len(rows)} cases): max |diff| {err:.3g} m/s "
        f"(limit {SEASON_TOL} + {rounding:.3g} for the CSV's rounding)")
    if not err <= SEASON_TOL + rounding:
        raise AssertionError(f"[luwseason] season u_avg off the weighted cases by {err}")
    return err


def phase_examples_post(work: Path, made: Path) -> dict:
    """Phase 4b, second half: the post-processing tools through the port's
    dispatcher on the outputs phase 4 and 4a's decks wrote, each timed."""
    log("== phase 4b (2/2): the examples' post-processing routes")
    t0 = time.perf_counter()
    secs, out = {}, {}
    # the profile route on vk-bf16-400's outputs
    home = work / "vk-bf16-400"
    deck = home / "conf.luwpf"
    vtk = home / "RESULTS" / "vtk"
    avg = vtk / f"{DATETIME}_avg-000000400.vtk"
    raw = vtk / f"{DATETIME}_raw_u-000000400.vtk"
    figs = home / "RESULTS" / "figures"
    deck.write_text(deck.read_text() + PROFILE_SITE)
    post_tool(secs, ["luwutmnc", deck, "--overwrite"],
              want=[home / "RESULTS" / "nc_utm_asl" / f"{avg.stem}_utm_asl.nc"])
    out["luwutmnc"] = hold_netcdf((home / "RESULTS" / "nc_utm_asl").glob("*.nc"))
    post_tool(secs, ["luwcutvis", deck, "100", "536", "100", "536"],
              want=[vtk / f"{avg.stem}_cropped.vtk",
                    figs / f"{avg.stem}_wind9.png", figs / f"{avg.stem}_tke9.png"])
    post_tool(secs, ["luwtkeviz", avg, "--out", home / "RESULTS" / "tke_viz"],
              want=[home / "RESULTS" / "tke_viz" / f"{avg.stem}_{k}_layers.png"
                    for k in ("wind", "tke")])
    post_tool(secs, ["luwspectra", deck],
              want=[figs / f"{raw.stem}_{k}" for k in
                    ("Ek.csv", "Ek.png", "kxky_overview.png", "kxky_layers.csv")])
    post_tool(secs, ["luwvideo", raw, "--out-dir", home / "video"],
              want=[home / "video" / f"frame_{i:05d}.png" for i in range(2)])
    printed = post_tool(secs, ["buildingscale", deck])
    if "lambda_p" not in printed:
        raise AssertionError("[post] buildingscale printed no statistics")
    out["profile_pngs"] = len(hold_pngs([*figs.glob("*.png"),
                                         *(home / "RESULTS" / "tke_viz").glob("*.png"),
                                         *(home / "video").glob("*.png")]))
    # the dataset-generation route on dg-bf16-300's averaged VTKs
    home = work / "dg-bf16-300-case-parallel"
    (home / "wind_bc").mkdir(exist_ok=True)
    (home / "wind_bc" / "profile.dat").write_text("z,U\n1\t3.0\n10\t6.0\n100\t9.0\n")
    from latticeurbanwind_tpu_torch.post.season_average import COMPASS

    probs = np.array(WINDROSE_PROBS, float)
    probs *= 100.0 / probs.sum()
    rows = ["dir,C1_4_8"] + [f"{c},{p:.6f}" for c, p in zip(COMPASS, probs)]
    (home / "wind_bc" / "windrose_10m.csv").write_text("\n".join(rows) + "\n")
    post_tool(secs, ["luwseason", home / "conf.luwdg"],
              want=[home / "RESULTS" / "vtk" / f"SEASON_{DATETIME}_avg.vtk",
                    home / "RESULTS" / "season_weights.csv",
                    home / "RESULTS" / "season_summary.txt",
                    home / "RESULTS" / "figures" / f"season_{DATETIME}_wind.png"])
    hold_pngs((home / "RESULTS" / "figures").glob("season_*.png"))
    out["season_max_diff"] = season_against_cases(home, DATETIME)
    # the flagship route's last step on phase 4a's 16 m run
    home = work / "nwp-made-16m"
    post_tool(secs, ["visluw", home / "conf.luw"])
    out["visluw"] = hold_netcdf((home / "RESULTS").glob("*_visluw.nc"))
    out["visluw_pngs"] = len(hold_pngs((home / "RESULTS" / "sections").glob("wind_*m.png")))
    # visdem on a seeded DEM grid, shptester on phase 4a's footprints
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(0.0, 2000.0, 10.0), np.arange(0.0, 1500.0, 10.0))
    z = (40.0 + 25.0 * np.exp(-((xs - 900) ** 2 + (ys - 700) ** 2) / 3e5)
         + rng.normal(0.0, 0.5, xs.shape))
    dem = work / "dem" / "interpolated_dem.csv"
    dem.parent.mkdir()
    np.savetxt(dem, np.column_stack([xs.ravel(), ys.ravel(), z.ravel()]),
               delimiter=",", header="x,y,z", comments="")
    post_tool(secs, ["visdem", dem, work / "dem" / "dem.png"],
              want=[work / "dem" / "dem.png"])
    hold_pngs([work / "dem" / "dem.png"])
    shp = sorted((made / "building_db").glob("*.shp"))
    printed = post_tool(secs, ["shptester", shp[0]])
    if "records:" not in printed:
        raise AssertionError("[post] shptester printed no report")
    log("[post] luwaij not run: the AIJ Case E workbook is not in the "
        "repository (tests/test_aij_validation.py:21), so no deck has its "
        "measurements to compare with")
    out["seconds"] = secs
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"[post] phase 4b seconds {out['phase_seconds']:.1f}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return out


STUDIO_JOB_S = 300              # a studio job's time limit
STUDIO_VTK_TOL = 1e-6           # if the job's VTK bytes differ from the direct run's


def studio_get(base: str, path: str):
    """(content type, body, headers) of one GET to the studio."""
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.headers.get_content_type(), r.read(), r.headers


def studio_json(base: str, path: str, post=None):
    import urllib.error
    import urllib.request

    req = (urllib.request.Request(base + path, data=json.dumps(post).encode(),
                                  method="POST") if post is not None else base + path)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:     # error answers carry JSON
        return json.loads(e.read())


def png_title(raw: bytes) -> str:
    """A PNG's tEXt Title (its chunks' CRCs checked), or raise."""
    import struct
    import zlib

    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, title, size = 8, None, None
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        if struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise AssertionError(f"bad CRC in the PNG's {kind!r} chunk")
        if kind == b"IHDR":
            size = struct.unpack(">II", data[:8])
        if kind == b"tEXt" and data.startswith(b"Title\x00"):
            title = data[6:].decode("latin-1")
        pos += 12 + n
    if not size or min(size) < 1 or not title:
        raise AssertionError(f"PNG size {size}, title {title!r}")
    return title


def vtk_max_diff(a: Path, b: Path) -> float:
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points

    fa, fb = read_structured_points(a)[1], read_structured_points(b)[1]
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"{a.name}: fields {sorted(fa)} != {sorted(fb)}")
    return max(float(np.abs(fa[k].astype(np.float64) - fb[k]).max()) for k in fa)


def phase_studio(work: Path, made: Path, direct_launches: dict) -> dict:
    """Phase 4c: the port's studio (`gui/server.py`) on a copy of the 16 m
    NWP case phase 4a made.  A `runluw conf.luw` job (a child process of
    the port's dispatcher, on the card) must exit 0 and write the VTKs of
    phase 4a's direct `runluw` of the same deck, and the kernel launches
    its runluw summary prints must equal that direct run's counted
    launches (`direct_launches`); then the job's averaged
    VTK through /api/render (slice, MIP, 3d), /api/volinfo and /api/brick,
    and /api/env, which must name this card and report the kernels built.
    Each request is timed (`[studio] <step> seconds`)."""
    import threading

    from latticeurbanwind_tpu_torch.gui.server import serve

    log("== phase 4c: the studio drives the 16 m NWP deck through the kernels")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    case = work / "studio-nwp-16m"
    shutil.copytree(made, case)
    direct = work / "nwp-made-16m" / "RESULTS" / "vtk"
    httpd = serve(case, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    secs, out = {}, {}

    def timed(step, fn):
        t0 = time.perf_counter()
        r = fn()
        secs[step] = time.perf_counter() - t0
        log(f"[studio] {step} seconds {secs[step]:.3f}")
        return r

    try:
        env = timed("env", lambda: studio_json(base, "/api/env"))
        log(f"[studio] /api/env: {json.dumps(env)}")
        if not (env.get("cards", 0) >= 1
                and env["devices"][0]["name"] == torch.cuda.get_device_name(0)
                and env["kernels"]["built"]):
            raise AssertionError(f"[studio] /api/env does not name the card or the "
                                 f"built kernels: {env}")

        def job():
            j = studio_json(base, "/api/run", post={"cmd": "runluw",
                                                    "args": ["conf.luw"], "cwd": ""})
            if "error" in j:
                raise AssertionError(f"[studio] /api/run refused: {j}")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < STUDIO_JOB_S:
                st = studio_json(base, f"/api/job?id={j['id']}")
                if st["done"]:
                    return st
                time.sleep(0.2)
            raise AssertionError(f"[studio] job not done in {STUDIO_JOB_S} s")

        st = timed("runluw job", job)
        log("\n".join(f"[studio job] {line}" for line in st["lines"]))
        log(f"[studio] job argv {st['argv'][1:]}, exit {st['rc']}, "
            f"progress {st['progress']}")
        if st["rc"] != 0:
            raise AssertionError(f"[studio] runluw job exit {st['rc']}")
        if not any(f"device={DEVICE}" in line for line in st["lines"]):
            raise AssertionError(f"[studio] the job did not run on {DEVICE}")
        tag = "runluw-torch: kernel launches "
        counted = [json.loads(line.split(tag, 1)[1]) for line in st["lines"]
                   if tag in line]
        job_launches = {k: counted[-1].get(k) for k in direct_launches} \
            if counted else None
        log(f"[studio] the job's kernel launches {counted[-1] if counted else None}"
            f", phase 4a's direct runluw {direct_launches}")
        if job_launches != direct_launches:
            raise AssertionError(f"[studio] the job's launches {job_launches} "
                                 f"!= the direct run's {direct_launches}")
        out["launches"] = counted[-1]
        got = {p.name: p for p in (case / "RESULTS" / "vtk").glob("*.vtk")}
        want = {p.name: p for p in direct.glob("*.vtk")}
        if sorted(got) != sorted(want) or not want:
            raise AssertionError(f"[studio] job VTKs {sorted(got)} != direct "
                                 f"{sorted(want)}")
        differ = {n: vtk_max_diff(got[n], want[n]) for n in sorted(want)
                  if got[n].read_bytes() != want[n].read_bytes()}
        log(f"[studio] the job's {len(got)} VTKs against the direct runluw's: "
            + ("byte for byte equal" if not differ else
               f"{len(differ)} differ, max |diff| {differ}"))
        if any(not v <= STUDIO_VTK_TOL for v in differ.values()):
            raise AssertionError(f"[studio] job VTKs off the direct run: {differ}")
        out["vtks"] = len(got)
        out["vtks_differing"] = differ
        avg = sorted(n for n in got if "_avg-" in n)[-1]
        rel = f"RESULTS/vtk/{avg}"
        shape = timed("vtkinfo", lambda: studio_json(
            base, f"/api/vtkinfo?path={rel}"))["fields"]["u_avg"]
        pngs = {}
        for mode in ("slice", "mip", "3d"):
            q = f"/api/render?path={rel}&mode={mode}" + (
                f"&field=u_avg&z={shape[1] // 2}" if mode != "3d" else "")
            ctype, body, _ = timed(f"render {mode}", lambda: studio_get(base, q))
            if ctype != "image/png":
                raise AssertionError(f"[studio] render {mode}: {ctype} {body[:200]!r}")
            pngs[mode] = {"bytes": len(body), "title": png_title(body)}
            if avg not in pngs[mode]["title"]:
                raise AssertionError(f"[studio] render {mode} title {pngs[mode]}")
        log(f"[studio] renders {pngs}")
        info = timed("volinfo", lambda: studio_json(base, f"/api/volinfo?path={rel}&field=u"))
        if "error" in info:
            raise AssertionError(f"[studio] volinfo: {info}")
        def bricks():       # every brick of every level
            n = 0
            for lvl, level in enumerate(info["levels"]):
                for i, j, k in np.ndindex(*level["bricks"]):
                    _, body, hdr = studio_get(
                        base, f"/api/brick?path={rel}&field=u&level={lvl}"
                              f"&i={i}&j={j}&k={k}")
                    dims = [int(v) for v in hdr["X-Brick-Shape"].split(",")]
                    tile = np.frombuffer(body, np.float16)
                    if tile.size != int(np.prod(dims)) or \
                            not np.isfinite(tile.astype(np.float32)).all():
                        raise AssertionError(f"[studio] brick {lvl}/{i},{j},{k}")
                    n += 1
            return n

        out["bricks"] = timed("bricks", bricks)
        out.update(env=env, renders=pngs, levels=len(info["levels"]), job_rc=st["rc"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
    out["seconds"] = secs
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[studio] phase 4c seconds {out['phase_seconds']:.1f}")
    shutil.rmtree(case, ignore_errors=True)
    return out


def varied_state(sim, seed: int):
    """A check's simulation started from fields that vary along every axis:
    its initial rho, u (and T) each plus seeded noise of 0.01, its flags
    as they were.  The checks' own initial states are uniform along their
    small axes (the cavity and the vortex street along z, Poiseuille along
    y and x), where a kernel that read the wrong plane, row or column of a
    grid smaller than one tile would give the same bytes."""
    from latticeurbanwind_tpu_torch.lbm.state import make_initial_state

    rng = np.random.default_rng(seed)
    shape, init = sim.shape, sim.init
    rho = np.ones(shape) if init.get("rho") is None else np.asarray(init["rho"])
    u = np.zeros((3, *shape)) if init.get("u") is None else np.asarray(init["u"])
    fields = {"flags": init.get("flags"),
              "rho": rho + 0.01 * rng.standard_normal(shape),
              "u": u + 0.01 * rng.standard_normal(u.shape)}
    if sim.config.thermal:
        T = np.ones(shape) if init.get("T") is None else np.asarray(init["T"])
        fields["T"] = T + 0.01 * rng.standard_normal(shape)
    return make_initial_state(shape, config=sim.config, device=DEVICE, **fields)


def sim_against_plain(sim, fi0, gi0, steps: int) -> float:
    """K-SC and its plain version, each `steps` steps from (fi0, gi0) with
    the simulation's flags, config and dyn row: the largest difference of
    f (and g)."""
    from latticeurbanwind_tpu_torch.lbm.state import Forcing, dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        stream_collide, stream_collide_plain,
    )

    flags, cfg = sim.state.flags, sim.config
    row = dyn_row(sim.dyn, DEVICE)
    fk, fp = fi0.clone(), fi0.clone()
    gk = [gi0.clone(), torch.empty_like(gi0)] if gi0 is not None else [None, None]
    gp = [gi0.clone(), torch.empty_like(gi0)] if gi0 is not None else [None, None]
    for _ in range(steps):
        fk = stream_collide(fk, flags, row, cfg, Forcing(), gi=gk[0], gi_out=gk[1])
        fp = stream_collide_plain(fp, flags, row, cfg, Forcing(), gi=gp[0],
                                  gi_out=gp[1])
        gk.reverse()
        gp.reverse()
    torch.cuda.synchronize()
    e = max_err(fk, fp)
    return e if gi0 is None else max(e, max_err(gk[0], gp[0]))


PHYSICS_VARIED_STEPS = 16      # K-SC against plain from a varied state


def phase_physics() -> dict:
    """Phase 5: every published-value check of `lbm/physics_checks.py` on
    the kernels in f32 (launches counted: one K-SC per step), each measured
    value printed beside its published value and band; a value outside its
    band fails the smoke.  Then, at each simulation's shape, flags, config
    and dyn row, K-SC and its plain version on the card must agree within
    the f32 (wall) tolerance at these grids (3 planes deep, 4 cells wide):
    5 steps from the simulation's initial state, and `PHYSICS_VARIED_STEPS`
    steps from a seeded state that varies along every axis
    (`varied_state`)."""
    from latticeurbanwind_tpu_torch.lbm import physics_checks as pc

    log("== phase 5: the published-value physics checks on the kernels")
    t_phase = time.perf_counter()
    out, outside, sims = {}, [], []
    for name, check in pc.CHECKS.items():
        zero_launches()
        t0 = time.perf_counter()
        c = check(DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        expect = {"stream_collide": c.steps,
                  "stream_collide_wall": sum(s.steps for s in c.sims
                                             if s.config.wall_model),
                  "stream_collide_thermal": sum(s.steps for s in c.sims
                                                if s.config.thermal)}
        log(f"[physics] {c}; {secs:.2f} s, launches {launches}")
        if sum(s.steps for s in c.sims) != c.steps or any(
                launches[k] != v for k, v in expect.items()):
            raise AssertionError(f"[physics] {name}: launches {launches}, "
                                 f"expected {expect}")
        if not c.ok:
            outside.append(name)
        out[name] = {"ok": c.ok, "seconds": secs, "steps": c.steps,
                     "launches": launches["stream_collide"],
                     "rows": [{"label": r.label, "value": r.value,
                               "lo": r.lo, "hi": r.hi, "published": r.ref}
                              for r in c.rows]}
        sims.extend(c.sims)
    t0 = time.perf_counter()
    initial, varied = {}, {}
    for seed, sim in enumerate(sims):
        cfg = sim.config
        tol = tolerance("f32", "wall" if cfg.wall_model else "")
        key = f"{sim.shape}{' wall' if cfg.wall_model else ''}" \
              f"{' thermal' if cfg.thermal else ''}"
        e0 = sim_against_plain(sim, *sim.initial, 5)
        st = varied_state(sim, seed)
        e1 = sim_against_plain(sim, st.fi, st.gi, PHYSICS_VARIED_STEPS)
        initial[key] = max(e0, initial.get(key, 0.0))
        varied[key] = max(e1, varied.get(key, 0.0))
        if not (e0 <= tol and e1 <= tol):
            raise AssertionError(f"[physics] K-SC off its plain version at {key}: "
                                 f"{e0} (5 steps from the initial state), {e1} "
                                 f"({PHYSICS_VARIED_STEPS} steps from a varied "
                                 f"state) against {tol}")
    log(f"[physics] K-SC against its plain version, 5 steps from each check's "
        f"initial state: max |diff| {initial}")
    log(f"[physics] K-SC against its plain version, {PHYSICS_VARIED_STEPS} steps "
        f"from a seeded state varying along every axis: max |diff| {varied}; "
        f"{time.perf_counter() - t0:.2f} s")
    out["kernel_against_plain"] = initial
    out["kernel_against_plain_varied"] = varied
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[physics] phase 5 seconds {out['phase_seconds']:.1f}")
    if outside:
        raise AssertionError(f"[physics] outside their bands: {outside}")
    return out


HOSTS_PROCESSES = 2
HOSTS_CHILD_S = 420             # a deck process's time limit
HOSTS_TIMED_STEPS = 50
HOSTS_CKPT_SHAPE = (24, 72, 136)
# a deck process: this script in its child mode
HOSTS_CHILD = [sys.executable, str(REPO / "chip_smoke.py"), "--hosts-child"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argv, n: int, timeout: float, cwd=None, env_of=None) -> list:
    """`argv` in `n` processes under the environment contract of
    `parallel/comm.py::ensure_distributed` on a free local port (process k
    gets `env_of(k)` besides); their outputs.  A process that fails or
    outlives `timeout` fails the phase and every other one is killed."""
    import os

    port = free_port()
    procs = []
    for k in range(n):
        env = dict(os.environ, LUW_COORDINATOR=f"127.0.0.1:{port}",
                   LUW_NUM_PROCESSES=str(n), LUW_PROCESS_ID=str(k),
                   PYTHONPATH=str(REPO))
        env.update(env_of(k) if env_of else {})
        procs.append(subprocess.Popen(argv, env=env, cwd=cwd, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = [None] * n
    deadline = time.monotonic() + timeout
    try:
        while any(o is None for o in outs):
            for k, p in enumerate(procs):
                if outs[k] is None and p.poll() is not None:
                    outs[k] = p.communicate()[0]
                    if p.returncode:
                        raise AssertionError(f"process {k} exited {p.returncode}")
            if time.monotonic() > deadline:
                raise AssertionError(f"processes outlived {timeout} s")
            time.sleep(0.2)
    except AssertionError as e:
        for k, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            if outs[k] is None:
                outs[k] = p.communicate()[0]
        raise AssertionError(f"{e}:\n" + "\n".join(
            f"--- process {k} (rc {p.returncode}), last lines:\n"
            + "\n".join(o.splitlines()[-40:]) for k, (p, o) in
            enumerate(zip(procs, outs)))) from None
    return outs


def printed_json(text: str, tag: str):
    """The JSON after `tag` on the last line of `text` that starts with it."""
    line = [x for x in text.splitlines() if x.startswith(tag)][-1]
    return json.loads(line[len(tag):])


def fi_digest(fi: torch.Tensor) -> str:
    """SHA-256 of a DDF tensor's stored codes."""
    import hashlib

    codes = fi.cpu().view(torch.int16) if fi.element_size() == 2 else fi.cpu()
    return hashlib.sha256(codes.numpy().tobytes()).hexdigest()


def hosts_child(deck: Path, device: str, ckpt: Path | None) -> None:
    """One process of a deck run over several processes (phase_hosts,
    chip_four.py): the deck through the port's `cli.run` on `device`, the
    peak memory of each card it uses, the final DDFs' digest (process 0);
    then the split step on the run's own runner and final shards, in
    lock-step with the other processes: the whole step, the exchange, the
    K8 launches and the FaceBC refresh apart by the host clock between
    synchronisations and barriers (the K8 launches also by events on the
    first card), and the bytes staged through the host per step; then,
    with `ckpt`, the sharded runner on HOSTS_CKPT_SHAPE saving a checkpoint
    set into `ckpt` at steps 7 and 9.  Prints `HOSTS {...}`."""
    import latticeurbanwind_tpu_torch.run.driver as driver
    import latticeurbanwind_tpu_torch.run.modes as modes
    from latticeurbanwind_tpu_torch.cli.run import main as runluw
    from latticeurbanwind_tpu_torch.parallel.comm import barrier

    seen = {}
    real = (driver.make_sharded_runner, driver.gather_state, modes.run_case)

    def runner_spy(config, forcing, mesh, **kw):
        seen["run"], impl = real[0](config, forcing, mesh, **kw)
        seen["mesh"] = mesh
        return seen["run"], impl

    def gather_spy(sstate, *a):
        seen["final"] = sstate
        seen["gathered"] = real[1](sstate, *a)
        return seen["gathered"]

    def case_spy(case, **kw):
        seen["case"] = case
        seen["result"] = real[2](case, **kw)
        return seen["result"]

    driver.make_sharded_runner, driver.gather_state = runner_spy, gather_spy
    modes.run_case = case_spy
    try:
        if runluw([str(deck), "--device", device]):
            raise AssertionError("runluw failed")
    finally:
        driver.make_sharded_runner, driver.gather_state, modes.run_case = real
    mesh, run, dyn = seen["mesh"], seen["run"], seen["case"].dyn
    result = {"rank": mesh.rank, "backend": mesh.transport.backend,
              "shards": list(mesh.local),
              "devices": [str(d) for d in mesh.local_devices],
              # since the process began: peak memory of each card it uses
              "peak_gib": [torch.cuda.max_memory_allocated(d) / 2**30
                           for d in sorted(set(mesh.local_devices), key=str)],
              "solver_seconds": seen["result"].solver_seconds,
              "mlups": seen["result"].timing["mlups"]}
    if seen["gathered"] is not None:
        result["fi_sha256"] = fi_digest(seen["gathered"].fi)
    devices = set(mesh.local_devices)
    cell = {"s": seen.pop("final"), "t": 10 ** 6}
    seen.clear()

    def lockstep_ms(fn, reps: int = HOSTS_TIMED_STEPS) -> float:
        for d in devices:
            torch.cuda.synchronize(d)
        barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        for d in devices:
            torch.cuda.synchronize(d)
        barrier()
        return (time.perf_counter() - t0) * 1e3 / reps

    def step():
        cell["s"] = run(cell["s"], dyn, cell["t"], 1)
        cell["t"] += 1

    lockstep_ms(step, 5)
    staged0 = mesh.transport.staged_bytes
    result["step_ms"] = lockstep_ms(step)
    result["staged_bytes_per_step"] = (
        (mesh.transport.staged_bytes - staged0) / HOSTS_TIMED_STEPS)
    stages = run.stages(cell["s"], dyn, cell["t"])
    stages.refresh()
    result["exchange_ms"] = lockstep_ms(stages.exchange)
    result["kernels_ms"] = lockstep_ms(stages.kernels)
    result["kernels_event_ms"] = cuda_ms(stages.kernels, reps=HOSTS_TIMED_STEPS)
    result["refresh_ms"] = lockstep_ms(stages.refresh)
    del stages, cell
    torch.cuda.empty_cache()
    if ckpt is not None:
        result["checkpoint"] = hosts_checkpoint(ckpt, device)
    log("HOSTS " + json.dumps(result))


def hosts_checkpoint(out: Path, device: str) -> dict:
    """The sharded runner SHARD_SPLIT on HOSTS_CKPT_SHAPE (bf16, nudge +
    sponge, VK hook) over this run's processes, a checkpoint set saved at
    steps 7 and 9 into `out`: the seconds of each save.  Process 1 removes
    its stale sibling after the second barrier of the save, so the set is
    read once the processes are done."""
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )
    from latticeurbanwind_tpu_torch.run.checkpoint import save_checkpoint

    cfg, st, frc, row = make_case(HOSTS_CKPT_SHAPE, "bf16", inflow=0.05,
                                  device=device)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    pre, _ = vk_hook(st)
    mesh = domain_mesh(SHARD_SPLIT, HOSTS_CKPT_SHAPE, device)
    run, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    ss = shard_state(st, mesh)
    seconds, t = {}, 0
    for step in (7, 9):
        ss = update_fields_sharded(run(ss, dyn, t, step - t), cfg, dyn)
        t = step
        t0 = time.perf_counter()
        save_checkpoint(out / "hosts.ckpt.npz", ss, step=step,
                        fbc=run.get_fbc())
        seconds[step] = time.perf_counter() - t0
    return {"save_seconds": seconds}


def hosts_checkpoint_reference(device: str):
    """hosts_checkpoint's state at step 9 in this one process, split
    SHARD_SPLIT on `device`, gathered to the host."""
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )

    cfg, st, frc, row = make_case(HOSTS_CKPT_SHAPE, "bf16", inflow=0.05,
                                  device=device)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    pre, _ = vk_hook(st)
    mesh = domain_mesh(SHARD_SPLIT, HOSTS_CKPT_SHAPE, device)
    run, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    ss = update_fields_sharded(run(shard_state(st, mesh), dyn, 0, 7), cfg, dyn)
    ss = update_fields_sharded(run(ss, dyn, 7, 2), cfg, dyn)
    return gather_state(ss)


def run_deck_processes(work: Path, source: Path, tag: str, *, device: str,
                       n: int, ckpt: bool = False, env_of=None) -> dict:
    """A copy of the deck case `source` (its outputs left behind) run by
    `n` processes of `hosts_child` on `device`: each process's lines, its
    launches (the runluw summary line), its HOSTS record; the run's VTKs
    (name -> path) and the wall seconds."""
    case = work / tag
    shutil.copytree(source, case, ignore=shutil.ignore_patterns(
        "RESULTS", "snapshots", "frames", "checkpoints"))
    deck = next(case.glob("conf.luw*"))
    argv = HOSTS_CHILD + [str(deck), device] + ([str(case)] if ckpt else [])
    t0 = time.perf_counter()
    outs = run_processes(argv, n, HOSTS_CHILD_S, cwd=case, env_of=env_of)
    wall = time.perf_counter() - t0
    procs = [{"launches": printed_json(o, "runluw-torch: kernel launches "),
              "record": printed_json(o, "HOSTS "),
              "lines": [x for x in o.splitlines() if x.startswith("| ")]}
             for o in outs]
    return {"processes": procs, "wall": wall, "case": case,
            "vtks": {p.name: p for p in (case / "RESULTS" / "vtk").glob("*.vtk")}}


def phase_hosts(work: Path, sharded: dict) -> dict:
    """The several-hosts path on card 0: `vk-bf16-sharded`'s deck (1.5 m,
    n_gpu = SHARD_SPLIT, 400 steps) run by HOSTS_PROCESSES processes of the
    port's `cli.run --device cuda:0`, gloo through the host between them:
    each process launches K8 400 x its shards (all with VK sites) and no
    K-AVG, process 0 writes every VTK, each byte for byte
    `vk-bf16-sharded`'s (`sharded`: its case directory and VTKs); the split
    step, its exchange and the host-staged bytes per step; then the
    sharded runner's checkpoint set of both processes, loaded here code for
    code equal to this process's split state."""
    from latticeurbanwind_tpu_torch.run.checkpoint import load_checkpoint

    log("== phase hosts: the split deck over processes on card 0")
    t0 = time.perf_counter()
    run = run_deck_processes(work, sharded["case"], "hosts-bf16-sharded",
                             device=SHARD_DEVICE, n=HOSTS_PROCESSES, ckpt=True)
    from latticeurbanwind_tpu_torch.deck import load_deck

    steps = load_deck(next(run["case"].glob("conf.luw*"))).get_int("run_nstep")
    records = [p["record"] for p in run["processes"]]
    for k, p in enumerate(run["processes"]):
        shards = len(p["record"]["shards"])
        want = {"stream_collide": steps * shards,
                "stream_collide_vk": steps * shards,
                "stream_collide_halo": steps * shards,
                "stream_collide_wall": 0, "stream_collide_thermal": 0,
                "vk_sites": 0, "avg_update": 0, "avg_update_wall": 0}
        got = {key: p["launches"].get(key) for key in want}
        log(f"[hosts] process {k}: " + "; ".join(p["lines"]))
        log(f"[hosts] process {k} (shards {p['record']['shards']}, data over "
            f"{p['record']['backend']}): launches {p['launches']}")
        if got != want or p["record"]["backend"] != "gloo":
            raise AssertionError(f"[hosts] process {k} launches {got} != {want}")
    names = sorted(sharded["vtks"])
    if sorted(run["vtks"]) != names:
        raise AssertionError(f"[hosts] VTKs {sorted(run['vtks'])} != {names}")
    same = {n: run["vtks"][n].read_bytes() == sharded["vtks"][n].read_bytes()
            for n in names}
    log(f"[hosts] VTKs against vk-bf16-sharded's: " + ", ".join(
        f"{n} {'byte for byte' if v else 'DIFFER'}" for n, v in same.items()))
    if not all(same.values()):
        raise AssertionError("[hosts] the VTKs differ from vk-bf16-sharded's")
    want = hosts_checkpoint_reference(SHARD_DEVICE)
    got, step, _, _, _ = load_checkpoint(run["case"] / "hosts.ckpt.npz",
                                         expect_shape=HOSTS_CKPT_SHAPE)
    apart = {k: codes_apart(getattr(got, k).to(getattr(want, k).device),
                            getattr(want, k))["differing"]
             for k in ("fi", "rho", "u")}
    apart["flags"] = int((got.flags != want.flags).sum())
    files = sorted(p.name for p in run["case"].glob("hosts.ckpt*"))
    log(f"[hosts] checkpoint set {files} at step {step}, against the split "
        f"state of one process: differing " + ", ".join(
            f"{k} {v}" for k, v in apart.items()))
    if step != 9 or any(apart.values()) or files != [
            "hosts.ckpt.npz", "hosts.ckpt.npz.p1.s9.npz"]:
        raise AssertionError("[hosts] the checkpoint set does not assemble")
    shutil.rmtree(run["case"], ignore_errors=True)
    timing = {k: [r[k] for r in records] for k in (
        "step_ms", "exchange_ms", "kernels_ms", "kernels_event_ms",
        "refresh_ms", "staged_bytes_per_step")}
    seconds = time.perf_counter() - t0
    log(f"[hosts] split step over {HOSTS_PROCESSES} processes on card 0, ms "
        f"per step (host clock, in lock-step) by process: whole "
        f"{timing['step_ms']}, exchange {timing['exchange_ms']}, K8 launches "
        f"{timing['kernels_ms']} (events {timing['kernels_event_ms']}), "
        f"refresh {timing['refresh_ms']}; bytes staged through the host per "
        f"step {timing['staged_bytes_per_step']}; solver seconds "
        f"{[r['solver_seconds'] for r in records]}; processes' wall "
        f"{run['wall']:.1f} s, phase {seconds:.1f} s")
    return {"timing": timing, "launches": [p["launches"] for p in run["processes"]],
            "solver_seconds": [r["solver_seconds"] for r in records],
            "mlups": [r["mlups"] for r in records],
            "peak_gib": [r["peak_gib"] for r in records],
            "checkpoint_save_seconds": records[0]["checkpoint"]["save_seconds"],
            "vtks_equal": same, "wall": run["wall"], "seconds": seconds}


def main() -> int:
    card = phase_card()
    from latticeurbanwind_tpu_torch.utils.cuda_build import BUILD_DIR

    errs = phase_compare()
    timing = phase_timing()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=BUILD_DIR))
    try:
        made, pipeline = phase_pipeline(work)
        prepared = phase_dgprepare(work)
        deck = phase_main_path(work, made)
        examples = phase_examples_post(work, made)
        examples["dgprepare"] = prepared
        studio = phase_studio(work, made, pipeline["route"]["launches"])
        hosts = phase_hosts(work, deck.pop("sharded"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    physics = phase_physics()

    paths = deck["paths"]
    paths["nwp-made-16m"] = pipeline["route"]
    by_path = {tag: p["launches"] for tag, p in paths.items()}
    # each kernel's launches on the deck path that runs it: the no-wall step
    # on the example deck as it ships, the wall step and K-AVG on it with
    # the wall models
    main_sc = paths["vk-bf16-400"]["launches"]
    main_wall = paths["wall-vk-bf16-400"]["launches"]
    main_th = paths["nwp-t-bf16-300"]["launches"]
    main_halo = paths["vk-bf16-sharded"]["launches"]
    plain_instances = tiled_families(card["registers"]).get(
        "plain (no wall model, SRT)", ())
    errs["stream_collide_halo"][timing["halo"]["name"]] = timing["halo"]["max_abs_err"]

    def times(prefix, wall, thermal=False):
        return {k: v for k, v in timing["configs"].items()
                if k.startswith(prefix) and thermal == (" thermal" in k)
                and (thermal or wall == any(w in k for w in (" wall", " trt")))}

    def timed(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}      # no one PyTorch call does a D3Q19 step

    record = {"kernels": [
        {"name": "stream_collide", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide_tiled.cuh",
         "unit": "latticeurbanwind_tpu_torch/csrc/stream_collide.cu",
         "registers": {k: v for k, v in card["registers"].items()
                       if k in plain_instances},
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:408",
         "launches": main_sc["stream_collide"] - main_sc["stream_collide_wall"],
         "launches_with_vk_sites": main_sc["stream_collide_vk"],
         "max_abs_err": max(errs["stream_collide"].values()),
         **timed(timing["sc"]),
         "launches_by_path": {k: v["stream_collide"] - v["stream_collide_wall"]
                              - v["stream_collide_thermal"]
                              - v["stream_collide_halo"]
                              for k, v in by_path.items()},
         "max_abs_err_by_config": errs["stream_collide"],
         "times_by_config": times("K-SC", False),
         "nwp_grid": timing["sc_nwp"],
         "step_loop_by_path": {k: v["step_loop"] for k, v in paths.items()
                               if "step_loop" in v
                               and not k.startswith(("wall", "nwp-t"))}},
        {"name": "vk_sites", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide.cu",
         "registers": {k: v for k, v in card["registers"].items()
                       if k.startswith("vk_site")},
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:915",
         # launched by stream_collide after every step with sites
         "launches": main_sc["stream_collide_vk"],
         "max_abs_err": max(v["max_abs"] for v in errs["vk_sites"].values()),
         "differing_codes_by_config": errs["vk_sites"],
         "ms": timing["sites"]["ms"], "plain_ms": timing["sites"]["plain_ms"],
         "bound_ms": timing["sites"]["bound_ms"],
         "bound_by": timing["sites"]["bound_by"],
         "sector_bound_ms": timing["sites"]["sector_bound_ms"],
         "library_ms": None,     # no one PyTorch call blends the sites
         "nwp_grid": timing["sites_nwp"],
         "launches_by_path": {k: v["stream_collide_vk"]
                              for k, v in by_path.items()},
         # K-SC with sites less without, and the pass alone, on the decks'
         # own states
         "ms_by_path": {
             k: v["step_loop"]["sc_vk_ms"] - v["step_loop"]["sc_novk_ms"]
             for k, v in paths.items() if "sc_vk_ms" in v.get("step_loop", {})
             and not k.startswith(("wall", "nwp-t", "vk-bf16-sharded"))},
         "alone_ms_by_path": {
             k: v["step_loop"]["sites_ms"] for k, v in paths.items()
             if "sites_ms" in v.get("step_loop", {})}},
        {"name": "stream_collide_wall", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide_tiled.cuh",
         "unit": "latticeurbanwind_tpu_torch/csrc/stream_collide_wall.cu",
         "registers": {k: v for k, v in card["registers"].items()
                       if k in tiled_families([k]).get(
                           "wall models and TRT", ())},
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:618",
         "launches": main_wall["stream_collide_wall"],
         "launches_with_vk_sites": main_wall["stream_collide_vk"],
         "max_abs_err": max(errs["stream_collide_wall"].values()),
         **timed(timing["sc_wall"]),
         "launches_by_path": {k: v["stream_collide_wall"]
                              for k, v in by_path.items()},
         "max_abs_err_by_config": errs["stream_collide_wall"],
         "times_by_config": times("K-SC", True),
         "step_loop_by_path": {k: v["step_loop"] for k, v in paths.items()
                               if "step_loop" in v and k.startswith("wall")},
         "near_ground_du_m_per_s": paths["wall-vk-bf16-400"]["near_ground_du"]},
        {"name": "stream_collide_thermal", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide_tiled.cuh",
         "unit": "latticeurbanwind_tpu_torch/csrc/stream_collide_thermal.cu",
         "registers": {k: v for k, v in card["registers"].items()
                       if k in tiled_families([k]).get("thermal", ())},
         "spill_bytes": card["spill_bytes"],
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:732",
         "launches": main_th["stream_collide_thermal"],
         "launches_with_vk_sites": main_th["stream_collide_vk"],
         "max_abs_err": max(errs["stream_collide_thermal"].values()),
         **timed(timing["sc_thermal"]),
         "launches_by_path": {k: v["stream_collide_thermal"]
                              for k, v in by_path.items()},
         "max_abs_err_by_config": errs["stream_collide_thermal"],
         "share_over_tol_and_differing_by_config": errs["thermal_code_shares"],
         "times_by_config": times("K-SC", False, thermal=True),
         "step_loop_by_path": {"nwp-t-bf16-300":
                               paths["nwp-t-bf16-300"]["step_loop"]},
         "update_fields_thermal": timing["thermal_fields"],
         "decks": {k: {kk: vv for kk, vv in paths[k].items() if kk != "step_loop"}
                   for k in ("nwp-t-bf16-300", "nwp-bf16-300")}},
        {"name": "stream_collide_halo", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/stream_collide_tiled.cuh",
         "unit": ["latticeurbanwind_tpu_torch/csrc/stream_collide_halo.cu",
                  "latticeurbanwind_tpu_torch/csrc/stream_collide_halo_thermal.cu"],
         "registers": {k: v for k, v in card["registers"].items()
                       if k.startswith("stream_collide_tiled")
                       and k.endswith(",1>")},
         "replaces": "latticeurbanwind_tpu/ops/stream_collide.py:409",
         "launches": main_halo["stream_collide_halo"],
         "launches_with_vk_sites": main_halo["stream_collide_vk"],
         "max_abs_err": max(errs["stream_collide_halo"].values()),
         **timed(timing["halo"]),
         "bound_includes_halo_bytes": timing["halo"]["halo_bytes"],
         "non_halo_ms_same_shard": timing["halo"]["non_halo_ms"],
         "launches_by_path": {k: v["stream_collide_halo"]
                              for k, v in by_path.items()},
         "max_abs_err_by_config": errs["stream_collide_halo"],
         "share_over_tol_and_differing_by_config": errs["halo_code_shares"],
         "sharded_runner_against_single_device": errs["sharded"],
         "sharded_step": timing["sharded_step"],
         "decks": {k: {kk: vv for kk, vv in v.items() if kk != "flags"}
                   for k, v in paths.items() if k.startswith("vk-bf16-sharded")}},
        {"name": "avg_update", "route": "cuda",
         "source": "latticeurbanwind_tpu_torch/csrc/avg_update.cu",
         "replaces": "latticeurbanwind_tpu/ops/avg_kernel.py:85",
         "launches": main_wall["avg_update"],
         "launches_wall": main_wall["avg_update_wall"],
         # phase 2's cases and the timed shapes' (main grids included)
         "max_abs_err": max([*errs["avg_update"].values()] + [
             v["max_abs_err"] for k, v in timing["configs"].items()
             if k.startswith("K-AVG")]),
         **timed(timing["av_wall"]),
         "registers": {k: v for k, v in card["registers"].items()
                       if k.startswith("avg_update")},
         "nwp_grid": timing["av_nwp"],
         "launches_by_path": {k: v["avg_update"] for k, v in by_path.items()},
         "max_abs_err_by_config": errs["avg_update"],
         "times_by_config": {k: v for k, v in timing["configs"].items()
                             if k.startswith("K-AVG")}},
    ], "build_s": card["build_s"], "nvcc_s": card["nvcc_s"],
        "copy_gbps": timing["copy_gbps"], "resume_phase": deck["resume"],
        "pipeline": pipeline, "examples": examples, "studio": studio,
        "hosts": hosts,
        "physics": physics,
        "renders": {k: {"renders": p["renders"],
                        "solver_seconds": p["solver_seconds"],
                        "solver_seconds_without_renders":
                            p["solver_seconds_without_renders"]}
                    for k, p in paths.items() if "renders" in p}}
    log(card["smi"])
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hosts-child"]:
        # one process of run_deck_processes: <deck> <device> [<checkpoint dir>]
        hosts_child(Path(sys.argv[2]), sys.argv[3],
                    Path(sys.argv[4]) if len(sys.argv) > 4 else None)
        sys.exit(0)
    sys.exit(main())
