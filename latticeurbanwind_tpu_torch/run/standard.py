"""Standard .luw mode: NWP-coupled boundary conditions from SurfData CSV.

Counterpart of `latticeurbanwind_tpu/run/standard.py::run_standard_mode`:
the same host set-up in numpy (the results are identical arrays), then the
state, the forcing and the VK inlet built on the run's device and the
common `run_case`.  Without the TPU-only Y padding (`apply_fast_tier`).  A
deck's `n_gpu` beyond [1, 1, 1] splits the case over a mesh under the device
rule of `run.modes` ("cuda": shard i on card i, or one card when fewer are
visible; "cuda:k": every shard on card k; "cpu").  The set-up's stages are
timed into the result's `timing` (`setup_*_seconds`).

Reproduces the reference standard-mode pipeline (setup.cpp:4931-5641):
  * SurfData_<datetime>.csv -> SI samples; si_ref_u = max |u|; adaptive
    affine temperature map from the CSV min/max;
  * three BC routes, chosen exactly as the reference does:
      patch column present -> patch-driven 2-D structured fields (with
        ground-height terrain clip, per-face velocity/temperature maps,
        side-below-support solids, ground temperature plane on solids);
      high_order=true     -> KNN + quadratic weighted LSQ (HD);
      otherwise            -> brute-force nearest neighbor;
  * boundary shell marking (ground solid, faces TYPE_E, optional open
    downstream face), side-face evaluation capped at the sponge core top;
  * flux correction, then the common run driver.

Coordinates: sample lattice position = SI / cell_m + 0.5 (cell-center frame),
matching the reference's origin-shifted sample transform (setup.cpp:3964-3975,
4941-4947).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..bc.flux import apply_flux_correction
from ..bc.high_order import KNNInterpolatorHD
from ..bc.nearest import nearest_neighbor_eval
from ..bc.patch2d import (
    PatchField2D, boundary_cell_patch, downstream_patch, patch_surface_coords,
)
from ..bc.samples import PATCH_BOTTOM, SampleSet, read_surfdata_csv
from ..bc.vk_inlet import build_vk_runtime, make_vk_pre_step, vk_config_from_deck
from ..deck import load_deck
from ..geometry import read_stl
from ..io.progress import ProgressEmitter
from ..lbm.forcing import build_forcing
from ..lbm.lattice import omega_from_nu, omega_t_from_alpha
from ..lbm.state import (
    DynParams, StepConfig, TYPE_E, TYPE_S, TYPE_T, make_initial_state,
)
from ..post.transform import TransformModel
from .case import (
    DEFAULT_BASE_HEIGHT, LBM_REF_U, SI_ALPHA_AIR, SI_NU_AIR,
    TEMPERATURE_REF_K,
    anchor_units, apply_wall_model, coriolis_lbmu, nudge_spec_from_deck,
    run_settings_from_deck, storage_from_deck,
    si_size_from_deck, sponge_spec_from_deck,
)
from .driver import RunResult, SolverCase, run_case
from .modes import _find_case_stl, _specialize_force, _voxelize_case, run_device
from .probe_parse import resolve_probes
from .sizing import plan_grid, setup_device


def _boundary_queries(shape, side_ref_z_cap: int):
    """Lattice positions (cell-center frame) of all outer-shell cells above
    the ground plate, with side faces z-capped; returns (idx_z, idx_y, idx_x,
    positions (Q,3))."""
    Z, Y, X = shape
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
    on_shell = ((xx == 0) | (xx == X - 1) | (yy == 0) | (yy == Y - 1) | (zz == Z - 1))
    on_shell &= zz > 0
    iz, iy, ix = np.nonzero(on_shell)
    pz = iz.astype(np.float64) + 0.5
    if side_ref_z_cap >= 0:
        is_side = (ix == 0) | (ix == X - 1) | (iy == 0) | (iy == Y - 1)
        cap = (iz != Z - 1) & is_side & (iz > side_ref_z_cap)
        pz = np.where(cap, side_ref_z_cap + 0.5, pz)
    pos = np.stack([ix + 0.5, iy + 0.5, pz], axis=1)
    return iz, iy, ix, pos


def run_standard_mode(deck_path: Path | str, *,
                      device: torch.device | str = "cuda",
                      quiet: bool = False, max_cases: int = 0) -> List[RunResult]:
    """Execute the .luw standard case on `device` (one case: `max_cases` is
    taken for the other modes' signature; an `n_gpu` deck under the device
    rule of the module docstring)."""
    dev = run_device(device)
    t_start = time.perf_counter()
    deck_path = Path(deck_path)
    deck = load_deck(deck_path)
    parent = deck_path.parent
    progress = ProgressEmitter("interface_interpolation")

    casename = deck.get_text("casename", "case")
    datetime_tag = deck.get_text("datetime", "00000000000000")
    si_size = si_size_from_deck(deck)
    z_offset = deck.get_float("base_height", DEFAULT_BASE_HEIGHT)
    downstream_bc = deck.get_text("downstream_bc", "+y")
    downstream_open = deck.get_bool("downstream_open_face", False)
    high_order = deck.get_bool("high_order", False)
    flux_on = deck.get_bool("flux_correction", False)
    buoyancy = deck.get_bool("buoyancy", True)

    csv_path = parent / "proj_temp" / f"SurfData_{datetime_tag}.csv"
    samples = read_surfdata_csv(csv_path)
    si_ref_u = samples.max_speed
    if si_ref_u <= 0:
        raise ValueError(f"no usable inlet samples in {csv_path}")

    # adaptive affine temperature map (reference: setup.cpp:3628-3648)
    use_temperature = buoyancy and samples.has_temperature
    temp_ref = temp_scale = TEMPERATURE_REF_K
    if use_temperature:
        tmin, tmax = samples.temperature_range()
        if np.isfinite(tmin) and np.isfinite(tmax) and tmax > 0:
            temp_ref = 0.5 * (tmin + tmax)
            half = 0.5 * (tmax - tmin)
            temp_scale = half if half > 1e-6 else 1.0

    sponge_on = deck.get_bool("enable_top_sponge", True) and (
        deck.get_float("sponge_tau_s", 120.0) or 0) > 0
    mesh_control = (deck.get_text("mesh_control", "gpu_memory") or "gpu_memory").lower()
    cell_size = deck.get_float("cell_size")
    ngpu = deck.get_int_list("n_gpu") or [1, 1, 1]
    storage = storage_from_deck(deck)
    plan = plan_grid(
        si_size,
        cell_m=cell_size if mesh_control == "cell_size" and cell_size else None,
        memory_mb=deck.get_int("gpu_memory", 20000),
        n_devices=int(np.prod(ngpu)), storage=storage, thermal=use_temperature,
        sponge_thickness_m=deck.get_float("sponge_thickness_m", 200.0) or 0.0,
        sponge_enabled=sponge_on,
    )
    units = anchor_units(plan.cell_m, si_ref_u, temp_scale_k=temp_scale,
                         temp_ref_k=temp_ref)
    u_scale = LBM_REF_U / si_ref_u
    shape = (plan.nz, plan.ny, plan.nx)

    # samples to lattice cell-center frame
    P = samples.p / plan.cell_m + 0.5
    U = samples.u * u_scale
    T_lbm = np.vectorize(units.T)(samples.T) if use_temperature else None
    t_clamp = None
    if use_temperature:
        lo, hi = sorted((units.T(samples.temperature_range()[0]),
                         units.T(samples.temperature_range()[1])))
        t_clamp = (lo, hi)

    t_vox = time.perf_counter()
    mesh = read_stl(_find_case_stl(parent, casename, "luw"))
    solid = _voxelize_case(mesh, plan, progress)
    t_bc = time.perf_counter()

    flags = np.where(solid, np.uint8(TYPE_S), np.uint8(0))
    flags[0] = TYPE_S
    u = np.zeros((3, *shape), np.float32)
    T_field = np.ones(shape, np.float32)

    z_threshold = z_offset / plan.cell_m + 0.5   # zero velocity below base height

    iz, iy, ix, qpos = _boundary_queries(shape, plan.side_ref_z_cap)
    solid_mask = (flags & TYPE_S) != 0
    q_free = ~solid_mask[iz, iy, ix]

    ds_patch = downstream_patch(downstream_bc)
    qpatch = boundary_cell_patch(ix, iy, iz, plan.nx, plan.ny, plan.nz)
    is_downstream = qpatch == ds_patch

    sample_set = SampleSet(p=P, u=U, T=T_lbm, patch=samples.patch)

    if samples.has_patch:
        _apply_patch_bc(flags, u, T_field, sample_set, shape, plan, z_threshold,
                        use_temperature, t_clamp, downstream_open, ds_patch, quiet)
        bc_eval = _patch_downstream_eval(sample_set, ds_patch, shape)
    else:
        keep = q_free & ~(downstream_open & is_downstream)
        qz = qpos[:, 2]
        below = qz < z_threshold
        if high_order:
            interp = KNNInterpolatorHD(P, U)
            vals = interp.eval(qpos[keep])
        else:
            vals = nearest_neighbor_eval(P, U, qpos[keep], device=dev)
        vals = np.where(below[keep][:, None], 0.0, vals)
        flags[iz[q_free], iy[q_free], ix[q_free]] |= TYPE_E
        for c in range(3):
            u[c, iz[keep], iy[keep], ix[keep]] = vals[:, c].astype(np.float32)
        if use_temperature:
            if high_order:
                t_interp = KNNInterpolatorHD(P, T_lbm[:, None])
                tvals = t_interp.eval(qpos[q_free])[:, 0]
            else:
                tvals = nearest_neighbor_eval(P, T_lbm[:, None], qpos[q_free],
                                              device=dev)[:, 0]
            tvals = np.where(qpos[q_free, 2] < z_threshold, 1.0, tvals)
            tvals = np.clip(tvals, *t_clamp)
            T_field[iz[q_free], iy[q_free], ix[q_free]] = tvals
            flags[iz[q_free], iy[q_free], ix[q_free]] |= TYPE_T

        def bc_eval(mask):
            sel = np.nonzero(mask)
            pos = np.stack([sel[2] + 0.5, sel[1] + 0.5, sel[0] + 0.5], axis=1)
            vals = (KNNInterpolatorHD(P, U).eval(pos) if high_order
                    else nearest_neighbor_eval(P, U, pos, device=dev))
            out = np.zeros((3, *shape), np.float32)
            for c in range(3):
                out[c][sel] = vals[:, c]
            return out

    t_flux = time.perf_counter()
    if flux_on:
        flags, u, report = apply_flux_correction(
            flags, u, downstream_bc=downstream_bc,
            downstream_eval=bc_eval if downstream_open else None)
        if not quiet:
            print(f"| Flux correction | net {report['net_before']:+.4f} -> "
                  f"{report['net_after']:+.4f}, avg dU {report['avg_dU']:.5f}")

    config = StepConfig(
        omega=omega_from_nu(units.nu(SI_NU_AIR)),
        collision="srt", subgrid=True,
        thermal=use_temperature,
        omega_t=omega_t_from_alpha(units.alpha(SI_ALPHA_AIR)) if use_temperature else 1.0,
        beta=units.beta(1.0 / temp_ref) if use_temperature else 0.0,
        t_avg=1.0,
        storage=storage,
    )
    nudge = nudge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                 grid=shape, downstream_bc=downstream_bc)
    sponge = sponge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                   nz=plan.nz, extended=plan.sponge_extended)
    t_state = time.perf_counter()
    state_dev = setup_device(ngpu, dev)
    forcing = build_forcing(shape, nudge=nudge, sponge=sponge, device=state_dev)
    omega_cor = coriolis_lbmu(deck, plan.cell_m, si_ref_u)
    config = apply_wall_model(
        _specialize_force(config, forcing, omega_cor), deck, plan.cell_m)
    pre_step = None
    vk_cfg = vk_config_from_deck(deck, units=units, downstream_bc=downstream_bc)
    vk_rt = build_vk_runtime(vk_cfg, flags, u)
    if vk_rt is not None:
        pre_step = make_vk_pre_step(vk_cfg, vk_rt, device=dev)
        if not quiet:
            print(f"| VK inlet        | active: {len(vk_rt.sigma)} points, "
                  f"{vk_cfg.nmodes} modes")

    # probe columns (deck `probes` syntax; needs the geographic mapping)
    probes = []
    probes_raw = deck.get_raw("probes")
    if probes_raw and probes_raw.strip():
        try:
            model = TransformModel.from_deck(
                deck, (plan.nx * plan.cell_m, plan.ny * plan.cell_m))
            lon_pair = deck.get_pair("cut_lon_manual")
            lat_pair = deck.get_pair("cut_lat_manual")
            center = (0.5 * sum(lon_pair), 0.5 * sum(lat_pair))
            probes = resolve_probes(
                probes_raw, model=model, center_lonlat=center, flags=flags,
                cell_m=plan.cell_m,
                si_size_xy=(plan.nx * plan.cell_m, plan.ny * plan.cell_m))
            if probes and not quiet:
                print(f"| Probes          | {len(probes)} column(s) resolved")
        except ValueError as e:
            print(f"| Probes          | disabled: {e}")

    # the standard mode sets no gravity vector, so the Boussinesq term of a
    # thermal run multiplies zero (as in the JAX package, whose line this is)
    dyn = DynParams(force=torch.zeros(3),
                    omega_coriolis=torch.as_tensor(omega_cor, dtype=torch.float32))
    case = SolverCase(
        config=config, forcing=forcing,
        state=make_initial_state(shape, config=config, u=u, flags=flags,
                                 T=T_field if use_temperature else None,
                                 device=state_dev),
        dyn=dyn, units=units,
        cell_m=plan.cell_m, parent=parent, datetime=datetime_tag,
        vtk_prefix="", nz_out=plan.nz_core if plan.sponge_extended else 0,
        settings=run_settings_from_deck(deck),
        thermal_output=use_temperature, pre_step=pre_step, probes=probes,
        ngpu=tuple(int(v) for v in (list(ngpu) + [1, 1, 1])[:3]), device=dev,
    )
    if not quiet:
        bc_kind = "patch-2d" if samples.has_patch else ("high-order" if high_order else "nearest")
        print(f"| Standard case   | {casename} bc={bc_kind} grid={plan.nx}x{plan.ny}x{plan.nz} "
              f"cell={plan.cell_m:.2f} m si_ref_u={si_ref_u:.2f} "
              f"T={'on' if use_temperature else 'off'} device={dev}")
    t_run = time.perf_counter()
    setup = {"setup_read_seconds": t_vox - t_start,
             "voxelize_seconds": t_bc - t_vox,
             "setup_bc_seconds": t_flux - t_bc,
             "setup_flux_seconds": t_state - t_flux,
             "setup_state_seconds": t_run - t_state}
    if not quiet:
        print("| Set-up          | " + ", ".join(
            f"{k.replace('_seconds', '').replace('setup_', '')} {v:.2f} s"
            for k, v in setup.items()))
    result = run_case(case, quiet=quiet)
    result.timing.update(setup)
    return [result]


def _apply_patch_bc(flags, u, T_field, samples: SampleSet, shape, plan,
                    z_threshold, use_temperature, t_clamp, downstream_open,
                    ds_patch, quiet):
    """Patch-driven 2-D mapping (reference: setup.cpp:5121-5353)."""
    Z, Y, X = shape
    # ground height field from patch-0 (values: lattice z of the terrain)
    ground_field = PatchField2D.from_samples(
        samples, PATCH_BOTTOM, lambda s, m: s.p[m][:, 2], default=z_threshold)
    if ground_field.has_samples:
        zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                                 indexing="ij")
        gz = ground_field.eval((xx + 0.5).ravel(), (yy + 0.5).ravel())[:, 0].reshape(shape)
        below = ((zz + 0.5) < gz) & ((flags & TYPE_S) == 0)
        flags[below] = TYPE_S
        for c in range(3):
            u[c][below] = 0.0

    vel_fields = {p: PatchField2D.from_samples(samples, p, lambda s, m: s.u[m])
                  for p in range(1, 6)}
    t_fields = None
    if use_temperature:
        t_fields = {p: PatchField2D.from_samples(
            samples, p, lambda s, m: s.T[m][:, None], default=1.0)
            for p in range(1, 6)}

    iz, iy, ix, qpos = _boundary_queries(shape, plan.side_ref_z_cap)
    qpatch = boundary_cell_patch(ix, iy, iz, X, Y, Z)
    solid_self = (flags[iz, iy, ix] & TYPE_S) != 0

    # side cells whose first interior neighbor column is solid -> grounded solid
    nbr_x = ix.copy()
    nbr_y = iy.copy()
    nbr_x[qpatch == 4] = min(1, X - 1)            # west face looks at x=1
    nbr_x[qpatch == 5] = max(X - 2, 0)            # east face looks at x=Nx-2
    nbr_y[qpatch == 2] = min(1, Y - 1)            # south face looks at y=1
    nbr_y[qpatch == 3] = max(Y - 2, 0)            # north face looks at y=Ny-2
    is_side_patch = np.isin(qpatch, (2, 3, 4, 5))
    side_nbr_solid = is_side_patch & ((flags[iz, nbr_y, nbr_x] & TYPE_S) != 0)

    grounded = solid_self | side_nbr_solid
    flags[iz[grounded], iy[grounded], ix[grounded]] = TYPE_S
    for c in range(3):
        u[c][iz[grounded], iy[grounded], ix[grounded]] = 0.0

    active = ~grounded
    for patch in range(1, 6):
        m = active & (qpatch == patch)
        if not m.any():
            continue
        field = vel_fields[patch]
        if not field.has_samples:
            continue
        a, b = patch_surface_coords(patch, qpos[m])
        if patch in (2, 3, 4, 5):
            below_support = field.below_sample_support(a, b)
            sel = np.nonzero(m)[0][below_support]
            flags[iz[sel], iy[sel], ix[sel]] = TYPE_S
            for c in range(3):
                u[c][iz[sel], iy[sel], ix[sel]] = 0.0
            m2 = np.nonzero(m)[0][~below_support]
        else:
            m2 = np.nonzero(m)[0]
        flags[iz[m2], iy[m2], ix[m2]] |= TYPE_E
        if downstream_open and patch == ds_patch:
            continue
        a2, b2 = patch_surface_coords(patch, qpos[m2])
        vals = field.eval(a2, b2)
        for c in range(3):
            u[c][iz[m2], iy[m2], ix[m2]] = vals[:, c].astype(np.float32)

    if use_temperature:
        free = (flags[iz, iy, ix] & TYPE_S) == 0
        for patch in range(1, 6):
            m = free & (qpatch == patch)
            if downstream_open and patch == ds_patch:
                continue
            field = t_fields[patch]
            if not m.any() or not field.has_samples:
                continue
            a, b = patch_surface_coords(patch, qpos[m])
            tvals = np.clip(field.eval(a, b)[:, 0], *t_clamp)
            T_field[iz[m], iy[m], ix[m]] = tvals
            flags[iz[m], iy[m], ix[m]] |= TYPE_T
        # ground temperature plane onto ALL solid cells per (x,y) column
        gt = PatchField2D.from_samples(samples, PATCH_BOTTOM,
                                       lambda s, m: s.T[m][:, None], default=1.0)
        if gt.has_samples:
            yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
            txy = np.clip(gt.eval((xx + 0.5).ravel(), (yy + 0.5).ravel())[:, 0],
                          *t_clamp).reshape(Y, X)
            solid_cells = (flags & TYPE_S) != 0
            T_field[:] = np.where(solid_cells, txy[None], T_field)
            flags[:] = np.where(solid_cells, flags | TYPE_T, flags)


def _patch_downstream_eval(samples: SampleSet, ds_patch: int, shape):
    field = (PatchField2D.from_samples(samples, ds_patch, lambda s, m: s.u[m])
             if 1 <= ds_patch <= 5 else None)

    def ev(mask):
        out = np.zeros((3, *shape), np.float32)
        if field is None or not field.has_samples:
            return out
        sel = np.nonzero(mask)
        pos = np.stack([sel[2] + 0.5, sel[1] + 0.5, sel[0] + 0.5], axis=1)
        a, b = patch_surface_coords(ds_patch, pos)
        vals = field.eval(a, b)
        for c in range(3):
            out[c][sel] = vals[:, c]
        return out

    return ev
