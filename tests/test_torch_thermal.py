"""PyTorch port: the thermal D3Q7 sub-lattice (kernel item K7) against the
JAX package.

The case is tests/test_pallas_kernel.py::_mk_case(thermal=True): the LUW
shell (outer faces TYPE_E, solid ground), solid blocks, TYPE_T on the west
face and the top plane, buffer nudging and the top sponge, Coriolis and a
NON-ZERO global force, so the Boussinesq term F -= force * beta * (T -
t_avg) is present (a standard-mode run builds `force = 0` and would leave it
inert).  With the JAX test's values (|force| ~ 2e-5, beta = 0.002) the term
moves the DDFs by ~1e-9, far below every tolerance here, so those cases
cannot see it: the `buoyant` variant of the case (|force| ~ 1e-2, beta =
0.5, t_avg = 0, T off 1 by ~0.05) moves them by 10x the tolerance and more,
and the step is held against both JAX tiers on it in all four storages.
Inputs come from one numpy seed and cross to the port bit for bit through
`convert`.  Tolerances are the JAX kernel's own against its
reference: 6e-6 for f32, 2e-4 for bf16, 2e-5 for decoded fp16c after 5
steps, 4x that on the fields.

Where the two JAX tiers differ the port takes the Pallas kernel's side: the
sponge relaxes T toward the FaceBC target `tt` (the initial top plane), not
toward the current `T[-1]` of `lbm/reference.py:305`, and TYPE_T cells keep
their stored g, where the reference re-evaluates g_eq.  In this case the top
plane and the TYPE_T cells are TYPE_E too, so their T and g never change and
both tiers agree within the tolerances; the direct comparison is the one
with `make_pallas_step` in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _mk_case(shape, storage, thermal=True, buoyant=False):
    """`buoyant`: a force, an expansion coefficient and a temperature spread
    large enough that the Boussinesq term moves the DDFs far above the
    comparison tolerances within 5 steps."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S, TYPE_T,
        build_forcing, make_initial_state, omega_from_nu,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(0)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, thermal=thermal,
                     omega_t=1.1, beta=0.002, storage=storage)
    if buoyant:
        cfg = dataclasses.replace(cfg, beta=0.5, t_avg=0.0)
    u = 0.02 * rng.standard_normal((3, Z, Y, X)).astype(np.float32)
    rho = (1.0 + 0.001 * rng.standard_normal(shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[2, 10:20, 40:44] = TYPE_S
    flags[1:3, 5:9, 20:30] = TYPE_S
    flags[:, :, 0] |= TYPE_T
    flags[-1] |= TYPE_T
    T = (1.0 + (0.05 if buoyant else 0.01)
         * rng.standard_normal(shape)).astype(np.float32)
    state = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags,
                               T=T)
    forcing = build_forcing(shape,
                            nudge=NudgeSpec(n_cells=3, inv_tau=0.02, downstream_face=2),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
    force = [5e-3, 0.0, -1e-2] if buoyant else [1e-5, 0.0, -2e-5]
    dyn = DynParams(force=jnp.array(force),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))
    return cfg, state, forcing, dyn, (rho, u, flags, T)


def _port_config(cfg):
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig

    return StepConfig(**dataclasses.asdict(cfg))


def _decoded(a, storage):
    from latticeurbanwind_tpu.lbm.state import decode_ddf

    return np.asarray(decode_ddf(a, storage)).astype(np.float32)


def _port_decoded(t, storage):
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf

    return decode_ddf(t, storage).float().numpy()


def _port_steps(cfg, state, forcing, dyn, n=5):
    """n plain thermal steps of the port; returns the port's LBMState."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide_plain,
    )

    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    fbc = build_face_bc(ts.u, ts.T)
    tcfg = _port_config(cfg)
    fi, gi = ts.fi, ts.gi
    for _ in range(n):
        g_new = torch.empty_like(gi)
        fi = stream_collide_plain(fi, ts.flags, row, tcfg, tf, fbc, gi=gi,
                                  gi_out=g_new)
        gi = g_new
    return ts._replace(fi=fi, gi=gi)


def _jax_reference_steps(cfg, state, forcing, dyn, n=5):
    import jax

    from latticeurbanwind_tpu.lbm.reference import make_step

    step = jax.jit(make_step(cfg, forcing))
    for _ in range(n):
        state = step(state, dyn)
    return state


def _jax_pallas_steps(cfg, state, forcing, dyn, n=5):
    import jax

    from latticeurbanwind_tpu.ops.stream_collide import (
        make_pallas_step, merge_state, split_state,
    )

    pstep = make_pallas_step(cfg, forcing, state.rho.shape)

    def pal_run(st, d):
        s = split_state(st, with_fbc=True)
        for _ in range(n):
            s = pstep(s, d)
        return merge_state(s)

    return jax.jit(pal_run)(state, dyn)


def _compare(port_state, jax_state, cfg, dyn, atol, gi_skips_type_e=False):
    """fi, gi at `atol`; rho, u, T after both packages' update_fields at
    4 * atol (the JAX test's own factor).  `gi_skips_type_e` leaves the g of
    TYPE_E cells out (see the bf16 case against the reference tier)."""
    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields

    storage = cfg.storage
    got = convert.state_to_numpy(port_state)
    np.testing.assert_allclose(_decoded(got.fi, storage),
                               _decoded(jax_state.fi, storage), atol=atol)
    keep = 1.0
    if gi_skips_type_e:
        keep = ((got.flags & 0x02) == 0).astype(np.float32)
    np.testing.assert_allclose(_decoded(got.gi, storage) * keep,
                               _decoded(jax_state.gi, storage) * keep,
                               atol=atol)
    want = jax_update(jax_state, cfg, dyn)
    fields = convert.state_to_numpy(update_fields(
        port_state, _port_config(cfg), convert.dyn_from_jax(dyn)))
    np.testing.assert_allclose(fields.rho, np.asarray(want.rho), atol=4 * atol)
    np.testing.assert_allclose(fields.u, np.asarray(want.u), atol=4 * atol)
    np.testing.assert_allclose(fields.T, np.asarray(want.T), atol=4 * atol)
    assert float(np.abs(fields.T - 1.0).max()) > 1e-3   # T is not trivial


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_thermal_initial_state_and_convert_bit_equal_to_jax(storage):
    """`make_initial_state(thermal)` builds the JAX package's fi, gi, T bit
    for bit, and `convert` carries a thermal state and FaceBC.tt across
    unchanged."""
    from latticeurbanwind_tpu.ops.stream_collide import build_face_bc as jax_fbc
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import make_initial_state
    from latticeurbanwind_tpu_torch.ops.stream_collide import build_face_bc

    shape = (7, 21, 45)
    cfg, state, _, _, (rho, u, flags, T) = _mk_case(shape, storage)
    mine = convert.state_to_numpy(make_initial_state(
        shape, config=_port_config(cfg), rho=rho, u=u, flags=flags, T=T))
    carried = convert.state_to_numpy(convert.state_from_jax(state))
    for got in (mine, carried):
        for name in ("fi", "gi"):
            a, b = getattr(got, name), np.asarray(getattr(state, name))
            assert a.dtype.itemsize == b.dtype.itemsize
            np.testing.assert_array_equal(
                a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))
        np.testing.assert_array_equal(got.T, np.asarray(state.T))
        np.testing.assert_array_equal(got.flags, np.asarray(state.flags))
    want = jax_fbc(state.u, state.T)
    fbc = convert.face_bc_from_jax(want)
    mine_fbc = build_face_bc(convert.to_torch(state.u), convert.to_torch(state.T))
    for got in (fbc, mine_fbc):
        assert tuple(got.tt.shape) == shape[1:]
        np.testing.assert_array_equal(got.tt.numpy(), np.asarray(want.tt))
        np.testing.assert_array_equal(got.uw.numpy(), np.asarray(want.uw))
    # no T given: ones, g at rest
    blank = make_initial_state((3, 4, 5), config=_port_config(cfg))
    assert bool((blank.T == 1).all()) and blank.gi.shape == (7, 3, 4, 5)


@pytest.mark.parametrize("shape,storage,atol", [
    ((8, 32, 128), "f32", 6e-6),
    ((7, 21, 45), "f32", 6e-6),
    ((8, 32, 128), "bf16", 2e-4),
    ((7, 21, 45), "bf16", 2e-4),
    ((7, 21, 45), "fp16c", 2e-5),
])
def test_thermal_plain_step_matches_jax_reference(shape, storage, atol):
    """Against JAX `make_step`.  In bf16 the g of TYPE_E cells is left out
    here and held against the Pallas tier below: the kernels collide it with
    the velocity recovered from the cell's stored (bf16-rounded) f, the
    reference tier with the exact `state.u`, and a few of those cells land
    one bf16 step (2.44e-4) apart -- the JAX package's own two tiers differ
    by the same step in the same cells (its tests run no bf16 thermal
    case)."""
    cfg, state, forcing, dyn, _ = _mk_case(shape, storage)
    got = _port_steps(cfg, state, forcing, dyn)
    want = _jax_reference_steps(cfg, state, forcing, dyn)
    _compare(got, want, cfg, dyn, atol, gi_skips_type_e=(storage == "bf16"))


@pytest.mark.parametrize("shape,storage,atol", [
    ((8, 32, 128), "f32", 6e-6),
    ((7, 21, 45), "f32", 6e-6),
    ((8, 32, 128), "bf16", 2e-4),
    ((7, 21, 45), "bf16", 2e-4),
])
def test_thermal_plain_step_matches_jax_pallas_kernel(shape, storage, atol):
    """Against the Pallas kernel in interpret mode: the tier whose sponge
    target (FaceBC.tt) and TYPE_T handling the port follows."""
    cfg, state, forcing, dyn, _ = _mk_case(shape, storage)
    got = _port_steps(cfg, state, forcing, dyn)
    want = _jax_pallas_steps(cfg, state, forcing, dyn)
    _compare(got, want, cfg, dyn, atol)


def test_thermal_sponge_target_is_the_face_bc_not_the_current_top():
    """The tiers' divergence made visible: with a top plane that is neither
    TYPE_E nor TYPE_T its T drifts, the reference tier's sponge follows it
    and the Pallas tier's does not.  The port agrees with the Pallas tier
    at the f32 tolerance and differs from the reference tier by more."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import TYPE_E, TYPE_T

    shape = (7, 21, 45)
    cfg, state, forcing, dyn, _ = _mk_case(shape, "f32")
    flags = np.asarray(state.flags).copy()
    flags[-1, 1:-1, 1:-1] &= ~np.uint8(TYPE_E | TYPE_T)
    state = state._replace(flags=jnp.asarray(flags))
    got = _port_steps(cfg, state, forcing, dyn, n=8)
    pal = _jax_pallas_steps(cfg, state, forcing, dyn, n=8)
    ref = _jax_reference_steps(cfg, state, forcing, dyn, n=8)
    g = got.gi.numpy()
    np.testing.assert_allclose(g, np.asarray(pal.gi), atol=6e-6)
    assert float(np.abs(g - np.asarray(ref.gi)).max()) > 6e-6


BUOYANT_TOL = {"f32": 6e-6, "bf16": 2e-4, "f16": 2e-5, "fp16c": 2e-5}


def test_thermal_buoyancy_moves_the_flow():
    """The Boussinesq term decides the result of the buoyant case: the same
    steps with beta = 0, with the term's sign flipped (beta -> -beta) or with
    a uniform T in its place give DDFs that differ by at least 10x the
    tolerance the comparisons below hold, in every storage.  The JAX test's
    own values move them by ~1e-9 only."""
    shape = (7, 21, 45)
    for storage, tol in BUOYANT_TOL.items():
        cfg, state, forcing, dyn, _ = _mk_case(shape, storage, buoyant=True)
        a = _port_decoded(_port_steps(cfg, state, forcing, dyn).fi, storage)
        for other in (dataclasses.replace(cfg, beta=0.0),
                      dataclasses.replace(cfg, beta=-cfg.beta)):
            b = _port_decoded(_port_steps(other, state, forcing, dyn).fi,
                              storage)
            assert float(np.abs(a - b).max()) > 10 * tol, (storage, other.beta)
    # f32: the term reads the cell's T, not a constant
    cfg, state, forcing, dyn, (rho, u, flags, T) = _mk_case(shape, "f32",
                                                            buoyant=True)
    from latticeurbanwind_tpu.lbm import make_initial_state

    flat = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags,
                              T=np.ones_like(T))
    a = _port_steps(cfg, state, forcing, dyn).fi.numpy()
    b = _port_steps(cfg, flat, forcing, dyn).fi.numpy()
    assert float(np.abs(a - b).max()) > 10 * BUOYANT_TOL["f32"]
    cfg, state, forcing, dyn, _ = _mk_case(shape, "f32")
    a = _port_steps(cfg, state, forcing, dyn).fi.numpy()
    b = _port_steps(dataclasses.replace(cfg, beta=0.0), state, forcing,
                    dyn).fi.numpy()
    assert 0 < float(np.abs(a - b).max()) < 6e-6


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_thermal_buoyant_step_matches_jax_pallas_kernel(storage):
    """The buoyant case (the Boussinesq term 10x above the tolerance and
    more) against the Pallas kernel in interpret mode, fi, gi and the
    fields."""
    cfg, state, forcing, dyn, _ = _mk_case((7, 21, 45), storage, buoyant=True)
    got = _port_steps(cfg, state, forcing, dyn)
    want = _jax_pallas_steps(cfg, state, forcing, dyn)
    _compare(got, want, cfg, dyn, BUOYANT_TOL[storage])


@pytest.mark.parametrize("storage", ["f32", "fp16c"])
def test_thermal_buoyant_step_matches_jax_reference(storage):
    """The buoyant case against JAX `make_step`, away from the TYPE_E shell.
    The two JAX tiers differ AT the shell once the force is large: the
    reference tier rewrites a TYPE_E cell's f as f_eq(rho, u + F / 2 rho)
    (`lbm/reference.py:349`, force included), the Pallas kernel and the port
    keep the stored equilibria.  With the JAX test's |F| ~ 1e-5 that is
    below the tolerance; here it is not, and it travels inward one cell per
    step.  So: 2 steps, and the cells more than 2 away from every TYPE_E
    cell, where the buoyancy still moves f by 10x the tolerance."""
    n, tol = 2, BUOYANT_TOL[storage]
    inner = (slice(None), slice(1, 4), slice(3, -3), slice(3, -3))
    cfg, state, forcing, dyn, _ = _mk_case((7, 21, 45), storage, buoyant=True)
    got = _port_steps(cfg, state, forcing, dyn, n=n)
    want = _jax_reference_steps(cfg, state, forcing, dyn, n=n)
    off = _port_steps(dataclasses.replace(cfg, beta=0.0), state, forcing, dyn,
                      n=n)
    f_got = _port_decoded(got.fi, storage)
    f_want = _decoded(want.fi, storage)
    np.testing.assert_allclose(f_got[inner], f_want[inner], atol=tol)
    np.testing.assert_allclose(_port_decoded(got.gi, storage)[inner],
                               _decoded(want.gi, storage)[inner], atol=tol)
    assert float(np.abs(f_got - _port_decoded(off.fi, storage))[inner].max()) > 10 * tol
    assert float(np.abs(f_got - f_want).max()) > 10 * tol    # the shell


@pytest.mark.parametrize("storage,wall", [("f32", False), ("bf16", False),
                                          ("f32", True)])
def test_thermal_update_fields_and_welford_match_jax(storage, wall):
    """Thermal `update_fields` + `welford_update` (mean_T too) over three
    samples against the JAX package's, at 1e-5."""
    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu.run.welford import (
        init_avg as jax_init, welford_update as jax_welford,
    )
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    shape = (7, 21, 45)
    cfg, state, forcing, dyn, _ = _mk_case(shape, storage)
    if wall:
        cfg = dataclasses.replace(cfg, wall_model=True, wall_cd=0.0134)
    tcfg = _port_config(cfg)
    tdyn = convert.dyn_from_jax(dyn)
    javg = jax_init(shape, True)
    tavg = init_avg(shape, True)
    for n in (2, 1, 2):
        state = _jax_reference_steps(cfg, state, forcing, dyn, n=n)
        jst = jax_update(state, cfg, dyn)
        tst = update_fields(convert.state_from_jax(state), tcfg, tdyn)
        np.testing.assert_allclose(tst.T.numpy(), np.asarray(jst.T), atol=1e-5)
        np.testing.assert_allclose(tst.u.numpy(), np.asarray(jst.u), atol=1e-5)
        javg = jax_welford(javg, jst)
        tavg = welford_update(tavg, tst)
    assert tavg.count == 3
    got = convert.avg_to_numpy(tavg)
    np.testing.assert_allclose(got.mean_T, np.asarray(javg.mean_T), atol=1e-5)
    np.testing.assert_allclose(got.mean_u, np.asarray(javg.mean_u), atol=1e-5)
    np.testing.assert_allclose(got.mean_rho, np.asarray(javg.mean_rho), atol=1e-5)
    np.testing.assert_allclose(got.m2_u, np.asarray(javg.m2_u), atol=1e-5)
    carried = convert.avg_to_numpy(convert.avg_from_jax(javg))
    np.testing.assert_array_equal(carried.mean_T, np.asarray(javg.mean_T))


def test_thermal_runner_swaps_two_gi_buffers():
    """make_runner on the CPU gives the plain loop's fi and gi bit for bit
    and reuses two buffers for each."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner

    shape = (7, 21, 45)
    cfg, state, forcing, dyn, _ = _mk_case(shape, "bf16")
    want = _port_steps(cfg, state, forcing, dyn, n=5)
    ts = convert.state_from_jax(state)
    run, impl = make_runner(_port_config(cfg), convert.forcing_from_jax(forcing),
                            shape=shape, device="cpu")
    assert impl == "plain"
    td = convert.dyn_from_jax(dyn)
    fbufs, gbufs = {ts.fi.data_ptr()}, {ts.gi.data_ptr()}
    out = ts
    for t0, n in ((0, 1), (1, 1), (2, 3)):
        out = run(out, td, t0, n)
        fbufs.add(out.fi.data_ptr())
        gbufs.add(out.gi.data_ptr())
    assert len(fbufs) == 2 and len(gbufs) == 2
    assert run.get_fbc().tt is not None
    for name in ("fi", "gi"):
        np.testing.assert_array_equal(
            getattr(out, name).view(torch.int16).numpy(),
            getattr(want, name).view(torch.int16).numpy())


def test_thermal_wrapper_checks_its_arguments():
    """A thermal step without gi, with gi_out aliasing gi, or with the sponge
    and no FaceBC.tt raises; volume_force=False refuses thermal as the JAX
    tiers do."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide,
    )

    shape = (7, 21, 45)
    cfg, state, forcing, dyn, _ = _mk_case(shape, "f32")
    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    tcfg = _port_config(cfg)
    fbc = build_face_bc(ts.u, ts.T)
    with pytest.raises(ValueError, match="gi"):
        stream_collide(ts.fi, ts.flags, row, tcfg, tf, fbc)
    with pytest.raises(ValueError, match="gi_out"):
        stream_collide(ts.fi, ts.flags, row, tcfg, tf, fbc, gi=ts.gi)
    gout = torch.empty_like(ts.gi)
    with pytest.raises(ValueError, match="alias"):
        stream_collide(ts.fi, ts.flags, row, tcfg, tf, fbc, gi=ts.gi,
                       gi_out=ts.gi)
    with pytest.raises(ValueError, match="tt"):
        stream_collide(ts.fi, ts.flags, row, tcfg, tf, build_face_bc(ts.u),
                       gi=ts.gi, gi_out=gout)
    with pytest.raises(ValueError, match="volume_force"):
        stream_collide(ts.fi, ts.flags, row,
                       dataclasses.replace(tcfg, volume_force=False), tf, fbc,
                       gi=ts.gi, gi_out=gout)
    gout.fill_(float("nan"))
    out = stream_collide(ts.fi, ts.flags, row, tcfg, tf, fbc, gi=ts.gi,
                         gi_out=gout)
    assert out.shape == ts.fi.shape and bool(torch.isfinite(gout).all())
