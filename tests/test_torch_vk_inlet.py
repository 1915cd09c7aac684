"""PyTorch port: the von Kármán synthetic-turbulence inlet against the JAX
package's `bc/vk_inlet.py`, and the stream-collide step's inlet sites
against the Pallas kernel's.

Inputs come from numpy seeds and cross to the port bit for bit through
`convert`; the JAX side runs its Pallas kernel in interpret mode, as its own
tests run it on the CPU.  Tolerances:

  * runtimes and deck configs: bit-equal (the port copies the numpy code);
  * FaceBC refresh: 1e-6 -- both evaluate the same float32 formula, the
    cos/sin implementations of XLA and torch differ by an ulp or so at
    arguments of a few hundred radians, scaled by sigma ~ 1e-3;
  * the step with sites: 6e-6 (f32) and 2e-4 (bf16), the JAX kernel's own
    tolerances against its reference (tests/test_pallas_kernel.py).
"""

import dataclasses
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from latticeurbanwind_tpu.bc import vk_inlet as jvk
from latticeurbanwind_tpu_torch import convert
from latticeurbanwind_tpu_torch.bc import vk_inlet as tvk
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_ProfileResearch_noDEM"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _inlet_case(shape=(10, 12, 14), u0=0.05):
    """tests/test_vk_inlet.py::_inlet_case: LUW shell, solid ground, uniform
    inflow along x."""
    Z, Y, X = shape
    flags = np.zeros(shape, np.uint8)
    flags[0] = tvk.TYPE_S
    flags[-1] = tvk.TYPE_E
    flags[:, 0, :] |= tvk.TYPE_E
    flags[:, -1, :] |= tvk.TYPE_E
    flags[:, :, 0] |= tvk.TYPE_E
    flags[:, :, -1] |= tvk.TYPE_E
    u = np.zeros((3, Z, Y, X), np.float32)
    u[0] = u0
    return flags, u


def _port_state(flags, u, storage="f32"):
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, make_initial_state

    return make_initial_state(flags.shape, config=StepConfig(omega=1.0, storage=storage),
                              u=u, flags=flags)


def _assert_runtime_equal(rt_t, rt_j):
    assert rt_t is not None and rt_j is not None
    assert tuple(rt_t.grid) == tuple(rt_j.grid)
    for name in jvk.VkRuntime._fields:
        if name == "grid":
            continue
        a, b = getattr(rt_t, name), getattr(rt_j, name)
        if name == "idx":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


# ---------------------------------------------------------------- runtime


@pytest.mark.parametrize("cfg", [
    dict(nmodes=32),
    dict(nmodes=64, ti=0.1, seed=7, inflow_only=True, downstream_face_id=3),
    dict(nmodes=16, same_realization_all_faces=False, uc_norm_mean=False,
         anisotropy=(1.0, 0.8, 0.5)),
    dict(nmodes=24, face_mode=jvk.ALL_SELECTED, ti=0.0, sigma_lbm=0.002),
])
def test_runtime_matches_jax_on_the_inlet_case(cfg):
    flags, u = _inlet_case()
    rt_t = tvk.build_vk_runtime(tvk.VkConfig(**cfg), flags, u)
    rt_j = jvk.build_vk_runtime(jvk.VkConfig(**cfg), flags, u)
    _assert_runtime_equal(rt_t, rt_j)


def test_runtime_and_config_match_jax_on_the_example_deck(tmp_path, monkeypatch):
    """Both packages' run_deck set up the example deck (inlet on, as it
    ships); the solve itself is stubbed.  The boundary fields they hand to
    `build_vk_runtime`, the VkConfig from the deck and the runtimes are
    bit-equal."""
    import latticeurbanwind_tpu.run.modes as jmodes
    import latticeurbanwind_tpu_torch.run.modes as tmodes
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.deck import load_deck

    seen = {}

    def spy(key, real):
        def build(cfg, flags, u):
            rt = real(cfg, flags, u)
            seen[key] = (cfg, np.array(flags), np.array(u), rt)
            return rt
        return build

    def no_solve(case, quiet=False):
        side = "port" if isinstance(case.state.fi, torch.Tensor) else "jax"
        seen[("hook", side)] = case.pre_step
        return types.SimpleNamespace(timing={}, release_device_state=lambda: None)

    monkeypatch.setattr(tmodes, "build_vk_runtime", spy("port", tvk.build_vk_runtime))
    monkeypatch.setattr(jvk, "build_vk_runtime", spy("jax", jvk.build_vk_runtime))
    monkeypatch.setattr(tmodes, "run_case", no_solve)
    monkeypatch.setattr(jmodes, "run_case", no_solve)
    for side in ("port", "jax"):
        shutil.copytree(EXAMPLE, tmp_path / side)
        deck = load_deck(tmp_path / side / "conf.luwpf")
        assert deck.get_raw("turb_inflow_enable") is None   # on by default
        deck.set_list("angle", [0.0])
        deck.save()
    tmodes.run_deck(tmp_path / "port" / "conf.luwpf", device="cpu", quiet=True)
    jax_run_deck(tmp_path / "jax" / "conf.luwpf", impl="pallas", quiet=True)

    cfg_t, flags_t, u_t, rt_t = seen["port"]
    cfg_j, flags_j, u_j, rt_j = seen["jax"]
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.enable
    np.testing.assert_array_equal(flags_t, flags_j)
    np.testing.assert_array_equal(u_t, u_j)
    _assert_runtime_equal(rt_t, rt_j)
    assert set(rt_t.face_of.tolist()) == {0, 1, 2, 3}
    assert seen[("hook", "port")] is not None and seen[("hook", "jax")] is not None


# ------------------------------------- counterparts of tests/test_vk_inlet.py


def test_mode_spectrum_unit_rms():
    cfg = tvk.VkConfig(L_lbm=20.0, nmodes=256, seed=42)
    m = tvk._sample_modes(cfg, u_ref=0.05, conv_dir=np.array([1.0, 0, 0]), seed=42)
    var = 0.5 * (m["A"][:, 0] ** 2).sum()
    assert var == pytest.approx(1.0, rel=1e-6)
    k = np.linalg.norm(m["k"], axis=1)
    assert k.min() >= 2 * np.pi / (10 * 20.0) * 0.99
    assert k.max() <= np.pi * 1.01
    np.testing.assert_allclose(m["omega"], 0.05 * m["k"][:, 0], rtol=1e-6)


def test_face_selection_excludes_downstream_and_top():
    flags, u = _inlet_case()
    cfg = tvk.VkConfig(nmodes=32, inflow_only=True, downstream_face_id=3)
    faces = set(tvk.build_vk_runtime(cfg, flags, u).face_of.tolist())
    assert 3 not in faces and 4 not in faces and {0, 1, 2} <= faces
    rt2 = tvk.build_vk_runtime(tvk.VkConfig(nmodes=32), flags, u)
    assert set(rt2.face_of.tolist()) == {0, 1, 2, 3}


def test_runtime_points_are_boundary_e_cells():
    flags, u = _inlet_case()
    rt = tvk.build_vk_runtime(tvk.VkConfig(nmodes=16), flags, u)
    zi, yi, xi = rt.idx
    assert (flags[zi, yi, xi] & tvk.TYPE_E).all()
    assert (zi > 0).all()
    np.testing.assert_allclose(rt.sigma, 0.05 * 0.05, rtol=1e-5)


def test_pre_step_perturbs_with_correct_rms():
    flags, u = _inlet_case()
    cfg = tvk.VkConfig(nmodes=128, ti=0.1, seed=7)
    rt = tvk.build_vk_runtime(cfg, flags, u)
    pre = tvk.make_vk_pre_step(cfg, rt)
    state = _port_state(flags, u)
    zi, yi, xi = (torch.from_numpy(a.astype(np.int64)) for a in rt.idx)
    samples = []
    for t in range(0, 600, 7):
        out = pre(state, t)
        samples.append(out.u[:, zi, yi, xi].numpy() - rt.base_u)
    du = np.stack(samples)
    total_rms = np.sqrt((du ** 2).sum(axis=1).mean())
    sigma = float(rt.sigma[0])
    assert 0.3 * sigma < total_rms < 3.0 * sigma
    assert np.abs(du).max() < 20 * sigma
    assert float((out.u[:, 5, 5, 5] - state.u[:, 5, 5, 5]).abs().max()) == 0.0


def test_stride_hold_and_interpolation():
    flags, u = _inlet_case()
    state = _port_state(flags, u)

    def at(cfg, t):
        rt = tvk.build_vk_runtime(cfg, flags, u)
        zi, yi, xi = (torch.from_numpy(a.astype(np.int64)) for a in rt.idx)
        return tvk.make_vk_pre_step(cfg, rt)(state, t).u[:, zi, yi, xi].numpy()

    hold = tvk.VkConfig(nmodes=32, update_stride=4, stride_interpolation=False)
    u4, u6, u8 = (at(hold, t) for t in (4, 6, 8))
    np.testing.assert_allclose(u4, u6)
    assert np.abs(u8 - u4).max() > 0
    lerp = tvk.VkConfig(nmodes=32, update_stride=4, stride_interpolation=True)
    a4, a6, a8 = (at(lerp, t) for t in (4, 6, 8))
    np.testing.assert_allclose(a6, 0.5 * (a4 + a8), atol=1e-6)


def test_disabled_when_no_inflow():
    flags, u = _inlet_case(u0=0.0)
    assert tvk.build_vk_runtime(tvk.VkConfig(), flags, u) is None
    assert tvk.build_vk_runtime(tvk.VkConfig(enable=False), *_inlet_case()) is None


def test_pre_step_matches_jax():
    """The reference-tier hook writes the same inlet velocities as JAX's."""
    from latticeurbanwind_tpu.lbm import StepConfig, make_initial_state

    flags, u = _inlet_case()
    cfg = dict(nmodes=48, ti=0.1, seed=5, update_stride=3, stride_interpolation=True)
    pre_t = tvk.make_vk_pre_step(tvk.VkConfig(**cfg),
                                 tvk.build_vk_runtime(tvk.VkConfig(**cfg), flags, u))
    pre_j = jvk.make_vk_pre_step(jvk.VkConfig(**cfg),
                                 jvk.build_vk_runtime(jvk.VkConfig(**cfg), flags, u))
    js = make_initial_state(flags.shape, config=StepConfig(omega=1.0), u=u, flags=flags)
    ts = _port_state(flags, u)
    for t in (0, 5, 31):
        np.testing.assert_allclose(pre_t(ts, t).u.numpy(), np.asarray(pre_j(js, t).u),
                                   atol=1e-6, err_msg=f"t={t}")


# ------------------------------------------------------------ FaceBC refresh


@pytest.mark.parametrize("stride,interp", [(1, False), (4, False), (4, True)])
def test_facebc_refresh_matches_jax(stride, interp):
    """`.ddf` against JAX `pre.ddf` over steps 0..40 in two chunks (0..20 and
    21..40, each re-seeding the interpolation anchors from its first step,
    as the runners do), compared at t = 0, 3, 7 and 40."""
    import jax

    from latticeurbanwind_tpu.lbm import StepConfig, make_initial_state
    from latticeurbanwind_tpu.ops.stream_collide import split_state
    from latticeurbanwind_tpu_torch.ops.stream_collide import build_face_bc

    flags, u = _inlet_case()
    u = u + 0.01 * np.random.default_rng(4).standard_normal(u.shape).astype(np.float32)
    cfg = dict(nmodes=64, ti=0.1, seed=9, update_stride=stride,
               stride_interpolation=interp)
    pre_j = jvk.make_vk_pre_step(jvk.VkConfig(**cfg),
                                 jvk.build_vk_runtime(jvk.VkConfig(**cfg), flags, u))
    pre_t = tvk.make_vk_pre_step(tvk.VkConfig(**cfg),
                                 tvk.build_vk_runtime(tvk.VkConfig(**cfg), flags, u))
    js = make_initial_state(flags.shape, config=StepConfig(omega=1.0), u=u, flags=flags)
    s = split_state(js, with_fbc=True)
    hook_j = jax.jit(pre_j.ddf)
    fbc = build_face_bc(_port_state(flags, u).u)
    for name in fbc._fields[:6]:      # the velocity targets (tt: thermal runs)
        np.testing.assert_array_equal(getattr(fbc, name).numpy(),
                                      np.asarray(getattr(s.fbc, name)))
    aux = None
    for t in range(41):
        if t in (0, 21):
            s = s._replace(aux=pre_j.ddf.init_aux(s, t))
            aux = pre_t.ddf.init_aux(t)
        s = hook_j(s, t)
        fbc, aux = pre_t.ddf(fbc, t, aux)
        if t in (0, 3, 7, 40):
            for name in fbc._fields[:6]:      # the velocity targets (tt: thermal runs)
                np.testing.assert_allclose(getattr(fbc, name).numpy(),
                                           np.asarray(getattr(s.fbc, name)),
                                           atol=1e-6, err_msg=f"{name} t={t}")
    spec_j, spec_t = pre_j.ddf.kernel_spec, pre_t.ddf.kernel_spec
    assert spec_t["sites"] == spec_j["sites"]
    for k, m in spec_j["masks"].items():
        np.testing.assert_array_equal(spec_t["masks"][k].numpy(), np.asarray(m))


# -------------------------------------------------- the step with inlet sites


def _site_case(storage, seed=2):
    """tests/test_sharded_pallas.py::_case at (7, 21, 45) with nudging and
    the sponge (the FaceBC targets are both the nudge targets and the site
    velocities)."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S,
        build_forcing, make_initial_state, omega_from_nu,
    )

    shape = (7, 21, 45)
    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage=storage)
    u = 0.02 * rng.standard_normal((3, *shape)).astype(np.float32)
    u[0] += 0.05
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[3:5, 10:20, 30:40] = TYPE_S
    state = make_initial_state(shape, config=cfg, u=u, flags=flags)
    forcing = build_forcing(shape, nudge=NudgeSpec(n_cells=3, inv_tau=0.02,
                                                   downstream_face=1),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
    dyn = DynParams(force=jnp.array([1e-5, 0.0, 0.0]),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))
    return cfg, state, forcing, dyn


def _random_spec(shape, seed=3):
    """Random 0/1 masks on the four side faces and the top plane."""
    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    masks = {
        "uw": (rng.random((Z, 1, Y)) < .5).astype(np.float32),
        "ue": (rng.random((Z, 1, Y)) < .5).astype(np.float32),
        "us": (rng.random((Z, 1, X)) < .5).astype(np.float32),
        "un": (rng.random((Z, 1, X)) < .5).astype(np.float32),
        "ut": (rng.random((Y, X)) < .5).astype(np.float32),
    }
    sites = (("lane0", "uw"), ("laneL", "ue"), ("row0", "us"), ("rowL", "un"),
             ("planeL", "ut"))
    return sites, masks


@pytest.mark.parametrize("masks", ["inlet", "random"])
@pytest.mark.parametrize("storage,atol", [("f32", 6e-6), ("bf16", 2e-4)])
def test_plain_step_with_sites_matches_pallas(storage, atol, masks):
    """4 steps of `stream_collide_plain(vk=...)` against
    `make_pallas_step(vk=...)`: with the inlet's own sites, refreshed by
    the `.ddf` hooks before every step (stride 2 with interpolation, as in
    tests/test_sharded_pallas.py), and with random masks on five faces over
    static targets."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm.state import decode_ddf as jdecode
    from latticeurbanwind_tpu.ops.stream_collide import (
        make_pallas_step, merge_state, split_state,
    )
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide_plain,
    )

    cfg, state, forcing, dyn = _site_case(storage)
    shape = state.rho.shape
    vcfg = dict(enable=True, ti=0.08, L_lbm=6.0, nmodes=24, seed=7,
                update_stride=2, stride_interpolation=True)
    if masks == "inlet":
        pre_j = jvk.make_vk_pre_step(jvk.VkConfig(**vcfg), jvk.build_vk_runtime(
            jvk.VkConfig(**vcfg), np.asarray(state.flags), np.asarray(state.u)))
        pre_t = tvk.make_vk_pre_step(tvk.VkConfig(**vcfg), tvk.build_vk_runtime(
            tvk.VkConfig(**vcfg), np.asarray(state.flags), np.asarray(state.u)))
        hook_j, hook_t = pre_j.ddf, pre_t.ddf
        spec_j, spec_t = hook_j.kernel_spec, hook_t.kernel_spec
    else:
        sites, m = _random_spec(shape)
        spec_j = {"sites": sites, "masks": {k: jnp.asarray(v) for k, v in m.items()}}
        spec_t = {"sites": sites, "masks": {k: torch.from_numpy(v) for k, v in m.items()}}
        hook_j = hook_t = None

    pstep = make_pallas_step(cfg, forcing, shape, vk=spec_j)

    def advance(st, d):
        s = split_state(st, with_fbc=True)
        for t in range(4):
            if hook_j is not None:
                s = hook_j(s, t)
            s = pstep(s, d)
        return merge_state(s)

    want = np.asarray(jdecode(jax.jit(advance)(state, dyn).fi, storage))

    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    tcfg = StepConfig(**dataclasses.asdict(cfg))
    fbc = build_face_bc(ts.u)
    fi = ts.fi
    for t in range(4):
        if hook_t is not None:
            fbc, _ = hook_t(fbc, t)
        fi = stream_collide_plain(fi, ts.flags, row, tcfg, tf, fbc, vk=spec_t)
    got = convert.to_numpy(fi).astype(np.float32)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=atol)
    # the sites did act: the inlet faces differ from a run without them
    fi0 = ts.fi
    for t in range(4):
        fi0 = stream_collide_plain(fi0, ts.flags, row, tcfg, tf, build_face_bc(ts.u))
    assert np.abs(convert.to_numpy(fi0).astype(np.float32) - got).max() > 10 * atol


def test_runner_with_the_hook_matches_the_plain_loop():
    """make_runner(pre_step=...) over chunks of 3 + 2 steps equals the
    plain loop with the hook before every step (the runner re-seeds the
    interpolation anchors per chunk, which changes no value), launches no
    kernel on the CPU, and carries the refreshed FaceBC across chunks."""
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    cfg, state, forcing, dyn = _site_case("bf16")
    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    td = convert.dyn_from_jax(dyn)
    tcfg = StepConfig(**dataclasses.asdict(cfg))
    vcfg = tvk.VkConfig(ti=0.08, L_lbm=6.0, nmodes=24, seed=7, update_stride=2,
                        stride_interpolation=True)
    pre = tvk.make_vk_pre_step(vcfg, tvk.build_vk_runtime(
        vcfg, convert.to_numpy(ts.flags), convert.to_numpy(ts.u)))

    fbc = build_face_bc(ts.u)
    fi = ts.fi.clone()
    row = dyn_row(td, "cpu")
    for t in range(5):
        fbc, _ = pre.ddf(fbc, t)
        fi = stream_collide_plain(fi, ts.flags, row, tcfg, tf, fbc,
                                  vk=pre.ddf.kernel_spec)

    run, impl = make_runner(tcfg, tf, shape=tuple(ts.flags.shape), device="cpu",
                            pre_step=pre)
    launches = stream_collide.launches
    out = run(ts, td, 0, 3)
    out = run(out, td, 3, 2)
    assert impl == "plain" and stream_collide.launches == launches
    np.testing.assert_array_equal(convert.to_numpy(out.fi).view(np.uint16),
                                  convert.to_numpy(fi).view(np.uint16))
    for name in fbc._fields[:6]:      # the velocity targets (tt: thermal runs)
        np.testing.assert_array_equal(getattr(run.get_fbc(), name).numpy(),
                                      getattr(fbc, name).numpy())
    with pytest.raises(NotImplementedError, match="pure-DDF"):
        make_runner(tcfg, tf, shape=tuple(ts.flags.shape), device="cpu",
                    pre_step=lambda s, t: s)


# ------------------------------------------- the site pass alone (vk_sites)


def _port_site_case(storage, halo=False, seed=4):
    """`_site_case` in the port, with random 0/1 masks on all six faces;
    with `halo` also random z-halo planes and ghost widths (1, 1), as a
    halo-mode slab (K8) of a split domain has them."""
    from latticeurbanwind_tpu_torch.lbm.state import (
        StepConfig, TYPE_S, ZHalo, dyn_row, encode_ddf,
    )
    from latticeurbanwind_tpu_torch.ops.stream_collide import build_face_bc

    cfg, state, forcing, dyn = _site_case(storage)
    ts = convert.state_from_jax(state)
    Z, Y, X = ts.flags.shape
    sites, masks = _random_spec((Z, Y, X), seed)
    rng = np.random.default_rng(seed)
    masks["ub"] = (rng.random((Y, X)) < .5).astype(np.float32)
    spec = {"sites": sites + (("plane0", "ub"),),
            "masks": {k: torch.from_numpy(v) for k, v in masks.items()}}
    zh = None
    if halo:
        def ddf():
            v = (0.01 * rng.standard_normal((5, Y, X))).astype(np.float32)
            return encode_ddf(torch.from_numpy(v), storage)

        def flag():
            return torch.from_numpy(
                np.where(rng.random((Y, X)) < .15, TYPE_S, 0).astype(np.uint8))

        zh = ZHalo(fp=ddf(), fm=ddf(), flb=flag(), fla=flag(), gy=1, gx=1)
    return (StepConfig(**dataclasses.asdict(cfg)), ts,
            convert.forcing_from_jax(forcing),
            dyn_row(convert.dyn_from_jax(dyn), "cpu"), build_face_bc(ts.u),
            spec, zh)


@pytest.mark.parametrize("halo", [False, True], ids=["box", "halo"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_vk_sites_is_the_step_with_sites(storage, halo):
    """The step with the sites is the step without them and then
    `vk_sites` on its output, code for code, in every storage, with the
    sites on all six faces -- and in a halo-mode slab on the box inside its
    ghost layers (gy = gx = 1)."""
    from latticeurbanwind_tpu_torch.lbm.state import raw_bits
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        stream_collide, vk_sites,
    )

    cfg, ts, frc, row, fbc, spec, zh = _port_site_case(storage, halo)
    want = stream_collide(ts.fi, ts.flags, row, cfg, frc, fbc, vk=spec,
                          halo=zh)
    out = stream_collide(ts.fi, ts.flags, row, cfg, frc, fbc, halo=zh)
    before = raw_bits(out).clone()
    got = vk_sites(out, fbc, spec, storage, gy=zh.gy if halo else 0,
                   gx=zh.gx if halo else 0)
    assert got is out
    assert torch.equal(raw_bits(got), raw_bits(want))
    changed = raw_bits(got) != before
    assert changed.any()
    if halo:   # the ghost rows and columns keep the step's codes
        assert not changed[:, :, [0, -1]].any()
        assert not changed[:, :, :, [0, -1]].any()


def test_vk_sites_refuses_a_spec_without_sites():
    """A `vk` without sites is refused on every device before anything runs,
    so each CUDA call that returns is one launch of the pass."""
    from latticeurbanwind_tpu_torch.ops.stream_collide import vk_sites

    cfg, ts, frc, row, fbc, spec, zh = _port_site_case("bf16", False)
    out = ts.fi.clone()
    with pytest.raises(ValueError, match="no site"):
        vk_sites(out, fbc, {"sites": (), "masks": {}}, "bf16")
    assert torch.equal(out.view(torch.int16), ts.fi.view(torch.int16))


@pytest.mark.parametrize("storage,atol", [("f32", 6e-6), ("bf16", 2e-4)])
def test_vk_sites_after_the_step_match_pallas(storage, atol):
    """4 steps without sites, each followed by `vk_sites`, against
    `make_pallas_step(vk=...)` (interpret mode) with random masks on five
    faces over static targets, at the tolerances of
    `test_plain_step_with_sites_matches_pallas`."""
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm.state import decode_ddf as jdecode
    from latticeurbanwind_tpu.ops.stream_collide import (
        make_pallas_step, merge_state, split_state,
    )
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide_plain, vk_sites,
    )

    cfg, state, forcing, dyn = _site_case(storage)
    shape = state.rho.shape
    sites, m = _random_spec(shape)
    spec_j = {"sites": sites, "masks": {k: jnp.asarray(v) for k, v in m.items()}}
    spec_t = {"sites": sites, "masks": {k: torch.from_numpy(v) for k, v in m.items()}}
    pstep = make_pallas_step(cfg, forcing, shape, vk=spec_j)

    def advance(st, d):
        s = split_state(st, with_fbc=True)
        for _ in range(4):
            s = pstep(s, d)
        return merge_state(s)

    want = np.asarray(jdecode(jax.jit(advance)(state, dyn).fi, storage))
    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    tcfg = StepConfig(**dataclasses.asdict(cfg))
    fbc = build_face_bc(ts.u)
    fi = ts.fi
    for _ in range(4):
        fi = vk_sites(stream_collide_plain(fi, ts.flags, row, tcfg, tf, fbc),
                      fbc, spec_t, storage)
    got = convert.to_numpy(fi).astype(np.float32)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=atol)


def _site_pass_cells(Z, Y, X, faces, gy=0, gx=0) -> list:
    """The site pass's map from a thread's index along x to its cell, as
    `vk_site_kernel` and `vk_faces` (csrc/stream_collide.cu) compute it for
    the masked `faces` (FaceBC field names); each of the 19 directions
    (the grid's y) runs over this list."""
    m = {k: k in faces for k in ("uw", "ue", "us", "un", "ut", "ub")}
    Yb, Xb = Y - 2 * gy, X - 2 * gx
    nplanes = int(m["ub"]) + int(m["ut"] and (Z > 1 or not m["ub"]))
    nrows = int(m["us"]) + int(m["un"] and (Yb > 1 or not m["us"]))
    nlanes = int(m["uw"]) + int(m["ue"] and (Xb > 1 or not m["uw"]))
    zlo, zhi = int(m["ub"]), Z - 1 if m["ut"] else Z
    ylo, yhi = gy + int(m["us"]), Y - gy - 1 if m["un"] else Y - gy
    nz, ny = max(zhi - zlo, 0), max(yhi - ylo, 0)
    plane_cells, row_cells = nplanes * Yb * Xb, nrows * nz * Xb
    cells = []
    for i in range(plane_cells + row_cells + nz * ny * nlanes):
        if i < plane_cells:
            k, r = divmod(i, Yb * Xb)
            cells.append((0 if k == 0 and m["ub"] else Z - 1, gy + r // Xb,
                          gx + r % Xb))
        elif i - plane_cells < row_cells:
            k, r = divmod(i - plane_cells, nz * Xb)
            cells.append((zlo + r // Xb, gy if k == 0 and m["us"] else Y - 1 - gy,
                           gx + r % Xb))
        else:
            t, k = divmod(i - plane_cells - row_cells, nlanes)
            cells.append((zlo + t // ny, ylo + t % ny,
                          gx if k == 0 and m["uw"] else X - 1 - gx))
    return cells


@pytest.mark.parametrize("shape,gy,gx", [
    ((1, 1, 1), 0, 0), ((1, 4, 5), 0, 0), ((2, 2, 2), 0, 0), ((3, 1, 4), 0, 0),
    ((3, 4, 1), 0, 0), ((5, 6, 7), 0, 0), ((4, 5, 7), 1, 1), ((3, 3, 5), 1, 0),
    ((3, 6, 5), 0, 2)])
def test_site_pass_visits_every_masked_face_element_once(shape, gy, gx):
    """For every set of masked faces, the site pass's threads (the list
    `_site_pass_cells` mirrors, once per direction) take every cell of the
    masked faces of the box gy / gx inside the y / x edges exactly once and
    no other cell -- boxes thinner than 3 cells, where faces share or
    coincide, included -- and the lanes' cells come in memory order (the
    east cell of row y next to the west cell of row y + 1)."""
    import itertools

    Z, Y, X = shape
    names = ("uw", "ue", "us", "un", "ut", "ub")
    for r in range(1, 7):
        for faces in itertools.combinations(names, r):
            want = set()
            for z, y, x in itertools.product(range(Z), range(gy, Y - gy),
                                             range(gx, X - gx)):
                if (("ub" in faces and z == 0) or ("ut" in faces and z == Z - 1)
                        or ("us" in faces and y == gy)
                        or ("un" in faces and y == Y - 1 - gy)
                        or ("uw" in faces and x == gx)
                        or ("ue" in faces and x == X - 1 - gx)):
                    want.add((z, y, x))
            got = _site_pass_cells(Z, Y, X, faces, gy, gx)
            assert len(got) == len(set(got)), faces
            assert set(got) == want, faces
            # the lanes' cells (the last run) in memory order: the east
            # cell of row y beside the west cell of row y + 1
            lane_run = [c for c in got if c[0] not in (0, Z - 1)
                        or not {"ub", "ut"} & set(faces)]
            lane_run = [c for c in lane_run if c[1] not in (gy, Y - 1 - gy)
                        or not {"us", "un"} & set(faces)]
            flat = [(z * Y + y) * X + x for z, y, x in lane_run]
            assert flat == sorted(flat), faces
