"""PyTorch port: the stream-collide step (plain version of K-SC) against the
JAX package's reference step and its Pallas kernel.

The case mirrors tests/test_pallas_kernel.py::_mk_case: the LUW shell (all
outer faces TYPE_E, solid ground), solid blocks, buffer nudging and the top
sponge, a global force and Coriolis.  Inputs come from one numpy seed and
cross to the port bit for bit through `convert`.  Tolerances are the JAX
kernel's own against its reference (test_pallas_kernel.py): 6e-6 for f32 and
2e-4 for bf16 storage after 5 steps.  Both port and Pallas kernel freeze the
TYPE_E cells, where the reference re-evaluates feq with the force half-step;
the gap stays inside those tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _mk_case(shape, storage):
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S,
        build_forcing, make_initial_state, omega_from_nu,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(0)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage=storage)
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
    state = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags)
    forcing = build_forcing(shape,
                            nudge=NudgeSpec(n_cells=3, inv_tau=0.02, downstream_face=2),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
    dyn = DynParams(force=jnp.array([1e-5, 0.0, -2e-5]),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))
    return cfg, state, forcing, dyn


def _flagship(cfg, state):
    """volume_force=False: no nudge/sponge and an inert dyn."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import DynParams, build_forcing

    cfg = dataclasses.replace(cfg, volume_force=False)
    return cfg, build_forcing(state.rho.shape), DynParams(
        force=jnp.zeros(3), omega_coriolis=jnp.zeros(3))


def _port_config(cfg):
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig

    return StepConfig(**dataclasses.asdict(cfg))


def _port_plain_steps(cfg, state, forcing, dyn, n=5):
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide_plain,
    )

    ts = convert.state_from_jax(state)
    tf = convert.forcing_from_jax(forcing)
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    fbc = build_face_bc(ts.u)
    tcfg = _port_config(cfg)
    fi = ts.fi
    for _ in range(n):
        fi = stream_collide_plain(fi, ts.flags, row, tcfg, tf, fbc)
    return convert.to_numpy(fi)


def _reference_steps(cfg, state, forcing, dyn, n=5):
    import jax

    from latticeurbanwind_tpu.lbm.reference import make_step

    step = jax.jit(make_step(cfg, forcing))
    for _ in range(n):
        state = step(state, dyn)
    return np.asarray(state.fi)


@pytest.mark.parametrize("volume_force", [True, False])
@pytest.mark.parametrize("shape,storage,atol", [
    ((8, 32, 128), "f32", 6e-6),
    ((7, 21, 45), "f32", 6e-6),
    ((8, 32, 128), "bf16", 2e-4),
    ((7, 21, 45), "bf16", 2e-4),
])
def test_plain_step_matches_jax_reference(shape, storage, atol, volume_force):
    cfg, state, forcing, dyn = _mk_case(shape, storage)
    if not volume_force:
        cfg, forcing, dyn = _flagship(cfg, state)
    got = _port_plain_steps(cfg, state, forcing, dyn)
    want = _reference_steps(cfg, state, forcing, dyn)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=atol)


def test_plain_step_matches_jax_pallas_kernel():
    """Against the Pallas kernel itself, run in interpret mode as the JAX
    package's own tests run it on the CPU."""
    import jax

    from latticeurbanwind_tpu.ops.stream_collide import (
        make_pallas_step, merge_state, split_state,
    )

    shape = (7, 21, 45)
    cfg, state, forcing, dyn = _mk_case(shape, "f32")
    pstep = make_pallas_step(cfg, forcing, shape)

    def pal_run(st, d):
        s = split_state(st, with_fbc=True)
        for _ in range(5):
            s = pstep(s, d)
        return merge_state(s)

    want = np.asarray(jax.jit(pal_run)(state, dyn).fi)
    got = _port_plain_steps(cfg, state, forcing, dyn)
    np.testing.assert_allclose(got, want, atol=6e-6)


def test_stepper_runs_the_wrapper_over_two_buffers():
    """make_runner on the CPU gives exactly the plain loop's DDFs, and
    reuses the two buffers it swaps (no new allocation per step)."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    shape = (7, 21, 45)
    cfg, state, forcing, dyn = _mk_case(shape, "bf16")
    want = _port_plain_steps(cfg, state, forcing, dyn, n=5)

    ts = convert.state_from_jax(state)
    run, impl = make_runner(_port_config(cfg), convert.forcing_from_jax(forcing),
                            shape=shape, device="cpu")
    assert impl == "plain" and run.fields_stale
    launches = stream_collide.launches
    td = convert.dyn_from_jax(dyn)
    buffers = {ts.fi.data_ptr()}
    out = ts
    for t0, n in ((0, 1), (1, 1), (2, 3)):
        out = run(out, td, t0, n)
        buffers.add(out.fi.data_ptr())
    assert len(buffers) == 2
    np.testing.assert_array_equal(convert.to_numpy(out.fi).view(np.uint16),
                                  want.view(np.uint16))
    # CPU tensors take the plain version: no kernel launch is counted
    assert stream_collide.launches == launches


@pytest.mark.parametrize("change,item", [
    (dict(collision="trt"), "K2"),
    (dict(wall_model=True, wall_cd=0.01), "K4"),
    (dict(wall_model=True, wall_cd=0.01, wall_sides=True), "K4"),
    (dict(thermal=True), "K7"),
    (dict(storage="f16"), "K5"),
    (dict(storage="fp16c"), "K5"),
    (dict(), "K6"),
])
def test_wrapper_refuses_unported_configs(change, item):
    from latticeurbanwind_tpu_torch.lbm.state import Forcing, StepConfig
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide

    cfg = StepConfig(omega=1.5, **change)
    shape = (4, 8, 8)
    fi = torch.zeros((19, *shape), dtype=torch.float32)
    flags = torch.zeros(shape, dtype=torch.uint8)
    vk = {"sites": (("lane0", "uw"),)} if not change else None
    with pytest.raises(NotImplementedError, match=item):
        stream_collide(fi, flags, torch.zeros(8), cfg, Forcing(), vk=vk)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The build looks for nvcc on PATH and in $CUDA_HOME/bin and raises
    when it finds none; nothing falls back to a plain version."""
    from latticeurbanwind_tpu_torch.utils import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
    assert not (tmp_path / "_build").exists() or not any(
        (tmp_path / "_build").glob("*.so"))
    assert len(cuda_build.source_digest()) == 64
    assert [p.name for p in cuda_build.sources()] == ["avg_update.cu",
                                                       "stream_collide.cu"]


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    from latticeurbanwind_tpu_torch.lbm.state import Forcing, StepConfig
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide
    from latticeurbanwind_tpu_torch.run.welford import init_avg

    cfg = StepConfig(omega=1.5, volume_force=False)
    shape = (4, 8, 8)
    fi = torch.zeros((19, *shape), device="meta")
    flags = torch.zeros(shape, dtype=torch.uint8, device="meta")
    row = torch.zeros(8, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        stream_collide(fi, flags, row, cfg, Forcing())
    with pytest.raises(NotImplementedError, match="meta"):
        avg_update(fi, flags, row, 1.0, init_avg(shape, False, "meta"), cfg)
