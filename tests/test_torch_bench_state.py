"""PyTorch port, the two functions a benchmark of the port calls
(`lbm/state.py::equilibrium_state`, `lbm/stepper.py::make_bench_runner`)
against the JAX package's.

`equilibrium_state` on tensors on the CPU device is held to the JAX
`equilibrium_state` in all four storages, f and the thermal g, within
`tests/test_lbm_physics.py:329`'s tolerances (one storage step), and to
the port's `make_initial_state` exactly; `make_bench_runner` is
`make_runner` with no forcing, step for step.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu_torch.lbm import state as tst

ATOL = {"f32": 1e-6, "bf16": 3e-3, "f16": 6e-4, "fp16c": 4e-4}


def _inputs(shape, seed=7):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.05 * rng.standard_normal(shape).astype(np.float32)
    u = 0.08 * rng.standard_normal((3, *shape)).astype(np.float32)
    T = 1.0 + 0.1 * rng.standard_normal(shape).astype(np.float32)
    flags = rng.integers(0, 4, size=shape).astype(np.uint8)
    return rho, u, T, flags


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_equilibrium_state_matches_jax(storage):
    import jax
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import decode_ddf, equilibrium_state
    from latticeurbanwind_tpu.lbm import StepConfig, omega_t_from_alpha

    shape = (5, 8, 9)
    kw = dict(omega=1.2, storage=storage, thermal=True,
              omega_t=omega_t_from_alpha(1e-3))
    rho, u, T, flags = _inputs(shape)
    ref = jax.jit(lambda r, uu, fl, tt: equilibrium_state(
        shape, config=StepConfig(**kw), rho=r, u=uu, flags=fl, T=tt))(rho, u, flags, T)
    cpu = torch.device("cpu")
    got = tst.equilibrium_state(
        shape, config=tst.StepConfig(**kw), device=cpu,
        rho=torch.from_numpy(rho), u=torch.from_numpy(u),
        flags=torch.from_numpy(flags), T=torch.from_numpy(T))
    for name in ("fi", "gi"):
        a = np.asarray(decode_ddf(jnp.asarray(getattr(ref, name)), storage))
        b = tst.decode_ddf(getattr(got, name), storage).numpy()
        np.testing.assert_allclose(b, a, atol=ATOL[storage], rtol=0)
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(ref.u))
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(ref.T))
    host = tst.make_initial_state(shape, config=tst.StepConfig(**kw), rho=rho, u=u,
                                  flags=flags, T=T, device="cpu")
    for name in ("fi", "gi", "rho", "u", "T", "flags"):
        assert torch.equal(getattr(host, name), getattr(got, name)), name
    assert all(getattr(got, n).device == cpu for n in ("fi", "gi", "rho", "u", "T"))


def test_equilibrium_state_defaults_and_bench_runner():
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import StepConfig as JaxConfig
    from latticeurbanwind_tpu.lbm import decode_ddf
    from latticeurbanwind_tpu.lbm import equilibrium_state as jax_eq
    from latticeurbanwind_tpu_torch.lbm.state import DynParams, Forcing
    from latticeurbanwind_tpu_torch.lbm.stepper import make_bench_runner, make_runner

    shape = (6, 8, 10)
    cfg = tst.StepConfig(omega=1.7, storage="bf16", volume_force=False)
    bare = tst.equilibrium_state(shape, config=cfg, device="cpu")
    ref = jax_eq(shape, config=JaxConfig(omega=1.7, storage="bf16", volume_force=False))
    np.testing.assert_allclose(tst.decode_ddf(bare.fi, "bf16").numpy(),
                               np.asarray(decode_ddf(jnp.asarray(ref.fi), "bf16")),
                               atol=ATOL["bf16"], rtol=0)
    assert bare.gi is None and bare.T is None and bare.flags.dtype == torch.uint8
    _, u, _, _ = _inputs(shape, seed=2)
    flags = np.zeros(shape, np.uint8)
    flags[0] = tst.TYPE_S
    flags[:, :, 0] = tst.TYPE_E
    states = [tst.make_initial_state(shape, config=cfg, u=u, flags=flags)
              for _ in range(2)]
    dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    run_b, impl = make_bench_runner(cfg, shape=shape, device="cpu")
    run_r, _ = make_runner(cfg, Forcing(), shape=shape, device="cpu")
    assert impl == "plain"
    a = run_b(states[0], dyn, 0, 3)
    b = run_r(states[1], dyn, 0, 3)
    assert torch.equal(a.fi, b.fi)
