"""PyTorch port: the fields pass and the averaging pass (plain version of
K-AVG) against the JAX package's update_fields + welford_update.

Inputs mirror tests/test_avg_kernel.py::_case (LUW shell, solid ground and a
solid block, force + Coriolis) from numpy seeds, crossed bit for bit through
`convert`.  The fused pass holds solid cells while update_fields +
welford_update re-accumulate them (avg_kernel.py:18-21), so the averaging
comparison covers fluid and TYPE_E cells.  1e-5 is the JAX fused kernel's own
f32 tolerance against the same pair (test_avg_kernel.py); both sides decode
identical storage bits, so bf16 meets it too.
"""

import numpy as np
import pytest


def _case(storage, seed, shape=(8, 24, 32)):
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, StepConfig, TYPE_E, TYPE_S, make_initial_state,
        omega_from_nu,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage=storage)
    u = 0.03 * rng.standard_normal((3, Z, Y, X)).astype(np.float32)
    rho = (1.0 + 0.001 * rng.standard_normal(shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[2:4, 8:14, 10:16] = TYPE_S
    state = make_initial_state(shape, config=cfg, rho=rho, u=u, flags=flags)
    dyn = DynParams(force=jnp.array([1e-5, 0.0, -2e-5]),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))
    return cfg, state, dyn, flags


def _stepped(storage, seed):
    """A state a few reference steps past equilibrium, with stale rho/u."""
    import jax

    from latticeurbanwind_tpu.lbm.reference import make_step

    cfg, state, dyn, flags = _case(storage, seed)
    step = jax.jit(make_step(cfg))
    for _ in range(3):
        state = step(state, dyn)
    return cfg, state, dyn, flags


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_update_fields_matches_jax(storage):
    import dataclasses

    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig

    cfg, state, dyn, _ = _stepped(storage, 4)
    want = jax_update(state, cfg, dyn)
    got = update_fields(convert.state_from_jax(state),
                        StepConfig(**dataclasses.asdict(cfg)),
                        convert.dyn_from_jax(dyn))
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho), atol=1e-6)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_avg_pass_matches_update_fields_plus_welford(storage):
    import dataclasses

    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu.lbm.state import TYPE_S
    from latticeurbanwind_tpu.run.welford import init_avg, welford_update
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.run import welford as tw

    samples = [_stepped(storage, seed) for seed in (4, 11, 23, 31)]
    cfg, _, dyn, flags = samples[0]
    shape = flags.shape

    ref = init_avg(shape, False)
    for _, st, _, _ in samples:
        ref = welford_update(ref, jax_update(st, cfg, dyn))

    tcfg = StepConfig(**dataclasses.asdict(cfg))
    row = dyn_row(convert.dyn_from_jax(dyn), "cpu")
    avg = tw.init_avg(shape, False)
    launches = avg_update.launches
    for k, (_, st, _, _) in enumerate(samples):
        ts = convert.state_from_jax(st)
        avg = avg_update(ts.fi, ts.flags, row, 1.0 / (k + 1), avg, tcfg)
    assert avg.count == 4 and avg_update.launches == launches

    got = convert.avg_to_numpy(avg)
    keep = (flags & TYPE_S) == 0
    for name in ("mean_u", "m2_u", "mean_rho"):
        np.testing.assert_allclose(getattr(got, name)[..., keep],
                                   np.asarray(getattr(ref, name))[..., keep],
                                   atol=1e-5, err_msg=name)
    # the port's own unfused pair agrees with the JAX pair as well
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields

    pair = tw.init_avg(shape, False)
    for _, st, _, _ in samples:
        pair = tw.welford_update(pair, update_fields(
            convert.state_from_jax(st), tcfg, convert.dyn_from_jax(dyn)))
    np.testing.assert_allclose(convert.to_numpy(tw.variance_sum_u(pair)),
                               np.asarray(ref.m2_u) / 4.0, atol=1e-5)
