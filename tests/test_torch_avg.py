"""PyTorch port: the fields pass and the averaging pass (plain version of
K-AVG) against the JAX package's update_fields + welford_update.

Inputs mirror tests/test_avg_kernel.py::_case (LUW shell, solid ground and a
solid block, force + Coriolis) from numpy seeds, crossed bit for bit through
`convert`, over its (storage, wall_model, wall_sides) matrix after the four
storages without a wall model.  The fused pass holds solid cells while
update_fields + welford_update re-accumulate them (avg_kernel.py:18-21), so
the averaging comparison covers fluid and TYPE_E cells.  1e-5 is the JAX fused kernel's own
f32 tolerance against the same pair (test_avg_kernel.py); both sides decode
identical storage bits, so bf16, f16 and fp16c meet it too.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


# the (storage, wall, sides) matrix of tests/test_avg_kernel.py, after the
# four storages without a wall model; ids of those stay the storage names
_MATRIX = [pytest.param(s, False, False, id=s)
           for s in ("f32", "bf16", "f16", "fp16c")] + [
    pytest.param("f32", True, False, id="f32-wall"),
    pytest.param("f32", True, True, id="f32-wall-sides"),
    pytest.param("bf16", True, False, id="bf16-wall"),
]


def _case(storage, seed, shape=(8, 24, 32), wall=False, sides=False):
    import dataclasses

    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, StepConfig, TYPE_E, TYPE_S, make_initial_state,
        omega_from_nu,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage=storage)
    if wall:
        cfg = dataclasses.replace(cfg, wall_model=True, wall_cd=0.0134)
    if sides:
        cfg = dataclasses.replace(cfg, wall_sides=True, wall_cd_sides=0.004)
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


def _stepped(storage, seed, wall=False, sides=False):
    """A state a few reference steps past equilibrium, with stale rho/u."""
    import jax

    from latticeurbanwind_tpu.lbm.reference import make_step

    cfg, state, dyn, flags = _case(storage, seed, wall=wall, sides=sides)
    step = jax.jit(make_step(cfg))
    for _ in range(3):
        state = step(state, dyn)
    return cfg, state, dyn, flags


@pytest.mark.parametrize("storage,wall,sides", _MATRIX)
def test_update_fields_matches_jax(storage, wall, sides):
    import dataclasses

    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig

    cfg, state, dyn, _ = _stepped(storage, 4, wall, sides)
    want = jax_update(state, cfg, dyn)
    got = update_fields(convert.state_from_jax(state),
                        StepConfig(**dataclasses.asdict(cfg)),
                        convert.dyn_from_jax(dyn))
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho), atol=1e-6)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6)


@pytest.mark.parametrize("storage,wall,sides", _MATRIX)
def test_avg_pass_matches_update_fields_plus_welford(storage, wall, sides):
    import dataclasses

    from latticeurbanwind_tpu.lbm.fields import update_fields as jax_update
    from latticeurbanwind_tpu.lbm.state import TYPE_S
    from latticeurbanwind_tpu.run.welford import init_avg, welford_update
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.run import welford as tw

    samples = [_stepped(storage, seed, wall, sides) for seed in (4, 11, 23, 31)]
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


@pytest.mark.parametrize("storage", ["f16", "fp16c"])
def test_plain_passes_decode_through_the_state_codec(storage, monkeypatch):
    """The averaging pass and the fields pass decode the stored DDFs with
    `lbm.state.decode_ddf` (the codec the kernels' device codecs are held
    to), not with a decoder of their own."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm import fields, state as tstate
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, dyn_row
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.run import welford as tw

    seen = []
    real = tstate.decode_ddf

    def spy(x, storage_):
        seen.append(storage_)
        return real(x, storage_)

    monkeypatch.setattr(fields, "decode_ddf", spy)
    cfg, st, dyn, flags = _stepped(storage, 4)
    ts = convert.state_from_jax(st)
    tcfg = StepConfig(**__import__("dataclasses").asdict(cfg))
    avg = avg_update(ts.fi, ts.flags, dyn_row(convert.dyn_from_jax(dyn), "cpu"),
                     1.0, tw.init_avg(flags.shape, False), tcfg)
    assert seen and set(seen) == {storage}
    n = len(seen)
    fields.update_fields(ts, tcfg, convert.dyn_from_jax(dyn))
    assert len(seen) > n and set(seen) == {storage}
    assert bool(torch.isfinite(avg.mean_u).all())


def _avg_shapes() -> dict:
    """K-AVG's compile-time shapes {name: (tx, ty, kz, min_blocks,
    prefetch)}: LUW_TILE_AVG and LUW_TILE_AVG_WALL of
    csrc/stream_collide_tiled.cuh."""
    import re

    from latticeurbanwind_tpu_torch.utils import cuda_build

    text = (cuda_build.CSRC_DIR / "stream_collide_tiled.cuh").read_text()
    return {m.group(1): tuple(int(v) for v in m.group(2).split(","))
            for m in re.finditer(r"#define LUW_TILE_(AVG\w*) ([\d, ]+)\n", text)}


def _tile_walk(shape, tile) -> np.ndarray:
    """How often K-AVG's march (avg_update_kernel's grid and tiled_march)
    visits each cell of `shape` with a block of tile = (tx, ty, kz):
    block (bx, by, bz) covers x0 = bx tx .. + tx, y0 = by ty .. + ty and
    the planes bz kz .. min(+ kz, Z); a thread is live where its cell lies
    inside the grid's ragged edge."""
    Z, Y, X = shape
    tx, ty, kz = tile[:3]
    seen = np.zeros(shape, np.int64)
    for bz in range(-(-Z // kz)):
        for by in range(-(-Y // ty)):
            for bx in range(-(-X // tx)):
                x0, y0, z0 = bx * tx, by * ty, bz * kz
                txn, tyn = min(tx, X - x0), min(ty, Y - y0)
                for z in range(z0, min(z0 + kz, Z)):
                    for t in range(tx * ty):
                        if t % tx < txn and t // tx < tyn:
                            seen[z, y0 + t // tx, x0 + t % tx] += 1
    return seen


@pytest.mark.parametrize("tile", ["AVG", "AVG_WALL", (128, 1, 8),
                                  (256, 1, 8)], ids=str)
@pytest.mark.parametrize("shape", [(7, 21, 45), (13, 37, 141), (1, 1, 1),
                                   (9, 3, 130)], ids=str)
def test_avg_tile_walk_visits_every_cell_once(shape, tile):
    """K-AVG's blocks, marching over their planes, visit every cell of a
    ragged grid exactly once, at the committed shapes (without and with a
    wall model) and at other shapes `chip_sweep.py --family avg` builds."""
    if isinstance(tile, str):
        tile = _avg_shapes()[tile]
    assert (_tile_walk(shape, tile) == 1).all()
