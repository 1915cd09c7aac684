"""PyTorch port: the step kernel's halo mode (K8, plain version) and a deck
split over several devices (`parallel/mesh.py`, `parallel/halo.py`).

  * K8's plain version on a slab with its halo planes against the plain
    step on the slab with its real neighbour planes around it (the other
    channels of those planes are what K8 never reads);
  * the sharded runner, every shard on the CPU, against the single-device
    plain step over the splits of tests/test_sharded_pallas.py ((1,1,2),
    (1,2,2), (2,1,1), (2,2,2)) with forcing and the VK inlet, the wall
    models, TRT, thermal and `volume_force` off, at its grids;
  * the port's sharded runner against the JAX package's
    `make_sharded_pallas_runner` (interpret mode on the 8-device CPU mesh of
    tests/conftest.py), at JAX's own 1e-6;
  * the example profile deck with `n_gpu = [1, 1, 2]` through the port's
    `run_deck(device="cpu")` against its unsplit run and the JAX package's
    `run_deck` (the tier of tests/test_torch_vk_deck.py) at the 2e-4 m/s of
    tests/test_run_layer.py:193;
  * splits that do not divide the grid (uneven shards, numpy.array_split's
    cuts): the example deck split [1, 1, 3] against its unsplit run and the
    JAX package's, the sharded runner on uneven splits of every axis, and
    the shard / gather round trip with each shard's box;
  * the device rule, the shard / gather round trip and the probe columns
    read from their shards;
  * shards on devices other than their tensors' own (the copy branch of
    the cross-device halos), the runner's stages against its step, and the
    whole-domain state built on the host for a run over several cards.

Each shard's cell runs the same arithmetic on the same inputs as in the
unsplit run, so the split runs are held to EQUAL stored DDFs, fields and
outputs, not to a tolerance.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_ProfileResearch_noDEM"
SPLITS = [(1, 1, 2), (1, 2, 2), (2, 1, 1), (2, 2, 2)]
WALL = dict(wall_model=True, wall_cd=0.0134)
SIDES = dict(WALL, wall_sides=True, wall_cd_sides=0.004)
THERMAL = dict(thermal=True, omega_t=1.1, beta=0.5, t_avg=0.0)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _bits(t):
    return t.view(torch.int16) if t.dtype in (torch.uint16, torch.bfloat16,
                                              torch.float16) else t


def _equal(a, b) -> bool:
    """Same stored codes (f32: same values, NaN nowhere)."""
    return torch.equal(_bits(a), _bits(b))


def _case(shape=(8, 32, 128), storage="f32", seed=0, forcing=True, **cfg_kw):
    """The LUW shell (TYPE_E faces, solid ground), an obstacle crossing the
    shard cuts and 3% random solids; thermal: TYPE_T on the west face, a
    random T and the strong buoyancy of tests/test_torch_thermal.py."""
    from latticeurbanwind_tpu_torch.lbm.forcing import (
        NudgeSpec, SpongeSpec, build_forcing,
    )
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import (
        DynParams, Forcing, StepConfig, TYPE_E, TYPE_S, TYPE_T,
        make_initial_state,
    )

    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage=storage,
                     volume_force=forcing, **cfg_kw)
    u = (0.02 * rng.standard_normal((3, *shape))).astype(np.float32)
    u[0] += np.float32(0.05)
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[(rng.random(shape) < 0.03) & (flags == 0)] = TYPE_S
    flags[3:5, Y // 3:Y // 3 + 10, X // 3:X // 3 + 20] = TYPE_S
    T = None
    if cfg.thermal:
        flags[:, :, 0] |= TYPE_T
        T = (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    state = make_initial_state(shape, config=cfg, u=u, flags=flags, T=T)
    if forcing:
        frc = build_forcing(shape, nudge=NudgeSpec(n_cells=3, inv_tau=0.02,
                                                   downstream_face=1),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
        dyn = DynParams(force=torch.tensor([5e-3, 0.0, -1e-2] if cfg.thermal
                                           else [1e-5, 0.0, 0.0]),
                        omega_coriolis=torch.tensor([0.0, 1e-5, 2e-5]))
    else:
        frc = Forcing()
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    return cfg, state, frc, dyn


def _hook(state, seed=7):
    from latticeurbanwind_tpu_torch.bc.vk_inlet import (
        VkConfig, build_vk_runtime, make_vk_pre_step,
    )

    cfg = VkConfig(ti=0.08, L_lbm=6.0, nmodes=24, seed=seed, update_stride=2,
                   stride_interpolation=True)
    rt = build_vk_runtime(cfg, state.flags.numpy(), state.u.numpy())
    assert rt is not None and len(rt.sigma) > 0
    return make_vk_pre_step(cfg, rt)


def _copy(state):
    return state._replace(fi=state.fi.clone(),
                          gi=None if state.gi is None else state.gi.clone())


# ------------------------------------------------- K8's plain version


@pytest.mark.parametrize("storage,kw,forcing", [
    pytest.param("f32", {}, True, id="f32"),
    pytest.param("f32", {}, False, id="f32-no-force"),
    pytest.param("bf16", SIDES, True, id="bf16-wall-sides"),
    pytest.param("fp16c", dict(WALL, collision="trt"), True, id="fp16c-trt-wall"),
    pytest.param("f32", THERMAL, True, id="f32-thermal"),
    pytest.param("bf16", dict(SIDES, **THERMAL), True, id="bf16-thermal-sides"),
])
def test_k8_plain_matches_plain_step_on_the_slab_with_its_neighbours(
        storage, kw, forcing):
    """A slab of a whole domain (Z + 2 planes, every channel filled, the
    outer two planes fluid with solid cells) with its two outer planes given
    as halos: K8's plain version equals the plain step of the whole domain
    on the slab's planes, with the VK sites of the side faces on; and the
    halos matter: the slab stepped on its own, wrapping, differs."""
    from latticeurbanwind_tpu_torch.lbm.state import ZHalo, dyn_row
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide, stream_collide_plain,
    )

    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S

    cfg, st, frc, dyn = _case((8, 20, 36), storage, seed=4, forcing=forcing,
                              **kw)
    # the outer planes as inside a domain: fluid with 15% solid cells, so the
    # slab's first and last planes pull from them
    rng = np.random.default_rng(9)
    flags = st.flags.clone()
    for z in (0, 7):
        flags[z] = torch.from_numpy(np.where(rng.random((20, 36)) < 0.15,
                                             TYPE_S, 0).astype(np.uint8))
    st = st._replace(flags=flags)
    row = dyn_row(dyn, "cpu")
    pre = _hook(st)
    fbc = build_face_bc(st.u, st.T)
    fbc, _ = pre.ddf(fbc, 0, pre.ddf.init_aux(0))
    vk = pre.ddf.kernel_spec if forcing else None
    if not forcing:
        fbc = None
    thermal = cfg.thermal
    gw = torch.empty_like(st.gi) if thermal else None
    whole = stream_collide_plain(st.fi, st.flags, row, cfg, frc, fbc, vk,
                                 st.gi, gw)

    def cut(a, axis=0):
        return None if a is None else a.narrow(axis, 1, 6)

    halo = ZHalo(fp=st.fi[9:14, 0], fm=st.fi[14:19, 7], flb=st.flags[0],
                 fla=st.flags[7], gp=st.gi[5, 0] if thermal else None,
                 gm=st.gi[6, 7] if thermal else None)
    sfrc = frc._replace(nudge_sigma=cut(frc.nudge_sigma),
                        nudge_face=cut(frc.nudge_face),
                        sponge_sigma_z=cut(frc.sponge_sigma_z))
    sfbc = None if fbc is None else fbc._replace(
        uw=cut(fbc.uw), ue=cut(fbc.ue), us=cut(fbc.us), un=cut(fbc.un))
    svk = None if vk is None else {
        "sites": vk["sites"],
        "masks": {k: cut(m) if m.dim() == 3 else m
                  for k, m in vk["masks"].items()}}
    gi = cut(st.gi, 1).contiguous() if thermal else None
    gs = torch.empty_like(gi) if thermal else None
    slab = stream_collide(cut(st.fi, 1).contiguous(), cut(st.flags).contiguous(),
                          row, cfg, sfrc, sfbc, vk=svk, gi=gi, gi_out=gs,
                          halo=halo)
    assert _equal(slab, whole[:, 1:7])
    if thermal:
        assert _equal(gs, gw[:, 1:7])
    wrapped = stream_collide(cut(st.fi, 1).contiguous(),
                             cut(st.flags).contiguous(), row, cfg, sfrc, sfbc,
                             vk=svk, gi=gi, gi_out=torch.empty_like(gs)
                             if thermal else None)
    assert not _equal(wrapped[:, 0], slab[:, 0])
    assert not _equal(wrapped[:, -1], slab[:, -1])


# ------------------------------------------- the sharded runner, port only


CONFIGS = {
    "forcing+vk": dict(hook=True),
    "wall": dict(kw=WALL, seed=3),
    "wall_sides": dict(kw=SIDES, seed=5),
    "trt": dict(kw=dict(collision="trt"), hook=True, seed=6),
    "thermal": dict(kw=THERMAL, shape=(8, 32, 64), seed=3, hook=True),
    "volume_force off": dict(forcing=False, seed=2),
}


def _single_and_split(name, split, storage="f32", steps=4, device="cpu",
                      shape=None):
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )

    c = CONFIGS[name]
    cfg, st, frc, dyn = _case(shape or c.get("shape", (8, 32, 128)), storage,
                              seed=c.get("seed", 0),
                              forcing=c.get("forcing", True), **c.get("kw", {}))
    pre = _hook(st) if c.get("hook") else None
    run, impl = make_runner(cfg, frc, shape=tuple(st.rho.shape), device="cpu",
                            pre_step=pre)
    single = run(_copy(st), dyn, 0, steps)
    single = update_fields(single, cfg, dyn)

    mesh = domain_mesh(split, tuple(st.rho.shape), device)
    srun, simpl = make_sharded_runner(cfg, frc, mesh, pre_step=pre,
                                      init_u=st.u, init_T=st.T)
    assert (impl, simpl) == ("plain", "plain-sharded")
    ss = shard_state(st, mesh)
    half = steps // 2                 # two calls: the carried FaceBC and aux
    ss = srun(ss, dyn, 0, half)
    ss = srun(ss, dyn, half, steps - half)
    split_state = gather_state(update_fields_sharded(ss, cfg, dyn))
    return cfg, single, split_state


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_runner_equals_single_device_step(name, split):
    cfg, single, split_state = _single_and_split(name, split)
    assert _equal(split_state.fi, single.fi)
    for k in ("rho", "u") + (("gi", "T") if cfg.thermal else ()):
        assert _equal(getattr(split_state, k), getattr(single, k)), k


@pytest.mark.parametrize("storage", ["bf16", "f16", "fp16c"])
def test_sharded_runner_equals_single_device_step_in_two_byte_storages(storage):
    cfg, single, split_state = _single_and_split("forcing+vk", (1, 2, 2),
                                                 storage)
    assert _equal(split_state.fi, single.fi)
    assert _equal(split_state.u, single.u)


@pytest.mark.parametrize("name", ["forcing+vk", "thermal"])
def test_sharded_runner_copies_halos_between_devices(name):
    """Shards on devices other than their tensors' own, as on several
    cards: CPU tensors report `cpu`, which is not `cpu:0`, so every z halo
    and flag plane goes through the copy into per-shard buffers (not a view
    into the neighbour's buffer) and every ghost copy crosses "devices";
    still the single-device step's codes."""
    assert torch.zeros(1).device != torch.device("cpu", 0)
    cfg, single, split_state = _single_and_split(
        name, (2, 2, 2), device=torch.device("cpu", 0))
    assert _equal(split_state.fi, single.fi)
    for k in ("rho", "u") + (("gi", "T") if cfg.thermal else ()):
        assert _equal(getattr(split_state, k), getattr(single, k)), k


def test_runner_stages_make_one_step():
    """`run.stages` hands out the stages `run` itself calls: refresh,
    exchange and kernels in turn step the shards into their spare buffers
    exactly as one `run` step does."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.halo import make_sharded_runner

    cfg, st, frc, dyn = _case(seed=4)
    pre = _hook(st)
    mesh = domain_mesh((1, 2, 2), tuple(st.rho.shape), "cpu")
    srun, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    want = srun(shard_state(st, mesh), dyn, 0, 3)
    srun.reset()
    ss = srun(shard_state(st, mesh), dyn, 0, 2)
    step = srun.stages(ss, dyn, 2)
    step.refresh()
    step.exchange()
    step.kernels()
    assert step.context.t == 3
    for got, w in zip(step.context.spare, want.shards):
        assert _equal(got, w.fi)


# ------------------------------------ against the JAX package's runner


def _jax_case(shape, seed, kw):
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, NudgeSpec, SpongeSpec, StepConfig, TYPE_E, TYPE_S,
        build_forcing, make_initial_state, omega_from_nu,
    )

    rng = np.random.default_rng(seed)
    cfg = StepConfig(omega=omega_from_nu(0.03), subgrid=True, storage="f32",
                     **kw)
    u = 0.02 * rng.standard_normal((3, *shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[-1] = TYPE_E
    flags[:, 0, :] |= TYPE_E
    flags[:, -1, :] |= TYPE_E
    flags[:, :, 0] |= TYPE_E
    flags[:, :, -1] |= TYPE_E
    flags[0] = TYPE_S
    flags[3:5, 10:20, 40:60] = TYPE_S
    state = make_initial_state(shape, config=cfg, u=u, flags=flags)
    forcing = build_forcing(shape, nudge=NudgeSpec(n_cells=3, inv_tau=0.02,
                                                   downstream_face=1),
                            sponge=SpongeSpec(n_cells=3, inv_tau=0.05))
    dyn = DynParams(force=jnp.array([1e-5, 0.0, 0.0]),
                    omega_coriolis=jnp.array([0.0, 1e-5, 2e-5]))
    return cfg, state, forcing, dyn


@pytest.mark.parametrize("split,kw,hook", [
    pytest.param((1, 2, 2), {}, True, id="1x2x2-vk"),
    pytest.param((2, 1, 2), SIDES, False, id="2x1x2-wall-sides"),
])
def test_sharded_runner_matches_jax_sharded_pallas_runner(split, kw, hook):
    from latticeurbanwind_tpu.bc.vk_inlet import (
        VkConfig, build_vk_runtime, make_vk_pre_step,
    )
    from latticeurbanwind_tpu.parallel import domain_mesh as jax_mesh
    from latticeurbanwind_tpu.parallel import shard_state as jax_shard
    from latticeurbanwind_tpu.parallel.halo import make_sharded_pallas_runner
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.bc.vk_inlet import (
        make_vk_pre_step as port_pre_step,
    )
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import make_sharded_runner

    cfg, state, forcing, dyn = _jax_case((8, 32, 128), 2, kw)
    jpre = ppre = None
    if hook:
        vcfg = VkConfig(enable=True, ti=0.08, L_lbm=6.0, nmodes=24, seed=7,
                        update_stride=2, stride_interpolation=True)
        rt = build_vk_runtime(vcfg, np.asarray(state.flags), np.asarray(state.u))
        jpre = make_vk_pre_step(vcfg, rt, storage=cfg.storage).ddf
        ppre = port_pre_step(vcfg, rt)
    mesh = jax_mesh(split)
    jrun = make_sharded_pallas_runner(cfg, forcing, state.rho.shape, mesh,
                                      n_inner=4, pre_step=jpre,
                                      init_u=state.u, init_T=state.T)
    want = np.asarray(jrun(jax_shard(state, mesh), dyn, 0).fi)

    ts = convert.state_from_jax(state)
    pmesh = domain_mesh(split, tuple(ts.rho.shape), "cpu")
    prun, _ = make_sharded_runner(StepConfig(**dataclasses.asdict(cfg)),
                                  convert.forcing_from_jax(forcing), pmesh,
                                  pre_step=ppre, init_u=ts.u, init_T=ts.T)
    got = gather_state(prun(shard_state(ts, pmesh),
                            convert.dyn_from_jax(dyn), 0, 4))
    np.testing.assert_allclose(got.fi.numpy(), want, rtol=0, atol=1e-6)


# -------------------------------------------------- the deck, split


def _deck_copy(dst: Path, n_gpu) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, dst)
    deck = load_deck(dst / "conf.luwpf")
    deck.set_float("cell_size", 24.0)
    deck.set_text("lbm_storage", "f32")
    deck.set_list("angle", [0.0])
    deck.set_int("run_nstep", 40)
    deck.set_int("unsteady_output", 20)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.set_raw("n_gpu", n_gpu)
    deck.save()
    return dst / "conf.luwpf"


def _split_deck_matches(tmp_path, capsys, n_gpu, line, jax_n_gpu):
    """The example deck at 24 m cells split `n_gpu` through the port on the
    CPU, against its unsplit run (final DDFs and raw VTKs exactly, averages
    at fluid cells within the fused pass's 1e-5) and the JAX package's run
    split `jax_n_gpu` (raw VTKs within 1e-4, averages within 2e-4)."""
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    split = run_deck(_deck_copy(tmp_path / "split", n_gpu), device="cpu")
    out = capsys.readouterr().out
    assert line in out
    assert "impl=plain-sharded" in out and "faces=[0, 1, 2, 3]" in out
    whole = run_deck(_deck_copy(tmp_path / "whole", "[1, 1, 1]"), device="cpu",
                     quiet=True)
    ref = jax_run_deck(_deck_copy(tmp_path / "jax", jax_n_gpu), impl="pallas",
                       quiet=True)
    got = {f.name: f for r in split for f in r.files if f.suffix == ".vtk"}
    same = {f.name: f for r in whole for f in r.files if f.suffix == ".vtk"}
    want = {f.name: f for r in ref for f in r.files if f.suffix == ".vtk"}
    assert sorted(got) == sorted(same) == sorted(want) and len(got) == 4
    assert _equal(split[0].state.fi, whole[0].state.fi)
    for name in sorted(got):
        _, fg = read_structured_points(got[name])
        _, fs = read_structured_points(same[name])
        _, fw = read_structured_points(want[name])
        assert sorted(fg) == sorted(fs) == sorted(fw)
        if "_avg-" not in name:
            np.testing.assert_array_equal(fg["data"], fs["data"], err_msg=name)
            np.testing.assert_allclose(fg["data"], fw["data"], rtol=0,
                                       atol=1e-4, err_msg=name)
            continue
        # the unsplit run samples through the fused averaging pass, the
        # split one through update_fields + welford_update (no K-AVG under a
        # mesh): they agree where the fluid is (solid cells: the fused pass
        # holds 0, the other route the stale field)
        fluid = fs["fluid"] > 0.5
        np.testing.assert_array_equal(fg["fluid"], fs["fluid"])
        for key in ("u_avg", "rho_avg", "tke"):
            a, b, c = fg[key][..., fluid], fs[key][..., fluid], fw[key][..., fluid]
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=f"{name}:{key}")
            np.testing.assert_allclose(a, c, rtol=0, atol=2e-4,
                                       err_msg=f"{name}:{key}")


def test_split_profile_deck_matches_unsplit_run_and_jax(tmp_path, capsys):
    """The example profile deck at 24 m cells (27x27x8: 60 m would leave 2
    planes, one per slab, which the JAX package's Pallas tier refuses), VK
    inlet on, n_gpu = [1, 1, 2]: equal to the unsplit run, close to the JAX
    package's run split the same way."""
    _split_deck_matches(tmp_path, capsys, "[1, 1, 2]",
                        "| Device mesh     | n_gpu=[1, 1, 2] -> 2 shards of "
                        "(4, 27, 27)", "[1, 1, 2]")


def test_split_that_does_not_divide_the_grid_raises(tmp_path, capsys):
    """A split that does not divide the grid runs (the name dates from when
    it raised; only a split that leaves a shard empty still does): the deck
    of the test above split n_gpu = [1, 1, 3] (8 planes: slabs of 3, 3 and
    2) runs on uneven shards and equals the unsplit run.  The JAX package
    cannot place that split itself (its `shard_state` puts an axis of 8
    over 3 devices, which `jax.device_put` refuses), so the port is held to
    the JAX package's unsplit run of the same deck; `domain_mesh` cuts an
    axis as numpy.array_split does."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh

    _split_deck_matches(tmp_path, capsys, "[1, 1, 3]",
                        "| Device mesh     | n_gpu=[1, 1, 3] -> 3 shards of "
                        "(3, 27, 27) / (2, 27, 27)", "[1, 1, 1]")
    m = domain_mesh((2, 1, 1), (8, 27, 27), "cpu")
    assert [m.box(i) for i in range(2)] == [(8, 27, 14), (8, 27, 13)]
    with pytest.raises(ValueError, match=r"grid 27x27x8 .*\[1, 1, 9\]"):
        domain_mesh((1, 1, 9), (8, 27, 27), "cpu")


# splits that divide no axis they cut: the y / x ghosts and z halos between
# shards of different sizes (numpy.array_split's cuts)
UNEVEN = [((2, 3, 1), (8, 23, 29)), ((3, 1, 2), (9, 22, 31)),
          ((1, 2, 3), (7, 21, 45))]


@pytest.mark.parametrize("split,shape", UNEVEN,
                         ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("name", ["forcing+vk", "wall_sides", "thermal"])
def test_sharded_runner_on_an_uneven_split_equals_single_device_step(
        name, split, shape):
    cfg, single, split_state = _single_and_split(name, split, shape=shape)
    assert _equal(split_state.fi, single.fi)
    for k in ("rho", "u") + (("gi", "T") if cfg.thermal else ()):
        assert _equal(getattr(split_state, k), getattr(single, k)), k


@pytest.mark.parametrize("split,shape", UNEVEN,
                         ids=lambda v: "x".join(map(str, v)))
def test_uneven_shard_and_gather_round_trip(split, shape):
    """Each shard's box is numpy.array_split's piece of every axis; its
    tensors are that box with one ghost row / lane on each side of a split
    y / x axis; gathering the shards gives back the state."""
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )

    cfg, st, _, _ = _case(shape, "bf16", **THERMAL)
    mesh = domain_mesh(split, shape, "cpu")
    dx, dy, dz = split
    pieces = [np.array_split(np.arange(n), c)
              for n, c in zip(shape, (dz, dy, dx))]
    ss = shard_state(st, mesh)
    gy, gx = mesh.ghosts
    for i, sh in enumerate(ss.shards):
        zi, yi, xi = mesh.coords(i)
        want = tuple(len(pieces[a][c]) for a, c in enumerate((zi, yi, xi)))
        assert mesh.box(i) == want
        assert mesh.origin(i) == tuple(int(pieces[a][c][0])
                                       for a, c in enumerate((zi, yi, xi)))
        assert tuple(sh.fi.shape) == (19, want[0], want[1] + 2 * gy,
                                      want[2] + 2 * gx) == (19, *mesh.local_shape(i))
    back = gather_state(ss)
    for k in st._fields:
        assert _equal(getattr(back, k), getattr(st, k)), k


# ----------------------------------------- the device rule, the mesh


def test_device_rule(monkeypatch):
    """"cuda" spreads the shards over the cards and is a single-device run
    with fewer cards; "cuda:k" and "cpu" put every shard on one device."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh
    from latticeurbanwind_tpu_torch.run.sizing import effective_ngpu

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert effective_ngpu([1, 2, 2], "cuda") == (1, 1, 1)
    assert effective_ngpu([1, 2, 2], "cuda:0") == (1, 2, 2)
    assert effective_ngpu([1, 2, 2], "cpu") == (1, 2, 2)
    assert effective_ngpu([1, 1], "cuda") == (1, 1, 1)
    with pytest.raises(ValueError, match="needs 4 cards, 1 visible"):
        domain_mesh((1, 2, 2), (4, 8, 8), "cuda")
    m = domain_mesh((1, 2, 2), (4, 8, 8), "cuda:0")
    assert m.devices == (torch.device("cuda", 0),) * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert effective_ngpu([1, 2, 2], "cuda") == (1, 2, 2)
    m = domain_mesh((1, 2, 2), (4, 8, 8), "cuda")
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    # shards in (z, y, x) order, their boxes and ghost-extended shapes
    assert [m.origin(i) for i in range(4)] == [(0, 0, 0), (0, 4, 0),
                                               (2, 0, 0), (2, 4, 0)]
    assert m.local_shape(0) == (2, 6, 8) and m.ghosts == (1, 0)


def test_whole_domain_is_built_on_the_host_for_several_cards(monkeypatch):
    """A run that spreads its shards over several cards builds its initial
    state and forcing on the host (card 0 never holds the whole domain);
    every other run builds them on its own device."""
    from latticeurbanwind_tpu_torch.run.sizing import setup_device

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert setup_device([1, 2, 2], "cuda") == torch.device("cpu")
    assert setup_device([1, 1, 1], "cuda") == torch.device("cuda")
    assert setup_device([1, 2, 2], "cuda:0") == torch.device("cuda", 0)
    assert setup_device([1, 2, 2], "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert setup_device([1, 2, 2], "cuda") == torch.device("cuda")


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_shard_and_gather_round_trip(storage):
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )

    cfg, st, _, _ = _case((4, 6, 10), storage, **THERMAL)
    mesh = domain_mesh((2, 2, 2), (4, 6, 10), "cpu")
    ss = shard_state(st, mesh)
    assert tuple(ss.shards[0].fi.shape) == (19, 2, 5, 7)
    back = gather_state(ss)
    for k in st._fields:
        assert _equal(getattr(back, k), getattr(st, k)), k
    # ghosts hold the periodic neighbours: shard 0's x = -1 lane is x = 9
    assert _equal(ss.shards[0].flags[:, 1:-1, 0], st.flags[:2, :3, 9])


@pytest.mark.parametrize("split,shape", [((2, 2, 3), (6, 8, 12)),
                                         ((3, 2, 2), (7, 9, 13))],
                         ids=["even", "uneven"])
def test_probe_columns_come_from_their_shards(split, shape):
    """Every column from the shards that own it, at the edges of their
    boxes too; the uneven split's boxes differ in size along every axis."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.mesh import column_reader

    _, st, _, _ = _case(shape)
    st = st._replace(u=torch.randn(st.u.shape))
    Y, X = shape[1:]
    ys, xs = (0, Y - 1, 3, 4, 5), (0, X - 1, 6, 5, 4)
    want = st.u[:, :, list(ys), list(xs)].numpy()
    mesh = domain_mesh(split, shape, "cpu")
    ss = shard_state(st, mesh)
    np.testing.assert_array_equal(column_reader(mesh, ys, xs)(ss), want)
