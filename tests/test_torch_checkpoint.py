"""PyTorch port, checkpoint/resume (`run/checkpoint.py` and the driver's
resume), against itself and against the JAX package's checkpoints.

The port's tests mirror `tests/test_checkpoint.py` one for one; the
cross-package cases hold the v2 file format both ways:

  * a JAX checkpoint (pallas tier, interpret mode, as the JAX package's
    tests run it on the CPU) loads into the port bit for bit and resumes
    there to within the kernels' tolerances of the JAX package's
    uninterrupted run (6e-6 f32, 2e-4 bf16, on the decoded DDFs and u);
  * a port checkpoint loads through the JAX package's `load_checkpoint`
    bit for bit in all four storages, and the JAX package resumes it to the
    same tolerances of its own uninterrupted run;
  * a port checkpoint of a split run holds one block per shard (no `fi`
    entry), also for a split that does not divide the grid, assembles in
    the JAX package's loader to the unsplit state, and resumes code for
    code under another split and unsplit;
  * a JAX checkpoint of a split run carries its FaceBC padded with the
    JAX runner's ghosts: the port prints the JAX package's "face targets
    not restored" line and resumes the state.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

DATETIME = "20250101000000"
SHAPE = (7, 8, 10)
TOL = {"f32": 6e-6, "bf16": 2e-4}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _inputs(shape, seed=3):
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_E, TYPE_S

    rng = np.random.default_rng(seed)
    u = 0.02 * rng.standard_normal((3, *shape)).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_E
    return u, flags


def _settings(run_settings, run_nstep):
    return run_settings(run_nstep=run_nstep, purge_avg=8, purge_avg_stride=2,
                        checkpoint_interval=10, chunk=5)


def _units(units_class):
    units = units_class()
    units.set_m_kg_s(1.0, 0.1, 1.0, 20.0, 8.0, 1.225)
    return units


def _port_case(parent, run_nstep, storage="f32", ngpu=(1, 1, 1), shape=SHAPE,
               sponge=False):
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import (
        DynParams, Forcing, StepConfig, make_initial_state,
    )
    from latticeurbanwind_tpu_torch.run.driver import RunSettings, SolverCase
    from latticeurbanwind_tpu_torch.units import Units

    u, flags = _inputs(shape)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=True, storage=storage)
    forcing = (Forcing(sponge_sigma_z=torch.linspace(0, 0.05, shape[0]))
               if sponge else Forcing())
    return SolverCase(
        config=config, forcing=forcing,
        state=make_initial_state(shape, config=config, u=u, flags=flags),
        dyn=DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3)),
        units=_units(Units), cell_m=20.0, parent=parent, datetime=DATETIME,
        settings=_settings(RunSettings, run_nstep), ngpu=ngpu, device=torch.device("cpu"))


def _jax_case(parent, run_nstep, storage="f32", ngpu=(1, 1, 1), shape=SHAPE,
              sponge=False):
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import (
        DynParams, Forcing, StepConfig, make_initial_state, omega_from_nu,
    )
    from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase
    from latticeurbanwind_tpu.units import Units

    u, flags = _inputs(shape)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=True, storage=storage)
    forcing = (Forcing(sponge_sigma_z=jnp.linspace(0, 0.05, shape[0]))
               if sponge else Forcing())
    return SolverCase(
        config=config, forcing=forcing,
        state=make_initial_state(shape, config=config, u=u, flags=flags),
        dyn=DynParams(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3)),
        units=_units(Units), cell_m=20.0, parent=parent, datetime=DATETIME,
        settings=_settings(RunSettings, run_nstep), impl="pallas", ngpu=ngpu)


def _codes(a) -> np.ndarray:
    """Stored codes of a tensor or array, for bit comparisons."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16, torch.uint16):
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _decoded(fi, storage) -> np.ndarray:
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf

    if not isinstance(fi, torch.Tensor):
        a = np.array(fi)
        fi = (torch.from_numpy(a.view(np.int16)).view(torch.uint16)
              if storage == "fp16c" else
              torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
              if storage == "bf16" else torch.from_numpy(np.array(a)))
    return decode_ddf(fi, storage).numpy()


def _run_dir(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return d


@pytest.fixture(scope="module")
def jax_full_run(tmp_path_factory):
    """The JAX package's uninterrupted 30-step run per storage, once."""
    from latticeurbanwind_tpu.run.driver import run_case as jax_run_case

    done = {}

    def get(storage):
        if storage not in done:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("LUW_PALLAS_INTERPRET", "1")
                parent = tmp_path_factory.mktemp(f"jax_full_{storage}")
                done[storage] = jax_run_case(_jax_case(parent, 30, storage),
                                             quiet=True)
        return done[storage]

    return get


# --------------------------------------------- mirrors of test_checkpoint.py

def test_checkpoint_save_load_round_trip(tmp_path):
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    case = _port_case(tmp_path, 4)
    p = tmp_path / "x.ckpt.npz"
    save_checkpoint(p, case.state, step=7, meta={"k": 1})
    state, step, avg, samples, meta = load_checkpoint(p)
    assert step == 7 and avg is None and samples == 0 and meta == {"k": 1}
    assert torch.equal(state.fi, case.state.fi)
    assert torch.equal(state.flags, case.state.flags)


def test_checkpoint_fbc_round_trip(tmp_path):
    from latticeurbanwind_tpu_torch.ops.stream_collide import FaceBC
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_fbc, save_checkpoint,
    )

    case = _port_case(tmp_path, 4)
    g = torch.Generator().manual_seed(11)
    Z, Y, X = case.state.rho.shape
    fbc = FaceBC(*(torch.randn(s, generator=g) for s in (
        (Z, 3, Y), (Z, 3, Y), (Z, 3, X), (Z, 3, X), (3, Y, X), (3, Y, X))))
    p = tmp_path / "f.ckpt.npz"
    save_checkpoint(p, case.state, step=3, fbc=fbc)
    back = load_fbc(p)
    assert back is not None and back.tt is None
    for k in ("uw", "ue", "us", "un", "ut", "ub"):
        assert torch.equal(getattr(back, k), getattr(fbc, k))
    p2 = tmp_path / "g.ckpt.npz"
    save_checkpoint(p2, case.state, step=3)
    assert load_fbc(p2) is None


@pytest.mark.parametrize("storage", ["bf16", "f16", "fp16c"])
def test_two_byte_storage_checkpoint_round_trips_bit_exactly(tmp_path, storage):
    """bf16 goes to the file as raw 2-byte voids under the name "bfloat16"
    (numpy's storage of the JAX package's bf16), fp16c as uint16, f16 as
    float16; each loads back to its own dtype bit for bit."""
    from latticeurbanwind_tpu_torch.lbm.state import storage_dtype
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    case = _port_case(tmp_path, 4, storage)
    p = tmp_path / "b.ckpt.npz"
    save_checkpoint(p, case.state, step=5)
    with np.load(p) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        stored = z["fi"].dtype
    want = {"bf16": ("bfloat16", "V"), "f16": ("float16", "f"),
            "fp16c": ("uint16", "u")}[storage]
    assert (header["dtypes"]["fi"], stored.kind) == want
    back, step, *_ = load_checkpoint(p)
    assert step == 5 and back.fi.dtype == storage_dtype(storage)
    np.testing.assert_array_equal(_codes(back.fi), _codes(case.state.fi))


def test_sharded_checkpoint_per_shard_format(tmp_path):
    from latticeurbanwind_tpu_torch.parallel.mesh import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    shape = (4, 8, 8)
    state = _port_case(tmp_path, 4, shape=shape).state
    sharded = shard_state(state, domain_mesh((2, 2, 2), shape, "cpu"))
    p = tmp_path / "s.ckpt.npz"
    save_checkpoint(p, sharded, step=9)
    with np.load(p) as z:
        assert len([k for k in z.files if k.startswith("fi@")]) == 8
        assert "fi" not in z.files
    back, step, *_ = load_checkpoint(p, expect_shape=shape)
    assert step == 9
    assert torch.equal(back.fi, state.fi) and torch.equal(back.u, state.u)
    resharded = shard_state(back, domain_mesh((4, 2, 1), shape, "cpu"))
    assert torch.equal(gather_state(resharded).fi, state.fi)


def test_load_returns_host_arrays(tmp_path):
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    case = _port_case(tmp_path, 4)
    p = tmp_path / "h.ckpt.npz"
    save_checkpoint(p, case.state, step=3)
    state, *_ = load_checkpoint(p)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in (state.fi, state.rho, state.u, state.flags))


def test_torn_multihost_save_detected(tmp_path):
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    case = _port_case(tmp_path, 4)
    p = tmp_path / "t.ckpt.npz"
    save_checkpoint(p, case.state, step=5)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
        header = json.loads(bytes(z["header"].tobytes()).decode())
    header["n_processes"] = 2
    payload["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez_compressed(p, **payload)
    sib = tmp_path / "t.ckpt.npz.p1.npz"
    np.savez_compressed(sib, header=np.frombuffer(
        json.dumps({"version": 2, "step": 6}).encode(), np.uint8))
    with pytest.raises(ValueError, match="torn multi-host save"):
        load_checkpoint(p)
    np.savez_compressed(sib, header=np.frombuffer(
        json.dumps({"version": 2, "step": 5}).encode(), np.uint8))
    state, step, *_ = load_checkpoint(p)
    assert step == 5


def _interrupted(tmp_path, first_ngpu, second_ngpu, storage="f32"):
    """(uninterrupted 30-step result, result resumed at 10 to 30)."""
    from latticeurbanwind_tpu_torch.run.checkpoint import checkpoint_path
    from latticeurbanwind_tpu_torch.run.driver import run_case

    full = run_case(_port_case(_run_dir(tmp_path, "full"), 30, storage,
                               ngpu=second_ngpu), quiet=True)
    part = _run_dir(tmp_path, "part")
    c1 = _port_case(part, 10, storage, ngpu=first_ngpu)
    c1.settings.purge_avg = 0
    run_case(c1, quiet=True)
    assert checkpoint_path(part, DATETIME).exists()
    resumed = run_case(_port_case(part, 30, storage, ngpu=second_ngpu),
                       quiet=True)
    assert resumed.total_steps == 30 and "checkpoint_load_seconds" in resumed.timing
    return full, resumed


def test_interrupted_sharded_run_resumes_identically(tmp_path):
    from latticeurbanwind_tpu_torch.run.checkpoint import checkpoint_path

    full, resumed = _interrupted(tmp_path, (1, 2, 2), (1, 2, 2))
    with np.load(checkpoint_path(tmp_path / "part", DATETIME)) as z:
        assert any(k.startswith("fi@") for k in z.files)
    for k in ("fi", "u", "rho"):
        assert torch.equal(getattr(resumed.state, k), getattr(full.state, k)), k
    for k in ("mean_u", "m2_u", "mean_rho"):
        assert torch.equal(getattr(resumed.avg, k), getattr(full.avg, k)), k


def test_interrupted_run_resumes_identically(tmp_path):
    full, resumed = _interrupted(tmp_path, (1, 1, 1), (1, 1, 1))
    for k in ("fi", "u", "rho"):
        assert torch.equal(getattr(resumed.state, k), getattr(full.state, k)), k
    for k in ("mean_u", "m2_u", "mean_rho"):
        assert torch.equal(getattr(resumed.avg, k), getattr(full.avg, k)), k


# ------------------------------------------------------ across the packages

@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, storage, jax_full_run):
    from latticeurbanwind_tpu.run.driver import run_case as jax_run_case
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        checkpoint_path, load_checkpoint,
    )
    from latticeurbanwind_tpu_torch.run.driver import run_case

    parent = _run_dir(tmp_path, "run")
    c1 = _jax_case(parent, 10, storage)
    c1.settings.purge_avg = 0
    at10 = jax_run_case(c1, quiet=True)
    state, step, avg, samples, meta = load_checkpoint(
        checkpoint_path(parent, DATETIME), expect_shape=SHAPE)
    assert (step, avg, samples, meta) == (10, None, 0, {"total_steps": 10})
    for k in ("fi", "rho", "u", "flags"):
        np.testing.assert_array_equal(_codes(getattr(state, k)),
                                      _codes(getattr(at10.state, k)), err_msg=k)

    resumed = run_case(_port_case(parent, 30, storage), quiet=True)
    full = jax_full_run(storage)
    assert resumed.total_steps == full.total_steps == 30
    np.testing.assert_allclose(_decoded(resumed.state.fi, storage),
                               _decoded(full.state.fi, storage),
                               rtol=0, atol=TOL[storage])
    np.testing.assert_allclose(resumed.state.u.numpy(), np.asarray(full.state.u),
                               rtol=0, atol=TOL[storage])


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_port_checkpoint_loads_in_jax(tmp_path, storage, jax_full_run):
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint as jax_load_checkpoint,
    )
    from latticeurbanwind_tpu.run.driver import run_case as jax_run_case
    from latticeurbanwind_tpu_torch.run.checkpoint import checkpoint_path
    from latticeurbanwind_tpu_torch.run.driver import run_case

    parent = _run_dir(tmp_path, "run")
    c1 = _port_case(parent, 10, storage)
    c1.settings.purge_avg = 0
    at10 = run_case(c1, quiet=True)
    state, step, *_ = jax_load_checkpoint(checkpoint_path(parent, DATETIME),
                                          expect_shape=SHAPE)
    assert step == 10
    for k in ("fi", "rho", "u", "flags"):
        np.testing.assert_array_equal(_codes(getattr(state, k)),
                                      _codes(getattr(at10.state, k)), err_msg=k)
    if storage not in TOL:
        return
    resumed = jax_run_case(_jax_case(parent, 30, storage), quiet=True)
    full = jax_full_run(storage)
    assert resumed.total_steps == 30
    np.testing.assert_allclose(_decoded(resumed.state.fi, storage),
                               _decoded(full.state.fi, storage),
                               rtol=0, atol=TOL[storage])
    np.testing.assert_allclose(np.asarray(resumed.state.u),
                               np.asarray(full.state.u), rtol=0, atol=TOL[storage])


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_checkpoints_cross_the_packages_bit_for_bit(tmp_path, storage):
    """Both packages' initial states of the same inputs (bit-equal), each
    saved plain and per shard, load in the other package bit for bit: the
    JAX package's blocks of a (2, 2, 2) mesh over 8 CPU devices, the port's
    of the uneven (1, 1, 3) split (the JAX package cannot place a split
    that does not divide the grid)."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import StepConfig as JaxConfig
    from latticeurbanwind_tpu.lbm import make_initial_state as jax_initial
    from latticeurbanwind_tpu.parallel import domain_mesh as jax_mesh
    from latticeurbanwind_tpu.parallel import shard_state as jax_shard
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint as jax_load, save_checkpoint as jax_save,
    )
    from latticeurbanwind_tpu_torch.parallel.mesh import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    shape = (6, 8, 10)
    ours = _port_case(tmp_path, 1, storage, shape=shape).state
    u, flags = _inputs(shape)
    theirs = jax_initial(shape, config=JaxConfig(omega=1.0, storage=storage),
                         u=u, flags=flags)
    keys = ("fi", "rho", "u", "flags")
    for k in keys:
        np.testing.assert_array_equal(_codes(getattr(ours, k)),
                                      _codes(getattr(theirs, k)), err_msg=k)
    saves = {
        "jax": jax_save(tmp_path / "j.ckpt.npz", theirs, step=3),
        "jax-sharded": jax_save(tmp_path / "js.ckpt.npz",
                                jax_shard(theirs, jax_mesh((2, 2, 2))), step=3),
        "port": save_checkpoint(tmp_path / "p.ckpt.npz", ours, step=3),
        "port-sharded": save_checkpoint(
            tmp_path / "ps.ckpt.npz",
            shard_state(ours, domain_mesh((1, 1, 3), shape, "cpu")), step=3),
    }
    for name, path in saves.items():
        with np.load(path) as z:
            assert ("fi" in z.files) == (not name.endswith("sharded")), name
        back = (load_checkpoint if name.startswith("jax") else jax_load)(path)[0]
        for k in keys:
            np.testing.assert_array_equal(_codes(getattr(back, k)),
                                          _codes(getattr(ours, k)),
                                          err_msg=f"{name}: {k}")
        if name.startswith("jax"):
            assert back.fi.dtype == ours.fi.dtype
        else:
            assert jnp.asarray(back.fi).dtype == theirs.fi.dtype


@pytest.mark.parametrize("split, other", [((1, 2, 2), (1, 1, 3)),
                                          ((1, 1, 3), (1, 2, 2))])
def test_split_checkpoint_assembles_in_jax_and_resumes_under_any_split(
        tmp_path, split, other):
    """(1, 1, 3) does not divide the grid's 7 planes: its blocks differ in
    size, which the JAX package's loader places by their shape."""
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint as jax_load_checkpoint,
    )
    from latticeurbanwind_tpu_torch.run.checkpoint import checkpoint_path
    from latticeurbanwind_tpu_torch.run.driver import run_case

    whole = run_case(_port_case(_run_dir(tmp_path, "whole"), 10), quiet=True)
    full = run_case(_port_case(_run_dir(tmp_path, "full"), 30), quiet=True)
    part = _run_dir(tmp_path, "part")
    c1 = _port_case(part, 10, ngpu=split)
    c1.settings.purge_avg = 0
    run_case(c1, quiet=True)
    ck = checkpoint_path(part, DATETIME)
    with np.load(ck) as z:
        assert "fi" not in z.files
        blocks = [z[k].shape for k in z.files if k.startswith("fi@")]
    assert len(blocks) == np.prod(split)
    if split == (1, 1, 3):
        assert sorted(blocks) == [(19, 2, 8, 10), (19, 2, 8, 10), (19, 3, 8, 10)]
    state, step, *_ = jax_load_checkpoint(ck, expect_shape=SHAPE)
    assert step == 10
    for k in ("fi", "rho", "u", "flags"):
        np.testing.assert_array_equal(_codes(getattr(state, k)),
                                      _codes(getattr(whole.state, k)), err_msg=k)
    # resumed under the other split, and unsplit, from the same file (a
    # resumed run saves again at 20 and 30: each starts from a copy)
    kept = tmp_path / "step10.ckpt.npz"
    shutil.copyfile(ck, kept)
    for ngpu in (other, (1, 1, 1)):
        shutil.copyfile(kept, ck)
        resumed = run_case(_port_case(part, 30, ngpu=ngpu), quiet=True)
        for k in ("fi", "u", "rho"):
            assert torch.equal(getattr(resumed.state, k),
                               getattr(full.state, k)), (ngpu, k)


def test_thermal_and_probe_buffers_round_trip(tmp_path):
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint as jax_load_checkpoint,
    )
    from latticeurbanwind_tpu.run.probes import GridProbe as JaxProbe
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig, make_initial_state
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from latticeurbanwind_tpu_torch.run.probes import GridProbe
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    u, flags = _inputs(SHAPE)
    T = (1.0 + 0.01 * np.random.default_rng(5).standard_normal(SHAPE)).astype(np.float32)
    config = StepConfig(omega=omega_from_nu(0.05), thermal=True, omega_t=1.1,
                        storage="bf16")
    state = make_initial_state(SHAPE, config=config, u=u, flags=flags, T=T)
    avg = welford_update(init_avg(SHAPE, True), state)
    probe = GridProbe("p0", x=3, y=4, z_indices=[1, 2, 3],
                      heights_si=[10.0, 20.0, 30.0])
    for i in range(3):
        probe.sample_column(state.u[:, :, 4, 3].numpy() * (i + 1), 0.5 * i, 2.0)
    p = tmp_path / "th.ckpt.npz"
    save_checkpoint(p, state, step=12, avg=avg, avg_samples=1, probes=[probe])

    fresh = GridProbe("p0", x=3, y=4, z_indices=[1, 2, 3],
                      heights_si=[10.0, 20.0, 30.0])
    back, step, avg_back, samples, _ = load_checkpoint(p, probes=[fresh])
    assert (step, samples, avg_back.count) == (12, 1, 1)
    for k in ("fi", "gi", "T", "u"):
        np.testing.assert_array_equal(_codes(getattr(back, k)),
                                      _codes(getattr(state, k)), err_msg=k)
    assert torch.equal(avg_back.mean_T, avg.mean_T)
    assert fresh.times_si == probe.times_si
    np.testing.assert_array_equal(np.stack(fresh.series), np.stack(probe.series))

    jprobe = JaxProbe("p0", x=3, y=4, z_indices=[1, 2, 3],
                      heights_si=[10.0, 20.0, 30.0])
    jback, _, javg, _, _ = jax_load_checkpoint(p, probes=[jprobe])
    for k in ("gi", "T"):
        np.testing.assert_array_equal(_codes(getattr(jback, k)),
                                      _codes(getattr(state, k)), err_msg=k)
    np.testing.assert_array_equal(np.asarray(javg.mean_T), avg.mean_T.numpy())
    np.testing.assert_array_equal(np.stack(jprobe.series), np.stack(probe.series))


def test_jax_split_checkpoint_face_targets_are_not_restored(
        tmp_path, monkeypatch, capsys):
    """The JAX package's split runner pads its FaceBC with ghost rows; the
    port's runners carry the whole domain's without ghosts and refuse that
    shape, so the resumed run prints the JAX package's line and goes on
    from the checkpoint's state (the targets refresh at the next VK
    anchor, as in the JAX package after a change of mesh)."""
    import latticeurbanwind_tpu.lbm.stepper as jax_stepper
    from latticeurbanwind_tpu.run.driver import run_case as jax_run_case
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        checkpoint_path, load_checkpoint, load_fbc,
    )
    from latticeurbanwind_tpu_torch.run.driver import run_case

    # the JAX split runner takes the pallas tier only on a TPU; its
    # interpret mode runs the same kernel on the CPU
    monkeypatch.setattr(jax_stepper, "_pallas_ok", lambda shape, config: True)
    shape = (8, 16, 16)
    parent = _run_dir(tmp_path, "run")
    c1 = _jax_case(parent, 10, ngpu=(1, 2, 2), shape=shape, sponge=True)
    c1.settings.purge_avg = 0
    jax_run_case(c1, quiet=True)
    ck = checkpoint_path(parent, DATETIME)
    fbc = load_fbc(ck)
    assert fbc is not None and tuple(fbc.uw.shape) != (shape[0], 3, shape[1])
    saved, *_ = load_checkpoint(ck)

    capsys.readouterr()
    c2 = _port_case(parent, 20, shape=shape, sponge=True)
    c2.settings.purge_avg = 0
    steps = []
    import latticeurbanwind_tpu_torch.run.driver as driver

    real = driver.make_runner

    def spy(*a, **kw):
        run, name = real(*a, **kw)

        def counted(st, dyn, t0=0, n_steps=1):
            steps.append((t0, n_steps))
            if t0 == 10:     # the first call steps the checkpoint's state
                assert torch.equal(st.fi, saved.fi)
            return run(st, dyn, t0, n_steps)

        counted.__dict__.update(run.__dict__)
        return counted, name

    monkeypatch.setattr(driver, "make_runner", spy)
    resumed = run_case(c2, quiet=False)
    out = capsys.readouterr().out
    assert "| Checkpoint      | face targets not restored (" in out
    assert "they refresh at the next VK anchor" in out
    assert "| Checkpoint      | resumed from step 10" in out
    assert steps[0][0] == 10 and resumed.total_steps == 20
    assert torch.isfinite(resumed.state.u).all()
