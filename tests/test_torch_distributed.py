"""PyTorch port: a split deck whose shards are spread over processes
(`parallel/comm.py`, `parallel/mesh.py`, `parallel/halo.py`), the multi-host
checkpoint writer (`run/checkpoint.py`) and the driver over processes.

Every test that needs several processes spawns two local CPU processes under
the JAX package's environment contract (`LUW_COORDINATOR` or
`COORDINATOR_ADDRESS`, `LUW_NUM_PROCESSES`, `LUW_PROCESS_ID`) on a free local
port, each with one torch thread, as `tests/test_distributed.py` does for
the JAX package; a child that fails or outlives its time kills the others.

  * `ensure_distributed` without the environment, without a process count,
    with a missing peer;
  * the sharded runner over 2 processes, on the plain versions, against the
    single-process runner of the same split, code for code, over the splits
    [1, 1, 2], [1, 2, 2], [2, 1, 2], an uneven split of (7, 21, 45) and a
    thermal case, in f32 and bf16, with the VK inlet on; every process's
    FaceBC after the refresh equal to the others' and the one process's;
  * the same runner against the JAX package's split runner of the same
    inputs at tests/test_torch_halo.py's 1e-6;
  * the checkpoint set of 2 processes: siblings `.p1.s7.npz` then
    `.p1.s9.npz`, the stale one removed only after the main file of step 9
    is committed, and the set loading in both packages to the single-process
    split state;
  * the example profile deck at 24 m split [1, 2, 2] through
    `python -m latticeurbanwind_tpu_torch.cli.run --device cpu` in 2
    processes: its VTKs byte for byte the single-process split run's and
    within tests/test_torch_halo.py's 1e-4 / 2e-4 of the JAX package's run;
    process 1 writes no file; a run killed after its first checkpoint and
    resumed in 2 processes and in 1 process equals the uninterrupted run.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

import test_torch_halo as halo

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CHILD_TIMEOUT_S = 240
STEPS = 4

# key -> (test_torch_halo.CONFIGS name, split, storage, grid or None)
RUNNER_CASES = {
    f"{name}-{'x'.join(map(str, split))}-{storage}": (name, split, storage, shape)
    for name, split, shape in (("forcing+vk", (1, 1, 2), None),
                               ("forcing+vk", (1, 2, 2), None),
                               ("forcing+vk", (2, 1, 2), None),
                               ("forcing+vk", (1, 2, 3), (7, 21, 45)),
                               ("thermal", (1, 2, 2), None))
    for storage in ("f32", "bf16")}
# key -> (split, config keywords, VK hook): tests/test_torch_halo.py's cases
JAX_CASES = {"1x2x2-vk": ((1, 2, 2), {}, True),
             "2x1x2-wall-sides": ((2, 1, 2), halo.SIDES, False)}
CKPT_CASE = ("forcing+vk", (1, 2, 2), "bf16", None)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_or_skip() -> int:
    try:
        return _free_port()
    except OSError:
        pytest.skip("cannot bind a local port")


def _env(port: int, rank: int, n: int = 2, **extra) -> dict:
    env = dict(os.environ)
    env.pop("COORDINATOR_ADDRESS", None)
    env.update(LUW_COORDINATOR=f"127.0.0.1:{port}", LUW_NUM_PROCESSES=str(n),
               LUW_PROCESS_ID=str(rank), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def _spawn(argvs, envs, cwd=None, timeout=CHILD_TIMEOUT_S, check=True):
    """Run the children together; [(returncode, output)] in their order.
    One that outlives `timeout`, or (`check`) fails, kills the others."""
    procs = [subprocess.Popen(a, env=e, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    outs = [None] * len(procs)
    deadline = time.monotonic() + timeout
    try:
        while any(o is None for o in outs):
            for k, p in enumerate(procs):
                if outs[k] is None and p.poll() is not None:
                    outs[k] = p.communicate(timeout=30)[0]
                    if p.returncode and check:
                        raise RuntimeError(f"child {k} exited {p.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError("children timed out")
            time.sleep(0.05)
    except (RuntimeError, TimeoutError) as e:
        for k, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            if outs[k] is None:
                outs[k] = p.communicate(timeout=30)[0]
        raise AssertionError(f"{e}:\n" + "\n".join(
            f"--- child {k} (rc {p.returncode})\n{o}"
            for k, (p, o) in enumerate(zip(procs, outs))))
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _python(code: str):
    return [sys.executable, "-c",
            f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(TESTS)!r}]; {code}"]


def _equal(a, b) -> bool:
    return halo._equal(a, b)


# ------------------------------------------------------ the case inputs


def _inputs(name, storage, shape=None):
    """tests/test_torch_halo.py's case and VK hook of CONFIGS[name]."""
    c = halo.CONFIGS[name]
    cfg, st, frc, dyn = halo._case(shape or c.get("shape", (8, 32, 128)),
                                   storage, seed=c.get("seed", 0),
                                   forcing=c.get("forcing", True),
                                   **c.get("kw", {}))
    return cfg, st, frc, dyn, halo._hook(st) if c.get("hook") else None


def _split_run(cfg, st, frc, dyn, pre, split, steps=STEPS):
    """The sharded runner of `split` on the CPU in this process or over the
    run's processes: `steps` in two calls, then the fields pass; returns
    (the gathered state in process 0, this process's FaceBC)."""
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )

    mesh = domain_mesh(split, tuple(st.rho.shape), "cpu")
    run, impl = make_sharded_runner(cfg, frc, mesh, pre_step=pre,
                                    init_u=st.u, init_T=st.T)
    assert impl == "plain-sharded"
    ss = shard_state(st, mesh)
    half = steps // 2
    ss = run(ss, dyn, 0, half)
    ss = run(ss, dyn, half, steps - half)
    return gather_state(update_fields_sharded(ss, cfg, dyn)), run.get_fbc()


# ---------------------------------------- the children of the runner tests


def _runner_worker() -> None:
    """Both processes: ensure_distributed twice, every RUNNER_CASES and
    JAX_CASES run over the processes, then the checkpoint set; process 0
    saves the gathered states, every process its FaceBC."""
    import torch.distributed as dist

    from latticeurbanwind_tpu_torch.parallel import ensure_distributed

    torch.set_num_threads(1)
    out = Path(os.environ["LUW_OUT"])
    assert ensure_distributed() and ensure_distributed()
    rank = dist.get_rank()
    assert dist.get_world_size() == 2
    for key, (name, split, storage, shape) in RUNNER_CASES.items():
        got, fbc = _split_run(*_inputs(name, storage, shape), split)
        if rank == 0:
            torch.save(got, out / f"{key}.state.pt")
        torch.save(fbc, out / f"{key}.fbc{rank}.pt")
    jax_inputs = torch.load(out / "jax_inputs.pt", weights_only=False)
    for key, (split, _, hook) in JAX_CASES.items():
        cfg, st, frc, dyn = jax_inputs[key]
        got, _ = _split_run(cfg, st, frc, dyn,
                            halo._hook(st) if hook else None, split)
        if rank == 0:
            torch.save(got, out / f"jax-{key}.state.pt")
    _checkpoint_worker(out, rank)
    cols = _probe_columns()
    if rank == 0:
        torch.save(torch.from_numpy(cols), out / "columns.pt")
    else:
        assert cols is None
    print(f"WORKER {rank} OK", flush=True)


PROBE_SPLIT, PROBE_SHAPE = (3, 2, 2), (7, 9, 13)
PROBE_YS, PROBE_XS = (0, 8, 3, 4, 5), (0, 12, 6, 5, 4)


def _probe_state():
    _, st, _, _ = halo._case(PROBE_SHAPE)
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(
        st.u.shape).astype(np.float32))
    return st._replace(u=u)


def _probe_columns():
    """The probe columns of an uneven split over the run's processes: the
    (3, Z, P) array in process 0, None in the others."""
    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.mesh import column_reader

    mesh = domain_mesh(PROBE_SPLIT, PROBE_SHAPE, "cpu")
    return column_reader(mesh, PROBE_YS, PROBE_XS)(
        shard_state(_probe_state(), mesh))


def _checkpoint_worker(out: Path, rank: int) -> None:
    """The sharded runner of CKPT_CASE saving a set at steps 7 and 9 with
    one Welford sample each; process 1 notes, when it removes its stale
    sibling, the step of the main file and which siblings exist."""
    import torch.distributed as dist

    from latticeurbanwind_tpu_torch.parallel import domain_mesh, shard_state
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )
    from latticeurbanwind_tpu_torch.run import checkpoint
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    name, split, storage, _ = CKPT_CASE
    cfg, st, frc, dyn, pre = _inputs(name, storage)
    mesh = domain_mesh(split, tuple(st.rho.shape), "cpu")
    run, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    ss = shard_state(st, mesh)
    avg = tuple(None if s is None else init_avg(tuple(s.rho.shape), False)
                for s in ss.shards)
    ck = out / "set.ckpt.npz"
    seen = {}
    real_gc = checkpoint._gc_siblings

    def gc_spy(path, k, keep):
        with np.load(path) as z:
            step = checkpoint._read_header(z)["step"]
        seen.setdefault("gc", []).append(
            {"main_step": step, "keep": keep, "siblings": sorted(
                p.name for p in path.parent.glob(f"{path.name}.p*"))})
        real_gc(path, k, keep)

    checkpoint._gc_siblings = gc_spy
    t = 0
    for step in (7, 9):
        ss = update_fields_sharded(run(ss, dyn, t, step - t), cfg, dyn)
        avg = tuple(None if s is None else welford_update(a, s)
                    for a, s in zip(avg, ss.shards))
        t = step
        checkpoint.save_checkpoint(ck, ss, step=step, avg=avg,
                                   avg_samples=avg[mesh.local[0]].count,
                                   fbc=run.get_fbc(), meta={"test": 1})
        dist.barrier()
        seen[f"after {step}"] = sorted(p.name for p in out.glob("set.ckpt*"))
    print("CKPT " + json.dumps(seen), flush=True)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both processes of `_runner_worker`, once for the module; process 1
    finds its coordinator through COORDINATOR_ADDRESS."""
    from latticeurbanwind_tpu_torch import convert
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig

    import dataclasses

    port = _port_or_skip()
    out = tmp_path_factory.mktemp("workers")
    inputs = {}
    for key, (_, kw, _) in JAX_CASES.items():
        cfg, state, forcing, dyn = halo._jax_case((8, 32, 128), 2, kw)
        inputs[key] = (StepConfig(**dataclasses.asdict(cfg)),
                       convert.state_from_jax(state),
                       convert.forcing_from_jax(forcing),
                       convert.dyn_from_jax(dyn))
    torch.save(inputs, out / "jax_inputs.pt")
    envs = [_env(port, 0, LUW_OUT=str(out)), _env(port, 1, LUW_OUT=str(out))]
    envs[1]["COORDINATOR_ADDRESS"] = envs[1].pop("LUW_COORDINATOR")
    runs = _spawn([_python("import test_torch_distributed as t; "
                           "t._runner_worker()")] * 2, envs)
    for k, (_, text) in enumerate(runs):
        assert f"WORKER {k} OK" in text, text
    ckpt = [json.loads(line.split("CKPT ", 1)[1]) for _, text in runs
            for line in text.splitlines() if line.startswith("CKPT ")]
    return {"out": out, "ckpt": ckpt}


# ------------------------------------------------- ensure_distributed


def test_ensure_distributed_without_environment_touches_nothing(monkeypatch):
    import torch.distributed as dist

    from latticeurbanwind_tpu_torch.parallel import ensure_distributed

    for k in ("LUW_COORDINATOR", "COORDINATOR_ADDRESS", "LUW_NUM_PROCESSES",
              "LUW_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert ensure_distributed() is False
    assert ensure_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("var", ["LUW_COORDINATOR", "COORDINATOR_ADDRESS"])
def test_coordinator_without_process_count_raises(monkeypatch, var):
    """torch cannot ask the cluster for the process count (JAX can)."""
    import torch.distributed as dist

    from latticeurbanwind_tpu_torch.parallel import ensure_distributed

    for k in ("LUW_COORDINATOR", "COORDINATOR_ADDRESS", "LUW_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(var, "127.0.0.1:1")
    with pytest.raises(ValueError, match="LUW_NUM_PROCESSES"):
        ensure_distributed()
    assert not dist.is_initialized()


def test_missing_peer_fails_within_the_timeout():
    """Process 0 of 2 alone: the set-up fails after LUW_DIST_TIMEOUT
    seconds instead of waiting for its peer for ever."""
    port = _port_or_skip()
    t0 = time.monotonic()
    p = subprocess.run(
        _python("from latticeurbanwind_tpu_torch.parallel import "
                "ensure_distributed; ensure_distributed()"),
        env=_env(port, 0, LUW_DIST_TIMEOUT="3"), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0, p.stdout + p.stderr
    assert time.monotonic() - t0 < 60


def test_more_processes_than_shards_raises(monkeypatch):
    from latticeurbanwind_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "rank_and_size", lambda: (0, 3))
    with pytest.raises(ValueError, match="3 processes .* 2 shards"):
        mesh.domain_mesh((1, 1, 2), (8, 8, 8), "cpu")


def test_shards_are_dealt_in_contiguous_blocks(monkeypatch):
    """Process order, as the JAX mesh lays the global devices: z slabs land
    across processes; "cuda" puts a process's j-th shard on its card j."""
    from latticeurbanwind_tpu_torch.parallel import comm, mesh

    monkeypatch.setattr(mesh, "rank_and_size", lambda: (1, 2))
    monkeypatch.setattr(mesh, "Transport", lambda devices: None)
    m = mesh.domain_mesh((1, 2, 2), (8, 8, 8), "cpu")
    assert m.ranks == (0, 0, 1, 1) and m.local == (2, 3) and m.processes == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = mesh.domain_mesh((1, 2, 3), (9, 8, 8), "cuda")
    assert m.ranks == (0, 0, 0, 1, 1, 1)
    assert m.devices[3:] == (torch.device("cuda", 0), torch.device("cuda", 1),
                             torch.device("cuda", 2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 3 cards in process 1"):
        mesh.domain_mesh((1, 2, 3), (9, 8, 8), "cuda")
    assert comm.rank_and_size() == (0, 1)


# ------------------------------------------------ the runner over processes


@pytest.mark.parametrize("key", list(RUNNER_CASES))
def test_sharded_runner_over_two_processes_equals_one_process(workers, key):
    name, split, storage, shape = RUNNER_CASES[key]
    cfg, st, frc, dyn, pre = _inputs(name, storage, shape)
    want, fbc = _split_run(cfg, st, frc, dyn, pre, split)
    got = torch.load(workers["out"] / f"{key}.state.pt", weights_only=False)
    for k in ("fi", "rho", "u", "flags") + (("gi", "T") if cfg.thermal else ()):
        assert _equal(getattr(got, k), getattr(want, k)), k
    # every process's face targets after the refresh, bit for bit
    fbcs = [torch.load(workers["out"] / f"{key}.fbc{r}.pt", weights_only=False)
            for r in range(2)]
    for k in fbc._fields:
        mine = getattr(fbc, k)
        for other in fbcs:
            theirs = getattr(other, k)
            assert (mine is None) == (theirs is None), k
            assert mine is None or _equal(mine, theirs), k


@pytest.mark.parametrize("key", list(JAX_CASES))
def test_sharded_runner_over_two_processes_matches_jax(workers, key):
    """The JAX package's split runner (interpret mode, the CPU mesh of
    tests/conftest.py) on the same inputs, at its own 1e-6."""
    from latticeurbanwind_tpu.bc.vk_inlet import (
        VkConfig, build_vk_runtime, make_vk_pre_step,
    )
    from latticeurbanwind_tpu.parallel import domain_mesh as jax_mesh
    from latticeurbanwind_tpu.parallel import shard_state as jax_shard
    from latticeurbanwind_tpu.parallel.halo import make_sharded_pallas_runner

    split, kw, hook = JAX_CASES[key]
    cfg, state, forcing, dyn = halo._jax_case((8, 32, 128), 2, kw)
    pre = None
    if hook:
        vcfg = VkConfig(enable=True, ti=0.08, L_lbm=6.0, nmodes=24, seed=7,
                        update_stride=2, stride_interpolation=True)
        rt = build_vk_runtime(vcfg, np.asarray(state.flags), np.asarray(state.u))
        pre = make_vk_pre_step(vcfg, rt, storage=cfg.storage).ddf
    mesh = jax_mesh(split)
    run = make_sharded_pallas_runner(cfg, forcing, state.rho.shape, mesh,
                                     n_inner=STEPS, pre_step=pre,
                                     init_u=state.u, init_T=state.T)
    want = np.asarray(run(jax_shard(state, mesh), dyn, 0).fi)
    got = torch.load(workers["out"] / f"jax-{key}.state.pt", weights_only=False)
    np.testing.assert_allclose(got.fi.numpy(), want, rtol=0, atol=1e-6)


def test_probe_columns_over_two_processes_go_to_process_0(workers):
    """Every column from the shards that own it, whichever process holds
    them (the uneven split's boxes differ along every axis)."""
    want = _probe_state().u[:, :, list(PROBE_YS), list(PROBE_XS)]
    got = torch.load(workers["out"] / "columns.pt", weights_only=False)
    assert torch.equal(got, want)


# ------------------------------------------------- the checkpoint set


def test_checkpoint_set_commits_as_a_set(workers):
    """Siblings `.p1.s7.npz`, then `.p1.s9.npz`; process 1 removes `.s7`
    only once the main file says step 9 (after the commit barrier)."""
    ckpt = workers["ckpt"]
    assert len(ckpt) == 2
    first, second = ckpt
    for seen in ckpt:
        assert seen["after 7"] == ["set.ckpt.npz", "set.ckpt.npz.p1.s7.npz"]
        assert seen["after 9"] == ["set.ckpt.npz", "set.ckpt.npz.p1.s9.npz"]
    assert "gc" not in first
    assert second["gc"] == [
        {"main_step": 7, "keep": 7, "siblings": ["set.ckpt.npz.p1.s7.npz"]},
        {"main_step": 9, "keep": 9, "siblings": ["set.ckpt.npz.p1.s7.npz",
                                                 "set.ckpt.npz.p1.s9.npz"]}]


def test_stale_siblings_go_and_other_processes_siblings_stay(tmp_path):
    """Process 1's clean-up in a set of 12 processes: its stale step tag
    and its legacy untagged file go; processes 10 and 11 (`.p10.`, `.p11.`)
    and its own new tag stay."""
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        _gc_siblings, _sibling_path,
    )

    path = tmp_path / "set.ckpt.npz"
    path.write_bytes(b"main")
    stale = [_sibling_path(path, 1, 7), _sibling_path(path, 1)]
    kept = [_sibling_path(path, k, step) for k in range(1, 12)
            for step in (7, 9) if (k, step) != (1, 7)]
    for f in stale + kept:
        f.write_bytes(b"x")
    _gc_siblings(path, 1, 9)
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [path.name] + [f.name for f in kept])


def _ckpt_reference():
    """The single-process split run of the checkpoint case to step 9 with
    its two Welford samples."""
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import (
        make_sharded_runner, update_fields_sharded,
    )
    from latticeurbanwind_tpu_torch.parallel.mesh import gather_tensors
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    name, split, storage, _ = CKPT_CASE
    cfg, st, frc, dyn, pre = _inputs(name, storage)
    mesh = domain_mesh(split, tuple(st.rho.shape), "cpu")
    run, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    ss = shard_state(st, mesh)
    avg = [init_avg(tuple(s.rho.shape), False) for s in ss.shards]
    t = 0
    for step in (7, 9):
        ss = update_fields_sharded(run(ss, dyn, t, step - t), cfg, dyn)
        avg = [welford_update(a, s) for a, s in zip(avg, ss.shards)]
        t = step
    means = {k: gather_tensors([getattr(a, k) for a in avg], mesh)
             for k in ("mean_u", "m2_u", "mean_rho")}
    return gather_state(ss), means, run.get_fbc()


def test_checkpoint_set_loads_in_both_packages(workers):
    from latticeurbanwind_tpu.run.checkpoint import (
        load_checkpoint as jax_load,
    )
    from latticeurbanwind_tpu_torch.run.checkpoint import (
        load_checkpoint, load_fbc,
    )

    ck = workers["out"] / "set.ckpt.npz"
    want, means, fbc = _ckpt_reference()
    st, step, avg, samples, meta = load_checkpoint(ck, expect_shape=(8, 32, 128))
    assert (step, samples, meta, avg.count) == (9, 2, {"test": 1}, 2)
    for k in ("fi", "rho", "u", "flags"):
        assert _equal(getattr(st, k), getattr(want, k)), k
    for k, v in means.items():
        assert torch.equal(getattr(avg, k), v), k
    saved = load_fbc(ck)
    for k in ("uw", "ue", "us", "un", "ut", "ub"):
        assert torch.equal(getattr(saved, k), getattr(fbc, k)), k
    jst, jstep, javg, jsamples, _ = jax_load(ck, expect_shape=(8, 32, 128))
    assert (jstep, jsamples, javg.count) == (9, 2, 2)
    np.testing.assert_array_equal(
        np.asarray(jst.fi).view(np.int16), want.fi.view(torch.int16).numpy())
    for k in ("rho", "u", "flags"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, k)),
                                      getattr(want, k).numpy(), err_msg=k)
    for k, v in means.items():
        np.testing.assert_array_equal(np.asarray(getattr(javg, k)), v.numpy(),
                                      err_msg=k)


# ---------------------------------------------- the deck over processes


_RECORD = """
import builtins, io, json, os, runpy, sys
import torch
torch.set_num_threads(1)
written = []
real_open, real_replace = builtins.open, os.replace

def spy_open(file, mode="r", *a, **kw):
    if any(c in mode for c in "wax+"):
        written.append(str(file))
    return real_open(file, mode, *a, **kw)

def spy_replace(src, dst, *a, **kw):
    written.append(str(dst))
    return real_replace(src, dst, *a, **kw)

builtins.open = io.open = spy_open
os.replace = spy_replace
{patch}
sys.argv = ["runluw-torch", {deck!r}, "--device", "cpu"]
try:
    runpy.run_module("latticeurbanwind_tpu_torch.cli.run", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
finally:
    print("WRITTEN " + json.dumps(written), flush=True)
"""

# every run_case with a checkpoint every 20 steps; KILL: the process ends
# once its first checkpoint is saved, as a killed run would
_CHECKPOINTS = """
import latticeurbanwind_tpu_torch.run.modes as modes
import latticeurbanwind_tpu_torch.run.driver as driver
real_run = modes.run_case

def run_spy(case, **kw):
    case.settings.checkpoint_interval = 20
    return real_run(case, **kw)

modes.run_case = run_spy
"""
_KILL = """
real_save = driver.save_checkpoint

def save_and_die(*a, **kw):
    real_save(*a, **kw)
    print("WRITTEN " + json.dumps(written), flush=True)
    os._exit(0)

driver.save_checkpoint = save_and_die
"""


def _deck_in_two_processes(deck: Path, patch: str = ""):
    """The deck through the port's `cli.run --device cpu` in 2 processes;
    the files each process opened for writing."""
    port = _port_or_skip()
    code = _RECORD.format(patch=patch, deck=str(deck))
    runs = _spawn([[sys.executable, "-c", code]] * 2,
                  [_env(port, r) for r in range(2)], cwd=deck.parent)
    return [json.loads(next(line for line in text.splitlines()[::-1]
                            if line.startswith("WRITTEN "))[8:])
            for _, text in runs], [text for _, text in runs]


def _vtks(root: Path) -> dict:
    return {p.name: p for p in (root / "RESULTS" / "vtk").glob("*.vtk")}


def test_split_deck_over_two_processes(tmp_path, capsys):
    """Byte for byte the single-process split run's VTKs, within 1e-4 and
    2e-4 of the JAX package's (which cannot split 27 rows in two, so it
    runs unsplit, as for the uneven splits of tests/test_torch_halo.py);
    process 1 writes no file."""
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    two = halo._deck_copy(tmp_path / "two", "[1, 2, 2]")
    written, texts = _deck_in_two_processes(two)
    assert "data over gloo" in texts[0] and "process 1 of 2" in texts[1]
    assert written[1] == []
    assert any(w.endswith(".vtk") for w in written[0])
    one = run_deck(halo._deck_copy(tmp_path / "one", "[1, 2, 2]"),
                   device="cpu", quiet=True)
    jax = jax_run_deck(halo._deck_copy(tmp_path / "jax", "[1, 1, 1]"),
                       impl="pallas", quiet=True)
    got, same = _vtks(two.parent), {f.name: f for f in one[0].files
                                    if f.suffix == ".vtk"}
    want = {f.name: f for r in jax for f in r.files if f.suffix == ".vtk"}
    assert sorted(got) == sorted(same) == sorted(want) and len(got) == 4
    for name in sorted(got):
        assert got[name].read_bytes() == same[name].read_bytes(), name
        _, fg = read_structured_points(got[name])
        _, fw = read_structured_points(want[name])
        if "_avg-" not in name:
            np.testing.assert_allclose(fg["data"], fw["data"], rtol=0,
                                       atol=1e-4, err_msg=name)
            continue
        fluid = fw["fluid"] > 0.5
        for key in ("u_avg", "rho_avg", "tke"):
            np.testing.assert_allclose(fg[key][..., fluid], fw[key][..., fluid],
                                       rtol=0, atol=2e-4, err_msg=f"{name}:{key}")


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """The split deck in 2 processes, killed after its first checkpoint
    (step 20 of 40): (its deck, the files each process wrote)."""
    deck = halo._deck_copy(tmp_path_factory.mktemp("killed") / "deck",
                           "[1, 2, 2]")
    written, _ = _deck_in_two_processes(deck, _CHECKPOINTS + _KILL)
    return deck, written


def test_killed_split_deck_resumes_in_two_and_in_one_process(tmp_path, killed,
                                                             monkeypatch):
    """Killed after its first checkpoint, the 2-process run resumes from
    the set in 2 processes and in 1, each to VTKs byte for byte the
    uninterrupted run's; the killed run's process 1 wrote its sibling and
    nothing else."""
    import latticeurbanwind_tpu_torch.run.modes as modes
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    whole = run_deck(halo._deck_copy(tmp_path / "whole", "[1, 2, 2]"),
                     device="cpu", quiet=True)
    want = {f.name: f.read_bytes() for f in whole[0].files if f.suffix == ".vtk"}
    killed, written = killed
    ckpts = killed.parent / "proj_temp" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "20260101120000.ckpt.npz", "20260101120000.ckpt.npz.p1.s20.npz"]
    assert [Path(w).name for w in written[1]] == [
        "20260101120000.ckpt.npz.p1.s20.tmp.npz",
        "20260101120000.ckpt.npz.p1.s20.npz"]
    resumed = {}
    for n in (2, 1):
        root = tmp_path / f"resumed{n}"
        shutil.copytree(killed.parent, root)
        if n == 2:
            _, texts = _deck_in_two_processes(root / "conf.luwpf", _CHECKPOINTS)
            assert "resumed from step 20" in texts[0], texts[0]
        else:
            real_run = modes.run_case

            def run_spy(case, **kw):
                case.settings.checkpoint_interval = 20
                return real_run(case, **kw)

            monkeypatch.setattr(modes, "run_case", run_spy)
            run_deck(root / "conf.luwpf", device="cpu", quiet=True)
        resumed[n] = {k: v.read_bytes() for k, v in _vtks(root).items()}
    assert sorted(resumed[2]) == sorted(resumed[1]) == sorted(want)
    for n, got in resumed.items():
        for name in want:
            assert got[name] == want[name], (n, name)


def test_processes_that_disagree_on_the_resume_point_raise(tmp_path, killed):
    """Process 0 finds the checkpoint set, process 1 (in a copy of the deck
    without it) none: both stop before any step instead of posting
    different steps' halos to each other."""
    deck, _ = killed
    roots = [tmp_path / "with", tmp_path / "without"]
    shutil.copytree(deck.parent, roots[0])
    shutil.copytree(deck.parent, roots[1])
    shutil.rmtree(roots[1] / "proj_temp" / "checkpoints")
    port = _port_or_skip()
    runs = _spawn([[sys.executable, "-c", _RECORD.format(
        patch=_CHECKPOINTS, deck=str(r / "conf.luwpf"))] for r in roots],
        [_env(port, r) for r in range(2)], cwd=tmp_path, check=False)
    for rc, text in runs:
        assert rc != 0, text
        assert "disagree on the resume point" in text, text
        assert "[(20, 0, True), (0, 0, False)]" in text, text
