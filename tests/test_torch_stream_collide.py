"""PyTorch port: the stream-collide step (plain version of K-SC) against the
JAX package's reference step and its Pallas kernel.

The case mirrors tests/test_pallas_kernel.py::_mk_case: the LUW shell (all
outer faces TYPE_E, solid ground), solid blocks, buffer nudging and the top
sponge, a global force and Coriolis.  Inputs come from one numpy seed and
cross to the port bit for bit through `convert`.  Tolerances are the JAX
kernel's own against its reference (test_pallas_kernel.py): 6e-6 for f32,
2e-4 for bf16 and 2e-5 for the decoded f16 and fp16c storages after 5 steps.  Both port and Pallas kernel freeze the
TYPE_E cells, where the reference re-evaluates feq with the force half-step;
the gap stays inside those tolerances.
"""

import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


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


def _decoded(fi, storage):
    """Stored DDFs as fp32 values (the JAX package's decode_ddf)."""
    from latticeurbanwind_tpu.lbm.state import decode_ddf

    return np.asarray(decode_ddf(fi, storage)).astype(np.float32)


@pytest.mark.parametrize("volume_force", [True, False])
@pytest.mark.parametrize("shape,storage,atol", [
    ((8, 32, 128), "f32", 6e-6),
    ((7, 21, 45), "f32", 6e-6),
    ((8, 32, 128), "bf16", 2e-4),
    ((7, 21, 45), "bf16", 2e-4),
    ((8, 32, 128), "f16", 2e-5),
    ((7, 21, 45), "f16", 2e-5),
    ((8, 32, 128), "fp16c", 2e-5),
    ((7, 21, 45), "fp16c", 2e-5),
])
def test_plain_step_matches_jax_reference(shape, storage, atol, volume_force):
    cfg, state, forcing, dyn = _mk_case(shape, storage)
    if not volume_force:
        cfg, forcing, dyn = _flagship(cfg, state)
    got = _port_plain_steps(cfg, state, forcing, dyn)
    want = _reference_steps(cfg, state, forcing, dyn)
    np.testing.assert_allclose(_decoded(got, storage), _decoded(want, storage),
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


_WALL = dict(wall_model=True, wall_cd=0.0134)
_SIDES = dict(_WALL, wall_sides=True, wall_cd_sides=0.004)
_TRT = dict(collision="trt")
_CONFIGS = {"wall": _WALL, "wall+sides": _SIDES, "trt": _TRT,
            "trt+wall+sides": dict(_TRT, **_SIDES)}


@pytest.mark.parametrize("shape,storage,atol,name", [
    *[(shape, "f32", 1e-5, name) for shape in ((8, 32, 128), (7, 21, 45))
      for name in _CONFIGS],
    *[((7, 21, 45), storage, atol, name)
      for storage, atol in (("bf16", 2e-4), ("fp16c", 2e-5))
      for name in ("wall+sides", "trt")],
])
def test_plain_wall_and_trt_steps_match_jax_reference(shape, storage, atol,
                                                      name):
    """The wall models (K4: ground specular + Schumann stress, the vertical
    faces' mirrors + side stress) and TRT (K2) against JAX `make_step`.
    1e-5 for f32 is the JAX kernel's own wall-model tolerance
    (test_pallas_kernel.py: the near-wall |u_h| u_h force reorders fp32
    sums); the coded storages keep their 2e-4 and 2e-5."""
    cfg, state, forcing, dyn = _mk_case(shape, storage)
    cfg = dataclasses.replace(cfg, **_CONFIGS[name])
    got = _port_plain_steps(cfg, state, forcing, dyn)
    want = _reference_steps(cfg, state, forcing, dyn)
    np.testing.assert_allclose(_decoded(got, storage), _decoded(want, storage),
                               atol=atol)


@pytest.mark.parametrize("name", ["wall+sides", "trt+wall+sides"])
def test_plain_wall_and_trt_steps_match_jax_pallas_kernel(name):
    """The same against the Pallas kernel in interpret mode, f32, at
    (8, 32, 128)."""
    import jax

    from latticeurbanwind_tpu.ops.stream_collide import (
        make_pallas_step, merge_state, split_state,
    )

    shape = (8, 32, 128)
    cfg, state, forcing, dyn = _mk_case(shape, "f32")
    cfg = dataclasses.replace(cfg, **_CONFIGS[name])
    pstep = make_pallas_step(cfg, forcing, shape)

    def pal_run(st, d):
        s = split_state(st, with_fbc=True)
        for _ in range(5):
            s = pstep(s, d)
        return merge_state(s)

    want = np.asarray(jax.jit(pal_run)(state, dyn).fi)
    got = _port_plain_steps(cfg, state, forcing, dyn)
    np.testing.assert_allclose(got, want, atol=1e-5)


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
    (dict(collision="trt"), None),
    (dict(wall_model=True, wall_cd=0.01), None),
    (dict(wall_model=True, wall_cd=0.01, wall_sides=True), None),
    (dict(thermal=True, omega_t=1.2), None),
    (dict(storage="f16"), None),
    (dict(storage="fp16c"), None),
    (dict(), None),
])
def test_wrapper_refuses_unported_configs(change, item):
    """Nothing single-device is refused any more: TRT (K2), the wall models
    (K4), the f16/fp16c storages (K5), the VK inlet sites (K6, the last
    case) and thermal (K7, with g at rest) are taken: a rest state stays at
    rest, except the west lane, whose site writes feq(rho=1, u_west)."""
    from latticeurbanwind_tpu_torch.lbm.state import (
        Forcing, StepConfig, decode_ddf, encode_ddf, storage_dtype,
    )
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, feq_vk, stream_collide,
    )

    cfg = StepConfig(omega=1.5, **change)
    shape = (4, 8, 8)
    fi = torch.zeros((19, *shape), dtype=storage_dtype(cfg.storage))
    flags = torch.zeros(shape, dtype=torch.uint8)
    vk = fbc = None
    if not change:
        u = torch.zeros((3, *shape))
        u[0, :, :, 0] = 0.05
        fbc = build_face_bc(u)
        vk = {"sites": (("lane0", "uw"),),
              "masks": {"uw": torch.ones((shape[0], 1, shape[1]))}}
    assert item is None
    gi = torch.zeros((7, *shape), dtype=fi.dtype) if cfg.thermal else None
    g_out = torch.ones_like(gi) if cfg.thermal else None
    out = stream_collide(fi, flags, torch.zeros(8), cfg, Forcing(), fbc, vk=vk,
                         gi=gi, gi_out=g_out)
    if cfg.thermal:
        assert not bool(g_out.any())
    out = decode_ddf(out, cfg.storage)
    assert out.shape == (19, *shape) and bool(torch.isfinite(out).all())
    want = torch.zeros_like(out)
    if vk is not None:
        zero = torch.zeros(shape[:2])
        fe = torch.stack(feq_vk(torch.full(shape[:2], 0.05), zero, zero))
        want[:, :, :, 0] = decode_ddf(encode_ddf(fe, cfg.storage), cfg.storage)
        assert float(want.abs().max()) > 1e-3
    torch.testing.assert_close(out, want, rtol=0, atol=0)


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
    assert [p.name for p in cuda_build.sources()] == [
        "avg_update.cu", "codec.cu", "stream_collide.cu",
        "stream_collide_halo.cu", "stream_collide_halo_thermal.cu",
        "stream_collide_thermal.cu", "stream_collide_wall.cu"]
    assert [p.name for p in cuda_build.headers()] == [
        "codec.cuh", "lattice.cuh", "stream_collide.cuh",
        "stream_collide_tiled.cuh", "thermal.cuh"]


def test_kernel_build_compiles_translation_units_only(monkeypatch, tmp_path):
    """nvcc (faked) gets one compile per `.cu`, each with -I csrc, and one
    link of the objects; no header is a compilation input.  The digest
    covers the headers: editing one names a new library."""
    import shutil

    from latticeurbanwind_tpu_torch.utils import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "fake-nvcc")
    calls = []

    def fake_run(cmd, capture_output=True, text=True):
        calls.append(list(cmd))
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "ok\n", "")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    lib, log = cuda_build.build()
    assert lib.exists() and lib.name == f"libluwtorch_{cuda_build.source_digest()}.so"
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1 and len(compiles) == len(cuda_build.sources())
    assert sorted(Path(c[-1]).name for c in compiles) == [
        p.name for p in cuda_build.sources()]
    for c in compiles:
        assert c[c.index("-I") + 1] == str(csrc)
    assert not any(a.endswith(".cuh") for c in calls for a in c)
    assert all(a.endswith(".o") for a in links[0][links[0].index("-o") + 2:])
    assert not list((tmp_path / "_build").glob("*.obj"))   # objects cleaned up

    digest = cuda_build.source_digest()
    (csrc / "codec.cuh").write_text((csrc / "codec.cuh").read_text() + "\n// edit\n")
    assert cuda_build.source_digest() != digest
    calls.clear()
    lib2, _ = cuda_build.build()
    assert lib2 != lib and len(calls) == len(cuda_build.sources()) + 1


def test_extra_nvcc_flags_reach_every_compile_and_the_digest(monkeypatch,
                                                            tmp_path):
    """$LUW_NVCC_FLAGS (how a variant of a compile-time choice is built)
    reaches every compile and not the link, and the flags and the content of
    a file they name enter the digest: another variant names another
    library."""
    import shutil

    from latticeurbanwind_tpu_torch.utils import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "fake-nvcc")
    calls = []

    def fake_run(cmd, capture_output=True, text=True):
        calls.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "ok\n", "")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    monkeypatch.delenv("LUW_NVCC_FLAGS", raising=False)
    plain = cuda_build.source_digest()
    variant = tmp_path / "variant.h"
    variant.write_text("#define LUW_TILE_THERMAL 128, 1, 4, 4, 0\n")
    monkeypatch.setenv("LUW_NVCC_FLAGS", f" -include  {variant} ")
    assert cuda_build.extra_flags() == ["-include", str(variant)]
    digest = cuda_build.source_digest()
    assert digest != plain
    lib, _ = cuda_build.build()
    assert lib.name == f"libluwtorch_{digest}.so"
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == len(cuda_build.sources()) and len(links) == 1
    for c in compiles:
        i = c.index("-include")
        assert c[i + 1] == str(variant) and i < c.index("-c")
    assert "-include" not in links[0]
    variant.write_text("#define LUW_TILE_THERMAL 64, 2, 8, 4, 0\n")
    assert cuda_build.source_digest() not in (plain, digest)


# Every direction table the kernels hold (local arrays in each function, so
# that the unrolled loops fold each lookup), by name and length.
_TABLES = ("CX[19]", "CY[19]", "CZ[19]", "OPP[19]", "MX[19]", "MY[19]",
           "MZ[19]", "CZ[7]", "OPP[7]", "CX7[7]", "CY7[7]", "CZ7[7]")


def _csrc_tables() -> dict:
    """{"NAME[n]": [(file, values), ...]}: every `const int NAME[n] = {...}`
    with an upper-case name in the kernels' sources."""
    import re

    from latticeurbanwind_tpu_torch.utils import cuda_build

    out = {}
    for p in cuda_build.sources() + cuda_build.headers():
        for m in re.finditer(r"const int ([A-Z]\w*)\[(\d+)\] = \{([^}]*)\}",
                             p.read_text()):
            out.setdefault(f"{m.group(1)}[{m.group(2)}]", []).append(
                (p.name, [int(v) for v in m.group(3).split(",")]))
    return out


def _lattice_table(name: str) -> list:
    """The table `name` from lbm/lattice.py (the mirrors' None as -1)."""
    from latticeurbanwind_tpu_torch.lbm import lattice as L

    base, n = name.rstrip("]").split("[")
    c = L.C19 if n == "19" else L.C7
    axis = {"X": 0, "Y": 1, "Z": 2}
    if base.startswith("C"):
        return [int(v) for v in c[:, axis[base[1]]]]
    if base == "OPP":
        return [int(v) for v in (L.OPP19 if n == "19" else L.OPP7)]
    mirror = {"MX": L.MIR_X, "MY": L.MIR_Y, "MZ": L.MIR_Z}[base]
    return [-1 if m is None else m for m in mirror]


@pytest.mark.parametrize("table", _TABLES)
def test_every_copy_of_a_direction_table_matches_the_lattice(table):
    """Each copy of a direction table in csrc/ -- the velocities, the
    opposites and the wall models' mirrors, which solid_source_pick (the
    tiled body and K-AVG) holds -- equals lbm/lattice.py's, so the copies
    cannot drift apart."""
    copies = _csrc_tables()[table]
    want = _lattice_table(table)
    assert copies
    for name, values in copies:
        assert values == want, (table, name)


def test_no_direction_table_in_the_kernels_goes_unchecked():
    assert set(_csrc_tables()) == set(_TABLES)


def _function_body(name: str) -> str:
    """The body of the device function `name` in csrc/lattice.cuh."""
    from latticeurbanwind_tpu_torch.utils import cuda_build

    text = (cuda_build.CSRC_DIR / "lattice.cuh").read_text()
    i = text.index("{", text.index(f" {name}(", text.index("__device__")))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(name)


def _plain_source(fn) -> str:
    import inspect

    return inspect.getsource(fn)


@pytest.mark.parametrize("pair", [
    ("pull", "solid_source_pick"),
    ("pull", "solid_source_pick", "planes"),
    ("wall_stress", "wall_stress_at")])
def test_wall_model_helpers_take_the_same_choices(pair):
    """The kernels' wall-model helpers (csrc/lattice.cuh, taken by the tiled
    body and K-AVG) make the choices of the plain version
    (lbm/fields.py): solid_source_pick takes the mirrors of `pull` under the
    same conditions (the wall mode, and the direction having that mirror)
    in the same priority (`pull`'s later select wins), each partner's
    solidity tested at the cell `pull` rolls it from; wall_stress_at applies
    `wall_stress`'s arithmetic under the same conditions at the same
    neighbours.  "planes": each partner's plane as `at(channel, cell,
    plane)` names it -- the ground partner and the bounce-back element in
    the cell's own plane (0), the face partners in the source's (-cz), which
    in a halo-mode slab (K8) may be a halo plane -- and the tiled body's
    halo instances pass it their halo accessor, K-AVG the plain one."""
    import re

    from latticeurbanwind_tpu_torch.lbm import fields
    from latticeurbanwind_tpu_torch.lbm import lattice as L
    from latticeurbanwind_tpu_torch.utils import cuda_build

    plain = _plain_source(getattr(fields, pair[0]))
    body = _function_body(pair[1])
    # the plain version's roll shift (cx, cy, cz) reads the cell at
    # (dz, dy, dx) = (-cz, -cy, -cx), as the kernels name it
    neg = {"0": "0", "cx": "-CX[d]", "cy": "-CY[d]", "cz": "-CZ[d]",
           "1": "-1", "-1": "1"}

    def cell(shift):
        x, y, z = (v.strip() for v in shift.split(","))
        return ", ".join(neg[v] for v in (z, y, x))

    if pair[0] == "pull":
        # (mirror, wall condition, partner cell) in pull's order of selects
        sel = re.findall(r"\(MIR_([XYZ])\[d\], \(([^)]*)\), wall ([=>]=) (\d)\)",
                         plain)
        assert len(sel) == 3
        want = [(f"M{m}", f"kWall {op} {k}", cell(sh))
                for m, sh, op, k in reversed(sel)] + [("OPP", None, None)]
        tests = re.findall(r"if \((kWall [=>]= \d) && C[XYZ]\[d\] [!=]= \d+\) "
                           r"\{\s*const I p = src \+ \w+;\s*"
                           r"if \(!solid\(p, ([^)]*)\)\) return "
                           r"at\((M[XYZ])\[d\]", body)
        got = [(m, cond, where) for cond, where, m in tests]
        got.append(("OPP", None, None) if re.search(
            r"return at\(OPP\[d\], n, 0\);\s*\}$", body) else None)
        assert got == want
        # the direction tests: a direction has the mirror exactly where the
        # helper's test on its velocity lets it look
        dir_tests = {m: t for t, m in re.findall(
            r"&& (C[XYZ]\[d\] [!=]= \d+)\) \{\s*const I p = src \+ \w+;"
            r"\s*if \([^)]*\)\) return at\((M[XYZ])\[d\]", body)}
        for m, mirror in (("MX", L.MIR_X), ("MY", L.MIR_Y), ("MZ", L.MIR_Z)):
            axis, op, val = re.fullmatch(r"C([XYZ])\[d\] ([!=]=) (\d+)",
                                         dir_tests[m]).groups()
            c = [int(v) for v in L.C19[:, "XYZ".index(axis)]]
            admits = [(v != int(val)) if op == "!=" else (v == int(val))
                      for v in c]
            assert admits == [mm is not None for mm in mirror], m
        if pair[2:] == ("planes",):
            got = re.findall(r"at\((MZ|MX|MY|OPP)\[d\], \w+, ([^)]*)\)", body)
            want = [(f"M{m}", cell(sh).split(", ")[0])
                    for m, sh, _, _ in reversed(sel)] + [("OPP", "0")]
            assert len(got) == 4 and got == want
            tiled = (cuda_build.CSRC_DIR / "stream_collide_tiled.cuh").read_text()
            assert re.search(r"solid_source_pick<kWall>\(\s*\[&\]\([^)]*\) "
                             r"\{[^}]*\},\s*at_halo, d,", tiled)
            avg = (cuda_build.CSRC_DIR / "avg_update.cu").read_text()
            assert re.search(r"solid_source_pick<kWall>\(\s*\[&\]\([^)]*\) "
                             r"\{[^}]*\},\s*at, d,", avg)
        return

    # wall_stress: the neighbours read, in order
    want = [cell(sh) for sh in re.findall(r"_roll\(solid, \(([^)]*)\)\)", plain)]
    got = re.findall(r"flag_at\(([^)]*)\)", body)
    assert len(want) == 5 and got == want
    # the conditions: the ground stress with any wall model, the side stress
    # with wall_sides and a positive Cd_sides
    assert re.findall(r"if (config\.\w+(?: and config\.wall_cd_sides > 0\.0)?):",
                      plain) == ["config.wall_model",
                                 "config.wall_sides and config.wall_cd_sides > 0.0"]
    assert re.findall(r"if \((kWall [=>]= \d(?: && cd_sides > 0\.0f)?)\)",
                      body) == ["kWall == 0", "kWall == 2 && cd_sides > 0.0f"]

    def py(expr):
        for i, a in enumerate("xyz"):
            expr = expr.replace(f"u[{i}]", f"u{a}")
        return expr

    roots = {k: py(v) for k, v in
             re.findall(r"(\w+) = torch\.sqrt\(([^)]*)\)", plain)}
    # the stress coefficients: (name, Cd, |u_t|'s squares)
    want = [(n, cd.replace("wall_", ""), roots[r]) for n, cd, r in
            re.findall(r"(cw\w*) = config\.(wall_cd\w*) \* g\w \* rho \* (\w+)",
                       plain)]
    got = re.findall(r"const float (cw\w*) = (?:g\w \? )?(cd\w*) \* rho \* "
                     r"sqrtf\(([^)]*)\)", body)
    assert len(want) == 3 and got == want
    # the force updates
    want = [(f"F{'xyz'[int(i)]}", py(e)) for i, e in
            re.findall(r"F\[(\d)\] = F\[\d\] - ([^\n]*)", plain)]
    got = re.findall(r"(F[xyz]) -= ([^;]*);", body)
    assert len(want) == 5 and got == want


def _tile_shapes() -> dict:
    """{family: (tx, ty, kz, min_blocks, prefetch)} as the tiled body defines
    them (LUW_TILE_*), and its shared-memory constants."""
    import re

    from latticeurbanwind_tpu_torch.utils import cuda_build

    text = (cuda_build.CSRC_DIR / "stream_collide_tiled.cuh").read_text()
    shapes = {m.group(1): tuple(int(v) for v in m.group(2).split(","))
              for m in re.finditer(r"#define LUW_TILE_(\w+) ([\d, ]+)\n", text)}
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (kSmem\w+) = (\d+);", text)}
    return shapes, consts


@pytest.mark.parametrize("family", ["THERMAL", "THERMAL_F32", "OTHER", "PLAIN",
                                    "PLAIN_F32_FP16C", "AVG", "AVG_WALL",
                                    "PLAIN_PAIR"])
def test_every_tile_shape_fits_its_rings_and_the_sm(family):
    """Each family's compile-time shape (stream_collide_tiled.cuh's
    LUW_TILE_*; AVG, AVG_WALL: K-AVG's without and with a wall model,
    avg_update.cu; PLAIN_PAIR: the paired instance, two cells per thread
    along x) keeps tile_ok's rules -- the
    flag ring's words and plain bytes each have a thread (the paired
    instance's ring is that of its 2 tx x ty cells, and a warp lies in one
    row) -- and its flag
    ring of three planes with their row shifts (static shared memory; the
    paired instance's 2 tx + 2 columns wide) fits
    a block's 48 KB, and min_blocks blocks of it, with the 1 KB each that
    the system keeps, fit the SM's 228 KB."""
    shapes, consts = _tile_shapes()
    assert set(shapes) == {"THERMAL", "THERMAL_F32", "OTHER", "PLAIN",
                           "PLAIN_F32_FP16C", "AVG", "AVG_WALL", "PLAIN_PAIR"}
    assert consts == {"kSmemStatic": 49152, "kSmemPerSm": 233472,
                      "kSmemReserved": 1024}
    tx, ty, kz, min_blocks, prefetch = shapes[family]
    threads = tx * ty
    assert tx >= 4 and tx % 4 == 0 and ty >= 1 and kz >= 1
    assert min_blocks >= 1 and prefetch >= 0
    assert threads <= 1024 and threads % 32 == 0
    if family == "PLAIN_PAIR":
        assert tx % 32 == 0 and prefetch == 0
        tx = 2 * tx    # the cells a row of the tile covers
    assert (ty + 2) * (tx // 4) <= threads and (ty + 2) * 8 <= threads
    ring = 3 * ((ty + 2) * (tx + 8) + ty + 2)
    assert ring <= consts["kSmemStatic"]
    assert min_blocks * (ring + consts["kSmemReserved"]) <= consts["kSmemPerSm"]


_PAIR_CASES = {
    "bf16": (dict(storage="bf16"), {}, True),
    "f16": (dict(storage="f16"), {}, True),
    "bf16 no volume force": (dict(storage="bf16", volume_force=False), {},
                             True),
    "bf16 nudge": (dict(storage="bf16"), dict(nudge=True), True),
    "f32": (dict(storage="f32"), {}, False),
    "fp16c": (dict(storage="fp16c"), {}, False),
    "wall model": (dict(storage="bf16", wall_model=True, wall_cd=0.01), {},
                   False),
    "wall_sides": (dict(storage="f16", wall_model=True, wall_cd=0.01,
                        wall_sides=True), {}, False),
    "trt": (dict(storage="bf16", collision="trt"), {}, False),
    "thermal": (dict(storage="bf16", thermal=True, omega_t=1.2), {}, False),
    "halo": (dict(storage="bf16"), dict(halo=True), False),
    "odd X": (dict(storage="bf16"), dict(X=9), False),
    "misaligned DDFs": (dict(storage="bf16"), dict(offset=1), False),
}


@pytest.mark.parametrize("case", sorted(_PAIR_CASES))
def test_paired_instance_takes_plain_two_byte_steps_with_even_x(case,
                                                                monkeypatch):
    """The wrapper's `paired_step` (the entry point's `pair_step`) picks
    K-SC's paired instance for the plain family (no wall model, SRT, not
    thermal, not halo mode) in bf16 and f16 with X even and aligned words,
    and for nothing else; `count_launch` (the bookkeeping of every CUDA
    step) counts exactly those steps in `stream_collide.launches_pair`,
    beside `.launches`."""
    from latticeurbanwind_tpu_torch.lbm.forcing import NudgeSpec, build_forcing
    from latticeurbanwind_tpu_torch.lbm.state import (
        Forcing, StepConfig, ZHalo, storage_dtype,
    )
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        count_launch, paired_step, stream_collide,
    )

    change, how, want = _PAIR_CASES[case]
    cfg = StepConfig(omega=1.5, **change)
    Z, Y, X = 4, 6, how.get("X", 8)
    dtype = storage_dtype(cfg.storage)
    offset = how.get("offset", 0)
    fi = torch.zeros(19 * Z * Y * X + offset, dtype=dtype)[offset:].view(
        19, Z, Y, X)
    out = torch.zeros((19, Z, Y, X), dtype=dtype)
    flags = torch.zeros((Z, Y, X), dtype=torch.uint8)
    forcing = (build_forcing((Z, Y, X), nudge=NudgeSpec(n_cells=2,
                                                       inv_tau=0.02))
               if how.get("nudge") else Forcing())
    halo = None
    if how.get("halo"):
        plane = torch.zeros((5, Y, X), dtype=dtype)
        fl = torch.zeros((Y, X), dtype=torch.uint8)
        halo = ZHalo(fp=plane, fm=plane, flb=fl, fla=fl)
    got = paired_step(fi, out, flags, cfg, forcing, halo)
    assert got is want
    for name in ("launches", "launches_vk", "launches_wall",
                 "launches_thermal", "launches_halo", "launches_pair"):
        monkeypatch.setattr(stream_collide, name, 0)
    for _ in range(3):
        count_launch(cfg, None, halo, got)
    assert stream_collide.launches == 3
    assert stream_collide.launches_pair == (3 if want else 0)
    assert stream_collide.launches_halo == (3 if halo is not None else 0)
    assert stream_collide.launches_thermal == (3 if cfg.thermal else 0)
    assert stream_collide.launches_wall == (3 if cfg.wall_model else 0)


def test_the_paired_instance_and_its_entry_agree_on_the_storages():
    """The kernels' paired codecs (`kPairCodec`: bf16 and f16, the 2-byte
    storages the card converts in hardware) and the wrapper's
    `PAIRED_STORAGES` are the same set; fp16c's software codec and f32
    keep their instances."""
    import re

    from latticeurbanwind_tpu_torch.ops.stream_collide import PAIRED_STORAGES
    from latticeurbanwind_tpu_torch.utils import cuda_build

    text = (cuda_build.CSRC_DIR / "stream_collide_tiled.cuh").read_text()
    body = re.search(r"constexpr bool kPairCodec =([^;]*);", text).group(1)
    codecs = set(re.findall(r"std::is_same<C, Codec(\w+)>::value", body))
    assert {c.lower() for c in codecs} == set(PAIRED_STORAGES) == {"bf16",
                                                                   "f16"}


@pytest.mark.parametrize("name", ["stream_collide_kernel", "sc_launch",
                                  "halo_source", "thermal_cell"])
def test_the_old_step_body_is_gone(name):
    """Every step runs the tiled body: no source of csrc/ defines the old
    body's kernel, its launcher or its halo and thermal helpers any more."""
    import re

    from latticeurbanwind_tpu_torch.utils import cuda_build

    for p in cuda_build.sources() + cuda_build.headers():
        assert not re.search(rf"\b{name}\s*\(", p.read_text()), (name, p.name)


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    from latticeurbanwind_tpu_torch.lbm.state import Forcing, StepConfig
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        FaceBC, stream_collide, vk_sites,
    )
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
    Z, Y, X = shape
    face = torch.zeros((Z, 3, Y), device="meta")
    fbc = FaceBC(uw=face, ue=face, us=face, un=face, ut=face, ub=face)
    vk = {"sites": (("lane0", "uw"),),
          "masks": {"uw": torch.zeros((Z, 1, Y), device="meta")}}
    with pytest.raises(NotImplementedError, match="meta"):
        vk_sites(fi, fbc, vk, "f32")
