"""PyTorch port: storage codecs, initial state and StepConfig against the JAX
package, and the port's independence from jax."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from latticeurbanwind_tpu.lbm import state as jst
from latticeurbanwind_tpu_torch import convert
from latticeurbanwind_tpu_torch.lbm import state as tst
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _f32_sweep() -> np.ndarray:
    """Dense fp32 sweep without NaN: every exponent band (incl. denormals,
    ties and the saturating range) at a stride through the mantissa, the
    signed zeros and infinities, plus random values."""
    rng = np.random.default_rng(0)
    exps = np.arange(0, 256, dtype=np.uint32) << 23
    mants = np.unique(np.concatenate([
        np.arange(0, 1 << 23, 4093, dtype=np.uint32),
        np.array([0, 1, 0x7FF, 0x800, 0x801, 0xFFF, 0x1000, 0x7FFFFF],
                 np.uint32)]))
    bits = (exps[:, None] | mants[None, :]).ravel()
    bits = np.concatenate([bits, bits | np.uint32(0x80000000)])
    vals = bits.view(np.float32)
    vals = vals[~np.isnan(vals)]
    extra = rng.standard_normal(20000).astype(np.float32) * np.float32(0.05)
    return np.concatenate([vals, extra])


def test_fp16c_encode_bit_exact():
    x = _f32_sweep()
    want = np.asarray(jst.encode_fp16c(x))
    got = tst.encode_fp16c(torch.from_numpy(x)).to(torch.int32).numpy()
    np.testing.assert_array_equal(got.astype(np.uint16), want)


def test_fp16c_decode_bit_exact_all_codes():
    codes = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    want = np.asarray(jst.decode_fp16c(codes)).view(np.uint32)
    got = tst.decode_fp16c(torch.from_numpy(codes.astype(np.int32)).to(torch.uint16))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_storage_codecs_bit_exact(storage):
    import jax.numpy as jnp

    x = _f32_sweep()
    if storage == "f16":      # keep the scaled values inside the half range
        x = x[np.abs(x) < 1.0]
    enc_j = jst.encode_ddf(jnp.asarray(x), storage)
    enc_t = tst.encode_ddf(torch.from_numpy(x), storage)
    a, b = np.asarray(enc_j), convert.to_numpy(enc_t)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    dec_j = np.asarray(jst.decode_ddf(enc_j, storage))
    dec_t = tst.decode_ddf(enc_t, storage).numpy()
    np.testing.assert_array_equal(dec_j.view(np.uint32), dec_t.view(np.uint32))


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "fp16c"])
def test_make_initial_state_matches_jax(storage):
    rng = np.random.default_rng(3)
    shape = (7, 21, 45)
    u = (0.05 * rng.standard_normal((3, *shape))).astype(np.float32)
    rho = (1.0 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    flags = rng.integers(0, 4, shape).astype(np.uint8)
    js = jst.make_initial_state(
        shape, config=jst.StepConfig(omega=1.2, storage=storage),
        rho=rho, u=u, flags=flags)
    ts = tst.make_initial_state(
        shape, config=tst.StepConfig(omega=1.2, storage=storage),
        rho=rho, u=u, flags=flags)
    assert ts.fi.dtype == tst.storage_dtype(storage)
    got = convert.state_to_numpy(ts)
    for name in ("fi", "rho", "u", "flags"):
        a = np.asarray(getattr(js, name))
        b = getattr(got, name)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


def test_fp16c_encode_saturates_nan():
    """NaN of any payload encodes to sign | 0x7FFF, the Pallas kernel
    codec's side (ROADMAP section 3): never to a finite zero, which is what
    the bare integer formula makes of payloads at or above 0x7FFFF800 --
    CUDA's canonical NaN 0x7FFFFFFF among them."""
    bits = np.array([0x7FC00000, 0x7FFFFFFF, 0x7FFFF800, 0x7F800001,
                     0xFFC00000, 0xFFFFFFFF, 0xFFFFF800, 0xFF800001],
                    np.uint32)
    x = torch.from_numpy(bits.view(np.float32))
    got = tst.encode_fp16c(x).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, [0x7FFF] * 4 + [0xFFFF] * 4)
    # the decoded value is the largest finite magnitude, so the cell shows
    assert float(tst.decode_fp16c(tst.encode_fp16c(x)).abs().min()) > 1.99
    # infinities saturate the same way, as in the JAX formula
    inf = torch.tensor([np.inf, -np.inf], dtype=torch.float32)
    assert tst.encode_fp16c(inf).view(torch.int16).numpy().view(np.uint16).tolist() \
        == [0x7FFF, 0xFFFF]
    assert np.asarray(jst.encode_fp16c(np.array([np.inf, -np.inf], np.float32))
                      ).tolist() == [0x7FFF, 0xFFFF]


def test_step_config_fields_and_checks_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jst.StepConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tst.StepConfig)]
    assert tf == jf
    assert tst.TYPE_S == jst.TYPE_S and tst.TYPE_E == jst.TYPE_E
    assert tst.TYPE_T == jst.TYPE_T and tst.TYPE_F == jst.TYPE_F
    assert tst.FP16_SCALE == jst.FP16_SCALE
    for bad in (dict(collision="mrt"), dict(storage="f8"),
                dict(wall_model=True), dict(wall_sides=True),
                dict(wall_model=True, wall_cd=0.1, volume_force=False)):
        with pytest.raises(AssertionError):
            jst.StepConfig(omega=1.0, **bad)
        with pytest.raises(AssertionError):
            tst.StepConfig(omega=1.0, **bad)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import latticeurbanwind_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'latticeurbanwind_tpu', 'ml_dtypes', 'matplotlib',\n"
        "        'PIL')]\n"
        "assert not bad, bad\n"
        "new = ['run.standard', 'bc.nearest', 'bc.patch2d', 'bc.samples',\n"
        "       'bc.high_order', 'run.probes', 'run.probe_parse',\n"
        "       'post.transform', 'pre.utm', 'parallel.mesh',\n"
        "       'parallel.halo', 'run.checkpoint', 'run.fieldvis',\n"
        "       'run.render', 'run.render_device', 'run.snapshots',\n"
        "       'run.batch', 'io.png', 'pre.shp_reader', 'pre.buildbc',\n"
        "       'pre.wrf_ingest', 'pre.shpcutter', 'pre.dem_ingest',\n"
        "       'pre.terrain', 'pre.voxelization', 'cli.inspect_tools',\n"
        "       'cli.validate', 'cli.clean', 'cli.makeluw', 'cli.dispatch',\n"
        "       'utils.accelerator', 'post.vtk2nc']\n"
        "missing = [m for m in new if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    # nor does any function of the port import JAX, the JAX package,
    # matplotlib or PIL when it runs (convert.py reads bfloat16 through
    # ml_dtypes, for the tests, where the caller hands it JAX arrays)
    lazy = re.compile(r"^\s*(?:import|from)\s+(?:jax|latticeurbanwind_tpu|"
                      r"matplotlib|PIL)\b", re.M)
    hits = [str(f.relative_to(REPO)) for f in
            sorted((REPO / "latticeurbanwind_tpu_torch").rglob("*.py"))
            if lazy.search(f.read_text())]
    assert not hits, hits
