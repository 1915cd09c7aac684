"""PyTorch port, snapshots, video frames and their renderers
(`run/render_device.py`, `run/render.py`, `run/fieldvis.py`,
`run/snapshots.py`, `io/png.py`) against the JAX package's functions on the
same numpy inputs.

Mirrors `tests/test_render_jax.py`, `tests/test_fieldvis.py` and
`tests/test_snapshots_forces.py`:

  * the device march (`_march_trace`) gives the JAX march's hit labels
    exactly and its hit distances within 1e-4, the shading and the
    volumetric sums within 1e-5, the device streamlines the JAX device
    streamlines' paths within 1e-4;
  * the Q-criterion: the host path equals the JAX host path, the device
    path (f32) is within 1e-6 of it;
  * the colour ramps, field colours and weights, the volumetric raycast
    and the slice plane equal the JAX package's (the port's copy);
  * the solid-boundary force field and total equal the JAX package's on
    the same stored DDFs, fp16c included;
  * the PNG writer stores its array exactly (decoded here with zlib);
  * a run with `frame_output` and `unsteady_output` writes the JAX driver's
    file names on the same case.

The port composes its figures without matplotlib (the image array is the
figure), so images are compared by their arrays' inputs, not by pixels.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _scene(n=28):
    zz, yy, xx = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    solid = (zz < 3) | ((np.abs(xx - n // 2) < 3)
                        & (np.abs(yy - n // 2) < 3) & (zz < n // 2))
    speed = np.exp(-((xx - 20.0) ** 2 + (yy - n // 2) ** 2
                     + (zz - 10.0) ** 2) / 60).astype(np.float32)
    u = np.stack([speed, 0.1 * speed, np.zeros_like(speed)])
    return solid, u, speed


def _read_png(path):
    """(width, height, rgb (H, W, 3) uint8, text chunks) of an RGB8 PNG with
    filter-0 rows, decoded with zlib."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, text, ihdr = 8, b"", {}, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\x00")
            text[key.decode()] = value.decode("latin-1")
        pos += 12 + n
    w, h, depth, color, *_ = ihdr
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return w, h, rows[:, 1:].reshape(h, w, 3), text


# ----------------------------------------------------------------- the PNG

def test_png_writer_round_trips_its_array(tmp_path):
    from latticeurbanwind_tpu_torch.io.png import png_size, write_png

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = write_png(tmp_path / "a" / "x.png", img, title="step 200")
    w, h, got, text = _read_png(p)
    assert (w, h) == (53, 37) == png_size(p)
    np.testing.assert_array_equal(got, img)
    assert text == {"Title": "step 200"}
    # floats in [0, 1] go through round(255 x), clipped
    f = np.array([[[0.0, 0.5, 1.0], [-1.0, 2.0, 0.2]]], np.float32)
    _, _, got, text = _read_png(write_png(tmp_path / "f.png", f))
    np.testing.assert_array_equal(got, [[[0, 128, 255], [0, 255, 51]]])
    assert text == {}


# ------------------------------------------------------- device renderer

@pytest.mark.parametrize("fov", [0.0, 70.0])
def test_march_trace_matches_jax(fov):
    import jax.numpy as jnp

    from latticeurbanwind_tpu.run.render_jax import _march_trace as jax_march
    from latticeurbanwind_tpu_torch.run.render import Camera, _camera_rays
    from latticeurbanwind_tpu_torch.run.render_device import _march_trace

    solid, u, speed = _scene()
    label = solid.astype(np.int8)
    label[(speed > 0.6) & ~solid] = 2
    cam = Camera(width=72, height=54, fov=fov)
    origins, d, diag = _camera_rays(solid.shape, cam)
    n_steps = int(np.ceil(2.0 * diag / 0.7)) + 2
    want = jax_march(jnp.asarray(label), jnp.asarray(speed), jnp.asarray(origins),
                     jnp.asarray(d), jnp.float32(0.3), n_steps=n_steps,
                     with_field=True)
    got = _march_trace(torch.from_numpy(label), torch.from_numpy(speed),
                       torch.from_numpy(origins), torch.from_numpy(d), 0.3,
                       n_steps=n_steps, with_field=True)
    hit_w, t_w, pos_w, wsum_w, vsum_w, steps_w = (np.asarray(a) for a in want)
    hit_g, t_g, pos_g, wsum_g, vsum_g, steps_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(hit_g, hit_w)
    assert (hit_g == 2).any() and (hit_g == 1).any() and (hit_g == 0).any()
    hit = hit_w > 0
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=0, atol=1e-4)
    assert np.isinf(t_g[~hit]).all()
    np.testing.assert_allclose(pos_g[hit], pos_w[hit], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(steps_g, steps_w)
    np.testing.assert_allclose(wsum_g, wsum_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vsum_g, vsum_w, rtol=1e-5, atol=1e-5)


def test_shading_matches_jax():
    import jax.numpy as jnp

    from latticeurbanwind_tpu.run.render_jax import _box_blur as jax_blur
    from latticeurbanwind_tpu.run.render_jax import _shade_hits as jax_shade
    from latticeurbanwind_tpu_torch.run.render_device import _box_blur, _shade_hits

    solid, _, _ = _scene()
    occ_w = jax_blur(jnp.asarray(solid, jnp.float32))
    occ_g = _box_blur(torch.from_numpy(solid.astype(np.float32)))
    np.testing.assert_allclose(occ_g.numpy(), np.asarray(occ_w), rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 27, (200, 3)).astype(np.float32)
    t = rng.uniform(0, 80, 200).astype(np.float32)
    lab = rng.integers(0, 3, 200).astype(np.int8)
    base = np.array([[1, 1, 1], [0.55, 0.55, 0.6], [0.85, 0.3, 0.15]], np.float32)
    diag = float(np.linalg.norm(solid.shape))
    want = jax_shade(occ_w, jnp.asarray(pos), jnp.asarray(t), jnp.asarray(base),
                     jnp.asarray(lab), jnp.float32(diag))
    got = _shade_hits(occ_g, torch.from_numpy(pos), torch.from_numpy(t),
                      torch.from_numpy(base), torch.from_numpy(lab), diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_device_streamlines_match_jax_and_host():
    import jax.numpy as jnp

    from latticeurbanwind_tpu.run.render import (
        integrate_streamlines as jax_integrate,
    )
    from latticeurbanwind_tpu.run.render_jax import (
        _streamlines_device as jax_streamlines,
    )
    from latticeurbanwind_tpu_torch.run.render import integrate_streamlines
    from latticeurbanwind_tpu_torch.run.render_device import _streamlines_device

    solid, u, _ = _scene()
    seeds = np.array([[1.5, 10.0, 8.0], [1.5, 14.0, 12.0], [1.5, 20.0, 5.0]])
    pw, sw = (np.asarray(a) for a in jax_streamlines(
        jnp.asarray(u), jnp.asarray(seeds), jnp.asarray(solid), n_steps=50))
    pg, sg = (a.numpy() for a in _streamlines_device(
        torch.from_numpy(u), torch.from_numpy(seeds), torch.from_numpy(solid),
        n_steps=50))
    assert pg.shape == pw.shape == (51, 3, 3)
    np.testing.assert_array_equal(np.isnan(pg), np.isnan(pw))
    assert np.isfinite(pg).any()
    np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-4, equal_nan=True)
    np.testing.assert_allclose(sg, sw, rtol=0, atol=1e-6, equal_nan=True)
    # the host integrator is the JAX package's, value for value
    ph, sh = integrate_streamlines(u, seeds, n_steps=50, solid=solid)
    pj, sj = jax_integrate(u, seeds, n_steps=50, solid=solid)
    np.testing.assert_array_equal(ph, pj)
    np.testing.assert_array_equal(sh, sj)


def test_q_criterion_host_and_device_paths():
    import jax.numpy as jnp

    from latticeurbanwind_tpu.run.render_jax import (
        q_criterion_device as jax_q_device,
    )
    from latticeurbanwind_tpu.run.snapshots import q_criterion as jax_q
    from latticeurbanwind_tpu_torch.run.render_device import q_criterion_device
    from latticeurbanwind_tpu_torch.run.snapshots import q_criterion

    _, u, _ = _scene()
    host = q_criterion(u.astype(np.float64))
    np.testing.assert_array_equal(host, jax_q(u.astype(np.float64)))
    dev = q_criterion_device(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dev, np.asarray(jax_q_device(jnp.asarray(u))),
                               rtol=0, atol=1e-6)


def test_q_criterion_detects_shear():
    from latticeurbanwind_tpu_torch.run.snapshots import q_criterion

    shape = (8, 16, 16)
    z, y, x = np.meshgrid(np.arange(8), np.arange(16), np.arange(16), indexing="ij")
    u = np.zeros((3, *shape), np.float32)
    u[0] = -0.01 * (y - 8)
    u[1] = 0.01 * (x - 8)
    assert q_criterion(u)[4, 8, 8] > 0          # rotation
    u2 = np.zeros((3, *shape), np.float32)
    u2[0] = 0.01 * (x - 8)
    u2[1] = -0.01 * (y - 8)
    assert q_criterion(u2)[4, 8, 8] < 0         # strain


def test_percentile_is_numpys():
    from latticeurbanwind_tpu_torch.run.render_device import percentile

    x = np.random.default_rng(4).standard_normal(1001).astype(np.float32)
    for q in (0.0, 12.5, 97.0, 99.5, 100.0):
        assert percentile(torch.from_numpy(x), q) == pytest.approx(
            float(np.percentile(x, q)), rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------- fieldvis

def test_colour_ramps_and_field_modes_match_jax():
    import latticeurbanwind_tpu.run.fieldvis as jv
    import latticeurbanwind_tpu_torch.run.fieldvis as tv

    x = np.linspace(-0.2, 1.2, 301).astype(np.float32)
    for name in ("colorscale_rainbow", "colorscale_iron", "colorscale_twocolor"):
        np.testing.assert_array_equal(getattr(tv, name)(x), getattr(jv, name)(x))
    v = np.random.default_rng(2).uniform(0.5, 1.5, 500).astype(np.float32)
    for mode in tv.FIELD_MODES:
        np.testing.assert_array_equal(tv.field_color(v, mode, 2.0, 1.0),
                                      jv.field_color(v, mode, 2.0, 1.0))
        np.testing.assert_array_equal(tv.field_weight(v, mode, 2.0, 1.0),
                                      jv.field_weight(v, mode, 2.0, 1.0))
        assert tv.auto_scale(v, mode) == jv.auto_scale(v, mode)
    with pytest.raises(ValueError):
        tv.field_color(v, "p", 1.0)
    # the reference ramps' end points (kernel.cpp:112-156)
    np.testing.assert_allclose(tv.colorscale_rainbow(np.array([0.0, 1.0])),
                               [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(tv.colorscale_iron(np.array([0.0, 1.0])),
                               [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], atol=1e-6)


@pytest.mark.parametrize("fov", [0.0, 60.0])
def test_raycast_and_slice_plane_match_jax(fov):
    import latticeurbanwind_tpu.run.fieldvis as jv
    import latticeurbanwind_tpu_torch.run.fieldvis as tv
    from latticeurbanwind_tpu_torch.run.render import Camera, _camera_rays

    solid, _, speed = _scene(20)
    origins, dirs, _ = _camera_rays(solid.shape, Camera(width=40, height=30,
                                                        fov=fov))
    depth = np.full(len(origins), 40.0, np.float32)
    for mode in ("u", "T"):
        got = tv.raycast_field(speed, origins, dirs, mode=mode, exclude=solid,
                               geom_depth=depth)
        want = jv.raycast_field(speed, origins, dirs, mode=mode, exclude=solid,
                                geom_depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for axis in (0, 1, 2):
        got = tv.slice_plane(speed, axis, 7, origins, dirs, exclude=solid)
        want = jv.slice_plane(speed, axis, 7, origins, dirs, exclude=solid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].any()


# ------------------------------------------------------------ the renders

def test_host_render_scene_frames(tmp_path, monkeypatch):
    """render_scene: geometry, Q layer, streamlines and force vectors on a
    small camera; the perspective camera; decimation above max_cells."""
    import latticeurbanwind_tpu_torch.run.render as rr
    from latticeurbanwind_tpu_torch.io.png import png_size

    Z, Y, X = 16, 24, 32
    solid = np.zeros((Z, Y, X), bool)
    solid[:1] = True
    solid[:8, 8:12, 10:14] = True
    u = np.zeros((3, Z, Y, X), np.float32)
    u[0] = 0.05
    u[:, solid] = 0.0
    cam = rr.Camera(width=160, height=120)
    img, depth = rr.raytrace_masks((Z, Y, X), [(solid, (0.5, 0.5, 0.5))], cam)
    assert img.shape == (120, 160, 3) and np.isfinite(depth).any()
    seeds = rr.default_seeds((Z, Y, X), solid)
    paths, _ = rr.integrate_streamlines(u, seeds, n_steps=60, solid=solid)
    assert np.nanmax(paths[:, :, 0]) - seeds[:, 0].max() > 10
    force = np.zeros((3, Z, Y, X))
    force[0, :8, 8:12, 10] = 1.0
    p = rr.render_scene(solid, u, tmp_path / "frame.png", cam=cam, title="t",
                        force_field=force)
    w, h, rgb, text = _read_png(p)
    assert (w, h) == (160, 120) and text == {"Title": "t"}
    assert (rgb < 250).any() and len(np.unique(rgb.reshape(-1, 3), axis=0)) > 20
    persp = rr.render_scene(solid, u, tmp_path / "persp.png",
                            cam=rr.Camera(width=160, height=120, fov=70.0))
    assert png_size(persp) == (160, 120)
    shapes = []
    orig = rr.raytrace_masks

    def spy(shape, layers, cam, **kw):
        shapes.append(shape)
        return orig(shape, layers, cam, **kw)

    monkeypatch.setattr(rr, "raytrace_masks", spy)
    rr.render_scene(np.zeros((24, 48, 64), bool), None, tmp_path / "dec.png",
                    streamlines=False, max_cells=1000)
    assert shapes and int(np.prod(shapes[0])) <= 1000 * 8


def test_render_scene_device_writes_frames(tmp_path):
    from latticeurbanwind_tpu_torch.io.png import png_size
    from latticeurbanwind_tpu_torch.run.render import Camera
    from latticeurbanwind_tpu_torch.run.render_device import (
        q_criterion_device, render_scene_device,
    )

    solid, u, _ = _scene()
    solid_t, u_t = torch.from_numpy(solid), torch.from_numpy(u)
    q = torch.where(solid_t, torch.zeros(()), q_criterion_device(u_t))
    pos = q.numpy()[q.numpy() > 0]
    thr = float(np.percentile(pos, 97.0)) if pos.size else None
    p = render_scene_device(solid_t, u_t, tmp_path / "dev.png",
                            q=q if thr is not None else None, q_threshold=thr, cam=Camera(width=200, height=150),
                            volume_mode=True, title="dev")
    w, h, rgb, text = _read_png(p)
    assert (w, h) == (200, 150) and text == {"Title": "dev"}
    assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 20
    p2 = render_scene_device(solid_t, u_t, tmp_path / "persp.png",
                             cam=Camera(width=200, height=150, fov=70.0),
                             streamlines=False)
    assert png_size(p2) == (200, 150)


def _channel_with_block(storage="f32", u0=0.05):
    from latticeurbanwind_tpu_torch.lbm.lattice import omega_from_nu
    from latticeurbanwind_tpu_torch.lbm.state import (
        StepConfig, TYPE_E, TYPE_S, make_initial_state,
    )

    shape = (12, 16, 32)
    flags = np.zeros(shape, np.uint8)
    flags[0] = flags[-1] = TYPE_S
    flags[2:8, 6:10, 10:14] = TYPE_S      # block in the stream
    flags[:, :, 0] |= np.where(flags[:, :, 0] == 0, TYPE_E, 0).astype(np.uint8)
    flags[:, :, -1] |= np.where(flags[:, :, -1] == 0, TYPE_E, 0).astype(np.uint8)
    u = np.zeros((3, *shape), np.float32)
    u[0] = u0
    u[:, (flags & TYPE_S) != 0] = 0.0
    config = StepConfig(omega=omega_from_nu(0.02), subgrid=True, storage=storage)
    return config, make_initial_state(shape, config=config, u=u, flags=flags), u, flags


def _stepped(config, state, steps):
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner

    run, _ = make_runner(config, shape=tuple(state.rho.shape), device="cpu")
    dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    return update_fields(run(state, dyn, 0, steps), config, dyn)


@pytest.mark.parametrize("storage", ["f32", "bf16", "fp16c"])
def test_force_field_and_total_match_jax(storage):
    """The same stored DDFs through both packages' force diagnostics: equal
    per cell and in total; after 60 steps of flow in +x the block is pushed
    in +x more than it is lifted, and the total is the field's sum."""
    from latticeurbanwind_tpu.lbm.state import LBMState as JaxState
    from latticeurbanwind_tpu.run.snapshots import (
        solid_boundary_force as jax_total,
        solid_boundary_force_field as jax_field,
    )
    from latticeurbanwind_tpu_torch.lbm.state import TYPE_S
    from latticeurbanwind_tpu_torch.run.snapshots import (
        solid_boundary_force, solid_boundary_force_field,
    )

    config, state, _, _ = _channel_with_block(storage)
    out = _stepped(config, state, 60)
    F = solid_boundary_force_field(out)
    total = solid_boundary_force(out)
    raw = out.fi.view(torch.int16).numpy() if storage != "f32" else out.fi.numpy()
    fi = raw.view(np.uint16) if storage == "fp16c" else raw
    if storage == "bf16":
        import ml_dtypes

        fi = raw.view(ml_dtypes.bfloat16)
    jstate = JaxState(fi=fi, rho=out.rho.numpy(), u=out.u.numpy(),
                      flags=out.flags.numpy())
    np.testing.assert_array_equal(F, jax_field(jstate))
    np.testing.assert_array_equal(total, jax_total(jstate))
    solid = (out.flags.numpy() & TYPE_S) != 0
    assert np.all(F[:, ~solid] == 0.0)
    assert total[0] > 0 and abs(total[0]) > abs(total[2])
    assert F[0, 2:8, 6:10, 10].sum() > 0
    np.testing.assert_allclose(total, F.sum(axis=(1, 2, 3)), rtol=1e-12, atol=1e-12)


def test_write_snapshot_on_both_paths(tmp_path, monkeypatch):
    """The host path (CPU tensors) and the device path (taken here on CPU
    tensors, as on a card's) each write the panels PNG, sized from the
    grid, and its 3-D companion; nz_out crops the panels."""
    import latticeurbanwind_tpu_torch.run.snapshots as snapshots
    from latticeurbanwind_tpu_torch.io.png import png_size

    config, state, _, _ = _channel_with_block()
    out = _stepped(config, state, 20)
    gap = snapshots.PANEL_GAP
    for name, on_device in (("host", False), ("dev", True)):
        monkeypatch.setattr(snapshots, "_render_on_device", lambda a: on_device)
        p = snapshots.write_snapshot(out, tmp_path / f"{name}.png",
                                     u_factor=10.0, title=name)
        # |u| at z=2 (16x32), the y slice (12x32), the Q projection (16x32)
        assert png_size(p) == (3 * 32 + 2 * gap, 16)
        assert png_size(tmp_path / f"{name}_3d.png") == (960, 720)
        _, _, rgb, text = _read_png(p)
        assert text == {"Title": name}
        assert (rgb[:, :32] == 0).all(axis=2).any()       # solids black
        p2 = snapshots.write_snapshot(out, tmp_path / f"{name}2.png", nz_out=8)
        assert png_size(p2) == (3 * 32 + 2 * gap, 16)
        f = snapshots.write_frame(out, tmp_path / f"{name}_f.png")
        assert png_size(f) == (960, 720)


def test_frame_and_snapshot_files_match_the_jax_driver(tmp_path):
    """frame_output=3 and unsteady_output=3 over 6 steps: the port's driver
    writes the JAX driver's file names (frames numbered t // frame_output,
    snapshots by step with their _3d companions) and lists them in files."""
    import jax.numpy as jnp

    from latticeurbanwind_tpu.lbm import DynParams as JaxDyn
    from latticeurbanwind_tpu.lbm import Forcing as JaxForcing
    from latticeurbanwind_tpu.lbm import StepConfig as JaxConfig
    from latticeurbanwind_tpu.lbm import make_initial_state as jax_initial
    from latticeurbanwind_tpu.run.driver import RunSettings as JaxSettings
    from latticeurbanwind_tpu.run.driver import SolverCase as JaxCase
    from latticeurbanwind_tpu.run.driver import run_case as jax_run_case
    from latticeurbanwind_tpu.units import Units as JaxUnits
    from latticeurbanwind_tpu_torch.lbm.state import DynParams, Forcing
    from latticeurbanwind_tpu_torch.run.driver import (
        RunSettings, SolverCase, run_case,
    )
    from latticeurbanwind_tpu_torch.units import Units

    config, state, u, flags = _channel_with_block()
    kw = dict(run_nstep=6, frame_output=3, unsteady_output=3)
    port = SolverCase(
        config=config, forcing=Forcing(), state=state,
        dyn=DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3)),
        units=Units(), cell_m=1.0, parent=tmp_path / "port",
        datetime="20260101120000", vtk_prefix="TEST_",
        settings=RunSettings(**kw), device=torch.device("cpu"))
    jcfg = JaxConfig(omega=config.omega, subgrid=True, storage="f32")
    jax = JaxCase(
        config=jcfg, forcing=JaxForcing(),
        state=jax_initial(state.rho.shape, config=jcfg, u=u, flags=flags),
        dyn=JaxDyn(force=jnp.zeros(3), omega_coriolis=jnp.zeros(3)),
        units=JaxUnits(), cell_m=1.0, parent=tmp_path / "jax",
        datetime="20260101120000", vtk_prefix="TEST_",
        settings=JaxSettings(**kw))
    got = run_case(port, quiet=True)
    want = jax_run_case(jax, quiet=True)

    def pngs(root):
        return sorted(str(p.relative_to(root / "proj_temp"))
                      for p in (root / "proj_temp").rglob("*.png"))

    assert pngs(tmp_path / "port") == pngs(tmp_path / "jax") == [
        "frames/TEST_20260101120000_000001.png",
        "frames/TEST_20260101120000_000002.png",
        "snapshots/TEST_20260101120000_000000003.png",
        "snapshots/TEST_20260101120000_000000003_3d.png",
        "snapshots/TEST_20260101120000_000000006.png",
        "snapshots/TEST_20260101120000_000000006_3d.png"]
    listed = [f.relative_to(tmp_path / "port") for f in got.files]
    assert [f.relative_to(tmp_path / "jax") for f in want.files] == listed
    assert got.timing["snapshot_seconds"] > 0 and got.timing["frame_seconds"] > 0


def test_split_run_renders_from_its_gathered_fields(tmp_path):
    """A run split n_gpu = [1, 2, 2] writes the unsplit run's snapshot and
    frame files, from its fields gathered to the host, with the same
    panels image (the split run's u equals the unsplit one's)."""
    from latticeurbanwind_tpu_torch.lbm.state import DynParams, Forcing
    from latticeurbanwind_tpu_torch.run.driver import (
        RunSettings, SolverCase, run_case,
    )
    from latticeurbanwind_tpu_torch.units import Units

    runs = {}
    for ngpu in ((1, 1, 1), (1, 2, 2)):
        config, state, _, _ = _channel_with_block()
        runs[ngpu] = run_case(SolverCase(
            config=config, forcing=Forcing(), state=state,
            dyn=DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3)),
            units=Units(), cell_m=1.0, parent=tmp_path / str(ngpu[1]),
            datetime="20260101120000",
            settings=RunSettings(run_nstep=4, frame_output=4, unsteady_output=4),
            ngpu=ngpu, device=torch.device("cpu")), quiet=True)
    one, split = (sorted(p.relative_to(tmp_path / d)
                         for p in (tmp_path / d / "proj_temp").rglob("*.png"))
                  for d in ("1", "2"))
    assert one == split and len(one) == 3
    for rel in one:
        a = _read_png(tmp_path / "1" / rel)
        b = _read_png(tmp_path / "2" / rel)
        assert a[:2] == b[:2]
        if "snapshots" in str(rel) and not str(rel).endswith("_3d.png"):
            np.testing.assert_array_equal(a[2], b[2])
