"""Fused D3Q19 stream-collide step: the CUDA kernel K-SC and its plain version.

Counterpart of `latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step`
(one launch per time step).  The semantics are the Pallas tier's pure-DDF
step: the kernel streams DDFs and flags only, TYPE_E cells freeze their
stored equilibria, TYPE_S cells go to zero, and the nudge / sponge targets
come from the static `FaceBC` built once from the initial velocity field.

`stream_collide` is the entry point; `vk_sites` runs the VK site pass
alone (K6, the pass a step with sites launches after the step).  A
tensor on the CPU goes to `stream_collide_plain` (torch ops with
`torch.roll` pulls); a CUDA tensor
launches an instance of the tiled body `csrc/stream_collide_tiled.cuh`
(`csrc/stream_collide.cu`: no wall model, SRT; `csrc/stream_collide_wall.cu`:
the wall models or TRT) or raises.
There is no fallback between the two.  Both take every configuration of one
device:
SRT or TRT collision with Smagorinsky LES and equilibrium boundaries, f32,
bf16, f16 or fp16c storage, volume force (global force + Coriolis) on or
off, buffer nudging, the top sponge, the wall models (`wall_model`,
`wall_sides`), the VK inlet sites of `bc.vk_inlet` (`vk`, the hook's
`kernel_spec`) and the thermal D3Q7 sub-lattice (`thermal`, instances of
`csrc/stream_collide_thermal.cu`); and with `halo` every configuration as
one z slab of a domain split over devices (K8, the Pallas kernel's
`halo_mode`, instances of `csrc/stream_collide_halo.cu`).

Halo mode (Pallas `make_pallas_step` :409, :1032-1042, :1222-1241): a pull
whose z source leaves the slab's [0, Z) reads the neighbouring slab's plane
from the `lbm.state.ZHalo` (its cz = +1 channels below, cz = -1 above, their
flags, and the thermal g channel) instead of wrapping: the bounce-back test
on the source's flag, the pulled value, the wall models' x and y mirror
partners and the Schumann stress's flag below.  y and x still wrap inside
the slab's ghost-extended plane, and the VK sites sit on the box inside the
ghosts (`ZHalo.gy`, `.gx`).  The plain version puts the halo planes beside
the slab (`lbm.fields.halo_extend`), runs the plain step and crops.

Thermal (Pallas `make_pallas_step` :732-807): the 7 `g` populations are
pulled with halfway bounce-back from solid sources (no mirrors); T = 1 +
sum g, at TYPE_T cells 1 + the sum of the cell's own frozen populations; the
top sponge relaxes T toward the FaceBC target `tt` (the initial top plane
of T) at cells that are neither TYPE_E nor TYPE_T; g_eq = w0 (T - 1) and
ws (T - 1) +- T u_axis / 2 with the streamed, unforced velocity (TYPE_E
cells: the velocity of their own frozen f); g relaxes at omega_t, TYPE_T
cells keep their stored g and solid cells write 0; the Boussinesq term
F -= dyn.force * beta * (T - t_avg) enters F before the Guo half-step.  The
JAX reference tier (`lbm/reference.py:305`) takes the current `T[-1]` as
the sponge target; the kernels, the Pallas one and this one, stream no T
field and take `tt`.

Wall models (Pallas `make_pallas_step` :618-650 and :678-703, reference
`lbm/reference.py::_stream`): a direction d whose pull source is solid
takes, instead of the bounce-back value f_opp(x), the first admissible
mirror in the order ground, x face, y face (the reference applies them as
selects y, x, ground, so the later one wins):

  * ground (`wall_model`, cz = +1): f_(cx,cy,-1) of the own plane at
    (x - cx, y - cy, z), when that cell is fluid;
  * x face (`wall_sides`, cx != 0): f_(-cx,cy,cz) at (x, y - cy, z - cz),
    when fluid;
  * y face (`wall_sides`, cy != 0): f_(cx,-cy,cz) at (x - cx, y, z - cz),
    when fluid.

All reads are of the previous step's DDFs and wrap periodically.  The
Schumann stress F_h -= Cd rho |u_h| u_h acts at fluid cells whose z - 1
neighbour is solid; with `wall_sides` and Cd_sides > 0 a fluid cell beside
an x (y) solid neighbour loses Cd_sides rho |u_t| u_t along y and z (x and
z).  Both use the streamed, unforced velocity and come right after
Coriolis, before nudging and the sponge.

TRT (Pallas :890-902): omega+ is the LES rate, omega- = 1/(0.1875/(1/omega+
- 1/2) + 1/2) per cell, and each opposite pair relaxes its even part at
omega+ and its odd part at omega-; the Guo source splits the same way.

VK inlet sites (Pallas `make_pallas_step` :915-978): each site (kind,
field) overwrites the step's encoded outputs on one boundary face with
enc(m * feq_vk(u) + (1 - m) * dec(out)), where u is the FaceBC field's
velocity at the face cell, feq_vk the DDF-shifted equilibrium at rho = 1
and m the site's mask (0/1, f32).  Kinds and their fields: lane0/uw (x=0)
and laneL/ue (x=X-1) with masks (Z,1,Y), row0/us (y=0) and rowL/un
(y=Y-1) with masks (Z,1,X), planeL/ut (z=Z-1) and plane0/ub (z=0) with
masks (Y,X).  Planes apply first, then rows, then lanes, each reading back
what the earlier ones wrote, so the lanes own the corners.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..lbm.fields import halo_extend, pull, pull_g, wall_stress
from ..lbm.lattice import C19, CS, OPP19, SMAGORINSKY_FACTOR, W7, W19
from ..lbm.state import (
    Forcing, StepConfig, TYPE_E, TYPE_S, TYPE_T, ZHalo, decode_ddf,
    encode_ddf, raw_bits, storage_dtype, wall_mode,
)

_STORAGE_CODE = {"f32": 0, "bf16": 1, "f16": 2, "fp16c": 3}

# VK site kind -> (FaceBC field, application rank): planes, rows, lanes
VK_SITES = {"planeL": ("ut", 0), "plane0": ("ub", 0), "row0": ("us", 1),
            "rowL": ("un", 1), "lane0": ("uw", 2), "laneL": ("ue", 2)}


class FaceBC(NamedTuple):
    """Static boundary-face targets for nudging and the sponge.

    Layouts as in the JAX package: uw/ue (Z, 3, Y), us/un (Z, 3, X),
    ut/ub (3, Y, X), all f32.  With pure-DDF stepping the face velocities
    are those of the initial field (the faces are TYPE_E cells).  `tt`
    (Y, X) is the sponge's temperature target of a thermal run."""

    uw: torch.Tensor
    ue: torch.Tensor
    us: torch.Tensor
    un: torch.Tensor
    ut: torch.Tensor
    ub: torch.Tensor
    tt: Optional[torch.Tensor] = None


_FACE_FIELDS = ("uw", "ue", "us", "un", "ut", "ub")


def build_face_bc(u: torch.Tensor, T: Optional[torch.Tensor] = None) -> FaceBC:
    """Face targets from the initialized boundary fields: the velocity
    (3,Z,Y,X) and, for a thermal run, the temperature (Z,Y,X)."""
    def c(a):
        return a.to(torch.float32).contiguous()

    return FaceBC(
        uw=c(u[:, :, :, 0].transpose(0, 1)), ue=c(u[:, :, :, -1].transpose(0, 1)),
        us=c(u[:, :, 0, :].transpose(0, 1)), un=c(u[:, :, -1, :].transpose(0, 1)),
        ut=c(u[:, -1, :, :]), ub=c(u[:, 0, :, :]),
        tt=None if T is None else c(T[-1]),
    )


def _check_storage(storage: str) -> None:
    if storage not in _STORAGE_CODE:
        raise ValueError(f"unknown storage {storage!r}")


def _check_vk(vk) -> None:
    for kind, field in vk["sites"]:
        if VK_SITES.get(kind, (None,))[0] != field:
            raise ValueError(f"VK site ({kind!r}, {field!r}) is not one "
                             f"of {sorted(VK_SITES.items())}")
        if field not in vk["masks"]:
            raise ValueError(f"VK site {kind!r} has no mask {field!r}")


def check_config(config: StepConfig, forcing: Forcing, vk=None) -> None:
    """Raise for a configuration K-SC (and its plain version) does not take."""
    _check_storage(config.storage)
    if vk is not None:
        _check_vk(vk)
    has_forcing = (forcing.nudge_sigma is not None
                   or forcing.sponge_sigma_z is not None)
    if not config.volume_force and (has_forcing or config.thermal):
        raise ValueError("volume_force=False requires no nudge/sponge "
                         "forcing and no thermal buoyancy")


def _roll(a: torch.Tensor, c) -> torch.Tensor:
    """Pull shift: result[z, y, x] = a[z-cz, y-cy, x-cx] (periodic)."""
    cx, cy, cz = (int(v) for v in c)
    if cx == 0 and cy == 0 and cz == 0:
        return a
    return torch.roll(a, shifts=(cz, cy, cx), dims=(0, 1, 2))


def _cdot(c, a, b, d):
    """c.v summing only the nonzero components, in x, y, z order."""
    out = None
    for ci, v in zip((int(x) for x in c), (a, b, d)):
        if ci == 0:
            continue
        t = v if ci == 1 else -v
        out = t if out is None else out + t
    return out


_raw = raw_bits


def feq_vk(ux: torch.Tensor, uy: torch.Tensor, uz: torch.Tensor) -> list:
    """DDF-shifted D3Q19 equilibria at rho = 1 (the inlet's pinned boundary
    density), in the Pallas step's evaluation order."""
    c3 = -3.0 * (ux * ux + uy * uy + uz * uz)
    fe = [None] * 19
    fe[0] = (1.0 / 3.0) * (0.5 * c3)
    for d in range(1, 19, 2):
        w = float(W19[d])
        cu = 3.0 * _cdot(C19[d], ux, uy, uz)
        b = w * (0.5 * (cu * cu + c3))
        fe[d] = b + w * cu
        fe[int(OPP19[d])] = b - w * cu
    return fe


def _site_slab(out: torch.Tensor, fbc: FaceBC, kind: str, field: str, mask):
    """(output slab view (19, R, C), velocity components (3 x (R, C)), mask
    (R, C)) of one VK site."""
    u = getattr(fbc, field)
    if kind in ("planeL", "plane0"):
        slab = out[:, -1 if kind == "planeL" else 0]
        return slab, (u[0], u[1], u[2]), mask
    if kind in ("row0", "rowL"):
        slab = out[:, :, -1 if kind == "rowL" else 0]
    else:
        slab = out[:, :, :, -1 if kind == "laneL" else 0]
    return slab, (u[:, 0], u[:, 1], u[:, 2]), mask[:, 0]


def apply_vk_sites(out: torch.Tensor, fbc: FaceBC, vk, storage: str) -> None:
    """The VK site epilogue on whole face slabs of the encoded step output
    `out` (19,Z,Y,X), in place: planes, then rows, then lanes."""
    sites = sorted(vk["sites"], key=lambda s: VK_SITES[s[0]][1])
    for kind, field in sites:
        slab, (ux, uy, uz), m = _site_slab(out, fbc, kind, field,
                                           vk["masks"][field])
        fe = torch.stack(feq_vk(ux, uy, uz))
        cur = decode_ddf(slab, storage)
        new = encode_ddf(m * fe + (1.0 - m) * cur, storage)
        _raw(slab).copy_(_raw(new))


def _thermal_plain(gi, f_prev, un, solid, eqbc, tfix, sponge_sig, tt,
                   config: StepConfig):
    """(post-collision g (7,Z,Y,X) in storage dtype, T) of one thermal step:
    the D3Q7 half of `stream_collide_plain`, in the Pallas step's order."""
    g_prev = decode_ddf(gi, config.storage)
    # TYPE_E cells collide g with their prescribed velocity: the moments of
    # their own frozen f
    rho_own = f_prev[0]
    for d in range(1, 19):
        rho_own = rho_own + f_prev[d]
    rho_own = rho_own + 1.0
    mom_own = [None, None, None]
    for d in range(1, 19):
        for a in range(3):
            c = int(C19[d, a])
            if c == 0:
                continue
            t = f_prev[d] if c == 1 else -f_prev[d]
            mom_own[a] = t if mom_own[a] is None else mom_own[a] + t
    inv_rho_own = 1.0 / rho_own
    un_t = [torch.where(eqbc, mom_own[a] * inv_rho_own, un[a])
            for a in range(3)]

    gpl = [pull_g(g_prev.__getitem__, solid, d) for d in range(7)]
    T_m, T_own = gpl[0], g_prev[0]
    for d in range(1, 7):
        T_m = T_m + gpl[d]
        T_own = T_own + g_prev[d]
    Tn = torch.where(tfix, T_own + 1.0, T_m + 1.0)
    if sponge_sig is not None:
        sig_t = torch.where(eqbc | tfix, 0.0, sponge_sig)
        Tn = Tn + sig_t * (tt[None] - Tn)
    tm1_q = float(W7[1]) * (Tn - 1.0)
    geq = [float(W7[0]) * (Tn - 1.0)]
    for ax in range(3):
        cu_t = 0.5 * Tn * un_t[ax]
        geq.append(tm1_q + cu_t)
        geq.append(tm1_q - cu_t)
    g_out = torch.empty_like(gi)
    raw_out, raw_in = _raw(g_out), _raw(gi)
    zero = torch.zeros((), dtype=raw_out.dtype, device=gi.device)
    for d in range(7):
        coll = (1.0 - config.omega_t) * gpl[d] + config.omega_t * geq[d]
        post = torch.where(tfix, raw_in[d],
                           _raw(encode_ddf(coll, config.storage)))
        raw_out[d] = torch.where(solid, zero, post)
    return g_out, Tn


def _z_pad(a: Optional[torch.Tensor], dim: int = 0) -> Optional[torch.Tensor]:
    """`a` with one zero plane before and after along z (axis `dim`)."""
    if a is None:
        return None
    shape = list(a.shape)
    shape[dim] = 1
    zero = torch.zeros(shape, dtype=a.dtype, device=a.device)
    return torch.cat([zero, a, zero], dim)


def _inner_box(out: torch.Tensor, fbc: FaceBC, vk, gy: int, gx: int):
    """(output view, FaceBC views, site spec) of the box inside a slab's
    ghost layers, where a halo-mode step applies the VK inlet sites."""
    Y, X = out.shape[-2:]
    ys, xs = slice(gy, Y - gy), slice(gx, X - gx)
    box = FaceBC(uw=fbc.uw[:, :, ys], ue=fbc.ue[:, :, ys], us=fbc.us[:, :, xs],
                 un=fbc.un[:, :, xs], ut=fbc.ut[:, ys, xs], ub=fbc.ub[:, ys, xs])
    cut = {"uw": (slice(None), slice(None), ys), "ue": (slice(None), slice(None), ys),
           "us": (slice(None), slice(None), xs), "un": (slice(None), slice(None), xs),
           "ut": (ys, xs), "ub": (ys, xs)}
    masks = {k: m[cut[k]] for k, m in vk["masks"].items()}
    return out[:, :, ys, xs], box, {"sites": vk["sites"], "masks": masks}


def _halo_plain(fi, flags, dyn, config, forcing, fbc, vk, gi, gi_out, halo):
    """K8's plain version: the slab with its halo planes beside it
    (`lbm.fields.halo_extend`) through the plain step, cropped back to the
    slab; then the VK sites on the box inside the ghost layers."""
    fe, fl, ge = halo_extend(fi, flags, halo, gi if config.thermal else None)
    frc = forcing._replace(nudge_sigma=_z_pad(forcing.nudge_sigma),
                           nudge_face=_z_pad(forcing.nudge_face),
                           sponge_sigma_z=_z_pad(forcing.sponge_sigma_z))
    fbc_e = None if fbc is None else fbc._replace(
        uw=_z_pad(fbc.uw), ue=_z_pad(fbc.ue), us=_z_pad(fbc.us),
        un=_z_pad(fbc.un))
    go = None if ge is None else torch.empty_like(ge)
    out = stream_collide_plain(fe, fl, dyn, config, frc, fbc_e, None, ge, go)
    out = out[:, 1:-1].contiguous()
    if go is not None:
        _raw(gi_out).copy_(_raw(go[:, 1:-1]))
    if vk is not None:
        apply_vk_sites(*_inner_box(out, fbc, vk, halo.gy, halo.gx),
                       config.storage)
    return out


def stream_collide_plain(fi: torch.Tensor, flags: torch.Tensor,
                         dyn: torch.Tensor, config: StepConfig,
                         forcing: Forcing,
                         fbc: Optional[FaceBC] = None, vk=None,
                         gi: Optional[torch.Tensor] = None,
                         gi_out: Optional[torch.Tensor] = None,
                         halo: Optional[ZHalo] = None) -> torch.Tensor:
    """One step in plain torch: returns the post-collision DDFs (19,Z,Y,X) in
    storage dtype; with `config.thermal` it also writes the post-collision
    `g` (7,Z,Y,X) of `gi` into the caller's `gi_out`.  `dyn` is the (8,) row
    of `lbm.state.dyn_row`; `vk` the inlet site spec.  Same stages and
    evaluation order as the kernel and the Pallas step.  `halo`: one z slab
    of a split domain (K8), whose z neighbours beyond the slab are the
    halo's planes; y and x wrap inside the slab's plane, and the VK sites
    apply on the box inside its ghost layers (`halo.gy`, `halo.gx`)."""
    check_config(config, forcing, vk)
    use_force = config.volume_force
    has_nudge = forcing.nudge_sigma is not None
    has_sponge = forcing.sponge_sigma_z is not None
    if (has_nudge or has_sponge or vk is not None) and fbc is None:
        raise ValueError("nudging, sponge and VK sites need the FaceBC "
                         "targets (fbc)")
    if config.thermal:
        _check_thermal(gi, gi_out)
        if has_sponge and fbc.tt is None:
            raise ValueError("a thermal step with the sponge needs FaceBC.tt")
    if halo is not None:
        return _halo_plain(fi, flags, dyn, config, forcing, fbc, vk, gi,
                           gi_out, halo)
    f_prev = decode_ddf(fi, config.storage)
    solid = (flags & TYPE_S) != 0
    eqbc = (flags & TYPE_E) != 0

    wall = wall_mode(config)
    f = [f_prev[0]] + [pull(f_prev.__getitem__, solid, d, wall)
                       for d in range(1, 19)]

    rho = f[0]
    for d in range(1, 19):
        rho = rho + f[d]
    rho = rho + 1.0
    mom = [None, None, None]
    for d in range(1, 19):
        for a in range(3):
            c = int(C19[d, a])
            if c == 0:
                continue
            t = f[d] if c == 1 else -f[d]
            mom[a] = t if mom[a] is None else mom[a] + t
    inv_rho = 1.0 / rho
    un = [m * inv_rho for m in mom]

    F = [None, None, None]
    if use_force:
        fx, fy, fz, ox, oy, oz = (dyn[i] for i in range(6))
        F = [fx - 2.0 * rho * (oy * un[2] - oz * un[1]),
             fy - 2.0 * rho * (oz * un[0] - ox * un[2]),
             fz - 2.0 * rho * (ox * un[1] - oy * un[0])]
        F = wall_stress(F, un, rho, solid, config)
    if has_nudge:
        face = forcing.nudge_face
        rs = rho * torch.where(eqbc, 0.0, forcing.nudge_sigma)
        n_axes = 3 if forcing.nudge_vertical else 2
        for a in range(n_axes):
            tgt = fbc.uw[:, a, :, None]
            for fid, t in ((1, fbc.ue[:, a, :, None]), (2, fbc.us[:, a][:, None, :]),
                           (3, fbc.un[:, a][:, None, :]), (4, fbc.ut[a][None]),
                           (5, fbc.ub[a][None])):
                tgt = torch.where(face == fid, t, tgt)
            F[a] = F[a] + rs * (tgt - un[a])
    if has_sponge:
        sig = forcing.sponge_sigma_z[:, None, None]
        rs = rho * torch.where(eqbc, 0.0, sig)
        for a in range(3):
            F[a] = F[a] + rs * (fbc.ut[a][None] - un[a])

    if config.thermal:
        g_out, Tn = _thermal_plain(
            gi, f_prev, un, solid, eqbc, (flags & TYPE_T) != 0,
            forcing.sponge_sigma_z[:, None, None] if has_sponge else None,
            fbc.tt if has_sponge else None, config)
        _raw(gi_out).copy_(_raw(g_out))
        bterm = config.beta * (Tn - config.t_avg)
        F = [F[a] - dyn[a] * bterm for a in range(3)]

    if use_force:
        half = 0.5 / rho
        us_ = [torch.clamp(un[a] + F[a] * half, -CS, CS) for a in range(3)]
    else:
        us_ = [torch.clamp(un[a], -CS, CS) for a in range(3)]
    ux, uy, uz = us_

    c3 = -3.0 * (ux * ux + uy * uy + uz * uz)
    rhom1 = rho - 1.0
    uF = -(1.0 / 3.0) * (ux * F[0] + uy * F[1] + uz * F[2]) if use_force else None
    feq = [None] * 19
    fin = [None] * 19
    feq[0] = (1.0 / 3.0) * (rhom1 + rho * (0.5 * c3))
    if use_force:
        fin[0] = 3.0 * uF
    for d in range(1, 19, 2):
        w = float(W19[d])
        od = int(OPP19[d])
        cu = 3.0 * _cdot(C19[d], ux, uy, uz)
        base = w * (rhom1 + rho * (0.5 * (cu * cu + c3)))
        wcu = w * rho * cu
        feq[d] = base + wcu
        feq[od] = base - wcu
        if use_force:
            cF = _cdot(C19[d], F[0], F[1], F[2])
            w9 = 9.0 * w
            cu3 = cu * (1.0 / 3.0)
            fin[d] = w9 * (cF * (cu3 + 1.0 / 3.0) + uF)
            fin[od] = w9 * (cF * (cu3 - 1.0 / 3.0) + uF)

    if config.subgrid:
        fneq = [None] + [f[d] - feq[d] for d in range(1, 19)]
        H = {}
        for a in range(3):
            for b in range(a, 3):
                acc = None
                for d in range(1, 19):
                    coeff = int(C19[d, a]) * int(C19[d, b])
                    if coeff == 0:
                        continue
                    if acc is None:
                        acc = fneq[d] if coeff == 1 else -fneq[d]
                    else:
                        acc = acc + fneq[d] if coeff == 1 else acc - fneq[d]
                H[(a, b)] = acc
        Q = (H[(0, 0)] ** 2 + H[(1, 1)] ** 2 + H[(2, 2)] ** 2
             + 2.0 * (H[(0, 1)] ** 2 + H[(0, 2)] ** 2 + H[(1, 2)] ** 2))
        tau0 = 1.0 / config.omega
        w_eff = 2.0 / (tau0 + torch.sqrt(
            tau0 * tau0 + SMAGORINSKY_FACTOR * torch.sqrt(Q) / rho))
    else:
        w_eff = torch.full_like(rho, config.omega)

    if config.collision == "srt":
        one_m_w = 1.0 - w_eff
        cfin = 1.0 - 0.5 * w_eff

        def collide(d):
            coll = one_m_w * f[d] + w_eff * feq[d]
            return coll + cfin * fin[d] if use_force else coll
    else:
        wp = w_eff
        wm = 1.0 / (0.1875 / (1.0 / wp - 0.5) + 0.5)
        c_taup = 0.5 - 0.25 * wp
        c_taum = 0.5 - 0.25 * wm

        def collide(d):
            od = int(OPP19[d])
            coll = (f[d] + 0.5 * wp * (feq[d] - f[d] + feq[od] - f[od])
                    + 0.5 * wm * (feq[d] - feq[od] - f[d] + f[od]))
            if use_force:
                coll = coll + (c_taup * (fin[d] + fin[od])
                               + c_taum * (fin[d] - fin[od]))
            return coll

    out = torch.empty_like(fi)
    raw_out, raw_in = _raw(out), _raw(fi)
    zero = torch.zeros((), dtype=raw_out.dtype, device=fi.device)
    for d in range(19):
        coll = collide(d)
        post = torch.where(eqbc, raw_in[d],
                           _raw(encode_ddf(coll, config.storage)))
        raw_out[d] = torch.where(solid, zero, post)
    if vk is not None:
        apply_vk_sites(out, fbc, vk, config.storage)
    return out


def _check_thermal(gi, gi_out) -> None:
    if gi is None or gi_out is None:
        raise ValueError("a thermal step needs the g populations (gi) and a "
                         "buffer for the new ones (gi_out)")
    if gi_out.data_ptr() == gi.data_ptr():
        raise ValueError("gi_out must not alias gi (the step pulls from gi)")


def _check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_collide(fi: torch.Tensor, flags: torch.Tensor, dyn: torch.Tensor,
                   config: StepConfig, forcing: Forcing,
                   fbc: Optional[FaceBC] = None, *,
                   out: Optional[torch.Tensor] = None, vk=None,
                   gi: Optional[torch.Tensor] = None,
                   gi_out: Optional[torch.Tensor] = None,
                   halo: Optional[ZHalo] = None) -> torch.Tensor:
    """One time step from `fi` into `out` (allocated when None; must not
    alias `fi`), with the VK inlet sites of `vk` when given; returns `out`.
    A thermal configuration also steps `gi` into the caller's `gi_out`.
    `halo`: `fi` is one z slab of a split domain and the step is K8, the
    halo mode (see `stream_collide_plain`).  CPU tensors run the plain
    version; CUDA tensors launch K-SC and count the launch in
    `stream_collide.launches` (and, with sites, in
    `stream_collide.launches_vk` too; with a wall model, in
    `stream_collide.launches_wall`; thermal, an instance of
    `csrc/stream_collide_thermal.cu`, in `stream_collide.launches_thermal`;
    halo mode, an instance of `csrc/stream_collide_halo.cu`, in
    `stream_collide.launches_halo`; on the paired instance, `paired_step`,
    in `stream_collide.launches_pair`).  Every instance is the tiled body
    (`csrc/stream_collide_tiled.cuh`)."""
    check_config(config, forcing, vk)
    if fi.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no stream-collide kernel for {fi.device}")
    if out is None:
        out = torch.empty_like(fi)
    if out.data_ptr() == fi.data_ptr():
        raise ValueError("out must not alias fi (the kernel pulls from fi)")
    thermal = config.thermal
    if thermal:
        _check_thermal(gi, gi_out)
    if fi.device.type == "cpu":
        res = stream_collide_plain(fi, flags, dyn, config, forcing, fbc, vk,
                                   gi, gi_out, halo)
        _raw(out).copy_(_raw(res))
        return out

    dev = fi.device
    Z, Y, X = (int(v) for v in flags.shape)
    _check_tensor("fi", fi, storage_dtype(config.storage), (19, Z, Y, X), dev)
    _check_tensor("out", out, fi.dtype, fi.shape, dev)
    _check_tensor("flags", flags, torch.uint8, (Z, Y, X), dev)
    _check_tensor("dyn", dyn, torch.float32, (8,), dev)
    has_nudge = forcing.nudge_sigma is not None
    has_sponge = forcing.sponge_sigma_z is not None
    ptr = {k: None for k in ("nsig", "nface", "uw", "ue", "us", "un", "ut",
                             "ub", "sz")}
    mptr = {k: None for k in _FACE_FIELDS}
    if has_nudge:
        _check_tensor("nudge_sigma", forcing.nudge_sigma, torch.float32,
                      (Z, Y, X), dev)
        _check_tensor("nudge_face", forcing.nudge_face, torch.uint8,
                      (Z, Y, X), dev)
        ptr["nsig"] = forcing.nudge_sigma.data_ptr()
        ptr["nface"] = forcing.nudge_face.data_ptr()
    if has_sponge:
        _check_tensor("sponge_sigma_z", forcing.sponge_sigma_z, torch.float32,
                      (Z,), dev)
        ptr["sz"] = forcing.sponge_sigma_z.data_ptr()
    if has_nudge or has_sponge or vk is not None:
        ptr.update(_face_pointers(fbc, (Z, Y, X), dev))
    if vk is not None:
        mptr = _mask_pointers(vk, (Z, Y, X), dev)
    tt_ptr = None
    if thermal:
        _check_tensor("gi", gi, fi.dtype, (7, Z, Y, X), dev)
        _check_tensor("gi_out", gi_out, fi.dtype, (7, Z, Y, X), dev)
        if has_sponge:
            if fbc.tt is None:
                raise ValueError("a thermal step with the sponge needs "
                                 "FaceBC.tt")
            _check_tensor("fbc.tt", fbc.tt, torch.float32, (Y, X), dev)
            tt_ptr = fbc.tt.data_ptr()
    hp = _halo_pointers(halo, fi.dtype, (Y, X), dev, thermal)

    from ..utils.cuda_build import load_library

    lib = load_library()
    tau0 = 1.0 / config.omega
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.luw_stream_collide(
            fi.data_ptr(), out.data_ptr(), flags.data_ptr(), dyn.data_ptr(),
            ptr["nsig"], ptr["nface"], ptr["uw"], ptr["ue"], ptr["us"],
            ptr["un"], ptr["ut"], ptr["ub"], ptr["sz"], mptr["uw"],
            mptr["ue"], mptr["us"], mptr["un"], mptr["ut"], mptr["ub"],
            gi.data_ptr() if thermal else None,
            gi_out.data_ptr() if thermal else None, tt_ptr, Z, Y, X,
            _STORAGE_CODE[config.storage], int(config.volume_force),
            int(has_nudge), int(has_sponge), int(forcing.nudge_vertical),
            int(config.subgrid), config.omega, tau0, tau0 * tau0,
            wall_mode(config), int(config.collision == "trt"), config.wall_cd,
            config.wall_cd_sides, int(thermal), config.omega_t, config.beta,
            config.t_avg, *hp, stream)
    if rc != 0:
        raise RuntimeError(f"luw_stream_collide launch failed: CUDA error {rc}")
    count_launch(config, vk, halo,
                 paired_step(fi, out, flags, config, forcing, halo))
    return out


PAIRED_STORAGES = ("bf16", "f16")


def paired_step(fi: torch.Tensor, out: torch.Tensor, flags: torch.Tensor,
                config: StepConfig, forcing: Forcing,
                halo: Optional[ZHalo] = None) -> bool:
    """Whether K-SC steps `fi` on its paired instance (two cells per
    thread along x, every DDF access one 4-byte word;
    `csrc/stream_collide_tiled.cuh`): the plain family (no wall model, SRT,
    not thermal, not halo mode) in bf16 or f16, with X even and the words
    aligned (the DDFs to 4 bytes, the nudge band's sigma to 8 and face ids
    to 2, as torch allocates them).  The same test as the entry point's
    `pair_step`, so every other step keeps its instance."""
    plain = (not config.thermal and wall_mode(config) == 0
             and config.collision == "srt" and halo is None)
    nudge = [] if forcing.nudge_sigma is None else [
        (forcing.nudge_sigma, 8), (forcing.nudge_face, 2)]
    return (plain and config.storage in PAIRED_STORAGES
            and int(flags.shape[-1]) % 2 == 0
            and all(t.data_ptr() % n == 0
                    for t, n in [(fi, 4), (out, 4)] + nudge))


def count_launch(config: StepConfig, vk, halo: Optional[ZHalo],
                 paired: bool) -> None:
    """Count one K-SC launch in `stream_collide`'s counters."""
    stream_collide.launches += 1
    if vk is not None:
        stream_collide.launches_vk += 1
    if config.wall_model:
        stream_collide.launches_wall += 1
    if config.thermal:
        stream_collide.launches_thermal += 1
    if halo is not None:
        stream_collide.launches_halo += 1
    if paired:
        stream_collide.launches_pair += 1


def _face_pointers(fbc: Optional[FaceBC], shape, dev) -> dict:
    """{field: pointer} of the FaceBC velocity targets, checked."""
    if fbc is None:
        raise ValueError("nudging, sponge and VK sites need the FaceBC "
                         "targets (fbc)")
    Z, Y, X = shape
    out = {}
    for k, shp in (("uw", (Z, 3, Y)), ("ue", (Z, 3, Y)), ("us", (Z, 3, X)),
                   ("un", (Z, 3, X)), ("ut", (3, Y, X)), ("ub", (3, Y, X))):
        t = getattr(fbc, k)
        _check_tensor(f"fbc.{k}", t, torch.float32, shp, dev)
        out[k] = t.data_ptr()
    return out


def _mask_pointers(vk, shape, dev) -> dict:
    """{field: pointer} of the VK site masks (None where a face carries no
    site), checked."""
    Z, Y, X = shape
    mshape = {"uw": (Z, 1, Y), "ue": (Z, 1, Y), "us": (Z, 1, X),
              "un": (Z, 1, X), "ut": (Y, X), "ub": (Y, X)}
    out = dict.fromkeys(_FACE_FIELDS)
    for _kind, field in vk["sites"]:
        m = vk["masks"][field]
        _check_tensor(f"vk mask {field}", m, torch.float32, mshape[field], dev)
        out[field] = m.data_ptr()
    return out


def vk_sites(out: torch.Tensor, fbc: FaceBC, vk, storage: str, *,
             gy: int = 0, gx: int = 0) -> torch.Tensor:
    """The VK site pass alone, in place on the encoded step output `out`
    (19,Z,Y,X): the sites of `vk` from the FaceBC velocities `fbc`, on the
    faces of the box gy / gx inside the y / x edges (a halo-mode slab's
    ghost widths; 0 otherwise); returns `out`.  The step with sites is the
    step without them, then this pass.  CPU tensors run `apply_vk_sites`;
    CUDA tensors launch `vk_site_kernel` (`csrc/stream_collide.cu`, the
    kernel `stream_collide` launches after a step with sites) and count
    the launch in `vk_sites.launches`.  A `vk` without sites is refused."""
    _check_storage(storage)
    _check_vk(vk)
    if not vk["sites"]:
        raise ValueError("vk carries no site: the pass has nothing to do")
    Y, X = (int(v) for v in out.shape[-2:])
    if not (0 <= 2 * gy < Y and 0 <= 2 * gx < X):
        raise ValueError(f"ghost widths ({gy}, {gx}) leave no box in a "
                         f"({Y}, {X}) plane")
    if out.device.type == "cpu":
        apply_vk_sites(*_inner_box(out, fbc, vk, gy, gx), storage)
        return out
    if out.device.type != "cuda":
        raise NotImplementedError(f"no VK site kernel for {out.device}")
    dev = out.device
    Z = int(out.shape[1])
    _check_tensor("out", out, storage_dtype(storage), (19, Z, Y, X), dev)
    fp = _face_pointers(fbc, (Z, Y, X), dev)
    mp = _mask_pointers(vk, (Z, Y, X), dev)

    from ..utils.cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.luw_vk_sites(
            out.data_ptr(), *(mp[k] for k in _FACE_FIELDS),
            *(fp[k] for k in _FACE_FIELDS), Z, Y, X, gy, gx,
            _STORAGE_CODE[storage], stream)
    if rc != 0:
        raise RuntimeError(f"luw_vk_sites launch failed: CUDA error {rc}")
    vk_sites.launches += 1
    return out


def _halo_pointers(halo: Optional[ZHalo], dtype, plane, dev, thermal) -> tuple:
    """The entry point's halo arguments (fp, fm, fp channel stride, fm channel
    stride, flb, fla, gp, gm, gy, gx), all null / 0 without a halo."""
    if halo is None:
        return (None, None, 0, 0, None, None, None, None, 0, 0)
    Y, X = plane
    for name in ("fp", "fm"):
        t = getattr(halo, name)
        if (t.dtype != dtype or tuple(t.shape) != (5, Y, X) or t.device != dev
                or t.stride(1) != X or t.stride(2) != 1):
            raise ValueError(f"halo.{name}: want (5, {Y}, {X}) {dtype} on {dev} "
                             f"with contiguous planes, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, strides {t.stride()}")
    _check_tensor("halo.flb", halo.flb, torch.uint8, (Y, X), dev)
    _check_tensor("halo.fla", halo.fla, torch.uint8, (Y, X), dev)
    gp = gm = None
    if thermal:
        _check_tensor("halo.gp", halo.gp, dtype, (Y, X), dev)
        _check_tensor("halo.gm", halo.gm, dtype, (Y, X), dev)
        gp, gm = halo.gp.data_ptr(), halo.gm.data_ptr()
    if not (0 <= 2 * halo.gy < Y and 0 <= 2 * halo.gx < X):
        raise ValueError(f"ghost widths ({halo.gy}, {halo.gx}) leave no box "
                         f"in a ({Y}, {X}) plane")
    return (halo.fp.data_ptr(), halo.fm.data_ptr(), halo.fp.stride(0),
            halo.fm.stride(0), halo.flb.data_ptr(), halo.fla.data_ptr(), gp, gm,
            halo.gy, halo.gx)


stream_collide.launches = 0
stream_collide.launches_vk = 0
stream_collide.launches_wall = 0
stream_collide.launches_thermal = 0
stream_collide.launches_halo = 0
stream_collide.launches_pair = 0
vk_sites.launches = 0
