"""The D3Q19 stream-collide step in plain torch (the reference's K-SC).

A frozen copy of the port's plain version of its stream-collide kernel
(the pure-DDF step: streaming with bounce-back, SRT/TRT collision with the
Smagorinsky LES, Guo forcing with Coriolis, buffer nudging and the top
sponge toward the FaceBC targets, the VK inlet sites), without the CUDA
entry points.  The benchmark compares the program's kernels against it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fields import pull, wall_stress
from .lattice import C19, CS, OPP19, SMAGORINSKY_FACTOR, W19
from .state import (
    Forcing, StepConfig, TYPE_E, TYPE_S, decode_ddf, encode_ddf, raw_bits,
    wall_mode,
)

_STORAGE_CODE = {"f32": 0, "bf16": 1, "f16": 2, "fp16c": 3, "fp8": 4}

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


def stream_collide_plain(fi: torch.Tensor, flags: torch.Tensor,
                         dyn: torch.Tensor, config: StepConfig,
                         forcing: Forcing,
                         fbc: Optional[FaceBC] = None, vk=None) -> torch.Tensor:
    """One step in plain torch: returns the post-collision DDFs (19,Z,Y,X) in
    storage dtype.  `dyn` is the (8,) dynamic row; `vk` the inlet site
    spec.  Same stages and evaluation order as the port's kernel.  The
    thermal and split-slab variants of the port are not copied: no cell of
    the benchmark runs them yet."""
    check_config(config, forcing, vk)
    use_force = config.volume_force
    has_nudge = forcing.nudge_sigma is not None
    has_sponge = forcing.sponge_sigma_z is not None
    if (has_nudge or has_sponge or vk is not None) and fbc is None:
        raise ValueError("nudging, sponge and VK sites need the FaceBC "
                         "targets (fbc)")
    if config.thermal:
        raise NotImplementedError("the reference copies no thermal step")
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
