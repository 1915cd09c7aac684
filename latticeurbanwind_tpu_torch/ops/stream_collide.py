"""Fused D3Q19 stream-collide step: the CUDA kernel K-SC and its plain version.

Counterpart of `latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step`
(one launch per time step).  The semantics are the Pallas tier's pure-DDF
step: the kernel streams DDFs and flags only, TYPE_E cells freeze their
stored equilibria, TYPE_S cells go to zero, and the nudge / sponge targets
come from the static `FaceBC` built once from the initial velocity field.

`stream_collide` is the entry point.  A tensor on the CPU goes to
`stream_collide_plain` (torch ops with `torch.roll` pulls); a CUDA tensor
launches `csrc/stream_collide.cu` or raises.  There is no fallback between
the two.  Both take the same configurations: SRT + Smagorinsky LES with
equilibrium boundaries, f32 or bf16 storage, volume force (global force +
Coriolis) on or off, buffer nudging and the top sponge.  The rest raises
`NotImplementedError` naming the ROADMAP kernel item that ports it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..lbm.lattice import C19, CS, OPP19, SMAGORINSKY_FACTOR, W19
from ..lbm.state import (
    Forcing, StepConfig, TYPE_E, TYPE_S, decode_ddf, encode_ddf,
    storage_dtype,
)

_STORAGE_CODE = {"f32": 0, "bf16": 1}


class FaceBC(NamedTuple):
    """Static boundary-face targets for nudging and the sponge.

    Layouts as in the JAX package: uw/ue (Z, 3, Y), us/un (Z, 3, X),
    ut/ub (3, Y, X), all f32.  With pure-DDF stepping the face velocities
    are those of the initial field (the faces are TYPE_E cells)."""

    uw: torch.Tensor
    ue: torch.Tensor
    us: torch.Tensor
    un: torch.Tensor
    ut: torch.Tensor
    ub: torch.Tensor


def build_face_bc(u: torch.Tensor) -> FaceBC:
    """Face targets from the initialized boundary velocity field (3,Z,Y,X)."""
    def c(a):
        return a.to(torch.float32).contiguous()

    return FaceBC(
        uw=c(u[:, :, :, 0].transpose(0, 1)), ue=c(u[:, :, :, -1].transpose(0, 1)),
        us=c(u[:, :, 0, :].transpose(0, 1)), un=c(u[:, :, -1, :].transpose(0, 1)),
        ut=c(u[:, -1, :, :]), ub=c(u[:, 0, :, :]),
    )


def check_config(config: StepConfig, forcing: Forcing, vk=None) -> None:
    """Raise for a configuration K-SC (and its plain version) does not take."""
    if config.collision != "srt":
        raise NotImplementedError(
            "TRT collision is not ported yet (ROADMAP kernel item K2, TRT)")
    if config.wall_model:
        raise NotImplementedError(
            "wall_model is not ported yet (ROADMAP kernel item K4)")
    if config.wall_sides:
        raise NotImplementedError(
            "wall_sides is not ported yet (ROADMAP kernel item K4)")
    if config.thermal:
        raise NotImplementedError(
            "thermal D3Q7 is not ported yet (ROADMAP kernel item K7)")
    if config.storage not in _STORAGE_CODE:
        raise NotImplementedError(
            f"{config.storage} storage is not ported yet (ROADMAP kernel "
            "item K5, the f16/fp16c codecs)")
    if vk is not None:
        raise NotImplementedError(
            "VK inlet sites are not ported yet (ROADMAP kernel item K6)")
    has_forcing = (forcing.nudge_sigma is not None
                   or forcing.sponge_sigma_z is not None)
    if not config.volume_force and has_forcing:
        raise ValueError("volume_force=False requires no nudge/sponge forcing")


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


def stream_collide_plain(fi: torch.Tensor, flags: torch.Tensor,
                         dyn: torch.Tensor, config: StepConfig,
                         forcing: Forcing,
                         fbc: Optional[FaceBC] = None) -> torch.Tensor:
    """One step in plain torch: returns the post-collision DDFs (19,Z,Y,X) in
    storage dtype.  `dyn` is the (8,) row of `lbm.state.dyn_row`.  Same
    stages and evaluation order as the kernel and the Pallas step."""
    check_config(config, forcing)
    use_force = config.volume_force
    has_nudge = forcing.nudge_sigma is not None
    has_sponge = forcing.sponge_sigma_z is not None
    if (has_nudge or has_sponge) and fbc is None:
        raise ValueError("nudging/sponge need the FaceBC targets (fbc)")
    f_prev = decode_ddf(fi, config.storage)
    solid = (flags & TYPE_S) != 0
    eqbc = (flags & TYPE_E) != 0

    f = [f_prev[0]]
    for d in range(1, 19):
        src_solid = _roll(solid, C19[d])
        f.append(torch.where(src_solid, f_prev[int(OPP19[d])],
                             _roll(f_prev[d], C19[d])))

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

    one_m_w = 1.0 - w_eff
    cfin = 1.0 - 0.5 * w_eff
    out = torch.empty_like(fi)
    zero = torch.zeros((), dtype=fi.dtype, device=fi.device)
    for d in range(19):
        coll = one_m_w * f[d] + w_eff * feq[d]
        if use_force:
            coll = coll + cfin * fin[d]
        post = torch.where(eqbc, fi[d], encode_ddf(coll, config.storage))
        out[d] = torch.where(solid, zero, post)
    return out


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
                   out: Optional[torch.Tensor] = None, vk=None) -> torch.Tensor:
    """One time step from `fi` into `out` (allocated when None; must not
    alias `fi`).  CPU tensors run the plain version; CUDA tensors launch
    K-SC and count the launch in `stream_collide.launches`."""
    check_config(config, forcing, vk)
    if fi.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no stream-collide kernel for {fi.device}")
    if out is None:
        out = torch.empty_like(fi)
    if out.data_ptr() == fi.data_ptr():
        raise ValueError("out must not alias fi (the kernel pulls from fi)")
    if fi.device.type == "cpu":
        out.copy_(stream_collide_plain(fi, flags, dyn, config, forcing, fbc))
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
    if has_nudge or has_sponge:
        if fbc is None:
            raise ValueError("nudging/sponge need the FaceBC targets (fbc)")
        for k, shp in (("uw", (Z, 3, Y)), ("ue", (Z, 3, Y)), ("us", (Z, 3, X)),
                       ("un", (Z, 3, X)), ("ut", (3, Y, X)), ("ub", (3, Y, X))):
            t = getattr(fbc, k)
            _check_tensor(f"fbc.{k}", t, torch.float32, shp, dev)
            ptr[k] = t.data_ptr()

    from ..utils.cuda_build import load_library

    lib = load_library()
    tau0 = 1.0 / config.omega
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.luw_stream_collide(
            fi.data_ptr(), out.data_ptr(), flags.data_ptr(), dyn.data_ptr(),
            ptr["nsig"], ptr["nface"], ptr["uw"], ptr["ue"], ptr["us"],
            ptr["un"], ptr["ut"], ptr["ub"], ptr["sz"], Z, Y, X,
            _STORAGE_CODE[config.storage], int(config.volume_force),
            int(has_nudge), int(has_sponge), int(forcing.nudge_vertical),
            int(config.subgrid), config.omega, tau0, tau0 * tau0, stream)
    if rc != 0:
        raise RuntimeError(f"luw_stream_collide launch failed: CUDA error {rc}")
    stream_collide.launches += 1
    return out


stream_collide.launches = 0
