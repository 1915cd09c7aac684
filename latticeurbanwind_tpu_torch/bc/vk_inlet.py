"""Von Kármán synthetic-turbulence inlet (PyTorch port).

Counterpart of `latticeurbanwind_tpu/bc/vk_inlet.py` (reference:
setup.cpp:413-1150, kernel vk_inlet_apply kernel.cpp:2495-2571).  The host
side -- `VkConfig`, face selection, the inlet point lists, the mode sampling
(numpy Philox streams), `build_vk_runtime` and `vk_config_from_deck` -- is
the JAX package's numpy code unchanged, so both packages build bit-equal
runtimes from the same deck.

`make_vk_pre_step` builds the per-step hooks in torch on one device:

  * the hook itself, `pre_step(state, t)`, writes the perturbed inlet
    velocities into `state.u` (the JAX reference tier's hook);
  * `pre_step.ddf(fbc, t, aux) -> (fbc, aux)`, the pure-DDF hook the stepper
    runs before every step: it refreshes the FaceBC face-velocity targets
    with realization t, which the stream-collide kernel then reads both as
    the nudge targets and as the velocities of its inlet sites
    (`.kernel_spec`: the sites and their 0/1 masks).  `.init_aux(t0)` gives
    the loop-carried anchor realizations of the interpolating stride mode.

The mode sum is the JAX package's separable factorization: per face,
cos/sin over (M, R) at time t and a product with a static (2M, 3C) matrix.
Faces of one shape (west/east, south/north) are stacked and refreshed by
one batch of torch ops, so a step costs a few launches per face pair.  The
time argument a0 + omega t is formed in float32 from a float32 t, as in the
JAX package.  The JAX hook's shard offsets are not needed: a split run
(`parallel/halo.py`) refreshes the whole domain's FaceBC once per step and
slices it per shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..lbm.state import LBMState, TYPE_E, TYPE_S
from ..ops.stream_collide import VK_SITES, FaceBC
from ..utils.trace import span

WEST, EAST, SOUTH, NORTH, TOP = range(5)
FACE_NORMALS = np.array([
    (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
    (0.0, 0.0, -1.0),
], dtype=np.float64)
NMODES_MAX = 512
SITE_OF = {field: kind for kind, (field, _) in VK_SITES.items()}

# face selection policies (reference VkInletFaceMode)
AUTO_SIDES, TARGET_INFLOW, EXCLUDE_DOWNSTREAM, EXCLUDE_DOWNSTREAM_SIDES, \
    ALL_SIDES, ALL_SELECTED = range(6)


@dataclass(frozen=True)
class VkConfig:
    enable: bool = True
    ti: float = 0.05
    sigma_lbm: float = 0.0
    L_lbm: float = 100.0
    nmodes: int = 256
    seed: int = 100
    update_stride: int = 1
    uc_norm_mean: bool = True          # NORM_MEAN vs NORMAL_COMPONENT
    same_realization_all_faces: bool = True
    stride_interpolation: bool = False
    inflow_only: bool = False
    face_mode: int = AUTO_SIDES
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    downstream_face_id: int = -1       # 0..3 (W,E,S,N), -1 unknown

    def resolved_face_mode(self) -> int:
        if self.face_mode != AUTO_SIDES:
            return self.face_mode
        return EXCLUDE_DOWNSTREAM_SIDES if self.inflow_only else ALL_SIDES


class VkRuntime(NamedTuple):
    """Device-side inlet state (pytree); empty arrays when inactive."""

    idx: Tuple[np.ndarray, np.ndarray, np.ndarray]  # (z, y, x) point indices
    points: np.ndarray        # (P, 3) lattice positions (x, y, z)
    base_u: np.ndarray        # (3, P)
    sigma: np.ndarray         # (P,)
    face_of: np.ndarray       # (P,) int32
    modes_k: np.ndarray       # (5, M, 3)
    modes_omega: np.ndarray   # (5, M)
    modes_A: np.ndarray       # (5, M, 3)
    modes_phi: np.ndarray     # (5, M, 3)
    grid: Tuple[int, int, int] = (0, 0, 0)   # (Z, Y, X) of the lattice


def _opposite_side(face_id: int) -> int:
    return {WEST: EAST, EAST: WEST, SOUTH: NORTH, NORTH: SOUTH}.get(face_id, -1)


def _face_allowed(cfg: VkConfig, face_id: int) -> bool:
    mode = cfg.resolved_face_mode()
    target = _opposite_side(cfg.downstream_face_id)
    if mode == TARGET_INFLOW:
        if target >= 0 and face_id != target:
            return False
        if target < 0 and face_id == TOP and cfg.inflow_only:
            return False
    elif mode == EXCLUDE_DOWNSTREAM:
        if cfg.downstream_face_id >= 0 and face_id == cfg.downstream_face_id:
            return False
    elif mode == EXCLUDE_DOWNSTREAM_SIDES:
        if face_id == TOP:
            return False
        if cfg.downstream_face_id >= 0 and face_id == cfg.downstream_face_id:
            return False
    elif mode == ALL_SIDES:
        if face_id == TOP:
            return False
    elif face_id == TOP and cfg.inflow_only:
        return False
    return True


def _collect_points(cfg: VkConfig, flags: np.ndarray, u: np.ndarray):
    """Per-face inlet point lists following the reference's exclusive-ownership
    loops (west/east own the y corners; south/north skip them)."""
    Z, Y, X = flags.shape
    eligible = ((flags & TYPE_E) != 0) & ((flags & TYPE_S) == 0)
    faces = {}

    def take(face_id, zz, yy, xx):
        if not _face_allowed(cfg, face_id):
            return
        m = eligible[zz, yy, xx]
        faces[face_id] = (zz[m], yy[m], xx[m])

    zi = np.arange(1, Z - 1)
    # west / east: all y, z interior
    zz, yy = np.meshgrid(zi, np.arange(Y), indexing="ij")
    take(WEST, zz.ravel(), yy.ravel(), np.zeros(zz.size, dtype=int))
    take(EAST, zz.ravel(), yy.ravel(), np.full(zz.size, X - 1))
    if X > 2:
        zz, xx = np.meshgrid(zi, np.arange(1, X - 1), indexing="ij")
        take(SOUTH, zz.ravel(), np.zeros(zz.size, dtype=int), xx.ravel())
        take(NORTH, zz.ravel(), np.full(zz.size, Y - 1), xx.ravel())
    yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    take(TOP, np.full(yy.size, Z - 1), yy.ravel(), xx.ravel())
    return faces


def _sample_modes(cfg: VkConfig, u_ref: float, conv_dir: np.ndarray,
                  seed: int) -> Optional[dict]:
    L = cfg.L_lbm
    M = min(max(cfg.nmodes, 1), NMODES_MAX)
    if L <= 0 or M <= 0:
        return None
    k_max = math.pi / 1.0
    k_min = 2.0 * math.pi / (10.0 * L)
    if not (k_min > 0 and math.isfinite(k_min)):
        k_min = 1e-4
    if k_min >= 0.99 * k_max:
        k_min = 0.1 * k_max
    rng = np.random.default_rng(np.random.Philox(seed))
    xi = (np.arange(M) + rng.uniform(size=M)) / M
    k = np.exp(math.log(k_min) + xi * max(math.log(k_max) - math.log(k_min), 1e-6))
    zeta = 2.0 * rng.uniform(size=M) - 1.0
    az = 2.0 * math.pi * rng.uniform(size=M)
    r = np.sqrt(np.maximum(0.0, 1.0 - zeta ** 2))
    kvec = np.stack([k * r * np.cos(az), k * r * np.sin(az), k * zeta], axis=1)
    kL = k * L
    W = k ** 4 / (1.0 + kL ** 2) ** (17.0 / 6.0)
    a = np.sqrt(np.maximum(W, 0.0))
    var = 0.5 * float((a ** 2).sum())
    if var <= 0:
        return None
    A = (a / math.sqrt(var))[:, None] * np.asarray(cfg.anisotropy)[None, :]
    omega = u_ref * (kvec @ conv_dir)
    phi = 2.0 * math.pi * rng.uniform(size=(M, 3))
    return dict(k=kvec, omega=omega, A=A, phi=phi)


def _mix_seed(seed: int, face_id: int) -> int:
    x = (seed ^ (0x9E3779B97F4A7C15 * (face_id + 1))) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    return x


def build_vk_runtime(cfg: VkConfig, flags: np.ndarray,
                     u: np.ndarray) -> Optional[VkRuntime]:
    """Assemble the inlet runtime from the initialized boundary fields.

    Returns None when disabled or no valid inflow faces exist."""
    if not cfg.enable or cfg.L_lbm <= 0 or cfg.nmodes <= 0:
        return None
    Z, Y, X = flags.shape
    if min(Z, Y, X) < 2:
        return None
    faces = _collect_points(cfg, flags, u)

    # per-face characteristic speed and enablement
    active = {}
    for fid, (zz, yy, xx) in faces.items():
        if len(zz) == 0:
            continue
        base = u[:, zz, yy, xx]                       # (3, P_f)
        mean_u = base.mean(axis=1)
        uc = (np.linalg.norm(mean_u) if cfg.uc_norm_mean
              else abs(float(mean_u @ FACE_NORMALS[fid])))
        if uc <= 1e-7:
            continue
        active[fid] = (zz, yy, xx, base)
    if not active:
        return None

    all_base = np.concatenate([v[3] for v in active.values()], axis=1)
    u_ref = float(np.linalg.norm(all_base, axis=0).mean())
    mean_u = all_base.mean(axis=1)
    conv = mean_u / np.linalg.norm(mean_u) if np.linalg.norm(mean_u) > 1e-7 \
        else np.array([1.0, 0.0, 0.0])

    M = min(max(cfg.nmodes, 1), NMODES_MAX)
    modes_k = np.zeros((5, M, 3), np.float32)
    modes_omega = np.zeros((5, M), np.float32)
    modes_A = np.zeros((5, M, 3), np.float32)
    modes_phi = np.zeros((5, M, 3), np.float32)
    shared = _sample_modes(cfg, u_ref, conv, cfg.seed) \
        if cfg.same_realization_all_faces else None
    for fid in active:
        m = shared if shared is not None else _sample_modes(
            cfg, u_ref, conv, _mix_seed(cfg.seed, fid))
        if m is None:
            return None
        modes_k[fid] = m["k"]
        modes_omega[fid] = m["omega"]
        modes_A[fid] = m["A"]
        modes_phi[fid] = m["phi"]

    zs, ys, xs, bases, fids, sigmas = [], [], [], [], [], []
    for fid, (zz, yy, xx, base) in active.items():
        uc_pt = (np.linalg.norm(base, axis=0) if cfg.uc_norm_mean
                 else np.abs(FACE_NORMALS[fid] @ base))
        sigma = cfg.ti * uc_pt if cfg.ti > 0 else np.full(len(zz), cfg.sigma_lbm)
        keep = sigma > 0
        zs.append(zz[keep])
        ys.append(yy[keep])
        xs.append(xx[keep])
        bases.append(base[:, keep])
        fids.append(np.full(keep.sum(), fid, np.int32))
        sigmas.append(sigma[keep])
    zi = np.concatenate(zs)
    if len(zi) == 0:
        return None
    yi = np.concatenate(ys)
    xi = np.concatenate(xs)
    points = np.stack([xi, yi, zi], axis=1).astype(np.float32)
    return VkRuntime(
        idx=(zi.astype(np.int32), yi.astype(np.int32), xi.astype(np.int32)),
        points=points,
        base_u=np.concatenate(bases, axis=1).astype(np.float32),
        sigma=np.concatenate(sigmas).astype(np.float32),
        face_of=np.concatenate(fids),
        modes_k=modes_k, modes_omega=modes_omega,
        modes_A=modes_A, modes_phi=modes_phi,
        grid=(Z, Y, X),
    )


class _Group(NamedTuple):
    """Faces of one (R, C) shape, stacked on a leading face axis F."""

    fids: Tuple[int, ...]
    fields: Tuple[str, ...]      # FaceBC field of each face
    top: bool                    # (3, R, C) FaceBC layout, else (R, 3, C)
    R: int
    C: int
    a0: torch.Tensor             # (F, M)
    om: torch.Tensor             # (F, M)
    br: torch.Tensor             # (F, M)
    ymat: torch.Tensor           # (F, 2M, 3C)
    r_idx: torch.Tensor          # (R,)
    mask: torch.Tensor           # FaceBC layout with 1 for the 3: (F,R,1,C) / (F,1,R,C)
    omm: torch.Tensor            # 1 - mask
    base: torch.Tensor           # FaceBC layout: (F,R,3,C) / (F,3,R,C)
    sig: torch.Tensor            # as mask


def make_vk_pre_step(cfg: VkConfig, rt: VkRuntime,
                     device: torch.device | str = "cpu"):
    """Per-step inlet hooks on `device` (see the module docstring).  The
    returned callable is the reference-tier hook; `.ddf` is the pure-DDF
    hook with `.init_aux` and `.kernel_spec`.  Unlike the JAX hook it takes
    no storage: the kernel's sites encode in the step's own storage."""
    dev = torch.device(device)
    stride = max(1, cfg.update_stride)
    fstride = np.float32(stride)
    interp = cfg.stride_interpolation and stride > 1
    same = cfg.same_realization_all_faces
    face_of_np = np.asarray(rt.face_of)
    active_faces = sorted(set(int(f) for f in face_of_np))

    Z, Y, X = (int(v) for v in rt.grid)
    idx = tuple(np.asarray(a) for a in rt.idx)
    coord = {"z": idx[0], "y": idx[1], "x": idx[2]}
    size = {"z": Z, "y": Y, "x": X}
    # fid -> (u axis, slab index, row coord, col coord)
    FACE_DEF = {
        WEST: (3, 0, "z", "y"), EAST: (3, -1, "z", "y"),
        SOUTH: (2, 0, "z", "x"), NORTH: (2, -1, "z", "x"),
        TOP: (1, -1, "y", "x"),
    }
    # (axis, index) -> FaceBC field
    FBC_FIELD = {(3, 0): "uw", (3, -1): "ue", (2, 0): "us", (2, -1): "un",
                 (1, -1): "ut", (1, 0): "ub"}

    A_np = np.asarray(rt.modes_A)                            # (5, M, 3)
    ph_np = np.asarray(rt.modes_phi)
    # cos(theta + phi_c) = cos(theta) cos(phi_c) - sin(theta) sin(phi_c):
    # Ac/As fold the per-component phase into the amplitudes
    Ac_np = A_np * np.cos(ph_np)
    As_np = A_np * np.sin(ph_np)
    kk_np = np.asarray(rt.modes_k)
    om_np = np.asarray(rt.modes_omega)

    def face_geometry(fid):
        """Face grid -> lattice position: pos(r, c) = base + r e_r + c e_c."""
        base = np.zeros(3)
        er = np.zeros(3)
        ec = np.zeros(3)
        if fid in (WEST, EAST):
            base[0] = 0.0 if fid == WEST else X - 1
            er[2] = 1.0          # rows span z
            ec[1] = 1.0          # cols span y
        elif fid in (SOUTH, NORTH):
            base[1] = 0.0 if fid == SOUTH else Y - 1
            er[2] = 1.0
            ec[0] = 1.0
        else:                    # TOP
            base[2] = Z - 1.0
            er[1] = 1.0
            ec[0] = 1.0
        return base, er, ec

    # per-face host data, in the JAX package's float32 arithmetic
    per_face = {}
    for fid in active_faces:
        axis, index, rs, cs = FACE_DEF[fid]
        sel = face_of_np == fid
        R, C = size[rs], size[cs]
        rows, cols = coord[rs][sel], coord[cs][sel]
        mask = np.zeros((R, C), np.float32)
        mask[rows, cols] = 1.0
        base = np.zeros((3, R, C), np.float32)
        base[:, rows, cols] = np.asarray(rt.base_u)[:, sel]
        sig = np.zeros((R, C), np.float32)
        sig[rows, cols] = np.asarray(rt.sigma)[sel]
        # separable mode sum: theta(r, c, t) = (k.base + omega t + r k.e_r)
        # + c k.e_c, so cos(theta + phi) splits into a time-dependent (M, R)
        # cos/sin pair and a static (2M, 3C) matrix
        mid = active_faces[0] if same else fid
        gbase, ger, gec = face_geometry(fid)
        km = kk_np[mid]                              # (M, 3)
        cv = np.outer(km @ gec, np.arange(C))        # (M, C)
        CV, SV = np.cos(cv), np.sin(cv)
        Ac, As = Ac_np[mid], As_np[mid]              # (M, 3)
        ytop = np.concatenate(
            [Ac[:, i:i + 1] * CV - As[:, i:i + 1] * SV for i in range(3)], axis=1)
        ybot = np.concatenate(
            [-(Ac[:, i:i + 1] * SV + As[:, i:i + 1] * CV) for i in range(3)], axis=1)
        per_face[fid] = dict(
            key=(axis, index), R=R, C=C, mask=mask, base=base, sig=sig,
            a0=(km @ gbase).astype(np.float32), br=(km @ ger).astype(np.float32),
            om=np.asarray(om_np[mid], np.float32),
            ymat=np.concatenate([ytop, ybot], 0).astype(np.float32))

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    groups = []
    for members in ((WEST, EAST), (SOUTH, NORTH), (TOP,)):
        fids = tuple(f for f in members if f in per_face)
        if not fids:
            continue
        pf = [per_face[f] for f in fids]
        top = fids == (TOP,)
        R, C = pf[0]["R"], pf[0]["C"]
        mask = np.stack([p["mask"] for p in pf])              # (F, R, C)
        sig = np.stack([p["sig"] for p in pf])
        base = np.stack([p["base"] for p in pf])              # (F, 3, R, C)
        if top:
            mask, sig = mask[:, None], sig[:, None]           # (F, 1, R, C)
        else:
            mask, sig = mask[:, :, None], sig[:, :, None]     # (F, R, 1, C)
            base = base.transpose(0, 2, 1, 3)                 # (F, R, 3, C)
        groups.append(_Group(
            fids=fids, fields=tuple(FBC_FIELD[p["key"]] for p in pf), top=top,
            R=R, C=C,
            a0=T(np.stack([p["a0"] for p in pf])),
            om=T(np.stack([p["om"] for p in pf])),
            br=T(np.stack([p["br"] for p in pf])),
            ymat=T(np.stack([p["ymat"] for p in pf])),
            r_idx=T(np.arange(R, dtype=np.float32)),
            mask=T(mask), omm=T(np.float32(1.0) - mask), base=T(base),
            sig=T(sig)))

    def group_q(g: _Group, tf: np.float32) -> torch.Tensor:
        """Unit-RMS mode sum of the group's faces at time tf, in the FaceBC
        layout: (F, R, 3, C), or (F, 3, R, C) for the top plane."""
        F = len(g.fids)
        u = (g.a0 + g.om * float(tf))[:, :, None] \
            + g.br[:, :, None] * g.r_idx                       # (F, M, R)
        xr = torch.cat([torch.cos(u), torch.sin(u)], 1)        # (F, 2M, R)
        q = torch.bmm(xr.transpose(1, 2), g.ymat)              # (F, R, 3C)
        q = q.view(F, g.R, 3, g.C)
        return q.permute(0, 2, 1, 3).contiguous() if g.top else q

    def anchor_of(t) -> Tuple[np.float32, np.float32]:
        tf = np.float32(t)
        return tf, np.float32(np.floor(tf / fstride) * fstride)

    def q_at(t):
        """Per-group realization at step t (stride hold or interpolation)."""
        tf, anchor = anchor_of(t)
        if interp:
            a = float((tf - anchor) / fstride)
            out = []
            for g in groups:
                q = group_q(g, anchor)
                out.append(q + a * (group_q(g, anchor + fstride) - q))
            return out
        return [group_q(g, anchor if stride > 1 else tf) for g in groups]

    def newf_of(qs):
        """u' = base + sigma * q per group, FaceBC layout."""
        return [g.base + g.sig * q for g, q in zip(groups, qs)]

    def pre_step(state: LBMState, t) -> LBMState:
        """Reference-tier hook: perturb the inlet velocities of `state.u`."""
        u = state.u.clone()
        for g, newf in zip(groups, newf_of(q_at(t))):
            for i, fid in enumerate(g.fids):
                axis, index, _, _ = FACE_DEF[fid]
                if g.top:
                    nf, m = newf[i], g.mask[i]                 # (3,R,C), (1,R,C)
                else:
                    nf, m = newf[i].transpose(0, 1), g.mask[i].transpose(0, 1)
                if axis == 1:
                    sl = (slice(None), index)
                elif axis == 2:
                    sl = (slice(None), slice(None), index)
                else:
                    sl = (slice(None), slice(None), slice(None), index)
                u[sl] = m * nf + (1.0 - m) * u[sl]
        return state._replace(u=u)

    def apply(fbc: FaceBC, qs) -> FaceBC:
        """FaceBC with every active face blended toward u' by its mask."""
        if fbc is None:
            raise ValueError("the VK inlet needs the FaceBC carried targets")
        upd = {}
        for g, newf in zip(groups, newf_of(qs)):
            cur = torch.stack([getattr(fbc, f) for f in g.fields])
            new = g.mask * newf + g.omm * cur
            for i, f in enumerate(g.fields):
                upd[f] = new[i]
        return fbc._replace(**upd)

    def init_aux(t0):
        """Loop-carried anchor realizations of the interpolating stride mode
        (None otherwise); the stepper calls it at the start of every run."""
        if not interp:
            return None
        _, anchor = anchor_of(t0)
        return (anchor, [group_q(g, anchor) for g in groups],
                [group_q(g, anchor + fstride) for g in groups])

    def ddf_pre_step(fbc: FaceBC, t, aux=None):
        """Pure-DDF hook: (FaceBC, aux) after refreshing the face targets
        with realization t.  With stride > 1 and no interpolation the targets
        change only at anchor steps; with interpolation the two anchor
        realizations ride in `aux` and each step lerps them."""
        with span("vk.refresh"):
            if stride > 1 and not interp:
                if int(t) % stride != 0:
                    return fbc, aux
                return apply(fbc, q_at(t)), aux
            if interp and aux is not None:
                tf, anchor = anchor_of(t)
                if anchor != aux[0]:
                    aux = (anchor, [group_q(g, anchor) for g in groups],
                           [group_q(g, anchor + fstride) for g in groups])
                frac = float((tf - aux[0]) / fstride)
                qs = [q0 + frac * (q1 - q0) for q0, q1 in zip(aux[1], aux[2])]
                return apply(fbc, qs), aux
            return apply(fbc, q_at(t)), aux

    # kernel site spec: where the stream-collide kernel applies the inlet
    # equilibria from the FaceBC targets (lane/row masks (R, 1, C))
    sites = []
    site_masks = {}
    for fid in active_faces:
        p = per_face[fid]
        field_ = FBC_FIELD[p["key"]]
        kind = SITE_OF[field_]
        m = p["mask"]
        site_masks[field_] = m if kind in ("planeL", "plane0") else m[:, None, :]
        sites.append((kind, field_))
    ddf_pre_step.kernel_spec = {
        "sites": tuple(sites),
        "masks": {k: T(v) for k, v in site_masks.items()},
    }
    ddf_pre_step.init_aux = init_aux
    pre_step.ddf = ddf_pre_step
    return pre_step


def vk_config_from_deck(deck, *, units, downstream_bc: str) -> VkConfig:
    """Deck keys -> VkConfig in lattice units (reference make_vk_runtime_config)."""
    ds_map = {"-x": 0, "+x": 1, "-y": 2, "+y": 3}
    aniso = deck.get_float_list("vk_inlet_anisotropy") or [1.0, 1.0, 1.0]
    if len(aniso) != 3 or any((not np.isfinite(v)) or v < 0 for v in aniso):
        aniso = [1.0, 1.0, 1.0]
    seed_text = deck.get_text("vk_inlet_seed", "100") or "100"
    try:
        seed = int(float(seed_text))
    except ValueError:
        # deterministic digest — Python's salted hash() would give a
        # different turbulence realization on every process run
        import hashlib

        seed = int.from_bytes(
            hashlib.sha256(seed_text.encode()).digest()[:8], "little") >> 1
    nmodes = deck.get_int("vk_inlet_nmodes", 256) or 256
    if nmodes > NMODES_MAX:
        nmodes = NMODES_MAX
    if nmodes <= 0:
        nmodes = 256
    stride = deck.get_int("vk_inlet_update_stride", 1) or 1
    return VkConfig(
        enable=bool(deck.get_bool("turb_inflow_enable", True)),
        ti=deck.get_float("vk_inlet_ti", 0.05) or 0.0,
        sigma_lbm=units.u(deck.get_float("vk_inlet_sigma", 0.0) or 0.0),
        L_lbm=units.x(deck.get_float("vk_inlet_l", 100.0) or 100.0),
        nmodes=nmodes,
        seed=seed,
        update_stride=max(1, stride),
        uc_norm_mean=(deck.get_text("vk_inlet_uc_mode", "NORM_MEAN") or "NORM_MEAN")
        .upper() != "NORMAL_COMPONENT",
        same_realization_all_faces=bool(
            deck.get_bool("vk_inlet_same_realization_all_faces", True)),
        stride_interpolation=bool(deck.get_bool("vk_inlet_stride_interpolation", False)),
        inflow_only=bool(deck.get_bool("vk_inlet_inflow_only", False)),
        face_mode=AUTO_SIDES,
        anisotropy=tuple(aniso),
        downstream_face_id=ds_map.get(downstream_bc, -1),
    )
