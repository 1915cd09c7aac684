"""On-demand field materialization: rho/u/T from the DDF arrays (plain torch).

Counterpart of `latticeurbanwind_tpu/lbm/fields.py::update_fields`, which
XLA (not a Pallas kernel) runs in the JAX package; it stays torch here.  The
stepper streams DDFs only, so rho/u in an `LBMState` are stale until this
pass refreshes them at event steps.  Semantics (reference kernel.cpp:1938):

  * populations are streamed first, with halfway bounce-back from solid
    sources, or the wall models' specular mirrors (the stored DDFs are
    post-collision);
  * the Guo half-step uses the global force + Coriolis and the wall
    models' Schumann stress — the nudge and sponge forces of the step are
    left out here, as in the reference — followed by the +-CS clamp;
  * TYPE_E cells report the moments of their own frozen equilibria;
  * thermal: T = 1 + the streamed g populations (plain bounce-back), at
    TYPE_T cells 1 + the cell's own, and the Boussinesq term
    -dyn.force * beta * (T - t_avg) joins the half-step force;
  * solid cells keep their existing rho/u/T.

One z slab of a domain split over devices (`parallel/halo.py`) takes its z
neighbours from its halo planes (`halo_extend`, the `halo` of
`update_fields`) instead of wrapping.

The whole grid is processed at once, one opposite-direction pair (with the
wall models, one direction) at a time, so the transient is a few f32 planes
(no z-window chunking: the H100's 80 GB hold the transient of a 71M-cell
thermal grid, which chip_smoke.py runs).

`pull` and `wall_stress` are the streaming and the stress of the plain
stream-collide step (`ops.stream_collide.stream_collide_plain`) too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from .lattice import C7, C19, CS, MIR_X, MIR_Y, MIR_Z, OPP7, OPP19
from .state import (
    DynParams, LBMState, StepConfig, TYPE_E, TYPE_S, TYPE_T, ZHalo,
    decode_ddf, raw_bits as _bits, wall_mode,
)


def _roll(a: torch.Tensor, c, sign: int = 1) -> torch.Tensor:
    cx, cy, cz = (sign * int(v) for v in c)
    return torch.roll(a, shifts=(cz, cy, cx), dims=(0, 1, 2))


def pull(chan: Callable[[int], torch.Tensor], solid: torch.Tensor, d: int,
         wall: int = 0) -> torch.Tensor:
    """Direction d streamed into every cell (periodic): the value pulled
    from x - c_d, or where that source is solid the bounce-back value
    f_opp(x), replaced by the wall models' mirrors where their partner cell
    is fluid -- the y face, then the x face, then the ground, the later
    select winning (JAX `lbm/reference.py::_stream`).  `chan(k)` is channel
    k of the previous step's DDFs, decoded; `wall` is `wall_mode`."""
    cx, cy, cz = (int(v) for v in C19[d])
    repl = chan(int(OPP19[d]))
    for m, shift, on in ((MIR_Y[d], (cx, 0, cz), wall == 2),
                         (MIR_X[d], (0, cy, cz), wall == 2),
                         (MIR_Z[d], (cx, cy, 0), wall >= 1)):
        if on and m is not None:
            repl = torch.where(_roll(solid, shift), repl, _roll(chan(m), shift))
    return torch.where(_roll(solid, C19[d]), repl, _roll(chan(d), C19[d]))


def pull_g(chan: Callable[[int], torch.Tensor], solid: torch.Tensor,
           d: int) -> torch.Tensor:
    """D3Q7 direction d streamed into every cell (periodic), with halfway
    bounce-back from solid sources; the thermal sub-lattice has no mirrors."""
    if d == 0:
        return chan(0)
    return torch.where(_roll(solid, C7[d]), chan(int(OPP7[d])),
                       _roll(chan(d), C7[d]))


def wall_stress(F: List[torch.Tensor], u, rho: torch.Tensor,
                solid: torch.Tensor, config: StepConfig) -> List[torch.Tensor]:
    """F with the wall models' Schumann stress: -Cd rho |u_h| u_h at fluid
    cells above a solid cell (z - 1), and with `wall_sides` and Cd_sides > 0
    -Cd_sides rho |u_t| u_t beside x faces (along y, z) and y faces (along
    x, z), in the Pallas step's evaluation order (:678-703)."""
    F = list(F)
    if config.wall_model:
        ga = (~solid) & _roll(solid, (0, 0, 1))
        uh = torch.sqrt(u[0] * u[0] + u[1] * u[1])
        cw = config.wall_cd * ga * rho * uh
        F[0] = F[0] - cw * u[0]
        F[1] = F[1] - cw * u[1]
    if config.wall_sides and config.wall_cd_sides > 0.0:
        fl = ~solid
        gx = fl & (_roll(solid, (1, 0, 0)) | _roll(solid, (-1, 0, 0)))
        gy = fl & (_roll(solid, (0, 1, 0)) | _roll(solid, (0, -1, 0)))
        ut_x = torch.sqrt(u[1] * u[1] + u[2] * u[2])
        ut_y = torch.sqrt(u[0] * u[0] + u[2] * u[2])
        cwx = config.wall_cd_sides * gx * rho * ut_x
        cwy = config.wall_cd_sides * gy * rho * ut_y
        F[0] = F[0] - cwy * u[0]
        F[1] = F[1] - cwx * u[1]
        F[2] = F[2] - (cwx + cwy) * u[2]
    return F


def stream_moments(fi: torch.Tensor, flags: torch.Tensor, storage: str,
                   wall: int = 0):
    """(rho_streamed, mom_streamed, rho_own, mom_own) summed over opposite
    direction pairs, as the JAX package's `_stream_moments` does; with a
    wall model (`wall` > 0) summed one direction at a time in index order,
    as its `_stream_moments_sides` and the kernels do."""
    solid = (flags & TYPE_S) != 0
    rest = decode_ddf(fi[0], storage)
    rho_s, rho_o = rest.clone(), rest.clone()
    mom_s = [torch.zeros_like(rest) for _ in range(3)]
    mom_o = [torch.zeros_like(rest) for _ in range(3)]
    if wall:
        def chan(k):
            return decode_ddf(fi[k], storage)

        for d in range(1, 19):
            s = pull(chan, solid, d, wall)
            a = chan(d)
            rho_s = rho_s + s
            rho_o = rho_o + a
            for k in range(3):
                ck = int(C19[d, k])
                if ck:
                    mom_s[k] = mom_s[k] + ck * s
                    mom_o[k] = mom_o[k] + ck * a
        return 1.0 + rho_s, mom_s, 1.0 + rho_o, mom_o
    for d in range(1, 19):
        od = int(OPP19[d])
        if od < d:
            continue
        c = C19[d]
        a = decode_ddf(fi[d], storage)
        b = decode_ddf(fi[od], storage)
        sa = torch.where(_roll(solid, c), b, _roll(a, c))
        sb = torch.where(_roll(solid, c, -1), a, _roll(b, c, -1))
        rho_s = rho_s + (sa + sb)
        rho_o = rho_o + (a + b)
        for k in range(3):
            ck = int(c[k])
            if ck:
                mom_s[k] = mom_s[k] + ck * (sa - sb)
                mom_o[k] = mom_o[k] + ck * (a - b)
    return 1.0 + rho_s, mom_s, 1.0 + rho_o, mom_o


def stream_temperature(gi: torch.Tensor, flags: torch.Tensor, storage: str):
    """(T_streamed, T_own) from the D3Q7 populations, summed over opposite
    pairs as the JAX package's `_stream_moments` does."""
    solid = (flags & TYPE_S) != 0
    rest = decode_ddf(gi[0], storage)
    t_s, t_o = rest.clone(), rest.clone()
    for d in (1, 3, 5):
        c = C7[d]
        a = decode_ddf(gi[d], storage)
        b = decode_ddf(gi[int(OPP7[d])], storage)
        sa = torch.where(_roll(solid, c), b, _roll(a, c))
        sb = torch.where(_roll(solid, c, -1), a, _roll(b, c, -1))
        t_s = t_s + (sa + sb)
        t_o = t_o + (a + b)
    return 1.0 + t_s, 1.0 + t_o


def field_moments(fi: torch.Tensor, flags: torch.Tensor, dyn: torch.Tensor,
                  config: StepConfig, gi: Optional[torch.Tensor] = None):
    """(rho, u, T) the fields pass reports at every cell (solid cells
    included; callers mask them); T is None without the `gi` of a thermal
    configuration.  `dyn` is the (8,) row of `dyn_row`."""
    rho_s, mom_s, rho_o, mom_o = stream_moments(fi, flags, config.storage,
                                                wall_mode(config))
    u_s = [m / rho_s for m in mom_s]
    fx, fy, fz, ox, oy, oz = (dyn[i] for i in range(6))
    F = [fx - 2.0 * rho_s * (oy * u_s[2] - oz * u_s[1]),
         fy - 2.0 * rho_s * (oz * u_s[0] - ox * u_s[2]),
         fz - 2.0 * rho_s * (ox * u_s[1] - oy * u_s[0])]
    F = wall_stress(F, u_s, rho_s, (flags & TYPE_S) != 0, config)
    T = None
    if gi is not None:
        t_s, t_o = stream_temperature(gi, flags, config.storage)
        T = torch.where((flags & TYPE_T) != 0, t_o, t_s)
        bterm = config.beta * (T - config.t_avg)
        F = [F[0] - fx * bterm, F[1] - fy * bterm, F[2] - fz * bterm]
    half = 0.5 / rho_s
    eqbc = (flags & TYPE_E) != 0
    rho = torch.where(eqbc, rho_o, rho_s)
    u = torch.stack([
        torch.where(eqbc, mom_o[a] / rho_o,
                    torch.clamp(u_s[a] + F[a] * half, -CS, CS))
        for a in range(3)])
    return rho, u, T


def halo_extend(fi: torch.Tensor, flags: torch.Tensor, halo: ZHalo,
                gi: Optional[torch.Tensor] = None):
    """(fi, flags, gi) of a slab with its z-halo planes put beside it: one
    plane below (z = 0 of the result) and one above (z = Z + 1), holding the
    halo's channels and zeros in every channel the slab's cells do not pull
    from there.  Every cell of the slab then reads what it would read in the
    whole domain, and torch.roll's wrap reaches only the two halo planes,
    whose results the caller crops."""
    C, Z, Y, X = fi.shape
    fe = torch.zeros((C, Z + 2, Y, X), dtype=_bits(fi).dtype, device=fi.device)
    fe[:, 1:-1] = _bits(fi)
    fe[9:14, 0] = _bits(halo.fp)
    fe[14:19, -1] = _bits(halo.fm)
    fl = torch.cat([halo.flb[None], flags, halo.fla[None]])
    ge = None
    if gi is not None:
        ge = torch.zeros((7, Z + 2, Y, X), dtype=_bits(gi).dtype, device=gi.device)
        ge[:, 1:-1] = _bits(gi)
        ge[5, 0] = _bits(halo.gp)
        ge[6, -1] = _bits(halo.gm)
        ge = ge.view(gi.dtype)
    return fe.view(fi.dtype), fl, ge


def update_fields(state: LBMState, config: StepConfig,
                  dyn: Optional[DynParams] = None, *,
                  halo: Optional[ZHalo] = None) -> LBMState:
    """Refresh rho/u (and T of a thermal state) from the DDFs (reference
    kernel.cpp:1938); solid cells keep their previous values.  `halo`: the
    state is one z slab of a split domain, whose z neighbours beyond the
    slab are the halo's planes (`halo_extend`) instead of the periodic wrap;
    its y and x wrap inside the slab's ghost-extended plane, so the caller
    refreshes the ghosts first."""
    from .state import dyn_row

    if dyn is None:
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    row = dyn_row(dyn, state.fi.device)
    solid = (state.flags & TYPE_S) != 0
    gi = state.gi if config.thermal else None
    if halo is None:
        rho, u, T = field_moments(state.fi, state.flags, row, config, gi)
    else:
        fe, fl, ge = halo_extend(state.fi, state.flags, halo, gi)
        rho, u, T = field_moments(fe, fl, row, config, ge)
        rho, u = rho[1:-1], u[:, 1:-1]
        T = None if T is None else T[1:-1]
    state = state._replace(rho=torch.where(solid, state.rho, rho),
                           u=torch.where(solid, state.u, u))
    return state if T is None else state._replace(
        T=torch.where(solid, state.T, T))
