"""On-demand field materialization: rho/u from the DDF arrays (plain torch).

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
  * solid cells keep their existing rho/u.

Non-thermal; thermal raises.  The whole grid is processed at once, one
opposite-direction pair (with the wall models, one direction) at a time, so
the transient is a few f32 planes (no z-window chunking).

`pull` and `wall_stress` are the streaming and the stress of the plain
stream-collide step (`ops.stream_collide.stream_collide_plain`) too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from .lattice import C19, CS, MIR_X, MIR_Y, MIR_Z, OPP19
from .state import (
    DynParams, LBMState, StepConfig, TYPE_E, TYPE_S, decode_ddf, wall_mode,
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


def field_moments(fi: torch.Tensor, flags: torch.Tensor, dyn: torch.Tensor,
                  config: StepConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho, u) the fields pass reports at every cell (solid cells
    included; callers mask them).  `dyn` is the (8,) row of `dyn_row`."""
    rho_s, mom_s, rho_o, mom_o = stream_moments(fi, flags, config.storage,
                                                wall_mode(config))
    u_s = [m / rho_s for m in mom_s]
    fx, fy, fz, ox, oy, oz = (dyn[i] for i in range(6))
    F = [fx - 2.0 * rho_s * (oy * u_s[2] - oz * u_s[1]),
         fy - 2.0 * rho_s * (oz * u_s[0] - ox * u_s[2]),
         fz - 2.0 * rho_s * (ox * u_s[1] - oy * u_s[0])]
    F = wall_stress(F, u_s, rho_s, (flags & TYPE_S) != 0, config)
    half = 0.5 / rho_s
    eqbc = (flags & TYPE_E) != 0
    rho = torch.where(eqbc, rho_o, rho_s)
    u = torch.stack([
        torch.where(eqbc, mom_o[a] / rho_o,
                    torch.clamp(u_s[a] + F[a] * half, -CS, CS))
        for a in range(3)])
    return rho, u


def update_fields(state: LBMState, config: StepConfig,
                  dyn: Optional[DynParams] = None) -> LBMState:
    """Refresh rho/u from the DDFs (reference kernel.cpp:1938); solid cells
    keep their previous values."""
    from .state import dyn_row

    if config.thermal:
        raise NotImplementedError(
            "update_fields is ported for non-thermal configurations "
            "(ROADMAP kernel item K7)")
    if dyn is None:
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    row = dyn_row(dyn, state.fi.device)
    rho, u = field_moments(state.fi, state.flags, row, config)
    solid = (state.flags & TYPE_S) != 0
    return state._replace(rho=torch.where(solid, state.rho, rho),
                          u=torch.where(solid, state.u, u))
