"""On-demand field materialization: rho/u from the DDF arrays (plain torch).

Counterpart of `latticeurbanwind_tpu/lbm/fields.py::update_fields`, which
XLA (not a Pallas kernel) runs in the JAX package; it stays torch here.  The
stepper streams DDFs only, so rho/u in an `LBMState` are stale until this
pass refreshes them at event steps.  Semantics (reference kernel.cpp:1938):

  * populations are streamed first, with halfway bounce-back from solid
    sources (the stored DDFs are post-collision);
  * the Guo half-step uses the global force + Coriolis only — the nudge and
    sponge forces of the step are left out here, as in the reference —
    followed by the +-CS clamp;
  * TYPE_E cells report the moments of their own frozen equilibria;
  * solid cells keep their existing rho/u.

Non-thermal and without the wall models; other configurations raise.  The
whole grid is processed at once, one opposite-direction pair at a time, so
the transient is a few f32 planes (no z-window chunking).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .lattice import C19, CS, OPP19
from .state import DynParams, LBMState, StepConfig, TYPE_E, TYPE_S, decode_ddf


def _roll(a: torch.Tensor, c, sign: int = 1) -> torch.Tensor:
    cx, cy, cz = (sign * int(v) for v in c)
    return torch.roll(a, shifts=(cz, cy, cx), dims=(0, 1, 2))


def stream_moments(fi: torch.Tensor, flags: torch.Tensor, storage: str):
    """(rho_streamed, mom_streamed, rho_own, mom_own) summed over opposite
    direction pairs, as the JAX package's `_stream_moments` does."""
    solid = (flags & TYPE_S) != 0
    rest = decode_ddf(fi[0], storage)
    rho_s, rho_o = rest.clone(), rest.clone()
    mom_s = [torch.zeros_like(rest) for _ in range(3)]
    mom_o = [torch.zeros_like(rest) for _ in range(3)]
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
                  storage: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho, u) the fields pass reports at every cell (solid cells
    included; callers mask them).  `dyn` is the (8,) row of `dyn_row`."""
    rho_s, mom_s, rho_o, mom_o = stream_moments(fi, flags, storage)
    u_s = [m / rho_s for m in mom_s]
    fx, fy, fz, ox, oy, oz = (dyn[i] for i in range(6))
    F = (fx - 2.0 * rho_s * (oy * u_s[2] - oz * u_s[1]),
         fy - 2.0 * rho_s * (oz * u_s[0] - ox * u_s[2]),
         fz - 2.0 * rho_s * (ox * u_s[1] - oy * u_s[0]))
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

    if config.thermal or config.wall_model or config.wall_sides:
        raise NotImplementedError(
            "update_fields is ported for non-thermal configurations without "
            "the wall models (ROADMAP kernel items K4 and K7)")
    if dyn is None:
        dyn = DynParams(force=torch.zeros(3), omega_coriolis=torch.zeros(3))
    row = dyn_row(dyn, state.fi.device)
    rho, u = field_moments(state.fi, state.flags, row, config.storage)
    solid = (state.flags & TYPE_S) != 0
    return state._replace(rho=torch.where(solid, state.rho, rho),
                          u=torch.where(solid, state.u, u))
