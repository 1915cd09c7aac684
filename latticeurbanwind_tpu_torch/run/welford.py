"""Device-side Welford running statistics over the averaging window.

Counterpart of `latticeurbanwind_tpu/run/welford.py`.  The accumulators
live on the device and are updated IN PLACE (the JAX package donates them
for the same reason: a second accumulator set would be a transient spike of
~20 B/cell); only the final means and M2 cross to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..lbm.state import LBMState


class AvgState(NamedTuple):
    count: int                 # samples accumulated
    mean_u: torch.Tensor       # (3, Z, Y, X)
    m2_u: torch.Tensor         # (Z, Y, X) squared deviations summed over the
    #                            3 components (the variance trace)
    mean_rho: torch.Tensor     # (Z, Y, X)
    mean_T: Optional[torch.Tensor] = None


def init_avg(shape, thermal: bool, device: torch.device | str = "cpu") -> AvgState:
    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    return AvgState(count=0, mean_u=z(3, *shape), m2_u=z(*shape),
                    mean_rho=z(*shape), mean_T=z(*shape) if thermal else None)


def welford_update(avg: AvgState, state: LBMState) -> AvgState:
    """One sample of state.u / state.rho, in place; returns the state with
    the advanced count."""
    n = avg.count + 1
    inv_n = 1.0 / n
    delta = state.u - avg.mean_u
    avg.mean_u.add_(delta * inv_n)
    avg.m2_u.add_((delta * (state.u - avg.mean_u)).sum(dim=0))
    avg.mean_rho.add_((state.rho - avg.mean_rho) * inv_n)
    if avg.mean_T is not None and state.T is not None:
        avg.mean_T.add_((state.T - avg.mean_T) * inv_n)
    return avg._replace(count=n)


def variance_sum_u(avg: AvgState) -> torch.Tensor:
    """(Z, Y, X) velocity-variance trace var_u+var_v+var_w (population)."""
    return torch.clamp(avg.m2_u / float(max(avg.count, 1)), min=0.0)
