"""Carry state between the JAX package and the port, bit for bit.

The inputs are the JAX package's objects (`LBMState`, `Forcing`, `FaceBC`,
`AvgState`, `DynParams`) whose arrays numpy can read (`np.asarray` works on
jax arrays without importing jax here); the outputs are the port's objects
on a torch device.  The reverse functions return the port's NamedTuples
holding numpy arrays, for comparisons.  bfloat16 crosses as its 16-bit
pattern, so both sides start from the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .lbm.state import DynParams, Forcing, LBMState
from .ops.stream_collide import FaceBC
from .run.welford import AvgState


def to_torch(a, device: torch.device | str = "cpu") -> Optional[torch.Tensor]:
    """numpy-readable array -> torch tensor on `device` (None passes)."""
    if a is None:
        return None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """torch tensor -> numpy (bfloat16 as ml_dtypes.bfloat16)."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_jax(st, device: torch.device | str = "cpu") -> LBMState:
    return LBMState(fi=to_torch(st.fi, device), rho=to_torch(st.rho, device),
                    u=to_torch(st.u, device), flags=to_torch(st.flags, device),
                    gi=to_torch(st.gi, device), T=to_torch(st.T, device))


def state_to_numpy(st: LBMState) -> LBMState:
    return LBMState(*(to_numpy(v) for v in st))


def forcing_from_jax(forcing, device: torch.device | str = "cpu") -> Forcing:
    face = forcing.nudge_face
    return Forcing(
        nudge_sigma=to_torch(forcing.nudge_sigma, device),
        nudge_face=(None if face is None
                    else to_torch(np.asarray(face).astype(np.uint8), device)),
        nudge_vertical=bool(forcing.nudge_vertical),
        sponge_sigma_z=to_torch(forcing.sponge_sigma_z, device),
    )


def face_bc_from_jax(fbc, device: torch.device | str = "cpu") -> FaceBC:
    return FaceBC(*(to_torch(getattr(fbc, k), device).contiguous()
                    for k in FaceBC._fields))


def dyn_from_jax(dyn) -> DynParams:
    return DynParams(force=to_torch(np.asarray(dyn.force, np.float32)),
                     omega_coriolis=to_torch(np.asarray(dyn.omega_coriolis,
                                                        np.float32)))


def avg_from_jax(avg, device: torch.device | str = "cpu") -> AvgState:
    return AvgState(count=int(np.asarray(avg.count)),
                    mean_u=to_torch(avg.mean_u, device),
                    m2_u=to_torch(avg.m2_u, device),
                    mean_rho=to_torch(avg.mean_rho, device),
                    mean_T=to_torch(avg.mean_T, device))


def avg_to_numpy(avg: AvgState) -> AvgState:
    return AvgState(count=avg.count, mean_u=to_numpy(avg.mean_u),
                    m2_u=to_numpy(avg.m2_u), mean_rho=to_numpy(avg.mean_rho),
                    mean_T=to_numpy(avg.mean_T))
