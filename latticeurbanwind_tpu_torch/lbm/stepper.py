"""Step loop: the stream-collide kernel over two DDF buffers.

Counterpart of `latticeurbanwind_tpu/lbm/stepper.py::make_runner`.  The JAX
runner compiles one program per chunk; PyTorch runs eagerly, so a run of n
steps is n launches of `ops.stream_collide.stream_collide`, each pulling
from one DDF buffer into the other, and the two buffers swap by reference
after every step.  rho/u in the returned state are stale (pure-DDF
stepping): `lbm.fields.update_fields` refreshes them at events.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.stream_collide import (
    FaceBC, build_face_bc, check_config, stream_collide,
)
from .state import DynParams, Forcing, LBMState, StepConfig, dyn_row


def make_runner(config: StepConfig, forcing: Forcing = Forcing(), *,
                shape: Tuple[int, int, int], device: torch.device | str,
                pre_step=None):
    """`(run, impl_name)` with `run(state, dyn, t0, n_steps=1) -> state`.

    `impl_name` is "cuda" when `device` is a CUDA device (the K-SC kernel)
    and "plain" on the CPU (its plain torch version).

    `run` updates IN PLACE: it keeps exactly two DDF buffers, the incoming
    `state.fi` and one spare it allocates once, and after every step the
    two swap.  The returned state holds whichever buffer has the newest
    DDFs; the incoming state's `fi` becomes the spare and must not be read
    afterwards.  One runner serves one simulation: `run.reset()` forgets the
    carried FaceBC and the spare buffer before a runner is reused.
    """
    if pre_step is not None:
        raise NotImplementedError(
            "pre-step hooks (the VK inlet) are not ported yet (ROADMAP "
            "module item 7 and kernel item K6)")
    check_config(config, forcing)
    dev = torch.device(device)
    has_forcing = (forcing.nudge_sigma is not None
                   or forcing.sponge_sigma_z is not None)
    cell = {"fbc": None, "init": False, "spare": None}

    def run(state: LBMState, dyn: DynParams, t0: int = 0,
            n_steps: int = 1) -> LBMState:
        del t0          # per-step hooks (the VK inlet) would read it
        if not cell["init"]:
            cell["fbc"] = build_face_bc(state.u) if has_forcing else None
            cell["init"] = True
        row = dyn_row(dyn, dev)
        cur = state.fi
        spare = cell["spare"]
        if (spare is None or spare.shape != cur.shape or spare.dtype != cur.dtype
                or spare.data_ptr() == cur.data_ptr()):
            spare = torch.empty_like(cur)
        for _ in range(int(n_steps)):
            stream_collide(cur, state.flags, row, config, forcing, cell["fbc"],
                           out=spare)
            cur, spare = spare, cur
        cell["spare"] = spare
        return state._replace(fi=cur)

    def reset():
        cell.update(fbc=None, init=False, spare=None)

    def set_fbc(fbc: Optional[FaceBC]):
        if fbc is not None:
            Z, Y, X = shape
            want = {"uw": (Z, 3, Y), "ue": (Z, 3, Y), "us": (Z, 3, X),
                    "un": (Z, 3, X), "ut": (3, Y, X), "ub": (3, Y, X)}
            for k, shp in want.items():
                if tuple(getattr(fbc, k).shape) != shp:
                    raise ValueError(f"FaceBC {k} shape {tuple(getattr(fbc, k).shape)}"
                                     f" does not match this runner's grid (want {shp})")
        cell.update(fbc=fbc, init=True)

    run.reset = reset
    run.get_fbc = lambda: cell["fbc"]
    run.set_fbc = set_fbc
    # pure-DDF stepping on every device: rho/u stay stale until refreshed
    run.fields_stale = True
    return run, ("cuda" if dev.type == "cuda" else "plain")
