"""Step loop: the stream-collide kernel over two DDF buffers.

Counterpart of `latticeurbanwind_tpu/lbm/stepper.py::make_runner`.  The JAX
runner compiles one program per chunk; PyTorch runs eagerly, so a run of n
steps is n launches of `ops.stream_collide.stream_collide`, each pulling
from one DDF buffer into the other, and the two buffers swap by reference
after every step; a thermal run keeps two `gi` buffers the same way.
rho/u/T in the returned state are stale (pure-DDF stepping):
`lbm.fields.update_fields` refreshes them at events.

A pre-step hook (the VK inlet, `bc.vk_inlet.make_vk_pre_step`) runs before
every step as in the JAX loop (`post=False`): at step t its `.ddf` variant
refreshes the FaceBC targets with realization t, and the step then reads
them both as the nudge targets and as the velocities of the kernel's inlet
sites (the hook's `.kernel_spec`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.stream_collide import (
    FaceBC, build_face_bc, check_config, stream_collide,
)
from .state import DynParams, Forcing, LBMState, StepConfig, dyn_row


def spare_buffer(cur: torch.Tensor,
                 spare: Optional[torch.Tensor]) -> torch.Tensor:
    """`spare` when it can take the next step's output of `cur`, else a new
    buffer like `cur`."""
    if (spare is None or spare.shape != cur.shape or spare.dtype != cur.dtype
            or spare.device != cur.device or spare.data_ptr() == cur.data_ptr()):
        return torch.empty_like(cur)
    return spare


def make_runner(config: StepConfig, forcing: Forcing = Forcing(), *,
                shape: Tuple[int, int, int], device: torch.device | str,
                pre_step=None):
    """`(run, impl_name)` with `run(state, dyn, t0, n_steps=1) -> state`.

    `impl_name` is "cuda" when `device` is a CUDA device (the K-SC kernel)
    and "plain" on the CPU (its plain torch version).

    `run` updates IN PLACE: it keeps exactly two DDF buffers, the incoming
    `state.fi` and one spare it allocates once, and after every step the
    two swap (and the same pair for `state.gi` when thermal).  The returned
    state holds whichever buffers have the newest DDFs; the incoming
    state's `fi`/`gi` become the spares and must not be read afterwards.
    One runner serves one simulation: `run.reset()` forgets the carried
    FaceBC and the spare buffers before a runner is reused.

    `pre_step` is a hook with a pure-DDF variant `.ddf(fbc, t, aux) ->
    (fbc, aux)` (the VK inlet); `t0` is the global index of the first step,
    and the variant's `.init_aux(t0)` re-seeds its carried anchors at every
    call, as the JAX runner does per chunk.  The FaceBC it refreshes is
    carried across calls.
    """
    pre_ddf = None
    if pre_step is not None:
        pre_ddf = getattr(pre_step, "ddf", None)
        if pre_ddf is None:
            raise NotImplementedError(
                "a pre-step hook without a pure-DDF variant (.ddf) needs the "
                "JAX package's reference tier, which the port does not carry")
    vk_spec = getattr(pre_ddf, "kernel_spec", None)
    check_config(config, forcing, vk_spec)
    dev = torch.device(device)
    needs_fbc = (forcing.nudge_sigma is not None
                 or forcing.sponge_sigma_z is not None or vk_spec is not None)
    thermal = config.thermal
    cell = {"fbc": None, "init": False, "spare": None, "gspare": None,
            "row": None, "row_of": None}

    def run(state: LBMState, dyn: DynParams, t0: int = 0,
            n_steps: int = 1) -> LBMState:
        if not cell["init"]:
            cell["fbc"] = (build_face_bc(state.u, state.T if thermal else None)
                           if needs_fbc else None)
            cell["init"] = True
        aux = pre_ddf.init_aux(t0) if hasattr(pre_ddf, "init_aux") else None
        fbc = cell["fbc"]
        if cell["row_of"] is not dyn:   # one host-to-device copy per DynParams
            cell["row"], cell["row_of"] = dyn_row(dyn, dev), dyn
        row = cell["row"]
        cur = state.fi
        spare = spare_buffer(cur, cell["spare"])
        gcur = gspare = None
        if thermal:
            gcur = state.gi
            gspare = spare_buffer(gcur, cell["gspare"])
        for i in range(int(n_steps)):
            if pre_ddf is not None:
                fbc, aux = pre_ddf(fbc, int(t0) + i, aux)
            stream_collide(cur, state.flags, row, config, forcing, fbc,
                           out=spare, vk=vk_spec, gi=gcur, gi_out=gspare)
            cur, spare = spare, cur
            gcur, gspare = gspare, gcur
        cell["fbc"] = fbc
        cell["spare"] = spare
        cell["gspare"] = gspare
        return state._replace(fi=cur, gi=gcur) if thermal else state._replace(fi=cur)

    def reset():
        cell.update(fbc=None, init=False, spare=None, gspare=None, row=None,
                    row_of=None)

    def set_fbc(fbc: Optional[FaceBC]):
        if fbc is not None:
            Z, Y, X = shape
            want = {"uw": (Z, 3, Y), "ue": (Z, 3, Y), "us": (Z, 3, X),
                    "un": (Z, 3, X), "ut": (3, Y, X), "ub": (3, Y, X)}
            for k, shp in want.items():
                if tuple(getattr(fbc, k).shape) != shp:
                    raise ValueError(f"FaceBC {k} shape {tuple(getattr(fbc, k).shape)}"
                                     f" does not match this runner's grid (want {shp})")
            if thermal and forcing.sponge_sigma_z is not None and fbc.tt is None:
                raise ValueError("FaceBC has no thermal target 'tt' but this "
                                 "runner is thermal")
            if fbc.tt is not None and tuple(fbc.tt.shape) != (Y, X):
                raise ValueError(f"FaceBC tt shape {tuple(fbc.tt.shape)} does not "
                                 f"match this runner's grid (want {(Y, X)})")
        cell.update(fbc=fbc, init=True)

    run.reset = reset
    run.get_fbc = lambda: cell["fbc"]
    run.set_fbc = set_fbc
    # pure-DDF stepping on every device: rho/u/T stay stale until refreshed
    run.fields_stale = True
    return run, ("cuda" if dev.type == "cuda" else "plain")


def make_bench_runner(config: StepConfig, *, shape: Tuple[int, int, int],
                      device: torch.device | str):
    """`make_runner` with no forcing (`Forcing()`), as the JAX package's
    `make_bench_runner` is: `run(state, dyn, 0, n_steps)` steps a bare
    lattice."""
    return make_runner(config, Forcing(), shape=shape, device=device)
