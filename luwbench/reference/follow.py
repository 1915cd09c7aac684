"""The reference over a check stretch, from DDFs that the program produced.

`follow` starts from the program's DDFs at the stretch's first step (the
only state taken from the program: a run of thousands of steps cannot be
followed by the plain step in a run's time) and steps them with the
reference's own tables: its flags, forcing, face targets refreshed by its
own inlet at the same steps, its own step.  `average` runs the reference's
averaging pass over the DDFs the program sampled, so the accumulators are
judged apart from the steps' rounding; `sample_step` is one Welford step of
that pass from the accumulators and DDFs of the program's sample.  With
`low` each is the control: the same work a precision below what the
configuration states (DDFs stored in 8-bit floats instead of bf16; face
targets and accumulators rounded to bf16).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from .state import decode_ddf, encode_ddf
from .step import FaceBC, stream_collide_plain
from .welford import AvgState, avg_update_plain, init_avg

LOW_STORAGE = {"bf16": "fp8", "f16": "fp8", "fp16c": "fp8", "f32": "bf16"}


def bf16_round(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.bfloat16).to(t.dtype)


def follow(tables, fi_in: torch.Tensor, t0: int, *, rounds: int, steps: int,
           device, low: bool = False):
    """(DDFs in the configuration's storage, FaceBC) after `rounds` x
    `steps` steps from `fi_in` at step `t0`, the inlet's anchors re-seeded
    at each round as the program's runner does at each call."""
    storage = tables.config.storage
    config = replace(tables.config, storage=LOW_STORAGE[storage]) if low \
        else tables.config
    flags = torch.from_numpy(tables.flags).to(device)
    cur = encode_ddf(decode_ddf(fi_in.to(device), storage), config.storage)
    fbc = None if tables.fbc0 is None else FaceBC(
        *(None if v is None else v.clone() for v in tables.fbc0))
    vk = tables.vk
    spec = None if vk is None else vk.kernel_spec
    t = int(t0)
    for _ in range(rounds):
        aux = vk.init_aux(t) if vk is not None else None
        for _ in range(steps):
            if vk is not None:
                fbc, aux = vk(fbc, t, aux)
                if low:
                    fbc = FaceBC(*(bf16_round(v) for v in fbc))
            cur = stream_collide_plain(cur, flags, tables.dyn, config,
                                       tables.forcing, fbc, vk=spec)
            t += 1
    if low:
        cur = encode_ddf(decode_ddf(cur, config.storage), storage)
    return cur, fbc


def average(tables, samples, device, low: bool = False) -> AvgState:
    """The averaging pass over `samples` (DDFs in the configuration's
    storage, one per sample) on empty accumulators; with `low` the
    accumulators are rounded to bf16 after every sample (the control)."""
    flags = torch.from_numpy(tables.flags).to(device)
    avg = init_avg(tuple(tables.shape), False, device)
    for fi in samples:
        avg_update_plain(fi.to(device), flags, tables.dyn, 1.0 / (avg.count + 1),
                         avg, tables.config)
        avg = avg._replace(count=avg.count + 1)
        if low:
            avg = AvgState(avg.count, *(bf16_round(v) for v in avg[1:]))
    return avg


def sample_step(sample: dict, tables, device, *, low: bool = False) -> tuple:
    """(mean_u, m2_u, mean_rho) after the reference's Welford step from the
    sample's accumulators and DDFs, weight 1 / (k + 1); with `low` the
    control's: the accumulators rounded to bf16 after the step."""
    flags = torch.from_numpy(tables.flags).to(device)
    k = int(sample["k"])
    avg = AvgState(k, *(v.to(device).clone() for v in sample["before"]))
    avg_update_plain(sample["fi"].to(device), flags, tables.dyn, 1.0 / (k + 1),
                     avg, tables.config)
    return tuple((bf16_round(v) if low else v).cpu() for v in avg[1:4])
