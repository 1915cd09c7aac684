"""What decides `correct`: the timed path's products against the reference.

After the window has closed and the memory peak is read, the program's
own runner (the one `run_case` built and the window drove) and its
averaging pass run the cell's check stretch from the state the window left,
exactly as `run_case` calls them in that cell: `rounds` x (`steps` steps,
then one averaging sample when `samples`, on empty accumulators, through
the pass that `run_case` takes for the case: the fused pass, or the fields
pass and Welford's step where the case is thermal or has probes).  The
reference of the configuration's kind of deck (`cases/<reference>.py`,
over `reference/`) works the case's tables out again from the deck's raw
inputs and follows the same stretch from the same DDFs.  Compared, each
against its limit in the cell's file:

  * `ddf_rms`: the DDFs after the stretch, the RMS of the difference over
    the RMS of the reference's (the step: K-SC with its nudge, sponge,
    inlet sites and codec);
  * `ddf_max`: the widest gap of one DDF, lattice units (an answer altered
    in one cell);
  * `gdf_rms`, `gdf_max` (thermal cases only): the same of the D3Q7
    temperature DDFs (the thermal step);
  * `fbc_max`: the face targets after the inlet's last refresh, the widest
    gap over the reference's largest target (the VK refresh); of a thermal
    case also the sponge's temperature target, over its own largest value;
  * `avg_max`: the accumulators after the stretch's samples, the largest
    RMS of a difference over the reference's RMS, of mean u, M2, mean rho
    and, thermal, mean T, the reference averaging the DDFs that the program
    sampled (K-AVG, or the fields pass and Welford's step);
  * `samples_gap`: the averaging samples that `run_case` took in the window
    (in a window of cases: in its last case), as the benchmark's wrapper
    counted them and as the program's own count has them, each against the
    number that the deck asks for up to the window's last step
    (`harness.sample_steps`): the sum of the two gaps, exact;
  * `sample_max` (cells that average): the window's last sample, as
    `run_case` took it, against the reference's Welford step from the same
    accumulators and DDFs with the weight 1 / (count + 1), the count being
    the benchmark's: the RMS of the differences beyond one float32 spacing
    of the stored value over the RMS of the reference's increment, the
    largest of mean u, M2 and mean rho (the weight and the averaging pass
    of the loop; `sample_gap`);
  * `setup_max`: the case the program built against the reference's: the
    share of differing flags and face ids, the widest gap of the initial
    velocity, the nudge and sponge profiles, the relaxation rate and the
    Coriolis vector over the reference's largest value; of a thermal case
    also the initial temperature, the thermal relaxation rate and the
    sponge's temperature target;
  * `out_max` (windows of whole cases): the `_avg` VTK that the window's
    last case wrote, each field's widest gap over its largest reference
    value, the reference deriving the fields from the program's final
    accumulators (the output writer and the derived fields).
"""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import counts
from .reference.derived import derived_turbulence_fields
from .reference.follow import bf16_round
from .reference.state import TYPE_S, decode_ddf
from .reference.vtk import read_structured_points
from .reference.welford import AvgState, variance_sum_u


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    compared: Dict[str, dict]


@dataclass
class Products:
    """What the program produced, on the host."""

    t0: int
    fi_in: torch.Tensor
    fi_out: torch.Tensor
    # the DDFs each averaging sample read: fi, or (fi, gi) of a thermal state
    samples: Optional[list]
    fbc_out: Optional[list]              # the six faces (and tt, thermal)
    avg_out: Optional[tuple]             # mean_u, m2_u, mean_rho (, mean_T)
    u0: torch.Tensor
    flags: torch.Tensor
    forcing: dict
    omega: float
    coriolis: torch.Tensor               # (3,) the Coriolis vector
    prefix: str                          # the case's VTK prefix
    deck: Path                           # the deck file the case was built from
    # a thermal case: its D3Q7 DDFs at the stretch's start and end, the
    # initial T, the sponge's temperature target, the thermal rate
    gi_in: Optional[torch.Tensor] = None
    gi_out: Optional[torch.Tensor] = None
    T0: Optional[torch.Tensor] = None
    tt: Optional[torch.Tensor] = None
    omega_t: Optional[float] = None
    vtk: Optional[Path] = None
    acc: Optional[tuple] = None          # final (count, mean_u, m2_u, mean_rho)
    samples_gap: int = 0
    # the window's last sample: k (samples before it), fi, gi, before,
    # after (mean_u, m2_u, mean_rho (, mean_T) on the host), inv_n, same
    # (its DDFs are the window's last state, where they were not copied);
    # None: none taken
    sample: Optional[dict] = None
    needs_sample: bool = False


def _host(t):
    """A copy on the host (a CPU tensor is copied too: the runner reuses
    its buffers)."""
    return None if t is None else t.detach().to("cpu", copy=True)


def program_products(cell, stash: dict, keys: dict) -> Products:
    """Run the check stretch through the program's runner and averaging
    pass, and take every product to the host; the program's state is freed
    on return."""
    from .harness import averaging_pass, on, sample_steps

    chk = cell.workload["check"]
    sample = stash.pop("sample", None)
    if "ended" in stash:
        e = stash.pop("ended")
        case, res, runner = e["case"], e["result"], e["runner"].inner
        state, t0 = res.state, int(res.total_steps)
        vtk = [f for f in res.files if f.name.endswith(f"_avg-{t0:09d}.vtk")][0]
        final = tuple(_host(v) for v in res.avg[1:] if v is not None)
        acc = (res.avg.count, *final[:3])
        counted, count = e["samples"], res.avg.count
        if sample is not None:
            sample.update(after=final, same=True)
        del e, res
    else:
        case, runner, state, t0 = (stash.pop("case"), stash.pop("run"),
                                   stash.pop("state"), stash.pop("t"))
        vtk, acc = None, None
        counted = stash.pop("samples")
        count = 0
        if sample is not None:
            count = sample["after"].count
            sample.update(
                after=tuple(_host(v) for v in sample["after"][1:] if v is not None),
                same=sample["fi"] is state.fi and sample["gi"] is state.gi)
    expected = len(sample_steps(keys, t0))
    stash.clear()
    dev = state.fi.device
    fi_in, gi_in = _host(state.fi), _host(state.gi)
    if sample is not None and sample["fi"] is state.fi:
        sample.update(fi=fi_in, gi=gi_in)
    thermal = bool(case.config.thermal)
    with on(dev):
        avg = step = None
        if chk["samples"]:
            avg, step = averaging_pass(case, tuple(state.rho.shape), dev)
        fbc0 = runner.get_fbc()
        tt = None if fbc0 is None or fbc0.tt is None else _host(fbc0.tt)
        t = t0
        samples = [] if avg is not None else None
        for _ in range(int(chk["rounds"])):
            state = runner(state, case.dyn, t, int(chk["steps"]))
            t += int(chk["steps"])
            if avg is not None:
                samples.append(_host(state.fi) if state.gi is None
                               else (_host(state.fi), _host(state.gi)))
                state, avg = step(state, avg)
        fbc = runner.get_fbc()
        out = Products(
            t0=t0, fi_in=fi_in, fi_out=_host(state.fi), samples=samples,
            fbc_out=None if case.pre_step is None else
            [_host(v) for v in fbc if v is not None],
            avg_out=None if avg is None else
            tuple(_host(v) for v in avg[1:] if v is not None),
            u0=_host(case.state.u), flags=_host(case.state.flags),
            forcing={k: _host(getattr(case.forcing, k)) for k in
                     ("nudge_sigma", "nudge_face", "sponge_sigma_z")},
            omega=float(case.config.omega),
            coriolis=_host(torch.as_tensor(case.dyn.omega_coriolis)),
            prefix=case.vtk_prefix,
            deck=Path(case.parent) / cell.config["deck_file"],
            gi_in=gi_in, gi_out=_host(state.gi), T0=_host(case.state.T), tt=tt,
            omega_t=float(case.config.omega_t) if thermal else None,
            vtk=vtk, acc=acc,
            samples_gap=abs(counted - expected) + abs(count - expected),
            sample=sample, needs_sample=bool(chk["samples"]))
    del state, avg, step, fbc, fbc0, runner, case
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return out


def _rel_max(a, b) -> float:
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    gap = float((a - b).abs().max()) if b.numel() else 0.0
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def _share_differ(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return 1.0
    return float((a != b).double().mean())


def _ddf_numbers(prog: torch.Tensor, ref: torch.Tensor, storage: str,
                 device, name: str = "ddf") -> Dict[str, float]:
    """RMS of the difference over the RMS of the reference, and the widest
    gap, of the decoded DDFs, one direction at a time on `device`."""
    num = den = 0.0
    gap = 0.0
    for d in range(prog.shape[0]):
        p = decode_ddf(prog[d].to(device), storage).double()
        r = decode_ddf(ref[d].to(device), storage).double()
        diff = p - r
        num += float((diff * diff).sum())
        den += float((r * r).sum())
        gap = max(gap, float(diff.abs().max()))
    return {f"{name}_rms": math.sqrt(num / den) if den > 0 else math.inf,
            f"{name}_max": gap}


def _rms_rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    den = float((b * b).mean().sqrt())
    num = float(((a - b) ** 2).mean().sqrt())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _either_rel_max(p, r) -> Optional[float]:
    """`_rel_max` of a value that a case may lack: None where neither side
    has it, infinite where one side alone has it."""
    if p is None and r is None:
        return None
    if p is None or r is None:
        return math.inf
    return _rel_max(p, r)


def numbers(cell, prod: Products, tables, ref, device, *, low_inputs=False
            ) -> Dict[str, float]:
    """The compared numbers of `prod` (the program's products, or the
    control's in its place) against the reference `ref` = (DDFs, thermal
    DDFs or None, FaceBC, AvgState or None) and `tables`.  With
    `low_inputs` the set-up and output numbers are the control's: the
    reference's own values rounded to bf16 in the program's place."""
    fi_ref, gi_ref, fbc_ref, avg_ref = ref
    storage = tables.config.storage
    out = _ddf_numbers(prod.fi_out, fi_ref.cpu(), storage, device)
    if prod.gi_out is not None or gi_ref is not None:
        out.update(gdf_rms=math.inf, gdf_max=math.inf)
        if prod.gi_out is not None and gi_ref is not None:
            out.update(_ddf_numbers(prod.gi_out, gi_ref.cpu(), storage, device,
                                    "gdf"))
    if prod.fbc_out is not None:
        gaps = [float((p.double() - r.cpu().double()).abs().max())
                for p, r in zip(prod.fbc_out, fbc_ref[:6])]
        scale = max(float(r.abs().max()) for r in fbc_ref[:6])
        out["fbc_max"] = max(gaps) / scale
        tt_gap = _either_rel_max(
            prod.fbc_out[6] if len(prod.fbc_out) > 6 else None,
            None if fbc_ref.tt is None else fbc_ref.tt.cpu())
        if tt_gap is not None:
            out["fbc_max"] = max(out["fbc_max"], tt_gap)
    if prod.avg_out is not None:
        want = [v for v in avg_ref[1:] if v is not None]
        out["avg_max"] = (max(_rms_rel(p, r.cpu()) for p, r in
                              zip(prod.avg_out, want))
                          if len(want) == len(prod.avg_out) else math.inf)
    forcing_ref = {k: _host(getattr(tables.forcing, k)) for k in
                   ("nudge_sigma", "nudge_face", "sponge_sigma_z")}
    u0_ref = torch.from_numpy(tables.u0)
    coriolis_ref = _host(tables.dyn[3:6])
    thermal_ref = {"T0": None if tables.T0 is None else torch.from_numpy(tables.T0),
                   "tt": None if tables.fbc0 is None else _host(tables.fbc0.tt)}
    if low_inputs:
        u0, flags = bf16_round(u0_ref), torch.from_numpy(tables.flags)
        forcing = {k: (v if v is None or not v.is_floating_point()
                       else bf16_round(v)) for k, v in forcing_ref.items()}
        omega = float(torch.tensor(tables.config.omega).to(torch.bfloat16))
        coriolis = bf16_round(coriolis_ref)
        thermal = {k: bf16_round(v) for k, v in thermal_ref.items()}
        omega_t = (float(torch.tensor(tables.config.omega_t).to(torch.bfloat16))
                   if tables.config.thermal else None)
    else:
        u0, flags, forcing, omega = prod.u0, prod.flags, prod.forcing, prod.omega
        coriolis = prod.coriolis
        thermal = {"T0": prod.T0, "tt": prod.tt}
        omega_t = prod.omega_t
    parts = [_share_differ(flags, torch.from_numpy(tables.flags)),
             _rel_max(u0, u0_ref),
             abs(omega - tables.config.omega) / tables.config.omega,
             _rel_max(coriolis, coriolis_ref)]
    for k, r in forcing_ref.items():
        p = forcing[k]
        if (p is None) != (r is None):
            parts.append(math.inf)
        elif r is not None:
            parts.append(_rel_max(p, r) if r.is_floating_point()
                         else _share_differ(p, r))
    pairs = [(omega_t, tables.config.omega_t if tables.config.thermal else None)]
    pairs += [(thermal[k], r) for k, r in thermal_ref.items()]
    parts.extend(g for g in (_either_rel_max(p, r) for p, r in pairs)
                 if g is not None)
    out["setup_max"] = max(parts)
    if prod.acc is not None:
        out["out_max"] = output_gap(prod, tables, low=low_inputs)
    out["samples_gap"] = float(prod.samples_gap)
    if prod.needs_sample:
        out["sample_max"] = sample_gap(prod.sample, tables, device,
                                       cell.reference)
    return out


def sample_gap(sample: Optional[dict], tables, device, reference) -> float:
    """How far the program's sample departs from the reference's Welford
    step (`reference.sample`) beyond the rounding of the stored
    accumulators: over the cells that are not solid (the only ones the
    outputs report), each value's difference from the reference's, counted
    as 0 where it is within one float32 spacing of the reference's value;
    the RMS of that over the RMS of the reference's increment, the largest
    of mean u, M2, mean rho and, thermal, mean T.  Infinite where no sample
    was kept, its DDFs are not the ones it read, or the two sides keep
    other accumulators."""
    if sample is None or not sample["same"]:
        return math.inf
    ref = reference.sample(sample, tables, device)
    if not len(ref) == len(sample["before"]) == len(sample["after"]):
        return math.inf
    fluid = torch.from_numpy((tables.flags & TYPE_S) == 0).to(device)
    gap = 0.0
    for before, got, want in zip(sample["before"], sample["after"], ref):
        want = want.to(device)
        keep = fluid.expand(want.shape)
        mag = want.abs()
        spacing = (torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag)[keep]
        diff = (got.to(device).double() - want.double())[keep]
        beyond = torch.where(diff.abs() <= spacing.double(), 0.0, diff)
        inc = (want.double() - before.to(device).double())[keep]
        den = float((inc * inc).mean().sqrt())
        num = float((beyond * beyond).mean().sqrt())
        gap = max(gap, num / den if den > 0 else (0.0 if num == 0 else math.inf))
    return gap


def reference_fields(acc: tuple, tables, want=("tke", "ti", "tls")) -> dict:
    count, mean_u, m2_u, mean_rho = acc
    avg = AvgState(count, mean_u, m2_u, mean_rho)
    var_sum = variance_sum_u(avg).numpy()
    mu = mean_u.numpy()
    fields = {"u_avg": (mu * tables.u_factor).astype(np.float32),
              "rho_avg": (mean_rho.numpy() * tables.rho_factor).astype(np.float32)}
    derived = derived_turbulence_fields(
        mu, var_sum, tables.flags, avg_count=count, u_factor=tables.u_factor,
        spacing=tables.cell_m, want=want)
    fields["fluid"] = derived.pop("fluid")
    for key in ("tke", "TI", "TLS"):
        if key in derived:
            fields[key] = derived[key]
    return fields


def output_gap(prod: Products, tables, *, low: bool = False) -> float:
    """The widest gap of each field of the window's last `_avg` VTK over its
    largest reference value (the control: the fields derived from the
    accumulators rounded to bf16)."""
    ref = reference_fields(prod.acc, tables)
    if low:
        c, *acc = prod.acc
        got = reference_fields((c, *(bf16_round(v) for v in acc)), tables)
    else:
        _, got = read_structured_points(prod.vtk)
    if sorted(got) != sorted(ref):
        return math.inf
    return max(_rel_max(np.asarray(got[k], np.float64),
                        np.asarray(ref[k], np.float64)) for k in ref)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Result:
    compared, failed = {}, 0
    for name, v in values.items():
        lim = limits.get(name)
        ok = lim is not None and math.isfinite(v) and v <= lim
        failed += 0 if ok else 1
        compared[name] = {"value": v, "limit": lim}
    return Result(correct=failed == 0 and bool(values), attempted=len(values),
                  failed=failed, compared=compared)


def reference_products(cell, prod: Products, tables, device, *, low=False):
    """(DDFs, thermal DDFs or None, FaceBC, AvgState or None) of the
    configuration's reference over the stretch."""
    chk = cell.workload["check"]
    fi, gi, fbc = cell.reference.follow(
        tables, prod, rounds=int(chk["rounds"]), steps=int(chk["steps"]),
        device=device, low=low)
    avg = (None if prod.samples is None
           else cell.reference.average(tables, prod.samples, device, low=low))
    return fi, gi, fbc, avg


def check(cell, run, stash: dict, keys: dict, work_dir: Path) -> Result:
    """The harness's check: the program's products against the reference,
    each number against the cell's limit."""
    prod = program_products(cell, stash, keys)
    device = torch.device("cuda", 0) if run.on_cuda else torch.device("cpu")
    tables = cell.reference.tables(prod, device)
    run.work = counts.work_of(tables)
    ref = reference_products(cell, prod, tables, device)
    values = numbers(cell, prod, tables, ref, device)
    return judge(values, cell.workload.get("limits", {}))
