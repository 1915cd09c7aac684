"""The readings that a cell's limits are set from, on the card:

    python luwbench/control.py --workload <cell> --seeds 11,12,13 --seconds 6

For each seed, in one process: the cell's set-up and a short window at its
own size and load, then the check stretch through the program (the sound
reading of each compared number) and the control in the program's place:
the configuration's reference (`cases/<reference>.py`) a precision below
what the configuration states (DDFs stored in 8-bit floats instead of bf16;
face targets, accumulators, the initial fields and the output fields
rounded to bf16; the window's last averaging sample with its accumulators
rounded to bf16).  Each seed prints one JSON line `{"seed", "program":
{...}, "control": {...}}`.  The benchmark's own runs do not run the
control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from dataclasses import replace  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def readings(cell, run, stash, keys, work_dir, *, device):
    """(program's numbers, control's numbers) of one run's check stretch."""
    from luwbench import check

    prod = check.program_products(cell, stash, keys)
    tables = cell.reference.tables(prod, device)
    ref = check.reference_products(cell, prod, tables, device)
    program = check.numbers(cell, prod, tables, ref, device)
    fi, gi, fbc, avg = check.reference_products(cell, prod, tables, device,
                                                low=True)
    ctl = replace(
        prod, fi_out=fi.cpu(), gi_out=None if gi is None else gi.cpu(),
        fbc_out=None if prod.fbc_out is None else
        [v.cpu() for v in fbc if v is not None],
        avg_out=None if prod.avg_out is None else
        tuple(v.cpu() for v in avg[1:] if v is not None),
        sample=None if prod.sample is None else dict(
            prod.sample, after=cell.reference.sample(
                prod.sample, tables, device, low=True)))
    control = check.numbers(cell, ctl, tables, ref, device, low_inputs=True)
    control.pop("samples_gap")          # a count: no precision to lower
    return program, control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch

    from luwbench import check, harness, spec

    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        got = {}

        def fn(cell_, run, stash, keys, work_dir):
            got["program"], got["control"] = readings(
                cell_, run, stash, keys, work_dir, device=dev)
            return check.Result(True, 0, 0, {})

        work = harness.new_work_dir()
        try:
            harness.execute(cell, seed, args.seconds, False, t_process=T_PROCESS,
                            work_dir=work, device=args.device, check_fn=fn)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
