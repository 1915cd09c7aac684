"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python luwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits with another code than 0, and prints
no result, without CUDA or with fewer cards than the cell asks for, and when
JAX or the JAX package was loaded.  Its last line on standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` the `breakdown`, and last `compared`: each number compared with
its limit, which also end its standard error).  The kernels' build caches
stay in the checkout; the run's decks and outputs go to a directory under
TMPDIR that it removes.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def written_bytes() -> str:
    """Bytes this process passed to write() and had written to storage
    (/proc/self/io's wchar and write_bytes)."""
    try:
        rows = dict(r.split(":", 1) for r in
                    Path("/proc/self/io").read_text().splitlines())
    except OSError:
        return "unknown"
    return f"{int(rows['wchar'])} (write_bytes {int(rows['write_bytes'])})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch

    from luwbench import check, harness, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("luwbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"luwbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    names = cell.per_layer if args.trace else cell.end_to_end
    work = harness.new_work_dir()
    try:
        run, result = harness.execute(
            cell, args.seed, args.seconds, bool(args.trace),
            t_process=T_PROCESS, work_dir=work, check_fn=check.check)
        line = harness.result_line(run, result, names, spec.metric_units(bench))
        print("luwbench: set-up seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in run.setup_parts.items())
            + f"; window {run.window_s:.3f}; check {run.check_s:.3f}",
            file=sys.stderr)
        if run.cases:
            print("luwbench: cases (prefix, s from the window's start to the "
                  "call, run_case s, solver s) " + "; ".join(
                      f"{c.prefix} {c.enter - run.window_start:.3f} "
                      f"{c.exit - c.enter:.3f} {c.solver_seconds:.3f}"
                      for c in run.cases), file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"luwbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"luwbench: {written_bytes()} bytes written by this process",
          file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
