"""Run the PyTorch port of the solver on a profile deck (.luwpf).

    python -m latticeurbanwind_tpu_torch.cli.run conf.luwpf

Counterpart of `latticeurbanwind_tpu/cli/run.py`.  There is no --impl
switch: the run uses the first CUDA device when there is one (the
hand-written kernels, built on first use) and the CPU otherwise (their
plain torch versions); `--device` picks the device explicitly.  Other deck
kinds raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="runluw-torch", description=__doc__)
    parser.add_argument("deck", help="path to conf.luwpf")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda if available, else cpu)")
    parser.add_argument("--max-cases", type=int, default=0,
                        help="run only the first N angles")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from ..run.modes import run_deck

    results = run_deck(Path(args.deck).expanduser().resolve(),
                       device=args.device, quiet=args.quiet,
                       max_cases=args.max_cases)
    total = sum(r.solver_seconds for r in results)
    print(f"runluw-torch: {len(results)} case(s) complete, "
          f"solver time {total:.1f} s, "
          f"{sum(len(r.files) for r in results)} file(s) written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
