"""Run the PyTorch port of the solver on a standard NWP-coupled (.luw),
profile (.luwpf) or dataset-generation (.luwdg) deck.

    python -m latticeurbanwind_tpu_torch.cli.run conf.luw
    python -m latticeurbanwind_tpu_torch.cli.run conf.luwpf
    python -m latticeurbanwind_tpu_torch.cli.run conf.luwdg --device cpu

Counterpart of `latticeurbanwind_tpu/cli/run.py`.  There is no --impl
switch: the run goes to the CUDA device (the hand-written kernels, built on
first use) and raises when there is none; `--device cpu` runs the kernels'
plain torch versions on the CPU instead.  A deck whose `n_gpu` asks for
several devices is split over them: `--device cuda` puts shard i on card i
(one card when fewer are visible), `--device cuda:k` every shard on card k,
`--device cpu` every shard on the CPU.  The deck runs as written, the VK
synthetic-turbulence inlet, the wall models, the temperature sub-lattice
and every `lbm_storage` included.  A `.luw` deck needs its prepared inputs
(`proj_temp/SurfData_<datetime>.csv` and the case STL), which the port's
`makeluw` writes; `vtk2nc` then turns the averaged VTK into NetCDF:

    python -m latticeurbanwind_tpu_torch.cli.dispatch makeluw conf.luw
    python -m latticeurbanwind_tpu_torch.cli.dispatch runluw conf.luw
    python -m latticeurbanwind_tpu_torch.cli.dispatch vtk2nc conf.luw
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="runluw-torch", description=__doc__)
    parser.add_argument("deck", help="path to conf.luw, conf.luwpf or conf.luwdg")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda, which must be "
                             "present; cpu runs the plain versions); an "
                             "n_gpu deck's shards go to card i under cuda, "
                             "all to card k under cuda:k")
    parser.add_argument("--max-cases", type=int, default=0,
                        help="run only the first N cases")
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
