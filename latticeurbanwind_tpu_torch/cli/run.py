"""Run the PyTorch port of the solver on a standard NWP-coupled (.luw),
profile (.luwpf) or dataset-generation (.luwdg) deck.

    python -m latticeurbanwind_tpu_torch.cli.run conf.luw
    python -m latticeurbanwind_tpu_torch.cli.run conf.luwpf
    python -m latticeurbanwind_tpu_torch.cli.run conf.luwdg --device cpu

A `.luw` deck runs only when its `validation` is `pass` (`luwval` writes
it), unless `--force` is given; `.luwpf` and `.luwdg` decks are not gated.

Counterpart of `latticeurbanwind_tpu/cli/run.py`.  There is no --impl
switch: the run goes to the CUDA device (the hand-written kernels, built on
first use) and raises when there is none; `--device cpu` runs the kernels'
plain torch versions on the CPU instead.  A deck whose `n_gpu` asks for
several devices is split over them: `--device cuda` puts shard i on card i
(one card when fewer are visible), `--device cuda:k` every shard on card k,
`--device cpu` every shard on the CPU.

Over several processes or hosts, one command per process under the JAX
package's environment (`parallel/comm.py::ensure_distributed`), each
process with its own LUW_PROCESS_ID:

    export LUW_COORDINATOR=host0:29500 LUW_NUM_PROCESSES=2
    LUW_PROCESS_ID=0 python -m latticeurbanwind_tpu_torch.cli.run conf.luwpf
    LUW_PROCESS_ID=1 python -m latticeurbanwind_tpu_torch.cli.run conf.luwpf

The deck's shards are dealt to the processes in contiguous blocks (the
device rule then holds within each process), halos cross over NCCL between
distinct cards or gloo through the host otherwise, process 0 writes every
output file and a checkpoint is written by all as one set.

The deck runs as written, the VK
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
import json
import sys
from pathlib import Path


def launch_counts() -> dict:
    """The kernels' launch counters (each wrapper adds one where it launches
    its kernel; a run on the CPU launches none)."""
    from ..ops.avg_kernel import avg_update
    from ..ops.stream_collide import stream_collide, vk_sites

    return {"stream_collide": stream_collide.launches,
            "stream_collide_vk": stream_collide.launches_vk,
            "stream_collide_wall": stream_collide.launches_wall,
            "stream_collide_thermal": stream_collide.launches_thermal,
            "stream_collide_halo": stream_collide.launches_halo,
            "stream_collide_pair": stream_collide.launches_pair,
            "vk_sites": vk_sites.launches,
            "avg_update": avg_update.launches,
            "avg_update_wall": avg_update.launches_wall}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="runluw-torch", description=__doc__)
    parser.add_argument("deck", help="path to conf.luw, conf.luwpf or conf.luwdg")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda, which must be "
                             "present; cpu runs the plain versions); an "
                             "n_gpu deck's shards go to card i under cuda, "
                             "all to card k under cuda:k")
    parser.add_argument("--force", action="store_true",
                        help="skip the prerun validation gate")
    parser.add_argument("--max-cases", type=int, default=0,
                        help="run only the first N cases")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from ..deck import deck_mode_from_path, load_deck
    from ..run.modes import run_deck

    deck_path = Path(args.deck).expanduser().resolve()
    if deck_mode_from_path(deck_path) == "luw" and not args.force:
        status = (load_deck(deck_path).get_text("validation") or "").lower()
        if status != "pass":
            print(f"ERROR: deck validation status is '{status or 'missing'}' "
                  "(run luwval first, or pass --force)")
            return 1

    before = launch_counts()
    results = run_deck(deck_path,
                       device=args.device, quiet=args.quiet,
                       max_cases=args.max_cases)
    total = sum(r.solver_seconds for r in results)
    print(f"runluw-torch: {len(results)} case(s) complete, "
          f"solver time {total:.1f} s, "
          f"{sum(len(r.files) for r in results)} file(s) written")
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    print(f"runluw-torch: kernel launches {json.dumps(launched)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
