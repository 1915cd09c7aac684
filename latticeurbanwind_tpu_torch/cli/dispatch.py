"""Single CLI dispatch point for the port's LUW commands.

`python -m latticeurbanwind_tpu_torch.cli.dispatch <command> [args...]`

The counterpart of `latticeurbanwind_tpu/cli/dispatch.py` for the commands
the port carries, each a module of the port: the pre-processing pipeline
(`makeluw` and its stages), the solver (`runluw`, the port's `cli/run.py`),
`vtk2nc` and `luwenv`.  Any other command, among them the JAX package's
post-processing and GUI commands that the port does not carry yet, is
"Unknown" with the list.  `makeluw`, `luwvox` and `runluw` take `--device`
(default cuda; `cpu` runs on the CPU).
"""

from __future__ import annotations

import importlib
import sys

PKG = "latticeurbanwind_tpu_torch"


def _lazy(modname, attr="main"):
    def run(argv):
        return getattr(importlib.import_module(modname), attr)(argv)

    run.target = (modname, attr)
    return run


COMMANDS = {
    "makeluw": _lazy(f"{PKG}.cli.makeluw"),
    "runluw": _lazy(f"{PKG}.cli.run"),
    "luwbc": _lazy(f"{PKG}.pre.buildbc"),
    "luwcut": _lazy(f"{PKG}.pre.shpcutter"),
    "luwvox": _lazy(f"{PKG}.pre.voxelization"),
    "luwdem": _lazy(f"{PKG}.pre.dem_ingest"),
    "luwval": _lazy(f"{PKG}.cli.validate"),
    "cdfinspect": _lazy(f"{PKG}.cli.inspect_tools", "cdfinspect_main"),
    "shpinspect": _lazy(f"{PKG}.cli.inspect_tools", "shpinspect_main"),
    "cleanluw": _lazy(f"{PKG}.cli.clean"),
    "luwenv": _lazy(f"{PKG}.utils.accelerator"),
    "vtk2nc": _lazy(f"{PKG}.post.vtk2nc"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: dispatch <command> [args...]")
        print("Commands:", ", ".join(sorted(COMMANDS)))
        return 2
    cmd = argv[0]
    handler = COMMANDS.get(cmd)
    if handler is None:
        print(f"Unknown command: {cmd}")
        print("Commands:", ", ".join(sorted(COMMANDS)))
        return 2
    rc = handler(argv[1:])
    return int(rc or 0)


if __name__ == "__main__":
    sys.exit(main())
