"""Single CLI dispatch point for the port's LUW commands.

`python -m latticeurbanwind_tpu_torch.cli.dispatch <command> [args...]`

The counterpart of `latticeurbanwind_tpu/cli/dispatch.py`: every command
of the JAX package, each a module of the port — the pre-processing
pipeline (`makeluw` and its stages, `dgprepare`), the solver (`runluw`, the
port's `cli/run.py`), the post-processing tools and the studio
(`luwstudio`, `gui/server.py`, whose jobs are commands of this
dispatcher).  `makeluw`, `luwvox` and `runluw` take `--device` (default
cuda; `cpu` runs on the CPU); every other tool is host numpy.  The
examples' routes:

    dispatch dgprepare conf.luwpf; dispatch runluw conf.luwpf; dispatch vtk2nc conf.luwpf
    dispatch dgprepare conf.luwdg; dispatch runluw conf.luwdg; dispatch luwseason conf.luwdg
    dispatch makeluw conf.luw; dispatch runluw conf.luw; dispatch vtk2nc conf.luw; dispatch visluw conf.luw
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
    "dgprepare": _lazy(f"{PKG}.pre.dgprepare"),
    "buildingscale": _lazy(f"{PKG}.post.buildingscale"),
    "visluw": _lazy(f"{PKG}.post.visluw"),
    "luwutmnc": _lazy(f"{PKG}.post.vtk_avg_to_utm_asl_nc"),
    "luwcutvis": _lazy(f"{PKG}.post.cut_vis"),
    "luwseason": _lazy(f"{PKG}.post.season_average"),
    "luwspectra": _lazy(f"{PKG}.post.les_spectra"),
    "luwtkeviz": _lazy(f"{PKG}.post.tke_viz"),
    "luwaij": _lazy(f"{PKG}.post.aij_casee"),
    "luwvideo": _lazy(f"{PKG}.post.video"),
    "visdem": _lazy(f"{PKG}.cli.dem_shp_tools", "visdem_main"),
    "shptester": _lazy(f"{PKG}.cli.dem_shp_tools", "shptester_main"),
    "luwstudio": _lazy(f"{PKG}.gui.server"),
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
