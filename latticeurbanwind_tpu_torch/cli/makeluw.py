"""makeluw — preprocessing pipeline orchestrator.

Runs the six pipeline stages in order with a timestamping logger that tees
all output to proj_temp/<ts>.log (reference: tools_core/makeluw.py:41-162):

  1. cdfinspect       NetCDF overview
  2. shpinspect       shapefile overview
  3. luwbc            WRF/NetCDF -> SurfData boundary CSV (needs GIS stack)
  4. luwcut           building shapefile crop/clean (needs GIS stack)
  5. luwvox           terrain+building voxelization -> case STL
  6. luwval           pre-run validation gate

GIS-dependent stages degrade to a clear skip message when xarray/geopandas
are unavailable; geometry and validation stages are fully self-contained.

A copy of `latticeurbanwind_tpu/cli/makeluw.py` that runs the port's stages
and takes `--device` (default cuda), which it hands to luwvox: the
`kriging_gpu` terrain solve is the one step of the pipeline that runs on a
device.  Each stage prints its wall seconds ("[<stage>] stage seconds: s").

    python -m latticeurbanwind_tpu_torch.cli.makeluw conf.luw [--device cpu]
"""

from __future__ import annotations

import datetime as _dt
import io
import sys
import time
from pathlib import Path

from . import pop_device
from ..io.progress import ProgressEmitter


class Logger:
    """Tee stdout/stderr to a timestamped log file, prefixing each line."""

    def __init__(self, log_path: Path):
        self.log_path = log_path
        log_path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(log_path, "a", encoding="utf-8")
        self._stdout = sys.stdout
        self._buf = ""

    def write(self, text: str) -> int:
        self._stdout.write(text)
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            # collapse tqdm-style carriage-return rewrites to their final state
            if "\r" in line:
                line = line.rsplit("\r", 1)[-1]
            stamp = _dt.datetime.now().strftime("%H:%M:%S")
            self._fh.write(f"[{stamp}] {line}\n")
        return len(text)

    def flush(self) -> None:
        self._stdout.flush()
        self._fh.flush()

    def close(self) -> None:
        if self._buf:
            self.write("\n")
        self._fh.close()


def _stage_fns():
    """(name, main, required, takes --device) of each stage, in order."""
    from . import clean, inspect_tools, validate
    from ..pre import buildbc, shpcutter, voxelization

    return [
        ("cdfinspect", inspect_tools.cdfinspect_main, False, False),
        ("shpinspect", inspect_tools.shpinspect_main, False, False),
        ("luwbc", buildbc.main, True, False),
        ("luwcut", shpcutter.main, True, False),
        ("luwvox", voxelization.main, True, True),
        ("luwval", validate.main, True, False),
    ]


def main(argv=None) -> int:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    if len(argv) != 1:
        print("Usage: makeluw <deck file> [--device cuda|cpu]")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    if not deck_path.exists():
        print(f"ERROR: deck not found: {deck_path}")
        return 1
    home = deck_path.parent
    ts = _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
    logger = Logger(home / "proj_temp" / f"{ts}.log")
    old_stdout, old_stderr = sys.stdout, sys.stderr
    sys.stdout = sys.stderr = logger
    progress = ProgressEmitter("pipeline")
    stages = _stage_fns()
    failed = []
    try:
        for i, (name, fn, required, on_device) in enumerate(stages):
            print(f"===== stage {i + 1}/{len(stages)}: {name} =====")
            progress.emit(f"Running {name}", current=i, total=len(stages), force=True)
            t0 = time.perf_counter()
            try:
                rc = fn([str(deck_path)]
                        + (["--device", device] if on_device else []))
            except SystemExit as e:
                rc = int(e.code or 0)
            except Exception as e:
                print(f"[{name}] ERROR: {type(e).__name__}: {e}")
                rc = 1
            print(f"[{name}] stage seconds: {time.perf_counter() - t0:.3f}")
            if rc != 0:
                print(f"[{name}] exited with status {rc}")
                if required:
                    failed.append(name)
                    break
        progress.done("Pipeline")
    finally:
        sys.stdout, sys.stderr = old_stdout, old_stderr
        logger.close()
    if failed:
        print(f"makeluw: FAILED at stage {failed[0]} (log: {logger.log_path})")
        return 1
    print(f"makeluw: pipeline complete (log: {logger.log_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
