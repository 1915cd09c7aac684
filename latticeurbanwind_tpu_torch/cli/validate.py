"""luwval — pre-run validation gate.

Cross-checks the case STL bounding box against the SurfData CSV extents
(0.1% XY tolerance), fills missing deck fields (datetime, n_gpu,
mesh_control, gpu_memory from the card's memory through torch instead of
nvidia-smi), and writes `validation = pass|error` back into the deck — the
flag the solver re-checks before running.
(reference: tools_core/prerunValidate.py)

A copy of `latticeurbanwind_tpu/cli/validate.py` but for
`default_memory_mib`, which reads the CUDA card where the JAX package reads
the TPU.  It is only a deck default: it decides nothing about where a run
goes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..deck import DeckDocument, load_deck, parse_deck_text
from ..geometry import read_stl

TOL = 1e-3  # 0.1 %


def default_memory_mib() -> int:
    """85% of the first visible CUDA card's memory, in MiB; 20000 without
    one (the JAX package's value off a TPU)."""
    if torch.cuda.is_available():
        total = torch.cuda.get_device_properties(0).total_memory
        return int(total * 0.85 / (1024 * 1024))
    return 20000


def stl_ranges(stl_path: Path) -> dict:
    mesh = read_stl(stl_path)
    mn, mx = mesh.pmin, mesh.pmax
    return {ax: (float(mn[i]), float(mx[i]), float(mx[i] - mn[i]))
            for i, ax in enumerate("xyz")}


def csv_ranges(csv_path: Path) -> dict:
    from ..bc.samples import read_surfdata_csv

    samples = read_surfdata_csv(csv_path)
    mn = samples.p.min(axis=0)
    mx = samples.p.max(axis=0)
    return {ax: (float(mn[i]), float(mx[i]), float(mx[i] - mn[i]))
            for i, ax in enumerate("xyz")}


def compare_xy(stl: dict, csv: dict):
    """Span-normalized relative errors on X/Y min/max/span."""
    res = {}
    max_err = 0.0
    for axis in ("x", "y"):
        smin, smax, sspan = stl[axis]
        cmin, cmax, cspan = csv[axis]
        denom = abs(sspan) if sspan != 0 else max(abs(smin), abs(smax), 1.0)
        errs = {
            "min": abs(smin - cmin) / denom,
            "max": abs(smax - cmax) / denom,
            "span": abs(sspan - cspan) / denom,
        }
        res[axis] = errs
        max_err = max(max_err, *errs.values())
    return max_err < TOL, res


def ensure_conf_fields(conf_path: Path) -> DeckDocument:
    deck = load_deck(conf_path) if conf_path.exists() else parse_deck_text("")
    if not deck.get_text("datetime"):
        deck.set_text("datetime", "20990101120000")
        print("[!] Field 'datetime' missing. Set default.")
    if not deck.get_list("n_gpu"):
        deck.set_list("n_gpu", [1, 1, 1])
        print("[!] Field 'n_gpu' missing. Wrote default value.")
    mesh_control = (deck.get_text("mesh_control") or "").strip().lower()
    cell_raw = deck.get_raw("cell_size")
    if not mesh_control:
        deck.set_text("mesh_control", "gpu_memory", quoted=True)
        mesh_control = "gpu_memory"
        print("[!] Field 'mesh_control' missing. Wrote default value.")
    elif mesh_control == "cell_size" and not (cell_raw or "").strip():
        deck.set_text("mesh_control", "gpu_memory", quoted=True)
        mesh_control = "gpu_memory"
        print("[!] 'mesh_control' set to 'gpu_memory' because 'cell_size' is missing")
    if mesh_control == "gpu_memory" and deck.get_int("gpu_memory") is None:
        deck.set_int("gpu_memory", default_memory_mib())
        print("[!] Ensured 'gpu_memory'")
    if not deck.has("cell_size"):
        deck.set_raw("cell_size", "")
    deck.save(conf_path)
    return deck


def write_validation(deck: DeckDocument, conf_path: Path, passed: bool) -> None:
    deck.set_text("validation", "pass" if passed else "error")
    if not deck.has("high_order"):
        deck.set_bool("high_order", True)
    if not deck.has("flux_correction"):
        deck.set_bool("flux_correction", True)
    deck.save(conf_path)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print("LUW Pre-run Validation Tool...")
    if len(argv) != 1:
        print("Usage: luwval <path-to-deck-file>")
        return 2
    conf_path = Path(argv[0]).expanduser().resolve()
    home = conf_path.parent
    deck = ensure_conf_fields(conf_path)
    casename = deck.get_text("casename") or "example"
    dt = deck.get_text("datetime") or "20990101120000"

    proj_temp = home / "proj_temp"
    # resolution order: reference prerunValidate.py:163-167 tries _DEM then
    # plain; the mode-specific _DG/_PF names (dgPrepare outputs) come after
    stl_path = proj_temp / f"{casename}_DEM.stl"
    for suffix in ("", "_DG", "_PF"):
        if stl_path.exists():
            break
        stl_path = proj_temp / f"{casename}{suffix}.stl"
    csv_path = proj_temp / f"SurfData_{dt}.csv"
    if not csv_path.exists():
        alt = proj_temp / "SurfData_Latest.csv"
        if alt.exists():
            csv_path = alt
    print(f"Using STL file: {stl_path}")

    try:
        stl = stl_ranges(stl_path)
        if csv_path.exists():
            csv = csv_ranges(csv_path)
        else:
            # profile/datagen cases have no SurfData CSV; check the STL
            # against the deck's si_*_cfd extents instead
            csv = {}
            for ax in ("x", "y"):
                rng = deck.get_float_list(f"si_{ax}_cfd")
                if not rng or len(rng) != 2:
                    raise ValueError(
                        f"no {csv_path.name} and no si_{ax}_cfd range in deck")
                csv[ax] = (rng[0], rng[1], rng[1] - rng[0])
            print("No SurfData CSV — validating against deck si_*_cfd ranges")
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}")
        write_validation(deck, conf_path, False)
        return 1

    for tag, ranges in (("STL", stl), ("CSV", csv)):
        print(f"{tag} ranges:")
        for ax, (mn, mx, sp) in ranges.items():
            print(f"    {ax.upper()}: min={mn:.3f}, max={mx:.3f}, span={sp:.3f}")

    passed, errs = compare_xy(stl, csv)
    if passed:
        worst = max(max(v.values()) for v in errs.values())
        print(f"Validation passed. Maximum XY relative error {worst * 100:.6f}%")
    else:
        print("=" * 60)
        print("WARNING: XY range mismatch exceeds 0.1%!")
        for ax, e in errs.items():
            print(f"  Axis {ax}: min={e['min']*100:.6f}%, max={e['max']*100:.6f}%, "
                  f"span={e['span']*100:.6f}%")
        print("=" * 60)
    write_validation(deck, conf_path, passed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
