"""cleanluw — delete temporary case artifacts under <case>/proj_temp.

Removes files recursively, keeps directories, never follows dir symlinks,
never mutates the deck.  (reference: tools_core/cleanluw.py)
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def remove_files_in_proj_temp(parent_dir: Path) -> int:
    target = parent_dir / "proj_temp"
    if not target.exists():
        return 0
    if not target.is_dir():
        raise NotADirectoryError(f"{target} is not a directory")
    removed = 0
    for root, _dirs, files in os.walk(target, topdown=True, followlinks=False):
        for name in files:
            p = Path(root) / name
            try:
                p.unlink()
                removed += 1
            except FileNotFoundError:
                pass
            except PermissionError as e:
                print(f"Warning: failed to delete file: {p} ({e})", file=sys.stderr)
    return removed


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: cleanluw <deck file path>", file=sys.stderr)
        return 1
    deck_file = Path(argv[0]).resolve()
    if not deck_file.is_file():
        print(f"Error: {deck_file} is not a valid file", file=sys.stderr)
        return 1
    try:
        n = remove_files_in_proj_temp(deck_file.parent)
        print(f"cleanluw: removed {n} file(s) from proj_temp")
    except Exception as e:
        print(f"Failed to clean proj_temp: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
