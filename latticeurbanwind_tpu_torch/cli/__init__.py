"""Command-line entry points."""

from __future__ import annotations

from typing import List, Tuple

DEFAULT_DEVICE = "cuda"


def pop_device(argv: List[str]) -> Tuple[List[str], str]:
    """Split `--device DEV` (or `--device=DEV`) out of a stage's arguments:
    (the rest, DEV), DEV "cuda" when it is not given."""
    rest, device, i = [], DEFAULT_DEVICE, 0
    while i < len(argv):
        a = argv[i]
        if a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device
