"""The reference of a dataset-generation deck (`.luwdg`).

The case is worked out again from the raw deck and its STL by
`reference.setup.datagen_case`, at the inflow and direction of the deck's
rose that the case's prefix (`DG_<inflow>_<angle>_`) names.  The stretch
is followed and averaged by `reference.follow`.
"""

from luwbench.reference.follow import average, follow as _follow, sample_step
from luwbench.reference.setup import datagen_case

__all__ = ["tables", "follow", "average", "sample"]

sample = sample_step


def tables(prod, device):
    parts = prod.prefix.split("_")
    return datagen_case(prod.deck, float(parts[1]), float(parts[2]), device)


def follow(tables, prod, rounds, steps, device, low=False):
    fi, fbc = _follow(tables, prod.fi_in, prod.t0, rounds=rounds, steps=steps,
                      device=device, low=low)
    return fi, None, fbc
