"""The reference of a profile-research deck (`.luwpf`, no DEM).

The case is worked out again from the raw deck, its STL and
`wind_bc/profile.dat` by `reference.setup.profile_case`, at the direction
the deck gives the case: its one angle, or the one the case's prefix
(`ANG_<angle>_`) names where the deck lists several.  The stretch is
followed and averaged by `reference.follow`.
"""

from luwbench.reference.deck import load_deck
from luwbench.reference.follow import average, follow as _follow, sample_step
from luwbench.reference.setup import profile_case

__all__ = ["tables", "follow", "average", "sample"]

sample = sample_step


def tables(prod, device):
    if prod.prefix:
        angle = float(prod.prefix.split("_")[1])
    else:
        angle = load_deck(prod.deck).get_float_list("angle")[0]
    return profile_case(prod.deck, angle, device)


def follow(tables, prod, rounds, steps, device, low=False):
    fi, fbc = _follow(tables, prod.fi_in, prod.t0, rounds=rounds, steps=steps,
                      device=device, low=low)
    return fi, None, fbc
