"""Velocity-set constants for D3Q19 (flow) and D3Q7 (temperature) lattices.

Ordering follows the canonical FluidX3D enumeration (reference:
core/cfd_core/FluidX3D/src/kernel.cpp:890-919) where directions come in
(+,-) opposite pairs: odd index i and i+1 are antiparallel.  This pairing
makes bounce-back and TRT trivially vectorizable.

Arrays are numpy (host) constants; step functions close over them.
"""

from __future__ import annotations

import numpy as np

# D3Q19 in cz-grouped order — a TPU-native renumbering of the standard set:
#   dirs 0..8   : cz = 0   (rest, x/y axes, xy diagonals)
#   dirs 9..13  : cz = +1
#   dirs 14..18 : cz = -1, arranged so OPP(9+k) = 14+k.
# Grouping by the z-component lets the Pallas z-plane kernel fetch each
# direction's plane exactly once (group cz=+1 streams from z-1, cz=-1 from
# z+1, cz=0 from the own plane).  Physics is invariant under renumbering.
# C19[i] = (cx, cy, cz)
C19 = np.array(
    [
        (0, 0, 0),
        (1, 0, 0), (-1, 0, 0),
        (0, 1, 0), (0, -1, 0),
        (1, 1, 0), (-1, -1, 0),
        (1, -1, 0), (-1, 1, 0),
        # cz = +1
        (0, 0, 1), (1, 0, 1), (-1, 0, 1), (0, 1, 1), (0, -1, 1),
        # cz = -1 (opposites of the block above, same order)
        (0, 0, -1), (-1, 0, -1), (1, 0, -1), (0, -1, -1), (0, 1, -1),
    ],
    dtype=np.int32,
)

# weight by |c|^2: 1/3 rest, 1/18 axis, 1/36 diagonal
W19 = np.array(
    [1.0 / 3.0 if (c * c).sum() == 0 else (1.0 / 18.0 if (c * c).sum() == 1 else 1.0 / 36.0)
     for c in C19],
    dtype=np.float32,
)

# Opposite direction: OPP19[i] is the index of -C19[i].
OPP19 = np.array(
    [int(np.where((C19 == -C19[i]).all(axis=1))[0][0]) for i in range(19)],
    dtype=np.int32,
)

# Index ranges of the cz groups (contiguous by construction).
GROUP0 = slice(0, 9)     # cz = 0
GROUP_P = slice(9, 14)   # cz = +1
GROUP_M = slice(14, 19)  # cz = -1

# D3Q7 thermal sub-lattice, same grouping: 0..4 cz=0, 5 cz=+1, 6 cz=-1.
C7 = np.array(
    [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    dtype=np.int32,
)
W7 = np.array([1.0 / 4.0] + [1.0 / 8.0] * 6, dtype=np.float32)
OPP7 = np.array([0, 2, 1, 4, 3, 6, 5], dtype=np.int32)
G7_0 = slice(0, 5)
G7_P = slice(5, 6)
G7_M = slice(6, 7)

# Lattice speed of sound for D3Q19 (c = 1/sqrt(3)); D3Q7 uses cs^2 = 1/2.
CS = 0.57735027
CS2 = 1.0 / 3.0

# Smagorinsky-Lilly constant folded as used by the LES relaxation update:
# 18*sqrt(2)*(C*Delta)^2 with C = 1/pi*(2/(3*Ck))^(3/4), Ck=3/2, Delta=1
# (reference: kernel.cpp:1735).
SMAGORINSKY_FACTOR = 0.76421222


def tau_from_nu(nu: float) -> float:
    """SRT relaxation time tau = 3*nu + 1/2 (D3Q19, cs^2 = 1/3)."""
    return 3.0 * nu + 0.5


def omega_from_nu(nu: float) -> float:
    """SRT relaxation rate w = 1/tau."""
    return 1.0 / tau_from_nu(nu)


def omega_t_from_alpha(alpha: float) -> float:
    """D3Q7 thermal relaxation rate w_T = 1/(2*alpha + 1/2).

    Reference-parity mapping (lbm.cpp device define `def_w_T`).  Note the
    quirk inherited from the reference: with D3Q7 weights (cs_T^2 = 1/4) the
    *effective* diffusivity of this mapping is alpha/2, verified numerically
    by tests/test_lbm_physics.py::test_thermal_diffusion_rate.
    """
    return 1.0 / (2.0 * alpha + 0.5)


def check_lattice_integrity() -> None:
    """Invariants: weights sum to 1, first moments vanish, opposites correct."""
    assert abs(W19.sum() - 1.0) < 1e-6
    assert abs(W7.sum() - 1.0) < 1e-6
    assert np.all((C19 * W19[:, None]).sum(axis=0) == 0)
    assert np.all(C19[OPP19] == -C19)
    assert np.all(C7[OPP7] == -C7)
    # second moment isotropy: sum_i w_i c_ia c_ib = cs^2 delta_ab
    m2 = np.einsum("i,ia,ib->ab", W19, C19.astype(np.float64), C19.astype(np.float64))
    assert np.allclose(m2, np.eye(3) / 3.0, atol=1e-7)
    m2t = np.einsum("i,ia,ib->ab", W7, C7.astype(np.float64), C7.astype(np.float64))
    assert np.allclose(m2t, np.eye(3) / 4.0, atol=1e-7)
