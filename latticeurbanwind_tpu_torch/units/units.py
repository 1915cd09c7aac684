"""Lattice <-> SI unit conversion (m, kg, s, K with affine temperature map).

Clean-room equivalent of the reference Units class
(reference: core/cfd_core/FluidX3D/src/units.hpp:5-169).  Holds the four base
unit scales; temperature supports an affine map T_SI = T * unit_K + offset so
a lattice temperature of 1.0 can anchor an arbitrary reference Kelvin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class Units:
    unit_m: float = 1.0     # SI meters per lattice cell
    unit_kg: float = 1.0    # SI kg per lattice mass unit
    unit_s: float = 1.0     # SI seconds per lattice step
    unit_K: float = 1.0     # SI Kelvin per lattice temperature unit
    unit_K_offset: float = 0.0

    # -- calibration ---------------------------------------------------------

    def set_m_kg_s(self, x: float, u: float, rho: float,
                   si_x: float, si_u: float, si_rho: float) -> None:
        """Anchor scales from a length, velocity and density given in both systems."""
        self.unit_m = si_x / x
        self.unit_kg = si_rho / rho * self.unit_m ** 3
        self.unit_s = u / si_u * self.unit_m

    def set_m_kg_s_K(self, x: float, u: float, rho: float, T: float,
                     si_x: float, si_u: float, si_rho: float, si_T: float) -> None:
        self.set_m_kg_s(x, u, rho, si_x, si_u, si_rho)
        self.unit_K = si_T / T
        self.unit_K_offset = 0.0

    def set_temperature_reference(self, T_ref: float, si_T_ref: float) -> None:
        """Keep unit_K, shift the offset so lattice T_ref maps to si_T_ref."""
        self.unit_K_offset = si_T_ref - T_ref * self.unit_K

    # -- SI -> lattice ---------------------------------------------------------

    def x(self, si_x: float) -> float: return si_x / self.unit_m
    def m(self, si_m: float) -> float: return si_m / self.unit_kg
    def t(self, si_t: float) -> int: return int(si_t / self.unit_s)
    def frequency(self, si_f: float) -> float: return si_f * self.unit_s
    def u(self, si_u: float) -> float: return si_u * self.unit_s / self.unit_m
    def rho(self, si_rho: float) -> float: return si_rho * self.unit_m ** 3 / self.unit_kg
    def nu(self, si_nu: float) -> float: return si_nu * self.unit_s / self.unit_m ** 2
    def g(self, si_g: float) -> float: return si_g * self.unit_s ** 2 / self.unit_m
    def f(self, si_rho: float, si_g: float) -> float:
        """Force per volume from SI density and acceleration."""
        return si_rho * si_g * (self.unit_m * self.unit_s) ** 2 / self.unit_kg
    def T(self, si_T: float) -> float: return (si_T - self.unit_K_offset) / self.unit_K
    def dT(self, si_dT: float) -> float: return si_dT / self.unit_K
    def alpha(self, si_alpha: float) -> float: return si_alpha * self.unit_s / self.unit_m ** 2
    def beta(self, si_beta: float) -> float: return si_beta * self.unit_K

    # -- lattice -> SI ---------------------------------------------------------

    def si_x(self, x: float) -> float: return x * self.unit_m
    def si_t(self, t: float) -> float: return t * self.unit_s
    def si_u(self, u: float) -> float: return u * self.unit_m / self.unit_s
    def si_rho(self, rho: float) -> float: return rho * self.unit_kg / self.unit_m ** 3
    def si_p(self, p: float) -> float:
        return p * self.unit_kg / (self.unit_m * self.unit_s ** 2)
    def si_nu(self, nu: float) -> float: return nu * self.unit_m ** 2 / self.unit_s
    def si_T(self, T: float) -> float: return T * self.unit_K + self.unit_K_offset
    def si_dT(self, dT: float) -> float: return dT * self.unit_K

    # -- dimensionless helpers -------------------------------------------------

    @staticmethod
    def Re(x: float, u: float, nu: float) -> float: return x * u / nu
    @staticmethod
    def Ma(u: float) -> float: return u / 0.57735027
    @staticmethod
    def nu_from_tau(tau: float) -> float: return (tau - 0.5) / 3.0
    @staticmethod
    def p_from_rho(rho: float) -> float: return (rho - 1.0) / 3.0
    @staticmethod
    def rho_from_p(p: float) -> float: return 1.0 + 3.0 * p
