"""Published-value physics checks of the step, on any device.

The JAX package holds its reference tier to analytic and published results
(`tests/test_cavity_validation.py`, `tests/test_strouhal_validation.py`,
`tests/test_lbm_physics.py`).  These are the same checks, each with the JAX
test's setup, published value and tolerance, run through the port's step
loop (`lbm/stepper.make_runner`, `lbm/fields.update_fields` where the JAX
test reads fields): on the CPU the plain versions, on a CUDA device the
kernels.  Each returns a `Check` whose rows hold every measured value beside
its band; `Check.ok` says whether all are inside.

None of the checks touches a decided divergence between the JAX reference
tier and the kernels the port follows: no TYPE_E cell sits under a nonzero
volume force (the cavity's lid and the vortex street's faces run with zero
force and no rotation) and none has a top sponge.

    from latticeurbanwind_tpu_torch.lbm.physics_checks import CHECKS
    for name, check in CHECKS.items():
        print(check("cuda"))
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .fields import update_fields
from .lattice import omega_from_nu, omega_t_from_alpha
from .state import (
    DynParams, Forcing, LBMState, StepConfig, TYPE_E, TYPE_S, make_initial_state,
)
from .stepper import make_runner


class Row(NamedTuple):
    """One measured value and its band: lo < value < hi, or lo <= value <=
    hi when `closed`; `ref` the published or analytic value, where the
    band is built around one."""

    label: str
    value: float
    lo: float
    hi: float
    closed: bool = False
    ref: Optional[float] = None

    @property
    def ok(self) -> bool:
        v = float(self.value)
        return (self.lo <= v <= self.hi) if self.closed else (self.lo < v < self.hi)


class Check(NamedTuple):
    name: str
    source: str            # the JAX test and the published value it holds
    rows: List[Row]
    steps: int             # time steps run, all runs together
    sims: tuple = ()       # the check's simulations (`_Sim`), in run order

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.rows)

    def __str__(self) -> str:
        return f"{self.name} ({self.source}; {self.steps} steps): " + "; ".join(
            f"{r.label} {r.value:.6g}"
            + ("" if r.ref is None else f" (published {r.ref:.6g})")
            + f" in {'[' if r.closed else '('}{r.lo:.6g}, {r.hi:.6g}"
            f"{']' if r.closed else ')'}{'' if r.ok else ' OUTSIDE'}"
            for r in self.rows)


def _dyn(force=(0.0, 0.0, 0.0), coriolis=(0.0, 0.0, 0.0)) -> DynParams:
    return DynParams(force=torch.tensor(force, dtype=torch.float32),
                     omega_coriolis=torch.tensor(coriolis, dtype=torch.float32))


class _Sim:
    """One simulation: its state on `device`, stepped by one runner.  It
    keeps its shape, the host arrays it started from (`init`: rho, u, T,
    flags as given) and copies of its initial DDFs (`initial`: fi, gi)."""

    def __init__(self, shape, config: StepConfig, device, dyn: DynParams,
                 **init):
        self.shape, self.config, self.dyn, self.init = tuple(shape), config, dyn, init
        self.state = make_initial_state(shape, config=config, device=device, **init)
        st = self.state
        self.initial = (st.fi.clone(), None if st.gi is None else st.gi.clone())
        self.run, _ = make_runner(config, Forcing(), shape=shape, device=device)
        self.steps = 0

    def step(self, n: int) -> LBMState:
        self.state = self.run(self.state, self.dyn, self.steps, n)
        self.steps += n
        return self.state

    def fields(self) -> LBMState:
        """The state with rho/u (and T) refreshed from the DDFs."""
        self.state = update_fields(self.state, self.config, self.dyn)
        return self.state


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# Ghia, Ghia & Shin (1982), table I, Re=100: u through the vertical
# centerline, y measured bottom wall -> lid (selected rows)
GHIA_RE100_U = {
    0.9766: 0.84123,
    0.7344: 0.00332,
    0.5000: -0.20581,
    0.2813: -0.15662,
    0.0625: -0.04192,
}


def lid_driven_cavity(device) -> Check:
    """Re 100 lid-driven cavity (3x48x48, thin periodic z, SRT, f32) run to
    steady state; u/U along the vertical centerline within 0.03 of Ghia et
    al. (1982) at five heights, and the primary vortex's core u below
    -0.15 U (tests/test_cavity_validation.py:28)."""
    N, U = 48, 0.1
    L = N - 2                      # fluid span between the solid walls
    nu = U * L / 100.0             # Re = U L / nu = 100
    shape = (3, N, N)
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = TYPE_S        # west wall
    flags[:, :, -1] = TYPE_S       # east wall
    flags[:, 0, :] = TYPE_S        # bottom
    flags[:, -1, :] = TYPE_E       # moving lid: equilibrium BC with u = U x
    u = np.zeros((3, *shape), np.float32)
    u[0, :, -1, :] = U
    config = StepConfig(omega=omega_from_nu(nu), collision="srt",
                        subgrid=False, storage="f32")
    sim = _Sim(shape, config, device, _dyn(), u=u, flags=flags)
    prev = None
    for _ in range(40):            # to steady state (~10k steps at 48^2)
        sim.step(500)
        ux = _np(sim.fields().u[0, 1, :, N // 2])
        if prev is not None and np.abs(ux - prev).max() < 2e-7:
            break
        prev = ux
    y_cells = (np.arange(N) - 0.5) / L    # wall surfaces at y=0 and y=1
    rows = [Row(f"u/U at y={y_t}", float(np.interp(y_t, y_cells, ux / U)),
                ref - 0.03, ref + 0.03, ref=ref)
            for y_t, ref in GHIA_RE100_U.items()]
    rows.append(Row("core u/U", float(ux[N // 2] / U), -np.inf, -0.15))
    return Check("cavity", "Ghia et al. 1982, Re 100, within 0.03", rows,
                 sim.steps, (sim,))


def vortex_street(device) -> Check:
    """Re 100 vortex street behind a circular cylinder (3x100x250, D = 10,
    12,000 steps): shedding develops (|v| > 0.2 u0 at the wake probe) and
    the Strouhal number of the probe's cross-stream velocity lies in [0.14,
    0.19] around Williamson's (1989) 0.164
    (tests/test_strouhal_validation.py:17)."""
    Z, Y, X = 3, 100, 250
    D = 10
    u0 = 0.1
    nu = u0 * D / 100.0                     # Re = 100
    config = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    cx, cy = X // 4, Y // 2
    yy, xx = np.mgrid[0:Y, 0:X]
    cyl = (xx - cx) ** 2 + (yy - cy) ** 2 <= (D / 2) ** 2
    flags = np.zeros((Z, Y, X), np.uint8)
    flags[:, cyl] = TYPE_S
    flags[:, :, 0] |= TYPE_E               # inflow
    flags[:, :, -1] |= TYPE_E              # outflow (EQ at u0)
    flags[:, 0, :] |= TYPE_E               # free-slip-ish far lateral
    flags[:, -1, :] |= TYPE_E
    u = np.zeros((3, Z, Y, X), np.float32)
    u[0] = u0
    u[1, :, : Y // 2, :] = 0.004           # asymmetry to trigger shedding
    u[:, :, cyl] = 0.0
    sim = _Sim((Z, Y, X), config, device, _dyn(), u=u, flags=flags)
    sample = 50                            # steps between probe samples
    px, py = cx + 3 * D, cy                # wake probe 3 diameters behind
    vs = []
    for _ in range(240):                   # 12 000 steps ~ 20 periods
        sim.step(sample)
        vs.append(float(sim.fields().u[1, 1, py, px]))
    sig = np.asarray(vs)[96:]              # discard the growth transient
    amp_max = float(np.abs(sig).max())
    sig = sig - sig.mean()
    freqs = np.fft.rfftfreq(len(sig), d=float(sample))
    amp = np.abs(np.fft.rfft(sig))
    st = float(freqs[1 + int(np.argmax(amp[1:]))] * D / u0)
    rows = [Row("max |v| / u0 at the wake probe", amp_max / u0, 0.2, np.inf),
            Row("Strouhal number", st, 0.14, 0.19, closed=True, ref=0.164)]
    return Check("strouhal", "Williamson 1989, St 0.164 at Re 100, band "
                 "[0.14, 0.19]", rows, sim.steps, (sim,))


def taylor_green(device) -> Check:
    """2-D Taylor-Green vortex (4x32x32 periodic, nu 0.02): the peak u after
    200 steps within 2% of U0 exp(-2 nu k^2 t) (tests/test_lbm_physics.py:60)."""
    N = 32
    nu = 0.02
    shape = (4, N, N)
    config = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    k = 2 * np.pi / N
    z, y, x = np.meshgrid(np.arange(4), np.arange(N), np.arange(N), indexing="ij")
    U0 = 0.01
    u = np.zeros((3, *shape), dtype=np.float32)
    u[0] = U0 * np.sin(k * x) * np.cos(k * y)
    u[1] = -U0 * np.cos(k * x) * np.sin(k * y)
    rho = 1.0 - (3.0 * U0**2 / 4.0) * (np.cos(2 * k * x) + np.cos(2 * k * y))
    sim = _Sim(shape, config, device, _dyn(), rho=rho, u=u)
    steps = 200
    sim.step(steps)
    expected = U0 * np.exp(-2.0 * nu * k * k * steps)
    measured = float(sim.fields().u[0].abs().max())
    return Check("taylor_green", "exp(-2 nu k^2 t) decay, within 2%",
                 [Row("max |u_x|", measured, expected * 0.98, expected * 1.02,
                      ref=expected)],
                 sim.steps, (sim,))


def poiseuille(device) -> Check:
    """Body-force channel flow between halfway bounce-back walls (18x4x8,
    nu 0.1, f 1e-5, 6,000 steps): u(z) within 2% of the peak of
    f/(2 nu) d (H - d) (tests/test_lbm_physics.py:82)."""
    Nz = 18
    shape = (Nz, 4, 8)
    nu = 0.1
    config = StepConfig(omega=omega_from_nu(nu), subgrid=False, storage="f32")
    flags = np.zeros(shape, dtype=np.uint8)
    flags[0] = TYPE_S
    flags[-1] = TYPE_S
    f = 1e-5
    sim = _Sim(shape, config, device, _dyn(force=(f, 0.0, 0.0)), flags=flags)
    sim.step(12 * 500)
    ux = _np(sim.fields().u[0, :, 2, 4]).astype(np.float64)
    # walls at z=0.5 and z=Nz-1.5; H = Nz-2 cells; u(z) = f/(2 nu) * d*(H-d)
    d = np.arange(Nz, dtype=np.float64) - 0.5
    H = Nz - 2.0
    expected = f / (2.0 * nu) * d * (H - d)
    interior = slice(1, Nz - 1)
    err = np.abs(ux[interior] - expected[interior]) / expected[interior].max()
    return Check("poiseuille", "parabolic profile, within 2% of the peak",
                 [Row("max |u - u_exact| / u_peak", float(err.max()), -np.inf,
                      0.02, ref=0.0)],
                 sim.steps, (sim,))


def thermal_diffusion(device) -> Check:
    """D3Q7 sine-wave temperature decay (4x4x32, alpha 0.05, 100 steps): the
    amplitude within 2% of 0.1 exp(-alpha_eff k^2 t), alpha_eff = (1/omega_T
    - 1/2)/4 = alpha/2 under the reference's mapping
    (tests/test_lbm_physics.py:145)."""
    N = 32
    alpha = 0.05
    shape = (4, 4, N)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, thermal=True,
                        omega_t=omega_t_from_alpha(alpha), storage="f32")
    k = 2 * np.pi / N
    x = np.arange(N)
    T = np.ones(shape, dtype=np.float32) + 0.1 * np.sin(k * x)[None, None, :]
    sim = _Sim(shape, config, device, _dyn(), T=T)
    steps = 100
    sim.step(steps)
    amp = float((sim.fields().T - 1.0).abs().max())
    alpha_eff = (1.0 / config.omega_t - 0.5) / 4.0  # = alpha/2
    expected = 0.1 * np.exp(-alpha_eff * k * k * steps)
    return Check("thermal_diffusion", "exp(-alpha_eff k^2 t) decay, within 2%",
                 [Row("max |T - 1|", amp, expected * 0.98, expected * 1.02,
                      ref=expected)],
                 sim.steps, (sim,))


def coriolis(device) -> Check:
    """Uniform flow (8^3 periodic, u_x 0.02) under a Coriolis rotation
    Omega_z 1e-3 for 100 steps turns toward -y (mean u_y < -1e-4) and keeps
    its speed within 5% (tests/test_lbm_physics.py:187)."""
    shape = (8, 8, 8)
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False, storage="f32")
    u0 = np.zeros((3, *shape), dtype=np.float32)
    u0[0] = 0.02
    sim = _Sim(shape, config, device, _dyn(coriolis=(0.0, 0.0, 1e-3)), u=u0)
    sim.step(100)
    u = sim.fields().u
    ux = float(u[0].mean())
    uy = float(u[1].mean())
    speed = float(np.hypot(ux, uy))
    return Check("coriolis", "f = -2 rho Omega x u turns +x toward -y, speed "
                 "kept within 5%",
                 [Row("mean u_y", uy, -np.inf, -1e-4),
                  Row("speed", speed, 0.02 * 0.95, 0.02 * 1.05, ref=0.02)],
                 sim.steps, (sim,))


def boussinesq(device) -> Check:
    """Boussinesq coupling (24x12x12 closed box, g 2e-4, beta 0.5, 150
    steps): a warm blob rises and a cold one sinks relative to the
    background (|w| > 1e-5), and with beta = 0 each blob moves with its
    surroundings at the same height (within 2e-6)
    (tests/test_lbm_physics.py:360)."""
    shape = (24, 12, 12)
    g = 2e-4
    config = StepConfig(omega=omega_from_nu(0.05), subgrid=False,
                        thermal=True, omega_t=omega_t_from_alpha(0.05),
                        beta=0.5, t_avg=1.0, storage="f32")
    Z, Y, X = shape
    T = np.ones(shape, np.float32)
    T[5:9, 4:8, 4:8] = 1.2
    T[15:19, 4:8, 4:8] = 0.8
    flags = np.zeros(shape, np.uint8)
    flags[0] = flags[-1] = TYPE_S          # closed top/bottom
    dyn = _dyn(force=(0.0, 0.0, -g))
    sim = _Sim(shape, config, device, dyn, T=T, flags=flags)
    sim.step(150)
    w = _np(sim.fields().u[2])
    # gravity also accelerates the uniform background until the hydrostatic
    # gradient builds: buoyancy is the motion relative to the background
    w_bg = w[1:-1].mean()
    rows = [Row("warm blob w - background", float(w[5:9, 4:8, 4:8].mean() - w_bg),
                1e-5, np.inf),
            Row("cold blob w - background", float(w[15:19, 4:8, 4:8].mean() - w_bg),
                -np.inf, -1e-5)]
    cfg0 = StepConfig(omega=config.omega, subgrid=False, thermal=True,
                      omega_t=config.omega_t, beta=0.0, t_avg=1.0,
                      storage="f32")
    sim0 = _Sim(shape, cfg0, device, dyn, T=T, flags=flags)
    sim0.step(150)
    w0 = _np(sim0.fields().u[2])
    ring = np.ones((Y, X), bool)
    ring[4:8, 4:8] = False
    for zlo, zhi in ((5, 9), (15, 19)):
        blob = w0[zlo:zhi, 4:8, 4:8].mean()
        around = w0[zlo:zhi][:, ring].mean()
        rows.append(Row(f"beta 0: blob w - ring w at z {zlo}:{zhi}",
                        float(blob - around), -2e-6, 2e-6))
    return Check("boussinesq", "warm rises, cold sinks; inert without beta",
                 rows, sim.steps + sim0.steps, (sim, sim0))


def schumann_drag(device) -> Check:
    """The Schumann stress (10x8x16, u 0.05 over a solid floor, cd 0.02, 5
    steps) removes horizontal momentum at 0.7-1.3x the predicted n cd u^2
    rho Y X, measured against a cd ~ 0 run so the shared ceiling loss
    cancels (tests/test_lbm_physics.py:446)."""
    shape = (10, 8, 16)
    u0 = 0.05
    cd = 0.02
    n = 5
    sims = []

    def momentum(cd_val):
        config = StepConfig(omega=omega_from_nu(0.01), subgrid=False,
                            storage="f32", wall_model=True, wall_cd=cd_val)
        flags = np.zeros(shape, np.uint8)
        flags[0] = TYPE_S
        u = np.zeros((3, *shape), np.float32)
        u[0, 1:] = u0
        sim = _Sim(shape, config, device, _dyn(), u=u, flags=flags)
        sim.step(n)
        sims.append(sim)
        f = sim.fields()
        return float((f.rho * f.u[0])[1:].double().sum())

    loss = momentum(1e-12) - momentum(cd)
    expected = n * cd * u0 * u0 * 1.0 * shape[1] * shape[2]
    return Check("schumann_drag", "dP/dt = -cd rho |u_h| u_h, 0.7-1.3x",
                 [Row("momentum loss", loss, 0.7 * expected, 1.3 * expected,
                      ref=expected)],
                 sum(s.steps for s in sims), tuple(sims))


def wall_sides(device) -> Check:
    """Flow along a vertical wall (8x32x16, v 0.05, 150 steps): stair-step
    bounce-back kills it (v < 0.015 at the first fluid cell), the specular
    sides keep it (within 1e-3 of 0.05), and the side Schumann stress sits
    between (tests/test_lbm_physics.py:545)."""
    import dataclasses

    shape = (8, 32, 16)
    u = np.zeros((3, *shape), np.float32)
    u[1] = 0.05                      # flow along y
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = TYPE_S          # vertical wall: the x = 0 plane
    base = StepConfig(omega=omega_from_nu(0.05), subgrid=False,
                      volume_force=True, wall_model=True, wall_cd=1e-9)
    sims = []

    def v_first_cell(cfg):
        sim = _Sim(shape, cfg, device, _dyn(), u=u, flags=flags)
        sim.step(150)
        sims.append(sim)
        return float(sim.fields().u[1, 4, 16, 1])

    v_bb = v_first_cell(base)
    v_slip = v_first_cell(dataclasses.replace(base, wall_sides=True,
                                              wall_cd_sides=0.0))
    v_cd = v_first_cell(dataclasses.replace(base, wall_sides=True,
                                            wall_cd_sides=0.01))
    rows = [Row("v, bounce-back", v_bb, -np.inf, 0.015),
            Row("v, free slip", v_slip, 0.05 - 1e-3, 0.05 + 1e-3, ref=0.05),
            Row("v, side stress", v_cd, v_bb, v_slip)]
    return Check("wall_sides", "bounce-back < side stress < free slip", rows,
                 sum(s.steps for s in sims), tuple(sims))


CHECKS: Dict[str, Callable[[Optional[str]], Check]] = {
    "cavity": lid_driven_cavity,
    "strouhal": vortex_street,
    "taylor_green": taylor_green,
    "poiseuille": poiseuille,
    "thermal_diffusion": thermal_diffusion,
    "coriolis": coriolis,
    "boussinesq": boussinesq,
    "schumann_drag": schumann_drag,
    "wall_sides": wall_sides,
}
