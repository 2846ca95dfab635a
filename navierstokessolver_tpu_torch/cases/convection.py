"""Buoyancy-driven (natural convection) cases, PyTorch port.

Counterpart of ``navierstokessolver_tpu/cases/convection.py``, with its
keywords, defaults and dt rule:

heated_cavity: the de Vahl Davis (1983) differentially heated square (or
cube) cavity: hot left wall (theta = 1), cold right wall (theta = 0),
adiabatic elsewhere, Boussinesq buoyancy along the last axis.
Nondimensionalized with the buoyancy velocity scale ``U = sqrt(g beta dT
L)``, so ``g beta = 1``, ``nu = sqrt(Pr / Ra)`` and ``alpha = 1 / sqrt(Ra
Pr)``. Published hot-wall Nusselt numbers: Ra = 1e3 -> 1.118, 1e4 ->
2.243, 1e5 -> 4.519.

rayleigh_benard: periodic in x, rigid no-slip walls in y, hot bottom /
cold top; the rigid-rigid critical Rayleigh number is 1708.

heated_enclosure: a hot cylinder in a cold square enclosure (the
Moukalled-Acharya / Kim et al. configuration); the obstacle sends it down
the unfused 2D route, where the step forms the buoyancy of theta (the body
frozen) as a forcing volume of the predictor kernel and advances theta
with the plain update. Its steady oracle is the exact discrete energy
balance: the body's heat flux equals the walls' (:func:`wall_heat_flux`,
``scalar.body_heat_flux``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bcs import BCSpec
from ..grid import GridSpec
from ..ops.poisson import PoissonConfig
from ..scalar import ScalarBC, ScalarBCKind, ScalarConfig
from ..solver import SimParams, Simulation


def _convection_dt(grid: GridSpec, nu: float, alpha: float) -> float:
    """JAX's dt rule: the buoyancy velocity scale U = 1 and the diffusive
    limit of max(nu, alpha)."""
    h = min(grid.spacing)
    dmax = max(nu, alpha)
    return 0.5 * min(h, h * h / (4.0 * dmax))


def _params(dt, nu, upwind_gamma, poisson_method, poisson_tol, poisson_iters,
            params_kw) -> SimParams:
    return SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
        **params_kw,
    )


def build_heated_cavity(
    shape=(64, 64),
    ra: float = 1e4,
    pr: float = 0.71,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    device="cuda",
    **params_kw,
):
    """``device``: the card unless the caller names another."""
    from . import Case

    nd = len(shape)
    grid = GridSpec(shape=tuple(shape), lengths=(1.0,) * nd)
    nu = math.sqrt(pr / ra)
    alpha = 1.0 / math.sqrt(ra * pr)
    zeros = (0.0,) * nd
    bcs = {(a, s): BCSpec.wall(zeros) for a in range(nd) for s in (0, 1)}
    # hot left / cold right wall along axis 0, buoyancy along the last
    # axis, adiabatic elsewhere
    sc_bcs = {(a, s): ScalarBC.adiabatic() for a in range(nd) for s in (0, 1)}
    sc_bcs[(0, 0)] = ScalarBC.dirichlet(1.0)
    sc_bcs[(0, 1)] = ScalarBC.dirichlet(0.0)
    buoy = tuple(1.0 if a == nd - 1 else 0.0 for a in range(nd))
    cond = 1.0 - (np.arange(shape[0]) + 0.5) / shape[0]
    theta0 = np.broadcast_to(
        cond.reshape((shape[0],) + (1,) * (nd - 1)), tuple(shape)
    ).copy()
    scalar = ScalarConfig(
        bcs=sc_bcs,
        diffusivity=alpha,
        buoyancy=buoy,
        theta_ref=0.5,
        upwind_gamma=upwind_gamma,
        theta_init=theta0,
    )
    if dt is None:
        dt = _convection_dt(grid, nu, alpha)
    params = _params(dt, nu, upwind_gamma, poisson_method, poisson_tol,
                     poisson_iters, params_kw)
    sim = Simulation.build(grid, bcs, params, device, scalar=scalar)
    return Case(
        name="heated_cavity",
        sim=sim,
        suggested_steps=int(round(30.0 / dt)),
        description=f"differentially heated cavity Ra={ra:g} Pr={pr} {shape}",
    )


def hot_wall_nusselt(sim: Simulation, theta) -> float:
    """The average Nusselt number on the hot (x = 0) wall: the mean of
    -d(theta)/dx L / dT with the Dirichlet ghost convention (the
    first-order wall gradient 2 (theta_w - theta_1) / h)."""
    h = sim.grid.spacing[0]
    theta = torch.as_tensor(theta)
    grad = 2.0 * (1.0 - theta[0]) / h
    return float(torch.mean(grad))


def build_rayleigh_benard(
    shape=(48, 24),
    ra: float = 5e3,
    pr: float = 0.71,
    aspect: float = 2.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    perturb: float = 1e-2,
    device="cuda",
    **params_kw,
):
    """Rayleigh-Benard convection: periodic in x, rigid no-slip walls in
    y, hot bottom (theta = 1) / cold top (theta = 0). Below the critical
    Rayleigh number 1708 a seeded perturbation decays to the conductive
    state; above it convection rolls grow and saturate. ``device``: the
    card unless the caller names another."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=(aspect, 1.0))
    nu = math.sqrt(pr / ra)
    alpha = 1.0 / math.sqrt(ra * pr)
    zeros = (0.0, 0.0)
    bcs = {
        (0, 0): BCSpec.periodic(),
        (0, 1): BCSpec.periodic(),
        (1, 0): BCSpec.wall(zeros),
        (1, 1): BCSpec.wall(zeros),
    }
    nx, ny = shape
    x = (np.arange(nx) + 0.5) / nx * aspect
    y = (np.arange(ny) + 0.5) / ny
    cond = 1.0 - y                        # the conductive profile
    seed = perturb * np.sin(2.0 * np.pi * x / aspect)[:, None] \
        * np.sin(np.pi * y)[None, :]
    scalar = ScalarConfig(
        bcs={
            (0, 0): ScalarBC.periodic(),
            (0, 1): ScalarBC.periodic(),
            (1, 0): ScalarBC.dirichlet(1.0),   # hot bottom
            (1, 1): ScalarBC.dirichlet(0.0),   # cold top
        },
        diffusivity=alpha,
        buoyancy=(0.0, 1.0),
        theta_ref=0.5,
        upwind_gamma=upwind_gamma,
        theta_init=(np.broadcast_to(cond, (nx, ny)) + seed).astype(np.float32),
    )
    if dt is None:
        dt = _convection_dt(grid, nu, alpha)
    params = _params(dt, nu, upwind_gamma, poisson_method, poisson_tol,
                     poisson_iters, params_kw)
    sim = Simulation.build(grid, bcs, params, device, scalar=scalar)
    return Case(
        name="rayleigh_benard",
        sim=sim,
        suggested_steps=int(round(60.0 / dt)),
        description=f"Rayleigh-Benard Ra={ra:g} Pr={pr} {shape}",
    )


def build_heated_enclosure(
    shape=(64, 64),
    ra: float = 1e4,
    pr: float = 0.71,
    diameter: float = 0.4,
    center=(0.5, 0.5),
    dt: float | None = None,
    poisson_method: str = "mg",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    device="cuda",
    **params_kw,
):
    """Natural convection from a hot inner cylinder in a cold square
    enclosure (JAX's defaults): no-slip cold walls (theta = 0), an
    isothermal immersed body (theta = 1), Boussinesq buoyancy along +y;
    nondimensionalized on the enclosure side L with the buoyancy velocity
    scale (g beta = 1, nu = sqrt(Pr/Ra), alpha = 1/sqrt(Ra Pr): Ra is the
    side-based Rayleigh number). ``device``: the card unless the caller
    names another; without a CUDA device the default raises."""
    from . import Case
    from .cylinder import cylinder_mask

    nd = len(shape)
    grid = GridSpec(shape=tuple(shape), lengths=(1.0,) * nd)
    nu = math.sqrt(pr / ra)
    alpha = 1.0 / math.sqrt(ra * pr)
    zeros = (0.0,) * nd
    bcs = {(a, s): BCSpec.wall(zeros) for a in range(nd) for s in (0, 1)}
    solid = cylinder_mask(grid, center, diameter / 2.0)
    buoy = tuple(1.0 if a == nd - 1 else 0.0 for a in range(nd))
    scalar = ScalarConfig(
        bcs={(a, s): ScalarBC.dirichlet(0.0)
             for a in range(nd) for s in (0, 1)},
        diffusivity=alpha,
        buoyancy=buoy,
        theta_ref=0.0,
        upwind_gamma=upwind_gamma,
        body_bc=ScalarBC.dirichlet(1.0),
    )
    if dt is None:
        dt = _convection_dt(grid, nu, alpha)
    params = _params(dt, nu, upwind_gamma, poisson_method, poisson_tol,
                     poisson_iters, params_kw)
    sim = Simulation.build(grid, bcs, params, device, solid=solid,
                           scalar=scalar)
    return Case(
        name="heated_enclosure",
        sim=sim,
        suggested_steps=int(round(30.0 / dt)),
        description=(f"hot cylinder in cold enclosure Ra={ra:g} Pr={pr} "
                     f"{shape}"),
    )


def wall_heat_flux(sim: Simulation, theta) -> float:
    """The total diffusive flux out through every Dirichlet domain wall:
    the first-order wall gradient 2 (theta_edge - theta_wall) / h a face,
    times the face area. At steady state it balances
    ``scalar.body_heat_flux`` for an interior hot body."""
    g = sim.grid
    cfg = sim.scalar
    theta = torch.as_tensor(theta)
    vol = float(np.prod(g.spacing))
    total = 0.0
    for a in range(g.ndim):
        area = vol / g.spacing[a]
        for side in (0, 1):
            bc = cfg.bcs[(a, side)]
            if bc.kind is not ScalarBCKind.DIRICHLET:
                continue
            n = theta.shape[a]
            edge = theta.narrow(a, 0 if side == 0 else n - 1, 1)
            w = float(bc.value)
            total += float(
                torch.sum(2.0 * (edge - w) / g.spacing[a]) * area
                * cfg.diffusivity
            )
    return total
