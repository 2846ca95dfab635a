"""Poiseuille channel: parabolic inflow at x=0, outflow at x=Lx, no-slip
walls (PyTorch port).

Counterpart of ``navierstokessolver_tpu/cases/channel.py``: BASELINE config
#2 (256x64, inflow-outflow + no-slip). Oracle: the analytic parabolic
profile ``u(y) = 4 u_max y (Ly - y) / Ly^2`` is a steady solution of the
discrete system and must persist. The inflow profile is a BC value array
(bcs.py): the unfused 2D step reads it through the predictor kernel's
ghost table (ops/predictor2d.py) and the BC passes.

``channel_periodic``: the body-force-driven channel, periodic along x with
no-slip walls; a constant force ``f_x = 8 nu u_max / Ly^2`` replaces the
mean pressure gradient, and the Poiseuille parabola is its steady
solution (the fused 2D step with the static force; the direct solve's
circulant plan along x and DCT along y).

``duct_periodic``: the 3D analog, periodic streamwise with four no-slip
walls; the steady solution is the series profile
(:func:`duct_profile_exact`); kernel 1's static force.
``pulsatile_channel``: the Womersley channel, the force
``amp cos(omega t)`` a callable of the carried time, refilled into kernel
4's force entry each step on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bcs import BCSpec, apply_velocity_bcs
from ..grid import GridSpec, State
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation
from .cavity import _stable_dt


def parabolic_profile(grid: GridSpec, u_max: float) -> np.ndarray:
    """Inflow u(y) at the cell-centre heights (the u component's face
    slice), numpy float32: the JAX profile's arithmetic."""
    y = grid.cell_centers(1)
    ly = grid.lengths[1]
    return 4.0 * u_max * y * (ly - y) / (ly * ly)


def build_channel(
    shape=(256, 64),
    lengths=(4.0, 1.0),
    re: float = 100.0,
    u_max: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "mg",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    outlet: str = "outflow",
    device="cuda",
    **params_kw,
):
    """``device``: the card unless the caller names another; without a
    CUDA device the default raises. ``outlet``: "outflow" (zero-gradient)
    or "convective" (du/dt + U du/dn = 0 with U the bulk inflow speed
    2 u_max / 3, less reflective for unsteady wakes; JAX's)."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    nu = u_max * grid.lengths[1] / re
    bcs = {
        (0, 0): BCSpec.inflow((parabolic_profile(grid, u_max), 0.0)),
        (0, 1): (BCSpec.convective(2.0 * u_max / 3.0)
                 if outlet == "convective" else BCSpec.outflow()),
        (1, 0): BCSpec.wall((0.0, 0.0)),
        (1, 1): BCSpec.wall((0.0, 0.0)),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, u_max, upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
    )
    sim = Simulation.build(grid, bcs, params, device)
    return Case(
        name="channel",
        sim=sim,
        suggested_steps=int(8.0 / dt),
        description=f"Poiseuille channel Re={re} {shape}",
    )


def poiseuille_state(sim: Simulation, u_max: float = 1.0) -> State:
    """Exact steady state: parabolic u everywhere, v = 0, p = 0 (the linear
    pressure is left out, as in JAX)."""
    grid = sim.grid
    profile = torch.as_tensor(parabolic_profile(grid, u_max),
                              device=sim.device)
    st = sim.initial_state()
    u0 = profile[None, :].expand(grid.face_shape(0)).contiguous()
    u = apply_velocity_bcs(grid, sim.bcs, (u0, st.u[1]), sim.face_masks)
    return State(u=u, p=st.p, p_prev=st.p_prev)


def build_channel_periodic(
    shape=(256, 64),
    lengths=(4.0, 1.0),
    re: float = 100.0,
    u_max: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    device="cuda",
    **params_kw,
):
    """Body-force-driven channel (JAX's defaults): periodic along x,
    no-slip walls, the force ``(8 nu u_max / Ly^2, None)``; the initial
    state is the parabola. ``device``: the card unless the caller names
    another; without a CUDA device the default raises."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    ly = grid.lengths[1]
    nu = u_max * ly / re
    bcs = {
        (0, 0): BCSpec.periodic(),
        (0, 1): BCSpec.periodic(),
        (1, 0): BCSpec.wall((0.0, 0.0)),
        (1, 1): BCSpec.wall((0.0, 0.0)),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, u_max, upwind_gamma)
    fx = 8.0 * nu * u_max / (ly * ly)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
    )
    sim = Simulation.build(grid, bcs, params, device, forcing=(fx, None))
    return Case(
        name="channel_periodic",
        sim=sim,
        suggested_steps=2000,
        description="body-force-driven periodic channel (laminar Poiseuille)",
        init=lambda s: poiseuille_state(s, u_max),
    )


def duct_profile_exact(ny: int, nz: int, ly: float, lz: float,
                       g_over_nu: float, n_terms: int = 61) -> np.ndarray:
    """The analytic fully developed rectangular duct profile u(y, z) at
    cell centres, a (ny, nz) numpy float64 array: the series solution of
    nu lap(u) = -G with no-slip on all four walls (e.g. White, Viscous
    Fluid Flow, sec. 3-3), as JAX's:

        u = (G/2 nu) [ z(lz - z)
            - sum_{n odd} (8 lz^2 / (n pi)^3)
              cosh(n pi (y - ly/2)/lz) / cosh(n pi ly / (2 lz))
              sin(n pi z / lz) ]
    """
    y = (np.arange(ny) + 0.5) * (ly / ny)
    z = (np.arange(nz) + 0.5) * (lz / nz)
    yy, zz = np.meshgrid(y, z, indexing="ij")
    u = zz * (lz - zz)
    for n in range(1, n_terms + 1, 2):
        k = n * np.pi / lz
        u = u - (8.0 * lz * lz / (n * np.pi) ** 3) * (
            np.cosh(k * (yy - ly / 2.0)) / np.cosh(k * ly / 2.0)
        ) * np.sin(k * zz)
    return 0.5 * g_over_nu * u


def build_duct_periodic(
    shape=(64, 32, 32),
    lengths=(4.0, 1.0, 1.0),
    re: float = 100.0,
    u_scale: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    device="cuda",
    **params_kw,
):
    """Body-force-driven rectangular duct (JAX's defaults): periodic
    streamwise, no-slip on the four transverse walls; f_x scaled so the
    exact profile (:func:`duct_profile_exact`) peaks near ``u_scale``.
    ``device``: the card unless the caller names another; without a CUDA
    device the default raises."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    ly, lz = grid.lengths[1], grid.lengths[2]
    nu = u_scale * min(ly, lz) / re
    bcs = {
        (0, 0): BCSpec.periodic(),
        (0, 1): BCSpec.periodic(),
        (1, 0): BCSpec.wall((0.0, 0.0, 0.0)),
        (1, 1): BCSpec.wall((0.0, 0.0, 0.0)),
        (2, 0): BCSpec.wall((0.0, 0.0, 0.0)),
        (2, 1): BCSpec.wall((0.0, 0.0, 0.0)),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, u_scale, upwind_gamma)
    # the centre velocity of a square duct is ~0.295 (G/nu) a^2 with
    # a = lz/2: G so that the peak lands near u_scale
    fx = u_scale * nu / (0.295 * (min(ly, lz) / 2.0) ** 2)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
    )
    sim = Simulation.build(grid, bcs, params, device,
                           forcing=(fx, None, None))
    return Case(
        name="duct_periodic",
        sim=sim,
        suggested_steps=4000,
        description="body-force-driven periodic duct (exact series profile)",
    )


def build_pulsatile_channel(
    shape=(64, 64),
    lengths=(2.0, 1.0),
    womersley: float = 5.0,
    amp: float = 1.0,
    omega: float = 2.0 * np.pi,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    dtype=None,
    device="cuda",
    **params_kw,
):
    """Pulsatile (Womersley) channel (JAX's defaults): the oscillating body
    force ``f_x(t) = amp cos(omega t)`` in a streamwise-periodic channel
    with no-slip walls; ``Wo = (Ly/2) sqrt(omega/nu)``. The force is a
    callable of the carried ``State.t`` (a 0-d tensor on the device).
    ``device``: the card unless the caller names another; without a CUDA
    device the default raises."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    ly = grid.lengths[1]
    nu = omega * (0.5 * ly) ** 2 / (womersley * womersley)
    bcs = {
        (0, 0): BCSpec.periodic(),
        (0, 1): BCSpec.periodic(),
        (1, 0): BCSpec.wall((0.0, 0.0)),
        (1, 1): BCSpec.wall((0.0, 0.0)),
    }
    u_scale = amp / omega  # the inviscid core's velocity amplitude
    dt = dt if dt is not None else min(
        _stable_dt(grid, nu, max(u_scale, 1e-6), 0.0),
        2.0 * np.pi / omega / 200.0,   # >= 200 steps a period
    )

    def fx(t):
        return amp * torch.cos(omega * t)

    params = SimParams(
        dt=dt,
        nu=nu,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
        ),
    )
    sim = Simulation.build(grid, bcs, params, device, forcing=(fx, None))
    period = 2.0 * np.pi / omega
    return Case(
        name="pulsatile_channel",
        sim=sim,
        suggested_steps=int(4 * period / dt),
        description=(
            f"pulsatile channel Wo={womersley} {shape} "
            f"(omega={omega:.3g}, nu={nu:.3g})"
        ),
    )
