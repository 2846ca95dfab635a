"""Flow past a circular cylinder at Re=200 (vortex shedding), PyTorch port.

Counterpart of ``navierstokessolver_tpu/cases/cylinder.py``: BASELINE
config #3 (512x256, obstacle mask). Domain 16x8 diameters, cylinder D=1
centred at (4, 4.003) (the small vertical offset seeds the shedding);
uniform inflow on the left, a zero-gradient outflow on the right, slip
walls at the top and bottom. The pressure solve is ``dctcg``, the
capacitance-corrected DCT-preconditioned solve, warm-started from
``p + 0.8 (p - p_prev)``. ``heated=True`` (the ``heated_cylinder`` case):
forced convection from an isothermal cylinder (theta = 1 body in a theta =
0 stream, a passive scalar, alpha = nu/Pr).

``build_sphere`` is the 3D analog (flow past a sphere at Re 300, 256x128x128
over 16x8x8 diameters): inflow, outflow, four slip walls and the staircase
sphere, through the fused 3D kernels' masked mode and the 3D ``dctcg``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bcs import BCSpec, apply_velocity_bcs
from ..grid import GridSpec, State
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation
from .cavity import _stable_dt


def cylinder_mask(grid: GridSpec, center, radius: float) -> np.ndarray:
    """Solid-cell mask: cell centers inside the circle (float32
    coordinates, as the JAX mask takes them)."""
    coords = np.meshgrid(
        *[grid.cell_centers(a) for a in range(grid.ndim)], indexing="ij",
    )
    r2 = sum((c - c0) ** 2 for c, c0 in zip(coords, center))
    return r2 <= radius * radius


def build_cylinder(
    shape=(512, 256),
    lengths=(16.0, 8.0),
    re: float = 200.0,
    u_in: float = 1.0,
    diameter: float = 1.0,
    center=(4.0, 4.003),  # slight y-offset seeds the shedding instability
    dt: float | None = None,
    poisson_method: str = "dctcg",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.2,
    dtype=None,
    outlet: str = "outflow",
    poisson_extrapolate: float = 0.8,
    ibm: bool = False,
    spin: float = 0.0,
    sharp_pressure: bool = False,
    heated: bool = False,
    prandtl: float = 0.7,
    device="cuda",
    **params_kw,
):
    """``ibm=True`` replaces the staircase velocity treatment with the
    sharp-interface direct forcing from the circle's exact signed distance
    (ibm.py). ``spin`` (needs ``ibm``): the surface's rotation rate
    omega R / u_in. ``heated``: the passive temperature of
    :func:`_heated_scalar` (the mean Nusselt number from
    ``scalar.body_heat_flux`` / (pi alpha)). ``device``: the card unless
    the caller names another; without a CUDA device the default raises.
    ``outlet="convective"`` and ``sharp_pressure`` are not ported yet and
    raise."""
    from . import Case

    if outlet != "outflow":
        raise NotImplementedError(
            f"outlet {outlet!r}: CONVECTIVE faces are not ported yet "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    if sharp_pressure and not ibm:
        raise ValueError("sharp_pressure requires ibm=True (needs the sdf)")
    if sharp_pressure:
        raise NotImplementedError(
            "cylinder sharp_pressure (cut-cell pressure): not ported yet "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    nu = u_in * diameter / re
    solid = cylinder_mask(grid, center, diameter / 2.0)
    bcs = {
        (0, 0): BCSpec.inflow((u_in, 0.0)),
        (0, 1): BCSpec.outflow(),
        (1, 0): BCSpec.slip(),
        (1, 1): BCSpec.slip(),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, 1.8 * u_in,
                                              upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
            # the iterative solves warm-start from p + 0.8 (p - p_prev)
            extrapolate=(poisson_extrapolate
                         if poisson_method != "fft" else 0.0),
        ),
    )
    radius = diameter / 2.0
    sdf = (lambda *cs: np.sqrt(
        sum((c - c0) ** 2 for c, c0 in zip(cs, center))) - radius
    ) if ibm else None
    vel = None
    if spin:
        if not ibm:
            raise ValueError("spin (rotating cylinder) requires ibm=True")
        omega = spin * u_in / radius

        def vel(x, y):  # rigid rotation about the center
            return (-omega * (y - center[1]), omega * (x - center[0]))
    scalar = _heated_scalar(grid, nu, prandtl) if heated else None
    sim = Simulation.build(grid, bcs, params, device, solid=solid, sdf=sdf,
                           surface_velocity=vel, scalar=scalar)
    return Case(
        name="heated_cylinder" if heated else "cylinder",
        sim=sim,
        suggested_steps=int(150.0 / dt),  # enough shedding periods for St
        description=f"cylinder Re={re} {shape}"
        + (f" heated Pr={prandtl}" if heated else ""),
    )


def _heated_scalar(grid: GridSpec, nu: float, prandtl: float):
    """The passive temperature of the heated-obstacle cases: a theta = 0
    free stream (inflow Dirichlet), zero-gradient outlet and lateral
    faces, a theta = 1 isothermal body, alpha = nu/Pr."""
    from ..scalar import ScalarBC, ScalarConfig

    nd = grid.ndim
    sc_bcs = {(a, s): ScalarBC.adiabatic()
              for a in range(nd) for s in (0, 1)}
    sc_bcs[(0, 0)] = ScalarBC.dirichlet(0.0)
    return ScalarConfig(
        bcs=sc_bcs,
        diffusivity=nu / prandtl,
        body_bc=ScalarBC.dirichlet(1.0),
    )


def build_sphere(
    shape=(256, 128, 128),
    lengths=(16.0, 8.0, 8.0),
    re: float = 300.0,
    u_in: float = 1.0,
    diameter: float = 1.0,
    center=(4.0, 4.003, 3.997),  # off-axis offsets seed the instability
    dt: float | None = None,
    poisson_method: str = "dctcg",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.2,
    dtype=None,
    outlet: str = "outflow",
    poisson_extrapolate: float = 0.8,
    ibm: bool = False,
    spin: float = 0.0,
    sharp_pressure: bool = False,
    heated: bool = False,
    prandtl: float = 0.7,
    device="cuda",
    **params_kw,
):
    """Flow past a sphere (the 3D analog of the cylinder case; JAX's
    signature and defaults): Re 300, whose wake sheds (St ~ 0.135), the
    staircase sphere of ``cylinder_mask`` with a 3-vector centre. ``device``:
    the card unless the caller names another. ``ibm``, ``spin``,
    ``sharp_pressure``, ``heated`` and ``outlet="convective"`` are not
    ported yet and raise (``spin`` without ``ibm`` and ``sharp_pressure``
    without it raise ValueError, as in JAX)."""
    from . import Case

    if outlet != "outflow":
        raise NotImplementedError(
            f"outlet {outlet!r}: CONVECTIVE faces are not ported yet "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    if spin and not ibm:
        raise ValueError("spin (rotating sphere) requires ibm=True")
    if sharp_pressure and not ibm:
        raise ValueError("sharp_pressure requires ibm=True (needs the sdf)")
    if sharp_pressure:
        raise NotImplementedError(
            "sphere sharp_pressure (cut-cell pressure): not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )
    if ibm:
        raise NotImplementedError(
            "the sphere's immersed boundary (ibm=True, spin: the 3D IBM): "
            "not ported yet (ROADMAP Queue A, 'Physics extensions')"
        )
    if heated:
        raise NotImplementedError(
            "the heated sphere (3D heated obstacles): not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )
    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    nu = u_in * diameter / re
    solid = cylinder_mask(grid, center, diameter / 2.0)
    bcs = {
        (0, 0): BCSpec.inflow((u_in, 0.0, 0.0)),
        (0, 1): BCSpec.outflow(),
        (1, 0): BCSpec.slip(),
        (1, 1): BCSpec.slip(),
        (2, 0): BCSpec.slip(),
        (2, 1): BCSpec.slip(),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, 1.8 * u_in,
                                              upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
            extrapolate=(poisson_extrapolate
                         if poisson_method != "fft" else 0.0),
        ),
    )
    sim = Simulation.build(grid, bcs, params, device, solid=solid)
    return Case(
        name="sphere",
        sim=sim,
        suggested_steps=int(150.0 / dt),
        description=f"sphere Re={re} {shape}",
    )


def impulsive_start_state(sim: Simulation, u_in: float = 1.0) -> State:
    """Uniform free-stream initial condition (masked in the solid); any
    dimension."""
    grid = sim.grid
    st = sim.initial_state()
    u0 = torch.full(grid.face_shape(0), u_in, dtype=grid.dtype,
                    device=sim.device)
    u = apply_velocity_bcs(grid, sim.bcs, (u0, *st.u[1:]), sim.face_masks)
    return State(u=u, p=st.p, p_prev=st.p_prev)
