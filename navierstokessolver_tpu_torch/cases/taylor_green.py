"""Taylor-Green vortex in a fully periodic box, PyTorch port.

Counterpart of ``navierstokessolver_tpu/cases/taylor_green.py``. The 3D
vortex (``taylor_green3d``) is the vortex-stretching / transition benchmark
of Brachet et al. 1983 on [0, 2pi]^3 at Re 1600: u = sin x cos y cos z,
v = -cos x sin y cos z, w = 0, every axis PERIODIC, the direct solve on the
circulant eigenbasis. The 2D vortex (``taylor_green``) needs periodic
faces in 2D, which are not ported yet, and raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bcs import BCSpec
from ..grid import GridSpec, State
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation


def taylor_green3d_state(grid: GridSpec, device, amp: float = 1.0) -> State:
    """The classic 3D Taylor-Green initial field on [0, 2pi]^3 (staggered
    sampling, in float64 numpy rounded to float32 as the JAX state is):
    u = sin x cos y cos z, v = -cos x sin y cos z, w = 0. Divergence-free
    analytically and discretely."""
    nx, ny, nz = grid.shape
    hx, hy, hz = grid.spacing

    def nodes(n, h):
        return np.arange(n + 1) * h

    def centers(n, h):
        return (np.arange(n) + 0.5) * h

    xu, yu, zu = nodes(nx, hx), centers(ny, hy), centers(nz, hz)
    u = (amp * np.sin(xu)[:, None, None] * np.cos(yu)[None, :, None]
         * np.cos(zu)[None, None, :])
    xv, yv, zv = centers(nx, hx), nodes(ny, hy), centers(nz, hz)
    v = (-amp * np.cos(xv)[:, None, None] * np.sin(yv)[None, :, None]
         * np.cos(zv)[None, None, :])

    def dev(a):
        return torch.as_tensor(a.astype(np.float32)).to(device)

    w = torch.zeros(grid.face_shape(2), dtype=grid.dtype, device=device)
    p = torch.zeros(grid.shape, dtype=grid.dtype, device=device)
    return State(u=(dev(u), dev(v), w), p=p)


def build_taylor_green3d(
    shape=(128, 128, 128),
    re: float = 1600.0,   # the canonical 3D TGV transition benchmark Re
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    device="cuda",
    **params_kw,
):
    """3D Taylor-Green vortex (periodic box). There is no closed-form
    solution in 3D; the standard oracle is the kinetic energy and
    dissipation-rate history. ``device``: the card unless the caller names
    another; without a CUDA device the default raises."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=(2.0 * math.pi,) * 3)
    bcs = {(a, s): BCSpec.periodic() for a in range(3) for s in (0, 1)}
    nu = 1.0 / re
    if dt is None:
        h = min(grid.spacing)
        dt = min(0.25 * h, 0.2 * h * h / nu)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
        **params_kw,
    )
    sim = Simulation.build(grid, bcs, params, device)
    return Case(
        name="taylor_green3d",
        sim=sim,
        suggested_steps=int(round(10.0 / dt)),  # t=10 covers the peak
        description="3D Taylor-Green vortex (periodic; vortex stretching)",
        init=lambda s: taylor_green3d_state(s.grid, s.device),
    )


def build_taylor_green(**kw):
    """The 2D vortex (fully periodic square): not ported yet."""
    raise NotImplementedError(
        "taylor_green (PERIODIC faces in 2D and the split circulant plan): "
        "not ported yet (ROADMAP Queue A, 'Other BC kinds')"
    )
