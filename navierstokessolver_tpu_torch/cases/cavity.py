"""Lid-driven cavity cases (2D and 3D), PyTorch port.

Counterpart of ``navierstokessolver_tpu/cases/cavity.py``: unit square or
cube, no-slip walls, the top lid (last axis, high side) moving at ``lid``
in +x. BASELINE configs #1 (Re=100, 64x64) and #5 (3D, 256^3).
"""

from __future__ import annotations

import torch

from ..bcs import BCSpec
from ..grid import GridSpec
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation


def _stable_dt(grid: GridSpec, nu: float, u_max: float, upwind_gamma: float) -> float:
    """Conservative explicit-step limit: diffusive + advective CFL."""
    h = min(grid.spacing)
    ndim = grid.ndim
    dt_diff = h * h / (2.0 * ndim * nu) if nu > 0 else float("inf")
    dt_adv = h / max(u_max, 1e-12)
    return 0.5 * min(dt_diff, dt_adv)


def build_cavity(
    shape=(64, 64),
    re: float = 100.0,
    lid: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    upwind_gamma: float = 0.0,
    dtype=None,
    device="cpu",
    **params_kw,
):
    """``device`` is where every field and operator lives."""
    from . import Case  # local import to avoid a cycle

    grid = GridSpec(
        shape=tuple(shape),
        lengths=(1.0,) * len(shape),
        dtype=dtype or torch.float32,
    )
    nu = lid * grid.lengths[0] / re
    nd = grid.ndim
    zeros = (0.0,) * nd
    lid_vel = tuple(lid if a == 0 else 0.0 for a in range(nd))
    bcs = {(a, s): BCSpec.wall(zeros) for a in range(nd) for s in (0, 1)}
    bcs[(nd - 1, 1)] = BCSpec.wall(lid_vel)  # top face (last axis, high side)

    dt = dt if dt is not None else _stable_dt(grid, nu, lid, upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(method=poisson_method),
    )
    sim = Simulation.build(grid, bcs, params, device)
    return Case(
        name="cavity",
        sim=sim,
        suggested_steps=int(25.0 / dt),  # ~t=25 reaches steady state at Re=100
        description=f"lid-driven cavity Re={re} {shape}",
    )


def build_cavity3d(shape=(256, 256, 256), re: float = 1000.0, **kw):
    return build_cavity(shape=shape, re=re, **kw)
