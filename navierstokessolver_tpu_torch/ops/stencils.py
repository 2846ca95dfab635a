"""Finite-difference stencils on the staggered grid (plain PyTorch).

Counterpart of ``navierstokessolver_tpu/ops/stencils.py`` for the ported
slice (WALL boundaries, no obstacles, no forcing). Advection is the same
pinned choice: advective-form central differences blended with first-order
donor-cell upwinding by ``upwind_gamma`` in [0, 1].

These functions are the plain versions that the fused CUDA kernels
(ops/fused3d.py) are held to, and the 2D step runs on them directly.
Every function is dimension-generic: velocity is a tuple of face-normal
components, component ``a`` staggered along axis ``a``. The arithmetic is
written in the JAX module's order so the two agree to float32 roundoff.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..bcs import BCTable, pad_transverse
from ..grid import GridSpec


def _lo(x: torch.Tensor, axis: int) -> torch.Tensor:
    """All but the last entry along ``axis``."""
    return x.narrow(axis, 0, x.shape[axis] - 1)


def _hi(x: torch.Tensor, axis: int) -> torch.Tensor:
    """All but the first entry along ``axis``."""
    return x.narrow(axis, 1, x.shape[axis] - 1)


def _mid(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.narrow(axis, 1, x.shape[axis] - 2)


def _neighbors(padded: torch.Tensor, ax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The -1 and +1 neighbors along ``ax`` of the centered interior of a
    ghost-padded component (slice(0,-2) / slice(2,None) along ``ax``,
    slice(1,-1) elsewhere)."""
    um, up = padded, padded
    for b in range(padded.ndim):
        if b == ax:
            um = um.narrow(b, 0, um.shape[b] - 2)
            up = up.narrow(b, 2, up.shape[b] - 2)
        else:
            um = _mid(um, b)
            up = _mid(up, b)
    return um, up


def _add_interior(arr: torch.Tensor, axis: int, delta: torch.Tensor) -> torch.Tensor:
    """``arr`` with ``arr[1:-1 along axis] + delta`` (a new tensor)."""
    out = arr.clone()
    _mid(out, axis).copy_(_mid(arr, axis) + delta)
    return out


def divergence(grid: GridSpec, u: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cell-centered divergence of a staggered velocity field."""
    h = grid.spacing
    out = None
    for a, comp in enumerate(u):
        d = (_hi(comp, a) - _lo(comp, a)) / h[a]
        out = d if out is None else out + d
    return out


def pressure_gradient(grid: GridSpec, p: torch.Tensor, axis: int) -> torch.Tensor:
    """dp/dx_axis at the *interior* faces along ``axis`` (shape - e_axis)."""
    return (_hi(p, axis) - _lo(p, axis)) / grid.spacing[axis]


def correct_velocity(
    grid: GridSpec, u: Sequence[torch.Tensor], p: torch.Tensor, scale
) -> tuple[torch.Tensor, ...]:
    """Projection corrector: ``u -= scale * grad(p)`` on interior faces.

    ``scale`` is ``dt / rho``. Boundary-face DOFs are left untouched.
    """
    return tuple(
        _add_interior(comp, a, -scale * pressure_gradient(grid, p, a))
        for a, comp in enumerate(u)
    )


def laplacian_component(
    grid: GridSpec, bcs: BCTable, comp: int, arr: torch.Tensor
) -> torch.Tensor:
    """Viscous Laplacian of velocity component ``comp`` at its interior
    faces (n_comp - 1 along ``comp``, full extent elsewhere)."""
    nd = grid.ndim
    h = grid.spacing
    padded = pad_transverse(grid, bcs, comp, arr)
    center = padded
    for ax in range(nd):
        center = _mid(center, ax)
    out = torch.zeros_like(center)
    for ax in range(nd):
        um, up = _neighbors(padded, ax)
        out = out + (up - 2.0 * center + um) / (h[ax] * h[ax])
    return out


def _transverse_velocity_at(
    grid: GridSpec, u: Sequence[torch.Tensor], comp: int, trans: int
) -> torch.Tensor:
    """Average component ``trans`` onto the interior-face locations of
    component ``comp`` (pair averages along ``comp``, then ``trans``)."""
    ut = u[trans]
    m = 0.5 * (_lo(ut, comp) + _hi(ut, comp))
    return 0.5 * (_lo(m, trans) + _hi(m, trans))


def advection_component(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[torch.Tensor],
    comp: int,
    upwind_gamma: float = 0.0,
) -> torch.Tensor:
    """Advective-form (u . grad) u_comp at interior faces of ``comp``:
    ``d = gamma * upwind + (1 - gamma) * central``."""
    nd = grid.ndim
    h = grid.spacing
    padded = pad_transverse(grid, bcs, comp, u[comp])
    center = padded
    for ax in range(nd):
        center = _mid(center, ax)
    out = torch.zeros_like(center)
    for ax in range(nd):
        um, up = _neighbors(padded, ax)
        central = (up - um) / (2.0 * h[ax])
        if ax == comp:
            vel = center
        else:
            vel = _transverse_velocity_at(grid, u, comp, ax)
        if upwind_gamma > 0.0:
            fwd = (up - center) / h[ax]
            bwd = (center - um) / h[ax]
            # zero velocity takes fwd, exactly as jnp.where(vel > 0, ...)
            upw = torch.where(vel > 0.0, bwd, fwd)
            d = upwind_gamma * upw + (1.0 - upwind_gamma) * central
        else:
            d = central
        out = out + vel * d
    return out


def predictor(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[torch.Tensor],
    dt,
    nu: float,
    upwind_gamma: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """Explicit advection-diffusion predictor ``u* = u + dt*(-adv + nu*lap)``
    on interior faces; boundary DOFs are left for the BC pass."""
    out = []
    for a, comp in enumerate(u):
        adv = advection_component(grid, bcs, u, a, upwind_gamma)
        lap = laplacian_component(grid, bcs, a, comp)
        rhs = -adv + nu * lap
        out.append(_add_interior(comp, a, dt * rhs))
    return tuple(out)


def max_cfl(grid: GridSpec, u: Sequence[torch.Tensor], dt) -> torch.Tensor:
    """max over axes of |u| dt / h (advective CFL number)."""
    cfl = torch.zeros((), dtype=grid.dtype, device=u[0].device)
    for a, comp in enumerate(u):
        cfl = torch.maximum(cfl, comp.abs().max() * dt / grid.spacing[a])
    return cfl
