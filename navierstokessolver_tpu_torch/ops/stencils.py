"""Finite-difference stencils on the staggered grid (plain PyTorch).

Counterpart of ``navierstokessolver_tpu/ops/stencils.py`` for the ported
slice (the BC kinds of bcs.py, obstacle correction masks, periodic axes).
On a periodic axis a component's own faces 0..n-1 are all distinct
unknowns updated with wrap neighbors, and face n repeats face 0.
Advection is the same
pinned choice: advective-form central differences blended with first-order
donor-cell upwinding by ``upwind_gamma`` in [0, 1].

These functions are the plain versions that the CUDA kernels
(ops/fused3d.py, ops/fused2d.py, ops/predictor3d.py, ops/predictor2d.py)
are held to.
Every function is dimension-generic: velocity is a tuple of face-normal
components, component ``a`` staggered along axis ``a``. The arithmetic is
written in the JAX module's order so the two agree to float32 roundoff.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..bcs import BCTable, pad_transverse, periodic_axes
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


def _wrap_extend_faces(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Periodic own-axis extension of a face array [f0..fn] (fn == f0):
    drop the duplicate last face and add one wrap ghost on each side, so
    the centred interior covers all n distinct faces with wrap
    neighbors."""
    work = _lo(arr, axis)
    n = work.shape[axis]
    return torch.cat([work.narrow(axis, n - 1, 1), work, work.narrow(axis, 0, 1)],
                     dim=axis)


def _with_duplicate(work: torch.Tensor, axis: int) -> torch.Tensor:
    """The n distinct faces of a periodic axis plus face n = face 0."""
    return torch.cat([work, work.narrow(axis, 0, 1)], dim=axis)


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


def divergence_ap(grid: GridSpec, u: Sequence[torch.Tensor],
                  ap: Sequence[torch.Tensor]) -> torch.Tensor:
    """The cut-cell (apertured) divergence ``sum_a (a_hi u_hi - a_lo
    u_lo)/h_a``, ``ap`` the per-axis full face apertures (cutcell.py); the
    matching operator is ops/poisson.build_poisson_op_cut."""
    h = grid.spacing
    out = None
    for a, comp in enumerate(u):
        au = ap[a] * comp
        d = (_hi(au, a) - _lo(au, a)) / h[a]
        out = d if out is None else out + d
    return out


def poisson_rhs(grid: GridSpec, u_star: Sequence[torch.Tensor], dt,
                rho: float, ap=None) -> torch.Tensor:
    """The Poisson RHS ``(rho/dt) div u*``, ``rho/dt`` formed in float32 as
    the JAX step forms it; every cell fluid (the caller masks). ``dt``: a
    Python float or a 0-d float32 tensor; ``ap``: the cut-cell apertures
    (the apertured divergence), None for the plain one."""
    if isinstance(dt, torch.Tensor):
        rho_over_dt = torch.full_like(dt, rho) / dt
    else:
        rho_over_dt = float(np.float32(rho) / np.float32(dt))
    div = (divergence(grid, u_star) if ap is None
           else divergence_ap(grid, u_star, ap))
    return div * rho_over_dt


def pressure_gradient(grid: GridSpec, p: torch.Tensor, axis: int) -> torch.Tensor:
    """dp/dx_axis at the *interior* faces along ``axis`` (shape - e_axis)."""
    return (_hi(p, axis) - _lo(p, axis)) / grid.spacing[axis]


def correct_velocity(
    grid: GridSpec, u: Sequence[torch.Tensor], p: torch.Tensor, scale,
    corr_masks: Optional[Sequence[torch.Tensor]] = None,
    periodic: Sequence[bool] = (),
) -> tuple[torch.Tensor, ...]:
    """Projection corrector: ``u -= scale * grad(p)`` on interior faces.

    ``scale`` is ``dt / rho``. Boundary-face DOFs are left untouched (the
    BC pass owns them); ``corr_masks[a]`` (bcs.correction_face_masks)
    zeroes the gradient on obstacle-adjacent faces. Along an axis that
    ``periodic`` marks every face is corrected with the wrap gradient
    (face 0 sees ``p[0] - p[n-1]``) and face n repeats face 0.
    """
    out = []
    for a, comp in enumerate(u):
        if periodic and periodic[a]:
            g = (p - torch.roll(p, 1, dims=a)) / grid.spacing[a]
            if corr_masks is not None:
                g = g * corr_masks[a]
            out.append(_with_duplicate(_lo(comp, a) - scale * g, a))
            continue
        g = pressure_gradient(grid, p, a)
        if corr_masks is not None:
            g = g * corr_masks[a]
        out.append(_add_interior(comp, a, -scale * g))
    return tuple(out)


def laplacian_component(
    grid: GridSpec, bcs: BCTable, comp: int, arr: torch.Tensor
) -> torch.Tensor:
    """Viscous Laplacian of velocity component ``comp`` at its interior
    faces (n_comp - 1 along ``comp``, all n faces on a periodic ``comp``
    axis; full extent elsewhere)."""
    nd = grid.ndim
    h = grid.spacing
    if periodic_axes(grid, bcs)[comp]:
        arr = _wrap_extend_faces(arr, comp)
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
    grid: GridSpec, u: Sequence[torch.Tensor], comp: int, trans: int,
    wrap_comp: bool = False,
) -> torch.Tensor:
    """Average component ``trans`` onto the interior-face locations of
    component ``comp`` (pair averages along ``comp``, then ``trans``).
    ``wrap_comp``: ``comp``'s axis is periodic; the values then cover all
    n faces, face 0's cell pair wrapping around."""
    ut = u[trans]
    if wrap_comp:
        n = ut.shape[comp]
        ut = torch.cat([ut.narrow(comp, n - 1, 1), ut], dim=comp)
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
    arr = u[comp]
    wrap_own = periodic_axes(grid, bcs)[comp]
    if wrap_own:
        arr = _wrap_extend_faces(arr, comp)
    padded = pad_transverse(grid, bcs, comp, arr)
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
            vel = _transverse_velocity_at(grid, u, comp, ax, wrap_own)
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
    forcing: Optional[Sequence[Optional[torch.Tensor]]] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, ...]:
    """Explicit advection-diffusion predictor
    ``u* = u + dt*(-adv + nu*lap [+ f])`` on interior faces; boundary DOFs
    are left for the BC pass; on a periodic axis every face is updated
    and face n repeats face 0. ``forcing[a]`` (or None) has the shape of
    component ``a``'s interior faces (all n on a periodic axis), e.g.
    :func:`..les.sgs_forcing`. ``dt``: a Python float or a 0-d tensor.
    ``base``: rk2's stage-2 mode, ``u*`` anchored at the step-start field,
    ``u* = base + dt*RHS(u)`` (the boundary DOFs then keep ``base``'s)."""
    per = periodic_axes(grid, bcs)
    out = []
    for a, comp in enumerate(u):
        adv = advection_component(grid, bcs, u, a, upwind_gamma)
        lap = laplacian_component(grid, bcs, a, comp)
        rhs = -adv + nu * lap
        if forcing is not None and forcing[a] is not None:
            rhs = rhs + forcing[a]
        anchor = comp if base is None else base[a]
        if per[a]:
            out.append(_with_duplicate(_lo(anchor, a) + dt * rhs, a))
        else:
            out.append(_add_interior(anchor, a, dt * rhs))
    return tuple(out)


def max_cfl(grid: GridSpec, u: Sequence[torch.Tensor], dt) -> torch.Tensor:
    """max over axes of |u| dt / h (advective CFL number); ``dt`` a Python
    float or a 0-d tensor."""
    cfl = torch.zeros((), dtype=grid.dtype, device=u[0].device)
    for a, comp in enumerate(u):
        cfl = torch.maximum(cfl, comp.abs().max() * dt / grid.spacing[a])
    return cfl


# -- derived fields of a snapshot (io.snapshot_arrays) -------------------------


def vorticity_2d(grid: GridSpec, u: Sequence[torch.Tensor]) -> torch.Tensor:
    """z-vorticity dv/dx - du/dy at interior grid nodes, ``(nx-1, ny-1)``."""
    if grid.ndim != 2:
        raise ValueError("vorticity_2d is 2D only")
    dx, dy = grid.spacing
    uu, vv = u
    dvdx = (vv[1:, 1:-1] - vv[:-1, 1:-1]) / dx
    dudy = (uu[1:-1, 1:] - uu[1:-1, :-1]) / dy
    return dvdx - dudy


def streamfunction_2d(grid: GridSpec,
                      u: Sequence[torch.Tensor]) -> torch.Tensor:
    """The discrete streamfunction at grid nodes, ``(nx+1, ny+1)``:
    ``psi(i, j+1) - psi(i, j) = u[i, j] dy`` with ``psi(i, 0) = 0``, the
    MAC-exact column integral (path-independent wherever the discrete
    divergence vanishes). The prefix sum's order is the device's, so it
    agrees with another order to a few ulps of max|psi| a column."""
    if grid.ndim != 2:
        raise ValueError("streamfunction_2d is 2D only")
    psi = torch.cumsum(u[0], dim=1) * grid.spacing[1]
    return torch.nn.functional.pad(psi, (1, 0))


def vorticity_magnitude_3d(grid: GridSpec,
                           u: Sequence[torch.Tensor]) -> torch.Tensor:
    """|curl u| at interior grid nodes, ``(nx-1, ny-1, nz-1)``: each curl
    component averaged from its edges to the shared nodes."""
    if grid.ndim != 3:
        raise ValueError("vorticity_magnitude_3d is 3D only")
    h = grid.spacing
    uu, vv, ww = u

    def d(arr, axis, ax_h):
        return (_hi(arr, axis) - _lo(arr, axis)) / h[ax_h]

    def avg(arr, axis):
        return 0.5 * (_hi(arr, axis) + _lo(arr, axis))

    # omega_x = dw/dy - dv/dz at (cell, node, node), then over x pairs
    wx = avg(d(ww[:, :, 1:-1], 1, 1) - d(vv[:, 1:-1, :], 2, 2), 0)
    # omega_y = du/dz - dw/dx at (node, cell, node), then over y pairs
    wy = avg(d(uu[1:-1, :, :], 2, 2) - d(ww[:, :, 1:-1], 0, 0), 1)
    # omega_z = dv/dx - du/dy at (node, node, cell), then over z pairs
    wz = avg(d(vv[:, 1:-1, :], 0, 0) - d(uu[1:-1, :, :], 1, 1), 2)
    return torch.sqrt(wx * wx + wy * wy + wz * wz)


def q_criterion_3d(grid: GridSpec,
                   u: Sequence[torch.Tensor]) -> torch.Tensor:
    """Q = -(1/2) tr(G G), G_ij = du_i/dx_j, at cell centres: central
    differences of the centre-interpolated velocity, one-sided first order
    at the domain edges (``jnp.gradient``'s formula)."""
    if grid.ndim != 3:
        raise ValueError("q_criterion_3d is 3D only")
    from ..grid import interpolate_to_centers

    uc = interpolate_to_centers(grid, u)
    g = [[torch.gradient(uc[i], spacing=grid.spacing[j], dim=j,
                         edge_order=1)[0] for j in range(3)]
         for i in range(3)]
    q = torch.zeros_like(uc[0])
    for i in range(3):
        for j in range(3):
            q = q - 0.5 * g[i][j] * g[j][i]
    return q
