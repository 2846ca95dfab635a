"""Aerodynamic force diagnostics: control-volume momentum balance (PyTorch).

Counterpart of ``navierstokessolver_tpu/utils/forces.py``, the same
discretization. On a Cartesian MAC grid with a stair-step obstacle mask,
integrating the stress directly over the masked surface is noisy at O(h);
the control-volume (CV) momentum balance is the robust classical
alternative:

    F_body = - d/dt (integral_CV rho u dV)
             - (surface integral of rho u (u . n) dA)     [momentum flux]
             - (surface integral of p n dA)               [pressure]
             + (surface integral of mu grad(u) . n dA)    [viscous]

over any box enclosing the body. The surface terms are slice reductions
on the state's device (:meth:`..solver.Simulation.run_scan_forces` samples
them after every step without a host read); the d/dt term is the finite
difference of the CV momentum between successive samples
(:func:`drag_lift_series`, numpy, as in JAX).

Conventions: unit density, the box is given in CELL indices ``(i0, i1, j0,
j1[, k0, k1])`` (exclusive upper), box faces lie on cell boundaries = face
planes. ``F = -d(mom)/dt + surface_force``; ``Cd = 2 Fx / (rho U^2 D)``,
``Cl = 2 Fy / (rho U^2 D)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec, State


def cv_terms(
    grid: GridSpec, state: State, nu: float, box: tuple[int, int, int, int]
):
    """(surface_force_x, surface_force_y, mom_x, mom_y) for the 2D CV
    ``box``, 0-d tensors: the hand-unrolled 2D form. surface_force_* is the
    sum of momentum-flux + pressure + viscous surface integrals with
    OUTWARD normals, signed so that ``F_body = -d(mom)/dt +
    surface_force``."""
    if grid.ndim != 2:
        raise ValueError("cv_terms is 2D")
    i0, i1, j0, j1 = box
    dx, dy = grid.spacing
    u, v = state.u
    p = state.p

    # CV momentum (face velocities integrated over the box)
    mom_x = torch.sum(
        0.5 * (u[i0:i1, j0:j1] + u[i0 + 1:i1 + 1, j0:j1])
    ) * dx * dy
    mom_y = torch.sum(
        0.5 * (v[i0:i1, j0:j1] + v[i0:i1, j0 + 1:j1 + 1])
    ) * dx * dy

    # x-faces (left i0, right i1): normal = -x / +x
    def x_face(i, sgn):
        uf = u[i, j0:j1]
        dudx = ((u[i + 1, j0:j1] - u[i - 1, j0:j1]) / (2.0 * dx)
                if 0 < i < grid.shape[0] else torch.zeros_like(uf))
        vf = 0.25 * (v[i - 1, j0:j1] + v[i, j0:j1]
                     + v[i - 1, j0 + 1:j1 + 1] + v[i, j0 + 1:j1 + 1])
        dvdx = (v[i, j0:j1] + v[i, j0 + 1:j1 + 1]
                - v[i - 1, j0:j1] - v[i - 1, j0 + 1:j1 + 1]) / (2.0 * dx)
        pf = 0.5 * (p[i - 1, j0:j1] + p[i, j0:j1])
        fx = sgn * torch.sum(uf * uf) * dy + sgn * torch.sum(pf) * dy \
            - sgn * nu * torch.sum(dudx) * dy
        fy = sgn * torch.sum(vf * uf) * dy - sgn * nu * torch.sum(dvdx) * dy
        return fx, fy

    # y-faces (bottom j0, top j1): normal = -y / +y
    def y_face(j, sgn):
        vf = v[i0:i1, j]
        dvdy = ((v[i0:i1, j + 1] - v[i0:i1, j - 1]) / (2.0 * dy)
                if 0 < j < grid.shape[1] else torch.zeros_like(vf))
        uf = 0.25 * (u[i0:i1, j - 1] + u[i0:i1, j]
                     + u[i0 + 1:i1 + 1, j - 1] + u[i0 + 1:i1 + 1, j])
        dudy = (u[i0:i1, j] + u[i0 + 1:i1 + 1, j]
                - u[i0:i1, j - 1] - u[i0 + 1:i1 + 1, j - 1]) / (2.0 * dy)
        pf = 0.5 * (p[i0:i1, j - 1] + p[i0:i1, j])
        fy = sgn * torch.sum(vf * vf) * dx + sgn * torch.sum(pf) * dx \
            - sgn * nu * torch.sum(dvdy) * dx
        fx = sgn * torch.sum(uf * vf) * dx - sgn * nu * torch.sum(dudy) * dx
        return fx, fy

    fxl, fyl = x_face(i0, -1.0)
    fxr, fyr = x_face(i1, +1.0)
    fxb, fyb = y_face(j0, -1.0)
    fxt, fyt = y_face(j1, +1.0)
    sfx = -(fxl + fxr + fxb + fxt)
    sfy = -(fyl + fyr + fyb + fyt)
    return sfx, sfy, mom_x, mom_y


def cv_terms_nd(grid: GridSpec, state: State, nu: float, box):
    """Rank-generic control-volume terms: ``box`` is ``2*ndim`` cell
    indices ``(i0, i1, j0, j1[, k0, k1])`` (exclusive upper, faces on cell
    boundaries). Returns ``(surface_force, momentum)``, two length-ndim
    tuples of 0-d tensors with the sign conventions of :func:`cv_terms`. In
    2D it is slice for slice :func:`cv_terms`' discretization; box faces
    on a domain boundary read their outer neighbours one-sided (clamped)."""
    nd = grid.ndim
    if len(box) != 2 * nd:
        raise ValueError(f"box needs {2 * nd} indices for a {nd}D grid")
    lo = tuple(box[2 * a] for a in range(nd))
    hi = tuple(box[2 * a + 1] for a in range(nd))
    h = grid.spacing
    cell_vol = 1.0
    for s in h:
        cell_vol *= s
    cells = [slice(lo[c], hi[c]) for c in range(nd)]

    def at(sl, axis, index):
        """``sl`` with ``index`` along ``axis``."""
        out = list(sl)
        out[axis] = index
        return tuple(out)

    # CV momentum: the face average of each component over the box
    mom = []
    for b in range(nd):
        ub = state.u[b]
        mom.append(torch.sum(0.5 * (
            ub[at(cells, b, slice(lo[b], hi[b]))]
            + ub[at(cells, b, slice(lo[b] + 1, hi[b] + 1))])) * cell_vol)

    sf = [torch.zeros((), dtype=grid.dtype, device=state.p.device)
          for _ in range(nd)]

    def clamp_cell(i: int, a: int) -> int:
        """A cell index along axis ``a`` clamped into the domain."""
        return min(max(i, 0), grid.shape[a] - 1)

    def tangential_on_face(b: int, a: int, i: int):
        """Component b averaged onto the plane of the face normal to axis
        a at index i over the box's cells: the 4 surrounding b faces (2 in
        axis a by 2 in axis b), one-sided at domain boundaries."""
        ub = state.u[b]
        vals = 0.0
        for da in (clamp_cell(i - 1, a), clamp_cell(i, a)):
            for off in (0, 1):
                s = at(cells, a, da)
                s = at(s, b, slice(lo[b] + off, hi[b] + off))
                vals = vals + ub[s]
        return 0.25 * vals

    for a in range(nd):
        da = h[a]
        face_area = cell_vol / da
        ua = state.u[a]
        for i, sgn in ((lo[a], -1.0), (hi[a], +1.0)):
            uf = ua[at(cells, a, i)]          # u_a on the face plane
            if 0 < i < grid.shape[a]:
                dua = (ua[at(cells, a, i + 1)]
                       - ua[at(cells, a, i - 1)]) / (2.0 * da)
            else:
                dua = torch.zeros_like(uf)
            pf = 0.5 * (state.p[at(cells, a, clamp_cell(i - 1, a))]
                        + state.p[at(cells, a, clamp_cell(i, a))])
            # normal momentum: flux + pressure + viscous
            sf[a] = sf[a] + sgn * (torch.sum(uf * uf) + torch.sum(pf)) \
                * face_area - sgn * nu * torch.sum(dua) * face_area
            # tangential components: flux u_b (u_a . n) + viscous du_b/dx_a
            for b in range(nd):
                if b == a:
                    continue
                vb = tangential_on_face(b, a, i)
                ubc = state.u[b]

                def pair_sum(ia):
                    s0 = at(cells, a, clamp_cell(ia, a))
                    return (ubc[at(s0, b, slice(lo[b], hi[b]))]
                            + ubc[at(s0, b, slice(lo[b] + 1, hi[b] + 1))])

                # clamping makes this zero on a domain-boundary face
                dvb = (pair_sum(i) - pair_sum(i - 1)) / (2.0 * da)
                sf[b] = sf[b] + sgn * torch.sum(vb * uf) * face_area \
                    - sgn * nu * torch.sum(dvb) * face_area

    return tuple(-s for s in sf), tuple(mom)


def drag_lift_series(
    grid: GridSpec, nu: float, box, sf_x, sf_y, mom_x, mom_y, dt_sample,
    u_inf: float = 1.0, diameter: float = 1.0, rho: float = 1.0,
):
    """Cd/Cl time series (numpy) from sampled CV terms (arrays over time):
    F = -d(mom)/dt + surface_force, central-differenced."""
    sf_x, sf_y, mom_x, mom_y = (_numpy(x) for x in (sf_x, sf_y, mom_x, mom_y))
    fx = -np.gradient(mom_x, dt_sample) + sf_x
    fy = -np.gradient(mom_y, dt_sample) + sf_y
    scale = 2.0 / (rho * u_inf * u_inf * diameter)
    return fx * scale, fy * scale


def dominant_frequency(series, dt_sample: float) -> float:
    """Dominant oscillation frequency of a (demeaned, Hann-windowed) time
    series by its rFFT peak, with quadratic sub-bin interpolation: the lift
    coefficient series gives the shedding frequency, St =
    dominant_frequency(cl, dt) * D / U."""
    x = _numpy(series).astype(np.float64)
    x = x - x.mean()
    if len(x) < 8 or not np.any(x):
        return 0.0
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    spec[0] = 0.0
    k = int(np.argmax(spec))
    if 1 <= k < len(spec) - 1:
        a, b, c = spec[k - 1], spec[k], spec[k + 1]
        denom = a - 2 * b + c
        if denom != 0.0:
            k = k + 0.5 * (a - c) / denom
    return float(k / (len(x) * dt_sample))


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
