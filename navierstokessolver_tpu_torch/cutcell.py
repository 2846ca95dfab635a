"""Cut-cell (apertured) sharp-interface pressure treatment (PyTorch).

Counterpart of ``navierstokessolver_tpu/cutcell.py``. Each cell face
carries an aperture alpha in [0, 1], its fluid-open fraction from the
obstacle's signed distance field, and

  * the Poisson operator becomes ``(A p)_i = sum_f alpha_f (p_nb - p_i)/h^2``
    (ops/poisson.build_poisson_op_cut, ``PoissonOp.ap``);
  * the divergence and the Poisson RHS become the apertured flux sum
    ``sum_a (alpha_hi u_hi - alpha_lo u_lo)/h_a``
    (ops/stencils.divergence_ap);
  * the velocity correction applies the plain face gradient on every face
    with alpha > 0 (the correction masks).

Together they keep the projection exact: div_ap(u_new) = div_ap(u*) -
(dt/rho) A p = 0 to the solver's tolerance. Solid cells (volume fraction
0, or no open face) keep identity rows.

The geometry is numpy, built once (a copy of the JAX package's, so both
packages hold bit-equal apertures, volume fractions and solid masks): a
clipped linear reconstruction of the SDF on a subcell lattice, evaluated
on the surface shell only (a dense pass over the face and cell centres
bounds which faces and cells the interface can cut).

The fused 3D step composes with it as the JAX fused step does
(:func:`fused_cut_consts`, :func:`fused_rhs_patch_cut`,
:func:`fused_div_max_cut`): kernels 1-2 run the masked step on the cut
operator's stencil code, whose open and correction bits equal the cut
masks (binary == apertured outside the cut band, the faces with alpha
strictly between 0 and 1); the step replaces the Poisson RHS on the band's
bounding box by the apertured divergence, and folds the box's apertured
max|div u| into the diagnostics, while the corrector leaves the band's
cells out of its own maximum (bit 7 of its code, ops/fused3d.py). These
are slices of plain tensor algebra over the box.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .grid import GridSpec
from .ops import stencils

# faces with aperture below this are treated as closed (kills the
# small-cell stiffness of nearly-grazing cuts; the velocity there is
# zeroed by the face mask, so no flux is lost from the discrete system)
ALPHA_MIN = 0.01


def _seg_frac(v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    """Length fraction of {phi > 0} on a segment with endpoint SDF values
    ``v0``/``v1``, from the linear reconstruction: ((v1)+ - (v0)+)/(v1-v0)
    (sign-symmetric; exact for any affine phi). Degenerate v0 == v1 falls
    back to the indicator."""
    b = v1 - v0
    pos0 = np.maximum(v0, 0.0)
    pos1 = np.maximum(v1, 0.0)
    safe = np.abs(b) > 1e-300
    f = np.where(safe, (pos1 - pos0) / np.where(safe, b, 1.0),
                 (v0 > 0.0).astype(np.float64))
    return np.clip(f, 0.0, 1.0)


def _rect_frac(v00, v10, v01, v11) -> np.ndarray:
    """Area fraction of {phi > 0} on a rectangle with corner SDF values
    ``vXY`` (X along the first transverse axis, Y along the second), from
    the AFFINE least-squares reconstruction of the four corners:

        area = ((w11)+^2 + (w00)+^2 - (w10)+^2 - (w01)+^2) / (2 b c)

    (w = affine-fit corner values, b/c the fit's edge slopes; the identity
    is the closed form of integrating the 1D clipped-segment rule, and is
    invariant under either axis flip so any nonzero b, c works). Exact for
    planar interfaces -- affine data has zero twist, so w == v and the
    formula integrates the half-plane clip exactly. Near-degenerate slopes
    (cut parallel to an axis) fall back to the 1D segment rule, which is
    exact there."""
    b = 0.5 * ((v10 - v00) + (v11 - v01))   # mean slope, first axis
    c = 0.5 * ((v01 - v00) + (v11 - v10))   # mean slope, second axis
    m = 0.25 * (v00 + v10 + v01 + v11)
    w00 = m - 0.5 * (b + c)
    w10 = m + 0.5 * (b - c)
    w01 = m - 0.5 * (b - c)
    w11 = m + 0.5 * (b + c)
    pos = lambda x: np.maximum(x, 0.0)  # noqa: E731
    num = pos(w11) ** 2 + pos(w00) ** 2 - pos(w10) ** 2 - pos(w01) ** 2
    scale = np.abs(b) + np.abs(c) + np.abs(m) + 1e-300
    bc_ok = (np.abs(b) > 1e-9 * scale) & (np.abs(c) > 1e-9 * scale)
    den = 2.0 * b * c
    area = np.where(bc_ok, num / np.where(bc_ok, den, 1.0), 0.0)
    # b ~ 0: phi constant along the first axis -> 1D cut along the second
    # (and vice versa); both ~ 0: indicator of the (constant) value
    area = np.where(bc_ok, area,
                    np.where(np.abs(b) <= np.abs(c),
                             _seg_frac(w00, w01), _seg_frac(w00, w10)))
    return np.clip(area, 0.0, 1.0)


def face_apertures(
    grid: GridSpec, sdf: Callable, k: int = 4
) -> tuple[np.ndarray, ...]:
    """Per-axis FULL face-aperture arrays (shape = grid.face_shape(a)):
    the fluid fraction (sdf > 0) of each face, from the SDF's LINEAR
    reconstruction on a k-per-axis subcell lattice (corner samples;
    :func:`_seg_frac` on 2D grids' face segments, :func:`_rect_frac` on
    3D grids' face rectangles). EXACT for planar interfaces at any angle
    (every subcell sees affine data); for smooth curved boundaries each
    cut subcell carries the linear-interpolant error O((h/k)^2), so the
    per-face worst case is O(1/k^2).

    SPARSE evaluation: one dense SDF pass over the face CENTERS
    classifies faces via the signed-distance bound -- ``sdf`` is a true
    distance near the interface (every ``cases/`` body is; 1-Lipschitz),
    so |phi(center)| exceeding 1.5x the face half-diagonal PROVES the
    face uniformly in/out -- and the subcell reconstruction runs only on
    the O(surface) shell of candidates. At 256x128x128 this turned a
    ~7-minute dense-lattice build into seconds."""
    nd = grid.ndim
    h = grid.spacing
    out = []
    for a in range(nd):
        tr = [d for d in range(nd) if d != a]
        # dense face-center values: classification AND the IBM-consistency
        # closing below share this one evaluation
        centers = []
        for d in range(nd):
            if d == a:
                c = np.arange(grid.shape[d] + 1, dtype=np.float64) * h[d]
            else:
                c = (np.arange(grid.shape[d], dtype=np.float64) + 0.5) * h[d]
            shp = [1] * nd
            shp[d] = -1
            centers.append(c.reshape(shp))
        phi_c = np.broadcast_to(
            np.asarray(sdf(*centers), np.float64), grid.face_shape(a)
        )
        alpha = (phi_c > 0.0).astype(np.float64)
        halfdiag = 0.5 * float(np.sqrt(sum(h[t] ** 2 for t in tr)))
        idx = np.argwhere(np.abs(phi_c) <= 1.5 * halfdiag)
        if idx.size:
            # per-candidate subcell corner lattices, sdf broadcast over
            # (N, k+1[, k+1]) -- dimension order preserved
            args = []
            lat_shape = [len(idx)] + [k + 1] * (nd - 1)
            for d in range(nd):
                if d == a:
                    col = idx[:, d].astype(np.float64) * h[d]
                    col = col.reshape([-1] + [1] * (nd - 1))
                else:
                    off = np.arange(k + 1, dtype=np.float64) * (h[d] / k)
                    shp = [1] * len(lat_shape)
                    shp[1 + tr.index(d)] = -1
                    col = (idx[:, d].astype(np.float64) * h[d]
                           ).reshape([-1] + [1] * (nd - 1)) \
                        + off.reshape(shp)
                args.append(col)
            phi = np.broadcast_to(
                np.asarray(sdf(*args), np.float64), lat_shape
            )
            if nd == 2:
                fr = _seg_frac(phi[:, :-1], phi[:, 1:]).mean(axis=1)
            else:
                fr = _rect_frac(
                    phi[:, :-1, :-1], phi[:, 1:, :-1],
                    phi[:, :-1, 1:], phi[:, 1:, 1:],
                ).mean(axis=(1, 2))
            alpha[tuple(idx.T)] = fr
        # consistency with the IBM velocity treatment: a face whose
        # CENTER is inside the body has its velocity DOF forced toward
        # the body value (ibm.py clamps w = phi_f/phi_nbr to 0 there), so
        # keeping a partial aperture open on it would count a systematic
        # flux deficit into the continuity equation -- close it. The open
        # set then matches where the velocity DOF is meaningful (alpha of
        # surviving cut faces is in ~(0.5, 1]).
        alpha = np.where(phi_c > 0.0, alpha, 0.0)
        alpha[alpha < ALPHA_MIN] = 0.0
        out.append(alpha)
    return tuple(out)


def volume_fractions(
    grid: GridSpec, sdf: Callable, k: int = 4
) -> np.ndarray:
    """Cell fluid-volume fractions by k^nd midpoint subsampling -- SPARSE
    like :func:`face_apertures`: a dense cell-center SDF pass classifies
    cells via the signed-distance bound (|phi(center)| > 1.5x the cell
    half-diagonal proves the cell uniformly in/out), midpoint subsampling
    runs only on the O(surface) candidate shell."""
    nd = grid.ndim
    h = grid.spacing
    centers = []
    for d in range(nd):
        c = (np.arange(grid.shape[d], dtype=np.float64) + 0.5) * h[d]
        shp = [1] * nd
        shp[d] = -1
        centers.append(c.reshape(shp))
    phi_c = np.broadcast_to(
        np.asarray(sdf(*centers), np.float64), grid.shape
    )
    frac = (phi_c > 0.0).astype(np.float64)
    halfdiag = 0.5 * float(np.sqrt(sum(hh ** 2 for hh in h)))
    idx = np.argwhere(np.abs(phi_c) <= 1.5 * halfdiag)
    if idx.size:
        lat_shape = [len(idx)] + [k] * nd
        args = []
        for d in range(nd):
            sub = (np.arange(k, dtype=np.float64) + 0.5) * (h[d] / k)
            shp = [1] * (nd + 1)
            shp[1 + d] = -1
            args.append(
                (idx[:, d].astype(np.float64) * h[d]).reshape(
                    [-1] + [1] * nd
                ) + sub.reshape(shp)
            )
        phi = np.broadcast_to(np.asarray(sdf(*args), np.float64), lat_shape)
        frac[tuple(idx.T)] = (phi > 0.0).reshape(len(idx), -1).mean(axis=1)
    return frac


def cut_geometry(grid: GridSpec, sdf: Callable, k: int = 8):
    """(apertures, fluid, solid): the consistent cut-cell classification.

    A cell is FLUID iff it has positive volume fraction AND at least one
    open face (isolated slivers become solid); apertures of faces touching
    a solid cell are closed so the operator/divergence/masks all agree.
    """
    nd = grid.ndim

    def inner_sl(a):
        s = [slice(None)] * nd
        s[a] = slice(1, -1)
        return tuple(s)

    def lo_sl(a):   # cell's low face / low-side neighbor cell
        s = [slice(None)] * nd
        s[a] = slice(0, -1)
        return tuple(s)

    def hi_sl(a):
        s = [slice(None)] * nd
        s[a] = slice(1, None)
        return tuple(s)

    ap = [a.copy() for a in face_apertures(grid, sdf, k)]
    vol = volume_fractions(grid, sdf, max(4, k // 2))
    fluid = vol > 0.0
    # fixed point: close faces touching a solid cell; a fluid cell with no
    # remaining open face becomes solid (isolated sliver) -> repeat
    while True:
        for a in range(nd):
            both = fluid[lo_sl(a)] & fluid[hi_sl(a)]
            ap[a][inner_sl(a)] *= both.astype(np.float64)
            first = [slice(None)] * nd
            first[a] = 0
            last = [slice(None)] * nd
            last[a] = -1
            cf = [slice(None)] * nd
            cf[a] = 0
            cl = [slice(None)] * nd
            cl[a] = -1
            ap[a][tuple(first)] *= fluid[tuple(cf)].astype(np.float64)
            ap[a][tuple(last)] *= fluid[tuple(cl)].astype(np.float64)
        open_any = np.zeros(grid.shape, bool)
        for a in range(nd):
            open_any |= (ap[a][lo_sl(a)] > 0) | (ap[a][hi_sl(a)] > 0)
        new_fluid = fluid & open_any
        if (new_fluid == fluid).all():
            break
        fluid = new_fluid
    return tuple(ap), fluid, ~fluid


# -- the fused 3D step's composition -------------------------------------------


def fused_cut_consts(grid: GridSpec, ap, wet=None, margin: int = 1):
    """The fused composition's static constants: ``(box, alb, band)``, the
    cut band's cell bounding box ``((lo...), (size...))``, the per-axis
    apertures of the faces of the box's cells (numpy float64; axis a's has
    ``size[a] + 1`` faces along a) and the band's cells (bool). None when
    no face is cut, or when a band cell lies within ``margin`` of a domain
    face (the fused route then refuses the table).

    ``wet``: a moving body's wet-face masks (per component, full face
    arrays). Wet faces carry the body velocity and are open in the
    corrector's code while their aperture is 0, so cells touching one join
    the band (left out of the kernel's maximum, recomputed apertured in
    the box) even when none of their faces is partially open."""
    nd = grid.ndim
    ap_np = [np.asarray(a, np.float64) for a in ap]
    cutf = [(a > 0.0) & (a < 1.0) for a in ap_np]
    if wet is not None:
        for a in range(nd):
            if wet[a] is not None:
                cutf[a] |= np.asarray(wet[a]) > 0
    band = np.zeros(grid.shape, bool)
    for a in range(nd):
        lo = [slice(None)] * nd
        lo[a] = slice(0, -1)
        hi = [slice(None)] * nd
        hi[a] = slice(1, None)
        band |= cutf[a][tuple(lo)] | cutf[a][tuple(hi)]
    if not band.any():
        return None
    idx = np.argwhere(band)
    lo = idx.min(axis=0)
    hi = idx.max(axis=0) + 1
    if (lo < margin).any() or (hi > np.asarray(grid.shape) - margin).any():
        return None
    box = (tuple(int(x) for x in lo), tuple(int(x) for x in hi - lo))
    alb = []
    for a in range(nd):
        sl = tuple(
            slice(int(lo[d]), int(hi[d]) + (1 if d == a else 0))
            for d in range(nd)
        )
        alb.append(ap_np[a][sl])
    return box, tuple(alb), band


def _boxed_div_ap(grid: GridSpec, u: Sequence[torch.Tensor],
                  alb: Sequence[torch.Tensor], box) -> torch.Tensor:
    """The apertured divergence over the box's cells, from the faces of
    those cells (views of ``u``) and their apertures ``alb``."""
    lo, size = box
    faces = []
    for a, comp in enumerate(u):
        for d in range(grid.ndim):
            comp = comp.narrow(d, lo[d], size[d] + (1 if d == a else 0))
        faces.append(comp)
    return stencils.divergence_ap(grid, faces, alb)


def fused_rhs_patch_cut(grid: GridSpec, rhs: torch.Tensor,
                        u_star: Sequence[torch.Tensor],
                        alb: Sequence[torch.Tensor], box,
                        rho_over_dt) -> torch.Tensor:
    """The Poisson RHS with its band box replaced by the apertured
    divergence ``(rho/dt) sum_a (alpha_hi u_hi - alpha_lo u_lo)/h_a`` of
    the post-IBM ``u_star`` (non-band fluid cells recompute to the binary
    value, solid cells to zero: their apertures are closed). Returns a new
    tensor; ``rho_over_dt`` a number or a 0-d tensor."""
    out = rhs.clone()
    view = out
    for d, (l, s) in enumerate(zip(*box)):
        view = view.narrow(d, l, s)
    view.copy_(rho_over_dt * _boxed_div_ap(grid, u_star, alb, box))
    return out


def fused_div_max_cut(grid: GridSpec, u_new: Sequence[torch.Tensor],
                      alb: Sequence[torch.Tensor], box) -> torch.Tensor:
    """max |apertured div u| over the band box of the corrected field (a
    0-d tensor), folded into the corrector's maximum, which left the band's
    cells out. Solid cells give zero (their apertures are closed)."""
    return torch.max(torch.abs(_boxed_div_ap(grid, u_new, alb, box)))
