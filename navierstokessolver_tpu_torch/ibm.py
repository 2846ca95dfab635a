"""Sharp-interface immersed boundary: direct forcing with SDF interpolation
(PyTorch).

Counterpart of ``navierstokessolver_tpu/ibm.py``. The staircase obstacle
treatment (bcs.face_masks_from_solid) represents a curved body as blocked
faces. Direct forcing upgrades the velocity boundary: at the first fluid
faces outside the body the velocity is replaced by a linear interpolation
along the local surface normal between the boundary value and the next
fluid sample,

    u_f = (phi_f / phi_nbr) * u_nbr        (stationary body, u_b = 0),

with ``phi`` the signed distance to the surface (negative inside). The
pressure treatment (the masked Poisson operator and correction masks of
the staircase cell mask) is unchanged.

Everything data-dependent happens at build time in numpy (normal
directions, neighbour choice, interpolation weights), copied from the JAX
``build_ibm`` so the masks and weights are bit-equal to its. The per-step
apply is a handful of masked multiply-adds and unit rolls over each
component's bounding box of the forcing band (a one-face margin, no
alignment: the JAX package rounds its boxes to the TPU's 8 x 128 tiles,
which changes nothing in the result).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .grid import GridSpec

Box = tuple[tuple[int, ...], tuple[int, ...]]   # (lo, size) per axis


def _crop(x: torch.Tensor, box: Box) -> torch.Tensor:
    """The view of ``x`` over ``box``."""
    for ax, (lo, size) in enumerate(zip(*box)):
        x = x.narrow(ax, lo, size)
    return x


@dataclasses.dataclass(eq=False)
class IBMForcing:
    """Per-component direct-forcing operator, every array cropped to the
    component's ``box``.

    For component ``a`` and direction ``d`` (the 2*ndim axis neighbours
    ``dirs[d] = (axis, sign)``), ``masks[a][d]`` is a one-hot float mask of
    the forcing faces whose interpolation neighbour lies one face over along
    ``dirs[d]`` (the masks are disjoint); ``w[a]`` the weight phi_f/phi_nbr
    (in [0, 1]); ``band[a]`` their union. Moving bodies add ``ub`` (the
    surface velocity at each band face's foot point), ``wet`` (blocked
    faces with an open neighbour) and ``ub_wet`` (the body velocity
    there); None for stationary bodies."""

    ndim: int
    dirs: tuple[tuple[int, int], ...]
    box: tuple[Box, ...]
    masks: tuple[tuple[torch.Tensor, ...], ...]
    w: tuple[torch.Tensor, ...]
    band: tuple[torch.Tensor, ...]
    ub: Optional[tuple[torch.Tensor, ...]] = None
    wet: Optional[tuple[torch.Tensor, ...]] = None
    ub_wet: Optional[tuple[torch.Tensor, ...]] = None

    @staticmethod
    def from_numpy(grid: GridSpec, dirs, masks, w, band, device, ub=None,
                   wet=None, ub_wet=None) -> "IBMForcing":
        """From full-field numpy arrays (:func:`build_ibm`'s, or a JAX
        ``IBMForcing``'s): crop each component to the bounding box of its
        band (and wet) support with a one-face margin for the unit rolls,
        float32 on ``device``."""
        nd = grid.ndim
        boxes = []
        for a in range(nd):
            supp = np.asarray(band[a]) > 0
            if wet is not None:
                supp = supp | (np.asarray(wet[a]) > 0)
            shape = supp.shape
            if not supp.any():
                boxes.append(((0,) * nd, (1,) * nd))
                continue
            nzs = np.nonzero(supp)
            lo = tuple(max(int(nzs[ax].min()) - 1, 0) for ax in range(nd))
            hi = tuple(min(int(nzs[ax].max()) + 2, shape[ax])
                       for ax in range(nd))
            boxes.append((lo, tuple(h - l for l, h in zip(lo, hi))))

        def dev(a, x):
            sl = tuple(slice(l, l + s) for l, s in zip(*boxes[a]))
            return torch.as_tensor(
                np.ascontiguousarray(np.asarray(x, np.float32)[sl])
            ).to(device)

        def opt(t):
            return (None if t is None
                    else tuple(dev(a, x) for a, x in enumerate(t)))

        return IBMForcing(
            ndim=nd,
            dirs=tuple(tuple(d) for d in dirs),
            box=tuple(boxes),
            masks=tuple(tuple(dev(a, m) for m in masks[a])
                        for a in range(nd)),
            w=tuple(dev(a, x) for a, x in enumerate(w)),
            band=tuple(dev(a, x) for a, x in enumerate(band)),
            ub=opt(ub), wet=opt(wet), ub_wet=opt(ub_wet),
        )

    def apply(self, u: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """Impose the interpolated boundary values on the forcing band, in
        one pass over the pre-forcing values (band faces never interpolate
        from each other: the build picks neighbours outside the band).
        Returns new tensors."""
        out = []
        for a, comp in enumerate(u):
            crop = _crop(comp, self.box[a])
            acc = None
            for (axis, sign), m in zip(self.dirs, self.masks[a]):
                # the neighbour at face + sign*e_axis; a roll that wraps
                # meets a zero mask (the box margin, the build's checks)
                term = m * torch.roll(crop, -sign, dims=axis)
                acc = term if acc is None else acc + term
            forced = self.w[a] * acc
            if self.ub is not None:
                forced = forced + (1.0 - self.w[a]) * self.ub[a]
            res = torch.where(self.band[a] > 0, forced, crop)
            if self.wet is not None:
                res = torch.where(self.wet[a] > 0, self.ub_wet[a], res)
            full = comp.clone()
            _crop(full, self.box[a]).copy_(res)
            out.append(full)
        return tuple(out)

    def apply_wet(self, u: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """Re-impose only the wet-solid body velocities (moving bodies),
        after a BC pass whose face masks zeroed them."""
        if self.wet is None:
            return tuple(u)
        out = []
        for a, comp in enumerate(u):
            full = comp.clone()
            crop = _crop(full, self.box[a])
            crop.copy_(torch.where(self.wet[a] > 0, self.ub_wet[a], crop))
            out.append(full)
        return tuple(out)


def _face_points(grid: GridSpec, a: int) -> tuple[np.ndarray, ...]:
    """Broadcastable numpy float64 coordinates of component ``a``'s faces."""
    nd = grid.ndim
    coords = []
    for k in range(nd):
        h = grid.spacing[k]
        n = grid.shape[k]
        if k == a:
            c = np.arange(n + 1, dtype=np.float64) * h
        else:
            c = (np.arange(n, dtype=np.float64) + 0.5) * h
        shape = [1] * nd
        shape[k] = -1
        coords.append(c.reshape(shape))
    return tuple(coords)


def cell_center_points(grid: GridSpec) -> tuple[np.ndarray, ...]:
    """Broadcastable numpy float64 coordinates of the cell centers."""
    nd = grid.ndim
    coords = []
    for k in range(nd):
        h = grid.spacing[k]
        c = (np.arange(grid.shape[k], dtype=np.float64) + 0.5) * h
        shape = [1] * nd
        shape[k] = -1
        coords.append(c.reshape(shape))
    return tuple(coords)


def solid_from_sdf(grid: GridSpec, sdf: Callable) -> np.ndarray:
    """Cell-centered solid mask (phi < 0) for the Poisson/staircase layer."""
    phi = np.asarray(sdf(*cell_center_points(grid)), np.float64)
    phi = np.broadcast_to(phi, grid.shape)
    return phi < 0.0


def build_ibm(
    grid: GridSpec,
    sdf: Callable,
    face_masks: Sequence[torch.Tensor],
    device,
    velocity: Optional[Callable] = None,
) -> Optional[IBMForcing]:
    """The direct-forcing operator from a signed distance field (the JAX
    ``build_ibm``, copied as it is).

    ``sdf(*coords)`` takes broadcastable per-axis coordinates and returns
    the signed distance. ``face_masks``: the staircase open-face masks of
    the Simulation. The forcing band is the set of open faces with a
    blocked axis neighbour; the interpolation neighbour lies along the
    dominant component of the surface normal grad(phi), falling back
    through the other directions ranked by |n_k| until one is open,
    farther from the surface and outside the band. ``velocity(*coords)``
    (moving bodies): the body's surface velocity, evaluated at each band
    face's foot point ``x - phi grad(phi)/|grad(phi)|``. Returns None when
    the band is empty."""
    nd = grid.ndim
    h = grid.spacing
    dirs = tuple((k, s) for k in range(nd) for s in (-1, 1))

    masks_all, w_all, band_all = [], [], []
    ub_all, wet_all, ubwet_all = [], [], []
    any_band = False
    for a in range(nd):
        open_f = face_masks[a].detach().cpu().numpy().astype(np.float64) > 0.5
        blocked = ~open_f
        phi = np.asarray(sdf(*_face_points(grid, a)), np.float64)
        phi = np.broadcast_to(phi, open_f.shape).copy()

        # first fluid ring: open faces with a blocked axis neighbour
        band = np.zeros_like(open_f)
        for k in range(nd):
            for s in (-1, 1):
                nb = np.roll(blocked, -s, axis=k)
                # a roll that wraps reads the far wall; kill wrapped lanes
                edge = [slice(None)] * nd
                edge[k] = -1 if s == 1 else 0
                nb[tuple(edge)] = False
                band |= nb
        band &= open_f
        zeros = np.zeros(open_f.shape, np.float64)
        if not band.any():
            masks_all.append(tuple(zeros for _ in dirs))
            w_all.append(zeros)
            band_all.append(zeros)
            ub_all.append(zeros)
            wet_all.append(zeros)
            ubwet_all.append(zeros)
            continue
        any_band = True

        # surface normal from phi differences on the face lattice
        grad = np.stack(
            [np.gradient(phi, h[k], axis=k) for k in range(nd)], axis=0
        )
        order = np.argsort(-np.abs(grad), axis=0)  # axes ranked by |n_k|

        masks = [np.zeros(open_f.shape, np.float64) for _ in dirs]
        w = np.zeros(open_f.shape, np.float64)
        assigned = np.zeros_like(band)
        eps = 1e-12
        for rank in range(nd):
            axis_pick = order[rank]
            for k in range(nd):
                for s in (-1, 1):
                    d = dirs.index((k, s))
                    nb_phi = np.roll(phi, -s, axis=k)
                    nb_open = np.roll(open_f & ~band, -s, axis=k)
                    edge = [slice(None)] * nd
                    edge[k] = -1 if s == 1 else 0
                    nb_open[tuple(edge)] = False
                    want = (
                        band & ~assigned
                        & (axis_pick == k)
                        & ((grad[k] > 0) == (s > 0))
                        & nb_open
                        & (nb_phi > phi + eps)
                        & (nb_phi > eps)
                    )
                    if not want.any():
                        continue
                    masks[d][want] = 1.0
                    w[want] = np.clip(phi[want] / nb_phi[want], 0.0, 1.0)
                    assigned |= want
        # faces the fallback never resolved stay unforced (plain open)
        band &= assigned
        masks_all.append(tuple(masks))
        w_all.append(w)
        band_all.append(band.astype(np.float64))

        if velocity is not None:
            # surface foot points x - phi * n_hat; the body velocity there
            gmag = np.sqrt((grad ** 2).sum(axis=0))
            gmag = np.where(gmag > eps, gmag, 1.0)
            pts = np.broadcast_arrays(*_face_points(grid, a))
            feet = tuple(
                pts[k] - phi * grad[k] / gmag for k in range(nd)
            )
            vb = np.broadcast_to(
                np.asarray(velocity(*feet)[a], np.float64), open_f.shape
            )
            ub_all.append(np.where(band, vb, 0.0))
            # wet solid faces: blocked with an open axis neighbour
            wet = np.zeros_like(open_f)
            for k in range(nd):
                for s in (-1, 1):
                    nb = np.roll(open_f, -s, axis=k)
                    edge = [slice(None)] * nd
                    edge[k] = -1 if s == 1 else 0
                    nb[tuple(edge)] = False
                    wet |= nb
            wet &= blocked
            wet_all.append(wet.astype(np.float64))
            ubwet_all.append(np.where(wet, vb, 0.0))

    if not any_band:
        return None
    moving = velocity is not None
    return IBMForcing.from_numpy(
        grid, dirs, masks_all, w_all, band_all, device,
        ub=ub_all if moving else None,
        wet=wet_all if moving else None,
        ub_wet=ubwet_all if moving else None,
    )
