"""Boundary conditions for the staggered grid (PyTorch).

Counterpart of ``navierstokessolver_tpu/bcs.py`` with the same pinned ghost
treatment:

  * WALL, INFLOW and SLIP faces are velocity-Dirichlet for the *normal*
    component: its DOF lives on the boundary face and is set directly
    (:func:`apply_velocity_bcs`; SLIP's value is 0).
  * OUTFLOW is zero-gradient: the boundary-normal DOF copies its interior
    neighbor, and the pressure sees a homogeneous Dirichlet face
    (ops/poisson.py).
  * *Tangential* components see ghost cells (:func:`pad_transverse`):
    ``ghost = 2*u_bc - edge`` across WALL and INFLOW faces, ``ghost =
    edge`` across SLIP and OUTFLOW faces.
  * Interior obstacles are static solid-cell masks: every face touching a
    solid cell carries zero velocity (:func:`face_masks_from_solid`), and
    the corrector only touches faces between two fluid cells
    (:func:`correction_face_masks`).

  * PERIODIC axes (set on both faces, even extent): face n of the
    axis's own component is the same physical face as face 0
    (:func:`apply_velocity_bcs` mirrors face 0 onto it), and tangential
    ghosts wrap around (:func:`pad_transverse`).

A moving lid is a WALL with a nonzero tangential velocity. INFLOW, OUTFLOW,
SLIP and PERIODIC faces are ported in 2D, PERIODIC faces in 3D; CONVECTIVE
faces and the other kinds in 3D are not ported yet and raise (ROADMAP
Queue A, 'Other BC kinds'). Time-dependent values raise (ROADMAP Queue A,
'Physics extensions').

Profiles (2D): a WALL or INFLOW value may be an array (numpy or a tensor)
instead of a number, as in JAX: a normal component is the face slab's
values, given with or without the face's own axis (``(n1,)`` or ``(1,
n1)`` for u on an axis-0 face); a tangential one broadcasts to the edge
slab that :func:`pad_transverse` reflects it through (``(n1 + 1,)`` for v
on an axis-0 face, ``(n0 + 1, 1)`` for u on an axis-1 face). Other shapes
raise ValueError, where JAX's broadcast raises. ``Simulation.build`` moves
a table's profiles to its device once (:func:`bcs_on_device`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .grid import GridSpec


class BCKind(enum.Enum):
    WALL = "wall"
    OUTFLOW = "outflow"
    INFLOW = "inflow"
    SLIP = "slip"
    PERIODIC = "periodic"
    CONVECTIVE = "convective"


# faces where the normal velocity DOF is Dirichlet
_DIRICHLET_KINDS = (BCKind.WALL, BCKind.INFLOW, BCKind.SLIP)
# faces whose tangential ghost reflects through the face value (SLIP and
# OUTFLOW copy the edge instead)
TANGENTIAL_REFLECT_KINDS = (BCKind.WALL, BCKind.INFLOW)
# the kinds the port takes in 2D and in 3D
_PORTED = {2: (BCKind.WALL, BCKind.INFLOW, BCKind.OUTFLOW, BCKind.SLIP,
               BCKind.PERIODIC),
           3: (BCKind.WALL, BCKind.PERIODIC)}


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Boundary condition on one domain face.

    ``velocity`` is the prescribed wall or inlet velocity vector, one value
    per axis, a number or (2D) a profile array (empty means at rest;
    ignored for OUTFLOW).
    """

    kind: BCKind
    velocity: tuple[float, ...] = ()

    @staticmethod
    def wall(velocity: tuple[float, ...] = ()) -> "BCSpec":
        return BCSpec(BCKind.WALL, tuple(velocity))

    @staticmethod
    def inflow(velocity: tuple[float, ...]) -> "BCSpec":
        return BCSpec(BCKind.INFLOW, tuple(velocity))

    @staticmethod
    def outflow() -> "BCSpec":
        return BCSpec(BCKind.OUTFLOW)

    @staticmethod
    def slip() -> "BCSpec":
        return BCSpec(BCKind.SLIP)

    @staticmethod
    def periodic() -> "BCSpec":
        return BCSpec(BCKind.PERIODIC)

    def component(self, comp: int, ndim: int):
        if not self.velocity:
            return 0.0
        if len(self.velocity) != ndim:
            raise ValueError(
                f"BC velocity {self.velocity} has wrong rank for ndim={ndim}"
            )
        return self.velocity[comp]


# A BCTable maps (axis, side) -> BCSpec, side 0 = low face, 1 = high face.
Face = tuple[int, int]
BCTable = Mapping[Face, BCSpec]


def validate_bcs(grid: GridSpec, bcs: BCTable) -> None:
    """Every face present; WALL faces and PERIODIC axes (in 2D also
    INFLOW, OUTFLOW and SLIP faces) with constant values, in 2D also
    profiles of JAX's shapes (see the module docstring); a PERIODIC axis on
    both faces with an even extent, as the JAX package asks."""
    ported = _PORTED[grid.ndim]
    for a in range(grid.ndim):
        for side in (0, 1):
            if (a, side) not in bcs:
                raise ValueError(f"missing BC for face (axis={a}, side={side})")
        lo_p = bcs[(a, 0)].kind is BCKind.PERIODIC
        if lo_p != (bcs[(a, 1)].kind is BCKind.PERIODIC):
            raise ValueError(f"axis {a}: PERIODIC must be set on both faces")
        if lo_p and grid.shape[a] % 2:
            raise ValueError(
                f"axis {a}: periodic extent must be even (red-black "
                "coloring wraps consistently only for even n)"
            )
        for side in (0, 1):
            spec = bcs[(a, side)]
            if spec.kind not in ported:
                raise NotImplementedError(
                    f"BC kind {spec.kind.value!r} on face {(a, side)} of a "
                    f"{grid.ndim}D grid: not ported yet (ROADMAP Queue A, "
                    "'Other BC kinds')"
                )
            for v in spec.velocity:
                if callable(v):
                    raise NotImplementedError(
                        "time-dependent BC values: not ported yet (ROADMAP "
                        "Queue A, 'Physics extensions')"
                    )
                if not _is_number(v) and grid.ndim != 2:
                    raise NotImplementedError(
                        "BC velocity profiles in 3D: not ported yet "
                        "(ROADMAP Queue A, 'Other BC kinds')"
                    )
            spec.component(0, grid.ndim)  # rank check
            for c in range(grid.ndim):
                v = spec.component(c, grid.ndim)
                if _is_number(v):
                    continue
                if c == a and spec.kind in _DIRICHLET_KINDS:
                    _check_shape(np.shape(v), _slab(grid.face_shape(a), a),
                                 (a, side), c, normal=True)
                elif c != a and spec.kind in TANGENTIAL_REFLECT_KINDS:
                    _check_shape(np.shape(v), _slab(grid.face_shape(c), a),
                                 (a, side), c, normal=False)


def _is_number(v) -> bool:
    """A constant BC value (a Python number), not a profile array."""
    return isinstance(v, (int, float))


def _slab(shape, axis: int) -> tuple[int, ...]:
    """``shape`` with extent 1 along ``axis``: one boundary slab."""
    s = list(shape)
    s[axis] = 1
    return tuple(s)


def _check_shape(vshape, slab, face, comp: int, normal: bool) -> None:
    """Raise ValueError unless a profile of shape ``vshape`` broadcasts to
    ``slab`` (a normal component may leave out the face's own axis), the
    shapes JAX's ``_set_face`` and ``pad_transverse`` take."""
    vshape = tuple(vshape)
    if normal and len(vshape) == len(slab) - 1:
        vshape = vshape[:face[0]] + (1,) + vshape[face[0]:]
    try:
        ok = tuple(torch.broadcast_shapes(vshape, slab)) == tuple(slab)
    except RuntimeError:
        ok = False
    if not ok:
        raise ValueError(
            f"BC velocity profile of shape {vshape} for component {comp} on "
            f"face {face}: does not broadcast to the face slab {slab}"
        )


def _profile(v, slab, face, comp: int, normal: bool,
             device) -> torch.Tensor:
    """Profile ``v`` as a float32 tensor on ``device`` shaped to broadcast
    to ``slab`` (no copy when it is one already)."""
    _check_shape(np.shape(v), slab, face, comp, normal)
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if normal and t.ndim == len(slab) - 1:
        t = t.unsqueeze(face[0])
    return t


def tangential_value(grid: GridSpec, bc: BCSpec, face: Face, comp: int,
                     device) -> torch.Tensor:
    """Component ``comp``'s value on ``face`` (a tangential component) as
    a float32 tensor on ``device`` that broadcasts to the edge slab
    :func:`pad_transverse` reflects it through."""
    v = bc.component(comp, grid.ndim)
    if _is_number(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)
    return _profile(v, _slab(grid.face_shape(comp), face[0]), face, comp,
                    False, device)


def bcs_on_device(bcs: BCTable, device) -> dict[Face, BCSpec]:
    """The table with every profile a float32 tensor on ``device``: the
    step then copies nothing from the host."""
    return {
        face: dataclasses.replace(spec, velocity=tuple(
            v if _is_number(v) else torch.as_tensor(
                v, dtype=torch.float32, device=device)
            for v in spec.velocity))
        for face, spec in bcs.items()
    }


def periodic_axes(grid: GridSpec, bcs: BCTable) -> tuple[bool, ...]:
    return tuple(
        bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(grid.ndim)
    )


def has_outflow(grid: GridSpec, bcs: BCTable) -> bool:
    """Any OUTFLOW (or CONVECTIVE) face: the corrected velocity then needs
    the BC pass again, whose zero-gradient copy tracks the new interior."""
    return any(
        bcs[(a, s)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        for a in range(grid.ndim) for s in (0, 1)
    )


def no_slip_box(grid: GridSpec) -> dict[Face, BCSpec]:
    """All-walls, zero-velocity BC table (the cavity starting point)."""
    zeros = (0.0,) * grid.ndim
    return {
        (a, s): BCSpec.wall(zeros) for a in range(grid.ndim) for s in (0, 1)
    }


def apply_velocity_bcs(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[torch.Tensor],
    face_masks: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, ...]:
    """Impose the boundary values on each component's boundary faces along
    its own axis (the Dirichlet value of WALL, INFLOW and SLIP faces, the
    inner face's copy on OUTFLOW faces, face 0's copy on face n of a
    PERIODIC axis), then zero the faces the obstacle blocks
    (``face_masks[a]``: 1 open, 0 blocked). Returns new tensors; the
    inputs are not modified."""
    out = []
    for a, comp in enumerate(u):
        comp = comp.clone()
        n = comp.shape[a]
        if bcs[(a, 0)].kind is BCKind.PERIODIC:
            comp.select(a, n - 1).copy_(comp.select(a, 0))
            out.append(comp if face_masks is None else comp * face_masks[a])
            continue
        for side, index, inner in ((0, 0, 1), (1, n - 1, n - 2)):
            bc = bcs[(a, side)]
            if bc.kind in _DIRICHLET_KINDS:
                val = bc.component(a, grid.ndim)
                face = comp.narrow(a, index, 1)
                if _is_number(val):
                    face.fill_(val)
                else:
                    face.copy_(_profile(val, face.shape, (a, side), a,
                                        True, comp.device).expand(face.shape))
            elif bc.kind is BCKind.OUTFLOW:
                comp.select(a, index).copy_(comp.select(a, inner))
            else:
                raise NotImplementedError(
                    f"BC kind {bc.kind.value!r}: not ported yet (ROADMAP "
                    "Queue A, 'Other BC kinds')"
                )
        if face_masks is not None:
            comp = comp * face_masks[a]
        out.append(comp)
    return tuple(out)


def pad_transverse(
    grid: GridSpec, bcs: BCTable, comp: int, arr: torch.Tensor
) -> torch.Tensor:
    """Ghost-pad velocity component ``comp`` by one cell along every axis
    except its own staggering axis: ``ghost = 2*u_bc - edge`` across WALL
    and INFLOW faces, ``ghost = edge`` across SLIP and OUTFLOW faces, the
    opposite edge across a PERIODIC axis."""
    for t in range(grid.ndim):
        if t == comp:
            continue
        n = arr.shape[t]
        if bcs[(t, 0)].kind is BCKind.PERIODIC:
            arr = torch.cat([arr.narrow(t, n - 1, 1), arr, arr.narrow(t, 0, 1)],
                            dim=t)
            continue
        ghosts = []
        for side, edge in ((0, arr.narrow(t, 0, 1)),
                           (1, arr.narrow(t, n - 1, 1))):
            bc = bcs[(t, side)]
            if bc.kind in TANGENTIAL_REFLECT_KINDS:
                val = bc.component(comp, grid.ndim)
                if not _is_number(val):
                    val = _profile(val, edge.shape, (t, side), comp, False,
                                   arr.device)
                ghosts.append((2.0 * val - edge).expand(edge.shape))
            else:
                ghosts.append(edge)
        arr = torch.cat([ghosts[0], arr, ghosts[1]], dim=t)
    return arr


# -- obstacle masks (numpy, copied from the JAX package) ----------------------


def face_masks_from_solid(
    grid: GridSpec, solid: Optional[np.ndarray], device,
    periodic: Sequence[bool] = (),
) -> Optional[tuple[torch.Tensor, ...]]:
    """Per-component face masks (1 = open, 0 = blocked) from a solid-cell
    mask, on ``device``. A face is blocked if any adjacent cell is solid;
    a boundary face follows its one adjacent cell, and along a
    ``periodic`` axis it wraps (its cells are n-1 and 0)."""
    if solid is None:
        return None
    per = tuple(periodic) or (False,) * grid.ndim
    fluid = np.logical_not(np.asarray(solid, bool))
    if fluid.shape != grid.shape:
        raise ValueError(f"solid mask shape {fluid.shape} != grid {grid.shape}")
    nd = grid.ndim
    masks = []
    for a in range(nd):
        m = np.ones(grid.face_shape(a), dtype=bool)
        lo, hi, mid = ([slice(None)] * nd for _ in range(3))
        lo[a], hi[a], mid[a] = slice(0, -1), slice(1, None), slice(1, -1)
        m[tuple(mid)] = fluid[tuple(lo)] & fluid[tuple(hi)]
        first, last = [slice(None)] * nd, [slice(None)] * nd
        first[a], last[a] = 0, -1
        if per[a]:
            m[tuple(first)] = m[tuple(last)] = (fluid[tuple(first)]
                                                & fluid[tuple(last)])
        else:
            m[tuple(first)] = fluid[tuple(first)]
            m[tuple(last)] = fluid[tuple(last)]
        masks.append(torch.as_tensor(m, dtype=grid.dtype).to(device))
    return tuple(masks)


def correction_face_masks(
    grid: GridSpec, solid: Optional[np.ndarray], device,
    periodic: Sequence[bool] = (),
) -> Optional[tuple[torch.Tensor, ...]]:
    """Masks of the pressure-gradient correction on *interior* faces, on
    ``device``: only faces between two fluid cells are corrected (solid
    cells hold a dummy p = 0 that must not leak into the velocity).
    Component ``a``'s mask has the shape ``grid.shape - e_a`` on a bounded
    axis and ``grid.shape`` (all n wrap faces, face 0 between cells n-1
    and 0) on a ``periodic`` one, as JAX's."""
    if solid is None:
        return None
    per = tuple(periodic) or (False,) * grid.ndim
    fluid = np.logical_not(np.asarray(solid, bool))
    nd = grid.ndim
    masks = []
    for a in range(nd):
        if per[a]:
            m = np.roll(fluid, 1, axis=a) & fluid
        else:
            lo, hi = [slice(None)] * nd, [slice(None)] * nd
            lo[a], hi[a] = slice(0, -1), slice(1, None)
            m = fluid[tuple(lo)] & fluid[tuple(hi)]
        masks.append(torch.as_tensor(m, dtype=grid.dtype).to(device))
    return tuple(masks)
