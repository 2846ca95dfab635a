"""Boundary conditions for the staggered grid (PyTorch), WALL subset.

Counterpart of ``navierstokessolver_tpu/bcs.py`` with the same pinned ghost
treatment:

  * WALL faces are velocity-Dirichlet. The *normal* velocity DOF lives on
    the boundary face and is set directly (:func:`apply_velocity_bcs`).
  * The *tangential* components see linear-reflection ghost cells
    ``ghost = 2*u_wall - edge`` (:func:`pad_transverse`).

A moving lid is a WALL with a nonzero tangential velocity. The other kinds
(inflow, outflow, slip, periodic, convective) keep their enum names here so
BC tables read the same as in the JAX package, but the port rejects them
until they are ported (ROADMAP Queue A, "Other BC kinds").
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import torch

from .grid import GridSpec


class BCKind(enum.Enum):
    WALL = "wall"
    OUTFLOW = "outflow"
    INFLOW = "inflow"
    SLIP = "slip"
    PERIODIC = "periodic"
    CONVECTIVE = "convective"


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Boundary condition on one domain face.

    ``velocity`` is the prescribed wall velocity vector, one float per axis
    (empty means at rest).
    """

    kind: BCKind
    velocity: tuple[float, ...] = ()

    @staticmethod
    def wall(velocity: tuple[float, ...] = ()) -> "BCSpec":
        return BCSpec(BCKind.WALL, tuple(velocity))

    def component(self, comp: int, ndim: int) -> float:
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
    """Every face present; only WALL faces with constant scalar values."""
    for a in range(grid.ndim):
        for side in (0, 1):
            if (a, side) not in bcs:
                raise ValueError(f"missing BC for face (axis={a}, side={side})")
            spec = bcs[(a, side)]
            if spec.kind is not BCKind.WALL:
                raise NotImplementedError(
                    f"BC kind {spec.kind.value!r} on face {(a, side)}: not "
                    "ported yet (ROADMAP Queue A, 'Other BC kinds')"
                )
            for v in spec.velocity:
                if callable(v):
                    raise NotImplementedError(
                        "time-dependent BC values: not ported yet (ROADMAP "
                        "Queue A, 'Physics extensions')"
                    )
                if not isinstance(v, (int, float)):
                    raise NotImplementedError(
                        "BC velocity profiles: not ported yet (ROADMAP "
                        "Queue A, 'Other BC kinds')"
                    )
            spec.component(0, grid.ndim)  # rank check


def periodic_axes(grid: GridSpec, bcs: BCTable) -> tuple[bool, ...]:
    return tuple(
        bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(grid.ndim)
    )


def no_slip_box(grid: GridSpec) -> dict[Face, BCSpec]:
    """All-walls, zero-velocity BC table (the cavity starting point)."""
    zeros = (0.0,) * grid.ndim
    return {
        (a, s): BCSpec.wall(zeros) for a in range(grid.ndim) for s in (0, 1)
    }


def apply_velocity_bcs(
    grid: GridSpec, bcs: BCTable, u: tuple[torch.Tensor, ...]
) -> tuple[torch.Tensor, ...]:
    """Impose the WALL value on each component's boundary faces along its
    own axis. Returns new tensors; the inputs are not modified."""
    out = []
    for a, comp in enumerate(u):
        comp = comp.clone()
        n = comp.shape[a]
        for side, index in ((0, 0), (1, n - 1)):
            comp.select(a, index).fill_(bcs[(a, side)].component(a, grid.ndim))
        out.append(comp)
    return tuple(out)


def pad_transverse(
    grid: GridSpec, bcs: BCTable, comp: int, arr: torch.Tensor
) -> torch.Tensor:
    """Ghost-pad velocity component ``comp`` by one cell along every axis
    except its own staggering axis: ``ghost = 2*u_bc - edge``."""
    for t in range(grid.ndim):
        if t == comp:
            continue
        n = arr.shape[t]
        edge_lo = arr.narrow(t, 0, 1)
        edge_hi = arr.narrow(t, n - 1, 1)
        ghost_lo = 2.0 * bcs[(t, 0)].component(comp, grid.ndim) - edge_lo
        ghost_hi = 2.0 * bcs[(t, 1)].component(comp, grid.ndim) - edge_hi
        arr = torch.cat([ghost_lo, arr, ghost_hi], dim=t)
    return arr
