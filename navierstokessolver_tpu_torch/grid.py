"""Staggered (MAC) grid specification and simulation state (PyTorch).

Counterpart of ``navierstokessolver_tpu/grid.py``, same layout:

  * ``u[a]``: the velocity component normal to the faces along axis ``a``,
    with ``n_a + 1`` faces along ``a`` and ``n_b`` cells along every other
    axis ``b``; e.g. in 3D ``u[0]`` is ``(n0+1, n1, n2)``.
  * ``p``: cell-centered pressure, shape ``grid.shape``.

The port runs float32 only. Tensors live on the device the caller names;
nothing here picks a device on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a uniform staggered grid.

    Attributes:
      shape:   number of cells per axis, ``(nx, ny)`` or ``(nx, ny, nz)``.
      lengths: physical domain extent per axis.
      dtype:   field dtype; the port supports float32 only.
    """

    shape: tuple[int, ...]
    lengths: tuple[float, ...]
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "lengths", tuple(float(l) for l in self.lengths))
        if len(self.shape) != len(self.lengths):
            raise ValueError(
                f"shape {self.shape} and lengths {self.lengths} rank mismatch"
            )
        if len(self.shape) not in (2, 3):
            raise ValueError("only 2D and 3D grids are supported")
        if any(n < 2 for n in self.shape):
            raise ValueError(f"need >=2 cells per axis, got {self.shape}")
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"dtype {self.dtype}: the port runs float32 only (ROADMAP "
                "Queue A, 'RK2, CFL-adaptive dt and float64')"
            )

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(l / n for l, n in zip(self.lengths, self.shape))

    def face_shape(self, axis: int) -> tuple[int, ...]:
        """Shape of the velocity component staggered along ``axis``."""
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    def cell_centers(self, axis: int) -> np.ndarray:
        """1D coordinates of cell centers along ``axis``, as numpy float32:
        ``(arange + 0.5) * h`` in float32, the arithmetic of the JAX grid,
        so masks built on them match its masks bit for bit."""
        h = np.float32(self.spacing[axis])
        return (np.arange(self.shape[axis], dtype=np.float32)
                + np.float32(0.5)) * h

    def face_coords(self, axis: int) -> np.ndarray:
        """1D coordinates of the faces normal to ``axis`` (numpy float32)."""
        h = np.float32(self.spacing[axis])
        return np.arange(self.shape[axis] + 1, dtype=np.float32) * h


@dataclasses.dataclass(frozen=True)
class SlabGrid(GridSpec):
    """Rows of a grid along axis 0 (a slab of the sharded step,
    parallel/fused_sharded.py): ``shape[0]`` cells along axis 0 and every
    cell of the others, at the whole grid's spacing ``h``. ``spacing``
    returns ``h`` itself, since ``lengths[0] / shape[0]`` need not round
    to the same float, and a slab's stencils must see the same h."""

    h: tuple[float, ...] = ()

    @property
    def spacing(self) -> tuple[float, ...]:
        return self.h


def slab_grid(grid: GridSpec, rows: int) -> SlabGrid:
    """``rows`` cells of ``grid`` along axis 0, at its spacing."""
    h = grid.spacing
    return SlabGrid(shape=(rows,) + grid.shape[1:],
                    lengths=(rows * h[0],) + grid.lengths[1:],
                    dtype=grid.dtype, h=h)


@dataclasses.dataclass
class State:
    """Simulation state: staggered velocity components + cell pressure.

    ``theta`` (transported scalar), ``p_prev`` (extrapolated warm start) and
    ``t`` (the time of a time-dependent run: a 0-d tensor on the device)
    mirror the JAX State. ``p_prev`` is set when the pressure config asks
    for the extrapolated warm start, ``theta`` with a scalar, ``t`` when a
    BC value or a force component is a callable of t
    (``Simulation.initial_state``); otherwise they stay ``None``.
    """

    u: tuple[torch.Tensor, ...]
    p: torch.Tensor
    theta: Optional[torch.Tensor] = None
    p_prev: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None

    @property
    def ndim(self) -> int:
        return self.p.ndim


def zero_state(grid: GridSpec, device) -> State:
    """Quiescent initial state (u = 0, p = 0) on ``device``."""
    u = tuple(
        torch.zeros(grid.face_shape(a), dtype=grid.dtype, device=device)
        for a in range(grid.ndim)
    )
    p = torch.zeros(grid.shape, dtype=grid.dtype, device=device)
    return State(u=u, p=p)


def interpolate_to_centers(
    grid: GridSpec, u: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, ...]:
    """Average face-normal velocities to cell centers (output/diagnostics)."""
    out = []
    for a, comp in enumerate(u):
        n = comp.shape[a]
        out.append(0.5 * (comp.narrow(a, 0, n - 1) + comp.narrow(a, 1, n - 1)))
    return tuple(out)
