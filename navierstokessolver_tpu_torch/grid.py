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


@dataclasses.dataclass
class State:
    """Simulation state: staggered velocity components + cell pressure.

    ``theta`` (transported scalar), ``p_prev`` (extrapolated warm start) and
    ``t`` (time-dependent BCs) mirror the JAX State; the ported slice never
    sets them, so they stay ``None``.
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
