"""Pressure Poisson operator (PyTorch).

Counterpart of the operator half of ``navierstokessolver_tpu/ops/poisson.py``:
the boundary conditions are folded into static per-cell data built once per
case with numpy (:func:`build_poisson_op`, a copy of the JAX builder):

  * ``code``: one uint8 per cell; bit ``2a`` = coupling to the low neighbor
    along axis ``a``, bit ``2a+1`` = coupling to the high neighbor, bit 6 =
    the cell is fluid. A present coupling is worth ``w[a] = 1/h_a^2``.
  * ``diag``: the exact diagonal, float32.

The iterative solvers (jacobi/gs/sor/cg, ``solve_poisson``) are not ported
yet (ROADMAP Queue A, "Iterative Poisson solvers"); :class:`PoissonConfig`
accepts only ``method="fft"`` for now.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..bcs import BCKind, BCTable
from ..grid import GridSpec

FLUID_BIT = 6


@dataclasses.dataclass
class PoissonOp:
    """Matrix-free masked Laplacian ``A p = diag*p + sum_d c_d * p_nbr_d``.

    ``singular`` marks a pure-Neumann problem (nullspace = constants).
    """

    diag: torch.Tensor
    code: torch.Tensor               # uint8, same shape as diag
    w: tuple[float, ...]             # per-axis coupling 1/h_a^2
    singular: bool
    inv_fluid_count: float
    periodic: tuple[bool, ...] = ()

    @property
    def fluid(self) -> torch.Tensor:
        return ((self.code >> FLUID_BIT) & 1).to(self.diag.dtype)


def build_poisson_op(
    grid: GridSpec, bcs: BCTable, device, solid: Optional[np.ndarray] = None
) -> PoissonOp:
    """Static stencil code + diagonal for the pressure Poisson equation on
    ``device``: the JAX package's numpy builder, copied as it is, so both
    packages hold bit-equal ``diag`` and ``code``.

    Per axis ``a`` and side, the coupling across a face is ``1/h_a^2`` when
    the neighbor is a fluid cell; 0 across domain walls and solid
    neighbors (Neumann dp/dn = 0); outflow faces contribute ``-2/h_a^2`` to
    the diagonal. Solid cells get the identity row.
    """
    nd = grid.ndim
    h = grid.spacing
    periodic = tuple(
        bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(nd)
    )
    fluid = np.ones(grid.shape, dtype=bool)
    if solid is not None:
        fluid &= np.logical_not(np.asarray(solid, bool))

    diag = np.zeros(grid.shape, dtype=np.float64)
    code = np.zeros(grid.shape, dtype=np.uint8)
    code |= fluid.astype(np.uint8) << FLUID_BIT
    w = []
    for a in range(nd):
        wa = 1.0 / (h[a] * h[a])
        w.append(float(wa))

        def shifted(side: int) -> np.ndarray:
            """Whether the neighbor on `side` along axis a exists and is fluid."""
            if periodic[a]:
                return np.roll(fluid, 1 if side == 0 else -1, axis=a)
            nb = np.zeros(grid.shape, dtype=bool)
            src = [slice(None)] * nd
            dst = [slice(None)] * nd
            if side == 0:
                dst[a] = slice(1, None)
                src[a] = slice(0, -1)
            else:
                dst[a] = slice(0, -1)
                src[a] = slice(1, None)
            nb[tuple(dst)] = fluid[tuple(src)]
            return nb

        lo = shifted(0) & fluid
        hi = shifted(1) & fluid
        code |= lo.astype(np.uint8) << (2 * a)
        code |= hi.astype(np.uint8) << (2 * a + 1)
        for side in (0, 1):
            face = [slice(None)] * nd
            face[a] = 0 if side == 0 else -1
            if bcs[(a, side)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE):
                diag[tuple(face)] -= 2.0 * wa
        diag -= wa * (lo.astype(np.float64) + hi.astype(np.float64))

    diag[~fluid] = 1.0
    singular = not any(
        bcs[(a, s)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        for a in range(nd) for s in (0, 1)
    )
    return PoissonOp(
        diag=torch.as_tensor(diag, dtype=grid.dtype).to(device),
        code=torch.as_tensor(code).to(device),
        w=tuple(w),
        singular=singular,
        inv_fluid_count=float(1.0 / fluid.sum()),
        periodic=periodic,
    )


def _neighbor_sum(op: PoissonOp, p: torch.Tensor) -> torch.Tensor:
    """``sum_d c_d * p_neighbor_d`` with coefficients decoded from the
    stencil code (select-then-scale: a masked-out neighbor contributes
    exactly 0, which also kills the zero-pad ghosts)."""
    if any(op.periodic):
        raise NotImplementedError(
            "periodic Poisson axes: not ported yet (ROADMAP Queue A, "
            "'Other BC kinds')"
        )
    nd = p.ndim
    code = op.code
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    out = torch.zeros_like(p)
    for a in range(nd):
        n = p.shape[a]
        # F.pad lists (lo, hi) pairs from the last axis to the first
        k = 2 * (nd - 1 - a)
        pad_lo = [0] * (2 * nd)
        pad_lo[k] = 1
        pad_hi = [0] * (2 * nd)
        pad_hi[k + 1] = 1
        p_lo = torch.nn.functional.pad(p, pad_lo).narrow(a, 0, n)
        p_hi = torch.nn.functional.pad(p, pad_hi).narrow(a, 1, n)
        has_lo = (code & (1 << (2 * a))) > 0
        has_hi = (code & (1 << (2 * a + 1))) > 0
        out = out + op.w[a] * (
            torch.where(has_lo, p_lo, zero) + torch.where(has_hi, p_hi, zero)
        )
    return out


def apply_A(op: PoissonOp, p: torch.Tensor) -> torch.Tensor:
    return op.diag * p + _neighbor_sum(op, p)


def deflate(op: PoissonOp, x: torch.Tensor) -> torch.Tensor:
    """Remove the constant nullspace component over fluid cells (singular
    case)."""
    if not op.singular:
        return x
    fluid = op.fluid
    mean = torch.sum(x * fluid) * op.inv_fluid_count
    return (x - mean) * fluid


def residual_norm(op: PoissonOp, p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r = (b - apply_A(op, p)) * op.fluid
    return torch.sqrt(torch.sum(r * r))


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Pressure-solve settings. Only the direct spectral method
    (``"fft"``) is ported; the iterative solvers' settings (tolerance,
    iteration cap, SOR omega, Jacobi weight, extrapolated warm start) come
    with them."""

    method: str = "fft"
    # False -> diagnostics carry the sentinel -1.0 instead of the residual
    diag_residual: bool = True

    def __post_init__(self):
        if self.method != "fft":
            raise NotImplementedError(
                f"poisson method {self.method!r}: not ported yet (ROADMAP "
                "Queue A, 'Iterative Poisson solvers')"
            )
