"""Carry state and constants across from the JAX package, as numpy arrays.

The JAX package and this port store the same quantities in the same MAC
layout, with one exception: the JAX DCT solver keeps its spectral
multiplier axis-reversed (its tensordot chain leaves the spectrum that way),
while the port keeps natural axis order. These functions take the JAX
package's arrays as numpy (``np.asarray(jax_array)``) and give the port's
objects, so a test can feed both packages the same state and constants.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .grid import GridSpec, State
from .ops import dct as dct_mod
from .ops.fft_poisson import DCTPoissonSolver
from .ops.poisson import PoissonOp


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def state_from_numpy(
    u: Sequence[np.ndarray], p: np.ndarray, device="cpu"
) -> State:
    """A port State from the velocity components and pressure."""
    return State(u=tuple(_f32(c, device) for c in u), p=_f32(p, device))


def state_to_numpy(state: State) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
    """``(u components, p)`` as host numpy arrays."""
    return (tuple(c.detach().cpu().numpy() for c in state.u),
            state.p.detach().cpu().numpy())


def poisson_op_from_numpy(
    diag: np.ndarray,
    code: np.ndarray,
    w: Sequence[float],
    singular: bool,
    inv_fluid_count: float,
    periodic: Sequence[bool] = (),
    device="cpu",
) -> PoissonOp:
    """A port PoissonOp from a JAX ``PoissonOp``'s fields."""
    return PoissonOp(
        diag=_f32(diag, device),
        code=torch.from_numpy(np.array(code, dtype=np.uint8)).to(device),
        w=tuple(float(x) for x in w),
        singular=bool(singular),
        inv_fluid_count=float(inv_fluid_count),
        periodic=tuple(bool(x) for x in periodic),
    )


def dct_solver_from_numpy(
    grid: GridSpec,
    inv_eig_reversed: np.ndarray,
    fwd: Sequence[np.ndarray],
    inv: Sequence[np.ndarray],
    kinds: Optional[Sequence[str]] = None,
    refine: int = 1,
    device="cpu",
) -> DCTPoissonSolver:
    """A port DCTPoissonSolver from a JAX one whose plans are dense
    (level 0): ``inv_eig_reversed`` is its ``inv_eig`` (axis-reversed
    layout), ``fwd``/``inv`` its per-axis ``plans[a].base_fwd`` and
    ``plans[a].base_inv``."""
    nd = grid.ndim
    inv_nat = np.transpose(np.asarray(inv_eig_reversed), tuple(range(nd - 1, -1, -1)))
    plans = tuple(
        dct_mod.DensePlan(np.asarray(f), np.asarray(i), grid.dtype, device)
        for f, i in zip(fwd, inv)
    )
    return DCTPoissonSolver(
        grid=grid,
        inv_eig=_f32(inv_nat, device),
        plans=plans,
        refine=refine,
        kinds=tuple(kinds) if kinds is not None else ("nn",) * nd,
    )
