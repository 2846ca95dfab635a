"""Geometric multigrid pressure solver: V-cycles, red-black smoothing
(PyTorch).

Counterpart of ``navierstokessolver_tpu/ops/multigrid.py`` without the
sharded mode. The hierarchy rediscretizes the masked Laplacian on
2x-coarsened grids: a coarse cell is solid only when all its children are
solid, so thin fluid channels stay connected. Transfers are full-weighting
restriction (the 2^d-child mean) and tensor-product linear prolongation.

Routes through one level of a V-cycle, as in JAX:

  * ``fused`` (:meth:`MGPoissonSolver._fused_ok`: 2D float32 levels of at
    least 128 per side that are not the coarsest, no periodic axis): the
    level kernels ``mg_pre_sweeps_residual`` and ``mg_add_post_sweeps``
    (ops/multigrid_kernels.py), one pass over memory each;
  * ``use_pallas`` (the JAX name of the switch; here the ``rb_sweeps``
    kernel): the pre and post sweeps of the same levels in one kernel
    launch each;
  * otherwise plain torch: ``n`` x ``poisson._rb_sweep``, the residual by
    ``apply_A``. The coarsest level always runs ``coarse_iters`` plain
    RB-SOR sweeps at ``2/(1+sin(pi/n))``.

On a CUDA device the fused route is the default: JAX turned it off on the
TPU for the pad/unpad glue around its kernels (``multigrid.py:270-280``),
which the CUDA kernels, reading the exact layout, do not need. On the CPU
every route runs the kernels' plain versions.

Stopping rule: the relative L2 residual of ops/poisson.py; iterations are
reported in V-cycles (``solve``) or CG iterations (``solve_pcg``). Both
loops check on the host once per iteration (ops/poisson.device_while with a
block of one), since each iteration costs a whole V-cycle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..bcs import BCTable
from ..grid import GridSpec
from . import multigrid_kernels
from .poisson import (
    PoissonOp,
    _prepare,
    _rb_sweep,
    apply_A,
    build_poisson_op,
    deflate,
    device_while,
    flexible_pcg,
    residual_norm,
)


def _coarsen_solid(solid: np.ndarray) -> np.ndarray:
    """Coarse cell is solid iff all 2^d children are solid."""
    out = solid
    for a in range(solid.ndim):
        sh = list(out.shape)
        sh[a] //= 2
        sh.insert(a + 1, 2)
        out = out.reshape(sh).all(axis=a + 1)
    return out


def _can_coarsen(shape: tuple[int, ...], min_size: int = 4) -> bool:
    return all(n % 2 == 0 and n // 2 >= min_size for n in shape)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting (2^d-child average) restriction, axis by axis."""
    out = r
    for a in range(r.ndim):
        sh = list(out.shape)
        sh[a] //= 2
        sh.insert(a + 1, 2)
        out = out.reshape(sh).mean(dim=a + 1)
    return out


def _prolong(e: torch.Tensor, periodic: tuple[bool, ...] = ()) -> torch.Tensor:
    """Tensor-product linear prolongation for cell-centred grids: along
    each axis, fine cells 2i / 2i+1 get 0.75 c[i] + 0.25 c[i -/+ 1], the
    neighbor edge-replicated (homogeneous Neumann) or wrapped on a periodic
    axis."""
    per = periodic or (False,) * e.ndim
    out = e
    for a in range(e.ndim):
        n = out.shape[a]
        if per[a]:
            cm = torch.roll(out, 1, dims=a)
            cp = torch.roll(out, -1, dims=a)
        else:
            cm = torch.cat([out.narrow(a, 0, 1), out.narrow(a, 0, n - 1)], dim=a)
            cp = torch.cat([out.narrow(a, 1, n - 1), out.narrow(a, n - 1, 1)],
                           dim=a)
        lo = 0.75 * out + 0.25 * cm   # fine cell 2i
        hi = 0.75 * out + 0.25 * cp   # fine cell 2i+1
        shape = list(out.shape)
        shape[a] *= 2
        out = torch.stack([lo, hi], dim=a + 1).reshape(shape)
    return out


@dataclasses.dataclass(eq=False)
class MGPoissonSolver:
    """V-cycle hierarchy for one (grid, bcs, solid) problem; ``ops[0]`` is
    the finest level."""

    ops: list[PoissonOp]
    pre: int = 2
    post: int = 2
    coarse_iters: int = 60
    omega: float = 1.0                 # smoother relaxation (RB-GS)
    coarse_omega: float = 1.0          # coarse-solve relaxation (RB-SOR)
    # the rb_sweeps kernel for the pre/post sweeps of the large 2D levels
    use_pallas: bool = False
    # the fused level kernels (mg_pre_sweeps_residual, mg_add_post_sweeps)
    fused: bool = False

    @staticmethod
    def build(
        grid: GridSpec,
        bcs: BCTable,
        device,
        solid: Optional[np.ndarray] = None,
        pre: int = 2,
        post: int = 2,
        coarse_iters: int = 60,
        min_size: int = 4,
        max_levels: int = 8,
        use_pallas: Optional[bool] = None,
        fused: Optional[bool] = None,
        sdf=None,
    ) -> "MGPoissonSolver":
        """Level operators on ``device``, coarsened while every axis halves
        evenly to at least ``min_size``, at most ``max_levels`` levels; the
        coarse omega is the textbook-optimal one of the coarsest level.
        ``fused=None``: on when ``device`` is a CUDA device, off on the CPU;
        ``use_pallas=None``: off, as in JAX."""
        if sdf is not None:
            raise NotImplementedError(
                "cut-cell multigrid (sdf): not ported yet (ROADMAP Queue A, "
                "'Physics extensions')"
            )
        device = torch.device(device)
        ops = []
        g = grid
        s = None if solid is None else np.asarray(solid, bool)
        while True:
            ops.append(build_poisson_op(g, bcs, device, s))
            if len(ops) >= max_levels or not _can_coarsen(g.shape, min_size):
                break
            g = GridSpec(shape=tuple(n // 2 for n in g.shape),
                         lengths=g.lengths, dtype=g.dtype)
            s = None if s is None else _coarsen_solid(s)
        n_coarse = min(ops[-1].diag.shape)
        return MGPoissonSolver(
            ops=ops, pre=pre, post=post, coarse_iters=coarse_iters,
            coarse_omega=2.0 / (1.0 + math.sin(math.pi / n_coarse)),
            use_pallas=bool(use_pallas),
            fused=device.type == "cuda" if fused is None else fused,
        )

    # -- one V-cycle -----------------------------------------------------------

    def _smooth(self, level: int, x: torch.Tensor, b: torch.Tensor, n: int,
                omega: Optional[float] = None) -> torch.Tensor:
        op = self.ops[level]
        omega = self.omega if omega is None else omega
        if (self.use_pallas and n <= 8
                and multigrid_kernels.rb_sweeps_applicable(
                    tuple(op.diag.shape), op.diag.dtype)):
            return multigrid_kernels.rb_sweeps(op, x, b, omega, n)
        for _ in range(n):
            x = _rb_sweep(op, x, b, omega)
        return x

    def _fused_ok(self, level: int) -> bool:
        if not self.fused or level == len(self.ops) - 1:
            return False
        if not (1 <= self.pre <= 8 and 1 <= self.post <= 8):
            return False
        return multigrid_kernels.mg_fused_applicable(self.ops[level])

    def _v_cycle(self, level: int, x: torch.Tensor, b: torch.Tensor,
                 want_rsq: bool = False):
        """One V-cycle at ``level``. With ``want_rsq`` also returns
        ``sum(((b - A x') fluid)^2)`` of the returned iterate, the solve
        loop's convergence quantity (on the fused route the post kernel
        emits it)."""
        op = self.ops[level]
        if level == len(self.ops) - 1:
            x = self._smooth(level, x, b, self.coarse_iters, self.coarse_omega)
            if want_rsq:
                rn = residual_norm(op, x, b)
                return x, rn * rn
            return x
        if self._fused_ok(level):
            x, r = multigrid_kernels.mg_pre_sweeps_residual(
                op, x, b, self.pre, self.omega)
            rc = _restrict(r) * self.ops[level + 1].fluid
            ec = self._v_cycle(level + 1, torch.zeros_like(rc), rc)
            e = _prolong(ec, op.periodic)
            x, rsq = multigrid_kernels.mg_add_post_sweeps(
                op, x, b, e, self.post, self.omega)
            return (x, rsq) if want_rsq else x
        x = self._smooth(level, x, b, self.pre)
        r = (b - apply_A(op, x)) * op.fluid
        rc = _restrict(r) * self.ops[level + 1].fluid
        ec = self._v_cycle(level + 1, torch.zeros_like(rc), rc)
        x = (x + _prolong(ec, op.periodic)) * op.fluid
        x = self._smooth(level, x, b, self.post)
        if want_rsq:
            rn = residual_norm(op, x, b)
            return x, rn * rn
        return x

    def solve(self, b: torch.Tensor, p0: torch.Tensor, tol: float,
              max_cycles: int) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """Returns (p, cycles, relative residual), the semantics of
        ops/poisson.solve_poisson. Stops on convergence, the cycle cap, or
        stagnation (a residual no longer below 0.9x the previous one: the
        float32 residual floor)."""
        op = self.ops[0]
        b, p0, inv_bnorm = _prepare(op, b, p0)

        def cond(carry):
            _, k, res, prev = carry
            return (k < max_cycles) & (res > tol) & (res < 0.9 * prev)

        def body(carry):
            p, k, res, _ = carry
            # A maps constants to zero on the singular operator, so the
            # residual of the deflated iterate is the one of p
            p, rsq = self._v_cycle(0, p, b, want_rsq=True)
            if op.singular:
                p = deflate(op, p)
            return p, k + 1, torch.sqrt(rsq) * inv_bnorm, res

        res0 = residual_norm(op, p0, b) * inv_bnorm
        k0 = torch.zeros((), dtype=torch.int32, device=b.device)
        p, cycles, res, _ = device_while(
            cond, body, (p0, k0, res0, torch.full_like(res0, math.inf)), 1)
        return p, cycles, res

    def solve_pcg(self, b: torch.Tensor, p0: torch.Tensor, tol: float,
                  max_iters: int) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """Flexible CG with one zero-guess V-cycle as the preconditioner per
        iteration, ``z = -V(0, r)`` (A is negative semi-definite); the CG
        loop is ops/poisson.flexible_pcg, checked once per iteration."""
        op = self.ops[0]

        def precond(r):
            z = -self._v_cycle(0, torch.zeros_like(r), r)
            return deflate(op, z) if op.singular else z * op.fluid

        return flexible_pcg(op, b, p0, tol, max_iters, precond, block=1)
