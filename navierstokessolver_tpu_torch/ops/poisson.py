"""Pressure Poisson operator and iterative solvers (PyTorch).

Counterpart of ``navierstokessolver_tpu/ops/poisson.py``. The boundary
conditions are folded into static per-cell data built once per case with
numpy (:func:`build_poisson_op`, a copy of the JAX builder):

  * ``code``: one uint8 per cell; bit ``2a`` = coupling to the low neighbor
    along axis ``a``, bit ``2a+1`` = coupling to the high neighbor, bit 6 =
    the cell is fluid. A present coupling is worth ``w[a] = 1/h_a^2``.
  * ``diag``: the exact diagonal, float32.

The iterative solvers (:func:`solve_poisson`: damped Jacobi, red-black
Gauss-Seidel and SOR, conjugate gradients; :func:`flexible_pcg`, shared with
the multigrid preconditioner) keep the JAX stopping rules: the relative L2
residual ``||b - A p|| / max(||b||, tiny) <= tol``, an iteration cap, and
the JAX carry of each loop. JAX runs each solve as one ``lax.while_loop``
with no host round-trip. Here the loop body runs in blocks
(:func:`device_while`): inside a block a device flag freezes the carry once
the loop condition turns false, so the iterations past convergence are
exact no-ops, and the host reads the flag once per block. The counts the
solvers report are those of a sequential loop; :data:`HOST_SYNCS` counts
the host's reads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..bcs import BCKind, BCTable
from ..grid import GridSpec

FLUID_BIT = 6
TINY = float(np.finfo(np.float32).tiny)
# host reads of a loop flag (each waits for the device); reset by callers
HOST_SYNCS = {"poisson": 0}
# iterations per host check of the relaxation and CG loops
BLOCK = 16
METHODS = ("fft", "jacobi", "gs", "sor", "cg", "mg", "mgcg", "dctcg")


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

    @functools.cached_property
    def fluid(self) -> torch.Tensor:
        """The fluid mask as 1.0/0.0, decoded once per operator."""
        return ((self.code >> FLUID_BIT) & 1).to(self.diag.dtype)

    @functools.cached_property
    def couplings(self) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
        """Per axis, the (low, high) coupling-present masks, decoded once
        per operator."""
        return tuple(
            ((self.code & (1 << (2 * a))) > 0,
             (self.code & (1 << (2 * a + 1))) > 0)
            for a in range(self.code.ndim)
        )

    @functools.cached_property
    def red(self) -> torch.Tensor:
        """The red-black sweeps' red mask, made once per operator."""
        return _parity(tuple(self.code.shape), self.code.device)


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
    exactly 0, which also kills the zero-pad ghosts). A periodic axis
    takes its neighbors by a roll."""
    nd = p.ndim
    out = None
    for a, (has_lo, has_hi) in enumerate(op.couplings):
        n = p.shape[a]
        if op.periodic and op.periodic[a]:
            p_lo = torch.roll(p, 1, dims=a)
            p_hi = torch.roll(p, -1, dims=a)
        else:
            # F.pad lists (lo, hi) pairs from the last axis to the first
            k = 2 * (nd - 1 - a)
            pad_lo = [0] * (2 * nd)
            pad_lo[k] = 1
            pad_hi = [0] * (2 * nd)
            pad_hi[k + 1] = 1
            p_lo = torch.nn.functional.pad(p, pad_lo).narrow(a, 0, n)
            p_hi = torch.nn.functional.pad(p, pad_hi).narrow(a, 1, n)
        term = op.w[a] * (
            torch.where(has_lo, p_lo, 0.0) + torch.where(has_hi, p_hi, 0.0)
        )
        out = term if out is None else out + term
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
    """Pressure-solve settings, the JAX package's fields and defaults.

    ``method``: "fft" (direct DCT solve), "jacobi" | "gs" | "sor" | "cg"
    (:func:`solve_poisson`), "mg" | "mgcg" (ops/multigrid.py), "dctcg"
    (the DCT-preconditioned solve for obstacles,
    ops/fft_poisson.DCTPCGSolver).
    """

    method: str = "cg"
    tol: float = 1e-5            # relative L2 residual
    max_iters: int = 500
    omega: Optional[float] = None  # SOR relaxation; None -> auto-optimal
    check_every: int = 1         # residual check cadence for relaxation
    # Jacobi damping: plain (w=1) Jacobi does not converge on the pure-
    # Neumann problem (the checkerboard mode has eigenvalue -1)
    jacobi_weight: float = 0.8
    # False -> diagnostics of the direct (fft) solve carry the sentinel -1.0
    diag_residual: bool = True
    # damped second-order warm start of the iterative solves:
    # p_n + beta (p_n - p_{n-1}); beta must stay < 1 (0.0 = off)
    extrapolate: float = 0.0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(
                f"unknown poisson method {self.method!r}; one of {METHODS}"
            )


def _auto_omega(grid: GridSpec) -> float:
    """Textbook optimal SOR omega for the Laplacian on the coarsest axis."""
    return 2.0 / (1.0 + math.sin(math.pi / min(grid.shape)))


def reset_host_syncs() -> None:
    HOST_SYNCS["poisson"] = 0


def device_while(
    cond: Callable[[tuple], torch.Tensor],
    body: Callable[[tuple], tuple],
    carry: tuple,
    block: int,
) -> tuple:
    """``lax.while_loop(cond, body, carry)`` with a host check once per
    ``block`` iterations: the host reads ``cond`` (one sync), runs one
    iteration it knows is live, then ``block - 1`` more, each frozen by
    ``torch.where`` on the device once ``cond`` is false. Every carried
    value is a tensor; the result equals the sequential loop's."""
    while True:
        HOST_SYNCS["poisson"] += 1
        if not bool(cond(carry)):
            return carry
        carry = body(carry)
        for _ in range(block - 1):
            live = cond(carry)
            new = body(carry)
            carry = tuple(torch.where(live, n, c) for n, c in zip(new, carry))


def _prepare(op: PoissonOp, b: torch.Tensor, p0: torch.Tensor):
    """``b*fluid`` (deflated when singular), ``p0*fluid`` and
    ``1/max(||b||, tiny)``, as every JAX solver opens."""
    b = b * op.fluid
    b = deflate(op, b) if op.singular else b
    p0 = p0 * op.fluid
    bnorm = torch.sqrt(torch.sum(b * b))
    return b, p0, 1.0 / torch.clamp_min(bnorm, TINY)


def solve_poisson(
    op: PoissonOp,
    b: torch.Tensor,
    p0: torch.Tensor,
    grid: GridSpec,
    cfg: PoissonConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve ``A p = b``; returns ``(p, iters, final_relative_residual)``
    as device tensors (iters int32)."""
    b, p0, inv_bnorm = _prepare(op, b, p0)
    if cfg.method == "cg":
        return _solve_cg(op, b, p0, inv_bnorm, cfg.tol, cfg.max_iters)
    if cfg.method in ("jacobi", "gs", "sor"):
        if cfg.method == "jacobi":
            w = cfg.jacobi_weight
            sweep = lambda p: _jacobi_sweep(op, p, b, w)
        else:
            omega = 1.0 if cfg.method == "gs" else (
                cfg.omega if cfg.omega is not None else _auto_omega(grid)
            )
            sweep = lambda p: _rb_sweep(op, p, b, omega)
        return _relaxation_loop(op, b, p0, sweep, inv_bnorm, cfg)
    raise ValueError(f"solve_poisson: method {cfg.method!r} is not one of "
                     "jacobi, gs, sor, cg")


def _jacobi_sweep(
    op: PoissonOp, p: torch.Tensor, b: torch.Tensor, weight: float = 1.0
) -> torch.Tensor:
    p_new = (b - _neighbor_sum(op, p)) / op.diag
    if weight != 1.0:
        p_new = (1.0 - weight) * p + weight * p_new
    return p_new * op.fluid


def _parity(shape: tuple[int, ...], device) -> torch.Tensor:
    """The red mask ``(i + j (+ k)) % 2 == 0`` over global indices."""
    idx = sum(
        torch.arange(n, device=device).reshape(
            [n if d == a else 1 for d in range(len(shape))])
        for a, n in enumerate(shape)
    )
    return (idx % 2 == 0).expand(shape).contiguous()


def _rb_sweep(
    op: PoissonOp, p: torch.Tensor, b: torch.Tensor, omega: float
) -> torch.Tensor:
    """One red-black sweep: red cells, then black, each from the current
    iterate, ``(1-omega) p + omega (b - sum c p_nbr) / diag``, fluid-gated."""
    red = op.red
    fluid = op.fluid
    for is_red in (True, False):
        gs = (b - _neighbor_sum(op, p)) / op.diag
        p_new = (1.0 - omega) * p + omega * gs
        p = (torch.where(red, p_new, p) if is_red
             else torch.where(red, p, p_new)) * fluid
    return p


def _relaxation_loop(op, b, p0, sweep, inv_bnorm, cfg):
    check = max(1, int(cfg.check_every))
    tol, max_iters = cfg.tol, cfg.max_iters

    def cond(carry):
        _, k, res = carry
        return (k < max_iters) & (res > tol)

    def body(carry):
        p, k, _ = carry
        for _ in range(check):
            p = sweep(p)
        if op.singular:
            p = deflate(op, p)
        return p, k + check, residual_norm(op, p, b) * inv_bnorm

    k0 = torch.zeros((), dtype=torch.int32, device=b.device)
    res0 = residual_norm(op, p0, b) * inv_bnorm
    return device_while(cond, body, (p0, k0, res0), BLOCK)


def _neg_matvec(op: PoissonOp, x: torch.Tensor) -> torch.Tensor:
    """``(-A x) * fluid``, deflated when singular: the SPD operator the CG
    loops run on."""
    ax = -apply_A(op, x) * op.fluid
    return deflate(op, ax) if op.singular else ax


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y)


def _solve_cg(op, b, p0, inv_bnorm, tol, max_iters):
    """Matrix-free conjugate gradients on ``(-A) p = -b`` (SPD on the fluid
    subspace, the constant mode deflated when singular). On curvature
    breakdown (``d.Ad <= 0``, the search direction at float32 noise) the
    iteration takes no step, still counts, and stops, as in JAX."""
    b = -b
    r0 = (b - _neg_matvec(op, p0)) * op.fluid
    r0 = deflate(op, r0) if op.singular else r0
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)
    ok0 = torch.ones((), dtype=torch.bool, device=b.device)

    def cond(carry):
        _, _, _, rs, k, ok = carry
        return ok & (k < max_iters) & (torch.sqrt(rs) * inv_bnorm > tol)

    def body(carry):
        p, r, d, rs, k, _ = carry
        ad = _neg_matvec(op, d)
        dad = _dot(d, ad)
        ok = dad > 0.0
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        alpha = torch.where(ok, rs / torch.clamp_min(dad, 1e-30), zero)
        p = p + alpha * d
        r = r - alpha * ad
        rs_new = _dot(r, r)
        beta = torch.where(ok, rs_new / torch.clamp_min(rs, 1e-30), zero)
        d = r + beta * d
        return p, r, d, rs_new, k + 1, ok

    p, _, _, rs, iters, _ = device_while(
        cond, body, (p0, r0, r0, _dot(r0, r0), k0, ok0), BLOCK)
    if op.singular:
        p = deflate(op, p)
    return p, iters, torch.sqrt(rs) * inv_bnorm


def flexible_pcg(
    op: PoissonOp,
    b: torch.Tensor,
    p0: torch.Tensor,
    tol: float,
    max_iters: int,
    precond: Callable[[torch.Tensor], torch.Tensor],
    block: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flexible (Polak-Ribiere) preconditioned CG on ``(-A) p = -b``, one
    implementation for every preconditioner. ``precond(r)`` approximates
    ``(-A)^{-1} r`` and may be inexact and nonsymmetric. Same stopping rule
    as every solver here, plus the JAX float32-floor guard: the best
    iterate is carried and the loop stops after ``PATIENCE = 5``
    iterations without a 5% improvement. ``block``: iterations per host
    check; a costly preconditioner (one V-cycle) wants 1, since the
    iterations past convergence in a block run in full before they are
    discarded."""
    b, p0, inv_bnorm = _prepare(op, b, p0)
    nb = -b
    r0 = (nb - _neg_matvec(op, p0)) * op.fluid
    r0 = deflate(op, r0) if op.singular else r0
    z0 = precond(r0)
    res0 = torch.sqrt(_dot(r0, r0)) * inv_bnorm
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)
    patience = 5

    def cond(carry):
        k, best_res, since = carry[5], carry[6], carry[8]
        return (k < max_iters) & (best_res > tol) & (since < patience)

    def body(carry):
        p, r, z, d, rz, k, best_res, best_p, since = carry
        ad = _neg_matvec(op, d)
        alpha = rz / torch.clamp_min(_dot(d, ad), 1e-30)
        p = p + alpha * d
        r_new = r - alpha * ad
        z_new = precond(r_new)
        beta = _dot(z_new, r_new - r) / torch.clamp_min(rz, 1e-30)
        beta = torch.clamp_min(beta, 0.0)   # restart direction if negative
        d = z_new + beta * d
        rz_new = _dot(r_new, z_new)
        res = torch.sqrt(_dot(r_new, r_new)) * inv_bnorm
        better = res < best_res              # False for a NaN residual
        best_p = torch.where(better, p, best_p)
        improved = res < 0.95 * best_res
        best_res = torch.where(better, res, best_res)
        since = torch.where(improved, torch.zeros_like(since), since + 1)
        return p, r_new, z_new, d, rz_new, k + 1, best_res, best_p, since

    carry = (p0, r0, z0, z0, _dot(r0, z0), k0, res0, p0, k0)
    out = device_while(cond, body, carry, block)
    iters, res, p = out[5], out[6], out[7]
    if op.singular:
        p = deflate(op, p)
    return p, iters, res
