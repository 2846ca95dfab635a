"""Direct spectral (DCT) pressure Poisson solver (PyTorch).

Counterpart of ``DCTPoissonSolver`` and ``solve_with_residual`` in
``navierstokessolver_tpu/ops/fft_poisson.py``, matmul mode with the
Neumann/Neumann ('nn') kind on every axis -- the closed box of the cavity
cases. The discrete Laplacian diagonalizes under a DCT-II per axis, so the
solve is exact in one application: forward transform per axis, multiply by
the inverse eigenvalue sums, inverse transform. One refinement pass
``p += direct(b - A p)`` follows, its residual taken by the fused residual
kernel in 3D (ops/fused3d.residual_3d).

The transforms are plain GEMMs (``torch.matmul``), as the JAX package left
them to XLA outside any kernel. They run in full float32: callers that time
them on a GPU keep ``torch.backends.cuda.matmul.allow_tf32`` False.

Each axis of n >= 1024 runs the radix-split transform chain that the JAX
solver picks (:func:`auto_split_levels`), in block order. The multiplier
``inv_eig`` is stored in natural axis order, each axis permuted to its
plan's block order. (The JAX solver stores it axis-reversed because its
tensordot chain leaves the spectrum that way;
convert.dct_solver_from_numpy undoes that layout.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..bcs import BCKind, BCTable
from ..grid import GridSpec
from . import dct as dct_mod
from .poisson import PoissonOp, residual_norm


def axis_kinds_from_bcs(grid: GridSpec, bcs: BCTable) -> tuple[str, ...]:
    """Per-axis transform kind for the pressure operator's eigenbasis:
    'nn' DCT-II | 'nd' DCT-IV | 'dn' flipped DCT-IV | 'dd' DST-II | 'per'."""
    kinds = []
    for a in range(grid.ndim):
        if bcs[(a, 0)].kind is BCKind.PERIODIC:
            kinds.append("per")
            continue
        lo_d = bcs[(a, 0)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        hi_d = bcs[(a, 1)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        kinds.append({(False, False): "nn", (False, True): "nd",
                      (True, False): "dn", (True, True): "dd"}[(lo_d, hi_d)])
    return tuple(kinds)


def is_applicable(grid: GridSpec, bcs: BCTable, solid) -> bool:
    """Only an interior obstacle mask breaks the tensor structure."""
    return solid is None or not np.any(solid)


def auto_split_levels(n: int) -> int:
    """Split levels of a length-``n`` 'nn' axis, as the JAX solver picks
    them (``_auto_levels``): none below 1024, else halve while the base
    stays at least 128 wide, at most 4 times."""
    if n < 1024:
        return 0
    return min(4, dct_mod.split_levels(n, min_base=128))


@dataclasses.dataclass(eq=False)
class DCTPoissonSolver:
    """Precomputed inverse-eigenvalue tensor and per-axis transform plans.

    ``precision`` and ``refine_precision`` are the JAX package's MXU pass
    counts for the transform matmuls. They have no meaning on a GPU; the
    port accepts them so configurations carry over, and runs every GEMM in
    full float32.
    """

    grid: GridSpec
    inv_eig: torch.Tensor  # 1/(sum_a lambda_a(k_a)), 0 at the constant mode
    plans: tuple[dct_mod.SplitPlan, ...] = ()
    precision: str = "high"
    refine: int = 1
    refine_precision: str = "high"
    kinds: tuple[str, ...] = ()

    @property
    def singular(self) -> bool:
        return all(k in ("nn", "per") for k in self.kinds)

    @staticmethod
    def build(
        grid: GridSpec,
        device,
        precision: str = "high",
        refine: int = 1,
        kinds: Optional[tuple[str, ...]] = None,
        split_levels: Optional[int] = None,
    ) -> "DCTPoissonSolver":
        """Multiplier and plans on ``device``, then the build-time
        self-check, which raises on failure. ``split_levels``: the levels
        of every axis; None picks :func:`auto_split_levels` per axis."""
        kinds = kinds or ("nn",) * grid.ndim
        if any(k != "nn" for k in kinds):
            raise NotImplementedError(
                f"axis kinds {kinds}: only Neumann/Neumann ('nn') axes are "
                "ported (ROADMAP Queue A, 'Other BC kinds')"
            )
        total = np.zeros(grid.shape, dtype=np.float64)
        for a, (n, h) in enumerate(zip(grid.shape, grid.spacing)):
            shape = [1] * grid.ndim
            shape[a] = n
            total = total + dct_mod.neumann_eigenvalues(n, h).reshape(shape)
        inv = np.zeros_like(total)
        nz = total != 0.0
        inv[nz] = 1.0 / total[nz]  # constant mode pinned to 0 (deflation)
        plans = []
        for a, n in enumerate(grid.shape):
            lv = auto_split_levels(n) if split_levels is None else split_levels
            plans.append(dct_mod.SplitPlan.build(n, lv, grid.dtype, device))
            # block order along this axis, so the runtime never interleaves
            inv = np.take(inv, dct_mod.split_permutation(n, lv), axis=a)
        solver = DCTPoissonSolver(
            grid=grid,
            inv_eig=torch.as_tensor(inv, dtype=grid.dtype).to(device),
            plans=tuple(plans),
            precision=precision,
            refine=refine,
            kinds=kinds,
        )
        err = solver._self_check_error()
        if not (err < 0.05):
            raise RuntimeError(
                f"DCT Poisson self-check failed (rel err {err:.3g}) "
                f"for shape {grid.shape}; refusing to produce corrupt "
                "physics"
            )
        return solver

    def _self_check_error(self) -> float:
        """Relative error of one direct solve on an exact-eigenfunction RHS
        (the JAX package's manufactured multi-eigenmode check: ~8 discrete
        Neumann eigenmodes with analytic eigenvalues, so solve(sum c lam_m
        p_m) == sum c p_m exactly in exact arithmetic)."""
        shape = self.grid.shape
        spacing = self.grid.spacing
        nd = self.grid.ndim
        rng = np.random.RandomState(0)
        p = np.zeros(shape, np.float64)
        b = np.zeros(shape, np.float64)
        for m in range(8):
            lam = 0.0
            prod = np.ones((1,) * nd, np.float64)
            zero_lam = True
            for a, (n, h) in enumerate(zip(shape, spacing)):
                if m == 0:
                    k = min(1, n - 1)
                elif m == 1:
                    k = n - 1
                else:
                    k = int(rng.randint(0, n))
                i = np.arange(n, dtype=np.float64)
                theta = np.pi * k / n
                basis = np.cos(np.pi * k * (i + 0.5) / n)
                lam_a = (2.0 * np.cos(theta) - 2.0) / (h * h)
                if lam_a != 0.0:
                    zero_lam = False
                lam += lam_a
                sh = [1] * nd
                sh[a] = n
                prod = prod * basis.reshape(sh)
            if zero_lam:
                continue  # constant mode is deflated by construction
            c = float(rng.uniform(0.5, 1.0))
            p += c * prod
            b += c * lam * prod
        bt = torch.as_tensor(b, dtype=self.grid.dtype).to(self.inv_eig.device)
        got = self._direct(bt).double().cpu().numpy()
        p -= p.mean()
        got = got - got.mean()
        denom = float(np.linalg.norm(p.ravel())) or 1.0
        return float(np.linalg.norm((got - p).ravel())) / denom

    def _direct(self, b: torch.Tensor) -> torch.Tensor:
        """One application of the diagonalized inverse Laplacian: the
        forward chain (block-order spectrum), the multiply, the inverse
        chain (the JAX ``_fwd`` / ``_inv`` order)."""
        x = b
        for a, plan in enumerate(self.plans):
            x = dct_mod.split_dct_apply(plan, x, a)
        x = x * self.inv_eig
        for a in range(self.grid.ndim - 1, -1, -1):
            x = dct_mod.split_idct_apply(self.plans[a], x, a)
        return x

    def solve(
        self, b: torch.Tensor, op: Optional[PoissonOp] = None,
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Solve ``lap p = b`` (mean-zero branch), then ``refine`` passes of
        ``p += direct(b - A p)``. ``use_kernel``: take the residual through
        ops/fused3d.residual_3d (3D); False keeps it plain."""
        from . import fused3d

        p = self._direct(b)
        if self.refine and op is not None:
            resid = (fused3d.residual_3d if use_kernel and b.ndim == 3
                     else fused3d.residual_plain)
            for _ in range(self.refine):
                p = p + self._direct(resid(op, p, b))
        return p


def solve_with_residual(
    solver: DCTPoissonSolver, op: PoissonOp, b: torch.Tensor,
    diag_residual: bool = True, use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve and report (p, iters=1, relative residual) for diagnostics.

    As in the JAX package, the up-front ``b - mean(b)`` runs in 2D only
    (in 3D the direct application already projects the constant mode out),
    the residual is reported against the deflated RHS, normalized by
    ``||b||``, and ``diag_residual=False`` reports the sentinel -1.0.
    In 3D with ``use_kernel`` the reported residual is taken by the
    residual kernel too. Every returned value stays on the device.
    """
    from . import fused3d

    if solver.singular and b.ndim == 2:
        p = solver.solve(b - torch.mean(b), op, use_kernel)
    else:
        p = solver.solve(b, op, use_kernel)
    iters = torch.ones((), dtype=torch.int32, device=b.device)
    if not diag_residual:
        return p, iters, torch.full((), -1.0, dtype=b.dtype, device=b.device)
    bd = b - torch.mean(b) if solver.singular else b
    bnorm = torch.sqrt(torch.sum(b * b))
    tiny = float(np.finfo(np.float32).tiny)
    if use_kernel and b.ndim == 3:
        r = fused3d.residual_3d(op, p, bd)
        rnorm = torch.sqrt(torch.sum(r * r))
    else:
        rnorm = residual_norm(op, p, bd)
    return p, iters, rnorm / torch.clamp_min(bnorm, tiny)
