"""Spectral (DCT) pressure Poisson solvers (PyTorch): the direct solve and
the capacitance-corrected DCT-preconditioned solve for obstacles.

Counterpart of ``DCTPoissonSolver``, ``solve_with_residual`` and the
single-device parts of ``DCTPCGSolver`` in
``navierstokessolver_tpu/ops/fft_poisson.py``, matmul mode.

Direct solve. Without an interior obstacle the discrete Laplacian
diagonalizes under one transform per axis, chosen from the axis's BCs
(:func:`axis_kinds_from_bcs`): DCT-II on Neumann/Neumann axes (walls,
inflow, slip), DCT-IV on an axis with one outflow face, DST-II with two,
the orthonormal circulant eigenbasis on a periodic axis (dense below
1024, the symmetric-fold split ``CircSplitPlan`` from 1024 on, as the JAX
solver picks it).
The solve is exact in one application: forward transform per axis,
multiply by the inverse eigenvalue sums, inverse transform. One
refinement pass ``p += direct(b - A p)`` follows, its residual taken by
the fused residual kernel in 3D (ops/fused3d.residual_3d).

``dctcg`` (:class:`DCTPCGSolver`). An interior obstacle perturbs the
unmasked operator U only through its cut links (fluid-solid face pairs).
With one Woodbury column per cut link (and one pin per solid component)
the capacitance matrix ``C = I + W^T U^-1 W`` is built once and inverted
in float64; each preconditioner application is then the masked inverse
up to float32 roundoff, and preconditioned Richardson sweeps
``p += M (b - A p)`` converge in one or two sweeps a step. Without a
capacitance correction (no obstacle, or a singular unmasked operator) the
plain spectral inverse preconditions flexible CG.

The chain's transforms and the fused route's axis-0 transforms are plain
GEMMs (``torch.matmul``), as the JAX package left them to XLA outside any
kernel. They run in full float32: callers that time them on a GPU keep
``torch.backends.cuda.matmul.allow_tf32`` False. The JAX package's
``precision`` settings count bf16 passes of the TPU's matrix unit; on the
card they have a meaning in the fused route's kernel only (below).

Each DCT-II axis of n >= 1024 runs the radix-split transform chain that
the JAX solver picks (:func:`auto_split_levels`), each DCT-IV axis of n >=
512 its one-level split, each periodic axis of n >= 1024 its symmetric
fold, in block order. The multiplier ``inv_eig`` is
stored in natural axis order, each axis permuted to its plan's block
order. (The JAX solver stores it axis-reversed because its tensordot chain
leaves the spectrum that way; convert.dct_solver_from_numpy undoes that
layout.)

The fused trailing-axes route (``fuse_trailing``, 3D, off by default as in
the JAX package): the axis-0 transform as one GEMM, then both trailing
axes and the spectral multiply in one call of ops/trailing_dct.py's
kernel, and the same for the inverse: four passes over the field instead
of six. Its per-axis matrices are the plans applied to an identity, in
the plans' block order, and ``inv_eig`` is the multiplier as it is. The
kernel computes the JAX kernel's bf16 split products: ``precision="high"``
(the default) 3 passes, ``"default"`` 1 pass; ``"highest"`` keeps the
chain, as JAX's ``_fused3d_route_ok`` does. The main solve runs at
``precision``, each refinement solve at ``refine_precision``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..bcs import BCKind, BCTable
from ..grid import GridSpec
from . import dct as dct_mod
from . import trailing_dct
from .poisson import (
    TINY, PoissonOp, apply_A, deflate, device_while, flexible_pcg,
    residual_norm,
)


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


def _eigenvalues(kind: str, n: int, h: float) -> np.ndarray:
    """The axis's eigenvalues, in its basis's order (Q-column order for
    'per')."""
    if kind == "per":
        return dct_mod.circulant_eigenbasis(n, h)[1]
    if kind == "nn":
        return dct_mod.neumann_eigenvalues(n, h)
    if kind in ("nd", "dn"):
        return dct_mod.mixed_nd_eigenvalues(n, h)
    return dct_mod.dirichlet_eigenvalues(n, h)


def _plan(kind: str, n: int, split_levels: Optional[int], dtype, device):
    """The JAX solver's plan choice for one axis."""
    if kind == "per":
        # the symmetric fold halves the GEMM work at the DCT split's scale
        if n >= 1024 and n % 2 == 0:
            return dct_mod.CircSplitPlan(n, dtype, device)
        q = dct_mod.circulant_eigenbasis(n, 1.0)[0]
        return dct_mod.SplitPlan.dense(q.T, q, dtype, device)
    if kind in ("nd", "dn"):
        # one-level even-odd split from 512 on
        if n % 2 == 0 and n >= 512:
            return dct_mod.Dct4SplitPlan(n, dtype, device,
                                         flipped=(kind == "dn"))
        c = dct_mod.dct4_matrix(n)
        if kind == "dn":
            c = c[:, ::-1]
        return dct_mod.SplitPlan.dense(c, c.T, dtype, device)
    if kind == "dd":
        c = dct_mod.dst2_matrix(n)
        return dct_mod.SplitPlan.dense(c, c.T, dtype, device)
    lv = auto_split_levels(n) if split_levels is None else split_levels
    return dct_mod.SplitPlan.build(n, lv, dtype, device)


@dataclasses.dataclass(eq=False)
class DCTPoissonSolver:
    """Precomputed inverse-eigenvalue tensor and per-axis transform plans.

    ``precision`` and ``refine_precision`` are the JAX package's MXU pass
    counts for the transforms, of the main solve and of each refinement
    solve. On the card they have a meaning on the fused trailing-axes
    route only (``fuse_trailing``): its kernel computes ``"high"`` as 3
    bf16 passes and ``"default"`` as 1, and ``"highest"`` keeps the chain.
    Every other GEMM runs in full float32.
    """

    grid: GridSpec
    inv_eig: torch.Tensor  # 1/(sum_a lambda_a(k_a)), 0 at a constant mode
    plans: tuple = ()      # dct.SplitPlan | Dct4SplitPlan | CircSplitPlan
    precision: str = "high"
    refine: int = 1
    refine_precision: str = "high"
    kinds: tuple[str, ...] = ()
    # the fused trailing-axes route (3D): off by default, as in JAX
    fuse_trailing: bool = False

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
        of every 'nn' axis; None picks :func:`auto_split_levels` per
        axis."""
        kinds = tuple(kinds or ("nn",) * grid.ndim)
        total = np.zeros(grid.shape, dtype=np.float64)
        for a, (n, h) in enumerate(zip(grid.shape, grid.spacing)):
            shape = [1] * grid.ndim
            shape[a] = n
            total = total + _eigenvalues(kinds[a], n, h).reshape(shape)
        inv = np.zeros_like(total)
        nz = total != 0.0
        inv[nz] = 1.0 / total[nz]  # constant mode pinned to 0 (deflation)
        plans = []
        for a, n in enumerate(grid.shape):
            plan = _plan(kinds[a], n, split_levels, grid.dtype, device)
            plans.append(plan)
            # block order along this axis, so the runtime never interleaves
            inv = np.take(inv, plan.permutation(), axis=a)
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
        eigenmodes of each axis's kind with analytic eigenvalues, so
        solve(sum c lam_m p_m) == sum c p_m exactly in exact arithmetic)."""
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
                kind = self.kinds[a]
                if kind == "per":
                    theta = 2.0 * np.pi * k / n
                    basis = np.cos(2.0 * np.pi * k * i / n)
                elif kind == "nn":
                    theta = np.pi * k / n
                    basis = np.cos(np.pi * k * (i + 0.5) / n)
                elif kind in ("nd", "dn"):
                    theta = np.pi * (2 * k + 1) / (2 * n)
                    j = i if kind == "nd" else (n - 1 - i)
                    basis = np.cos(theta * (j + 0.5))
                else:  # "dd"
                    theta = np.pi * (k + 1) / n
                    basis = np.sin(theta * (i + 0.5))
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
        if self.singular:
            p -= p.mean()
            got = got - got.mean()
        denom = float(np.linalg.norm(p.ravel())) or 1.0
        return float(np.linalg.norm((got - p).ravel())) / denom

    def _fwd(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """The forward chain (axis ``a`` of the grid is axis ``a + offset``
        of ``x``, leading axes batch): a block-order spectrum, axes in
        natural order."""
        for a, plan in enumerate(self.plans):
            x = plan.fwd(x, a + offset)
        return x

    def _inv(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """The inverse chain (the JAX ``_inv`` order: last axis first)."""
        for a in range(self.grid.ndim - 1, -1, -1):
            x = self.plans[a].inv(x, a + offset)
        return x

    def axis_matrices(self, a: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The axis-``a`` transform as explicit matrices, by running the
        plan over an identity: F (n_spec, n_real) forward in the plan's
        block order, V (n_real, n_spec) inverse."""
        plan = self.plans[a]
        eye = torch.eye(self.grid.shape[a], dtype=self.grid.dtype,
                        device=self.inv_eig.device)
        return plan.fwd(eye, 0), plan.inv(eye, 0)

    @functools.cached_property
    def _fused3d_consts(self) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
        """Each axis's (F, V) for the fused route, built once on the
        solver's device."""
        return tuple(self.axis_matrices(a) for a in range(self.grid.ndim))

    @functools.cached_property
    def _fused3d_split(self) -> tuple[tuple[trailing_dct.Split, ...], ...]:
        """Axes 1 and 2's (F, V) split once into bf16 hi/lo for the fused
        route's kernel (trailing_dct.split_matrix)."""
        return tuple(tuple(trailing_dct.split_matrix(m) for m in fv)
                     for fv in self._fused3d_consts[1:])

    def _fused3d_route_ok(self, precision: Optional[str] = None) -> bool:
        """The fused trailing-axes route: asked for, a 3D float32 grid, not
        at 'highest' (the chain, as in JAX), and a shape the kernel's gate
        admits (trailing_dct.applicable)."""
        return (self.fuse_trailing and self.grid.ndim == 3
                and self.grid.dtype == torch.float32
                and (precision or self.precision) != "highest"
                and trailing_dct.applicable(self.grid.shape))

    def _direct_fused3d(self, b: torch.Tensor, passes: int,
                        use_kernel: bool = True) -> torch.Tensor:
        """The direct solve in four passes: the axis-0 forward GEMM, the
        fused trailing forward with the multiplier, the axis-0 inverse
        GEMM, the fused trailing inverse (the JAX ``_direct_fused3d``), the
        trailing pairs at ``passes`` bf16 passes; ``use_kernel`` False:
        through the kernel's plain version."""
        (f0, v0) = self._fused3d_consts[0]
        (f1, v1), (f2, v2) = self._fused3d_split
        trail = (trailing_dct.fused_trailing if use_kernel
                 else trailing_dct.fused_trailing_plain)
        n0, n1, n2 = self.grid.shape
        t = (f0 @ b.reshape(n0, n1 * n2)).reshape(n0, n1, n2)
        that = trail(t, f1, f2, self.inv_eig, passes)
        z = (v0 @ that.reshape(n0, n1 * n2)).reshape(n0, n1, n2)
        return trail(z, v1, v2, None, passes)

    def _direct(self, b: torch.Tensor, offset: int = 0,
                use_kernel: bool = True,
                precision: Optional[str] = None) -> torch.Tensor:
        """One application of the diagonalized inverse Laplacian (to a
        batch along the ``offset`` leading axes) at ``precision`` (None:
        the solver's); the fused route when ``fuse_trailing`` is set and
        applies at that precision (``use_kernel`` False: its plain
        version), else the chain."""
        prec = precision or self.precision
        if offset == 0 and self._fused3d_route_ok(prec):
            return self._direct_fused3d(b, trailing_dct.PASSES[prec],
                                        use_kernel)
        return self._inv(self._fwd(b, offset) * self.inv_eig, offset)

    def solve(
        self, b: torch.Tensor, op: Optional[PoissonOp] = None,
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Solve ``lap p = b`` (mean-zero branch), then ``refine`` passes of
        ``p += direct(b - A p)`` at ``refine_precision`` (the JAX
        ``solve``). ``use_kernel``: take the residual through
        ops/fused3d.residual_3d (3D) and, with ``fuse_trailing``, the
        trailing transforms through kernel 12; False: their plain
        versions."""
        from . import fused3d

        p = self._direct(b, use_kernel=use_kernel)
        if self.refine and op is not None:
            resid = (fused3d.residual_3d if use_kernel and b.ndim == 3
                     else fused3d.residual_plain)
            for _ in range(self.refine):
                p = p + self._direct(resid(op, p, b), use_kernel=use_kernel,
                                     precision=self.refine_precision)
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
    With a Dirichlet (outflow) axis nothing is deflated. In 3D with
    ``use_kernel`` the reported residual is taken by the residual kernel
    too. Every returned value stays on the device.
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
    if use_kernel and b.ndim == 3:
        r = fused3d.residual_3d(op, p, bd)
        rnorm = torch.sqrt(torch.sum(r * r))
    else:
        rnorm = residual_norm(op, p, bd)
    return p, iters, rnorm / torch.clamp_min(bnorm, TINY)


@dataclasses.dataclass(eq=False)
class DCTPCGSolver:
    """The DCT-preconditioned solve for obstacle topologies (method
    ``dctcg``), single device.

    With a capacitance correction (an obstacle and a nonsingular unmasked
    operator, i.e. an outflow face) each preconditioner application is

        z = U^-1 r - U^-1 W C^-1 W^T U^-1 r

    W has one column ``sqrt(w_a) (e_i - e_s)`` per cut link between fluid
    cell i and solid cell s, and one ``sqrt(alpha) e_pin`` per connected
    solid component; ``cap_va``/``cap_vb`` are the column entries at the
    link endpoints ``cap_idx_a``/``cap_idx_b`` (flat indices).

    In 2D the Woodbury term runs inside the transform chain (the JAX 2D
    spectral-domain path): one forward and one inverse chain plus two thin
    point-GEMMs, from the link-point rows of each axis's inverse transform
    (``cap_vx``, ``cap_vy``: (2K, n_a)) and columns of its forward transform
    (``cap_fx``, ``cap_fy``: (n_a, 2K)), in the plans' block order. In 3D
    it is JAX's generic path: two spectral solves around the contraction
    with W dense over the links' bounding box (``cap_wbox``: (K, *box),
    the box's first cell ``cap_origin``).
    """

    dct: DCTPoissonSolver
    cap_cinv: Optional[torch.Tensor] = None    # (K, K) inverse capacitance
    cap_va: Optional[torch.Tensor] = None      # (K,) +entry values
    cap_vb: Optional[torch.Tensor] = None      # (K,) -entry values
    cap_vx: Optional[torch.Tensor] = None      # (2K, n0) inverse rows at x_p
    cap_vy: Optional[torch.Tensor] = None      # (2K, n1) inverse rows at y_p
    cap_fx: Optional[torch.Tensor] = None      # (n0, 2K) forward cols at x_p
    cap_fy: Optional[torch.Tensor] = None      # (n1, 2K) forward cols at y_p
    cap_idx_a: Optional[np.ndarray] = None     # (K,) flat link endpoints
    cap_idx_b: Optional[np.ndarray] = None
    cap_wbox: Optional[torch.Tensor] = None    # (K, *box) W over the box
    cap_origin: Optional[tuple[int, ...]] = None  # the box's first cell

    @staticmethod
    def build(
        grid: GridSpec,
        bcs: BCTable,
        device,
        solid: Optional[np.ndarray] = None,
    ) -> "DCTPCGSolver":
        """The direct solver of the unmasked operator (no refinement) and,
        with an obstacle and a nonsingular operator, the capacitance
        correction on ``device`` (2D: the spectral-domain arrays; 3D: W
        over the links' bounding box)."""
        kinds = axis_kinds_from_bcs(grid, bcs)
        dct = DCTPoissonSolver.build(grid, device, refine=0, kinds=kinds)
        have_solid = solid is not None and bool(np.any(solid))
        s = DCTPCGSolver(dct=dct)
        if have_solid and not dct.singular:
            s._build_capacitance(grid, np.asarray(solid, bool))
            if grid.ndim == 2:
                s._build_spectral_correction(grid)
            else:
                s._build_box(grid)
        return s

    @property
    def _device(self) -> torch.device:
        return self.dct.inv_eig.device

    def _build_spectral_correction(self, grid: GridSpec) -> None:
        pts_a = np.unravel_index(self.cap_idx_a, grid.shape)
        pts_b = np.unravel_index(self.cap_idx_b, grid.shape)
        dev = self._device
        xs = torch.as_tensor(np.concatenate([pts_a[0], pts_b[0]]), device=dev)
        ys = torch.as_tensor(np.concatenate([pts_a[1], pts_b[1]]), device=dev)
        f0, v0 = self.dct.axis_matrices(0)
        f1, v1 = self.dct.axis_matrices(1)
        self.cap_vx = v0[xs, :].contiguous()
        self.cap_vy = v1[ys, :].contiguous()
        self.cap_fx = f0[:, xs].contiguous()
        self.cap_fy = f1[:, ys].contiguous()

    def _build_box(self, grid: GridSpec) -> None:
        """W dense over the bounding box of the links' endpoints (JAX's
        ``cap_wbox`` and ``cap_origin``): K x |box| floats, a few obstacle
        diameters a side for a compact obstacle."""
        ia, ib = self.cap_idx_a, self.cap_idx_b
        pts = np.stack(np.unravel_index(np.concatenate([ia, ib]),
                                        grid.shape), axis=1)
        lo = pts.min(axis=0)
        box = tuple(int(h - l) for l, h in zip(lo, pts.max(axis=0) + 1))
        k_all = ia.shape[0]
        wbox = np.zeros((k_all,) + box, np.float64)
        ks = np.arange(k_all)
        aa = np.unravel_index(ia, grid.shape)
        bb = np.unravel_index(ib, grid.shape)
        va = self.cap_va.double().cpu().numpy()
        vb = self.cap_vb.double().cpu().numpy()
        wbox[(ks,) + tuple(a - o for a, o in zip(aa, lo))] += va
        np.add.at(wbox, (ks,) + tuple(b - o for b, o in zip(bb, lo)), vb)
        self.cap_origin = tuple(int(o) for o in lo)
        self.cap_wbox = torch.as_tensor(wbox, dtype=grid.dtype).to(
            self._device)

    def _build_capacitance(self, grid: GridSpec, solid: np.ndarray) -> None:
        """The cut links and pins (the JAX build's numpy, copied; any
        rank), then ``C = I + W^T U^-1 W`` from K spectral solves on the
        device in batches of the JAX chunk size, assembled and inverted on
        the host in float64."""
        from scipy import ndimage

        fluid = np.logical_not(solid)
        nd = grid.ndim
        idx_a, idx_b, val = [], [], []
        flat = np.arange(int(np.prod(grid.shape))).reshape(grid.shape)
        for a in range(nd):
            w = 1.0 / (grid.spacing[a] ** 2)
            lo = [slice(None)] * nd
            hi = [slice(None)] * nd
            lo[a] = slice(0, -1)
            hi[a] = slice(1, None)
            lo, hi = tuple(lo), tuple(hi)
            cut = fluid[lo] & solid[hi]      # fluid i | solid i+1
            cut_r = solid[lo] & fluid[hi]    # solid i | fluid i+1
            for fi, si in ((flat[lo][cut], flat[hi][cut]),
                           (flat[hi][cut_r], flat[lo][cut_r])):
                idx_a.append(fi)
                idx_b.append(si)
                val.append(np.full(fi.shape, np.sqrt(w)))
        idx_a = np.concatenate(idx_a)
        idx_b = np.concatenate(idx_b)
        val_a = np.concatenate(val)
        val_b = -val_a
        # one pin column per connected solid component: the embedded solid
        # block is an interior Neumann problem whose constant mode the pin
        # shifts, so C stays invertible
        labels, ncomp = ndimage.label(solid)
        alpha = max(1.0 / (h * h) for h in grid.spacing)
        for c in range(1, ncomp + 1):
            pin = int(flat[labels == c].ravel()[0])
            idx_a = np.append(idx_a, pin)
            idx_b = np.append(idx_b, pin)  # unused (val_b = 0)
            val_a = np.append(val_a, np.sqrt(alpha))
            val_b = np.append(val_b, 0.0)
        k_all = idx_a.shape[0]

        self.cap_idx_a = idx_a
        self.cap_idx_b = idx_b
        dev, dtype = self._device, grid.dtype
        ia = torch.as_tensor(idx_a, device=dev)
        ib = torch.as_tensor(idx_b, device=dev)
        va = torch.as_tensor(val_a, dtype=dtype).to(dev)
        vb = torch.as_tensor(val_b, dtype=dtype).to(dev)
        n_cells = int(np.prod(grid.shape))
        chunk = max(1, min(16, (64 * 1024 * 1024) // (4 * n_cells)))
        blocks = []
        for i0 in range(0, k_all, chunk):
            k = min(chunk, k_all - i0)
            rows = torch.arange(k, device=dev)
            cols = torch.zeros((k, n_cells), dtype=dtype, device=dev)
            cols.index_put_((rows, ia[i0:i0 + k]), va[i0:i0 + k],
                            accumulate=True)
            cols.index_put_((rows, ib[i0:i0 + k]), vb[i0:i0 + k],
                            accumulate=True)
            ys = self.dct._direct(cols.reshape((k, *grid.shape)), 1)
            ys = ys.reshape(k, n_cells)
            # (W^T y)[j] = va[j] y[ia[j]] + vb[j] y[ib[j]], row = column i
            blocks.append((ys[:, ia] * va + ys[:, ib] * vb).double().cpu())
        wtuw = torch.cat(blocks).numpy()
        cinv = np.linalg.inv(np.eye(k_all, dtype=np.float64) + wtuw)
        self.cap_cinv = torch.as_tensor(cinv, dtype=dtype).to(dev)
        self.cap_va = va
        self.cap_vb = vb

    def _precond_apply(self, r: torch.Tensor,
                       fluid: torch.Tensor) -> torch.Tensor:
        """One application of the (capacitance-corrected) unmasked
        inverse, masked to the fluid."""
        dct = self.dct
        if self.cap_cinv is None:
            return dct._direct(r) * fluid
        if self.cap_wbox is not None:
            return self._precond_box(r, fluid)
        k = self.cap_va.shape[0]
        va, vb = self.cap_va, self.cap_vb
        # sample and re-inject the Woodbury term inside the transform
        # chain. that is (k0, k1); JAX holds it as (k1, k0) and contracts
        # the other axis first.
        that = dct._fwd(r) * dct.inv_eig
        zp = torch.sum((self.cap_vx @ that) * self.cap_vy, dim=1)
        h = self.cap_cinv @ (va * zp[:k] + vb * zp[k:])
        c = torch.cat([va * h, vb * h])
        shat = (self.cap_fx * c) @ self.cap_fy.T
        return dct._inv(that - dct.inv_eig * shat) * fluid

    def _precond_box(self, r: torch.Tensor,
                     fluid: torch.Tensor) -> torch.Tensor:
        """JAX's generic (3D) path: two spectral solves around the
        dense-box contractions, ``z = U^-1 r - U^-1 W C^-1 W^T U^-1 r``,
        masked to the fluid."""
        dct = self.dct
        z = dct._direct(r)
        k = self.cap_wbox.shape[0]
        box = self.cap_wbox.shape[1:]
        at = tuple(slice(o, o + n) for o, n in zip(self.cap_origin, box))
        wflat = self.cap_wbox.reshape(k, -1)
        g = wflat @ z[at].reshape(-1)          # W^T U^-1 r   (K,)
        h = self.cap_cinv @ g                  # C^-1 g       (K,)
        src = torch.zeros_like(z)
        src[at] = (h @ wflat).reshape(box)     # W h, dense over the box
        return (z - dct._direct(src)) * fluid

    def solve(
        self, b: torch.Tensor, p0: torch.Tensor, tol, max_iters: int,
        op: PoissonOp,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Solve ``A p = b`` from ``p0``; (p, iters, final relative
        residual) as device tensors. With the capacitance correction:
        preconditioned Richardson; without: flexible CG around the plain
        spectral inverse. One host check per iteration."""
        if self.cap_cinv is not None:
            return self._solve_richardson(b, p0, tol, max_iters, op)
        fluid = op.fluid

        def precond(r):
            # the negated system wants (-A)^-1 r = -(A^-1 r)
            z = -self._precond_apply(r, fluid)
            return deflate(op, z) if op.singular else z

        return flexible_pcg(op, b, p0, tol, max_iters, precond, block=1)

    def _solve_richardson(
        self, b: torch.Tensor, p0: torch.Tensor, tol, max_iters: int,
        op: PoissonOp,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Preconditioned Richardson ``p += M (b - A p)``, the JAX stopping
        rules: relative L2 residual <= tol, the iteration cap, and the
        stagnation bail (stop once a sweep fails to cut the residual below
        0.9 of the previous one). The first sweep runs before the loop, so
        the count starts at 1 (a warm start already at tol still pays one
        sweep)."""
        fluid = op.fluid
        b = b * fluid
        p0 = p0 * fluid
        inv_bnorm = 1.0 / torch.clamp_min(torch.sqrt(torch.sum(b * b)), TINY)

        def resid(p):
            return (b - apply_A(op, p)) * fluid

        def norm(r):
            return torch.sqrt(torch.sum(r * r)) * inv_bnorm

        r0 = resid(p0)
        res0 = norm(r0)
        p1 = p0 + self._precond_apply(r0, fluid)
        r1 = resid(p1)
        res1 = norm(r1)

        def cond(carry):
            _, _, k, res, prev = carry
            return (k < max_iters) & (res > tol) & (res < 0.9 * prev)

        def body(carry):
            p, r, k, res, _ = carry
            p = p + self._precond_apply(r, fluid)
            r = resid(p)
            return p, r, k + 1, norm(r), res

        k1 = torch.ones((), dtype=torch.int32, device=b.device)
        p, _, iters, res, _ = device_while(cond, body,
                                           (p1, r1, k1, res1, res0), 1)
        return p, iters, res
