"""Transform plans for the direct spectral pressure solve: the DCT-II
(dense and radix-split), the mixed-BC bases (DCT-IV, dense and split
once; DST-II) and the periodic (circulant) eigenbasis (dense, and split
by its symmetric fold: :class:`CircSplitPlan`).

Counterpart of the matrix half of ``navierstokessolver_tpu/ops/dct.py``
(numpy builders copied as they are). Every plan has ``fwd(x, axis)``,
``inv(x, axis)`` and ``permutation()`` (its block order). DCT-II
conventions (unnormalized, matching scipy.fft.dct type 2):

  DCT2(x)_k = 2 * sum_i x_i cos(pi k (2i+1) / (2n)),  idct2 its exact inverse.

Radix split (the JAX module's derivation, exact at every level): fold the
input, ``g_j = x_j + x_{n-1-j}`` and ``d_j = x_j - x_{n-1-j}`` (j < m = n/2);
then the even outputs are ``DCT2_m(g)`` (which recurses) and the odd ones
``D d``, ``D[r,j] = 2 cos(pi (2r+1)(2j+1) / (4m))``, with ``D^-1 = D^T/(2m)``.
Each level halves the GEMM work and every factor is bounded by 2. Outputs
come in BLOCK order (``[evens; odds]`` recursively, see
:func:`split_permutation`); the solver pre-permutes its spectral multiplier
to match, so the runtime never interleaves.

Every transform is applied with the port's :func:`apply_axis` convention:
axes stay in place, and each step along a leading, trailing or middle axis
is one GEMM or one batched GEMM (``torch.matmul``), as the JAX package
left these matmuls to XLA outside any kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def dct2_matrix(n: int) -> np.ndarray:
    """Dense DCT-II matrix: X = C @ x, C[k,i] = 2 cos(pi k (2i+1)/(2n))."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * i + 1) / (2 * n))


def idct2_matrix(n: int) -> np.ndarray:
    """Dense inverse: x = M @ X, M[i,k] = (1/n) * (1/2 if k==0 else cos(...))."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) / n
    m[:, 0] = 0.5 / n
    return m


def dct4_matrix_scaled(n: int) -> np.ndarray:
    """D[r, j] = 2 cos(pi (2r+1)(2j+1) / (4n)) (twice the DCT-IV matrix)."""
    r = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (2 * r + 1) * (2 * j + 1) / (4 * n))


def neumann_eigenvalues(n: int, h: float) -> np.ndarray:
    """Eigenvalues of the 1D cell-centered Neumann Laplacian under DCT-II:
    lambda_k = -(4/h^2) sin^2(pi k / (2n))."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * k / (2 * n)) ** 2


def split_levels(n: int, min_base: int = 512) -> int:
    """Levels of radix splitting: halve while even and the base matmul stays
    at least ``min_base`` wide."""
    lev = 0
    while n % 2 == 0 and n // 2 >= min_base:
        n //= 2
        lev += 1
    return lev


def split_permutation(n: int, levels: int) -> np.ndarray:
    """``perm`` such that block-order output[k'] = natural-order X[perm[k']]."""
    if levels == 0:
        return np.arange(n)
    m = n // 2
    sub = split_permutation(m, levels - 1)
    return np.concatenate([2 * sub, 2 * np.arange(m) + 1])


class SplitPlan:
    """The DCT-II factors of one axis: ``d4[l]`` (and ``d4inv[l]``) for each
    split level l, and the dense base pair at the last level. With no
    levels it is one dense forward and one dense inverse matrix."""

    def __init__(self, d4: Sequence[np.ndarray], base_fwd: np.ndarray,
                 base_inv: np.ndarray, dtype, device):
        """From the factor matrices, e.g. a JAX plan's ``d4``, ``base_fwd``
        and ``base_inv``. ``d4inv = d4^T / (2m)`` is formed in float32 from
        the float32 ``d4``, as the JAX plan forms it, so both packages hold
        the same bits."""
        d4 = [np.asarray(x, np.float32) for x in d4]
        self.levels = len(d4)
        self.n = np.asarray(base_fwd).shape[0] << self.levels

        def dev(m):
            return torch.tensor(np.ascontiguousarray(m), dtype=dtype,
                                device=device)

        self.d4 = [dev(x) for x in d4]
        self.d4inv = [dev(x.T / np.float32(2 * x.shape[0])) for x in d4]
        self.base_fwd = dev(base_fwd)
        self.base_inv = dev(base_inv)

    @staticmethod
    def build(n: int, levels: int, dtype, device) -> "SplitPlan":
        """The ``levels``-level plan of a length-``n`` DCT-II."""
        if levels < 0 or n % (1 << levels):
            raise ValueError(f"cannot split n={n} into {levels} levels")
        d4 = []
        m = n
        for _ in range(levels):
            m //= 2
            d4.append(dct4_matrix_scaled(m))
        return SplitPlan(d4, dct2_matrix(m), idct2_matrix(m), dtype, device)

    @staticmethod
    def dense(fwd: np.ndarray, inv: np.ndarray, dtype, device) -> "SplitPlan":
        """One dense forward and one dense inverse matrix (the JAX
        ``DensePlan``: the mixed-BC bases below 512, and DST-II axes)."""
        return SplitPlan([], fwd, inv, dtype, device)

    def permutation(self) -> np.ndarray:
        return split_permutation(self.n, self.levels)

    def fwd(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        return split_dct_apply(self, x, axis)

    def inv(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        return split_idct_apply(self, x, axis)


def apply_axis(m: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """``y = m`` applied along ``axis`` of ``x`` (``y_k = sum_i m[k,i] x_i``),
    axes kept in place. The leading axis is one GEMM, the trailing axis
    one GEMM against ``m.T``, a middle axis one batched GEMM; none of them
    copies ``x`` into another layout."""
    shape = x.shape
    n = shape[axis]
    pre = 1
    for s in shape[:axis]:
        pre *= s
    post = x.numel() // (pre * n)
    if post == 1:
        return (x.reshape(pre, n) @ m.T).reshape(shape)
    if pre == 1:
        return (m @ x.reshape(n, post)).reshape(shape)
    return torch.matmul(m, x.reshape(pre, n, post)).reshape(shape)


def split_dct_apply(plan: SplitPlan, x: torch.Tensor, axis: int,
                    level: int = 0) -> torch.Tensor:
    """DCT-II along ``axis`` in block order (the JAX function with
    ``block_order=True``, the axis kept in place)."""
    if level == plan.levels:
        return apply_axis(plan.base_fwd, x, axis)
    m = x.shape[axis] // 2
    xf = x.narrow(axis, 0, m)
    xr = x.narrow(axis, m, m).flip(axis)
    g = split_dct_apply(plan, xf + xr, axis, level + 1)
    h = apply_axis(plan.d4[level], xf - xr, axis)
    return torch.cat([g, h], dim=axis)


def split_idct_apply(plan: SplitPlan, x: torch.Tensor, axis: int,
                     level: int = 0) -> torch.Tensor:
    """Exact inverse of :func:`split_dct_apply`: block-order input,
    natural order out."""
    if level == plan.levels:
        return apply_axis(plan.base_inv, x, axis)
    m = x.shape[axis] // 2
    g = split_idct_apply(plan, x.narrow(axis, 0, m), axis, level + 1)
    dd = apply_axis(plan.d4inv[level], x.narrow(axis, m, m), axis)
    return torch.cat([0.5 * (g + dd), (0.5 * (g - dd)).flip(axis)], dim=axis)


# -- mixed-BC bases -------------------------------------------------------------
# ops/poisson.py discretizes an outflow (pressure-Dirichlet) face as ghost =
# -edge and a wall, inflow or slip face as ghost = edge, so the cell-centred
# 1D second difference diagonalizes exactly under
#   Neumann/Neumann 'nn' DCT-II, Neumann/Dirichlet 'nd' DCT-IV,
#   Dirichlet/Neumann 'dn' index-flipped DCT-IV, Dirichlet/Dirichlet 'dd'
#   DST-II
# (the JAX module's mixed-BC section, its numpy copied as it is).


def dct4_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-IV: C[k,i] = sqrt(2/n) cos(pi(2k+1)(2i+1)/(4n)),
    symmetric and its own inverse; rows are the 'nd' eigenvectors."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return np.sqrt(2.0 / n) * np.cos(
        np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n)
    )


def dst2_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-II: S[k,i] ~ sin(pi(k+1)(2i+1)/(2n)), the last row
    weighted 1/sqrt(n); its inverse is the transpose."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (k + 1) * (2 * i + 1) / (2 * n))
    scale = np.full((n, 1), np.sqrt(2.0 / n))
    scale[n - 1, 0] = np.sqrt(1.0 / n)
    return scale * m


def mixed_nd_eigenvalues(n: int, h: float) -> np.ndarray:
    """'nd' (and 'dn') eigenvalues under the DCT-IV:
    lambda_k = -(4/h^2) sin^2(pi (2k+1) / (4n)), all nonzero."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * (2 * k + 1) / (4 * n)) ** 2


def dirichlet_eigenvalues(n: int, h: float) -> np.ndarray:
    """'dd' eigenvalues under the DST-II:
    lambda_k = -(4/h^2) sin^2(pi (k+1) / (2n))."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * (k + 1) / (2 * n)) ** 2


def circulant_eigenbasis(n: int, h: float) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal real eigenbasis Q and eigenvalues of the periodic
    (circulant) 1D second-difference operator on n cells (the JAX
    function, copied as it is).

    Columns: constant, then (cos, sin) pairs at wavenumbers k = 1..n/2-1,
    then the Nyquist alternating mode (n even). Eigenvalues
    ``lambda_k = -(4/h^2) sin^2(pi k / n)``. Forward transform = Q^T x.
    """
    if n % 2:
        raise ValueError("periodic axis extent must be even")
    j = np.arange(n)
    cols = [np.full(n, 1.0 / np.sqrt(n))]
    lam = [0.0]
    s = np.sqrt(2.0 / n)
    for k in range(1, n // 2):
        lk = -(4.0 / (h * h)) * np.sin(np.pi * k / n) ** 2
        cols.append(s * np.cos(2.0 * np.pi * k * j / n))
        lam.append(lk)
        cols.append(s * np.sin(2.0 * np.pi * k * j / n))
        lam.append(lk)
    cols.append(((-1.0) ** j) / np.sqrt(n))
    lam.append(-(4.0 / (h * h)))
    Q = np.stack(cols, axis=1)
    return Q, np.asarray(lam)


def _along(v: torch.Tensor, nd: int, axis: int) -> torch.Tensor:
    shape = [1] * nd
    shape[axis] = v.shape[0]
    return v.reshape(shape)


class Dct4SplitPlan:
    """One-level even-odd butterfly of the orthonormal DCT-IV along one
    axis (the JAX ``Dct4SplitPlan``): with m = n/2, phi_j = pi(2j+1)/(4n),
    u_j = x_j, w_j = x_{n-1-j},

        a_j = u_j cos(phi_j) + w_j sin(phi_j)
        b_j = w_j cos(phi_j) - u_j sin(phi_j)
        A[r] = sum_j a_j cos(pi r (2j+1)/(2m))          (DCT-II_m)
        B[r] = sum_j b_j sin(pi r (2j+1)/(2m)), r=1..m  (DST-II_m)
        X[2r] = A[r] + B[r],  X[2r+1] = A[r+1] - B[r+1]  (A[m] == 0)

    Two m x m GEMMs instead of one n x n, every factor bounded by 1; the
    orthonormal scale sqrt(2/n) is folded into the rotation. Outputs in
    block order ``[evens; odds]`` (:meth:`permutation`); the inverse runs
    the same stages transposed. ``flipped``: the 'dn' axis (the forward
    flips its input, the inverse its output). Axes stay in place, as with
    :func:`apply_axis`."""

    levels = 1  # block-order output

    def __init__(self, n: int, dtype, device, flipped: bool = False):
        if n % 2:
            raise ValueError("DCT-IV split needs an even extent")
        m = n // 2
        self.n = n
        self.flipped = flipped
        phi = np.pi * (2 * np.arange(m) + 1) / (4 * n)
        s = np.sqrt(2.0 / n)
        r = np.arange(m)[:, None]
        j = np.arange(m)[None, :]
        c2 = np.cos(np.pi * r * (2 * j + 1) / (2 * m))
        dst = np.sin(np.pi * (r + 1) * (2 * j + 1) / (2 * m))

        def dev(x):
            return torch.tensor(np.asarray(x, np.float32), dtype=dtype,
                                device=device)

        self.cos = dev(s * np.cos(phi))
        self.sin = dev(s * np.sin(phi))
        self.c2 = dev(c2)
        self.dst = dev(dst)
        self.c2_t = dev(np.asarray(c2, np.float32).T)
        self.dst_t = dev(np.asarray(dst, np.float32).T)

    def permutation(self) -> np.ndarray:
        m = self.n // 2
        return np.concatenate([2 * np.arange(m), 2 * np.arange(m) + 1])

    def fwd(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        nd, m = x.ndim, self.n // 2
        if self.flipped:
            x = x.flip(axis)
        u = x.narrow(axis, 0, m)
        w = x.narrow(axis, m, m).flip(axis)
        c = _along(self.cos, nd, axis)
        s = _along(self.sin, nd, axis)
        a_ = apply_axis(self.c2, c * u + s * w, axis)
        b_ = apply_axis(self.dst, c * w - s * u, axis)
        zero = torch.zeros_like(a_.narrow(axis, 0, 1))
        e = a_ + torch.cat([zero, b_.narrow(axis, 0, m - 1)], dim=axis)
        o = torch.cat([a_.narrow(axis, 1, m - 1), zero], dim=axis) - b_
        return torch.cat([e, o], dim=axis)

    def inv(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        nd, m = x.ndim, self.n // 2
        e = x.narrow(axis, 0, m)
        o = x.narrow(axis, m, m)
        e0, et = e.narrow(axis, 0, 1), e.narrow(axis, 1, m - 1)
        oh, ol = o.narrow(axis, 0, m - 1), o.narrow(axis, m - 1, 1)
        a_ = apply_axis(self.c2_t, torch.cat([e0, et + oh], dim=axis), axis)
        b_ = apply_axis(self.dst_t, torch.cat([et - oh, -ol], dim=axis), axis)
        c = _along(self.cos, nd, axis)
        s = _along(self.sin, nd, axis)
        out = torch.cat([c * a_ - s * b_, (s * a_ + c * b_).flip(axis)],
                        dim=axis)
        return out.flip(axis) if self.flipped else out


class CircSplitPlan:
    """Symmetric-fold factorization of the circulant eigenbasis transform
    along one axis (the JAX ``CircSplitPlan``): the cos rows of ``Q^T``
    are symmetric under j -> n-j and the sin rows antisymmetric, so with
    m = n/2, ``g = [x_0, x_j + x_{n-j}, x_m]`` (j = 1..m-1) and
    ``d = [x_j - x_{n-j}]``, the forward transform is two half-size GEMMs,
    ``G = cf g`` and ``D = sf d``. Outputs in block order ``[c_0, c_1 ..
    c_{m-1}, nyquist, s_1 .. s_{m-1}]`` (:meth:`permutation` maps it to the
    natural eigen-column order). cf, sf and their inverses are formed in
    float64 numpy and stored in ``dtype``; the inverse runs the inverse
    factors and unfolds. Axes stay in place, as with :func:`apply_axis`."""

    levels = 1  # block-order output

    def __init__(self, n: int, dtype, device):
        if n % 2:
            raise ValueError("periodic axis extent must be even")
        m = n // 2
        self.n = n
        j_g = np.arange(m + 1)
        k_c = np.arange(1, m)
        s = np.sqrt(2.0 / n)
        cf = np.empty((m + 1, m + 1))
        cf[0, :] = 1.0 / np.sqrt(n)
        cf[1:m, :] = s * np.cos(2.0 * np.pi * k_c[:, None] * j_g[None, :] / n)
        cf[m, :] = ((-1.0) ** j_g) / np.sqrt(n)
        sf = s * np.sin(2.0 * np.pi * k_c[:, None] * np.arange(1, m)[None, :]
                        / n)

        def dev(x):
            return torch.tensor(np.asarray(x, np.float32), dtype=dtype,
                                device=device)

        self.cf = dev(cf)
        self.sf = dev(sf)
        self.cfi = dev(np.linalg.inv(cf))
        self.sfi = dev(np.linalg.inv(sf))

    def permutation(self) -> np.ndarray:
        """``block_output[k'] = natural[perm[k']]`` (natural: the
        :func:`circulant_eigenbasis` column order c0, c1, s1, ..., nyq)."""
        m = self.n // 2
        return np.concatenate([[0], 2 * np.arange(1, m) - 1, [self.n - 1],
                               2 * np.arange(1, m)])

    def fwd(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        m = self.n // 2
        xf = x.narrow(axis, 1, m - 1)
        xr = x.narrow(axis, m + 1, m - 1).flip(axis)
        g = torch.cat([x.narrow(axis, 0, 1), xf + xr, x.narrow(axis, m, 1)],
                      dim=axis)
        return torch.cat([apply_axis(self.cf, g, axis),
                          apply_axis(self.sf, xf - xr, axis)], dim=axis)

    def inv(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        m = self.n // 2
        g = apply_axis(self.cfi, x.narrow(axis, 0, m + 1), axis)
        d = apply_axis(self.sfi, x.narrow(axis, m + 1, m - 1), axis)
        mid = g.narrow(axis, 1, m - 1)
        return torch.cat([g.narrow(axis, 0, 1), 0.5 * (mid + d),
                          g.narrow(axis, m, 1), (0.5 * (mid - d)).flip(axis)],
                         dim=axis)
