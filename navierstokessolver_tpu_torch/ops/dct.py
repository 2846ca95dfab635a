"""Dense DCT-II matrices and plans for the direct spectral pressure solve.

Counterpart of the matrix half of ``navierstokessolver_tpu/ops/dct.py``
(numpy builders copied as they are). Conventions (unnormalized, matching
scipy.fft.dct type 2):

  DCT2(x)_k = 2 * sum_i x_i cos(pi k (2i+1) / (2n)),  idct2 its exact inverse.

Only level-0 plans are ported: the JAX solver splits a transform only for
n >= 1024, so every grid below that runs dense matmuls. The radix split is
queued (ROADMAP Queue A, "Split-level DCT for n >= 1024").
"""

from __future__ import annotations

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


def neumann_eigenvalues(n: int, h: float) -> np.ndarray:
    """Eigenvalues of the 1D cell-centered Neumann Laplacian under DCT-II:
    lambda_k = -(4/h^2) sin^2(pi k / (2n))."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * k / (2 * n)) ** 2


class DensePlan:
    """One dense forward and one dense inverse matrix for one axis."""

    levels = 0

    def __init__(self, fwd: np.ndarray, inv: np.ndarray, dtype, device):
        self.n = fwd.shape[0]
        self.base_fwd = torch.tensor(np.asarray(fwd), dtype=dtype, device=device)
        self.base_inv = torch.tensor(np.asarray(inv), dtype=dtype, device=device)


class SplitPlan(DensePlan):
    """The DCT-II plan of one axis. ``levels=0`` (all that n < 1024 uses)
    is the dense matrix pair."""

    def __init__(self, n: int, levels: int, dtype, device):
        if levels != 0:
            raise NotImplementedError(
                f"radix-split DCT (levels={levels}): not ported yet "
                "(ROADMAP Queue A, 'Split-level DCT for n >= 1024')"
            )
        super().__init__(dct2_matrix(n), idct2_matrix(n), dtype, device)


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
