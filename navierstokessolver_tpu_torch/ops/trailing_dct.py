"""The fused trailing-axes spectral transform of the 3D direct solve: the
wrapper and its plain version.

Counterpart of the Pallas kernel ``_kernel`` of
``navierstokessolver_tpu/ops/pallas_dct.py`` (wrapper ``fused_trailing``):

  ==============  ========================  =====================
  wrapper         replaces                  plain version
  ==============  ========================  =====================
  fused_trailing  pallas_dct._kernel        fused_trailing_plain
  ==============  ========================  =====================

``out[i] = (m1 @ x[i] @ m2.T) * eig[i]`` over the axis-0 slabs of ``x``
(n0, n1, n2), ``m1`` (k1, n1), ``m2`` (k2, n2), ``eig`` (n0, k1, k2) or
None, all float32, at the JAX kernel's pass count (``_dot``): every product
of both stages is the bf16 split product of its float32 operands, each
operand ``a`` cut into ``hi = bf16(a)`` and ``lo = bf16(a - hi)`` (round to
nearest even, JAX's ``_split_bf16``) and summed in float32. ``passes=3``
(``Precision.HIGH``) adds ``hi hi + hi lo + lo hi``; ``passes=1``
(``Precision.DEFAULT``) takes ``hi hi`` alone. Stage 1 splits ``m1`` and
``x[i]``, stage 2 the float32 stage-1 result and ``m2``.

The kernel is CUDA C++ for sm_90a in ``csrc/trailing_dct.cu`` (bf16
``wgmma``; built and loaded by ops/_native.py). ``m1`` and ``m2`` are solver
constants: :func:`split_matrix` splits them once into a :class:`Split`
(the matrix and the zero-padded hi/lo pair the kernel reads), which both
the wrapper and its plain version take. The wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor to
the kernel, and nothing else. Each launch adds one to
``LAUNCHES["fused_trailing"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _native

LAUNCHES = {"fused_trailing": 0}

# bf16 passes of each JAX precision name the fused route admits ('highest'
# keeps the chain, as in JAX)
PASSES = {"high": 3, "default": 1}

# the kernel's stage-1 N pass (csrc/trailing_dct.cu), the largest n2 it
# takes
_PASS_N = 256
# the packed constants: rows padded to a stage-2 pass of 128 output
# columns, columns to a 64-wide K atom (128 swizzled bytes a row)
_PACK_ROWS, _PACK_COLS = 128, 64
_GRID_Y_LIMIT = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes() -> int:
    """Shared memory of one CTA (csrc/trailing_dct.cu): the stage-1 B tile,
    later the split intermediate Y (64 x 256 bf16 hi and lo, 64 KB); the
    float32 staging ring of x (two 16 x 256 pieces, 32 KB), later the
    stage-2 B slices; the m1 slices (16 KB); 1 KB of alignment slack."""
    return 64 * 1024 + 32 * 1024 + 16 * 1024 + 1024


def applicable(shape) -> bool:
    """The Hopper gate of the kernel for ``x`` of ``shape``: 3D, n2 <= 256
    (one stage-1 N pass; Y stays in shared memory as bf16 hi/lo), at most
    65535 slabs (the grid's y extent). n1, k1 and k2 are free (K loops and
    output passes). The TPU gate admits n2 of 128 and 256."""
    if len(shape) != 3 or min(shape) < 1:
        return False
    n0, _, n2 = shape
    return n0 <= _GRID_Y_LIMIT and n2 <= _PASS_N


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_split_bf16``: ``hi = bf16(a)``, ``lo = bf16(a - hi)``, both
    rounded to nearest even."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi, lo


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """A float32 matrix (k, n) and the pair the kernel reads: ``packed``
    (2, k padded to 128, n padded to 64), hi then lo, zero outside the
    matrix (no lo garbage in the padding). ``hi`` and ``lo`` are views of
    it."""

    full: torch.Tensor
    packed: torch.Tensor

    @property
    def hi(self) -> torch.Tensor:
        k, n = self.full.shape
        return self.packed[0, :k, :n]

    @property
    def lo(self) -> torch.Tensor:
        k, n = self.full.shape
        return self.packed[1, :k, :n]


def split_matrix(m: torch.Tensor) -> Split:
    """``m`` (float32, 2D) split once, as the solver caches its constants."""
    if m.ndim != 2 or m.dtype != torch.float32:
        raise ValueError("split_matrix: a 2D float32 matrix")
    k, n = m.shape
    kp = -(-k // _PACK_ROWS) * _PACK_ROWS
    np_ = -(-n // _PACK_COLS) * _PACK_COLS
    packed = torch.zeros((2, kp, np_), dtype=torch.bfloat16, device=m.device)
    packed[0, :k, :n], packed[1, :k, :n] = split_bf16(m)
    return Split(full=m.contiguous(), packed=packed)


def _dot(a: torch.Tensor, b: torch.Tensor, passes: int,
         a_split=None, b_split=None) -> torch.Tensor:
    """``a @ b`` as the split product: bf16-valued float32 matmuls, whose
    products are exact in float32, summed as JAX's ``_dot`` sums them."""
    a_hi, a_lo = a_split if a_split is not None else split_bf16(a)
    b_hi, b_lo = b_split if b_split is not None else split_bf16(b)
    a_hi, b_hi = a_hi.float(), b_hi.float()
    out = torch.matmul(a_hi, b_hi)
    if passes == 3:
        out = (out + torch.matmul(a_hi, b_lo.float())
               + torch.matmul(a_lo.float(), b_hi))
    return out


def _check_passes(passes: int) -> None:
    if passes not in (1, 3):
        raise ValueError(f"fused_trailing: passes must be 1 or 3, got "
                         f"{passes!r}")


def fused_trailing_plain(x: torch.Tensor, m1: Split, m2: Split,
                         eig: Optional[torch.Tensor] = None,
                         passes: int = 3) -> torch.Tensor:
    """The two stages as split products of ``torch.matmul`` (the kernel's
    arithmetic up to the order of its float32 sums), then the multiply."""
    _check_passes(passes)
    y = _dot(m1.full, x, passes, a_split=(m1.hi, m1.lo))
    out = _dot(y, m2.full.T, passes, b_split=(m2.hi.T, m2.lo.T))
    return out if eig is None else out * eig


_ARGTYPES = [_native.P] * 5 + [_native.I] * 6 + [_native.P]


def fused_trailing(x: torch.Tensor, m1: Split, m2: Split,
                   eig: Optional[torch.Tensor] = None,
                   passes: int = 3) -> torch.Tensor:
    """``(m1 @ x[i] @ m2.T) * eig[i]`` for every slab ``i`` at ``passes``
    bf16 passes, one launch on a CUDA device (``eig`` None: no multiply).
    ``m1``, ``m2``: the :class:`Split` of each matrix."""
    if not isinstance(x, torch.Tensor) or x.ndim != 3:
        raise ValueError("fused_trailing: x must be a 3D tensor")
    if not (isinstance(m1, Split) and isinstance(m2, Split)):
        raise ValueError("fused_trailing: m1 and m2 must be Splits "
                         "(split_matrix)")
    _check_passes(passes)
    n0, n1, n2 = x.shape
    k1, k2 = m1.full.shape[0], m2.full.shape[0]
    device = x.device
    check = _native.check
    check("fused_trailing x", x, (n0, n1, n2), torch.float32, device)
    check("fused_trailing m1", m1.full, (k1, n1), torch.float32, device)
    check("fused_trailing m2", m2.full, (k2, n2), torch.float32, device)
    if eig is not None:
        check("fused_trailing eig", eig, (n0, k1, k2), torch.float32, device)
    if device.type == "cpu":
        return fused_trailing_plain(x, m1, m2, eig, passes)
    _native.cuda_or_raise(device, "fused_trailing")
    if not applicable(x.shape):
        raise ValueError(f"fused_trailing: shape {tuple(x.shape)} is outside "
                         "the kernel's gate (trailing_dct.applicable)")
    for name, s in (("m1", m1), ("m2", m2)):
        k, n = s.full.shape
        check(f"fused_trailing {name} packed", s.packed,
              (2, -(-k // _PACK_ROWS) * _PACK_ROWS,
               -(-n // _PACK_COLS) * _PACK_COLS), torch.bfloat16, device)
    out = torch.empty((n0, k1, k2), dtype=torch.float32, device=device)
    ptr = _native.ptr
    _native.launch(
        "trailing_dct", "nss_fused_trailing", _ARGTYPES, device,
        ptr(x), ptr(m1.packed), ptr(m2.packed),
        None if eig is None else ptr(eig), ptr(out),
        n0, n1, n2, k1, k2, passes,
    )
    LAUNCHES["fused_trailing"] += 1
    return out
