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
None, all float32. The kernel is CUDA C++ for sm_90a in
``csrc/trailing_dct.cu`` (built and loaded by ops/_native.py). The wrapper
checks device, dtype, shape and contiguity; a tensor on the CPU goes to the
plain version, a CUDA tensor to the kernel, and nothing else. Each launch
adds one to ``LAUNCHES["fused_trailing"]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _native

LAUNCHES = {"fused_trailing": 0}

# the kernel's tiles (csrc/trailing_dct.cu): 64 output rows per CTA, the
# reduction staged 16 deep, B tiles of 16 x (256 + 4) floats
_ROWS, _DEPTH, _LDB = 64, 16, 260
# shared memory one CTA may take on an H100 (232 448 bytes)
_SMEM_LIMIT = 227 * 1024
_GRID_Y_LIMIT = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(n2: int) -> int:
    """Shared memory of one CTA for trailing extent ``n2``: the 64-row
    intermediate ``Y`` (rows of n2 rounded up to 16) and the two operand
    tiles."""
    yw = -(-n2 // _DEPTH) * _DEPTH
    return 4 * (_ROWS * yw + _ROWS * _DEPTH + _DEPTH * _LDB)


def applicable(shape) -> bool:
    """The Hopper gate of the kernel for ``x`` of ``shape``: 3D, a CTA's
    shared memory (the 64 x n2 intermediate that keeps ``m1 @ x[i]`` on
    chip, plus two operand tiles) within the H100's 227 KB, which admits n2
    up to 816, and at most 65535 slabs (the grid's y extent). The TPU
    gate's VMEM and lane rules (n1 n2 <= 256^2, n2 % 128) do not apply."""
    if len(shape) != 3 or min(shape) < 1:
        return False
    n0, _, n2 = shape
    return n0 <= _GRID_Y_LIMIT and smem_bytes(n2) <= _SMEM_LIMIT


def fused_trailing_plain(
    x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
    eig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two batched ``torch.matmul`` and the multiply."""
    out = torch.matmul(torch.matmul(m1, x), m2.T)
    return out if eig is None else out * eig


_ARGTYPES = [_native.P] * 5 + [_native.I] * 5 + [_native.P]


def fused_trailing(
    x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
    eig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(m1 @ x[i] @ m2.T) * eig[i]`` for every slab ``i``, one launch on
    a CUDA device (``eig`` None: no multiply)."""
    if not isinstance(x, torch.Tensor) or x.ndim != 3:
        raise ValueError("fused_trailing: x must be a 3D tensor")
    n0, n1, n2 = x.shape
    k1, k2 = m1.shape[0], m2.shape[0]
    device = x.device
    check = _native.check
    check("fused_trailing x", x, (n0, n1, n2), torch.float32, device)
    check("fused_trailing m1", m1, (k1, n1), torch.float32, device)
    check("fused_trailing m2", m2, (k2, n2), torch.float32, device)
    if eig is not None:
        check("fused_trailing eig", eig, (n0, k1, k2), torch.float32, device)
    if device.type == "cpu":
        return fused_trailing_plain(x, m1, m2, eig)
    _native.cuda_or_raise(device, "fused_trailing")
    if not applicable(x.shape):
        raise ValueError(f"fused_trailing: shape {tuple(x.shape)} is outside "
                         "the kernel's gate (trailing_dct.applicable)")
    out = torch.empty((n0, k1, k2), dtype=torch.float32, device=device)
    ptr = _native.ptr
    _native.launch(
        "trailing_dct", "nss_fused_trailing", _ARGTYPES, device,
        ptr(x), ptr(m1), ptr(m2), None if eig is None else ptr(eig),
        ptr(out), n0, n1, n2, k1, k2,
    )
    LAUNCHES["fused_trailing"] += 1
    return out
