"""Fused 3D projection-step kernels: wrappers and their plain versions.

Counterpart of the three Pallas kernels that carry the JAX package's 3D
step on the TPU (``navierstokessolver_tpu/ops/pallas_kernels.py``):

  ===================  ==============================  =====================
  wrapper              replaces                        plain version
  ===================  ==============================  =====================
  predictor_rhs_3d     _fused_pred_kernel              predictor_rhs_plain
  correct_diag_3d      _fused_corr_kernel              correct_diag_plain
  residual_3d          _residual3d_kernel              residual_plain
  ===================  ==============================  =====================

The kernels are CUDA C++ for sm_90a in ``csrc/fused3d.cu`` (built and
loaded by ops/_native.py). Every wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor
to the kernel, and nothing else. Each kernel launch adds one to
``LAUNCHES[<wrapper name>]``.

Fields use the exact MAC layout of :class:`~..grid.State`; the slice
supports WALL faces (lid included) with constant values, no obstacles and
no forcing (see :func:`fused_step3d_applicable`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..bcs import BCKind, BCTable, apply_velocity_bcs
from ..grid import GridSpec
from . import _native, stencils
from .poisson import PoissonOp, apply_A

LAUNCHES = {"predictor_rhs_3d": 0, "correct_diag_3d": 0, "residual_3d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_step3d_applicable(grid: GridSpec, bcs: BCTable) -> bool:
    """The kernels take 3D float32 grids whose every face is a WALL with
    constant scalar values."""
    if grid.ndim != 3 or grid.dtype != torch.float32:
        return False
    return all(
        bcs[(a, s)].kind is BCKind.WALL
        and all(isinstance(v, (int, float)) for v in bcs[(a, s)].velocity)
        for a in range(3) for s in (0, 1)
    )


def bc_table(grid: GridSpec, bcs: BCTable, device) -> torch.Tensor:
    """The wall values as the kernels read them: float32
    ``[(axis*2 + side)*3 + comp]`` on ``device``. Build it once per
    simulation; the step then copies nothing from the host."""
    values = [float(bcs[(a, s)].component(c, 3))
              for a in range(3) for s in (0, 1) for c in range(3)]
    return torch.tensor(values, dtype=torch.float32, device=device)


# -- checks -------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_velocity(grid: GridSpec, u: Sequence[torch.Tensor], what: str):
    if grid.ndim != 3 or len(u) != 3:
        raise ValueError(f"{what}: the fused kernels are 3D only")
    device = u[0].device
    for a in range(3):
        _check(f"{what}[{a}]", u[a], grid.face_shape(a), torch.float32, device)
    return device


def _cuda_or_raise(device: torch.device, wrapper: str) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"{wrapper}: tensors on {device}; the kernel runs on CUDA "
            "devices and the plain version on the CPU"
        )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _f32(x: float) -> float:
    return float(np.float32(x))


_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
# C signatures in csrc/fused3d.cu: pointers, the three extents, float
# scalars, the stream
_ARGTYPES = {
    "nss_predictor_rhs_3d": [_P] * 8 + [_I] * 3 + [_F] * 14 + [_P],
    "nss_correct_diag_3d": [_P] * 8 + [_I] * 3 + [_F] * 4 + [_P],
    "nss_residual_3d": [_P] * 5 + [_I] * 3 + [_F] * 3 + [_P],
}


def _launch(name: str, device: torch.device, *args) -> None:
    """Call ``name`` with ``device`` current and PyTorch's current stream
    on it as the last argument; raise if the launch failed."""
    fn = _native.bind(_native.load("fused3d"), name, _ARGTYPES[name])
    with torch.cuda.device(device):
        err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")


def build() -> float:
    """Build (or load) the kernel library now; returns the build seconds
    (0.0 when a built library was already there)."""
    _native.load("fused3d")
    return _native.BUILD_INFO["fused3d"][0]


# -- predictor + BCs + Poisson RHS (replaces _fused_pred_kernel) --------------


def predictor_rhs_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], dt: float,
    nu: float, upwind_gamma: float = 0.0, rho: float = 1.0,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """u* (BC values on the boundary faces) and the Poisson RHS
    ``(rho/dt) div u*``, from the plain stencils; any dimension."""
    u_star = stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma)
    u_star = apply_velocity_bcs(grid, bcs, u_star)
    rho_over_dt = _f32(np.float32(rho) / np.float32(dt))
    return u_star, stencils.divergence(grid, u_star) * rho_over_dt


def predictor_rhs_3d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], dt: float,
    nu: float, upwind_gamma: float = 0.0, rho: float = 1.0,
    bc: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused predictor: one launch writes u0*, u1*, u2* and the RHS.

    ``bc``: the wall-value buffer from :func:`bc_table` (built here when
    None). ``dt`` is the fixed step as a Python float.
    """
    device = _check_velocity(grid, u, "predictor_rhs_3d u")
    if not fused_step3d_applicable(grid, bcs):
        raise NotImplementedError(
            "predictor_rhs_3d: WALL faces with constant values only "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    if device.type == "cpu":
        return predictor_rhs_plain(grid, bcs, u, dt, nu, upwind_gamma, rho)
    _cuda_or_raise(device, "predictor_rhs_3d")
    if bc is None:
        bc = bc_table(grid, bcs, device)
    _check("predictor_rhs_3d bc", bc, (18,), torch.float32, device)
    out = tuple(torch.empty_like(c) for c in u)
    rhs = torch.empty(grid.shape, dtype=torch.float32, device=device)
    h = grid.spacing
    n0, n1, n2 = grid.shape
    _launch(
        "nss_predictor_rhs_3d", device,
        *(_ptr(t) for t in (*u, *out, rhs, bc)),
        n0, n1, n2,
        *(_f32(x) for x in h),
        *(_f32(2.0 * x) for x in h),
        *(_f32(x * x) for x in h),
        _f32(dt), _f32(nu), _f32(upwind_gamma), _f32(1.0 - upwind_gamma),
        _f32(np.float32(rho) / np.float32(dt)),
    )
    LAUNCHES["predictor_rhs_3d"] += 1
    return out, rhs


# -- corrector + diagnostics (replaces _fused_corr_kernel) --------------------


def correct_diag_plain(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: float,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """``u = u* - scale grad p`` on interior faces, plus ``max|div u|`` and
    ``max_a max|u_a|/h_a``; any dimension. Every cell is fluid."""
    u_new = stencils.correct_velocity(grid, u_star, p, scale)
    max_div = stencils.divergence(grid, u_new).abs().max()
    h = grid.spacing
    max_vel = torch.stack(
        [(c / h[a]).abs().max() for a, c in enumerate(u_new)]
    ).max()
    return u_new, max_div, max_vel


def correct_diag_3d(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: float,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Fused corrector: one launch writes u_new and both diagnostics (0-d
    tensors on the device; a NaN anywhere shows in them)."""
    device = _check_velocity(grid, u_star, "correct_diag_3d u_star")
    _check("correct_diag_3d p", p, grid.shape, torch.float32, device)
    if device.type == "cpu":
        return correct_diag_plain(grid, u_star, p, scale)
    _cuda_or_raise(device, "correct_diag_3d")
    out = tuple(torch.empty_like(c) for c in u_star)
    maxes = torch.zeros(2, dtype=torch.int32, device=device)
    h = grid.spacing
    n0, n1, n2 = grid.shape
    _launch(
        "nss_correct_diag_3d", device,
        *(_ptr(t) for t in (*u_star, p, *out, maxes)),
        n0, n1, n2,
        *(_f32(x) for x in h),
        _f32(scale),
    )
    LAUNCHES["correct_diag_3d"] += 1
    m = maxes.view(torch.float32)
    return out, m[0], m[1]


# -- Poisson residual (replaces _residual3d_kernel) ---------------------------


def residual_plain(op: PoissonOp, p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(b - A p) * fluid``; any dimension."""
    return (b - apply_A(op, p)) * op.fluid


def residual_3d(op: PoissonOp, p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(b - A p) * fluid`` in one launch, A decoded from ``op.code``."""
    if p.ndim != 3:
        raise ValueError("residual_3d: 3D fields only")
    if any(op.periodic):
        raise NotImplementedError(
            "residual_3d: periodic axes not ported (ROADMAP Queue A, "
            "'Other BC kinds')"
        )
    device = p.device
    shape = tuple(p.shape)
    _check("residual_3d p", p, shape, torch.float32, device)
    _check("residual_3d b", b, shape, torch.float32, device)
    _check("residual_3d diag", op.diag, shape, torch.float32, device)
    _check("residual_3d code", op.code, shape, torch.uint8, device)
    if device.type == "cpu":
        return residual_plain(op, p, b)
    _cuda_or_raise(device, "residual_3d")
    out = torch.empty_like(p)
    _launch(
        "nss_residual_3d", device,
        *(_ptr(t) for t in (p, b, op.diag, op.code, out)),
        *shape,
        *(_f32(w) for w in op.w),
    )
    LAUNCHES["residual_3d"] += 1
    return out
