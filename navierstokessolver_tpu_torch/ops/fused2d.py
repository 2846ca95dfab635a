"""Fused 2D projection-step kernels: wrappers and their plain versions.

Counterpart of the two Pallas kernels that carry the JAX package's fused
2D step on the TPU (``navierstokessolver_tpu/ops/pallas_2d.py``):

  ===================  ==============================  ======================
  wrapper              replaces                        plain version
  ===================  ==============================  ======================
  predictor_rhs_2d     _pred2d_kernel                  predictor_rhs_2d_plain
  correct_diag_2d      _corr2d_kernel                  correct_diag_2d_plain
  ===================  ==============================  ======================

The kernels are CUDA C++ for sm_90a in ``csrc/fused2d.cu`` (built and
loaded by ops/_native.py). Every wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor
to the kernel, and nothing else. Each kernel launch adds one to
``LAUNCHES[<wrapper name>]``.

Fields use the exact MAC layout of :class:`~..grid.State`: u is
(n0+1, n1), v is (n0, n1+1). The slice supports WALL faces (lid included)
with constant values, no obstacles, no periodic axes, no forcing and no
thermal coupling (see :func:`fused_step2d_applicable`). As in
ops/fused3d.py, the kernels read the step size from a device buffer
(ops/step_size.py), and the predictor's ``base`` runs rk2's stage 2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..bcs import BCKind, BCTable
from ..grid import GridSpec
from . import _native, fused3d, step_size

LAUNCHES = {"predictor_rhs_2d": 0, "correct_diag_2d": 0}

# The plain versions are the dimension-generic compositions of the plain
# stencils: the JAX package's jnp step, which its Pallas kernels are held to.
predictor_rhs_2d_plain = fused3d.predictor_rhs_plain
correct_diag_2d_plain = fused3d.correct_diag_plain

_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/fused2d.cu: pointers (the predictor's base and
# step-size buffer, the corrector's scale among them), the two extents,
# float scalars, the stream
_ARGTYPES = {
    "nss_predictor_rhs_2d": [_P] * 9 + [_I] * 2 + [_F] * 9 + [_P],
    "nss_correct_diag_2d": [_P] * 7 + [_I] * 2 + [_F] * 2 + [_P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_step2d_applicable(grid: GridSpec, bcs: BCTable) -> bool:
    """The kernels take 2D float32 grids whose every face is a WALL with
    constant scalar values."""
    if grid.ndim != 2 or grid.dtype != torch.float32:
        return False
    return all(
        bcs[(a, s)].kind is BCKind.WALL
        and all(isinstance(v, (int, float)) for v in bcs[(a, s)].velocity)
        for a in range(2) for s in (0, 1)
    )


def bc_table(grid: GridSpec, bcs: BCTable, device) -> torch.Tensor:
    """The wall values as the kernels read them: float32
    ``[(axis*2 + side)*2 + comp]`` on ``device``. Build it once per
    simulation; the step then copies nothing from the host."""
    values = [float(bcs[(a, s)].component(c, 2))
              for a in range(2) for s in (0, 1) for c in range(2)]
    return torch.tensor(values, dtype=torch.float32, device=device)


def predictor_scalars(grid: GridSpec, nu: float,
                      upwind_gamma: float) -> list[float]:
    """Kernel 4's float arguments, in the order of its C signature, in one
    numpy conversion: ``1/h_a``, ``1/(2h_a)`` and ``1/h_a^2`` (a = 0, 1),
    the Pallas kernel's constants (a Python double rounded to float32);
    nu, gamma, 1 - gamma. dt and rho/dt come from the step-size buffer.
    Kernel 5 takes :func:`fused3d.corrector_scalars`."""
    h = np.asarray(grid.spacing, dtype=np.float64)
    vals = np.concatenate([1.0 / h, 1.0 / (2.0 * h), 1.0 / (h * h),
                           [nu, upwind_gamma, 1.0 - upwind_gamma]])
    return vals.astype(np.float32).tolist()


def _check_velocity(grid: GridSpec, u: Sequence[torch.Tensor], what: str):
    if grid.ndim != 2 or len(u) != 2:
        raise ValueError(f"{what}: the fused 2D kernels take 2D fields")
    device = u[0].device
    for a in range(2):
        _native.check(f"{what}[{a}]", u[a], grid.face_shape(a),
                      torch.float32, device)
    return device


def _launch(name: str, device: torch.device, *args) -> None:
    _native.launch("fused2d", name, _ARGTYPES[name], device, *args)


# -- predictor + BCs + Poisson RHS (replaces _pred2d_kernel) ------------------


def predictor_rhs_2d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, bc: Optional[torch.Tensor] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
    dts: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused predictor: one launch writes u*, v* (BC values on the boundary
    faces) and the RHS ``(rho/dt) div u*``.

    ``bc``: the wall-value buffer from :func:`bc_table` (built here when
    None). ``dt``: a Python float or a 0-d tensor; ``dts``: its step-size
    buffer (:mod:`.step_size`, formed here when None). ``base``: the
    step-start velocity, rk2's stage-2 mode (``u`` the midpoint field).
    """
    device = _check_velocity(grid, u, "predictor_rhs_2d u")
    if not fused_step2d_applicable(grid, bcs):
        raise NotImplementedError(
            "predictor_rhs_2d: WALL faces with constant values only "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    base_ptrs = [None, None]
    if base is not None:
        for a in range(2):
            _native.check(f"predictor_rhs_2d base[{a}]", base[a],
                          grid.face_shape(a), torch.float32, device)
        base_ptrs = [_native.ptr(t) for t in base]
    if device.type == "cpu":
        return predictor_rhs_2d_plain(grid, bcs, u, dt, nu, upwind_gamma, rho,
                                      base=base)
    _native.cuda_or_raise(device, "predictor_rhs_2d")
    if bc is None:
        bc = bc_table(grid, bcs, device)
    _native.check("predictor_rhs_2d bc", bc, (8,), torch.float32, device)
    dts = step_size.check(step_size.buffer(dt, rho, device) if dts is None
                          else dts, device, "predictor_rhs_2d dts")
    out = tuple(torch.empty_like(c) for c in u)
    rhs = torch.empty(grid.shape, dtype=torch.float32, device=device)
    _launch(
        "nss_predictor_rhs_2d", device,
        *(_native.ptr(t) for t in (*u, *out, rhs, bc)), *base_ptrs,
        _native.ptr(dts), *grid.shape,
        *predictor_scalars(grid, nu, upwind_gamma),
    )
    LAUNCHES["predictor_rhs_2d"] += 1
    return out, rhs


# -- corrector + diagnostics (replaces _corr2d_kernel) ------------------------


def correct_diag_2d(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Fused corrector: one launch writes u_new and both diagnostics,
    ``max|div u|`` and ``max_a max|u_a|/h_a`` (0-d tensors on the device; a
    NaN anywhere shows in them). ``scale`` (dt/rho): a Python float or a
    one-element float32 tensor on the fields' device."""
    device = _check_velocity(grid, u_star, "correct_diag_2d u_star")
    _native.check("correct_diag_2d p", p, grid.shape, torch.float32, device)
    if device.type == "cpu":
        return correct_diag_2d_plain(grid, u_star, p, scale)
    _native.cuda_or_raise(device, "correct_diag_2d")
    scale = step_size.scalar(scale, device, "correct_diag_2d scale")
    out = tuple(torch.empty_like(c) for c in u_star)
    maxes = torch.zeros(2, dtype=torch.int32, device=device)
    _launch(
        "nss_correct_diag_2d", device,
        *(_native.ptr(t) for t in (*u_star, p, *out, maxes, scale)),
        *grid.shape, *fused3d.corrector_scalars(grid),
    )
    LAUNCHES["correct_diag_2d"] += 1
    m = maxes.view(torch.float32)
    return out, m[0], m[1]
