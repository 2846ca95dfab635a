"""Per-component 3D predictor and eddy-viscosity kernels of the LES step:
wrappers and their plain versions.

Counterpart of two Pallas kernels of the JAX package
(``navierstokessolver_tpu/ops/pallas_kernels.py``), the route every
unsharded 3D LES run takes on the TPU (``Simulation._predict``):

  ============  ===================  ====================================
  wrapper       replaces             plain version
  ============  ===================  ====================================
  nu_t_3d       _nu_t3d_kernel       les.eddy_viscosity
  predictor_3d  _predictor3d_kernel  predictor_3d_plain (stencils.predictor
                                     with les.sgs_forcing as its forcing)
  ============  ===================  ====================================

The kernels are CUDA C++ for sm_90a in ``csrc/predictor3d.cu`` (built and
loaded by ops/_native.py). Every wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor
to the kernel, and nothing else. Each wrapper call that launches its
kernel adds one to ``LAUNCHES[<wrapper name>]``.

Fields use the exact MAC layout of :class:`~..grid.State`; the slice
supports WALL faces (lid included) with constant values (the WALL tables
of :func:`.fused3d.fused_step3d_applicable`; periodic axes are not ported
here). Like ``fused3d.predictor_rhs_3d``
and unlike the TPU kernel, :func:`predictor_3d` returns u* with the BC
values on the boundary faces, so the step needs no BC pass after it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import les as les_mod
from ..bcs import BCTable, apply_velocity_bcs, periodic_axes
from ..grid import GridSpec
from . import _native, fused3d, step_size, stencils

LAUNCHES = {"nu_t_3d": 0, "predictor_3d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_check, _ptr = _native.check, _native.ptr
_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/predictor3d.cu: pointers, the three extents, float
# scalars, the stream
_ARGTYPES = {
    "nss_nu_t_3d": [_P] * 5 + [_I] * 3 + [_F] * 4 + [_P],
    "nss_predictor_3d": [_P] * 9 + [_I] * 3 + [_F] * 9 + [_P],
}


def _launch(name: str, device: torch.device, *args) -> None:
    _native.launch("predictor3d", name, _ARGTYPES[name], device, *args)


def _prepare(grid: GridSpec, bcs: BCTable, u, bc, what: str):
    """Checks shared by both wrappers; returns (device, bc buffer or None
    on the CPU)."""
    device = fused3d.check_velocity(grid, u, f"{what} u")
    if (not fused3d.fused_step3d_applicable(grid, bcs)
            or any(periodic_axes(grid, bcs))):
        raise NotImplementedError(
            f"{what}: WALL faces with constant values only (ROADMAP Queue "
            "A, 'Other BC kinds')"
        )
    if device.type == "cpu":
        return device, None
    _native.cuda_or_raise(device, what)
    if bc is None:
        bc = fused3d.bc_table(grid, bcs, device)
    _check(f"{what} bc", bc, (fused3d.BC_SIZE,), torch.float32, device)
    return device, bc


def nu_t_scalars(grid: GridSpec, cfg: les_mod.LESConfig) -> list[float]:
    """Kernel 7's float arguments, in the order of its C signature:
    ``1/h_a`` (a = 0..2), the reciprocals ``_nu_t3d_kernel`` multiplies by
    (Python double, then float32), and ``cs^2 Delta^2`` in float32, as the
    JAX step hands it to the kernel."""
    h = np.asarray(grid.spacing, dtype=np.float64)
    scale = cfg.cs * cfg.cs * cfg.filter_width(grid) ** 2
    return np.append(1.0 / h, scale).astype(np.float32).tolist()


def predictor_scalars(grid: GridSpec, nu: float,
                      upwind_gamma: float) -> list[float]:
    """Kernel 6's float arguments, in the order of its C signature:
    ``1/h_a`` and ``1/h_a^2`` (a = 0..2), formed as ``_predictor3d_kernel``
    forms them (Python double, then float32; the kernel takes ``1/(2h_a)``
    as 0.5 times ``1/h_a``, the same float32), then nu, gamma and
    1 - gamma; dt comes through a pointer."""
    h = np.asarray(grid.spacing, dtype=np.float64)
    vals = np.concatenate([1.0 / h, 1.0 / (h * h),
                           [nu, upwind_gamma, 1.0 - upwind_gamma]])
    return vals.astype(np.float32).tolist()


# -- eddy viscosity (replaces _nu_t3d_kernel) ---------------------------------


def nu_t_3d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    cfg: les_mod.LESConfig, bc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cell-centred static Smagorinsky ``nu_t = cs^2 Delta^2 |S|`` in one
    launch. The dynamic model's test filter and global sums stay plain
    (:func:`..les.eddy_viscosity`), as in the JAX package."""
    if cfg.model != "smagorinsky":
        raise ValueError(
            f"nu_t_3d: static Smagorinsky only, got model {cfg.model!r}"
        )
    device, bc = _prepare(grid, bcs, u, bc, "nu_t_3d")
    if device.type == "cpu":
        return les_mod.eddy_viscosity(grid, bcs, u, cfg)
    out = torch.empty(grid.shape, dtype=torch.float32, device=device)
    _launch(
        "nss_nu_t_3d", device,
        *(_ptr(t) for t in (*u, bc, out)),
        *grid.shape,
        *nu_t_scalars(grid, cfg),
    )
    LAUNCHES["nu_t_3d"] += 1
    return out


# -- per-component predictor (replaces _predictor3d_kernel) -------------------


def predictor_3d_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    nu_t: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """u* with the BC values on the boundary faces; with ``nu_t``, plus the
    subgrid stress divergence of :func:`..les.sgs_forcing`."""
    forcing = (None if nu_t is None
               else les_mod.sgs_forcing(grid, bcs, u, None, nu_t=nu_t))
    u_star = stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma, forcing)
    return apply_velocity_bcs(grid, bcs, u_star)


def predictor_3d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    nu_t: Optional[torch.Tensor] = None, bc: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """u* of all three components in one launch (the BC values written on
    the boundary faces); ``nu_t`` (cell-centred) adds the LES subgrid
    stress divergence. ``bc``: the wall-value buffer of
    :func:`.fused3d.bc_table` (built here when None). ``dt``: a Python
    float or a one-element float32 tensor on the fields' device, which the
    kernel reads (element 0 of a step-size buffer)."""
    device, bc = _prepare(grid, bcs, u, bc, "predictor_3d")
    if nu_t is not None:
        _check("predictor_3d nu_t", nu_t, grid.shape, torch.float32, device)
    if device.type == "cpu":
        return predictor_3d_plain(grid, bcs, u, dt, nu, upwind_gamma, nu_t)
    dt = step_size.scalar(dt, device, "predictor_3d dt")
    out = tuple(torch.empty_like(c) for c in u)
    _launch(
        "nss_predictor_3d", device,
        *(_ptr(t) for t in u),
        _ptr(nu_t) if nu_t is not None else None,
        *(_ptr(t) for t in (*out, bc, dt)),
        *grid.shape,
        *predictor_scalars(grid, nu, upwind_gamma),
    )
    LAUNCHES["predictor_3d"] += 1
    return out
