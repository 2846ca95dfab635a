"""2D per-component predictor kernel: wrapper and its plain version.

Counterpart of the Pallas kernel the JAX package's unfused 2D step runs on
the TPU (``navierstokessolver_tpu/ops/pallas_kernels.py``, reached through
``Simulation._predict`` when the fused 2D step does not apply, e.g. with
the immersed boundary):

  ===================  ==============================  =====================
  wrapper              replaces                        plain version
  ===================  ==============================  =====================
  predictor_2d         _predictor_component_kernel     predictor_2d_plain
  ===================  ==============================  =====================

The kernel is CUDA C++ for sm_90a in ``csrc/predictor2d.cu`` (built and
loaded by ops/_native.py). The wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor
to the kernel, and nothing else. Each kernel launch adds one to
``LAUNCHES["predictor_2d"]``.

Fields use the exact MAC layout of :class:`~..grid.State`: u is
(n0+1, n1), v is (n0, n1+1). Faces may be WALL, INFLOW, SLIP or OUTFLOW
with constant values (see :func:`predictor_2d_applicable`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bcs import TANGENTIAL_REFLECT_KINDS, BCKind, BCTable
from ..grid import GridSpec
from . import _native, stencils

LAUNCHES = {"predictor_2d": 0}

_F, _I, _P = _native.F, _native.I, _native.P
# C signature in csrc/predictor2d.cu: pointers, the two extents, float
# scalars (spacings, dt, nu, the blend, the ghost table), the stream
_ARGTYPES = [_P] * 4 + [_I] * 2 + [_F] * 18 + [_P]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def predictor_2d_applicable(grid: GridSpec, bcs: BCTable) -> bool:
    """The kernel takes 2D float32 grids whose faces are WALL, INFLOW,
    SLIP or OUTFLOW with constant scalar values."""
    if grid.ndim != 2 or grid.dtype != torch.float32:
        return False
    kinds = (BCKind.WALL, BCKind.INFLOW, BCKind.SLIP, BCKind.OUTFLOW)
    return all(
        bcs[(a, s)].kind in kinds
        and all(isinstance(v, (int, float)) for v in bcs[(a, s)].velocity)
        for a in range(2) for s in (0, 1)
    )


def ghost_table(grid: GridSpec, bcs: BCTable) -> tuple[float, ...]:
    """The kernel's transverse ghosts ``alpha * edge + beta``: alpha of u
    across the axis-1 low and high faces, then of v across the axis-0
    faces, then the four betas. ``(-1, 2 u_bc)`` across WALL and INFLOW,
    ``(1, 0)`` across SLIP and OUTFLOW: the ghosts of
    :func:`..bcs.pad_transverse`, bit for bit. Build it once per
    simulation."""
    alpha, beta = [], []
    for comp, axis in ((0, 1), (1, 0)):
        for side in (0, 1):
            bc = bcs[(axis, side)]
            if bc.kind in TANGENTIAL_REFLECT_KINDS:
                alpha.append(-1.0)
                beta.append(2.0 * _native.f32(bc.component(comp, 2)))
            else:
                alpha.append(1.0)
                beta.append(0.0)
    return (*alpha, *beta)


def predictor_2d_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], dt: float,
    nu: float, upwind_gamma: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """The plain version: ``stencils.predictor`` without forcing (the JAX
    package's jnp predictor, which its Pallas kernel is held to)."""
    return stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma)


def predictor_2d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], dt: float,
    nu: float, upwind_gamma: float = 0.0,
    ghosts: Optional[tuple[float, ...]] = None,
) -> tuple[torch.Tensor, ...]:
    """``(u*, v*)`` in one launch: the predictor update on every face that
    is not a boundary face of its own axis. Those keep their input value,
    for the caller's BC pass to overwrite (the contract of the JAX
    ``predictor_2d``, whose kernel leaves them garbage).

    ``ghosts``: :func:`ghost_table` (built here when None). ``dt`` is the
    fixed step as a Python float."""
    if grid.ndim != 2 or len(u) != 2:
        raise ValueError("predictor_2d: the kernel takes 2D fields")
    device = u[0].device
    for a in range(2):
        _native.check(f"predictor_2d u[{a}]", u[a], grid.face_shape(a),
                      torch.float32, device)
    if not predictor_2d_applicable(grid, bcs):
        raise NotImplementedError(
            "predictor_2d: WALL, INFLOW, SLIP and OUTFLOW faces with "
            "constant values only (ROADMAP Queue A, 'Other BC kinds')"
        )
    if device.type == "cpu":
        return predictor_2d_plain(grid, bcs, u, dt, nu, upwind_gamma)
    _native.cuda_or_raise(device, "predictor_2d")
    if ghosts is None:
        ghosts = ghost_table(grid, bcs)
    out = tuple(torch.empty_like(c) for c in u)
    h = grid.spacing
    f32 = _native.f32
    # the Pallas kernel's constants: 1/h, 1/(2h), 1/h^2 formed in double,
    # then rounded to float32
    _native.launch(
        "predictor2d", "nss_predictor_2d", _ARGTYPES, device,
        *(_native.ptr(t) for t in (*u, *out)),
        *grid.shape,
        *(f32(1.0 / x) for x in h),
        *(f32(1.0 / (2.0 * x)) for x in h),
        *(f32(1.0 / (x * x)) for x in h),
        f32(dt), f32(nu), f32(upwind_gamma), f32(1.0 - upwind_gamma),
        *ghosts,
    )
    LAUNCHES["predictor_2d"] += 1
    return out
