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
(n0+1, n1), v is (n0, n1+1). Faces may be WALL, INFLOW, SLIP, OUTFLOW or
CONVECTIVE, with constant values, profiles or time-dependent numbers, or
an axis PERIODIC: every kind of a 2D table (a CONVECTIVE face is one more
entry of the ghost table, a copy, and its own face the caller's update; a
periodic
axis is the kernel's wrap mode: its ghosts wrap, a component's own faces
0..n-1 are all updated and face n repeats face 0, as the plain
predictor's);
a time-dependent value is a number the step resolves and writes into the
ghost table in place (:func:`refill_ghosts`). ``forcing``: one forcing
volume (or None) a component in the plain predictor's layout
(:func:`.fused3d.force_shape`: all n faces of a periodic own axis), added
to the RHS: the JAX step's jnp predictor with a force (a static force,
buoyancy, the LES subgrid stress, any sum of them), which JAX's kernel
route does not take.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bcs import (
    TANGENTIAL_REFLECT_KINDS, BCTable, periodic_axes, tangential_value,
)
from ..grid import GridSpec
from . import _native, fused2d, fused3d, step_size, stencils

LAUNCHES = {"predictor_2d": 0}

_F, _I, _P = _native.F, _native.I, _native.P
# C signature in csrc/predictor2d.cu: pointers (u, v, u*, v*, the ghost
# table, dt, the forcing volumes), the two extents, float scalars
# (spacings, nu, the blend), the periodic mask, the stream
_ARGTYPES = [_P] * 8 + [_I] * 2 + [_F] * 9 + [_I, _P]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ghost_table(grid: GridSpec, bcs: BCTable, device) -> torch.Tensor:
    """The kernel's transverse ghosts ``alpha * edge + beta[pos]`` as one
    float32 buffer on ``device``: alpha of u across the axis-1 low and high
    faces and of v across the axis-0 low and high faces, then the four
    beta vectors in the same order, of n0 + 1 (u, by row) and n1 + 1 (v,
    by column) values (see :func:`ghost_parts`). Across WALL and INFLOW
    faces ``(-1, 2 u_bc)``, a constant broadcast into its vector as a
    profile is; across SLIP, OUTFLOW and CONVECTIVE ``(1, 0)``: the ghosts of
    :func:`..bcs.pad_transverse`, bit for bit; a PERIODIC face's entries
    are ``(1, 0)`` too, which the kernel's wrap modes do not read. Build it
    once per simulation; the step then passes one pointer and copies nothing from
    the host."""
    alpha, betas = [], []
    for comp, axis in ((0, 1), (1, 0)):
        shape = grid.face_shape(comp)
        for side in (0, 1):
            bc = bcs[(axis, side)]
            if bc.kind in TANGENTIAL_REFLECT_KINDS:
                alpha.append(-1.0)
                val = tangential_value(grid, bc, (axis, side), comp, device)
                edge = list(shape)
                edge[axis] = 1
                betas.append((2.0 * val).expand(edge).reshape(shape[comp]))
            else:
                alpha.append(1.0)
                betas.append(torch.zeros(shape[comp], device=device))
    head = torch.tensor(alpha, dtype=torch.float32, device=device)
    return torch.cat([head, *betas])


def ghost_parts(grid: GridSpec, table: torch.Tensor):
    """``(alpha, betas)`` of a :func:`ghost_table`: the 4 alphas, and the
    beta vectors of u across the axis-1 low / high faces and of v across
    the axis-0 low / high faces (views)."""
    n0, n1 = grid.shape
    return table[:4], table[4:].split([n0 + 1, n0 + 1, n1 + 1, n1 + 1])


# the (component, face) of each beta vector of a ghost table, in its order
_BETAS = ((0, (1, 0)), (0, (1, 1)), (1, (0, 0)), (1, (0, 1)))


def refill_ghosts(grid: GridSpec, bcs: BCTable, resolved: BCTable,
                  table: torch.Tensor) -> None:
    """Write the values of ``resolved`` (``bcs`` with its callables of t
    evaluated: numbers or 0-d tensors) into the beta vectors of ``table``
    whose tangential value depends on time, in place and on the device:
    ``beta = 2 u_bc``. The other entries do not change in time."""
    _, betas = ghost_parts(grid, table)
    for beta, (comp, face) in zip(betas, _BETAS):
        spec = bcs[face]
        if (spec.kind in TANGENTIAL_REFLECT_KINDS
                and callable(spec.component(comp, 2))):
            v = resolved[face].component(comp, 2)
            if isinstance(v, torch.Tensor):
                beta.copy_((2.0 * v).expand(beta.shape))
            else:
                beta.fill_(2.0 * float(v))


def predictor_2d_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    forcing: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> tuple[torch.Tensor, ...]:
    """The plain version: ``stencils.predictor`` (the JAX package's jnp
    predictor, which its Pallas kernel is held to), with ``forcing``."""
    return stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma, forcing)


def predictor_2d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    ghosts: Optional[torch.Tensor] = None,
    forcing: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> tuple[torch.Tensor, ...]:
    """``(u*, v*)`` in one launch: the predictor update on every face that
    is not a boundary face of its own axis. Those keep their input value,
    for the caller's BC pass to overwrite (the contract of the JAX
    ``predictor_2d``, whose kernel leaves them garbage).

    ``ghosts``: :func:`ghost_table` on the fields' device (built here when
    None; with a time-dependent value, the caller's table refilled by
    :func:`refill_ghosts`). ``dt``: a Python float or a one-element
    float32 tensor on the fields' device, which the kernel reads (element
    0 of a step-size buffer). ``forcing``: a forcing volume (or None) a
    component, :func:`.fused3d.force_shape`'s layout (all n faces of a
    periodic own axis), added to the RHS before the multiply by dt."""
    if grid.ndim != 2 or len(u) != 2:
        raise ValueError("predictor_2d: the kernel takes 2D fields")
    device = u[0].device
    for a in range(2):
        _native.check(f"predictor_2d u[{a}]", u[a], grid.face_shape(a),
                      torch.float32, device)
    per = periodic_axes(grid, bcs)
    vol_ptrs = fused3d.force_vol_ptrs(grid, per, forcing, device,
                                      "predictor_2d")
    if device.type == "cpu":
        return predictor_2d_plain(grid, bcs, u, dt, nu, upwind_gamma, forcing)
    _native.cuda_or_raise(device, "predictor_2d")
    if ghosts is None:
        ghosts = ghost_table(grid, bcs, device)
    n0, n1 = grid.shape
    _native.check("predictor_2d ghosts", ghosts,
                  (4 + 2 * (n0 + 1) + 2 * (n1 + 1),), torch.float32, device)
    dt = step_size.scalar(dt, device, "predictor_2d dt")
    out = tuple(torch.empty_like(c) for c in u)
    _native.launch(
        "predictor2d", "nss_predictor_2d", _ARGTYPES, device,
        *(_native.ptr(t) for t in (*u, *out, ghosts, dt)), *vol_ptrs,
        # kernel 4's float arguments: the same constants
        n0, n1, *fused2d.predictor_scalars(grid, nu, upwind_gamma),
        fused3d.periodic_mask(per),
    )
    LAUNCHES["predictor_2d"] += 1
    return out
