"""Fused 2D projection-step kernels: wrappers and their plain versions.

Counterpart of the two Pallas kernels that carry the JAX package's fused
2D step on the TPU (``navierstokessolver_tpu/ops/pallas_2d.py``):

  ===================  ==============================  ======================
  wrapper              replaces                        plain version
  ===================  ==============================  ======================
  predictor_rhs_2d     _pred2d_kernel                  predictor_rhs_2d_plain
  correct_diag_2d      _corr2d_kernel                  correct_diag_2d_plain
                                                       (with theta:
                                                       fused3d.correct_diag_
                                                       thermal_plain)
  ===================  ==============================  ======================

The kernels are CUDA C++ for sm_90a in ``csrc/fused2d.cu`` (built and
loaded by ops/_native.py). Every wrapper checks device, dtype, shape and
contiguity; a tensor on the CPU goes to the plain version, a CUDA tensor
to the kernel, and nothing else. Each kernel launch adds one to
``LAUNCHES[<wrapper name>]``.

Fields use the exact MAC layout of :class:`~..grid.State`: u is
(n0+1, n1), v is (n0, n1+1). The slice supports WALL faces (lid included)
with constant or time-dependent values and PERIODIC axes, per axis and
mixed (face n of a periodic axis repeats face 0), a body force (one number
a component, the JAX kernel's ``force``, static or refilled each step) and
forcing volumes (``force_vol``, :func:`fused3d.force_shape`'s layout; the
JAX package steps those on its jnp predictor), no obstacles (see
:func:`fused_step2d_applicable`). Each kernel takes the periodic axes as a
bit mask (:func:`fused3d.periodic_mask`); the wall values and the force
ride in one device buffer (:func:`bc_table`), so a value that depends on
time is the same launch with the buffer's entry refilled by the step. As
in ops/fused3d.py, the kernels read the step size from a device buffer
(ops/step_size.py), and the predictor's ``base`` runs rk2's stage 2.

Thermal modes (the transported scalar, scalar.py; the TPU kernels'
``theta``): given ``theta`` and a buoyant ``scalar`` configuration, the
predictor adds the Boussinesq term ``g_a beta (theta - theta_ref)``,
averaged to the interior a-faces, to the RHS before the multiply by dt;
given ``theta``, the corrector also returns theta advanced by one explicit
step of the flux-form update with the corrected velocity. Both read the
scalar's ghosts, buoyancy and diffusivity from one device buffer
(:func:`..scalar.thermal_table`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import scalar as scalar_mod
from ..bcs import BCKind, BCTable, is_scalar_value, periodic_axes
from ..grid import GridSpec
from . import _native, fused3d, step_size

LAUNCHES = {"predictor_rhs_2d": 0, "correct_diag_2d": 0}

# A body force: one number a component (a Python float, or a 0-d tensor:
# a time-dependent force's value; None: no force on it).
Force = fused3d.Force
# entries of the kernels' bc buffer: 8 wall values, then the force
BC_SIZE = 10
FORCE_AT = 8

# The corrector's plain version is the dimension-generic composition of the
# plain stencils (the JAX package's jnp step, which its Pallas kernels are
# held to): ``correct_diag_2d_plain(grid, u_star, p, scale, periodic)``
# corrects every face of a periodic axis with the wrap gradient, face n
# repeating face 0.
correct_diag_2d_plain = fused3d.correct_diag_plain

_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/fused2d.cu: pointers (the predictor's base and
# step-size buffer, the corrector's scale among them; theta and the
# thermal buffer, null without the thermal mode; the predictor's forcing
# volumes, null where a component has none), the two extents, float
# scalars, the periodic mask, (predictor) the force flag, (corrector) the
# scalar's wrap mask, the stream
_ARGTYPES = {
    "nss_predictor_rhs_2d": [_P] * 13 + [_I] * 2 + [_F] * 9 + [_I, _I, _P],
    "nss_correct_diag_2d": [_P] * 11 + [_I] * 2 + [_F] * 4 + [_I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_step2d_applicable(grid: GridSpec, bcs: BCTable) -> bool:
    """The kernels take 2D float32 grids whose every face is a WALL with
    scalar values (numbers, or time-dependent ones) or belongs to a
    PERIODIC axis (both faces)."""
    if grid.ndim != 2 or grid.dtype != torch.float32:
        return False
    for a in range(2):
        kinds = (bcs[(a, 0)].kind, bcs[(a, 1)].kind)
        if kinds == (BCKind.PERIODIC, BCKind.PERIODIC):
            continue
        if any(k is not BCKind.WALL for k in kinds) or not all(
                is_scalar_value(v)
                for s in (0, 1) for v in bcs[(a, s)].velocity):
            return False
    return True


def force_values(force: Force) -> tuple[float, float]:
    """The force as the kernel adds it: two floats, 0.0 for a component
    without one."""
    return tuple(fused3d.force_values(force, 2))


def bc_table(grid: GridSpec, bcs: BCTable, device,
             force: Force = None) -> torch.Tensor:
    """The wall values as the kernels read them, float32
    ``[(axis*2 + side)*2 + comp]``, then the body force of each component
    (entries 8 and 9), on ``device``. Build it once per simulation; the
    step then copies nothing from the host."""
    values = [float(bcs[(a, s)].component(c, 2))
              for a in range(2) for s in (0, 1) for c in range(2)]
    return torch.tensor(values + list(force_values(force)),
                        dtype=torch.float32, device=device)


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


def predictor_rhs_2d_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, base: Optional[Sequence[torch.Tensor]] = None,
    force: Force = None, theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    force_vol: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The plain version: ``fused3d.predictor_rhs_plain`` (the JAX jnp
    predictor, BC pass and RHS; wrap stencils on the table's periodic
    axes) with the force's components (a component's volume in place of
    its number) and, with ``theta``, the ``scalar``'s buoyancy
    (``scalar.buoyancy_forcing``) as its forcing, combined as the JAX step
    combines them."""
    forcing = fused3d.plain_forcing(force, force_vol, 2)
    if theta is not None:
        forcing = scalar_mod.combined_forcing(
            forcing, scalar_mod.buoyancy_forcing(grid, scalar, theta))
    return fused3d.predictor_rhs_plain(grid, bcs, u, dt, nu, upwind_gamma,
                                       rho, forcing, base)


def predictor_rhs_2d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, bc: Optional[torch.Tensor] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
    dts: Optional[torch.Tensor] = None, force: Force = None,
    theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    thermal: Optional[torch.Tensor] = None,
    force_vol: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused predictor: one launch writes u*, v* (BC values on the wall
    faces, face n of a periodic axis equal to face 0) and the RHS
    ``(rho/dt) div u*``.

    ``bc``: the buffer from :func:`bc_table`, with the same ``force``
    (built here when None). ``dt``: a Python float or a 0-d tensor;
    ``dts``: its step-size buffer (:mod:`.step_size`, formed here when
    None). ``base``: the step-start velocity, rk2's stage-2 mode (``u`` the
    midpoint field). ``force``: the body force, one number (or None) a
    component, added to the RHS before the multiply by dt; ``force_vol``:
    forcing volumes (:func:`fused3d.force_shape`), a component's volume in
    place of its number. ``theta``
    with a buoyant ``scalar``: the thermal mode, the Boussinesq term of
    ``theta`` added with the force (``thermal``: the scalar's buffer,
    :func:`..scalar.thermal_table`, built here when None).
    """
    device = _check_velocity(grid, u, "predictor_rhs_2d u")
    if not fused_step2d_applicable(grid, bcs):
        raise NotImplementedError(
            "predictor_rhs_2d: WALL faces with constant values and "
            "PERIODIC axes only (ROADMAP Queue A, 'Other BC kinds')"
        )
    base_ptrs = [None, None]
    if base is not None:
        for a in range(2):
            _native.check(f"predictor_rhs_2d base[{a}]", base[a],
                          grid.face_shape(a), torch.float32, device)
        base_ptrs = [_native.ptr(t) for t in base]
    per = periodic_axes(grid, bcs)
    if theta is not None:
        fused3d.check_buoyant(grid, per, theta, scalar, device,
                              "predictor_rhs_2d")
    vol_ptrs = fused3d.force_vol_ptrs(grid, per, force_vol, device,
                                      "predictor_rhs_2d")
    if device.type == "cpu":
        return predictor_rhs_2d_plain(grid, bcs, u, dt, nu, upwind_gamma, rho,
                                      base=base, force=force, theta=theta,
                                      scalar=scalar, force_vol=force_vol)
    _native.cuda_or_raise(device, "predictor_rhs_2d")
    if bc is None:
        bc = bc_table(grid, bcs, device, force)
    _native.check("predictor_rhs_2d bc", bc, (BC_SIZE,), torch.float32,
                  device)
    th_ptrs = fused3d.thermal_ptrs(grid, theta, scalar, thermal, device,
                                   "predictor_rhs_2d")
    dts = step_size.check(step_size.buffer(dt, rho, device) if dts is None
                          else dts, device, "predictor_rhs_2d dts")
    out = tuple(torch.empty_like(c) for c in u)
    rhs = torch.empty(grid.shape, dtype=torch.float32, device=device)
    _launch(
        "nss_predictor_rhs_2d", device,
        *(_native.ptr(t) for t in (*u, *out, rhs, bc)), *base_ptrs,
        _native.ptr(dts), *th_ptrs, *vol_ptrs, *grid.shape,
        *predictor_scalars(grid, nu, upwind_gamma),
        fused3d.periodic_mask(per), int(fused3d.forced(force, force_vol)),
    )
    LAUNCHES["predictor_rhs_2d"] += 1
    return out, rhs


# -- corrector + diagnostics (replaces _corr2d_kernel) ------------------------


def correct_diag_2d(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, periodic: Sequence[bool] = (),
    theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    dt: Optional[step_size.Step] = None,
    thermal: Optional[torch.Tensor] = None,
) -> tuple:
    """Fused corrector: one launch writes u_new and both diagnostics,
    ``max|div u|`` and ``max_a max|u_a|/h_a`` (0-d tensors on the device; a
    NaN anywhere shows in them). ``periodic``: the periodic axes
    (``bcs.periodic_axes``), none when empty; every face of such an axis
    takes the wrap gradient. ``scale`` (dt/rho): a Python float or a
    one-element float32 tensor on the fields' device.

    Thermal mode (``theta``, ``scalar`` and ``dt`` given, ``dt`` as
    ``scale``): the same launch also advances theta by ``dt`` with the
    corrected faces (``thermal``: the scalar's buffer, built here when
    None), and the result gains it: ``(u_new, max_div, max_vel,
    theta_new)``."""
    device = _check_velocity(grid, u_star, "correct_diag_2d u_star")
    _native.check("correct_diag_2d p", p, grid.shape, torch.float32, device)
    if theta is not None:
        fused3d.check_theta(grid, theta, scalar, dt, device, "correct_diag_2d")
    if device.type == "cpu":
        if theta is not None:
            return fused3d.correct_diag_thermal_plain(
                grid, u_star, p, scale, periodic, theta, scalar, dt)
        return correct_diag_2d_plain(grid, u_star, p, scale, periodic)
    _native.cuda_or_raise(device, "correct_diag_2d")
    scale = step_size.scalar(scale, device, "correct_diag_2d scale")
    out = tuple(torch.empty_like(c) for c in u_star)
    maxes = torch.zeros(2, dtype=torch.int32, device=device)
    th = fused3d.corrector_thermal_args(grid, theta, scalar, dt, thermal,
                                        device, "correct_diag_2d")
    _launch(
        "nss_correct_diag_2d", device,
        *(_native.ptr(t) for t in (*u_star, p, *out, maxes, scale)),
        *th["ptrs"], *grid.shape, *fused3d.corrector_scalars(grid),
        *th["inv_hh"], fused3d.periodic_mask(periodic), th["wrap"],
    )
    LAUNCHES["correct_diag_2d"] += 1
    m = maxes.view(torch.float32)
    if theta is not None:
        return out, m[0], m[1], th["out"]
    return out, m[0], m[1]
