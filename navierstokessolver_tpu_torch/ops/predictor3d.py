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

Fields use the exact MAC layout of :class:`~..grid.State`. The kernels
take the tables of the fused 3D kernels
(:func:`.fused3d.fused_step3d_applicable`): WALL faces and PERIODIC axes
in any mix (the kernels' periodic mask), or on a grid with no periodic
axis WALL, INFLOW, OUTFLOW and SLIP faces with scalar values and no
OUTFLOW face at (0, 0) (their open modes, the faces' kinds read from the
bc buffer, :func:`.fused3d.bc_table`), with or without an obstacle (the
predictor's masked mode: ``code``, the Poisson operator's stencil code).
A CONVECTIVE face at (0, 1) keeps its carried value (the TPU kernel
refuses it; the step transports it after the predictor, as JAX's jnp step
does). Off the walls the predictor takes the LES term only (``nu_t``).
On walls and periodic axes the LES predictor has a forced mode (JAX's jnp
predictor with the subgrid stress merged into the force, which the TPU
kernel route does not take): the static force, forcing volumes and the
Boussinesq force of theta, read as ``fused3d.predictor_rhs_3d`` reads
them (the ``bc`` buffer's force entries, ``fused3d.force_shape``'s
volumes, the scalar's thermal buffer), so one set of ``Simulation``
buffers serves both kernels.
Like ``fused3d.predictor_rhs_3d`` and unlike the TPU kernel,
:func:`predictor_3d` returns u* with the BC values on the boundary faces
(an OUTFLOW face: the inner face's u*) and the obstacle's blocked faces
zeroed, so the step needs no BC pass after it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import les as les_mod
from .. import scalar as scalar_mod
from ..bcs import BCTable, apply_velocity_bcs, periodic_axes
from ..grid import GridSpec
from . import _native, fused3d, step_size, stencils

LAUNCHES = {"nu_t_3d": 0, "predictor_3d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_check, _ptr = _native.check, _native.ptr
_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/predictor3d.cu: pointers (the predictor's stencil
# code, theta, the thermal buffer and the forcing volumes among them, null
# where unused), the three extents, float scalars, the periodic mask, the
# open mask (the predictor: then the forced flag), the stream
_ARGTYPES = {
    "nss_nu_t_3d": [_P] * 5 + [_I] * 3 + [_F] * 4 + [_I] * 2 + [_P],
    "nss_predictor_3d": [_P] * 15 + [_I] * 3 + [_F] * 9 + [_I] * 3 + [_P],
}


def _launch(name: str, device: torch.device, *args) -> None:
    _native.launch("predictor3d", name, _ARGTYPES[name], device, *args)


def _prepare(grid: GridSpec, bcs: BCTable, u, bc, what: str,
             force: fused3d.Force = None):
    """Checks shared by both wrappers; returns (device, bc buffer or None
    on the CPU, periodic mask, open mask). A ``bc`` built here holds
    ``force``."""
    device = fused3d.check_velocity(grid, u, f"{what} u")
    if not fused3d.fused_step3d_applicable(grid, bcs):
        raise NotImplementedError(
            f"{what}: WALL faces and PERIODIC axes, or on a bounded grid "
            "WALL, INFLOW, OUTFLOW, SLIP and CONVECTIVE faces with scalar "
            "values and no OUTFLOW face at (0, 0), only (ROADMAP Queue A, "
            "'Other BC kinds')"
        )
    masks = (fused3d.periodic_mask(periodic_axes(grid, bcs)),
             fused3d.open_mask(grid, bcs))
    if device.type == "cpu":
        return (device, None, *masks)
    _native.cuda_or_raise(device, what)
    if bc is None:
        bc = fused3d.bc_table(grid, bcs, device, force)
    _check(f"{what} bc", bc, (fused3d.BC_SIZE,), torch.float32, device)
    return (device, bc, *masks)


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
    device, bc, per, open_ = _prepare(grid, bcs, u, bc, "nu_t_3d")
    if device.type == "cpu":
        return les_mod.eddy_viscosity(grid, bcs, u, cfg)
    out = torch.empty(grid.shape, dtype=torch.float32, device=device)
    _launch(
        "nss_nu_t_3d", device,
        *(_ptr(t) for t in (*u, bc, out)),
        *grid.shape,
        *nu_t_scalars(grid, cfg), per, open_,
    )
    LAUNCHES["nu_t_3d"] += 1
    return out


# -- per-component predictor (replaces _predictor3d_kernel) -------------------


def predictor_3d_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    nu_t: Optional[torch.Tensor] = None,
    code: Optional[torch.Tensor] = None,
    forcing=None,
) -> tuple[torch.Tensor, ...]:
    """u* with the BC values on the boundary faces; with ``nu_t``, plus the
    subgrid stress divergence of :func:`..les.sgs_forcing`; ``forcing``
    (a number, a tensor in the forcing layout or None a component) added
    to it as JAX's ``_predict`` merges them, ``f + sgs``; with ``code``,
    the BC pass with the obstacle's face masks (JAX's ``_predict``)."""
    if nu_t is not None:
        sgs = les_mod.sgs_forcing(grid, bcs, u, None, nu_t=nu_t)
        forcing = sgs if forcing is None else tuple(
            s if f is None else f + s for f, s in zip(forcing, sgs))
    u_star = stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma, forcing)
    masks = None if code is None else fused3d.masks_from_code(grid, code)[0]
    return apply_velocity_bcs(grid, bcs, u_star, masks)


def predictor_3d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    nu_t: Optional[torch.Tensor] = None, bc: Optional[torch.Tensor] = None,
    code: Optional[torch.Tensor] = None,
    force: fused3d.Force = None,
    force_vol: Optional[Sequence[Optional[torch.Tensor]]] = None,
    theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    thermal: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """u* of all three components in one launch (the BC values written on
    the boundary faces); ``nu_t`` (cell-centred) adds the LES subgrid
    stress divergence, and off the walls it is required. ``bc``: the
    face-value buffer of :func:`.fused3d.bc_table`, with the same ``force``
    (built here when None). ``code``: an obstacle's stencil code
    (``PoissonOp.code``; no periodic axis), the masked mode: blocked faces
    zero. ``dt``: a Python float or a one-element float32 tensor on the
    fields' device, which the kernel reads (element 0 of a step-size
    buffer).

    The forced mode (with ``nu_t``, on walls and periodic axes): ``force``,
    the static force, one number (or None) a component; ``force_vol``,
    forcing volumes (:func:`.fused3d.force_shape`), a component's volume in
    place of its number; ``theta`` with a buoyant ``scalar``, its
    Boussinesq force (``thermal``: the scalar's buffer,
    :func:`..scalar.thermal_table`, built here when None). Their sum is
    added to the subgrid stress, then to the RHS before the multiply by
    dt."""
    device, bc, per, open_ = _prepare(grid, bcs, u, bc, "predictor_3d",
                                      force)
    if nu_t is not None:
        _check("predictor_3d nu_t", nu_t, grid.shape, torch.float32, device)
    elif per or open_ or code is not None:
        raise ValueError(
            "predictor_3d: periodic axes, open faces and an obstacle take "
            "the LES term only (nu_t)"
        )
    periodic = periodic_axes(grid, bcs)
    forced = fused3d.forced(force, force_vol) or theta is not None
    if forced and nu_t is None:
        raise ValueError("predictor_3d: the forced mode is an LES mode "
                         "(nu_t)")
    if forced and (open_ or code is not None):
        raise NotImplementedError(
            "predictor_3d: a force or buoyancy with open faces or an "
            "obstacle (the open modes have no forced instantiation): not "
            "ported yet (ROADMAP Queue A, 'Physics extensions')"
        )
    if theta is not None:
        fused3d.check_buoyant(grid, periodic, theta, scalar, device,
                              "predictor_3d")
    vol_ptrs = fused3d.force_vol_ptrs(grid, periodic, force_vol, device,
                                      "predictor_3d")
    if code is not None:
        fused3d.check_code(grid, code, periodic, device, "predictor_3d")
        if not open_:
            open_ = fused3d.OPEN_KINDS
    if device.type == "cpu":
        forcing = fused3d.plain_forcing(force, force_vol, 3)
        if theta is not None:
            forcing = scalar_mod.combined_forcing(
                forcing, scalar_mod.buoyancy_forcing(grid, scalar, theta))
        return predictor_3d_plain(grid, bcs, u, dt, nu, upwind_gamma, nu_t,
                                  code, forcing)
    th_ptrs = fused3d.thermal_ptrs(grid, theta, scalar, thermal, device,
                                   "predictor_3d")
    dt = step_size.scalar(dt, device, "predictor_3d dt")
    out = tuple(torch.empty_like(c) for c in u)
    _launch(
        "nss_predictor_3d", device,
        *(_ptr(t) for t in u),
        _ptr(nu_t) if nu_t is not None else None,
        *(_ptr(t) for t in (*out, bc, dt)),
        None if code is None else _ptr(code), *th_ptrs, *vol_ptrs,
        *grid.shape,
        *predictor_scalars(grid, nu, upwind_gamma), per, open_, int(forced),
    )
    LAUNCHES["predictor_3d"] += 1
    return out
