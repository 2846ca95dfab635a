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
supports WALL faces (lid included) with constant or time-dependent values
and PERIODIC axes, per axis and mixed, and on grids with no periodic axis
also INFLOW, OUTFLOW and SLIP faces and a CONVECTIVE outlet at (0, 1) (see
:func:`fused_step3d_applicable`). Each kernel takes the periodic axes as a
bit mask (:func:`periodic_mask`) and the open faces as another
(:func:`open_mask`: the OUTFLOW faces, whether any face is neither a WALL
nor PERIODIC, and the CONVECTIVE face). The kernels read the face values
(a CONVECTIVE face's: its phase speed) and the kinds' ghost maps from a
device buffer (:func:`bc_table`), so a value that depends on time is the
same launch with the buffer's entry refilled by the step. A table with an
open face runs the kernels' open mode (with a force and a scalar too);
with a CONVECTIVE face its convective variant (neither a force nor a
scalar): the predictor transports the
outlet face from the carried one (rk2's stage 2: from ``base``'s) by the
inner face's u*, the corrector adds its Dirichlet-ghost correction
(:func:`..bcs.apply_convective_outlets`, :func:`..bcs.correct_convective_
faces`).

Masked mode (an obstacle; the TPU kernels' ``face_codes`` and
``fluid_code``, unsharded, no periodic axis): both
kernels take the Poisson operator's stencil code (``op.code``, one byte a
cell) and derive every face's open and correction bits from it, as
:func:`masks_from_code` does: u* zero on blocked faces, the RHS zero in
solid cells, the correction on faces between two fluid cells, max|div u|
over fluid cells. :func:`predictor_rhs_plain` and
:func:`correct_diag_plain` with ``code`` are the JAX jnp step's
``_predict`` and ``_project`` with the obstacle's masks.

Coded mode of the corrector (the sharp interface: the 3D IBM of a moving
body and the cut-cell pressure; the TPU kernels' face codes with a wet
face OPEN and never CORR, and their kernel-only fluid code with the cut
band's FLUID bit cleared): :func:`correct_diag_3d` given a 16-bit code
(:func:`corrector_code`, int16) in place of the stencil code: its low
byte the stencil code's bits 0-6 (the masked mode's masks) and bit 7,
``DIV_SKIP``, a cell left out of max|div u| (the cut band: the step folds
the band's apertured divergence in, cutcell.fused_div_max_cut), and bits
``WET_SHIFT + 2a + s``: face ``s`` of axis ``a`` of the cell is a moving
body's wet face, which keeps u* (no correction, not zeroed) and counts in
both maxima. :func:`correct_diag_plain` takes the same code.

Forced mode (the TPU kernel's ``forcing`` and ``forcing_fields``): the
predictor adds a body force to the RHS before the multiply by dt, from the
buffer's force entries (``force``: one number a component, static or
refilled each step) or from forcing volumes (``force_vol``: one tensor a
component in the plain predictor's forcing layout, :func:`force_shape`:
the interior faces of a bounded own axis, all n faces of a periodic one,
whose face n the kernel reads as face 0).

The halo mode of the predictor and the corrector (the TPU kernels'
``halo=True``) runs one slab of the sharded step
(parallel/fused_sharded.py): :func:`predictor_rhs_3d_halo` and
:func:`correct_diag_3d_halo` take a slab's buffers in the layout of
:func:`halo_shape`, whose axis-0 ghost rows hold the neighbouring slabs'
rows, and ``halo = (lo, hi)``: which sides of axis 0 border another slab.
A side that does not is a domain wall, as in the unsharded kernels.

The step size reaches the kernels through a device buffer
(ops/step_size.py): the predictor reads dt and rho/dt from it, the
corrector its ``scale`` dt/rho, so a dt computed on the device (the
CFL-adaptive step) costs no host read. The wrappers take ``dt`` and
``scale`` as Python floats or 0-d tensors, and the predictor the
simulation's buffer as ``dts``. With ``base`` (the step-start velocity),
the predictor runs rk2's stage-2 mode, as the TPU kernel's ``base``:
``u* = base + dt*RHS(u)``, with ``u`` the midpoint field.

Thermal modes (the transported scalar, scalar.py; the TPU kernels'
``theta``, unsharded only): given ``theta`` and a buoyant ``scalar``, the
predictor adds the Boussinesq term ``g_a beta (theta - theta_ref)``
averaged to the interior a-faces; given ``theta``, the corrector also
advances it by one explicit step of the flux-form update with the
corrected velocity (:func:`correct_diag_thermal_plain` is its plain
version). Both read the scalar's ghosts, buoyancy and diffusivity from one
device buffer (:func:`..scalar.thermal_table`). With open faces the
corrector advances theta with the final faces (an OUTFLOW face's copy
included); with an obstacle (the masked mode, the heated bodies) its
solid cells keep their value (an adiabatic ``body_bc``, whose diffusive
flux through every closed face is zero) or take the body's (isothermal),
the JAX jnp step's freeze (an isothermal body's solid neighbours read as
its value, whatever the solid cells hold on entry, as the plain version's
clamp before its fluxes). The
predictor adds the force and the buoyancy before the masks, in either
mode. A CONVECTIVE face takes neither (JAX's gates).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import scalar as scalar_mod
from ..bcs import (
    BCKind, BCSpec, BCTable, apply_convective_outlets, apply_velocity_bcs,
    correct_convective_faces, has_convective_outlet, has_outflow,
    is_scalar_value, periodic_axes,
)
from ..grid import GridSpec, slab_grid
from . import _native, step_size, stencils
from .poisson import PoissonOp, apply_A

LAUNCHES = {"predictor_rhs_3d": 0, "correct_diag_3d": 0, "residual_3d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_OPEN_KINDS = (BCKind.WALL, BCKind.INFLOW, BCKind.OUTFLOW, BCKind.SLIP,
               BCKind.CONVECTIVE)


def open_kinds_ok(grid: GridSpec, bcs: BCTable) -> bool:
    """Every face a WALL, INFLOW, OUTFLOW, SLIP or CONVECTIVE face with
    scalar values (numbers, callables of t, or their 0-d values; a
    CONVECTIVE face's phase speed a number) or on a PERIODIC axis, a
    CONVECTIVE face only at (0, 1) (JAX's gates), and no open face with a
    periodic axis: the tables of the kernels' walls, periodic and open
    modes in 2D and 3D."""
    if not walls_and_periodic(grid, bcs) and any(periodic_axes(grid, bcs)):
        return False
    for a in range(grid.ndim):
        kinds = (bcs[(a, 0)].kind, bcs[(a, 1)].kind)
        if kinds == (BCKind.PERIODIC, BCKind.PERIODIC):
            continue
        for s in (0, 1):
            spec = bcs[(a, s)]
            if spec.kind not in _OPEN_KINDS:
                return False
            if spec.kind is BCKind.CONVECTIVE:
                if (a, s) != (0, 1) or not all(
                        isinstance(v, (int, float)) for v in spec.velocity):
                    return False
            elif not all(is_scalar_value(v) for v in spec.velocity):
                return False
    return True


def fused_step3d_applicable(grid: GridSpec, bcs: BCTable) -> bool:
    """The kernels take 3D float32 grids whose every face is a WALL,
    INFLOW, OUTFLOW or SLIP face with scalar values (numbers, or
    time-dependent ones: callables of t, or their 0-d values) or belongs
    to a PERIODIC axis (both faces), or a CONVECTIVE face at (0, 1) with a
    numeric phase speed, but no OUTFLOW face at (0, 0) and no open face
    with a periodic axis: the JAX gate
    (``pallas_kernels.fused_step3d_applicable`` with ``allow_traced``)
    with the open mode on bounded grids only (:func:`open_kinds_ok`).
    Obstacles are the caller's (the masked mode)."""
    if grid.ndim != 3 or grid.dtype != torch.float32:
        return False
    if bcs[(0, 0)].kind is BCKind.OUTFLOW:
        return False
    return open_kinds_ok(grid, bcs)


def walls_and_periodic(grid: GridSpec, bcs: BCTable) -> bool:
    """Every face a WALL or on a PERIODIC axis: the tables of the halo
    mode (the slab tier), which takes no open face."""
    return all(bcs[(a, s)].kind in (BCKind.WALL, BCKind.PERIODIC)
               for a in range(grid.ndim) for s in (0, 1))


def periodic_mask(periodic) -> int:
    """The kernels' ``per`` argument: bit ``a`` set for a periodic axis."""
    return sum(1 << a for a, p in enumerate(periodic) if p)


OPEN_KINDS = 64
OPEN_CONV = 128
# the corrector's ``open`` bit for the 16-bit corrector code (its coded
# mode, :func:`corrector_code`)
OPEN_CODED = 256
# bits of the corrector code above the stencil code's: the cell is left out
# of max|div u|; face s of axis a is a wet face (bit WET_SHIFT + 2a + s)
DIV_SKIP = 7
WET_SHIFT = 8


def open_mask(grid: GridSpec, bcs: Optional[BCTable]) -> int:
    """The kernels' ``open`` argument: bit ``2 axis + side`` set for an
    OUTFLOW face, whose boundary value copies the inner face,
    ``OPEN_KINDS`` where a face is neither a WALL nor PERIODIC (the open
    mode, its kinds read from the bc buffer), and ``OPEN_CONV`` for a
    CONVECTIVE face at (0, 1) (the open mode's convective variant); 0
    without a table. The 2D kernels take the same mask."""
    if bcs is None or walls_and_periodic(grid, bcs):
        return 0
    conv = OPEN_CONV if bcs[(0, 1)].kind is BCKind.CONVECTIVE else 0
    return OPEN_KINDS | conv | sum(
        1 << (2 * a + s) for a in range(grid.ndim) for s in (0, 1)
        if bcs[(a, s)].kind is BCKind.OUTFLOW)


# entries of the kernels' bc buffer: 18 face values, the force, then the
# ghost map of each face value
BC_SIZE = 39
FORCE_AT = 18
ALPHA_AT = 21


def ghost_alpha(spec: BCSpec, axis: int, comp: int) -> float:
    """The kernels' ghost map of component ``comp`` on a face of ``axis``
    (ghost = alpha edge + (1 - alpha) value; JAX's ``_tangential_ghost``
    and ``_own_face_spec``): a tangential component reflects across WALL
    and INFLOW faces (-1) and copies the edge across SLIP and OUTFLOW
    faces (1); the face's own component copies the inner face on an
    OUTFLOW face (1) and is Dirichlet elsewhere (0; a CONVECTIVE face's
    own value is its phase speed, which only the convective variant
    reads). CONVECTIVE faces copy the edge as OUTFLOW faces do."""
    if comp == axis:
        return 1.0 if spec.kind is BCKind.OUTFLOW else 0.0
    return 1.0 if spec.kind in (BCKind.SLIP, BCKind.OUTFLOW,
                                BCKind.CONVECTIVE) else -1.0


def face_value(spec: BCSpec, axis: int, comp: int, ndim: int) -> float:
    """Component ``comp``'s value on a face of ``axis`` as the kernels'
    buffers hold it: the BC value, or on a CONVECTIVE face its phase speed
    in the face's own component (0 in the others)."""
    if spec.kind is BCKind.CONVECTIVE:
        return spec.convective_speed() if comp == axis else 0.0
    return float(spec.component(comp, ndim))

# A static body force: one number (a Python float, or a 0-d tensor: a
# time-dependent force's value) or None a component; None: no force.
Force = Optional[Sequence]


def force_values(force: Force, ndim: int) -> list[float]:
    """The force as the kernels' buffer holds it: ``ndim`` floats, 0.0
    for a component without one."""
    if force is None:
        return [0.0] * ndim
    return [0.0 if f is None else float(f) for f in force]


def bc_table(grid: GridSpec, bcs: BCTable, device,
             force: Force = None) -> torch.Tensor:
    """The face values as the kernels read them: float32
    ``[(axis*2 + side)*3 + comp]``, then the body force of each component
    (entries 18..20), then each value's ghost map (:func:`ghost_alpha`,
    entries 21..38), on ``device``. Build it once per simulation; the
    step then copies nothing from the host (a time-dependent value is
    refilled in place, on the device)."""
    faces = [(a, s, c) for a in range(3) for s in (0, 1) for c in range(3)]
    values = [face_value(bcs[(a, s)], a, c, 3) for a, s, c in faces]
    alphas = [ghost_alpha(bcs[(a, s)], a, c) for a, s, c in faces]
    return torch.tensor(values + force_values(force, 3) + alphas,
                        dtype=torch.float32, device=device)


def force_shape(grid: GridSpec, periodic: Sequence[bool],
                a: int) -> tuple[int, ...]:
    """The forcing layout of component ``a`` (the plain predictor's): its
    interior faces along a bounded own axis (n - 1), all n faces along a
    periodic one."""
    shape = list(grid.shape)
    if not periodic[a]:
        shape[a] -= 1
    return tuple(shape)


def force_vol_ptrs(grid: GridSpec, periodic: Sequence[bool], force_vol,
                   device, what: str) -> list:
    """The kernels' volume pointers (null for a component without one),
    after checking each volume as a field is checked."""
    if force_vol is None:
        return [None] * grid.ndim
    if len(force_vol) != grid.ndim:
        raise ValueError(f"{what}: force_vol needs {grid.ndim} components")
    ptrs = []
    for a, v in enumerate(force_vol):
        if v is None:
            ptrs.append(None)
            continue
        _check(f"{what} force_vol[{a}]", v, force_shape(grid, periodic, a),
               torch.float32, device)
        ptrs.append(_ptr(v))
    return ptrs


def plain_forcing(force: Force, force_vol, ndim: int):
    """The plain predictor's forcing of a static ``force`` and forcing
    volumes ``force_vol``: a component's volume where it has one, else its
    number (None where it has neither); None without either."""
    if force is None and force_vol is None:
        return None
    out = []
    for a in range(ndim):
        v = force_vol[a] if force_vol is not None else None
        out.append(v if v is not None else
                   (None if force is None else force[a]))
    return tuple(out)


def forced(force: Force, force_vol) -> bool:
    """The forced mode is on: a component has a number or a volume."""
    return any(f is not None for f in (force or ())) or any(
        v is not None for v in (force_vol or ()))


def check_velocity(grid: GridSpec, u: Sequence[torch.Tensor], what: str):
    """Raise unless ``u`` is a 3D float32 velocity in the exact MAC layout,
    all on one device; returns that device."""
    if grid.ndim != 3 or len(u) != 3:
        raise ValueError(f"{what}: the 3D kernels take 3D fields only")
    device = u[0].device
    for a in range(3):
        _check(f"{what}[{a}]", u[a], grid.face_shape(a), torch.float32, device)
    return device


def masks_from_code(grid: GridSpec, code: torch.Tensor):
    """``(face_masks, corr_masks, fluid)`` of an obstacle from the Poisson
    operator's stencil code, as the masked kernels derive them: a face is
    open when both its cells are fluid (an interior face: the fluid
    neighbour bit of the cell above it) or its one cell is (a boundary
    face), an interior face is corrected where it is open. Bit for bit
    :func:`..bcs.face_masks_from_solid` and
    :func:`..bcs.correction_face_masks` of a bounded grid; float32."""
    fluid = ((code >> 6) & 1).to(torch.float32)
    opened, corr = [], []
    for a in range(grid.ndim):
        n = grid.shape[a]
        inner = ((code >> (2 * a)) & 1).to(torch.float32).narrow(a, 1, n - 1)
        opened.append(torch.cat([fluid.narrow(a, 0, 1), inner,
                                 fluid.narrow(a, n - 1, 1)], dim=a))
        corr.append(inner)
    return tuple(opened), tuple(corr), fluid


def corrector_code(grid: GridSpec, code: torch.Tensor, wet=None,
                   skip=None) -> torch.Tensor:
    """The corrector's 16-bit code (int16, on ``code``'s device): the
    stencil code ``code`` with bit ``DIV_SKIP`` set in the cells of
    ``skip`` (bool, the grid's shape) and bit ``WET_SHIFT + 2a + s`` in
    each cell whose face on side ``s`` of axis ``a`` is set in ``wet[a]``
    (the full face masks of a moving body's wet faces; numpy arrays). The
    two cells of a face both carry it."""
    out = code.to(torch.int16)
    dev = code.device
    if skip is not None:
        out |= torch.as_tensor(np.asarray(skip, bool)).to(
            dev).to(torch.int16) << DIV_SKIP
    if wet is not None:
        for a in range(grid.ndim):
            w = torch.as_tensor(np.asarray(wet[a]) > 0).to(dev)
            n = grid.shape[a]
            out |= w.narrow(a, 0, n).to(torch.int16) << (WET_SHIFT + 2 * a)
            out |= w.narrow(a, 1, n).to(torch.int16) << (
                WET_SHIFT + 2 * a + 1)
    return out


def wet_from_code(grid: GridSpec, code: torch.Tensor) -> tuple:
    """The wet-face masks (bool, per component) a corrector code holds:
    face i of axis a is wet where cell i has its low bit or cell i - 1 its
    high bit."""
    out = []
    for a in range(grid.ndim):
        n = grid.shape[a]
        lo = ((code >> (WET_SHIFT + 2 * a)) & 1).bool()
        hi = ((code >> (WET_SHIFT + 2 * a + 1)) & 1).bool()
        w = torch.zeros(grid.face_shape(a), dtype=torch.bool,
                        device=code.device)
        w.narrow(a, 0, n).logical_or_(lo)
        w.narrow(a, 1, n).logical_or_(hi)
        out.append(w)
    return tuple(out)


_check, _ptr, _f32 = _native.check, _native.ptr, _native.f32
_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/fused3d.cu: pointers (the predictor's base and
# step-size buffer, the corrector's scale among them; theta and the
# thermal buffer, null without the thermal mode; the predictor's forcing
# volumes, null where a component has none; the stencil code, null
# without the masked mode), the three extents, float scalars, the
# periodic mask, (predictor and corrector) the halo mask, (predictor) the
# force flag, (corrector) the scalar's wrap mask, the open mask
# (:func:`open_mask`), the stream
_ARGTYPES = {
    "nss_predictor_rhs_3d": [_P] * 18 + [_I] * 3 + [_F] * 12 + [_I] * 4
    + [_P],
    "nss_correct_diag_3d": [_P] * 14 + [_I] * 3 + [_F] * 6 + [_I] * 4
    + [_P],
    "nss_residual_3d": [_P] * 5 + [_I] * 3 + [_F] * 3 + [_I, _P],
}


def _launch(name: str, device: torch.device, *args) -> None:
    _native.launch("fused3d", name, _ARGTYPES[name], device, *args)


def predictor_scalars(grid: GridSpec, nu: float,
                      upwind_gamma: float) -> list[float]:
    """Kernel 1's float arguments, in the order of its C signature:
    ``1/(2h_a)``, ``1/h_a`` and ``1/h_a^2`` (a = 0..2), the constants the
    kernel multiplies by, formed as the JAX kernels form them
    (``pallas_kernels.py`` ``inv2h``, ``invh``, ``invh2``: Python double,
    then float32); nu, gamma, 1 - gamma. dt and rho/dt come from the
    step-size buffer."""
    h = np.asarray(grid.spacing, dtype=np.float64)
    vals = np.concatenate([1.0 / (2.0 * h), 1.0 / h, 1.0 / (h * h),
                           [nu, upwind_gamma, 1.0 - upwind_gamma]])
    return vals.astype(np.float32).tolist()


def corrector_scalars(grid: GridSpec) -> list[float]:
    """Kernel 2's float arguments: ``1/h_a`` (as in
    :func:`predictor_scalars`); dt/rho comes through a pointer."""
    h = np.asarray(grid.spacing, dtype=np.float64)
    return (1.0 / h).astype(np.float32).tolist()


def _base_ptrs(grid: GridSpec, base, device, what: str, shape=None,
               ptr=None) -> list:
    """The three base pointers of kernel 1 (null for the Euler form),
    after checking ``base`` as the velocity is checked."""
    if base is None:
        return [None] * 3
    for a in range(3):
        _check(f"{what} base[{a}]", base[a],
               grid.face_shape(a) if shape is None else shape(grid, a),
               torch.float32, device)
    return [(ptr or _ptr)(t) for t in base]


def _check_theta_field(grid: GridSpec, theta, scalar, device, what: str):
    _check(f"{what} theta", theta, grid.shape, torch.float32, device)
    if scalar is None:
        raise ValueError(f"{what}: theta needs its scalar configuration")


def check_buoyant(grid: GridSpec, periodic, theta, scalar, device,
                  what: str) -> None:
    """Raise unless the predictor's thermal mode can take ``theta``: the
    grid's shape, float32, on ``device``, with a buoyant ``scalar`` whose
    buoyancy is along bounded axes only (as ``Simulation.build``
    requires)."""
    _check_theta_field(grid, theta, scalar, device, what)
    if not scalar.buoyant:
        raise ValueError(f"{what}: theta given with a scalar that has no "
                         "buoyancy (the passive scalar needs no predictor "
                         "term)")
    if any(b != 0.0 and periodic[a] for a, b in enumerate(scalar.buoyancy)):
        raise ValueError(f"{what}: Boussinesq buoyancy along a periodic "
                         "axis is not supported")


def check_theta(grid: GridSpec, theta, scalar, dt, device, what: str) -> None:
    """Raise unless the corrector's thermal mode can take ``theta``."""
    _check_theta_field(grid, theta, scalar, device, what)
    if dt is None:
        raise ValueError(f"{what}: theta needs the step's dt")


def _thermal_buffer(grid: GridSpec, scalar, thermal, device, what: str):
    if thermal is None:
        thermal = scalar_mod.thermal_table(scalar, grid.ndim, device)
    _check(f"{what} thermal", thermal,
           (scalar_mod.thermal_table_size(grid.ndim),), torch.float32, device)
    return thermal


def thermal_ptrs(grid: GridSpec, theta, scalar, thermal, device,
                 what: str) -> list:
    """The predictor's theta and thermal-buffer pointers (both null
    without the thermal mode)."""
    if theta is None:
        return [None, None]
    return [_ptr(theta),
            _ptr(_thermal_buffer(grid, scalar, thermal, device, what))]


def corrector_thermal_args(grid: GridSpec, theta, scalar, dt, thermal,
                           device, what: str) -> dict:
    """The corrector's thermal arguments: ``ptrs`` (theta, the new theta,
    the thermal buffer, dt; null without the thermal mode), ``inv_hh``
    (1/h_a^2 as the JAX kernels form them: Python double, then float32),
    ``wrap`` (the scalar's wrap mask) and ``out`` (the new theta)."""
    nd = grid.ndim
    if theta is None:
        return {"ptrs": [None] * 4, "inv_hh": [0.0] * nd, "wrap": 0,
                "out": None}
    out = torch.empty_like(theta)
    buf = _thermal_buffer(grid, scalar, thermal, device, what)
    dt = step_size.scalar(dt, device, f"{what} dt")
    h = np.asarray(grid.spacing, dtype=np.float64)
    return {"ptrs": [_ptr(theta), _ptr(out), _ptr(buf), _ptr(dt)],
            "inv_hh": (1.0 / (h * h)).astype(np.float32).tolist(),
            "wrap": scalar_mod.wrap_mask(scalar, nd), "out": out}


def check_code(grid: GridSpec, code: torch.Tensor, periodic, device,
               what: str, coded: bool = False) -> None:
    """Raise unless ``code`` is a stencil code the masked mode takes:
    uint8 of the grid's shape on ``device`` (``coded``: the corrector code
    too, int16), no periodic axis (JAX's gate refuses periodic axes with
    an obstacle)."""
    dtype = (torch.int16 if coded and code.dtype == torch.int16
             else torch.uint8)
    _check(f"{what} code", code, grid.shape, dtype, device)
    if any(periodic):
        raise NotImplementedError(
            f"{what}: an obstacle on a grid with a periodic axis (JAX's "
            "fused gate refuses it too; its jnp step): not ported yet "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )


def _code_ptr(code: Optional[torch.Tensor]):
    return None if code is None else _ptr(code)


# -- predictor + BCs + Poisson RHS (replaces _fused_pred_kernel) --------------


def predictor_rhs_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, forcing: Optional[Sequence[torch.Tensor]] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
    code: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """u* (BC values on the boundary faces) and the Poisson RHS
    ``(rho/dt) div u*``, from the plain stencils; any dimension.
    ``forcing``: per-face terms added to the predictor's RHS (the LES
    subgrid stress in ``Simulation.step_plain``); ``base``: rk2's stage-2
    mode, ``u* = base + dt*RHS(u)``; ``code``: an obstacle's stencil code
    (the masked mode: the BC pass with the face masks, the RHS on fluid
    cells, as JAX's ``_predict`` and ``_project``). A CONVECTIVE face takes
    its transport update after the BC pass, from the step-start field
    (``base``, else ``u``), as JAX's jnp step applies it."""
    u_star = stencils.predictor(grid, bcs, u, dt, nu, upwind_gamma, forcing,
                                base)
    masks = None if code is None else masks_from_code(grid, code)
    u_star = apply_velocity_bcs(grid, bcs, u_star,
                                None if masks is None else masks[0])
    if has_convective_outlet(grid, bcs):
        u_star = apply_convective_outlets(grid, bcs, u_star,
                                          u if base is None else base, dt)
    rhs = stencils.poisson_rhs(grid, u_star, dt, rho)
    return u_star, rhs if masks is None else rhs * masks[2]


def predictor_rhs_3d(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, bc: Optional[torch.Tensor] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
    dts: Optional[torch.Tensor] = None,
    theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    thermal: Optional[torch.Tensor] = None,
    force: Force = None,
    force_vol: Optional[Sequence[Optional[torch.Tensor]]] = None,
    code: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused predictor: one launch writes u0*, u1*, u2* and the RHS.

    ``bc``: the buffer from :func:`bc_table`, with the same ``force``
    (built here when None). ``force``: the static body force, one number
    (or None) a component, added to the RHS before the multiply by dt;
    ``force_vol``: forcing volumes (:func:`force_shape`), a component's
    volume in place of its number. ``dt``: a Python float or a 0-d tensor;
    ``dts``: its
    step-size buffer (:mod:`.step_size`, formed here when None; the kernel
    reads dt and rho/dt from it). ``base``: the step-start velocity, rk2's
    stage-2 mode (``u`` the midpoint field). ``theta`` with a buoyant
    ``scalar``: the thermal mode, the Boussinesq term of ``theta`` added
    to the RHS (``thermal``: the scalar's buffer,
    :func:`..scalar.thermal_table`, built here when None). ``code``: the
    masked mode, an obstacle's stencil code (``PoissonOp.code``; no
    periodic axis). A CONVECTIVE face takes no force and no theta.
    """
    device = check_velocity(grid, u, "predictor_rhs_3d u")
    if not fused_step3d_applicable(grid, bcs):
        raise NotImplementedError(
            "predictor_rhs_3d: WALL faces and PERIODIC axes, or on a bounded "
            "grid WALL, INFLOW, OUTFLOW and SLIP faces, with scalar values "
            "and no OUTFLOW face at (0, 0) only (ROADMAP Queue A, 'Other BC "
            "kinds')"
        )
    base_ptrs = _base_ptrs(grid, base, device, "predictor_rhs_3d")
    per = periodic_axes(grid, bcs)
    if theta is not None:
        check_buoyant(grid, per, theta, scalar, device, "predictor_rhs_3d")
    vol_ptrs = force_vol_ptrs(grid, per, force_vol, device,
                              "predictor_rhs_3d")
    if code is not None:
        check_code(grid, code, per, device, "predictor_rhs_3d")
    conv = open_mask(grid, bcs) & OPEN_CONV
    if conv and theta is not None:
        raise NotImplementedError(
            "predictor_rhs_3d: theta with a CONVECTIVE face (JAX's fused gate "
            "refuses it, its jnp step runs it): not ported yet (ROADMAP "
            "Queue A, 'Other BC kinds')"
        )
    if conv and forced(force, force_vol):
        raise NotImplementedError(
            "predictor_rhs_3d: a force with a CONVECTIVE face (the "
            "convective variant has no forced instantiation): not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )
    if device.type == "cpu":
        forcing = plain_forcing(force, force_vol, 3)
        if theta is not None:
            forcing = scalar_mod.combined_forcing(
                forcing, scalar_mod.buoyancy_forcing(grid, scalar, theta))
        return predictor_rhs_plain(grid, bcs, u, dt, nu, upwind_gamma, rho,
                                   forcing, base=base, code=code)
    _native.cuda_or_raise(device, "predictor_rhs_3d")
    if bc is None:
        bc = bc_table(grid, bcs, device, force)
    _check("predictor_rhs_3d bc", bc, (BC_SIZE,), torch.float32, device)
    th_ptrs = thermal_ptrs(grid, theta, scalar, thermal, device,
                           "predictor_rhs_3d")
    dts = step_size.check(step_size.buffer(dt, rho, device) if dts is None
                          else dts, device, "predictor_rhs_3d dts")
    out = tuple(torch.empty_like(c) for c in u)
    rhs = torch.empty(grid.shape, dtype=torch.float32, device=device)
    n0, n1, n2 = grid.shape
    _launch(
        "nss_predictor_rhs_3d", device,
        *(_ptr(t) for t in (*u, *out, rhs, bc)), *base_ptrs, _ptr(dts),
        *th_ptrs, *vol_ptrs, _code_ptr(code), n0, n1, n2,
        *predictor_scalars(grid, nu, upwind_gamma), periodic_mask(per), 0,
        int(forced(force, force_vol)), open_mask(grid, bcs),
    )
    LAUNCHES["predictor_rhs_3d"] += 1
    return out, rhs


# -- corrector + diagnostics (replaces _fused_corr_kernel) --------------------


def correct_diag_plain(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, periodic: Sequence[bool] = (),
    bcs: Optional[BCTable] = None, code: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """``u = u* - scale grad p`` on interior faces (every face of a
    ``periodic`` axis), plus ``max|div u|`` and ``max_a max|u_a|/h_a``; any
    dimension. ``scale`` (dt/rho): a Python float or a 0-d tensor. With an
    OUTFLOW face in ``bcs`` the BC pass follows (the copy tracks the
    corrected inner face; JAX's ``_project``), with a CONVECTIVE face its
    Dirichlet-ghost correction first. ``code``: an obstacle's stencil code
    (the masked mode): the correction on faces between two fluid cells,
    blocked faces zeroed, max|div u| over fluid cells; a 16-bit corrector
    code (:func:`corrector_code`) also keeps u* on its wet faces and leaves
    its DIV_SKIP cells out of max|div u|. Without it every cell is
    fluid."""
    masks = None if code is None else masks_from_code(grid, code)
    u_new = stencils.correct_velocity(grid, u_star, p, scale,
                                      None if masks is None else masks[1],
                                      periodic=periodic)
    if bcs is not None and has_convective_outlet(grid, bcs):
        u_new = correct_convective_faces(grid, bcs, u_new, p, scale)
    if bcs is not None and has_outflow(grid, bcs):
        u_new = apply_velocity_bcs(grid, bcs, u_new,
                                   None if masks is None else masks[0])
    elif masks is not None:
        u_new = tuple(c * m for c, m in zip(u_new, masks[0]))
    coded = code is not None and code.dtype == torch.int16
    if coded:
        u_new = tuple(torch.where(w, s, c) for w, s, c in
                      zip(wet_from_code(grid, code), u_star, u_new))
    div = stencils.divergence(grid, u_new)
    if masks is not None:
        div = div * masks[2]
    if coded:
        div = div * (1 - ((code >> DIV_SKIP) & 1)).to(div.dtype)
    max_div = div.abs().max()
    h = grid.spacing
    max_vel = torch.stack(
        [(c / h[a]).abs().max() for a, c in enumerate(u_new)]
    ).max()
    return u_new, max_div, max_vel


def correct_diag_thermal_plain(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, periodic: Sequence[bool],
    theta: torch.Tensor, scalar: scalar_mod.ScalarConfig,
    dt: step_size.Step, bcs: Optional[BCTable] = None,
    code: Optional[torch.Tensor] = None,
) -> tuple:
    """The thermal corrector's plain version, any dimension:
    :func:`correct_diag_plain` (``bcs``: the open faces; ``code``: an
    obstacle's stencil code, the masked mode), then ``theta + dt *
    scalar_rhs(u_new, theta)`` with the obstacle's solid cells (the code's
    cells without the fluid bit) under ``scalar.body_bc``: the diffusive
    flux closed on its faces for an adiabatic body (the TPU kernel's
    ``body_neumann``), the solid cells frozen (``scalar.advance``, JAX's
    jnp step). Returns ``(u_new, max_div, max_vel, theta_new)``."""
    u_new, max_div, max_vel = correct_diag_plain(grid, u_star, p, scale,
                                                 periodic, bcs, code)
    solid = None if code is None else ((code >> 6) & 1) == 0
    return (u_new, max_div, max_vel,
            scalar_mod.advance(grid, scalar, u_new, theta, dt, solid))


def correct_diag_3d(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, periodic: Sequence[bool] = (),
    theta: Optional[torch.Tensor] = None,
    scalar: Optional[scalar_mod.ScalarConfig] = None,
    dt: Optional[step_size.Step] = None,
    thermal: Optional[torch.Tensor] = None,
    bcs: Optional[BCTable] = None,
    code: Optional[torch.Tensor] = None,
) -> tuple:
    """Fused corrector: one launch writes u_new and both diagnostics (0-d
    tensors on the device; a NaN anywhere shows in them). ``periodic``:
    the periodic axes (``bcs.periodic_axes``), none when empty. ``scale``
    (dt/rho): a Python float or a one-element float32 tensor on the
    fields' device, which the kernel reads (element 2 of a step-size
    buffer). ``bcs``: the table, for its open faces (an OUTFLOW face's
    boundary value copies the corrected inner face; None: walls and
    periodic axes only). ``code``: the masked mode, an obstacle's stencil
    code (no periodic axis), or the coded mode, a 16-bit corrector code
    (:func:`corrector_code`).

    Thermal mode (``theta``, ``scalar`` and ``dt`` given, ``dt`` as
    ``scale``): the same launch also advances theta by ``dt`` with the
    corrected faces (``thermal``: the scalar's buffer, built here when
    None), and the result gains it: ``(u_new, max_div, max_vel,
    theta_new)``. With open faces and with a stencil code (an obstacle,
    whose ``scalar.body_bc`` is required: its solid cells frozen, an
    adiabatic body's closed faces without diffusive flux); not with a
    CONVECTIVE face or a corrector code."""
    device = check_velocity(grid, u_star, "correct_diag_3d u_star")
    _check("correct_diag_3d p", p, grid.shape, torch.float32, device)
    if theta is not None:
        check_theta(grid, theta, scalar, dt, device, "correct_diag_3d")
    if bcs is not None and not fused_step3d_applicable(grid, bcs):
        raise NotImplementedError(
            "correct_diag_3d: a table the fused 3D kernels do not take "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    if code is not None:
        check_code(grid, code, periodic, device, "correct_diag_3d",
                   coded=True)
    if theta is not None:
        if (open_mask(grid, bcs) & OPEN_CONV
                or (code is not None and code.dtype == torch.int16)):
            raise NotImplementedError(
                "correct_diag_3d: theta with a CONVECTIVE face or with the "
                "sharp interface's corrector code (JAX's fused gate refuses "
                "both, its jnp step runs them): not ported yet (ROADMAP "
                "Queue A, 'Other BC kinds')"
            )
        if code is not None and scalar.body_bc is None:
            raise ValueError("correct_diag_3d: theta with an obstacle needs "
                             "scalar.body_bc")
    if device.type == "cpu":
        if theta is not None:
            return correct_diag_thermal_plain(grid, u_star, p, scale,
                                              periodic, theta, scalar, dt,
                                              bcs, code)
        return correct_diag_plain(grid, u_star, p, scale, periodic, bcs,
                                  code)
    _native.cuda_or_raise(device, "correct_diag_3d")
    scale = step_size.scalar(scale, device, "correct_diag_3d scale")
    out = tuple(torch.empty_like(c) for c in u_star)
    maxes = torch.zeros(2, dtype=torch.int32, device=device)
    th = corrector_thermal_args(grid, theta, scalar, dt, thermal, device,
                                "correct_diag_3d")
    n0, n1, n2 = grid.shape
    coded = code is not None and code.dtype == torch.int16
    _launch(
        "nss_correct_diag_3d", device,
        *(_ptr(t) for t in (*u_star, p, *out, maxes, scale)), *th["ptrs"],
        _code_ptr(code), n0, n1, n2, *corrector_scalars(grid),
        *th["inv_hh"], periodic_mask(periodic), 0, th["wrap"],
        open_mask(grid, bcs) | (OPEN_CODED if coded else 0),
    )
    LAUNCHES["correct_diag_3d"] += 1
    m = maxes.view(torch.float32)
    if theta is not None:
        return out, m[0], m[1], th["out"]
    return out, m[0], m[1]


# -- halo mode: one slab of the sharded step -----------------------------------
#
# A slab of b = grid.shape[0] rows keeps each field in one tensor whose axis-0
# rows are [lo ghost | b data rows | hi ghost(s)]: u0's rows are the faces
# -1 .. b+1 (row b+1, local face b, is the face shared with the next slab),
# u1's and u2's the cells -1 .. b+1, p's the cells -1 .. b. The kernels get
# the address of data row 0 (buffer row 1) and read the ghost rows at the
# strides they already use.


def halo_shape(grid: GridSpec, comp: int) -> tuple[int, ...]:
    """The buffer shape of velocity component ``comp`` (0..2), or of the
    pressure (``comp`` 3), of a slab of ``grid.shape[0]`` rows."""
    b = grid.shape[0]
    if comp == 3:
        return (b + 2,) + tuple(grid.shape[1:])
    return (b + 3,) + tuple(grid.face_shape(comp)[1:])


def _row1(t: torch.Tensor):
    """The address of buffer row 1 (the slab's data row 0)."""
    return _native.ptr(t.narrow(0, 1, 1))


def _halo_masks(halo: Sequence[bool], periodic: Sequence[bool]):
    """(periodic mask, halo mask) of a slab: a periodic axis 0 is the
    sharded axis of a ring, both of whose sides are halo sides; its
    periodic bit is then cleared."""
    lo, hi = bool(halo[0]), bool(halo[1])
    per = list(periodic) if periodic else [False] * 3
    if per[0]:
        if not (lo and hi):
            raise ValueError(
                "a periodic axis 0 is sharded as a ring: both of its sides "
                f"are halo sides, got halo={tuple(halo)}"
            )
        per[0] = False
    return periodic_mask(per), int(lo) | (int(hi) << 1)


def _extended(grid: GridSpec, bcs: Optional[BCTable], halo):
    """The extended slab of the plain versions, the data rows plus each
    halo side's ghost row: (its first buffer row, its cell count, its
    grid, the BC table with the halo sides made walls). The extended
    slab's boundary values there are never kept, so any wall serves."""
    lo, hi = bool(halo[0]), bool(halo[1])
    cells = grid.shape[0] + lo + hi
    ext_bcs = None
    if bcs is not None:
        ext_bcs = dict(bcs)
        for side, h in enumerate((lo, hi)):
            if h or ext_bcs[(0, side)].kind is BCKind.PERIODIC:
                ext_bcs[(0, side)] = BCSpec.wall()
    return 1 - lo, cells, slab_grid(grid, cells), ext_bcs


def _owned_faces(b: int, hi: bool) -> int:
    """The u0 faces a slab writes: its b low faces, and face b where the
    high side is a wall."""
    return b if hi else b + 1


def predictor_rhs_halo_plain(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, halo: Sequence[bool] = (True, True),
    base: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Kernel 1's halo mode from the plain stencils: the unsharded plain
    version on the extended slab (data rows plus the halo sides' ghost
    rows, those sides made walls), cut back to what the kernel writes.
    Returns fresh buffers (zeros where the kernel writes nothing) and the
    slab's RHS. ``base``: the step-start slab buffers (rk2's stage 2)."""
    b, lo, hi = grid.shape[0], bool(halo[0]), bool(halo[1])
    r0, cells, ext, ext_bcs = _extended(grid, bcs, halo)

    def ext_rows(v):
        return tuple(c.narrow(0, r0, cells + (a == 0)) for a, c in enumerate(v))

    star, rhs = predictor_rhs_plain(
        ext, ext_bcs, ext_rows(u), dt, nu, upwind_gamma, rho,
        base=None if base is None else ext_rows(base))
    out = tuple(torch.zeros_like(c) for c in u)
    for a in range(3):
        n = _owned_faces(b, hi) if a == 0 else b
        out[a].narrow(0, 1, n).copy_(star[a].narrow(0, int(lo), n))
    return out, rhs.narrow(0, int(lo), b)


def predictor_rhs_3d_halo(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
    dt: step_size.Step, nu: float, upwind_gamma: float = 0.0,
    rho: float = 1.0, halo: Sequence[bool] = (True, True),
    bc: Optional[torch.Tensor] = None,
    out: Optional[Sequence[torch.Tensor]] = None,
    rhs: Optional[torch.Tensor] = None,
    base: Optional[Sequence[torch.Tensor]] = None,
    dts: Optional[torch.Tensor] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Kernel 1 on one slab: ``grid`` is the slab's (``grid.slab_grid``),
    ``bcs`` the whole domain's table, ``u`` the slab's buffers
    (:func:`halo_shape`) with fresh ghost rows on the ``halo`` sides.
    Writes u* into ``out`` (its data rows, and u0's face b on a wall side;
    the shared face is the next slab's, and the exchange brings it) and
    the slab's RHS into ``rhs``; allocates both when None. ``base``: the
    step-start buffers of the slab (rk2's stage 2; the kernel reads u0's
    face b there, the shared face, which the step's velocity refresh
    brought); ``dt`` and ``dts`` as in :func:`predictor_rhs_3d`."""
    device = u[0].device
    for a in range(3):
        _check(f"predictor_rhs_3d_halo u[{a}]", u[a], halo_shape(grid, a),
               torch.float32, device)
    if not (fused_step3d_applicable(grid, bcs)
            and walls_and_periodic(grid, bcs)):
        raise NotImplementedError(
            "predictor_rhs_3d_halo: WALL faces with constant values and "
            "PERIODIC axes only (ROADMAP Queue A, 'Other BC kinds')"
        )
    per, hm = _halo_masks(halo, periodic_axes(grid, bcs))
    out = tuple(torch.empty_like(c) for c in u) if out is None else out
    rhs = (torch.empty(grid.shape, dtype=torch.float32, device=device)
           if rhs is None else rhs)
    for a in range(3):
        _check(f"predictor_rhs_3d_halo out[{a}]", out[a], halo_shape(grid, a),
               torch.float32, device)
    _check("predictor_rhs_3d_halo rhs", rhs, grid.shape, torch.float32, device)
    base_ptrs = _base_ptrs(grid, base, device, "predictor_rhs_3d_halo",
                           halo_shape, _row1)
    if device.type == "cpu":
        star, r = predictor_rhs_halo_plain(grid, bcs, u, dt, nu, upwind_gamma,
                                           rho, halo, base)
        for o, s in zip(out, star):
            o.copy_(s)
        rhs.copy_(r)
        return tuple(out), rhs
    _native.cuda_or_raise(device, "predictor_rhs_3d_halo")
    if bc is None:
        bc = bc_table(grid, bcs, device)
    _check("predictor_rhs_3d_halo bc", bc, (BC_SIZE,), torch.float32,
           device)
    dts = step_size.check(step_size.buffer(dt, rho, device) if dts is None
                          else dts, device, "predictor_rhs_3d_halo dts")
    _launch(
        "nss_predictor_rhs_3d", device,
        *(_row1(t) for t in (*u, *out)), _ptr(rhs), _ptr(bc), *base_ptrs,
        _ptr(dts), None, None, None, None, None, None, *grid.shape,
        *predictor_scalars(grid, nu, upwind_gamma), per, hm, 0, 0,
    )
    LAUNCHES["predictor_rhs_3d"] += 1
    return tuple(out), rhs


def correct_diag_halo_plain(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, periodic: Sequence[bool] = (),
    halo: Sequence[bool] = (True, True),
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Kernel 2's halo mode from the plain stencils: the correction on the
    extended slab, cut back to what the kernel writes (fresh buffers,
    zeros elsewhere); ``max|div u|`` over the slab's cells and
    ``max_a max|u_a|/h_a`` over the faces it writes."""
    b, lo, hi = grid.shape[0], bool(halo[0]), bool(halo[1])
    per, _ = _halo_masks(halo, periodic)
    per = tuple(bool((per >> a) & 1) for a in range(3))
    r0, cells, ext, _ = _extended(grid, None, halo)
    us_ext = tuple(c.narrow(0, r0, cells + (a == 0))
                   for a, c in enumerate(u_star))
    new = stencils.correct_velocity(ext, us_ext, p.narrow(0, r0, cells),
                                    scale, periodic=per)
    local = tuple(c.narrow(0, int(lo), b + (a == 0)) for a, c in enumerate(new))
    max_div = stencils.divergence(grid, local).abs().max()
    h = grid.spacing
    out = tuple(torch.zeros_like(c) for c in u_star)
    vels = []
    for a in range(3):
        n = _owned_faces(b, hi) if a == 0 else b
        kept = local[a].narrow(0, 0, n)
        out[a].narrow(0, 1, n).copy_(kept)
        vels.append((kept / h[a]).abs().max())
    return out, max_div, torch.stack(vels).max()


def correct_diag_3d_halo(
    grid: GridSpec, u_star: Sequence[torch.Tensor], p: torch.Tensor,
    scale: step_size.Step, maxes: torch.Tensor, periodic: Sequence[bool] = (),
    halo: Sequence[bool] = (True, True),
    out: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, ...]:
    """Kernel 2 on one slab: u* buffers with u0's shared face filled (row
    b+1 of the buffer), ``p`` the slab's pressure buffer with fresh ghost
    rows on the ``halo`` sides. Writes the corrected velocity into ``out``
    (allocated when None) and folds ``max|div u|`` and ``max_a
    max|u_a|/h_a`` of the slab into ``maxes`` (int32, 2: the float bit
    patterns, which order as the values do; the caller zeroes it once for
    every slab, so it ends as the maximum over slabs, JAX's ``pmax``).
    ``scale`` as in :func:`correct_diag_3d`."""
    device = u_star[0].device
    for a in range(3):
        _check(f"correct_diag_3d_halo u_star[{a}]", u_star[a],
               halo_shape(grid, a), torch.float32, device)
    _check("correct_diag_3d_halo p", p, halo_shape(grid, 3), torch.float32,
           device)
    _check("correct_diag_3d_halo maxes", maxes, (2,), torch.int32, device)
    per, hm = _halo_masks(halo, periodic)
    out = tuple(torch.empty_like(c) for c in u_star) if out is None else out
    for a in range(3):
        _check(f"correct_diag_3d_halo out[{a}]", out[a], halo_shape(grid, a),
               torch.float32, device)
    if device.type == "cpu":
        new, div, vel = correct_diag_halo_plain(grid, u_star, p, scale,
                                                periodic, halo)
        for o, s in zip(out, new):
            o.copy_(s)
        bits = torch.stack([div, vel]).view(torch.int32)
        maxes.copy_(torch.maximum(maxes, bits))
        return tuple(out)
    _native.cuda_or_raise(device, "correct_diag_3d_halo")
    scale = step_size.scalar(scale, device, "correct_diag_3d_halo scale")
    _launch(
        "nss_correct_diag_3d", device,
        *(_row1(t) for t in (*u_star, p, *out)), _ptr(maxes), _ptr(scale),
        None, None, None, None, None, *grid.shape, *corrector_scalars(grid),
        0.0, 0.0, 0.0, per, hm, 0, 0,
    )
    LAUNCHES["correct_diag_3d"] += 1
    return tuple(out)


# -- Poisson residual (replaces _residual3d_kernel) ---------------------------


def residual_plain(op: PoissonOp, p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(b - A p) * fluid``; any dimension."""
    return (b - apply_A(op, p)) * op.fluid


def residual_3d(op: PoissonOp, p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(b - A p) * fluid`` in one launch, A decoded from ``op.code``
    (its neighbors wrap across ``op.periodic`` axes). An apertured
    (cut-cell) operator raises ValueError: the code alone would give the
    staircase operator (the cut pressure takes no direct solve, whose
    refinement is this kernel's caller)."""
    if p.ndim != 3:
        raise ValueError("residual_3d: 3D fields only")
    if op.ap is not None:
        raise ValueError("residual_3d: an apertured (cut-cell) operator; "
                         "the kernel decodes A from the stencil code alone "
                         "(residual_plain takes it)")
    device = p.device
    shape = tuple(p.shape)
    _check("residual_3d p", p, shape, torch.float32, device)
    _check("residual_3d b", b, shape, torch.float32, device)
    _check("residual_3d diag", op.diag, shape, torch.float32, device)
    _check("residual_3d code", op.code, shape, torch.uint8, device)
    if device.type == "cpu":
        return residual_plain(op, p, b)
    _native.cuda_or_raise(device, "residual_3d")
    out = torch.empty_like(p)
    _launch(
        "nss_residual_3d", device,
        *(_ptr(t) for t in (p, b, op.diag, op.code, out)),
        *shape,
        *(_f32(w) for w in op.w), periodic_mask(op.periodic),
    )
    LAUNCHES["residual_3d"] += 1
    return out
