"""Transported scalar (temperature / concentration) with Boussinesq buoyancy.

Counterpart of ``navierstokessolver_tpu/scalar.py``: an advected-diffused
cell-centred scalar

    d(theta)/dt = -div(u * theta) + alpha * lap(theta)

in conservative (flux) form on the MAC grid (the face-normal velocities are
the flux velocities, so the scalar is conserved up to boundary fluxes),
plus the optional Boussinesq coupling back into momentum,

    f_a = g_a * beta * (theta - theta_ref)

averaged to component-a faces.

Scalar BCs per face: Dirichlet (a wall value, ghost = 2*value - edge),
adiabatic / zero-flux Neumann (ghost = edge), or a periodic wrap, as the
velocity BCs' ghosts in bcs.py. The values are numbers: an array-valued
Dirichlet value raises (the JAX fused kernels refuse it too).

Immersed obstacles (``body_bc``): an ISOTHERMAL body
(``ScalarBC.dirichlet(value)``) clamps solid cells to its value, so the
diffusive flux at a fluid-solid face is the first-order staircase
Dirichlet flux; an ADIABATIC body (``ScalarBC.adiabatic()``) closes the
diffusive flux on every fluid-solid face. Solid cells are frozen across an
update either way (``freeze_body``); ``body_heat_flux`` integrates the
interface fluxes (the Nusselt number of the heated cylinder).

The functions here are plain PyTorch on the state's device. ``scalar_rhs``
and ``buoyancy_forcing`` are the plain versions that the thermal modes of
the fused kernels are held to (ops/fused2d.py, ops/fused3d.py);
:func:`thermal_table` is the device buffer those modes read.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .grid import GridSpec

Value = Union[float, np.ndarray]


class ScalarBCKind(enum.Enum):
    DIRICHLET = "dirichlet"      # prescribed boundary value (hot/cold wall)
    NEUMANN = "neumann"          # zero-flux (adiabatic/insulated)
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class ScalarBC:
    kind: ScalarBCKind
    value: Value = 0.0

    @staticmethod
    def dirichlet(value: Value) -> "ScalarBC":
        return ScalarBC(ScalarBCKind.DIRICHLET, value)

    @staticmethod
    def adiabatic() -> "ScalarBC":
        return ScalarBC(ScalarBCKind.NEUMANN)

    @staticmethod
    def periodic() -> "ScalarBC":
        return ScalarBC(ScalarBCKind.PERIODIC)


ScalarBCTable = Mapping[tuple[int, int], ScalarBC]


@dataclasses.dataclass(eq=False)
class ScalarConfig:
    """Static configuration of the transported scalar, as JAX's.

    diffusivity: alpha (e.g. nu/Pr for temperature).
    buoyancy: per-axis g_a * beta coefficients of the Boussinesq forcing
      (e.g. (0.0, 1.0) for gravity along -y with g*beta = 1); zeros (or
      empty) disable the momentum coupling (a passive scalar).
    theta_ref: the reference value subtracted inside the forcing.
    upwind_gamma: donor-cell blend of the advective flux (0 = central).
    theta_init: the initial field (cell-centred numpy array); None: zeros.
    body_bc: the scalar condition on an obstacle's staircase surface,
      ``ScalarBC.dirichlet(v)`` (isothermal) or ``ScalarBC.adiabatic()``;
      required when the simulation carries a solid mask.
    """

    bcs: ScalarBCTable
    diffusivity: float
    buoyancy: tuple[float, ...] = ()
    theta_ref: float = 0.0
    upwind_gamma: float = 0.0
    theta_init: Optional[np.ndarray] = None
    body_bc: Optional[ScalarBC] = None

    def validate(self, grid: GridSpec) -> None:
        if self.body_bc is not None and self.body_bc.kind not in (
            ScalarBCKind.DIRICHLET, ScalarBCKind.NEUMANN
        ):
            raise ValueError(
                "body_bc must be dirichlet (isothermal) or neumann "
                "(adiabatic)"
            )
        for a in range(grid.ndim):
            for side in (0, 1):
                if (a, side) not in self.bcs:
                    raise ValueError(
                        f"missing scalar BC for face (axis={a}, side={side})"
                    )
            lo = self.bcs[(a, 0)].kind is ScalarBCKind.PERIODIC
            hi = self.bcs[(a, 1)].kind is ScalarBCKind.PERIODIC
            if lo != hi:
                raise ValueError(f"axis {a}: PERIODIC scalar BC on one side")
        if self.buoyancy and len(self.buoyancy) != grid.ndim:
            raise ValueError("buoyancy rank mismatch")

    @property
    def buoyant(self) -> bool:
        """The scalar drives the momentum (some buoyancy coefficient is
        nonzero)."""
        return any(b != 0.0 for b in self.buoyancy)


def _is_number(v) -> bool:
    return np.isscalar(v) or getattr(v, "ndim", 1) == 0


def check_static_values(cfg: ScalarConfig) -> None:
    """Raise NotImplementedError for an array-valued Dirichlet value (on a
    domain face or the body): the port takes numbers only."""
    values = [bc.value for bc in cfg.bcs.values()
              if bc.kind is ScalarBCKind.DIRICHLET]
    if cfg.body_bc is not None and cfg.body_bc.kind is ScalarBCKind.DIRICHLET:
        values.append(cfg.body_bc.value)
    if not all(_is_number(v) for v in values):
        raise NotImplementedError(
            "an array-valued scalar Dirichlet value: not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )


def _lo(t: torch.Tensor, axis: int) -> torch.Tensor:
    """All but the last entry along ``axis``."""
    return t.narrow(axis, 0, t.shape[axis] - 1)


def _hi(t: torch.Tensor, axis: int) -> torch.Tensor:
    """All but the first entry along ``axis``."""
    return t.narrow(axis, 1, t.shape[axis] - 1)


def pad_scalar(grid: GridSpec, cfg: ScalarConfig,
               theta: torch.Tensor) -> torch.Tensor:
    """One ghost cell per side on every axis, honouring the scalar BCs."""
    for a in range(grid.ndim):
        lo, hi = cfg.bcs[(a, 0)], cfg.bcs[(a, 1)]
        n = theta.shape[a]
        if lo.kind is ScalarBCKind.PERIODIC:
            g_lo = theta.narrow(a, n - 1, 1)
            g_hi = theta.narrow(a, 0, 1)
        else:
            e_lo = theta.narrow(a, 0, 1)
            e_hi = theta.narrow(a, n - 1, 1)
            g_lo = (2.0 * float(lo.value) - e_lo
                    if lo.kind is ScalarBCKind.DIRICHLET else e_lo)
            g_hi = (2.0 * float(hi.value) - e_hi
                    if hi.kind is ScalarBCKind.DIRICHLET else e_hi)
        theta = torch.cat([g_lo, theta, g_hi], dim=a)
    return theta


def _face_open(solid: torch.Tensor, a: int) -> torch.Tensor:
    """The n+1 theta-faces along axis ``a`` that are open: both adjacent
    cells fluid (the domain ghosts count as fluid; the domain BCs govern
    those faces)."""
    fluid = torch.logical_not(solid)
    pad = [0] * (2 * solid.ndim)
    k = 2 * (solid.ndim - 1 - a)
    pad[k] = pad[k + 1] = 1
    fp = torch.nn.functional.pad(fluid.to(torch.uint8), pad,
                                 value=1).bool()
    return torch.logical_and(_lo(fp, a), _hi(fp, a))


def freeze_body(cfg: ScalarConfig, theta: torch.Tensor,
                solid: Optional[torch.Tensor]) -> torch.Tensor:
    """Solid cells clamped to the body value (an isothermal body); an
    adiabatic body or no obstacle leaves ``theta`` as it is."""
    if solid is None or cfg.body_bc is None:
        return theta
    if cfg.body_bc.kind is ScalarBCKind.DIRICHLET:
        return torch.where(solid, torch.full_like(theta,
                                                  float(cfg.body_bc.value)),
                           theta)
    return theta


def scalar_rhs(
    grid: GridSpec,
    cfg: ScalarConfig,
    u: Sequence[torch.Tensor],
    theta: torch.Tensor,
    solid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``-div(u theta) + alpha lap(theta)`` at cell centres, JAX's flux
    form: along axis a the face flux is ``u_a * theta_face``, theta_face
    the two-cell average blended with donor-cell upwinding by
    ``upwind_gamma``; the diffusive flux ``alpha (t_p - t_m) / h`` in the
    same face form (closed on fluid-solid faces for an adiabatic body); the
    flux differences summed axis by axis."""
    nd = grid.ndim
    h = grid.spacing
    if solid is not None and cfg.body_bc is not None \
            and cfg.body_bc.kind is ScalarBCKind.DIRICHLET:
        theta = freeze_body(cfg, theta, solid)
    close_body = (solid is not None and cfg.body_bc is not None
                  and cfg.body_bc.kind is ScalarBCKind.NEUMANN)
    tp = pad_scalar(grid, cfg, theta)
    out = torch.zeros_like(theta)
    gamma = cfg.upwind_gamma
    for a in range(nd):
        core = tp
        for b in range(nd):
            if b != a:
                core = core.narrow(b, 1, theta.shape[b])
        t_m = _lo(core, a)               # the cell below each face
        t_p = _hi(core, a)               # the cell above each face
        t_face = 0.5 * (t_m + t_p)
        ua = u[a]                        # n+1 faces (periodic: face n dup)
        if gamma > 0.0:
            t_up = torch.where(ua > 0.0, t_m, t_p)
            t_face = gamma * t_up + (1.0 - gamma) * t_face
        flux = ua * t_face
        dflux = cfg.diffusivity * (t_p - t_m) / h[a]
        if close_body:
            dflux = dflux * _face_open(solid, a).to(dflux.dtype)
        net = dflux - flux
        out = out + (_hi(net, a) - _lo(net, a)) / h[a]
    return out


def advance(grid: GridSpec, cfg: ScalarConfig, u: Sequence[torch.Tensor],
            theta: torch.Tensor, dt, solid: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """One explicit step of the scalar with the end-of-step velocity ``u``,
    as JAX's jnp step takes it: ``theta + dt * scalar_rhs(u, theta)``, and
    with an obstacle the solid cells frozen (clamped to the body value, or
    kept for an adiabatic body). ``dt``: a Python float or a 0-d tensor."""
    new = theta + dt * scalar_rhs(grid, cfg, u, theta, solid=solid)
    if solid is not None:
        new = torch.where(solid, freeze_body(cfg, theta, solid), new)
    return new


def body_heat_flux(
    grid: GridSpec,
    cfg: ScalarConfig,
    theta: torch.Tensor,
    solid: torch.Tensor,
) -> torch.Tensor:
    """The total diffusive flux from the body into the fluid: the sum over
    fluid-solid faces of ``alpha (theta_solid - theta_fluid) / h *
    face_area`` (an isothermal body's solid side at its value). The 2D
    cylinder's mean Nusselt number is ``Q / (pi alpha dT)`` for D = 1."""
    nd = grid.ndim
    h = grid.spacing
    theta = freeze_body(cfg, theta, solid)
    fluid = torch.logical_not(solid)
    vol = 1.0
    for a in range(nd):
        vol = vol * h[a]
    q = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for a in range(nd):
        area = vol / h[a]
        t_lo, t_hi = _lo(theta, a), _hi(theta, a)
        s_lo, s_hi = _lo(solid, a), _hi(solid, a)
        f_lo, f_hi = _lo(fluid, a), _hi(fluid, a)
        up = torch.logical_and(s_lo, f_hi).to(theta.dtype) * (t_lo - t_hi)
        dn = torch.logical_and(f_lo, s_hi).to(theta.dtype) * (t_hi - t_lo)
        q = q + cfg.diffusivity * area / h[a] * torch.sum(up + dn)
    return q


def buoyancy_forcing(
    grid: GridSpec,
    cfg: ScalarConfig,
    theta: torch.Tensor,
) -> Optional[tuple[Optional[torch.Tensor], ...]]:
    """The Boussinesq momentum forcing per component at its interior
    faces, ``g_a beta (theta - theta_ref)`` averaged to component-a faces
    (the predictor's forcing shape); None without buoyancy."""
    if not cfg.buoyant:
        return None
    dev = theta - float(cfg.theta_ref)
    out: list[Optional[torch.Tensor]] = []
    for a in range(grid.ndim):
        coef = cfg.buoyancy[a]
        if coef == 0.0:
            out.append(None)
            continue
        out.append(coef * (0.5 * (_lo(dev, a) + _hi(dev, a))))
    return tuple(out)


def combined_forcing(forcing, buoy):
    """A force (a number, a tensor or None a component, or None) and the
    buoyancy forcing (:func:`buoyancy_forcing`, or None) as the
    predictor's forcing, added component by component as JAX's
    ``Simulation._combined_forcing`` adds them."""
    if buoy is None:
        return forcing
    if forcing is None:
        return buoy
    return tuple(b if f is None else (f if b is None else f + b)
                 for f, b in zip(forcing, buoy))


# -- the device buffer of the kernels' thermal modes --------------------------


def theta_ghost_table(cfg: ScalarConfig, ndim: int) -> dict:
    """The scalar-BC ghost per (axis, side), as JAX's
    ``pallas_kernels.theta_ghost_table``: ``("a", alpha, beta)`` with
    ghost = alpha*edge + beta (the Dirichlet reflection -1, 2v; the Neumann
    copy 1, 0), or ``("wrap",)`` on a periodic axis. An array-valued
    Dirichlet value raises (where JAX's table returns None and its fused
    gate refuses the route)."""
    check_static_values(cfg)
    out = {}
    for a in range(ndim):
        for s in (0, 1):
            bc = cfg.bcs[(a, s)]
            if bc.kind is ScalarBCKind.PERIODIC:
                out[(a, s)] = ("wrap",)
            elif bc.kind is ScalarBCKind.NEUMANN:
                out[(a, s)] = ("a", 1.0, 0.0)
            else:
                out[(a, s)] = ("a", -1.0, 2.0 * float(bc.value))
    return out


def thermal_table_size(ndim: int) -> int:
    """Entries of :func:`thermal_table`: the ghost maps, the buoyancy,
    theta_ref, alpha, gamma and 1 - gamma."""
    return 5 * ndim + 4


def thermal_table(cfg: ScalarConfig, ndim: int, device) -> torch.Tensor:
    """The float32 buffer the kernels' thermal modes read, on ``device``:
    ``[(axis*2 + side)*2 + k]`` the ghost map of each face (k = 0: alpha,
    1: beta; a wrap face holds 1, 0 and the kernels wrap instead), then the
    ``ndim`` buoyancy coefficients, theta_ref, alpha, gamma and 1 - gamma
    (:func:`thermal_table_size` entries). Build it once per simulation;
    the step then copies nothing from the host. The wrap faces go to the
    kernels as a bit mask (:func:`wrap_mask`)."""
    tg = theta_ghost_table(cfg, ndim)
    vals = []
    for a in range(ndim):
        for s in (0, 1):
            g = tg[(a, s)]
            vals += [1.0, 0.0] if g[0] == "wrap" else [g[1], g[2]]
    buoy = list(cfg.buoyancy) if cfg.buoyancy else [0.0] * ndim
    gamma = float(cfg.upwind_gamma)
    vals += [float(b) for b in buoy] + [
        float(cfg.theta_ref), float(cfg.diffusivity), gamma, 1.0 - gamma]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def wrap_mask(cfg: ScalarConfig, ndim: int) -> int:
    """Bit ``a`` set where the scalar wraps along axis ``a``."""
    return sum(1 << a for a in range(ndim)
               if cfg.bcs[(a, 0)].kind is ScalarBCKind.PERIODIC)
