"""Chorin projection time stepper: predictor -> Poisson -> corrector (PyTorch).

Counterpart of ``navierstokessolver_tpu/solver.py`` for the ported slice:
explicit Euler or rk2 (the midpoint rule with a projection per stage), at
a fixed or a CFL-adaptive dt computed on the device (the kernels read the
step size from a device buffer, ops/step_size.py); WALL, INFLOW, OUTFLOW
and SLIP faces and PERIODIC axes (the Taylor-Green vortices, decaying
turbulence, the periodic channel), staircase obstacles (2D and 3D), in 2D
the sharp-interface immersed boundary (ibm.py), a body force
(one number, one array or one callable of t a component; every route)
and the transported scalar with Boussinesq buoyancy (scalar.py);
BC values that are callables of t (time-dependent drive, State.t);
every pressure method of the JAX package (the direct spectral solve,
damped Jacobi, red-black Gauss-Seidel and SOR, CG, multigrid,
MG-preconditioned CG and the DCT-preconditioned ``dctcg``); in 3D the
Smagorinsky LES closure (on WALL tables).

Two step routes, as :meth:`Simulation.step` dispatches in JAX:

Fused (2D: every face a WALL with scalar values or on a PERIODIC axis, no
obstacle, no IBM; 3D: the same, or on a grid with no periodic axis WALL,
INFLOW, OUTFLOW and SLIP faces with scalar values, no OUTFLOW face at
(0, 0), and an obstacle, the kernels' open and masked modes), as the JAX
fused steps (``_step_fused3d_internal``, ``_step_fused2d_internal``; the
predictors add the force):

    predictor + BCs + RHS      3D: ops/fused3d.predictor_rhs_3d  (kernel)
                               2D: ops/fused2d.predictor_rhs_2d  (kernel)
    pressure solve             fft: ops/fft_poisson.solve_with_residual
                               (3D residual: ops/fused3d.residual_3d,
                               kernel; 2D residual: plain, as in JAX; with
                               the solver's ``fuse_trailing`` the 3D
                               transforms' trailing axes on
                               ops/trailing_dct.fused_trailing, kernel)
                               mg, mgcg: ops/multigrid (2D levels >= 128:
                               ops/multigrid_kernels, kernels)
                               dctcg: ops/fft_poisson.DCTPCGSolver
                               jacobi, gs, sor, cg: ops/poisson (plain)
    corrector + diagnostics    3D: ops/fused3d.correct_diag_3d   (kernel)
                               2D: ops/fused2d.correct_diag_2d   (kernel)

rk2 runs the predictor at 0.5*dt, the solve and the corrector (stage 1),
then the predictor in ``base`` mode on the midpoint field, anchored at the
step-start state (``u* = u_n + dt*RHS(u_mid)``), the solve from the
stage-1 pressure and the corrector. With ``cfl`` set, ``run_scan``
carries the corrector's ``max_a max|u_a|/h_a`` into the next step's dt, as
the JAX scan carries it.

With a transported scalar, the fused kernels run their thermal modes, as
JAX's fused steps do: both predictor stages add the buoyancy of the
step-start theta, and the final corrector advances theta by the full dt
with the corrected faces (rk2's stage-1 corrector runs without it). The
unfused 2D route advances theta after the projection with the plain
update (``scalar.advance``), solid cells frozen, as JAX's jnp step; its
buoyancy (``scalar.buoyancy_forcing`` of the step-start theta) is a
forcing volume of the predictor kernel.

The body force (``forcing``, JAX's): a number a component rides in the
fused kernels' device buffer (``bc``); an array is a forcing volume
(``force_vol``, ``fused3d.force_shape``'s layout) that the predictor
kernel reads; on the unfused route every forced component is a volume. A
time-dependent run (a BC value or a force component that is a callable of
t) carries ``State.t`` (``initial_state`` sets it to 0): each step
resolves the callables at the carried t, on the device, refills the
buffers the kernels read (the wall and force entries of ``bc``, the
unfused route's ghost table, the volumes of array-valued callables),
rewrites the stored own-axis Dirichlet faces whose value changed, and
advances t by the dt it used; with ``cfl`` its CFL reduction is taken from
the refreshed field every step, as JAX's time-dependent scan does. The
kinds may not change in time. Nothing of it reads the host.

With ``les`` set (3D only) the predictor is the JAX package's LES route
(``Simulation._predict`` through ``_pallas_les_ok``):

    eddy viscosity             ops/predictor3d.nu_t_3d (kernel; the
                               dynamic model: les.eddy_viscosity, plain)
    predictor + BCs + SGS      ops/predictor3d.predictor_3d (kernel)
    Poisson RHS                ops/stencils.poisson_rhs (plain)

The fused-trailing route is the JAX package's:
``dataclasses.replace(sim, dct_solver=dataclasses.replace(sim.dct_solver,
fuse_trailing=True))``.

Unfused (2D, any other face kind, an obstacle or the IBM; 3D has no
unfused route and raises for any table the fused kernels refuse), the JAX
``_step_jnp`` with its predictor on the kernel that ``_predict`` runs
there (rk2: a predictor and a projection per stage, stage 2's u* formed
as ``u + (u*_mid - u_mid)``; the CFL dt from the entry field). A periodic
axis on this route (with an INFLOW, OUTFLOW or SLIP face, an obstacle or
the IBM) runs in ``step_plain``; the predictor kernel has no periodic
lanes yet, so ``step`` raises (ROADMAP Queue A, 'Other BC kinds'), where
JAX runs its jnp predictor:

    BC pass with face masks, then the IBM apply
    predictor                  ops/predictor2d.predictor_2d (kernel)
    BC pass with face masks
    IBM apply, RHS (rho/dt) div u* on fluid cells, pressure solve (as
    above), correction with the obstacle's correction masks, and with an
    OUTFLOW face the BC pass again (then the IBM's wet faces)
    diagnostics                max |div u| over fluid cells, CFL (plain)

The JAX package sends the staircase cylinder (an obstacle, no IBM) through
its fused 2D kernels with obstacle codes, which are not ported (ROADMAP
Queue A, 'Other BC kinds'); here it takes the unfused route, the JAX jnp
step, and is held to that. The staircase sphere (3D) takes the fused 3D
kernels' masked mode, as in JAX: u* zero on blocked faces, the RHS on
fluid cells, the correction between fluid cells, with an OUTFLOW face its
copy of the corrected inner face (the jnp ``_project``'s BC pass).

The iterative solves start from the previous pressure, or from
``p + beta (p - p_prev)`` with ``PoissonConfig.extrapolate = beta``; the
state then carries ``p_prev``. They check convergence on the host once per
block of iterations (ops/poisson.device_while).

On CPU tensors each kernel wrapper runs its plain version; on a CUDA
device the step launches the kernels and never falls back.
:meth:`Simulation.step_plain` is the plain composition of either route
(the multigrid solve on its plain route): the reference the kernel step is
held to on one device.

Like the JAX fused steps, the fused route relies on the state invariant
that boundary faces carry their BC values (``initial_state`` sets them,
the predictor rewrites them, the corrector keeps them), so no BC pass runs
at step entry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np
import torch

from . import bcs as bcs_mod
from . import ibm as ibm_mod
from . import les as les_mod
from . import scalar as scalar_mod
from .bcs import BCTable
from .grid import GridSpec, State, zero_state
from .ops import (
    fft_poisson, fused2d, fused3d, multigrid, predictor2d, predictor3d,
    step_size, stencils,
)
from .ops import poisson as poisson_mod
from .ops.poisson import PoissonConfig, PoissonOp

if TYPE_CHECKING:
    from .parallel.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static physical/numerical parameters of a run, as JAX's.

    ``integrator``: "euler" (explicit first order) or "rk2" (the midpoint
    rule, one projection per stage, second order in time). ``cfl``: when
    set, each step uses ``dt_k = min(dt, cfl / max_a(max|u_a| / h_a))``,
    computed on the device (``dt`` is then the cap); None: a fixed dt."""

    dt: float
    nu: float
    rho: float = 1.0
    upwind_gamma: float = 0.0
    poisson: PoissonConfig = dataclasses.field(default_factory=PoissonConfig)
    integrator: str = "euler"
    cfl: Optional[float] = None

    def __post_init__(self):
        if self.integrator not in ("euler", "rk2"):
            raise ValueError(f"unknown integrator {self.integrator!r}")


class StepDiagnostics(NamedTuple):
    poisson_iters: torch.Tensor   # iterations the pressure solve took
    poisson_res: torch.Tensor     # final relative residual (-1.0 if skipped)
    max_div: torch.Tensor         # max |div u| after projection
    max_cfl: torch.Tensor         # advective CFL of the step
    dt: torch.Tensor              # dt used


@dataclasses.dataclass(eq=False)
class Simulation:
    """The static pieces of a problem on one device, and its step."""

    grid: GridSpec
    bcs: BCTable
    params: SimParams
    op: PoissonOp
    device: torch.device
    # the direct solver (method "fft")
    dct_solver: Optional[fft_poisson.DCTPoissonSolver] = None
    # the V-cycle hierarchy (methods "mg" and "mgcg")
    mg_solver: Optional[multigrid.MGPoissonSolver] = None
    # wall values as the fused kernels read them
    bc: Optional[torch.Tensor] = None
    # the Smagorinsky LES closure (3D only); None: no subgrid model
    les: Optional[les_mod.LESConfig] = None
    # obstacle masks (bcs.face_masks_from_solid, bcs.correction_face_masks)
    face_masks: Optional[tuple[torch.Tensor, ...]] = None
    corr_masks: Optional[tuple[torch.Tensor, ...]] = None
    # the sharp-interface direct forcing (ibm.py); None: staircase only
    ibm: Optional[ibm_mod.IBMForcing] = None
    # the DCT-preconditioned solver (method "dctcg")
    dctcg_solver: Optional[fft_poisson.DCTPCGSolver] = None
    # the unfused predictor kernel's ghost table (predictor2d.ghost_table),
    # on the device
    ghosts: Optional[torch.Tensor] = None
    # the mesh of the slab-sharded step (parallel.sharded_simulation; None:
    # unsharded)
    mesh: Optional["Mesh"] = None
    # the body force as JAX holds it, per component: a float (static), a
    # tensor on the device in the forcing layout (fused3d.force_shape), a
    # callable of t, or None; None: no force
    forcing: Optional[tuple] = None
    # the forcing volumes the predictor kernels read, one (or None) a
    # component: the array-valued components on the fused routes, every
    # forced component on the unfused route; a callable's volume is
    # refilled by each step
    force_vol: Optional[tuple[Optional[torch.Tensor], ...]] = None
    # the transported scalar (scalar.ScalarConfig); None: no scalar
    scalar: Optional[scalar_mod.ScalarConfig] = None
    # the obstacle's solid cells, for the scalar's staircase treatment
    # (set when a scalar and an obstacle are both configured)
    scalar_solid: Optional[torch.Tensor] = None
    # the scalar's buffer of the kernels' thermal modes
    # (scalar.thermal_table; the fused routes)
    thermal: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.les is not None and self.grid.ndim != 3:
            raise NotImplementedError(
                "2D LES: not ported yet (ROADMAP Queue A, 'Physics "
                "extensions')"
            )
        if self.les is not None and any(self.op.periodic):
            raise NotImplementedError(
                "LES on periodic axes: not ported yet (ROADMAP Queue A, "
                "'Other BC kinds')"
            )
        if self.les is not None and (
                self.face_masks is not None
                or not fused3d.walls_and_periodic(self.grid, self.bcs)):
            raise NotImplementedError(
                "LES with INFLOW, OUTFLOW or SLIP faces or an obstacle "
                "(kernel 6's open lanes): not ported yet (ROADMAP Queue A, "
                "'Other BC kinds')"
            )
        if self.les is not None and self.scalar is not None:
            raise NotImplementedError(
                "LES with a transported scalar: not ported yet (ROADMAP "
                "Queue A, 'Physics extensions')"
            )
        if self.les is not None and self.forcing is not None:
            raise NotImplementedError(
                "LES with a body force (JAX's jnp predictor with the "
                "subgrid stress merged into the force): not ported yet "
                "(ROADMAP Queue A, 'Physics extensions')"
            )
        if self.mesh is not None:
            from .parallel.fused_sharded import check_sharded

            check_sharded(self, self.mesh)

    @staticmethod
    def build(
        grid: GridSpec,
        bcs: BCTable,
        params: SimParams,
        device,
        solid: Optional[np.ndarray] = None,
        forcing=None,
        scalar=None,
        les=None,
        sdf=None,
        surface_velocity=None,
        sharp_pressure: bool = False,
    ) -> "Simulation":
        """Static operators on ``device`` (no default: the caller names it;
        a CUDA device where there is none raises).

        ``solid``: a cell-centred obstacle mask (2D or 3D). ``sdf``: the
        obstacle's signed distance function (negative inside); it gives the
        solid mask when ``solid`` is None, and turns on the sharp-interface
        direct forcing (ibm.py). ``surface_velocity(*coords)``: the body's
        surface velocity (moving bodies; needs ``sdf``). ``les``: a
        :class:`~.les.LESConfig` (3D only). ``forcing``: the body force,
        as JAX's build takes it, one entry a component: a number, an array
        that broadcasts to the component's forcing layout
        (:func:`.ops.fused3d.force_shape`: its interior faces, all n on a
        periodic axis), a callable of t (a 0-d tensor on ``device``)
        returning a number, a 0-d tensor or such an array, or None.
        ``bcs`` may hold callables of t too (numbers at every t). A run
        with a callable carries ``State.t``. ``scalar``: a
        :class:`~.scalar.ScalarConfig`, checked as JAX's build checks it
        (buoyancy along a periodic axis raises, an obstacle needs
        ``body_bc``); its Dirichlet values are numbers. ``sharp_pressure``
        (the cut-cell pressure) is not ported yet and raises; in 3D so do
        an obstacle or an open face with a periodic axis or with a force
        or a scalar, and the IBM."""
        if sharp_pressure:
            raise NotImplementedError(
                "sharp_pressure (the cut-cell pressure): not ported yet "
                "(ROADMAP Queue A, 'Physics extensions')"
            )
        if surface_velocity is not None and sdf is None:
            raise ValueError("surface_velocity needs an sdf")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device}: no CUDA device here; pass device='cpu' "
                "to run the kernels' plain versions on the CPU"
            )
        bcs_mod.validate_bcs(grid, bcs)
        bcs = bcs_mod.bcs_on_device(bcs, device)
        t0 = torch.zeros((), dtype=grid.dtype, device=device)
        b0 = _check_time_values(bcs, t0)
        per = bcs_mod.periodic_axes(grid, bcs)
        forcing = _forcing_parts(forcing, grid, per, device, t0)
        if grid.ndim == 3:
            _check_3d(grid, bcs, per, solid, sdf, forcing, scalar)
        if sdf is not None and solid is None:
            solid = ibm_mod.solid_from_sdf(grid, sdf)
        scalar_solid = None
        if scalar is not None:
            scalar.validate(grid)
            scalar_mod.check_static_values(scalar)
            per = bcs_mod.periodic_axes(grid, bcs)
            if any(b != 0.0 and per[a]
                   for a, b in enumerate(scalar.buoyancy)):
                raise ValueError(
                    "Boussinesq buoyancy along a periodic axis is not "
                    "supported (the wrap predictor expects n-face forcing)"
                )
            if solid is not None and np.asarray(solid).any():
                if scalar.body_bc is None:
                    raise ValueError(
                        "scalar transport with an obstacle needs "
                        "scalar.body_bc (ScalarBC.dirichlet(v) for an "
                        "isothermal body, ScalarBC.adiabatic() for an "
                        "insulated one)"
                    )
                scalar_solid = torch.as_tensor(np.asarray(solid, dtype=bool),
                                               device=device)
        per = bcs_mod.periodic_axes(grid, bcs)
        face_masks = bcs_mod.face_masks_from_solid(grid, solid, device, per)
        corr_masks = bcs_mod.correction_face_masks(grid, solid, device, per)
        op = poisson_mod.build_poisson_op(grid, bcs, device, solid)
        method = params.poisson.method
        dct_solver = mg_solver = dctcg_solver = None
        if method == "fft":
            if not fft_poisson.is_applicable(grid, bcs, solid):
                raise ValueError(
                    "poisson method 'fft' needs an obstacle-free domain "
                    "(an interior obstacle mask does not diagonalize); use "
                    "an iterative method or 'dctcg' for this case"
                )
            dct_solver = fft_poisson.DCTPoissonSolver.build(
                grid, device,
                kinds=fft_poisson.axis_kinds_from_bcs(grid, bcs),
            )
        elif method == "dctcg":
            dctcg_solver = fft_poisson.DCTPCGSolver.build(grid, bcs, device,
                                                          solid)
        elif method in ("mg", "mgcg"):
            mg_solver = multigrid.MGPoissonSolver.build(grid, bcs, device,
                                                        solid)
        ibm = None
        if sdf is not None:
            ibm = ibm_mod.build_ibm(grid, sdf, face_masks, device,
                                    velocity=surface_velocity)
        # the route, settled once: the fused kernels of the grid's dimension
        # (their gate; in 2D no obstacle, no IBM; in 3D an obstacle runs
        # their masked mode) read ``bc`` (the face values, the force and
        # the ghost maps); the unfused 2D route's predictor kernel reads
        # ``ghosts``; 3D has no unfused route
        fused = (ibm is None and (face_masks is None or grid.ndim == 3)
                 and _kernels(grid.ndim)[0](grid, bcs))
        if not fused and grid.ndim == 3:
            raise NotImplementedError(
                "a 3D table the fused 3D kernels do not take: not ported "
                "yet (ROADMAP Queue A, 'Other BC kinds')"
            )
        sim = Simulation(grid=grid, bcs=bcs, params=params, op=op,
                         device=device, dct_solver=dct_solver,
                         mg_solver=mg_solver, les=les,
                         face_masks=face_masks, corr_masks=corr_masks,
                         ibm=ibm, dctcg_solver=dctcg_solver, forcing=forcing,
                         force_vol=_force_volumes(forcing, grid, per, device,
                                                  fused, t0),
                         scalar=scalar, scalar_solid=scalar_solid)
        if fused:
            force0 = sim._force_numbers(_resolved_forcing(forcing, t0))
            table = fused2d.bc_table if grid.ndim == 2 else fused3d.bc_table
            sim.bc = table(grid, b0, device, force0)
            if scalar is not None:
                sim.thermal = scalar_mod.thermal_table(scalar, grid.ndim,
                                                       device)
        else:
            sim.ghosts = predictor2d.ghost_table(grid, b0, device)
        return sim

    @property
    def fused(self) -> bool:
        """The step runs the fused kernels of the grid's dimension (the
        route ``build`` chose); otherwise the unfused 2D route."""
        return self.bc is not None

    @property
    def _code(self) -> Optional[torch.Tensor]:
        """The stencil code of the fused 3D kernels' masked mode (an
        obstacle); None without one."""
        if self.face_masks is None or self.grid.ndim != 3:
            return None
        return self.op.code

    @property
    def time_dependent(self) -> bool:
        """A BC value or a force component is a callable of t: the run
        carries ``State.t`` (JAX's ``_time_dependent``)."""
        return bcs_mod.bcs_time_dependent(self.bcs) or (
            self.forcing is not None and any(callable(f)
                                             for f in self.forcing))

    def initial_state(self) -> State:
        st = zero_state(self.grid, self.device)
        t = None
        b = self.bcs
        if self.time_dependent:
            # the t = 0 values on the boundary faces, as JAX's
            t = torch.zeros((), dtype=self.grid.dtype, device=self.device)
            b = bcs_mod.resolve_bcs(self.bcs, t)
        u = bcs_mod.apply_velocity_bcs(self.grid, b, st.u, self.face_masks)
        theta = None
        if self.scalar is not None:
            init = self.scalar.theta_init
            theta = (torch.zeros(self.grid.shape, dtype=self.grid.dtype,
                                 device=self.device) if init is None else
                     torch.as_tensor(np.asarray(init, dtype=np.float32),
                                     device=self.device).clone())
            theta = scalar_mod.freeze_body(self.scalar, theta,
                                           self.scalar_solid)
        # the extrapolated warm start carries p_prev from step 0
        p_prev = st.p if self.params.poisson.extrapolate else None
        return State(u=u, p=st.p, theta=theta, p_prev=p_prev, t=t)

    # -- the time-dependent drive ----------------------------------------------

    def _force_numbers(self, forcing):
        """The numbers of a resolved force that the kernels' buffer
        holds: a component's number where it has no volume, else None;
        None without a force."""
        if forcing is None:
            return None
        vol = self.force_vol or (None,) * self.grid.ndim
        return tuple(f if v is None and f is not None and _is_number(f)
                     else None for f, v in zip(forcing, vol))

    def _drive(self, t, plain: bool):
        """``(bcs, forcing)`` of a step at time ``t``: the table and the
        force with their callables evaluated at ``t`` (the simulation's own
        without any). Unless ``plain``, the values are also written where
        the kernels read them, in place and on the device: the wall and
        force entries of ``bc``, the unfused route's ghost table, the
        volumes of the force's callables."""
        if not self.time_dependent:
            return self.bcs, self.forcing
        if t is None:
            raise ValueError(
                "a time-dependent simulation steps from a state that carries "
                "t (State.t; initial_state sets it)"
            )
        b = bcs_mod.resolve_bcs(self.bcs, t)
        forcing = _resolved_forcing(self.forcing, t)
        if not plain:
            self._write_drive(b, forcing)
        return b, forcing

    def _write_drive(self, b, forcing) -> None:
        """Write the resolved values ``b`` and ``forcing`` of the
        simulation's callables into the buffers the kernels read."""
        nd = self.grid.ndim
        if self.bc is not None:
            for (a, s), spec in self.bcs.items():
                for c, v in enumerate(spec.velocity):
                    if callable(v):
                        _fill(self.bc[(a * 2 + s) * nd + c],
                              b[(a, s)].velocity[c])
        elif self.ghosts is not None and bcs_mod.bcs_time_dependent(
                self.bcs):
            predictor2d.refill_ghosts(self.grid, self.bcs, b, self.ghosts)
        if forcing is None:
            return
        at = fused2d.FORCE_AT if nd == 2 else fused3d.FORCE_AT
        for a, f in enumerate(self.forcing):
            if not callable(f):
                continue
            vol = self.force_vol[a] if self.force_vol is not None else None
            if vol is not None:
                v = forcing[a]
                if _is_number(v):
                    _fill(vol, v)
                else:
                    vol.copy_(torch.as_tensor(v, dtype=vol.dtype,
                                              device=vol.device)
                              .broadcast_to(vol.shape))
            else:
                _fill(self.bc[at + a], forcing[a])

    def _refreshed(self, state: State, b) -> State:
        """``state`` with the stored own-axis faces of every Dirichlet
        face whose normal value is a callable of t set to its value in
        ``b`` (JAX's ``refresh_dirichlet_faces_internal_3d``; the fused
        routes keep the BC values on the boundary faces, so only these
        change); a component is copied before it is written."""
        u = list(state.u)
        nd = self.grid.ndim
        for (a, s), spec in self.bcs.items():
            if (spec.kind in bcs_mod.DIRICHLET_KINDS
                    and callable(spec.component(a, nd))):
                if u[a] is state.u[a]:
                    u[a] = u[a].clone()
                n = u[a].shape[a]
                face = u[a].select(a, 0 if s == 0 else n - 1)
                _fill(face, b[(a, s)].component(a, nd))
                if self.face_masks is not None:
                    face.mul_(self.face_masks[a].select(a, 0 if s == 0
                                                        else n - 1))
        if all(x is y for x, y in zip(u, state.u)):
            return state
        return dataclasses.replace(state, u=tuple(u))

    # -- the step size ---------------------------------------------------------

    @functools.cached_property
    def _dt_consts(self) -> dict[str, torch.Tensor]:
        """The float32 0-d tensors on the device that a CFL step forms its
        dt from (the cap, cfl, rho), and the buffers of the fixed dt and
        of its half (rk2's stage 1): built once, so a step copies nothing
        from the host."""
        pr, dev = self.params, self.device
        out = {
            "full": step_size.constant(pr.dt, pr.rho, dev),
            "half": step_size.constant(float(np.float32(0.5)
                                             * np.float32(pr.dt)),
                                       pr.rho, dev),
        }
        for k, v in (("cap", pr.dt), ("rho", pr.rho),
                     ("cfl", pr.cfl if pr.cfl is not None else 0.0)):
            out[k] = torch.full((), v, dtype=torch.float32, device=dev)
        return out

    def _vel_inv(self, u) -> torch.Tensor:
        """``max_a max|u_a| / h_a`` (at least 1e-12): JAX's CFL reduction
        over a velocity field, on the device."""
        inv = torch.full((), step_size.VEL_FLOOR, dtype=self.grid.dtype,
                         device=self.device)
        for a, comp in enumerate(u):
            inv = torch.maximum(inv, torch.linalg.vector_norm(
                comp, float("inf")) / self.grid.spacing[a])
        return inv

    def _dts(self, vel: Optional[torch.Tensor]) -> torch.Tensor:
        """The step's step-size buffer ``[dt, rho/dt, dt/rho]``: the fixed
        dt's, or with ``cfl`` set, JAX's ``_dt_from_vel`` formed on the
        device from the CFL reduction ``vel`` in the same order,
        ``min(dt, cfl / max(vel, 1e-12))``."""
        c = self._dt_consts
        if self.params.cfl is None:
            return c["full"]
        dt = torch.minimum(
            c["cap"], c["cfl"] / torch.clamp_min(vel, step_size.VEL_FLOOR))
        return step_size.from_tensor(dt, c["rho"])

    def _half_dts(self, dts: torch.Tensor) -> torch.Tensor:
        """The buffer of rk2's stage 1, ``0.5*dt``."""
        c = self._dt_consts
        if self.params.cfl is None:
            return c["half"]
        return step_size.from_tensor(0.5 * dts[0], c["rho"])

    @property
    def _carries_vel(self) -> bool:
        """The route whose run_scan carries the corrector's max|u_a|/h_a as
        the next step's CFL reduction (JAX's fused steps); the others
        recompute it from the step's entry field, as JAX's jnp step, and so
        does a time-dependent run (from the refreshed field, as JAX's
        time-dependent scan)."""
        return self.fused and self.les is None and not self.time_dependent

    # -- the step --------------------------------------------------------------

    def step(self, state: State) -> tuple[State, StepDiagnostics]:
        """One projection step: the fused kernels of the grid's dimension
        (with ``les``: the LES predictor's kernels), or the unfused 2D
        route with the predictor kernel; ``integrator`` "euler" or "rk2",
        a fixed or (``cfl``) CFL-adaptive dt. The CFL reduction comes from
        ``state.u``, as JAX's single fused step computes it. A sharded
        simulation steps from ``run_scan`` only, as in JAX."""
        self._check_unsharded()
        return self._step(state, self._entry_vel(state), plain=False)[:2]

    def _check_unsharded(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "Simulation.step on a sharded simulation: the slab tier runs "
                "from run_scan only, as in JAX; the per-step GSPMD route is "
                "not ported (ROADMAP Queue A, 'parallel/: the explicit-halo "
                "solvers and the pencil tier')"
            )

    def step_plain(self, state: State) -> tuple[State, StepDiagnostics]:
        """The same step from the plain versions only (no kernel), in any
        dimension: the JAX package's jnp step for this slice (with ``les``,
        ``stencils.predictor`` with ``les.sgs_forcing`` as its forcing),
        rk2 and the CFL dt included."""
        return self._step(state, self._entry_vel(state), plain=True)[:2]

    def _entry_vel(self, state: State) -> Optional[torch.Tensor]:
        """The CFL reduction a route that carries it starts from (JAX's
        ``_vel_inv`` at scan entry); None otherwise."""
        if self.params.cfl is None or not self._carries_vel:
            return None
        return self._vel_inv(state.u)

    def _step(self, state: State, vel: Optional[torch.Tensor],
              plain: bool):
        """One step of the route ``build`` chose: ``(state, diagnostics,
        max_vel)``, ``max_vel`` the new velocity's max|u_a|/h_a (the next
        step's ``vel`` on the fused route). ``plain``: the kernels' plain
        versions only. A time-dependent run resolves its callables at
        ``state.t`` first (:meth:`_drive`), and a state that carries t
        leaves with t advanced by the step's dt."""
        b, forcing = self._drive(state.t, plain)
        if self.fused and self.time_dependent:
            state = self._refreshed(state, b)
            if self.params.cfl is not None:
                vel = self._vel_inv(state.u)
        if not self.fused:
            out = self._step_unfused(state, plain, b, forcing)
        elif self.les is not None:
            out = self._step_les(state, plain, b)
        else:
            out = self._step_fused(state, vel, plain, b, forcing)
        new, diag, max_vel = out
        if state.t is not None:
            new = dataclasses.replace(new, t=state.t + diag.dt)
        return new, diag, max_vel

    def _p_start(self, p: torch.Tensor, p_prev: Optional[torch.Tensor]):
        """The iterative solve's start: ``p``, or ``p + beta (p - p_prev)``
        with ``PoissonConfig.extrapolate = beta``."""
        beta = self.params.poisson.extrapolate
        if beta and p_prev is not None:
            return p + beta * (p - p_prev)
        return p

    def _step_fused(self, state: State, vel, plain: bool, b, forcing):
        """JAX's ``_step_fused3d_internal`` / ``_step_fused2d_internal``:
        the predictor kernel (with the BC values, the force and the RHS),
        the solve, the corrector kernel. rk2: stage 1 at 0.5*dt and its
        projection (its diagnostics dropped), then the predictor in
        ``base`` mode on the midpoint field, anchored at the step-start
        state, and a second solve from the stage-1 pressure. With a
        scalar: the thermal modes, both predictors with the step-start
        theta's buoyancy, the final corrector advancing theta by the full
        dt. ``b``, ``forcing``: the step's table and force
        (:meth:`_drive`)."""
        g, pr = self.grid, self.params
        dts = self._dts(vel)
        theta, cfg = state.theta, self.scalar
        if cfg is None:
            theta = None
        buoy_theta = theta if theta is not None and cfg.buoyant else None
        code = self._code
        if plain:
            # the JAX jnp step's entry BC pass (a no-op on the invariant)
            u = bcs_mod.apply_velocity_bcs(g, b, state.u, self.face_masks)
            if buoy_theta is not None:
                forcing = scalar_mod.combined_forcing(
                    forcing, scalar_mod.buoyancy_forcing(g, cfg, buoy_theta))

            def predict(src, d, base=None):
                return fused3d.predictor_rhs_plain(
                    g, b, src, d[0], pr.nu, pr.upwind_gamma, pr.rho,
                    forcing=forcing, base=base, code=code)

            def correct(u_star, p, d, th=None):
                if th is None:
                    return fused3d.correct_diag_plain(
                        g, u_star, p, d[2], self.op.periodic, b, code)
                return fused3d.correct_diag_thermal_plain(
                    g, u_star, p, d[2], self.op.periodic, th, cfg, d[0], b)
        else:
            u = state.u
            _, predictor_rhs, correct_diag = _kernels(g.ndim)
            kw = {"force": self._force_numbers(forcing),
                  "force_vol": self.force_vol}
            # 3D: the open faces and the masked mode's stencil code
            kw_corr = {} if g.ndim == 2 else {"bcs": b, "code": code}
            if g.ndim == 3:
                kw["code"] = code

            def predict(src, d, base=None):
                return predictor_rhs(g, b, src, d[0], pr.nu,
                                     pr.upwind_gamma, pr.rho, bc=self.bc,
                                     base=base, dts=d, theta=buoy_theta,
                                     scalar=cfg, thermal=self.thermal, **kw)

            def correct(u_star, p, d, th=None):
                if th is None:
                    return correct_diag(g, u_star, p, d[2], self.op.periodic,
                                        **kw_corr)
                return correct_diag(g, u_star, p, d[2], self.op.periodic,
                                    theta=th, scalar=cfg, dt=d[0],
                                    thermal=self.thermal, **kw_corr)

        p_start = self._p_start(state.p, state.p_prev)
        it_half = None
        if pr.integrator == "rk2":
            half = self._half_dts(dts)
            u_half, rhs = predict(u, half)
            p_half, it_half, _ = self._solve_pressure(rhs, p_start, plain)
            u_mid = correct(u_half, p_half, half)[0]
            u_star, rhs = predict(u_mid, dts, base=u)
            p_start = p_half
        else:
            u_star, rhs = predict(u, dts)
        p, iters, res = self._solve_pressure(rhs, p_start, plain)
        if it_half is not None:
            iters = iters + it_half
        u_new, max_div, max_vel, *theta_new = correct(u_star, p, dts, theta)
        theta_new = theta_new[0] if theta_new else state.theta
        return (self._next_state(state, u_new, p, theta_new),
                self._diag(iters, res, max_div, max_vel, dts), max_vel)

    def _solve_pressure(self, rhs: torch.Tensor, p_start: torch.Tensor,
                        plain: bool = False):
        """Dispatch to the configured pressure solver, as the JAX
        ``Simulation._solve_pressure``: fft -> dctcg -> mg -> mgcg ->
        solve_poisson. The iterative solves start from ``p_start``
        (:meth:`_p_start`). ``plain``: the kernels' plain versions only (the
        multigrid's plain V-cycle route). Returns (p, iters, res)."""
        pr = self.params.poisson
        if self.dct_solver is not None:
            return fft_poisson.solve_with_residual(
                self.dct_solver, self.op, rhs,
                diag_residual=pr.diag_residual, use_kernel=not plain,
            )
        if self.dctcg_solver is not None:
            return self.dctcg_solver.solve(rhs, p_start, pr.tol,
                                           pr.max_iters, self.op)
        mg = self.mg_solver
        if mg is not None:
            if plain:
                mg = dataclasses.replace(mg, fused=False, use_pallas=False)
            solve = mg.solve_pcg if pr.method == "mgcg" else mg.solve
            return solve(rhs, p_start, pr.tol, pr.max_iters)
        return poisson_mod.solve_poisson(self.op, rhs, p_start, self.grid, pr)

    @staticmethod
    def _next_state(state: State, u_new, p, theta) -> State:
        """The new state, with the step's new ``theta`` (None without a
        scalar); ``p_prev`` advances when the state carries it."""
        return State(u=u_new, p=p, theta=theta,
                     p_prev=state.p if state.p_prev is not None else None)

    def _predict_les(self, u, dt, plain: bool,
                     b) -> tuple[torch.Tensor, ...]:
        """u* with the BC values (the table ``b``) and the subgrid stress
        of ``les`` (JAX's ``_predict`` on its LES route): nu_t from its
        kernel (the dynamic model's from the plain ``les.eddy_viscosity``),
        then the LES predictor kernel; ``plain``: ``stencils.predictor``
        with ``les.sgs_forcing`` as its forcing."""
        g, pr, cfg = self.grid, self.params, self.les
        if plain:
            return fused3d.predictor_rhs_plain(
                g, b, u, dt, pr.nu, pr.upwind_gamma, pr.rho,
                les_mod.sgs_forcing(g, b, u, cfg))[0]
        if cfg.model == "smagorinsky":
            nu_t = predictor3d.nu_t_3d(g, b, u, cfg, bc=self.bc)
        else:
            nu_t = les_mod.eddy_viscosity(g, b, u, cfg)
        return predictor3d.predictor_3d(
            g, b, u, dt, pr.nu, pr.upwind_gamma, nu_t=nu_t, bc=self.bc
        )

    def _step_les(self, state: State, plain: bool, b):
        """The LES step: JAX's ``_step_jnp`` through ``_predict``, with the
        fused corrector (its plain version with ``plain``). rk2: stage 1
        at 0.5*dt and its projection; then the predictor on the midpoint
        field, ``u* = u + (u*_mid - u_mid)`` with its BC values, as JAX
        forms it; nu_t is recomputed on each stage's field. The CFL
        reduction comes from the step's entry field, as in JAX. ``b``: the
        step's table."""
        g, pr = self.grid, self.params
        u = (bcs_mod.apply_velocity_bcs(g, b, state.u) if plain
             else state.u)
        dts = self._dts(self._vel_inv(u) if pr.cfl is not None else None)
        correct = (fused3d.correct_diag_plain if plain
                   else fused3d.correct_diag_3d)

        def project(u_star, p_start, d):
            rhs = stencils.poisson_rhs(g, u_star, d[0], pr.rho)
            p, iters, res = self._solve_pressure(rhs, p_start, plain)
            return correct(g, u_star, p, d[2], self.op.periodic), p, iters, res

        p_start = self._p_start(state.p, state.p_prev)
        it_half = None
        if pr.integrator == "rk2":
            half = self._half_dts(dts)
            u_half = self._predict_les(u, half[0], plain, b)
            (u_mid, _, _), p_start, it_half, _ = project(u_half, p_start, half)
            adv = self._predict_les(u_mid, dts[0], plain, b)
            u_star = bcs_mod.apply_velocity_bcs(g, b, tuple(
                a + (c2 - c1) for a, c2, c1 in zip(u, adv, u_mid)))
        else:
            u_star = self._predict_les(u, dts[0], plain, b)
        (u_new, max_div, max_vel), p, iters, res = project(u_star, p_start,
                                                          dts)
        if it_half is not None:
            iters = iters + it_half
        return (self._next_state(state, u_new, p, state.theta),
                self._diag(iters, res, max_div, max_vel, dts), max_vel)

    def _predict_2d(self, u, dt, plain: bool, b,
                    forcing=None) -> tuple[torch.Tensor, ...]:
        """JAX's ``_predict`` on the unfused 2D route: the per-component
        predictor (its kernel, or ``plain``: its plain version) with the
        step's ``forcing`` (the kernel: volumes; the plain version: any
        form the plain predictor adds), then the BC pass with the face
        masks; ``b``: the step's table."""
        g, pr = self.grid, self.params
        if plain:
            u_star = predictor2d.predictor_2d_plain(g, b, u, dt, pr.nu,
                                                    pr.upwind_gamma, forcing)
        else:
            u_star = predictor2d.predictor_2d(g, b, u, dt, pr.nu,
                                              pr.upwind_gamma,
                                              ghosts=self.ghosts,
                                              forcing=forcing)
        return bcs_mod.apply_velocity_bcs(g, b, u_star, self.face_masks)

    def _unfused_forcing(self, forcing, theta, plain: bool):
        """The unfused predictor's force of a step: the step's
        ``forcing`` (``plain``; the volumes of ``force_vol`` for the
        kernel) plus the buoyancy of the step-start ``theta``, as JAX's
        ``_combined_forcing``."""
        base = forcing if plain else self.force_vol
        if self.scalar is None or theta is None or not self.scalar.buoyant:
            return base
        return scalar_mod.combined_forcing(
            base, scalar_mod.buoyancy_forcing(self.grid, self.scalar, theta))

    def _project(self, u_star, p_start, dts, plain: bool, b=None):
        """JAX's ``_project``: the IBM forcing on u*, the RHS
        ``(rho/dt) div u*`` on fluid cells, the solve, the correction with
        the obstacle's correction masks, and with an OUTFLOW face the BC
        pass again (then the IBM's wet faces); ``b``: the step's table (the
        simulation's when None). Returns (u_new, p, iters, res)."""
        g, pr = self.grid, self.params
        b = self.bcs if b is None else b
        if self.ibm is not None:
            u_star = self.ibm.apply(u_star)
        rhs = stencils.poisson_rhs(g, u_star, dts[0], pr.rho) * self.op.fluid
        p, iters, res = self._solve_pressure(rhs, p_start, plain)
        u_new = stencils.correct_velocity(g, u_star, p, dts[2],
                                          self.corr_masks, self.op.periodic)
        if bcs_mod.has_outflow(g, b):
            # the outflow copy must track the corrected interior
            u_new = bcs_mod.apply_velocity_bcs(g, b, u_new, self.face_masks)
            if self.ibm is not None:
                u_new = self.ibm.apply_wet(u_new)
        return u_new, p, iters, res

    def _entry_field(self, state: State, b=None):
        """The unfused step's entry field: the BC pass with face masks
        (the table ``b``, the simulation's when None), then the IBM apply
        (the correction perturbed the interpolated surface values)."""
        b = self.bcs if b is None else b
        u = bcs_mod.apply_velocity_bcs(self.grid, b, state.u,
                                       self.face_masks)
        return self.ibm.apply(u) if self.ibm is not None else u

    def star_rhs(self, state: State, plain: bool = False):
        """The unfused Euler step's first half: ``(u*, rhs)``, u* the
        predicted velocity with its BC values and the IBM forcing, rhs the
        Poisson RHS ``(rho/dt) div u*`` on fluid cells (the step's dt).
        ``plain``: the predictor's plain version on any device."""
        g, pr = self.grid, self.params
        b, forcing = self._drive(state.t, plain)
        u = self._entry_field(state, b)
        dts = self._dts(self._vel_inv(u) if pr.cfl is not None else None)
        u_star = self._predict_2d(
            u, dts[0], plain, b,
            self._unfused_forcing(forcing, state.theta, plain))
        if self.ibm is not None:
            u_star = self.ibm.apply(u_star)
        return u_star, stencils.poisson_rhs(g, u_star, dts[0],
                                            pr.rho) * self.op.fluid

    def _step_unfused(self, state: State, plain: bool, b, forcing):
        """JAX's ``_step_jnp`` (see the module docstring): the entry field,
        its CFL reduction, the predictor (with the force and the buoyancy
        of the step-start theta) and a projection; rk2: the predictor at
        0.5*dt and its projection, then the predictor on the midpoint
        field, ``u* = u + (u*_mid - u_mid)`` with its BC values, and a
        second projection from the stage-1 pressure. ``b``, ``forcing``:
        the step's table and force (:meth:`_drive`)."""
        g, pr = self.grid, self.params
        u = self._entry_field(state, b)
        dts = self._dts(self._vel_inv(u) if pr.cfl is not None else None)
        f = self._unfused_forcing(forcing, state.theta, plain)
        p_start = self._p_start(state.p, state.p_prev)
        if pr.integrator == "rk2":
            half = self._half_dts(dts)
            u_half = self._predict_2d(u, half[0], plain, b, f)
            u_mid, p_half, it_half, _ = self._project(u_half, p_start, half,
                                                      plain, b)
            adv = self._predict_2d(u_mid, dts[0], plain, b, f)
            u_star = bcs_mod.apply_velocity_bcs(g, b, tuple(
                a + (c2 - c1) for a, c2, c1 in zip(u, adv, u_mid)),
                self.face_masks)
            u_new, p, iters, res = self._project(u_star, p_half, dts, plain,
                                                 b)
            iters = iters + it_half
        else:
            u_star = self._predict_2d(u, dts[0], plain, b, f)
            u_new, p, iters, res = self._project(u_star, p_start, dts, plain,
                                                 b)
        div = stencils.divergence(g, u_new) * self.op.fluid
        dt = dts[0]
        theta_new = state.theta
        if self.scalar is not None and state.theta is not None:
            theta_new = scalar_mod.advance(g, self.scalar, u_new,
                                           state.theta, dt, self.scalar_solid)
        return (self._next_state(state, u_new, p, theta_new), StepDiagnostics(
            poisson_iters=iters, poisson_res=res,
            max_div=torch.max(torch.abs(div)),
            max_cfl=stencils.max_cfl(g, u_new, dt), dt=dt,
        ), None)

    @staticmethod
    def _diag(iters, res, max_div, max_vel, dts) -> StepDiagnostics:
        """The fused routes' diagnostics: ``max_cfl = max_vel * dt`` and
        the step's dt, from its device buffer."""
        dt = dts[0]
        return StepDiagnostics(
            poisson_iters=iters, poisson_res=res, max_div=max_div,
            max_cfl=max_vel * dt, dt=dt,
        )

    def run_scan(
        self, state: State, n_steps: int
    ) -> tuple[State, StepDiagnostics]:
        """Advance ``n_steps``; returns the final state and per-step
        diagnostics stacked on the device. With the direct (fft) solve
        nothing inside the loop waits for the device; an iterative solve
        reads its convergence flag on the host once per block of iterations
        (ops/poisson.HOST_SYNCS counts the reads). A sharded simulation
        runs the slab-sharded step (parallel/fused_sharded.py), as JAX's
        ``run_scan`` dispatches to ``run_scan_sharded_fused``."""
        if self.mesh is not None:
            from .parallel.fused_sharded import run_scan_sharded_fused

            return run_scan_sharded_fused(self, self.mesh, state, n_steps)
        if n_steps < 0:
            raise ValueError("run_scan needs n_steps >= 0")
        diags = []
        for state, d in self._steps(state, n_steps):
            diags.append(d)
        return state, self._stacked(diags)

    def _steps(self, state: State, n_steps: int):
        """Yield ``(state, diagnostics)`` after each of ``n_steps`` kernel
        steps. On the fused route the corrector's max|u_a|/h_a of each
        step is the next step's CFL reduction (JAX's scan carry; the entry
        value is one reduction over ``state.u``), so the loop reads
        nothing on the host for the dt."""
        self._check_unsharded()
        vel = self._entry_vel(state)
        for _ in range(n_steps):
            state, d, max_vel = self._step(state, vel, plain=False)
            vel = max_vel if self._carries_vel else None
            yield state, d

    def _stacked(self, diags: list) -> StepDiagnostics:
        """The steps' diagnostics stacked on the device (a 0-step run's:
        :meth:`empty_diagnostics`)."""
        if not diags:
            return self.empty_diagnostics()
        return StepDiagnostics(*(torch.stack(f) for f in zip(*diags)))

    def run_scan_stats(self, state: State, n_steps: int, stats=None):
        """Advance ``n_steps`` accumulating the running flow statistics
        (time-mean fields and Reynolds stresses, stats.py) after every
        step, as JAX's ``run_scan_stats``; pass the returned ``stats`` back
        in to go on accumulating. The steps are the kernel steps of
        :meth:`run_scan` (JAX takes its jnp step for the TPU's internal
        layout, which the port does not have); the accumulator stays on the
        device and nothing in the loop reads the host but what the step
        reads. Returns ``(state, diags, stats)``."""
        from . import stats as stats_mod

        if n_steps < 0:
            raise ValueError("run_scan_stats needs n_steps >= 0")
        if stats is None:
            stats = stats_mod.init_stats(self.grid, state.theta is not None,
                                         self.device)
        diags = []
        for state, d in self._steps(state, n_steps):
            stats = stats_mod.accumulate(self.grid, stats, state)
            diags.append(d)
        return state, self._stacked(diags), stats

    def run_scan_tracers(self, state: State, pos: torch.Tensor,
                         n_steps: int):
        """Advance ``n_steps`` advecting the tracer positions ``pos`` (n,
        ndim) after every step with its end-of-step velocity and its own dt
        (tracers.advect_tracers, the dt from the step's device buffer), as
        JAX's ``run_scan_tracers``. Returns ``(state, pos, diags, traj)``,
        ``traj`` the positions after each step, ``(n_steps, n, ndim)`` on
        the device."""
        from . import tracers as tracers_mod

        if n_steps < 0:
            raise ValueError("run_scan_tracers needs n_steps >= 0")
        diags, traj = [], []
        for state, d in self._steps(state, n_steps):
            pos = tracers_mod.advect_tracers(self.grid, self.bcs, state.u,
                                             pos, d.dt)
            diags.append(d)
            traj.append(pos)
        traj = (torch.stack(traj) if traj else
                pos.new_empty((0, *pos.shape)))
        return state, pos, self._stacked(diags), traj

    def run_scan_forces(
        self, state: State, n_steps: int, box
    ) -> tuple[State, StepDiagnostics, torch.Tensor, torch.Tensor]:
        """Advance ``n_steps`` sampling the control-volume force terms
        after every step (``utils.forces.cv_terms_nd`` over the static cell
        ``box``), as JAX's ``run_scan_forces``. Returns ``(state, diags,
        sf, mom)`` with ``sf`` and ``mom`` of shape ``(n_steps, ndim)`` on
        the device: the per-step surface-force and CV-momentum series for
        ``drag_lift_series(dt_sample=dt)``. The samples stay on the device;
        nothing inside the loop reads the host but what the step itself
        reads (an iterative solve's convergence flag). A sharded simulation
        raises at its first step, as ``step`` does."""
        from .utils.forces import cv_terms_nd

        if n_steps < 0:
            raise ValueError("run_scan_forces needs n_steps >= 0")
        box = tuple(int(b) for b in box)
        nd = self.grid.ndim
        if n_steps == 0:
            empty = torch.empty((0, nd), dtype=self.grid.dtype,
                                device=self.device)
            return state, self.empty_diagnostics(), empty, empty.clone()
        diags, sfs, moms = [], [], []
        for state, d in self._steps(state, n_steps):
            sf, mom = cv_terms_nd(self.grid, state, self.params.nu, box)
            diags.append(d)
            sfs.append(torch.stack(sf))
            moms.append(torch.stack(mom))
        return state, self._stacked(diags), torch.stack(sfs), torch.stack(moms)

    def empty_diagnostics(self) -> StepDiagnostics:
        """The diagnostics of a 0-step run: five empty tensors on the
        device, as JAX's length-0 ``lax.scan`` stacks them (the iteration
        count int32, the rest in the grid's dtype)."""
        return StepDiagnostics(
            torch.empty(0, dtype=torch.int32, device=self.device),
            *(torch.empty(0, dtype=self.grid.dtype, device=self.device)
              for _ in range(4)))


def _check_3d(grid: GridSpec, bcs, per, solid, sdf, forcing, scalar) -> None:
    """Raise, naming the ROADMAP item, for a 3D configuration the fused 3D
    kernels do not take: the IBM, an obstacle with a periodic axis (JAX
    refuses it too and takes its jnp step), a force or a scalar with an
    obstacle or an open face, an open face with a periodic axis."""
    if sdf is not None:
        raise NotImplementedError(
            "the 3D immersed boundary (ibm.py's 3D bands, internal_forcing "
            "and fused_rhs_patch of the fused 3D step): not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )
    obstacle = solid is not None
    if obstacle and any(per):
        raise NotImplementedError(
            "a 3D obstacle on a grid with a periodic axis (JAX's fused gate "
            "refuses it, its jnp step runs it; 3D has no unfused route): "
            "not ported yet (ROADMAP Queue A, 'Other BC kinds')"
        )
    if obstacle and scalar is not None:
        raise NotImplementedError(
            "3D heated obstacles (the isothermal clamp and body_neumann "
            "around kernel 2): not ported yet (ROADMAP Queue A, 'Physics "
            "extensions')"
        )
    if obstacle and forcing is not None:
        raise NotImplementedError(
            "a body force with a 3D obstacle (kernel 1's masked mode has no "
            "forced instantiation): not ported yet (ROADMAP Queue A, "
            "'Physics extensions')"
        )
    if not fused3d.walls_and_periodic(grid, bcs):
        if scalar is not None or forcing is not None:
            raise NotImplementedError(
                "a transported scalar or a body force with INFLOW, OUTFLOW "
                "or SLIP faces in 3D (the open mode of kernels 1-2 has no "
                "thermal or forced instantiation): not ported yet (ROADMAP "
                "Queue A, 'Physics extensions')"
            )
        if any(per):
            raise NotImplementedError(
                "INFLOW, OUTFLOW or SLIP faces with a periodic axis in 3D "
                "(the open mode of kernels 1-2 is instantiated for bounded "
                "grids; 3D has no unfused route): not ported yet (ROADMAP "
                "Queue A, 'Other BC kinds')"
            )


def _kernels(ndim: int):
    """(applicable, predictor_rhs, correct_diag) of the fused step in
    ``ndim`` dimensions."""
    if ndim == 3:
        return (fused3d.fused_step3d_applicable, fused3d.predictor_rhs_3d,
                fused3d.correct_diag_3d)
    return (fused2d.fused_step2d_applicable, fused2d.predictor_rhs_2d,
            fused2d.correct_diag_2d)


def _is_number(v) -> bool:
    """A force component or BC value the kernels' buffers hold as one
    number: a Python number, or a 0-d tensor or array."""
    return isinstance(v, (int, float)) or (
        isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim == 0)


def _fill(dst: torch.Tensor, v) -> None:
    """``dst`` set to the number ``v`` in place (a 0-d tensor on the
    device, or a Python number: no host read either way)."""
    dst.fill_(v if isinstance(v, torch.Tensor) else float(v))


def _check_time_values(bcs, t0):
    """The table resolved at ``t0``; raises unless every callable of t in
    it returns a number (a time-dependent profile is not ported)."""
    b0 = bcs_mod.resolve_bcs(bcs, t0)
    for face, spec in bcs.items():
        for c, v in enumerate(spec.velocity):
            if callable(v) and not _is_number(b0[face].velocity[c]):
                raise NotImplementedError(
                    f"a time-dependent BC profile on face {face} (a callable "
                    "returning an array): not ported yet (ROADMAP Queue A, "
                    "'Physics extensions')"
                )
    return b0


def _forcing_parts(forcing, grid: GridSpec, periodic, device, t0):
    """``forcing`` as the simulation holds it: per component a float (a
    number, or a 0-d array or tensor), a float32 tensor on ``device`` in
    the forcing layout (``fused3d.force_shape``; an array broadcast to
    it), a callable of t (checked at ``t0``: a number or such an array),
    or None; None without a force. A broadcast that fails raises
    ValueError, as JAX's add does."""
    if forcing is None:
        return None
    if len(forcing) != grid.ndim:
        raise ValueError(f"forcing {forcing!r} has wrong rank for "
                         f"ndim={grid.ndim}")
    out = []
    for a, f in enumerate(forcing):
        shape = fused3d.force_shape(grid, periodic, a)
        if f is None or callable(f):
            if callable(f):
                v = f(t0)
                if not _is_number(v):
                    _force_array(v, shape, device, a)
            out.append(f)
        elif _is_number(f):
            out.append(float(f))
        else:
            out.append(_force_array(f, shape, device, a))
    return tuple(out)


def _force_array(f, shape, device, a: int) -> torch.Tensor:
    """The array force ``f`` of component ``a`` broadcast to ``shape``,
    a contiguous float32 tensor on ``device``."""
    t = torch.as_tensor(np.asarray(f) if not isinstance(f, torch.Tensor)
                        else f, dtype=torch.float32, device=device)
    try:
        return t.broadcast_to(shape).contiguous()
    except RuntimeError as e:
        raise ValueError(f"forcing component {a} of shape {tuple(t.shape)} "
                         f"does not broadcast to its faces {shape}") from e


def _resolved_forcing(forcing, t):
    """The force with its callables evaluated at ``t``."""
    if forcing is None or not any(callable(f) for f in forcing):
        return forcing
    return tuple(f(t) if callable(f) else f for f in forcing)


def _force_volumes(forcing, grid: GridSpec, periodic, device, fused: bool,
                   t0):
    """The forcing volumes of a simulation (``Simulation.force_vol``): on
    a fused route the array components (a static array is its own volume,
    an array-valued callable gets a buffer), on the unfused route every
    forced component (a number as a constant volume); None where no
    component has one."""
    if forcing is None:
        return None
    vols = []
    for a, f in enumerate(forcing):
        shape = fused3d.force_shape(grid, periodic, a)
        if isinstance(f, torch.Tensor):
            vols.append(f)
        elif f is None or (fused and (not callable(f) or _is_number(f(t0)))):
            vols.append(None)
        elif callable(f):
            vols.append(torch.zeros(shape, dtype=torch.float32,
                                    device=device))
        else:
            vols.append(torch.full(shape, float(f), dtype=torch.float32,
                                   device=device))
    return tuple(vols) if any(v is not None for v in vols) else None

