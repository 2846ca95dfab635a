"""Chorin projection time stepper: predictor -> Poisson -> corrector (PyTorch).

Counterpart of ``navierstokessolver_tpu/solver.py`` for the ported slice:
explicit Euler or rk2 (the midpoint rule with a projection per stage), at
a fixed or a CFL-adaptive dt computed on the device (the kernels read the
step size from a device buffer, ops/step_size.py); WALL boundaries and
PERIODIC axes (the Taylor-Green vortices, decaying turbulence, the
periodic channel), in 2D also INFLOW, OUTFLOW and SLIP faces, staircase
obstacles, the sharp-interface immersed boundary (ibm.py) and a static
body force (one number a component, on the fused route);
every pressure method of the JAX package (the direct spectral solve,
damped Jacobi, red-black Gauss-Seidel and SOR, CG, multigrid,
MG-preconditioned CG and the DCT-preconditioned ``dctcg``); in 3D the
Smagorinsky LES closure (on WALL tables).

Two step routes, as :meth:`Simulation.step` dispatches in JAX:

Fused (every face a WALL with constant values or on a PERIODIC axis; no
obstacle, no IBM), as the JAX fused steps (``_step_fused3d_internal``,
``_step_fused2d_internal``; the 2D predictor adds the static force):

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

With ``les`` set (3D only) the predictor is the JAX package's LES route
(``Simulation._predict`` through ``_pallas_les_ok``):

    eddy viscosity             ops/predictor3d.nu_t_3d (kernel; the
                               dynamic model: les.eddy_viscosity, plain)
    predictor + BCs + SGS      ops/predictor3d.predictor_3d (kernel)
    Poisson RHS                ops/stencils.poisson_rhs (plain)

The fused-trailing route is the JAX package's:
``dataclasses.replace(sim, dct_solver=dataclasses.replace(sim.dct_solver,
fuse_trailing=True))``.

Unfused (2D, any other face kind, an obstacle or the IBM), the JAX
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
step, and is held to that.

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
    # the static body force, a float or None a component (JAX's
    # ``_static_forcing``; the fused 2D route only); None: no force
    forcing: Optional[tuple[Optional[float], ...]] = None

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

        ``solid``: a cell-centred obstacle mask (2D). ``sdf``: the
        obstacle's signed distance function (negative inside); it gives the
        solid mask when ``solid`` is None, and turns on the sharp-interface
        direct forcing (ibm.py). ``surface_velocity(*coords)``: the body's
        surface velocity (moving bodies; needs ``sdf``). ``les``: a
        :class:`~.les.LESConfig` (3D only). ``forcing``: a static body
        force, one Python float (or None) a component, as JAX's
        ``_static_forcing`` takes it; 2D tables of the fused route only
        (kernel 4 adds it). Array and callable forcing, forcing elsewhere,
        ``scalar`` and ``sharp_pressure`` are the JAX build's options for
        the other physics extensions; they are not ported yet and raise."""
        forcing = _static_forcing(forcing, grid)
        if scalar is not None:
            raise NotImplementedError(
                "scalar transport: not ported yet (ROADMAP Queue A, "
                "'Physics extensions')"
            )
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
        if sdf is not None and solid is None:
            solid = ibm_mod.solid_from_sdf(grid, sdf)
        if solid is not None and grid.ndim != 2:
            raise NotImplementedError(
                "3D obstacles: not ported yet (ROADMAP Queue A, 'Other BC "
                "kinds')"
            )
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
        sim = Simulation(grid=grid, bcs=bcs, params=params, op=op,
                         device=device, dct_solver=dct_solver,
                         mg_solver=mg_solver, les=les,
                         face_masks=face_masks, corr_masks=corr_masks,
                         ibm=ibm, dctcg_solver=dctcg_solver, forcing=forcing)
        # the route, settled once: the fused kernels of the grid's dimension
        # (every face a WALL with constant values or on a PERIODIC axis; no
        # obstacle, no IBM) read ``bc`` (in 2D with the force); the unfused
        # 2D route's predictor kernel reads ``ghosts``; 3D has no unfused
        # route
        applicable = _kernels(grid.ndim)[0]
        if face_masks is None and ibm is None and applicable(grid, bcs):
            sim.bc = (fused2d.bc_table(grid, bcs, device, forcing)
                      if grid.ndim == 2 else fused3d.bc_table(grid, bcs, device))
        elif forcing is not None:
            raise NotImplementedError(
                "a body force on the unfused 2D route (the predictor kernel "
                "of ops/predictor2d.py has no force mode): not ported yet "
                "(ROADMAP Queue A, 'Physics extensions')"
            )
        elif grid.ndim == 3:
            raise NotImplementedError(
                "a 3D table the fused 3D kernels do not take: not ported "
                "yet (ROADMAP Queue A, 'Other BC kinds')"
            )
        else:
            sim.ghosts = predictor2d.ghost_table(grid, bcs, device)
        return sim

    @property
    def fused(self) -> bool:
        """The step runs the fused kernels of the grid's dimension (the
        route ``build`` chose); otherwise the unfused 2D route."""
        return self.bc is not None

    def initial_state(self) -> State:
        st = zero_state(self.grid, self.device)
        u = bcs_mod.apply_velocity_bcs(self.grid, self.bcs, st.u,
                                       self.face_masks)
        # the extrapolated warm start carries p_prev from step 0
        p_prev = st.p if self.params.poisson.extrapolate else None
        return State(u=u, p=st.p, p_prev=p_prev)

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
        recompute it from the step's entry field, as JAX's jnp step."""
        return self.fused and self.les is None

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
        versions only."""
        if not self.fused:
            return self._step_unfused(state, plain)
        if self.les is not None:
            return self._step_les(state, plain)
        return self._step_fused(state, vel, plain)

    def _p_start(self, p: torch.Tensor, p_prev: Optional[torch.Tensor]):
        """The iterative solve's start: ``p``, or ``p + beta (p - p_prev)``
        with ``PoissonConfig.extrapolate = beta``."""
        beta = self.params.poisson.extrapolate
        if beta and p_prev is not None:
            return p + beta * (p - p_prev)
        return p

    def _step_fused(self, state: State, vel, plain: bool):
        """JAX's ``_step_fused3d_internal`` / ``_step_fused2d_internal``:
        the predictor kernel (with the BC values and the RHS), the solve,
        the corrector kernel. rk2: stage 1 at 0.5*dt and its projection
        (its diagnostics dropped), then the predictor in ``base`` mode on
        the midpoint field, anchored at the step-start state, and a second
        solve from the stage-1 pressure."""
        g, b, pr = self.grid, self.bcs, self.params
        dts = self._dts(vel)
        if plain:
            # the JAX jnp step's entry BC pass (a no-op on the invariant)
            u = bcs_mod.apply_velocity_bcs(g, b, state.u)

            def predict(src, d, base=None):
                return fused3d.predictor_rhs_plain(
                    g, b, src, d[0], pr.nu, pr.upwind_gamma, pr.rho,
                    forcing=self.forcing, base=base)

            def correct(u_star, p, d):
                return fused3d.correct_diag_plain(g, u_star, p, d[2],
                                                  self.op.periodic)
        else:
            u = state.u
            _, predictor_rhs, correct_diag = _kernels(g.ndim)
            force = {"force": self.forcing} if g.ndim == 2 else {}

            def predict(src, d, base=None):
                return predictor_rhs(g, b, src, d[0], pr.nu,
                                     pr.upwind_gamma, pr.rho, bc=self.bc,
                                     base=base, dts=d, **force)

            def correct(u_star, p, d):
                return correct_diag(g, u_star, p, d[2], self.op.periodic)

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
        u_new, max_div, max_vel = correct(u_star, p, dts)
        return (self._next_state(state, u_new, p),
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
    def _next_state(state: State, u_new, p) -> State:
        """The new state; ``p_prev`` advances when the state carries it."""
        return State(u=u_new, p=p,
                     p_prev=state.p if state.p_prev is not None else None)

    def _predict_les(self, u, dt, plain: bool) -> tuple[torch.Tensor, ...]:
        """u* with the BC values and the subgrid stress of ``les`` (JAX's
        ``_predict`` on its LES route): nu_t from its kernel (the dynamic
        model's from the plain ``les.eddy_viscosity``), then the LES
        predictor kernel; ``plain``: ``stencils.predictor`` with
        ``les.sgs_forcing`` as its forcing."""
        g, b, pr, cfg = self.grid, self.bcs, self.params, self.les
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

    def _step_les(self, state: State, plain: bool):
        """The LES step: JAX's ``_step_jnp`` through ``_predict``, with the
        fused corrector (its plain version with ``plain``). rk2: stage 1
        at 0.5*dt and its projection; then the predictor on the midpoint
        field, ``u* = u + (u*_mid - u_mid)`` with its BC values, as JAX
        forms it; nu_t is recomputed on each stage's field. The CFL
        reduction comes from the step's entry field, as in JAX."""
        g, b, pr = self.grid, self.bcs, self.params
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
            u_half = self._predict_les(u, half[0], plain)
            (u_mid, _, _), p_start, it_half, _ = project(u_half, p_start, half)
            adv = self._predict_les(u_mid, dts[0], plain)
            u_star = bcs_mod.apply_velocity_bcs(g, b, tuple(
                a + (c2 - c1) for a, c2, c1 in zip(u, adv, u_mid)))
        else:
            u_star = self._predict_les(u, dts[0], plain)
        (u_new, max_div, max_vel), p, iters, res = project(u_star, p_start,
                                                          dts)
        if it_half is not None:
            iters = iters + it_half
        return (self._next_state(state, u_new, p),
                self._diag(iters, res, max_div, max_vel, dts), max_vel)

    def _predict_2d(self, u, dt, plain: bool) -> tuple[torch.Tensor, ...]:
        """JAX's ``_predict`` on the unfused 2D route: the per-component
        predictor (its kernel, or ``plain``: its plain version), then the
        BC pass with the face masks."""
        g, b, pr = self.grid, self.bcs, self.params
        if plain:
            u_star = predictor2d.predictor_2d_plain(g, b, u, dt, pr.nu,
                                                    pr.upwind_gamma)
        else:
            u_star = predictor2d.predictor_2d(g, b, u, dt, pr.nu,
                                              pr.upwind_gamma,
                                              ghosts=self.ghosts)
        return bcs_mod.apply_velocity_bcs(g, b, u_star, self.face_masks)

    def _project(self, u_star, p_start, dts, plain: bool):
        """JAX's ``_project``: the IBM forcing on u*, the RHS
        ``(rho/dt) div u*`` on fluid cells, the solve, the correction with
        the obstacle's correction masks, and with an OUTFLOW face the BC
        pass again (then the IBM's wet faces). Returns (u_new, p, iters,
        res)."""
        g, b, pr = self.grid, self.bcs, self.params
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

    def _entry_field(self, state: State):
        """The unfused step's entry field: the BC pass with face masks,
        then the IBM apply (the correction perturbed the interpolated
        surface values)."""
        u = bcs_mod.apply_velocity_bcs(self.grid, self.bcs, state.u,
                                       self.face_masks)
        return self.ibm.apply(u) if self.ibm is not None else u

    def star_rhs(self, state: State, plain: bool = False):
        """The unfused Euler step's first half: ``(u*, rhs)``, u* the
        predicted velocity with its BC values and the IBM forcing, rhs the
        Poisson RHS ``(rho/dt) div u*`` on fluid cells (the step's dt).
        ``plain``: the predictor's plain version on any device."""
        g, pr = self.grid, self.params
        u = self._entry_field(state)
        dts = self._dts(self._vel_inv(u) if pr.cfl is not None else None)
        u_star = self._predict_2d(u, dts[0], plain)
        if self.ibm is not None:
            u_star = self.ibm.apply(u_star)
        return u_star, stencils.poisson_rhs(g, u_star, dts[0],
                                            pr.rho) * self.op.fluid

    def _step_unfused(self, state: State, plain: bool):
        """JAX's ``_step_jnp`` (see the module docstring): the entry field,
        its CFL reduction, the predictor and a projection; rk2: the
        predictor at 0.5*dt and its projection, then the predictor on the
        midpoint field, ``u* = u + (u*_mid - u_mid)`` with its BC values,
        and a second projection from the stage-1 pressure."""
        g, b, pr = self.grid, self.bcs, self.params
        u = self._entry_field(state)
        dts = self._dts(self._vel_inv(u) if pr.cfl is not None else None)
        p_start = self._p_start(state.p, state.p_prev)
        if pr.integrator == "rk2":
            half = self._half_dts(dts)
            u_half = self._predict_2d(u, half[0], plain)
            u_mid, p_half, it_half, _ = self._project(u_half, p_start, half,
                                                      plain)
            adv = self._predict_2d(u_mid, dts[0], plain)
            u_star = bcs_mod.apply_velocity_bcs(g, b, tuple(
                a + (c2 - c1) for a, c2, c1 in zip(u, adv, u_mid)),
                self.face_masks)
            u_new, p, iters, res = self._project(u_star, p_half, dts, plain)
            iters = iters + it_half
        else:
            u_star = self._predict_2d(u, dts[0], plain)
            u_new, p, iters, res = self._project(u_star, p_start, dts, plain)
        div = stencils.divergence(g, u_new) * self.op.fluid
        dt = dts[0]
        return (self._next_state(state, u_new, p), StepDiagnostics(
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
        if n_steps == 0:
            return state, self.empty_diagnostics()
        diags = []
        for state, d in self._steps(state, n_steps):
            diags.append(d)
        return state, StepDiagnostics(
            *(torch.stack(field) for field in zip(*diags))
        )

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
        return (state,
                StepDiagnostics(*(torch.stack(f) for f in zip(*diags))),
                torch.stack(sfs), torch.stack(moms))

    def empty_diagnostics(self) -> StepDiagnostics:
        """The diagnostics of a 0-step run: five empty tensors on the
        device, as JAX's length-0 ``lax.scan`` stacks them (the iteration
        count int32, the rest in the grid's dtype)."""
        return StepDiagnostics(
            torch.empty(0, dtype=torch.int32, device=self.device),
            *(torch.empty(0, dtype=self.grid.dtype, device=self.device)
              for _ in range(4)))


def _kernels(ndim: int):
    """(applicable, predictor_rhs, correct_diag) of the fused step in
    ``ndim`` dimensions."""
    if ndim == 3:
        return (fused3d.fused_step3d_applicable, fused3d.predictor_rhs_3d,
                fused3d.correct_diag_3d)
    return (fused2d.fused_step2d_applicable, fused2d.predictor_rhs_2d,
            fused2d.correct_diag_2d)


def _static_forcing(forcing, grid: GridSpec):
    """``forcing`` as JAX's ``Simulation._static_forcing`` reads it: a
    Python float (from a number or a 0-d array) or None a component, or
    None without a force. Array and callable forcing, and a force in 3D,
    raise (kernel 1's static force and forcing volumes are not ported)."""
    if forcing is None:
        return None
    if len(forcing) != grid.ndim:
        raise ValueError(f"forcing {forcing!r} has wrong rank for "
                         f"ndim={grid.ndim}")
    vals = []
    for f in forcing:
        if f is None:
            vals.append(None)
        elif isinstance(f, (int, float)) or (isinstance(f, np.ndarray)
                                             and f.ndim == 0):
            vals.append(float(f))
        else:
            raise NotImplementedError(
                "array or time-dependent forcing: not ported yet (ROADMAP "
                "Queue A, 'Physics extensions')"
            )
    if grid.ndim != 2:
        raise NotImplementedError(
            "a body force in 3D (kernel 1's static force): not ported yet "
            "(ROADMAP Queue A, 'Physics extensions')"
        )
    return tuple(vals)

