"""Chorin projection time stepper: predictor -> Poisson -> corrector (PyTorch).

Counterpart of ``navierstokessolver_tpu/solver.py`` for the ported slice:
explicit Euler at a fixed dt, WALL boundaries, the direct spectral (DCT)
pressure solve. One 3D step is composed like the JAX fused 3D step
(``Simulation._step_fused3d_internal``, Euler branch):

    predictor + BCs + RHS      ops/fused3d.predictor_rhs_3d   (kernel)
    DCT solve, one refinement  ops/fft_poisson.solve_with_residual
                               (residual: ops/fused3d.residual_3d, kernel)
    corrector + diagnostics    ops/fused3d.correct_diag_3d    (kernel)

A 2D grid runs the same composition from the plain stencils, as the JAX
package's 2D default does; the 2D kernels are queued (ROADMAP Queue B).
:meth:`Simulation.step_plain` is that plain composition in any dimension:
the reference the kernel step is held to on one device.

Like the JAX fused step, the 3D step relies on the state invariant that
boundary faces carry their BC values (``initial_state`` sets them, the
predictor rewrites them, the corrector keeps them), so no BC pass runs at
step entry.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import bcs as bcs_mod
from .bcs import BCTable
from .grid import GridSpec, State, zero_state
from .ops import fft_poisson, fused3d
from .ops import poisson as poisson_mod
from .ops.poisson import PoissonConfig, PoissonOp


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static physical/numerical parameters of a run. Only ``integrator=
    "euler"`` and ``cfl=None`` (fixed dt) are ported."""

    dt: float
    nu: float
    rho: float = 1.0
    upwind_gamma: float = 0.0
    poisson: PoissonConfig = dataclasses.field(default_factory=PoissonConfig)
    integrator: str = "euler"
    cfl: Optional[float] = None

    def __post_init__(self):
        if self.integrator != "euler":
            raise NotImplementedError(
                f"integrator {self.integrator!r}: not ported yet (ROADMAP "
                "Queue A, 'RK2, CFL-adaptive dt and float64')"
            )
        if self.cfl is not None:
            raise NotImplementedError(
                "CFL-adaptive dt: not ported yet (ROADMAP Queue A, "
                "'RK2, CFL-adaptive dt and float64')"
            )


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
    dct_solver: fft_poisson.DCTPoissonSolver
    device: torch.device
    # wall values as the fused kernels read them (3D only)
    bc: Optional[torch.Tensor] = None

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
    ) -> "Simulation":
        """Static operators on ``device`` (no default: the caller names it).
        ``solid``, ``forcing``, ``scalar``, ``les`` and ``sdf`` are the JAX
        build's options for obstacles and the physics extensions; they are
        not ported yet and raise."""
        if not fft_poisson.is_applicable(grid, bcs, solid) or sdf is not None:
            raise NotImplementedError(
                "obstacles: not ported yet (ROADMAP Queue A, 'Other BC kinds')"
            )
        if forcing is not None or scalar is not None or les is not None:
            raise NotImplementedError(
                "forcing, scalar transport and LES: not ported yet (ROADMAP "
                "Queue A, 'Physics extensions')"
            )
        device = torch.device(device)
        bcs_mod.validate_bcs(grid, bcs)
        op = poisson_mod.build_poisson_op(grid, bcs, device)
        dct_solver = fft_poisson.DCTPoissonSolver.build(
            grid, device, kinds=fft_poisson.axis_kinds_from_bcs(grid, bcs)
        )
        bc = (fused3d.bc_table(grid, bcs, device)
              if fused3d.fused_step3d_applicable(grid, bcs) else None)
        return Simulation(grid=grid, bcs=bcs, params=params, op=op,
                          dct_solver=dct_solver, device=device, bc=bc)

    def initial_state(self) -> State:
        st = zero_state(self.grid, self.device)
        u = bcs_mod.apply_velocity_bcs(self.grid, self.bcs, st.u)
        return State(u=u, p=st.p)

    def _dt_tensor(self) -> torch.Tensor:
        return torch.full((), self.params.dt, dtype=self.grid.dtype,
                          device=self.device)

    def step(self, state: State) -> tuple[State, StepDiagnostics]:
        """One projection step: the fused kernels in 3D, the plain
        composition in 2D."""
        if self.grid.ndim != 3:
            return self.step_plain(state)
        g, pr = self.grid, self.params
        dt = pr.dt
        u_star, rhs = fused3d.predictor_rhs_3d(
            g, self.bcs, state.u, dt, pr.nu, pr.upwind_gamma, pr.rho,
            bc=self.bc,
        )
        p, iters, res = fft_poisson.solve_with_residual(
            self.dct_solver, self.op, rhs,
            diag_residual=pr.poisson.diag_residual,
        )
        u_new, max_div, max_vel = fused3d.correct_diag_3d(
            g, u_star, p, _scale(dt, pr.rho)
        )
        return State(u=u_new, p=p), self._diag(iters, res, max_div, max_vel)

    def step_plain(self, state: State) -> tuple[State, StepDiagnostics]:
        """The same step from the plain versions only (no kernel), in any
        dimension: the JAX package's jnp step for this slice."""
        g, pr = self.grid, self.params
        dt = pr.dt
        u = bcs_mod.apply_velocity_bcs(g, self.bcs, state.u)
        u_star, rhs = fused3d.predictor_rhs_plain(
            g, self.bcs, u, dt, pr.nu, pr.upwind_gamma, pr.rho
        )
        p, iters, res = fft_poisson.solve_with_residual(
            self.dct_solver, self.op, rhs,
            diag_residual=pr.poisson.diag_residual, use_kernel=False,
        )
        u_new, max_div, max_vel = fused3d.correct_diag_plain(
            g, u_star, p, _scale(dt, pr.rho)
        )
        return State(u=u_new, p=p), self._diag(iters, res, max_div, max_vel)

    def _diag(self, iters, res, max_div, max_vel) -> StepDiagnostics:
        dt = self._dt_tensor()
        return StepDiagnostics(
            poisson_iters=iters, poisson_res=res, max_div=max_div,
            max_cfl=max_vel * dt, dt=dt,
        )

    def run_scan(
        self, state: State, n_steps: int
    ) -> tuple[State, StepDiagnostics]:
        """Advance ``n_steps``; returns the final state and per-step
        diagnostics stacked on the device. Nothing inside the loop waits
        for the device."""
        diags = []
        for _ in range(n_steps):
            state, d = self.step(state)
            diags.append(d)
        if not diags:
            raise ValueError("run_scan needs n_steps >= 1")
        return state, StepDiagnostics(
            *(torch.stack(field) for field in zip(*diags))
        )


def _scale(dt: float, rho: float) -> float:
    """dt / rho in float32, as the JAX step computes it."""
    return float(np.float32(dt) / np.float32(rho))
