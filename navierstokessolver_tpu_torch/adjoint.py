"""Reverse-mode gradients through the step (implicit function theorem).

Counterpart of ``navierstokessolver_tpu/adjoint.py``. The iterative
pressure solves loop on the host, and an unrolled Krylov or V-cycle tape
grows with every iteration; the CUDA kernels are ctypes calls that
autograd cannot see. Both are handled as JAX handles them:

The solve. The converged pressure solves a linear system,

    p = S b,   S = D A^+ D,   D = M - (1/N) f f^T  (fluid mask + nullspace
                                                    deflation projector)

with ``A`` the masked Laplacian of ops/poisson.py, symmetric by
construction (mutual ``1/h_a^2`` couplings, solid rows decoupled identity
rows, outflow faces diagonal-only), and ``D`` a symmetric projector, so
``S^T = S``: the vector-Jacobian product of the solve is the same solve
applied to the cotangent, ``cot_b = S^T g = solve(g)`` from a zero guess
(:func:`implicit_solve`, a ``torch.autograd.Function``). It wraps the
simulation's solver dispatch, so every method differentiates (the direct
DCT solve, jacobi/gs/sor/cg, mg/mgcg, dctcg), and forward and backward
are both the production solve: kernel 3 in the fft refinement, kernels
9-11 in mg and mgcg, kernel 12 with ``fuse_trailing``. The tape holds no
iteration. The warm start ``p0`` changes how many iterations the solve
takes, not (to the solver's tolerance) its solution, so it gets no
gradient; that also cuts the ``p -> p_prev -> p_start`` extrapolation
recurrence. The gradient is exact to O(solver tol).

The step. The kernels have no backward, so a differentiable simulation
steps through a second ``Function`` (:func:`fused_step`): its forward is
the base simulation's own kernel step (``Simulation._step(..., plain=
False)``: on the card the kernels, bit for bit what ``run_scan`` gives,
on every unsharded route: the fused 2D and 3D routes, the unfused 2D
route, LES, the time-dependent drive), and it saves the step-entry
tensors only. Its backward recomputes the differentiable simulation's
plain step from them (``_step(..., plain=True)``, with the IFT solve
inside; the same math as the kernels to their tolerance) and takes its
vector-Jacobian product with respect to the state, the carried CFL
reduction and the simulation's differentiable tensors. This is not a
fallback: the plain step runs only inside ``backward``; no backward kernel
is written, as JAX writes none (its backward differentiates ``_step_jnp``).

What differentiates:

====================  =========  =======================================
input                 grad?      notes
====================  =========  =======================================
initial state         yes        u, theta, t as they enter; p and
                                 p_prev get none through the solve's
                                 start (p only as the next p_prev)
forcing arrays        yes        a component given as a tensor in the
                                 forcing layout (fused3d.force_shape)
BC values             yes        a WALL/INFLOW value given as a 0-d
                                 tensor (the lid velocity)
a callable's params   raises     a callable of t whose value requires
                                 grad (its closure is not an input)
cut-cell / IBM        forward    geometry gets no cotangent
geometry              only
slab-sharded step     raises     'The adjoint on the slab tier'
====================  =========  =======================================

    from navierstokessolver_tpu_torch import adjoint
    diff = adjoint.differentiable(case.sim)
    du = torch.zeros_like(st0.u[0], requires_grad=True)
    st, diag = diff.run_scan(dataclasses.replace(st0, u=(st0.u[0] + du,)
                                                 + st0.u[1:]), 4)
    sum((c ** 2).sum() for c in st.u).backward()    # du.grad

A non-differentiable simulation on the card whose inputs require grad
raises (the kernels would cut the graph) and names this module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import bcs as bcs_mod
from .grid import State
from .solver import StepDiagnostics

_STATE_FIELDS = ("p", "theta", "p_prev", "t")


def differentiable(sim):
    """A copy of ``sim`` whose step and pressure solves are
    reverse-differentiable: ``loss.backward()`` (or
    ``torch.autograd.grad``) then flows through ``step`` and ``run_scan``
    to the initial state, forcing arrays and BC values given as tensors.
    The forward keeps the kernels (:func:`fused_step`). A sharded
    simulation raises NotImplementedError."""
    if sim.diff_solve:
        return sim
    return dataclasses.replace(sim, diff_solve=True)


def base_of(sim):
    """The cached ``diff_solve=False`` replica of ``sim`` that runs the
    forward pass: the kernels' buffers (``bc``, the ghost table, the
    forcing volumes) rebuilt from the detached values of ``sim``'s own
    table and force, so a ``dataclasses.replace(diff, bcs=..., forcing=...)``
    steps with its own values."""
    base = sim.__dict__.get("_adjoint_base")
    if base is None:
        base = dataclasses.replace(sim, diff_solve=False)
        base._set_buffers(base.fused)
        sim.__dict__["_adjoint_base"] = base
    return base


# -- the solve ------------------------------------------------------------------


def implicit_solve(base, rhs: torch.Tensor, p0: torch.Tensor):
    """``base._solve_pressure(rhs, p0)`` with the IFT vector-Jacobian
    product: ``(p, iters, res)``, the rhs's cotangent the same solve of
    p's from a zero guess; ``p0``, ``iters`` and ``res`` carry none.
    ``base`` must be non-differentiable (:func:`base_of`)."""
    if base.diff_solve:
        raise ValueError("implicit_solve needs the non-differentiable base "
                         "Simulation (adjoint.base_of)")
    return _IFTSolve.apply(base, rhs, p0)


class _IFTSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, base, rhs, p0):
        ctx.set_materialize_grads(False)
        ctx.base = base
        p, iters, res = base._solve_pressure(rhs, p0)
        ctx.mark_non_differentiable(iters, res)
        return p, iters, res

    @staticmethod
    def backward(ctx, gp, _gi, _gr):
        if gp is None:
            return None, None, None
        # lam = S g = S^T g: the solver masks the RHS to fluid cells and
        # deflates the constant nullspace itself (the D projector)
        gp = gp.contiguous()
        lam, _, _ = ctx.base._solve_pressure(gp, torch.zeros_like(gp))
        return None, lam, None


# -- the step -------------------------------------------------------------------


def fused_step(sim, state: State, vel: Optional[torch.Tensor]):
    """One step of the differentiable ``sim`` from ``state`` and the
    carried CFL reduction ``vel`` (None where the route recomputes it):
    ``(state, diagnostics, max_vel)`` as ``Simulation._step`` returns
    them, the base's kernel step forward and the plain step's
    vector-Jacobian product backward. ``Simulation.step`` and ``run_scan``
    call it for a differentiable simulation."""
    base = base_of(sim)
    _check_callables(sim, state)
    params = _diff_params(sim)
    leaves = [*state.u] + [getattr(state, f) for f in _STATE_FIELDS]
    spec = _Spec(len(state.u), len(leaves))
    out = _Step.apply(sim, base, spec, vel, *leaves, *params)
    nd = len(state.u)
    u = tuple(out[:nd])
    new = State(u, *out[nd:nd + 4])
    diag = StepDiagnostics(*out[nd + 4:nd + 9])
    return new, diag, out[nd + 9]


@dataclasses.dataclass
class _Spec:
    """The layout of ``_Step``'s tensor inputs: ``ndim`` velocity
    components, then the rest of the ``n_state`` state fields, then the
    simulation's differentiable tensors."""
    ndim: int
    n_state: int


def _diff_params(sim) -> list[torch.Tensor]:
    """The simulation's floating tensors a gradient can reach: its force's
    tensor components and its table's tensor values, in a fixed order
    (:func:`_rebound` puts them back)."""
    out = []
    for f in sim.forcing or ():
        if isinstance(f, torch.Tensor):
            out.append(f)
    for face in sorted(sim.bcs):
        for v in sim.bcs[face].velocity:
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                out.append(v)
    return out


def _rebound(sim, params: list[torch.Tensor]):
    """``sim`` with the tensors of :func:`_diff_params` replaced by
    ``params``, sharing its base (the forward's buffers)."""
    it = iter(params)
    forcing = None if sim.forcing is None else tuple(
        next(it) if isinstance(f, torch.Tensor) else f for f in sim.forcing)
    bcs = {}
    for face in sorted(sim.bcs):
        spec = sim.bcs[face]
        bcs[face] = dataclasses.replace(spec, velocity=tuple(
            next(it) if isinstance(v, torch.Tensor) and v.is_floating_point()
            else v for v in spec.velocity))
    new = dataclasses.replace(sim, bcs=bcs, forcing=forcing)
    new.__dict__["_adjoint_base"] = base_of(sim)
    return new


def _check_callables(sim, state: State) -> None:
    """Raise where a callable of t returns a value that requires grad: its
    parameters live in its closure, which the step's Function cannot take
    as an input, so their gradient would be lost."""
    if not sim.time_dependent or state.t is None or not (
            torch.is_grad_enabled()):
        return
    b = bcs_mod.resolve_bcs(sim.bcs, state.t.detach())
    vals = [v for spec in b.values() for v in spec.velocity]
    vals += [f(state.t.detach()) for f in sim.forcing or () if callable(f)]
    if any(isinstance(v, torch.Tensor) and v.requires_grad for v in vals):
        raise NotImplementedError(
            "a gradient into the parameters of a callable of t (they are not "
            "inputs of the step's Function): not ported yet (ROADMAP Queue "
            "A, 'The adjoint of a callable's parameters')"
        )


class _Step(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sim, base, spec, vel, *tensors):
        ctx.set_materialize_grads(False)
        ctx.sim, ctx.spec = sim, spec
        state = _state(spec, tensors)
        new, diag, max_vel = base._step(state, vel, plain=False)
        ctx.save_for_backward(vel, *tensors)
        ctx.mark_non_differentiable(diag.poisson_iters, diag.poisson_res)
        return (*new.u, new.p, new.theta, new.p_prev, new.t, *diag, max_vel)

    @staticmethod
    def backward(ctx, *grads):
        vel, *tensors = ctx.saved_tensors
        spec = ctx.spec
        with torch.enable_grad():
            # the inputs after (sim, base, spec): vel, then the tensors
            ins = [None if x is None else x.detach().requires_grad_(need)
                   for x, need in zip((vel, *tensors),
                                      ctx.needs_input_grad[3:])]
            vel_in, state_in = ins[0], ins[1:1 + spec.n_state]
            params = ins[1 + spec.n_state:]
            sim = _rebound(ctx.sim, params) if params else ctx.sim
            new, diag, max_vel = sim._step(_state(spec, state_in), vel_in,
                                           plain=True)
            outs = (*new.u, new.p, new.theta, new.p_prev, new.t, *diag,
                    max_vel)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if o is not None and g is not None and o.requires_grad]
            wrt = [x for x in ins if x is not None and x.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs and wrt else ())
        cots = [next(got, None) if x is not None and x.requires_grad
                else None for x in ins]
        return (None, None, None, *cots)


def _state(spec: _Spec, tensors) -> State:
    nd = spec.ndim
    return State(tuple(tensors[:nd]), *tensors[nd:spec.n_state])
