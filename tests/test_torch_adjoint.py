"""PyTorch port vs JAX package: gradients through run_scan (adjoint.py).

Both packages run on the CPU in this process at float32: JAX takes
``jax.grad`` through its own ``adjoint.differentiable(sim).run_scan``, the
port ``backward()`` through its ``adjoint.differentiable(sim).run_scan``
(its step Function's forward the kernels' plain versions here, its
backward the plain step with the IFT solve). The loss is sum_a ||u_a||^2
after the run; the input a seeded perturbation of the start velocity
(``numpy.random.default_rng``), passed through the BC pass, so that the
start keeps the fused routes' invariant that boundary faces carry their
BC values. Gradients agree within 1e-4 max|g_JAX| (the IFT gradient is
exact to O(solver tol)); the f64 finite-difference checks of the method
are JAX's own (tests/test_adjoint.py). Cases whose many solves would be
many collected tests run in one loop that names every failing case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import adjoint as jadj
from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu_torch import adjoint, convert
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.parallel import make_mesh, sharded_simulation

CPU = torch.device("cpu")
GRAD_RTOL = 1e-4      # of max|g_JAX|
AMP = 0.05            # the start perturbation's amplitude


def _each_case(cases, check) -> None:
    """``check(*case)`` for every case, then one assertion naming every
    case that failed."""
    failed = []
    for case in cases:
        try:
            check(*case)
        except AssertionError as e:
            failed.append(f"{case}: {str(e).splitlines()[0]}")
    assert not failed, "\n".join(failed)


def _sims(name, kw, les):
    """Both packages' simulations of case ``name`` (with ``les``: the
    Smagorinsky closure at that cs set on each)."""
    jsim = jax_make_case(name, **kw).sim
    tsim = make_case(name, device=CPU, **kw).sim
    if les is not None:
        from navierstokessolver_tpu.les import LESConfig as JaxLES
        from navierstokessolver_tpu_torch.les import LESConfig

        jsim = dataclasses.replace(jsim, les=JaxLES(cs=les))
        tsim = dataclasses.replace(tsim, les=LESConfig(cs=les))
    return jsim, tsim


def _grad_gap(name, n, kw, impulsive=False, amp=AMP, les=None):
    """(max|g_port - g_JAX|, max|g_JAX|) of d loss / d du through ``n``
    steps of the differentiable run of case ``name`` (``impulsive``: from
    the cylinder's impulsive start, else from its initial state)."""
    jsim, tsim = _sims(name, kw, les)
    if impulsive:
        jst, tst = jax_impulsive_start(jsim), impulsive_start_state(tsim)
    else:
        jst, tst = jsim.initial_state(), tsim.initial_state()
    rng = np.random.default_rng(0)
    du = [(amp * rng.standard_normal(np.shape(c))).astype(np.float32)
          for c in jst.u]
    jdiff = jadj.differentiable(jsim)

    def jloss(d):
        u = jbcs.apply_velocity_bcs(jsim.grid, jsim.bcs, tuple(
            a + b for a, b in zip(jst.u, d)), jsim.face_masks)
        st, _ = jdiff.run_scan(dataclasses.replace(jst, u=u), n)
        return sum(jnp.sum(c ** 2) for c in st.u)

    gj = jax.grad(jloss)(tuple(jnp.asarray(x) for x in du))
    tdiff = adjoint.differentiable(tsim)
    leaves = [torch.tensor(x, requires_grad=True) for x in du]
    u = tbcs.apply_velocity_bcs(tsim.grid, tsim.bcs, tuple(
        a + b for a, b in zip(tst.u, leaves)), tsim.face_masks)
    st, _ = tdiff.run_scan(dataclasses.replace(tst, u=u), n)
    sum((c ** 2).sum() for c in st.u).backward()
    gt = convert.grads_to_numpy(leaves)
    assert all(np.isfinite(g).all() for g in gt), "non-finite gradient"
    gap = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(gj, gt))
    return gap, max(float(np.abs(np.asarray(a)).max()) for a in gj)


def _check_grad(name, n, kw, impulsive=False, amp=AMP, les=None):
    gap, scale = _grad_gap(name, n, kw, impulsive, amp, les)
    assert scale > 0.0, "zero gradient"
    assert gap <= GRAD_RTOL * scale, (
        f"gradient gap {gap:.3g} > {GRAD_RTOL} * max|g_JAX| {scale:.3g}")


def test_diff_forward_unchanged():
    """The differentiable run's forward is the kernel step's: bit for bit
    in u, p and every diagnostic, ``poisson_iters`` equal (the cavity 16^2
    with cg, 5 steps; the sphere 24x16x16 with dctcg)."""
    for name, kw in (("cavity", dict(shape=(16, 16), poisson_method="cg",
                                     poisson_tol=1e-6, poisson_iters=5000)),
                     ("sphere", dict(shape=(24, 16, 16)))):
        case = make_case(name, device=CPU, **kw)
        diff = adjoint.differentiable(case.sim)
        assert diff.diff_solve and not adjoint.base_of(diff).diff_solve
        assert adjoint.differentiable(diff) is diff
        st_b, d_b = case.sim.run_scan(case.initial_state(), 5)
        st_d, d_d = diff.run_scan(case.initial_state(), 5)
        for a, b in zip((*st_b.u, st_b.p), (*st_d.u, st_d.p)):
            assert torch.equal(a, b), name
        for a, b in zip(d_b, d_d):
            assert torch.equal(a, b), name
        assert int(d_d.poisson_iters.sum()) > 0


def test_vjp_is_symmetric_solve():
    """The VJP of ``implicit_solve`` with respect to the RHS is the same
    solve of the cotangent from a zero guess, for cg, fft, jacobi, mg,
    mgcg and dctcg, and the solve is symmetric, the premise of the IFT
    product (S^T = S): <g, S r> = <S g, r> within 1e-4 of |g| |S r|
    (each solve to its tol)."""
    rng = np.random.default_rng(0)
    rhs = torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))
    g = torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))
    zero = torch.zeros(16, 16)

    def check(method):
        base = adjoint.base_of(adjoint.differentiable(make_case(
            "cavity", shape=(16, 16), poisson_method=method,
            poisson_tol=1e-6, poisson_iters=5000, device=CPU).sim))
        b = rhs.clone().requires_grad_(True)
        p, _, _ = adjoint.implicit_solve(base, b, zero)
        (cot,) = torch.autograd.grad(p, b, g)
        lam, _, _ = base._solve_pressure(g, zero)
        assert torch.equal(cot, lam), "VJP is not the solve of g"
        sr = p.detach().double()
        lhs, rhs_ = float((g.double() * sr).sum()), float(
            (lam.double() * rhs.double()).sum())
        bound = 1e-4 * float(g.double().norm() * sr.norm())
        assert abs(lhs - rhs_) <= bound, f"<g,Sr> {lhs} <Sg,r> {rhs_}"

    _each_case([(m,) for m in ("cg", "fft", "jacobi", "mg", "mgcg",
                               "dctcg")], check)


def test_grad_parity_2d():
    """d loss / d u0 against JAX's through 4 steps of the cavity 16^2 (cg
    and fft at a fixed dt and at cfl 0.4, jacobi and mg at cfl 0.4: the
    fused 2D route, the CFL reduction carried), and 2 steps of the IBM
    cylinder 128x64 from its impulsive start (dctcg; the unfused 2D route,
    kernel 8's plain version; a perturbation of 0.01) and of the
    pulsatile channel 8x16 (the time-dependent drive)."""
    it = dict(poisson_tol=1e-6, poisson_iters=5000)
    cases = [("cavity", 4, dict(shape=(16, 16), poisson_method=m, **it,
                                **cfl))
             for m, cfl in (("cg", {}), ("cg", dict(cfl=0.4)), ("fft", {}),
                            ("fft", dict(cfl=0.4)),
                            ("jacobi", dict(cfl=0.4)),
                            ("mg", dict(cfl=0.4)))]
    cases += [("pulsatile_channel", 2, dict(shape=(8, 16))),
              ("cylinder", 2, dict(shape=(128, 64), ibm=True), True, 0.01)]
    _each_case(cases, _check_grad)


def test_grad_parity_3d():
    """d loss / d u0 against JAX's through 2 steps of JAX's four fused
    cases: cavity3d 12^3 with fft under Euler and rk2, the sphere 24x16x16
    (dctcg, the masked mode), heated_cavity 16^3 at Ra 1e4 (the thermal
    modes); and of the LES cavity 12^3 (cs 0.17) and the oscillating lid
    8^3 (the time-dependent drive)."""
    _each_case([
        ("cavity3d", 2, dict(shape=(12, 12, 12), poisson_method="fft")),
        ("cavity3d", 2, dict(shape=(12, 12, 12), poisson_method="fft",
                             integrator="rk2")),
        ("sphere", 2, dict(shape=(24, 16, 16))),
        ("heated_cavity", 2, dict(shape=(16, 16, 16), ra=1e4)),
        ("cavity3d", 2, dict(shape=(12, 12, 12), re=500.0,
                             poisson_method="fft"), False, AMP, 0.17),
        ("oscillating_lid", 2, dict(shape=(8, 8, 8))),
    ], _check_grad)


def test_grad_forcing_field_and_lid_value():
    """d loss / d f for a forcing field f of component 0 (JAX's case: the
    cavity 12^2 with cg, ``forcing=(f0, None)``, 4 steps, f0 seeded), and
    d loss / d lid for the lid velocity as a 0-d tensor at 0.5 (5 steps),
    each against JAX's ``jax.grad`` within 1e-4 of its max."""
    kw = dict(shape=(12, 12), poisson_method="cg", poisson_tol=1e-6,
              poisson_iters=5000)
    jc = jax_make_case("cavity", **kw)
    tc = make_case("cavity", device=CPU, **kw)
    jdiff, tdiff = jadj.differentiable(jc.sim), adjoint.differentiable(tc.sim)
    f0 = (0.5 * np.random.default_rng(0).standard_normal((11, 12))).astype(
        np.float32)

    def jloss_f(f):
        st, _ = dataclasses.replace(jdiff, forcing=(f, None)).run_scan(
            jc.initial_state(), 4)
        return jnp.sum(st.u[0] ** 2) + 0.5 * jnp.sum(st.u[1] ** 2)

    gj = np.asarray(jax.grad(jloss_f)(jnp.asarray(f0)))
    forcing = convert.forcing_from_numpy(tc.sim.grid, (False, False),
                                         (f0, None), requires_grad=True)
    st, _ = dataclasses.replace(tdiff, forcing=forcing).run_scan(
        tc.initial_state(), 4)
    (st.u[0].pow(2).sum() + 0.5 * st.u[1].pow(2).sum()).backward()
    (gt, _) = convert.grads_to_numpy([forcing[0], torch.zeros(1)])
    scale = float(np.abs(gj).max())
    assert scale > 0.0
    assert float(np.abs(gj - gt).max()) <= GRAD_RTOL * scale

    def lid_sim(diff, spec, lid):
        b = dict(diff.bcs)
        b[(1, 1)] = spec.wall((lid, 0.0))
        return dataclasses.replace(diff, bcs=b)

    def jrun(lid):
        s = lid_sim(jdiff, jbcs.BCSpec, lid)
        return s.run_scan(s.initial_state(), 5)[0].u[0]

    def trun(lid):
        s = lid_sim(tdiff, tbcs.BCSpec, lid)
        return s.run_scan(s.initial_state(), 5)[0].u[0]

    jt, tt = jrun(jnp.float32(1.0)), trun(torch.tensor(1.0))
    gj = float(jax.grad(lambda v: jnp.mean((jrun(v) - jt) ** 2) * 1e3)(
        jnp.float32(0.5)))
    lid = torch.tensor(0.5, requires_grad=True)
    (((trun(lid) - tt) ** 2).mean() * 1e3).backward()
    assert abs(float(lid.grad) - gj) <= GRAD_RTOL * abs(gj), (
        float(lid.grad), gj)


def test_lid_velocity_recovery_converges():
    """JAX's inverse-design check in the port: recover the lid velocity
    that made a target field by secant iterations on d loss / d lid
    through the differentiable run (the lid a 0-d tensor BC value):
    |lid - 1| < 1e-2 and the final loss below 1e-3 of the first."""
    case = make_case("cavity", shape=(12, 12), poisson_method="cg",
                     poisson_tol=1e-6, poisson_iters=5000, device=CPU)
    sim0 = adjoint.differentiable(case.sim)

    def run_u(lid, n=5):
        b = dict(sim0.bcs)
        b[(1, 1)] = tbcs.BCSpec.wall((lid, 0.0))
        sim = dataclasses.replace(sim0, bcs=b)
        st, _ = sim.run_scan(sim.initial_state(), n)
        return st.u[0]

    target = run_u(torch.tensor(1.0)).detach()

    def val_grad(lid):
        lid = torch.tensor(float(lid), requires_grad=True)
        v = ((run_u(lid) - target) ** 2).mean() * 1e3
        v.backward()
        return float(v.detach()), float(lid.grad)

    lid0, lid1 = 0.4, 0.6
    v0, g0 = val_grad(lid0)
    v1, g1 = val_grad(lid1)
    first_loss = v0
    for _ in range(6):
        if abs(lid1 - lid0) < 1e-6 or abs(g1) < 1e-6:
            break
        slope = (g1 - g0) / (lid1 - lid0)
        lid0, g0 = lid1, g1
        lid1 = lid1 - g1 / slope
        v1, g1 = val_grad(lid1)
    assert abs(lid1 - 1.0) < 1e-2, lid1
    assert v1 < 1e-3 * first_loss, (v1, first_loss)


def test_adjoint_exported_and_raises():
    """``adjoint`` is a top-level export; a sharded differentiable
    simulation raises 'The adjoint on the slab tier', and a gradient into
    a callable's closure raises rather than being lost."""
    import navierstokessolver_tpu_torch as port

    assert port.adjoint is adjoint and "adjoint" in port.__all__
    c = make_case("cavity3d", shape=(32, 16, 16), device=CPU)
    sp = sharded_simulation(c.sim, make_mesh(4, devices=[CPU] * 4))
    with pytest.raises(NotImplementedError, match="The adjoint on the slab"):
        adjoint.differentiable(sp)
    with pytest.raises(NotImplementedError, match="The adjoint on the slab"):
        dataclasses.replace(adjoint.differentiable(c.sim), mesh=sp.mesh)
    amp = torch.tensor(1.0, requires_grad=True)
    lid = make_case("oscillating_lid", shape=(8, 8, 8), device=CPU)
    b = dict(lid.sim.bcs)
    b[(2, 1)] = tbcs.BCSpec.wall((lambda t: amp * torch.cos(t), 0.0, 0.0))
    diff = dataclasses.replace(adjoint.differentiable(lid.sim), bcs=b)
    with pytest.raises(NotImplementedError, match="callable's parameters"):
        diff.run_scan(diff.initial_state(), 1)
