"""PyTorch port vs JAX package: periodic axes in 3D and the Taylor-Green
vortex.

The periodic stencils, the BC pass, the tangential ghosts, the corrector
and the Poisson operator run on a ragged 3D table with periodic axes 0 and
2 and walls (one moving) on axis 1, from the same numpy-seeded fields in
both packages; the fused 3D wrappers run their plain versions on CPU
tensors. Tolerances are those of the JAX package's interpret-parity tests
(tests/test_fused_step.py): u* and the corrected velocity rtol=atol=1e-5,
RHS rtol 1e-4 with atol 3e-7 max|RHS|, the residual 1e-6 of max|r|; the
ghost padding and the BC pass move values and must be bit-equal. The
Taylor-Green steps hold the port to the JAX jnp step with
tests/test_fused_step.py's whole-step tolerances (u rtol 2e-5/atol 2e-6,
p rtol 2e-4/atol 2e-5, max_div and max_cfl rtol 1e-3). Each JAX reference
is one jitted program.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.ops import fused3d
from navierstokessolver_tpu_torch.ops import poisson as tpois
from navierstokessolver_tpu_torch.solver import SimParams, Simulation

SHAPE, LENGTHS = (12, 10, 16), (1.2, 1.0, 1.6)
WALL = (0.7, 0.0, 0.2)
DT, NU, RHO = 1e-3, 0.02, 1.3


def _tables():
    jg, tg = jgrid.GridSpec(SHAPE, LENGTHS), tgrid.GridSpec(SHAPE, LENGTHS)
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[(1, 1)], tb[(1, 1)] = jbcs.BCSpec.wall(WALL), tbcs.BCSpec.wall(WALL)
    for a in (0, 2):
        for s in (0, 1):
            jb[(a, s)], tb[(a, s)] = jbcs.BCSpec.periodic(), tbcs.BCSpec.periodic()
    return jg, tg, jb, tb


def _fields(jg, seed):
    rng = np.random.default_rng(seed)
    u = [rng.normal(size=jg.face_shape(a)).astype(np.float32)
         for a in range(3)]
    p = rng.normal(size=jg.shape).astype(np.float32)
    b = rng.normal(size=jg.shape).astype(np.float32)
    return u, p, b


def _close(got, ref, rtol, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("gamma", [0.0, 0.7])
def test_periodic_stencils_match_jax(gamma):
    jg, tg, jb, tb = _tables()
    tbcs.validate_bcs(tg, tb)
    per = jbcs.periodic_axes(jg, jb)
    assert tbcs.periodic_axes(tg, tb) == per == (True, False, True)
    u, p, b = _fields(jg, seed=int(gamma * 10))

    @jax.jit
    def jax_ref(u, p, b):
        ub = jbcs.apply_velocity_bcs(jg, jb, u)
        pads = [jbcs.pad_transverse(jg, jb, a, ub[a]) for a in range(3)]
        star = jbcs.apply_velocity_bcs(
            jg, jb, jst.predictor(jg, jb, ub, jnp.float32(DT), NU, gamma))
        rhs = jst.divergence(jg, star) * (RHO / jnp.float32(DT))
        new = jst.correct_velocity(jg, star, p, DT / RHO, None, per)
        op = jpois.build_poisson_op(jg, jb)
        r = (b - jpois.apply_A(op, p)) * op.fluid
        return ub, pads, star, rhs, new, r

    j_ub, j_pads, j_star, j_rhs, j_new, j_r = jax_ref(u, p, b)
    t_ub = tbcs.apply_velocity_bcs(tg, tb, [torch.from_numpy(c) for c in u])
    for a in range(3):
        np.testing.assert_array_equal(t_ub[a].numpy(), np.asarray(j_ub[a]))
        np.testing.assert_array_equal(
            tbcs.pad_transverse(tg, tb, a, t_ub[a]).numpy(),
            np.asarray(j_pads[a]))
    before = dict(fused3d.LAUNCHES)
    t_star, t_rhs = fused3d.predictor_rhs_3d(tg, tb, t_ub, DT, NU, gamma, RHO)
    for a in range(3):
        _close(t_star[a], j_star[a], 1e-5, 1e-5)
        # face n of a periodic axis repeats face 0
        if per[a]:
            n = SHAPE[a]
            assert torch.equal(t_star[a].select(a, n), t_star[a].select(a, 0))
    _close(t_rhs, j_rhs, 1e-4, 3e-7 * float(jnp.max(jnp.abs(j_rhs))))
    t_new, t_div, t_vel = fused3d.correct_diag_3d(
        tg, t_star, torch.from_numpy(p), DT / RHO, per)
    for a in range(3):
        _close(t_new[a], j_new[a], 1e-5, 1e-5)
    _close(t_div, jnp.max(jnp.abs(jst.divergence(jg, j_new))), 1e-4, 1e-5)
    _close(t_vel * DT, jst.max_cfl(jg, j_new, jnp.float32(DT)), 1e-4, 1e-6)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    assert top.periodic == per and top.singular
    t_r = fused3d.residual_3d(top, torch.from_numpy(p), torch.from_numpy(b))
    _close(t_r, j_r, 1e-5, 1e-6 * float(jnp.max(jnp.abs(j_r))))
    assert fused3d.LAUNCHES == before          # CPU: the plain versions
    assert fused3d.fused_step3d_applicable(tg, tb)


@pytest.mark.parametrize("fuse_trailing", [False, True],
                         ids=["chain", "fuse_trailing"])
def test_taylor_green3d_five_steps_match_jax(fuse_trailing):
    """Five steps of ``taylor_green3d`` 16^3 at Re 200 through both
    packages' ``make_case`` from the same state; the port with
    ``fuse_trailing`` runs the fused route's composition (the kernel's
    plain version on the CPU), JAX its chain."""
    kw = dict(shape=(16, 16, 16), re=200.0)
    jc = jax_make_case("taylor_green3d", **kw)
    tc = make_case("taylor_green3d", device="cpu", **kw)
    tsim = tc.sim
    if fuse_trailing:
        tsim = dataclasses.replace(tsim, dct_solver=dataclasses.replace(
            tsim.dct_solver, fuse_trailing=True))
        assert tsim.dct_solver._fused3d_route_ok()
    assert tsim.fused and tsim.params.dt == jc.sim.params.dt
    assert tsim.dct_solver.kinds == ("per",) * 3 and tsim.op.singular
    js, ts = jc.initial_state(), tc.initial_state()
    for a in range(3):
        np.testing.assert_array_equal(ts.u[a].numpy(), np.asarray(js.u[a]))
    js, jd = jc.sim.run_scan(js, 5)
    ts, td = tsim.run_scan(ts, 5)
    u, p = convert.state_to_numpy(ts)
    for a in range(3):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(td.max_div[-1]), float(jd.max_div[-1]),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(td.max_cfl[-1]), float(jd.max_cfl[-1]),
                               rtol=1e-3, atol=1e-8)
    assert float(td.max_div.max()) < 1e-5
    # the plain composition takes the chain and agrees with the step
    sp, dp = tc.sim.step_plain(ts)
    sk, dk = tsim.step(ts)
    for a in range(3):
        _close(sk.u[a], sp.u[a], 2e-5, 2e-6)


def test_periodic_probes():
    """What stays unported raises naming its ROADMAP item; malformed
    periodic tables raise as in JAX."""
    # 2D periodic axes build; a periodic table that the fused 2D kernels do
    # not take (with an INFLOW face) steps on the unfused route, kernel 8's
    # periodic lanes, as step_plain does
    g2 = tgrid.GridSpec((8, 8), (1.0, 1.0))
    b2 = tbcs.no_slip_box(g2)
    b2[(1, 0)] = b2[(1, 1)] = tbcs.BCSpec.periodic()
    b2[(0, 0)] = tbcs.BCSpec.inflow((1.0, 0.0))
    sim2 = Simulation.build(g2, b2, SimParams(dt=1e-3, nu=0.01), "cpu")
    assert not sim2.fused
    sp2, _ = sim2.step_plain(sim2.initial_state())
    sk2, _ = sim2.step(sim2.initial_state())
    for a in range(2):
        _close(sk2.u[a], sp2.u[a], 2e-5, 2e-6)
    # kolmogorov builds since the forcing slice (a forcing volume)
    assert make_case("kolmogorov", shape=(16, 16), device="cpu").sim.fused
    g3 = tgrid.GridSpec((8, 6, 4), (1.0, 1.0, 1.0))
    b3 = tbcs.no_slip_box(g3)
    b3[(0, 0)] = tbcs.BCSpec.periodic()
    with pytest.raises(ValueError, match="both faces"):
        tbcs.validate_bcs(g3, b3)
    assert not fused3d.fused_step3d_applicable(g3, b3)
    odd = tgrid.GridSpec((7, 6, 4), (1.0, 1.0, 1.0))
    b_odd = tbcs.no_slip_box(odd)
    b_odd[(0, 0)] = b_odd[(0, 1)] = tbcs.BCSpec.periodic()
    with pytest.raises(ValueError, match="even"):
        tbcs.validate_bcs(odd, b_odd)
    # LES on the periodic box runs since the LES slice (kernels 6-7's
    # periodic mode), held to JAX's jnp LES step here (3 steps; Euler, rk2
    # and cfl and the dynamic model in tests/test_torch_les_bcs.py)
    from navierstokessolver_tpu import les as jles

    tc = make_case("taylor_green3d", shape=(8, 8, 8), device="cpu")
    sim = tc.sim
    les_sim = dataclasses.replace(sim, les=tles.LESConfig(cs=0.17))
    jc = jax_make_case("taylor_green3d", shape=(8, 8, 8))
    jsim = dataclasses.replace(jc.sim, les=jles.LESConfig(cs=0.17))
    js, jd = jsim.run_scan(jc.initial_state(), 3)
    ts, td = les_sim.run_scan(tc.initial_state(), 3)
    for a in range(3):
        np.testing.assert_allclose(ts.u[a].numpy(), np.asarray(js.u[a]),
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6)
    # a periodic axis of 1024 or more takes the split circulant plan
    big = Simulation.build(tgrid.GridSpec((1024, 4, 4), (1.0, 1.0, 1.0)),
                           {(a, s): tbcs.BCSpec.periodic() for a in range(3)
                            for s in (0, 1)}, sim.params, "cpu")
    assert [type(p).__name__ for p in big.dct_solver.plans] == [
        "CircSplitPlan", "SplitPlan", "SplitPlan"]
