"""PyTorch port vs JAX package: the sphere and 3D open faces on the CPU.

The sphere (JAX's ``make_case("sphere")``: inflow, an axis-0 outflow, four
slip walls and a staircase obstacle) runs the fused 3D kernels' masked
mode in the port, whose plain versions run here; JAX's ``run_scan`` runs
its jnp step on the CPU. Both start from the same state. Tolerances are
those of the JAX package's own sphere test
(tests/test_fused_step.py::test_fused3d_sphere_obstacle_matches_reference):
u rtol 2e-5 / atol 2e-6, p rtol 2e-4 / atol 2e-5, max_div rtol 1e-3 /
atol 1e-6, max_cfl rtol 1e-3 / atol 1e-8; iteration counts within
``COUNT_SLACK``: the dctcg sphere's first step from rest stops on the
Richardson stagnation rule above tol (relative residuals 3.6e-5 in JAX and
4.3e-5 in the port at float32's floor), one sweep apart. The CFL runs
hold the dt series within rtol 3e-5 (tests/test_torch_integrators.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.ops.fft_poisson import DCTPCGSolver as JaxDCTPCG
from navierstokessolver_tpu.ops.poisson import (
    PoissonConfig as JaxPoisson, build_poisson_op as jax_build_op,
)
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import fused3d
from navierstokessolver_tpu_torch.ops.fft_poisson import DCTPCGSolver
from navierstokessolver_tpu_torch.ops.poisson import (
    PoissonConfig, build_poisson_op,
)

CPU = torch.device("cpu")
# JAX's own sphere test's configuration (mg) and the dctcg sphere of its
# cut-cell and sharded tests (32x16x16 over 16x8x8 diameters)
MG_SPHERE = dict(shape=(16, 16, 16), lengths=(8.0, 8.0, 8.0),
                 center=(2.0, 4.1, 3.9), diameter=1.6, poisson_method="mg")
DCTCG_SPHERE = dict(shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0))
# the largest difference in poisson_iters a step that float32 roundoff of
# the stopping tests explains (see the module docstring)
COUNT_SLACK = {"mg": 0, "dctcg": 1}


def _cases(kw):
    return (jax_make_case("sphere", **kw),
            make_case("sphere", device="cpu", **kw))


def _to_port(st):
    """A JAX state as the port's, on the CPU."""
    return convert.state_from_numpy(
        [np.asarray(c) for c in st.u], np.asarray(st.p), CPU,
        p_prev=None if st.p_prev is None else np.asarray(st.p_prev))


def _check_run(jr, tr, slack, n=None):
    """Final fields and per-step diagnostics of two run_scan results."""
    (js, jd), (ts, td) = jr, tr
    for a in range(3):
        np.testing.assert_allclose(ts.u[a].numpy(), np.asarray(js.u[a]),
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    diff = np.abs(td.poisson_iters.numpy().astype(int)
                  - np.asarray(jd.poisson_iters).astype(int))
    assert diff.max() <= slack, (td.poisson_iters, jd.poisson_iters)


def test_sphere_masks_and_codes_match_jax():
    """The builders bit for bit: the face and correction masks, the
    stencil code, and the masked kernels' derivation of both masks from
    the code (fused3d.masks_from_code), against JAX's masks and against
    the port's bcs.face_masks_from_solid / correction_face_masks; the
    3D capacitance's box W and its origin, C^-1 within float32 roundoff
    of its spectral solves."""
    jc, tc = _cases(DCTCG_SPHERE)
    js, ts = jc.sim, tc.sim
    assert ts.fused and ts.face_masks is not None and ts.ibm is None
    assert ts.params.dt == js.params.dt and ts.params.nu == js.params.nu
    np.testing.assert_array_equal(ts.op.code.numpy(), np.asarray(js.op.code))
    np.testing.assert_array_equal(ts.op.diag.numpy(), np.asarray(js.op.diag))
    opened, corr, fluid = fused3d.masks_from_code(ts.grid, ts.op.code)
    np.testing.assert_array_equal(fluid.numpy(), np.asarray(js.op.fluid))
    for a in range(3):
        for mine, port, jax_ in ((opened, ts.face_masks, js.face_masks),
                                 (corr, ts.corr_masks, js.corr_masks)):
            assert mine[a].dtype == port[a].dtype == torch.float32
            np.testing.assert_array_equal(mine[a].numpy(), port[a].numpy())
            np.testing.assert_array_equal(port[a].numpy(),
                                          np.asarray(jax_[a]))
    jd, td = js.dctcg_solver, ts.dctcg_solver
    assert td.cap_origin == jd.cap_origin and td.cap_vx is None
    np.testing.assert_array_equal(td.cap_wbox.numpy(), np.asarray(jd.cap_wbox))
    np.testing.assert_array_equal(td.cap_idx_a, jd.cap_idx_a)
    np.testing.assert_array_equal(td.cap_idx_b, jd.cap_idx_b)
    cinv = np.asarray(jd.cap_cinv)
    np.testing.assert_allclose(td.cap_cinv.numpy(), cinv, rtol=0,
                               atol=1e-5 * np.abs(cinv).max())


def test_sphere_mg_matches_jax():
    """JAX's sphere test's case (16^3, mg, the sphere's diameter 1.6 off
    the axis), 4 steps from the case's start, Euler and rk2."""
    for integrator in ("euler", "rk2"):
        jc, tc = _cases(dict(MG_SPHERE, integrator=integrator))
        assert tc.sim.fused and tc.sim.mg_solver is not None
        _check_run(jc.sim.run_scan(jc.initial_state(), 4),
                   tc.sim.run_scan(tc.initial_state(), 4), COUNT_SLACK["mg"])


def test_sphere_dctcg_matches_jax():
    """The dctcg sphere (32x16x16, the 3D capacitance solve) from the
    impulsive start, 5 steps, Euler at the case's dt and at cfl 0.4 under
    a cap of 10x it (the CFL dt binds)."""
    from navierstokessolver_tpu.cases.cylinder import (
        impulsive_start_state as jax_impulsive_start,
    )
    for mode in ("euler", "cfl"):
        kw = dict(DCTCG_SPHERE)
        if mode == "cfl":
            kw["cfl"] = 0.4
        jc, tc = _cases(kw)
        jsim, tsim = jc.sim, tc.sim
        if mode == "cfl":
            p = dataclasses.replace(jsim.params, dt=10 * jsim.params.dt)
            jsim = dataclasses.replace(jsim, params=p)
            tsim = dataclasses.replace(tsim, params=dataclasses.replace(
                tsim.params, dt=p.dt))
        js0 = jax_impulsive_start(jsim)
        ts0 = impulsive_start_state(tsim)
        for a in range(3):
            np.testing.assert_array_equal(ts0.u[a].numpy(),
                                          np.asarray(js0.u[a]))
        jr, tr = jsim.run_scan(js0, 5), tsim.run_scan(ts0, 5)
        if mode == "cfl":
            assert float(tr[1].dt[-1]) < 0.5 * p.dt    # the CFL dt binds
        _check_run(jr, tr, COUNT_SLACK["dctcg"])


def _open_box(integrator: str):
    """A 3D box of every open kind with no obstacle: an inflow with
    tangential components on (0, 0), outflows on (0, 1) and (1, 1), a slip
    wall on (1, 0), a wall and a moving wall on axis 2; fft; a seeded
    random BC-consistent start."""
    shape, lengths = (16, 12, 8), (2.0, 1.5, 1.0)
    faces = {(0, 0): ("inflow", (1.0, 0.1, -0.2)), (0, 1): ("outflow", ()),
             (1, 0): ("slip", ()), (1, 1): ("outflow", ()),
             (2, 0): ("wall", (0.0, 0.0, 0.0)),
             (2, 1): ("wall", (0.4, -0.3, 0.0))}

    def table(mod):
        return {f: (mod.BCSpec(mod.BCKind(k), v)) for f, (k, v) in faces.items()}

    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb, tb = table(jbcs), table(tbcs)
    kw = dict(dt=2e-3, nu=0.01, upwind_gamma=0.3, integrator=integrator)
    jsim = jsolver.Simulation.build(jg, jb, jsolver.SimParams(
        poisson=JaxPoisson(method="fft"), **kw))
    tsim = tsolver.Simulation.build(tg, tb, tsolver.SimParams(
        poisson=PoissonConfig(method="fft"), **kw), CPU)
    rng = np.random.default_rng(11)
    u = jbcs.apply_velocity_bcs(jg, jb, tuple(
        rng.normal(size=jg.face_shape(a)).astype(np.float32)
        for a in range(3)))
    st = jsolver.State(u=u, p=np.zeros(shape, np.float32))
    return jsim, tsim, st


def test_open_box_matches_jax():
    """INFLOW, OUTFLOW and SLIP faces in 3D without an obstacle: the fused
    kernels' unmasked instantiations with the faces' kinds from the bc
    buffer (ghost maps, OUTFLOW copies), 3 steps, Euler and rk2; the bc
    buffer's ghost maps as JAX's _tangential_ghost and _own_face_spec give
    them."""
    for integrator in ("euler", "rk2"):
        jsim, tsim, st = _open_box(integrator)
        assert tsim.fused and tsim.dct_solver is not None
        al = tsim.bc[fused3d.ALPHA_AT:].reshape(3, 2, 3).numpy()
        assert al[0, 0].tolist() == [0.0, -1.0, -1.0]     # inflow
        assert al[0, 1].tolist() == [1.0, 1.0, 1.0]       # outflow
        assert al[1, 0].tolist() == [1.0, 0.0, 1.0]       # slip
        assert al[2, 1].tolist() == [-1.0, -1.0, 0.0]     # wall
        assert fused3d.open_mask(tsim.grid, tsim.bcs) == (
            fused3d.OPEN_KINDS | (1 << 1) | (1 << 3))
        jr = jsim.run_scan(st, 3)
        tr = tsim.run_scan(_to_port(st), 3)
        _check_run(jr, tr, 0)
        # the outflow faces copy their inner face
        u = tr[0].u
        assert torch.equal(u[0][-1], u[0][-2])
        assert torch.equal(u[1][:, -1], u[1][:, -2])


def test_dctcg_3d_solve_matches_jax():
    """One DCTPCGSolver solve of the 3D capacitance path on a shared
    seeded RHS (the sphere's operator): p within the solve's tolerance of
    JAX's, the same Richardson sweep count, the residual reported alike;
    one preconditioner application against JAX's; the operator bit for
    bit through both packages' build_poisson_op, and no capacitance for a
    singular (all-wall) operator in either package."""
    jc, tc = _cases(DCTCG_SPHERE)
    jsolver_, tsolver_ = jc.sim.dctcg_solver, tc.sim.dctcg_solver
    rng = np.random.default_rng(3)
    b = rng.normal(size=DCTCG_SPHERE["shape"]).astype(np.float32)
    b *= np.asarray(jc.sim.op.fluid)
    p0 = np.zeros_like(b)
    jp, jit, jres = jsolver_.solve(b, p0, 1e-5, 50, jc.sim.op)
    tp, tit, tres = tsolver_.solve(torch.from_numpy(b), torch.zeros(b.shape),
                                   1e-5, 50, tc.sim.op)
    assert int(tit) == int(jit)
    assert float(tres) <= 1e-5 and float(jres) <= 1e-5
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0,
                               atol=1e-4 * np.abs(jp).max())
    # and one application of the preconditioner against JAX's
    fl = jc.sim.op.fluid
    jz = np.asarray(jsolver_._precond_apply(b, fl))
    tz = tsolver_._precond_apply(torch.from_numpy(b), tc.sim.op.fluid)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=0,
                               atol=1e-5 * np.abs(jz).max())
    solid = ~np.asarray(jc.sim.op.fluid, bool)
    jop = jax_build_op(jc.sim.grid, jc.sim.bcs, solid)
    top = build_poisson_op(tc.sim.grid, tc.sim.bcs, CPU, solid)
    np.testing.assert_array_equal(top.code.numpy(), np.asarray(jop.code))
    s = DCTPCGSolver.build(tc.sim.grid, tbcs.no_slip_box(tc.sim.grid), CPU,
                           solid)
    assert s.cap_cinv is None and s.cap_wbox is None   # singular: no C
    jw = JaxDCTPCG.build(jc.sim.grid, jbcs.no_slip_box(jc.sim.grid),
                         solid=solid)
    assert jw.cap_cinv is None


def test_sphere_state_converts():
    """A JAX sphere state (3 steps of the dctcg sphere, with p_prev of the
    extrapolated warm start) carried across by convert.state_from_numpy;
    the port's 2 further steps from it against JAX's, and a JAX dctcg
    solver's capacitance (dctcg_solver_from_numpy with the box) solving as
    the port's own."""
    jc, tc = _cases(DCTCG_SPHERE)
    from navierstokessolver_tpu.cases.cylinder import (
        impulsive_start_state as jax_impulsive_start,
    )
    js3, _ = jc.sim.run_scan(jax_impulsive_start(jc.sim), 3)
    assert js3.p_prev is not None
    ts3 = _to_port(js3)
    assert ts3.p_prev is not None
    _check_run(jc.sim.run_scan(js3, 2), tc.sim.run_scan(ts3, 2),
               COUNT_SLACK["dctcg"])
    jd = jc.sim.dctcg_solver
    cs = convert.dctcg_solver_from_numpy(
        tc.sim.dctcg_solver.dct, cap_cinv=np.asarray(jd.cap_cinv),
        cap_va=np.asarray(jd.cap_va), cap_vb=np.asarray(jd.cap_vb),
        cap_idx_a=jd.cap_idx_a, cap_idx_b=jd.cap_idx_b,
        cap_wbox=np.asarray(jd.cap_wbox), cap_origin=jd.cap_origin)
    b = torch.from_numpy(np.array(js3.p)) * tc.sim.op.fluid
    z = cs._precond_apply(b, tc.sim.op.fluid)
    z_own = tc.sim.dctcg_solver._precond_apply(b, tc.sim.op.fluid)
    np.testing.assert_allclose(z.numpy(), z_own.numpy(), rtol=0,
                               atol=1e-5 * float(z_own.abs().max()))


def test_sphere_options_raise():
    """What the port lacks raises NotImplementedError naming its ROADMAP
    item; JAX's ValueErrors stay ValueErrors."""
    kw = dict(DCTCG_SPHERE, device="cpu")
    for opts, title in ((dict(ibm=True), "Physics extensions"),
                        (dict(ibm=True, spin=0.5), "Physics extensions"),
                        (dict(ibm=True, sharp_pressure=True),
                         "Physics extensions"),
                        (dict(heated=True), "Physics extensions"),
                        (dict(outlet="convective"), "Other BC kinds")):
        with pytest.raises(NotImplementedError, match=title):
            make_case("sphere", **kw, **opts)
    with pytest.raises(ValueError, match="requires ibm"):
        make_case("sphere", spin=0.5, **kw)
    sim = make_case("sphere", **kw).sim
    g = sim.grid
    solid = ~fused3d.masks_from_code(g, sim.op.code)[2].bool().numpy()
    # an obstacle with a periodic axis, an OUTFLOW face at (0, 0)
    per = dict(sim.bcs)
    per[(2, 0)] = per[(2, 1)] = tbcs.BCSpec.periodic()
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsolver.Simulation.build(g, per, sim.params, "cpu", solid=solid)
    lo_out = dict(sim.bcs)
    lo_out[(0, 0)] = tbcs.BCSpec.outflow()
    lo_out[(0, 1)] = tbcs.BCSpec.inflow((-1.0, 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsolver.Simulation.build(g, lo_out, sim.params, "cpu", solid=solid)
    assert not fused3d.fused_step3d_applicable(g, lo_out)
    # open faces with a periodic axis (JAX's fused gate takes them, its
    # jnp step otherwise; the open mode is instantiated bounded only)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsolver.Simulation.build(g, per, sim.params, "cpu")
    assert fused3d.open_mask(g, tbcs.no_slip_box(g)) == 0
    # a forced sphere, LES with open faces, a sharded sphere
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        tsolver.Simulation.build(g, sim.bcs, sim.params, "cpu", solid=solid,
                                 forcing=(0.1, None, None))
    from navierstokessolver_tpu_torch.les import LESConfig
    open_sim = tsolver.Simulation.build(g, sim.bcs, sim.params, "cpu")
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        dataclasses.replace(open_sim, les=LESConfig(cs=0.17))
    from navierstokessolver_tpu_torch.parallel import (
        make_mesh, sharded_simulation,
    )
    mesh = make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(NotImplementedError, match="pencil tier"):
        sharded_simulation(sim, mesh)
    # a 3D profile and a CONVECTIVE face still raise
    prof = dict(sim.bcs)
    prof[(0, 0)] = tbcs.BCSpec.inflow((np.ones((1, 16, 16)), 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsolver.Simulation.build(g, prof, sim.params, "cpu")
    conv = dict(sim.bcs)
    conv[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.CONVECTIVE, (1.0,))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsolver.Simulation.build(g, conv, sim.params, "cpu")

