"""PyTorch port vs JAX package: rk2 and the CFL-adaptive dt on every route.

Both packages run on the CPU in this process from the same seeded state;
the port's wrappers run their plain versions (the fused routes' stage 2
with ``base``, as the JAX kernels form it: u* = base + dt*RHS(u_mid)),
and the JAX package its jnp step (stage 2's u* formed as
u + (u*_mid - u_mid)), so the two routes' u* differ by float32 roundoff
of that one sum. Tolerances are those of the JAX package's own tests:
rk2 u rtol 2e-5 / atol 2e-6 and p rtol 2e-4 / atol 2e-5
(tests/test_fused_step.py, test_fused3d_rk2_matches_reference); the CFL
runs the dt series within rtol 3e-5 and u rtol 5e-5 / atol 5e-6
(test_fused3d_cfl_adaptive_matches_reference); the slab tier atol 5e-5 on
u, 5e-4 on p and the dt series within rtol 1e-6
(tests/test_fused_sharded.py). Iteration counts are equal, but where a
solve's stopping test sits within float32 roundoff of its tolerance (see
``COUNT_SLACK``). The CUDA kernels are held to their plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.les import LESConfig as JaxLESConfig
from navierstokessolver_tpu.ops.poisson import PoissonConfig as JaxPoisson
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import (
    fused2d, fused3d, predictor2d, predictor3d, step_size, stencils,
)
from navierstokessolver_tpu_torch.ops.poisson import PoissonConfig
from navierstokessolver_tpu_torch.parallel import (
    make_mesh, shard_state, sharded_simulation,
)

CPU = torch.device("cpu")

# The largest difference in poisson_iters a step that float32 roundoff
# explains, by route. IBM cylinder: one sweep of the DCT-preconditioned
# Richardson leaves a relative residual of 8.4e-6 (JAX) and 1.1e-5 (port)
# on the same stage-1 RHS at step 1, both evaluated in float64: the
# preconditioner's two float32 transform chains differ by 1.7e-6 of max|z|,
# and tol is 1e-5, so JAX stops after 1 sweep and the port after 2. Channel
# (mg, tol 1e-4, from rest): one V-cycle of 34, a count of the stagnation
# rule, as tests/test_torch_channel.py explains for the Euler step.
COUNT_SLACK = {"cylinder": 2, "channel": 1}


def _rk2_box():
    """JAX's test_fused3d_rk2_matches_reference: a (16, 8, 8) box, the
    wall on axis 2's high side moving at (0.6, 0.2, 0), mg, and a seeded
    random BC-consistent start."""
    shape, lengths = (16, 8, 8), (1.0, 0.5, 0.5)
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[(2, 1)] = jbcs.BCSpec.wall((0.6, 0.2, 0.0))
    tb[(2, 1)] = tbcs.BCSpec.wall((0.6, 0.2, 0.0))
    kw = dict(dt=2e-3, nu=0.02, integrator="rk2")
    jsim = jsolver.Simulation.build(jg, jb, jsolver.SimParams(
        poisson=JaxPoisson(method="mg", tol=1e-6, max_iters=400), **kw))
    tsim = tsolver.Simulation.build(tg, tb, tsolver.SimParams(
        poisson=PoissonConfig(method="mg", tol=1e-6, max_iters=400), **kw),
        CPU)
    rng = np.random.default_rng(5)
    u = jbcs.apply_velocity_bcs(jg, jb, tuple(
        rng.normal(size=jg.face_shape(a)).astype(np.float32)
        for a in range(3)))
    js = jsolver.State(u=u, p=np.zeros(shape, np.float32))
    ts = convert.state_from_numpy([np.asarray(c) for c in u],
                                  np.zeros(shape, np.float32))
    return jsim, tsim, js, ts


def _cases(name, **kw):
    """Both packages' ``make_case(name, **kw)`` and their start states."""
    les = kw.pop("les_cs", None)
    jc, tc = jax_make_case(name, **kw), make_case(name, device="cpu", **kw)
    jsim, tsim = jc.sim, tc.sim
    if les is not None:
        jcfg = JaxLESConfig(cs=les)
        jsim = dataclasses.replace(jsim, les=jcfg)
        tsim = dataclasses.replace(tsim, les=convert.les_config_from_jax(jcfg))
    if name == "cylinder":
        return jsim, tsim, jax_impulsive_start(jsim), impulsive_start_state(
            tsim)
    return jsim, tsim, jc.initial_state(), tc.initial_state()


def _compare(js, jd, ts, td, urtol=2e-5, uatol=2e-6, prtol=2e-4,
             patol=2e-5, slack=0, dt_rtol=3e-5):
    u, p = convert.state_to_numpy(ts)
    for a in range(len(u)):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=urtol,
                                   atol=uatol)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=prtol, atol=patol)
    t_it = td.poisson_iters.tolist()
    j_it = np.asarray(jd.poisson_iters).tolist()
    assert max(abs(a - b) for a, b in zip(t_it, j_it)) <= slack, (t_it, j_it)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=dt_rtol)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)


RK2_ROUTES = {
    # the fused 2D step (tests/test_pallas2d.py's rk2 case)
    "cavity2d-mg": ("cavity", dict(shape=(32, 32), re=100.0,
                                   poisson_method="mg")),
    # the fused 3D step on the periodic masks, the direct solve
    "taylor_green3d-fft": ("taylor_green3d", dict(shape=(16, 16, 16),
                                                  re=200.0)),
    # the unfused 2D step: IBM, inflow / outflow / slip faces, dctcg
    "cylinder-ibm-dctcg": ("cylinder", dict(shape=(64, 32), ibm=True)),
    # the unfused 2D step with the inflow profile, mg (tol as in
    # tests/test_torch_channel.py's developing start)
    "channel-mg": ("channel", dict(shape=(64, 16), poisson_tol=1e-4)),
    # the LES step: nu_t and the LES predictor on each stage's field
    "cavity3d-les": ("cavity3d", dict(shape=(16, 16, 16), re=500.0,
                                      les_cs=0.17)),
}


@pytest.mark.parametrize("route", sorted(RK2_ROUTES))
def test_rk2_five_steps_match_jax(route):
    name, kw = RK2_ROUTES[route]
    jsim, tsim, js, ts = _cases(name, integrator="rk2", **kw)
    assert tsim.params.integrator == "rk2"
    js, jd = jsim.run_scan(js, 5)
    ts, td = tsim.run_scan(ts, 5)
    _compare(js, jd, ts, td, slack=COUNT_SLACK.get(name, 0))
    assert bool(torch.isfinite(td.max_div).all())


def test_rk2_fused3d_box_matches_jax():
    """JAX's fused 3D rk2 test case: both stages through the fused route's
    plain versions, stage 2 anchored at the step-start state."""
    jsim, tsim, js, ts = _rk2_box()
    assert tsim.fused
    js, jd = jsim.run_scan(js, 5)
    ts, td = tsim.run_scan(ts, 5)
    _compare(js, jd, ts, td)
    # rk2 runs two solves a step: its counts are the sums of both
    assert all(int(i) >= 2 for i in td.poisson_iters)


def test_cfl_cavity3d_matches_jax():
    """JAX's test_fused3d_cfl_adaptive_matches_reference: cfl 0.4 with a
    cap of 10x the case's dt, 6 steps; the carried corrector maximum sets
    each dt from step 1 on."""
    tc = make_case("cavity3d", shape=(16, 16, 16), re=100.0, device="cpu")
    cap = 10 * tc.sim.params.dt
    jsim, tsim, js, ts = _cases("cavity3d", shape=(16, 16, 16), re=100.0,
                                cfl=0.4, dt=cap)
    js, jd = jsim.run_scan(js, 6)
    ts, td = tsim.run_scan(ts, 6)
    dts = td.dt.numpy()
    assert np.all(dts[1:] < cap) and len(np.unique(dts)) > 1
    _compare(js, jd, ts, td, urtol=5e-5, uatol=5e-6, prtol=5e-4, patol=5e-5)


def test_cfl_cavity2d_matches_jax():
    """JAX's test_cfl_adaptive_dt on the fused 2D step: cfl 0.3 at the
    case's dt, 50 steps; the limiter binds below the cap."""
    jsim, tsim, js, ts = _cases("cavity", shape=(32, 32), cfl=0.3)
    js, jd = jsim.run_scan(js, 50)
    ts, td = tsim.run_scan(ts, 50)
    dts = td.dt.numpy()
    assert dts.min() < tsim.params.dt and np.all(dts <= tsim.params.dt)
    assert float(td.max_cfl.max()) < 0.5
    _compare(js, jd, ts, td, urtol=5e-5, uatol=5e-6, prtol=5e-4, patol=5e-5)


@pytest.mark.parametrize("name,kw", [
    ("cylinder", dict(shape=(64, 32), ibm=True, cfl=0.4)),
    ("cavity3d", dict(shape=(16, 16, 16), re=500.0, les_cs=0.17, cfl=0.4,
                      dt=0.1)),
], ids=["cylinder-ibm", "cavity3d-les"])
def test_cfl_recomputing_routes_match_jax(name, kw):
    """The routes that take their CFL reduction from the step's entry
    field, as JAX's jnp step does (the unfused 2D step, the LES step),
    with rk2."""
    jsim, tsim, js, ts = _cases(name, integrator="rk2", **kw)
    js, jd = jsim.run_scan(js, 5)
    ts, td = tsim.run_scan(ts, 5)
    assert len(np.unique(td.dt.numpy())) > 1
    _compare(js, jd, ts, td, urtol=5e-5, uatol=5e-6, prtol=5e-4, patol=5e-5,
             slack=COUNT_SLACK.get(name, 0))


@pytest.mark.parametrize("kw", [dict(integrator="rk2"), dict(cfl=0.3)],
                         ids=["rk2", "cfl"])
def test_slab_tier_matches_unsharded_and_jax(kw):
    """4 slabs of cavity3d (32, 16, 16), 8 steps (JAX's
    test_sharded_fused_rk2_matches_unsharded and ..._cfl_adaptive_...):
    the slab tier equals the unsharded port bit for bit on the CPU and
    holds to the JAX step."""
    case = make_case("cavity3d", shape=(32, 16, 16), re=100.0, device="cpu",
                     **kw)
    jc = jax_make_case("cavity3d", shape=(32, 16, 16), re=100.0, **kw)
    mesh = make_mesh(4, devices=[CPU] * 4)
    sp = sharded_simulation(case.sim, mesh, rdma=True)
    out, d = sp.run_scan(shard_state(case.initial_state(), mesh,
                                     case.sim.grid), 8)
    ref, dref = case.sim.run_scan(case.initial_state(), 8)
    for a in range(3):
        torch.testing.assert_close(out.u[a], ref.u[a], rtol=0, atol=0)
    torch.testing.assert_close(d.dt, dref.dt, rtol=0, atol=0)
    assert d.poisson_iters.tolist() == dref.poisson_iters.tolist()
    js, jd = jc.sim.run_scan(jc.initial_state(), 8)
    u, p = convert.state_to_numpy(out)
    for a in range(3):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), atol=5e-5)
    np.testing.assert_allclose(p, np.asarray(js.p), atol=5e-4)
    np.testing.assert_allclose(d.dt.numpy(), np.asarray(jd.dt), rtol=1e-6)
    assert d.poisson_iters.tolist() == np.asarray(jd.poisson_iters).tolist()


def _taylor_green(integrator, dt, n_steps):
    case = make_case("taylor_green3d", shape=(12, 12, 12), re=5.0, dt=dt,
                     integrator=integrator, device="cpu")
    return case.sim.run_scan(case.initial_state(), n_steps)[0]


def _err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a.u, b.u))


def test_rk2_is_second_order_in_time():
    """JAX's tests/test_integrators.py test_rk2_is_second_order_in_time,
    in 3D (the port has no 2D periodic faces): self-convergence in time
    against an 80-step run to t = 0.4 at Re 5 on the same grid, so the
    spatial error cancels; halving dt cuts rk2's error ~4x and Euler's
    ~2x."""
    t_end = 0.4
    ref = _taylor_green("rk2", t_end / 80, 80)
    e_rk2 = [_err(_taylor_green("rk2", t_end / n, n), ref) for n in (5, 10)]
    e_eul = [_err(_taylor_green("euler", t_end / n, n), ref)
             for n in (5, 10)]
    assert e_rk2[0] / e_rk2[1] > 3.2, e_rk2
    assert 1.6 < e_eul[0] / e_eul[1] < 2.6, e_eul
    assert e_rk2[0] < 0.2 * e_eul[0], (e_rk2, e_eul)


# -- the step size as a device scalar -----------------------------------------


def _random_velocity(grid, bcs, seed):
    rng = np.random.default_rng(seed)
    return tbcs.apply_velocity_bcs(grid, bcs, tuple(
        torch.from_numpy(rng.normal(size=grid.face_shape(a)).astype(
            np.float32)) for a in range(grid.ndim)))


def _same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if isinstance(x, tuple):
            _same(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_step_size_buffer():
    """[dt, rho/dt, dt/rho] in float32 arithmetic, the same from a Python
    float as from a 0-d tensor (true divisions, never a reciprocal
    multiply)."""
    dt, rho = 3.7e-4, 1.3
    want = [np.float32(dt), np.float32(rho) / np.float32(dt),
            np.float32(dt) / np.float32(rho)]
    got = step_size.buffer(dt, rho, CPU)
    assert got.tolist() == [float(x) for x in want]
    assert step_size.buffer(torch.tensor(dt), rho, CPU).tolist() == \
        got.tolist()
    assert step_size.buffer(dt, rho, CPU) is got    # built once
    half = step_size.buffer(0.5 * torch.tensor(dt), rho, CPU)
    assert half.tolist() == step_size.values(float(np.float32(0.5)
                                                   * np.float32(dt)), rho)
    with pytest.raises(ValueError, match="one value"):
        step_size.scalar(torch.zeros(2), CPU, "x")
    with pytest.raises(TypeError, match="float32"):
        step_size.scalar(torch.zeros((), dtype=torch.float64), CPU, "x")


@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
def test_wrappers_take_dt_as_float_or_tensor(periodic):
    """Each wrapper (on the CPU: its plain version) and each plain version
    gives the same result for dt as a Python float and as a 0-d tensor,
    with and without ``base``."""
    tg = tgrid.GridSpec((12, 10, 14), (1.0, 0.8, 1.2))
    tb = tbcs.no_slip_box(tg)
    if periodic:
        for a in range(3):
            tb[(a, 0)] = tb[(a, 1)] = tbcs.BCSpec.periodic()
    else:
        tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    u, base = _random_velocity(tg, tb, 0), _random_velocity(tg, tb, 1)
    dt, rho = 3.7e-4, 1.3
    dtt = torch.tensor(dt)
    dts = step_size.buffer(dtt, rho, CPU)
    p = torch.from_numpy(np.random.default_rng(2).normal(
        size=tg.shape).astype(np.float32))
    per = tbcs.periodic_axes(tg, tb)
    for b in (None, base):
        _same(fused3d.predictor_rhs_3d(tg, tb, u, dt, 0.02, 0.8, rho,
                                       base=b),
              fused3d.predictor_rhs_3d(tg, tb, u, dtt, 0.02, 0.8, rho,
                                       base=b, dts=dts))
        _same(fused3d.predictor_rhs_plain(tg, tb, u, dt, 0.02, 0.8, rho,
                                          base=b),
              fused3d.predictor_rhs_plain(tg, tb, u, dtt, 0.02, 0.8, rho,
                                          base=b))
    scale = float(np.float32(dt) / np.float32(rho))
    _same(fused3d.correct_diag_3d(tg, u, p, scale, per),
          fused3d.correct_diag_3d(tg, u, p, dts[2], per))
    _same(fused3d.correct_diag_plain(tg, u, p, scale, per),
          fused3d.correct_diag_plain(tg, u, p, dts[2], per))
    _same(stencils.poisson_rhs(tg, u, dt, rho),
          stencils.poisson_rhs(tg, u, dtt, rho))
    _same(stencils.max_cfl(tg, u, dt), stencils.max_cfl(tg, u, dtt))
    if not periodic:
        nu_t = torch.rand(tg.shape, generator=torch.Generator().manual_seed(3))
        _same(predictor3d.predictor_3d(tg, tb, u, dt, 0.02, 0.8, nu_t=nu_t),
              predictor3d.predictor_3d(tg, tb, u, dts[0], 0.02, 0.8,
                                       nu_t=nu_t))
        _same(predictor3d.predictor_3d_plain(tg, tb, u, dt, 0.02, 0.8,
                                             nu_t=nu_t),
              predictor3d.predictor_3d_plain(tg, tb, u, dtt, 0.02, 0.8,
                                             nu_t=nu_t))


def test_2d_wrappers_take_dt_as_float_or_tensor():
    tg = tgrid.GridSpec((20, 14), (1.0, 0.7))
    tb = tbcs.no_slip_box(tg)
    tb[(1, 1)] = tbcs.BCSpec.wall((1.0, 0.0))
    u, base = _random_velocity(tg, tb, 4), _random_velocity(tg, tb, 5)
    dt, rho = 3.7e-4, 1.3
    dtt = torch.tensor(dt)
    dts = step_size.buffer(dtt, rho, CPU)
    p = torch.from_numpy(np.random.default_rng(6).normal(
        size=tg.shape).astype(np.float32))
    for b in (None, base):
        _same(fused2d.predictor_rhs_2d(tg, tb, u, dt, 0.02, 0.8, rho, base=b),
              fused2d.predictor_rhs_2d(tg, tb, u, dtt, 0.02, 0.8, rho,
                                       base=b, dts=dts))
    scale = float(np.float32(dt) / np.float32(rho))
    _same(fused2d.correct_diag_2d(tg, u, p, scale),
          fused2d.correct_diag_2d(tg, u, p, dts[2]))
    _same(predictor2d.predictor_2d(tg, tb, u, dt, 0.02, 0.2),
          predictor2d.predictor_2d(tg, tb, u, dts[0], 0.02, 0.2))
    _same(predictor2d.predictor_2d_plain(tg, tb, u, dt, 0.02, 0.2),
          predictor2d.predictor_2d_plain(tg, tb, u, dtt, 0.02, 0.2))


@pytest.mark.parametrize("name,kw", [
    ("cavity3d", dict(shape=(16, 16, 16), re=100.0, dt=0.05)),
    ("cavity", dict(shape=(32, 32), re=100.0, dt=0.05)),
    ("cylinder", dict(shape=(64, 32), ibm=True, dt=0.2)),
], ids=["fused3d", "fused2d", "unfused2d"])
def test_step_loop_dt_series_equals_run_scan(name, kw):
    """``step()`` recomputes the CFL reduction from its state, ``run_scan``
    carries the corrector's maximum (the fused routes) or recomputes it
    (the unfused one): on the CPU the two give the same dt series, since
    max(|u|/h) = max|u| / h exactly."""
    case = make_case(name, device="cpu", integrator="rk2", cfl=0.4, **kw)
    sim = case.sim
    st0 = (impulsive_start_state(sim) if name == "cylinder"
           else case.initial_state())
    _, d = sim.run_scan(st0, 6)
    st, dts = st0, []
    for _ in range(6):
        st, di = sim.step(st)
        dts.append(float(di.dt))
    assert d.dt.tolist() == dts
    assert len(set(dts)) > 1


def test_rk2_step_plain_equals_step_on_cpu():
    """On the CPU the kernel step runs the plain versions: step and
    step_plain agree on every route under rk2 and the CFL dt."""
    for name, kw in (("cavity3d", dict(shape=(12, 12, 12))),
                     ("taylor_green3d", dict(shape=(12, 12, 12))),
                     ("cavity", dict(shape=(24, 24)))):
        sim = make_case(name, device="cpu", integrator="rk2", cfl=0.5,
                        **kw).sim
        st = sim.initial_state() if name != "taylor_green3d" else \
            make_case(name, device="cpu", **kw).initial_state()
        a, da = sim.step(st)
        b, db = sim.step_plain(st)
        for x, y in zip(a.u, b.u):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
        assert float(da.dt) == float(db.dt)


def test_float64_stays_unported():
    with pytest.raises(NotImplementedError,
                       match="RK2, CFL-adaptive dt and float64"):
        tgrid.GridSpec((8, 8), (1.0, 1.0), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown integrator"):
        tsolver.SimParams(dt=1e-3, nu=0.01, integrator="rk3")


def test_run_scan_forces_runs_the_rk2_cfl_step():
    """``run_scan_forces`` steps as ``run_scan`` does, rk2 and the CFL dt
    included (JAX's run_scan_forces scans ``sim.step``): the same states
    and dt series, and force terms equal to ``cv_terms_nd`` sampled after
    each step of ``run_scan``."""
    from navierstokessolver_tpu_torch.utils.forces import cv_terms_nd

    case = make_case("cylinder", shape=(64, 32), lengths=(8.0, 4.0),
                     center=(2.0, 2.01), ibm=True, integrator="rk2", cfl=0.4,
                     dt=0.2, device="cpu")
    sim, box = case.sim, (8, 24, 6, 26)
    st0 = impulsive_start_state(sim)
    st_f, d_f, sf, mom = sim.run_scan_forces(st0, 4, box)
    st, post, dts = st0, [], []
    for _ in range(4):
        st, d = sim.run_scan(st, 1)
        dts.append(float(d.dt[0]))
        post.append(torch.stack([*(torch.stack(t) for t in cv_terms_nd(
            sim.grid, st, sim.params.nu, box))]))
    assert d_f.dt.tolist() == dts and len(set(dts)) > 1
    for a, b in zip(st_f.u, st.u):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack([sf, mom], 1), torch.stack(post),
                               rtol=0, atol=0)
