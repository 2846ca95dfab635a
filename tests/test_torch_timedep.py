"""PyTorch port vs JAX package: the time-dependent drive (State.t).

BC values and force components that are callables of ``t``: the step
resolves them at the carried ``State.t`` (a 0-d tensor on the device),
writes the values into the buffers the kernels read (the wall and force
entries of the fused kernels' table, the unfused route's ghost table)
and advances ``t`` by the dt it used. ``pulsatile_channel`` (a force
``cos(omega t)``, kernel 4's force entry) and ``oscillating_lid`` in 3D
and 2D (the lid's entry) through both packages' ``make_case`` and
``run_scan``, Euler, rk2 and the CFL dt, from the same initial state:
u rtol 2e-5 / atol 1e-6, p rtol 2e-4 / atol 1e-6, the dt series rtol
3e-5, equal iteration counts, and the final t equal within 1e-6
(tests/test_torch_convection.py's f32 tolerances). The JAX package's
oracles (tests/test_timedep.py): the Womersley channel against the exact
semi-discrete response, the oscillating lid against a static simulation
rebuilt every step, the 3D oscillating lid against JAX's run, the
checkpoint round trip, ``run_scan(state, 0)``; and the drive on the
unfused route (a pulsatile inflow and a moving wall) and through the
command line.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import io as jio
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jmake
from navierstokessolver_tpu.ops.poisson import PoissonConfig as JPoisson
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case as tmake
from navierstokessolver_tpu_torch.cli import main as cli_main
from navierstokessolver_tpu_torch.ops import predictor2d
from navierstokessolver_tpu_torch.ops.poisson import PoissonConfig

CASES = {
    "pulsatile": ("pulsatile_channel", dict(shape=(8, 16))),
    "lid3d": ("oscillating_lid", dict(shape=(8, 8, 8))),
    "lid2d": ("oscillating_lid", dict(shape=(16, 16))),
}
MODES = {"euler": {}, "rk2": dict(integrator="rk2"),
         "cfl": dict(integrator="rk2", cfl=0.4)}


def _compare(js, jd, ts, td, atol_u=1e-6, atol_p=1e-6, slack=0):
    u, p = convert.state_to_numpy(ts)
    for c in range(len(u)):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]), rtol=2e-5,
                                   atol=atol_u)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=atol_p)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    it = np.abs(td.poisson_iters.numpy().astype(np.int64)
                - np.asarray(jd.poisson_iters).astype(np.int64))
    assert int(it.max()) <= slack, it
    np.testing.assert_allclose(float(ts.t), float(js.t), rtol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("key", list(CASES))
def test_timedep_cases_match_jax(key, mode):
    """Ten steps of each time-dependent case in both packages (the port
    on its fused route: the callables' values in the kernels' table; JAX
    on its fused 3D scan or its jnp step), fields, dt, iterations and t."""
    name, kw = CASES[key]
    jc = jmake(name, **kw, **MODES[mode])
    tc = tmake(name, device="cpu", **kw, **MODES[mode])
    assert tc.sim.fused and tc.sim.time_dependent
    js, ts = jc.initial_state(), tc.initial_state()
    assert float(ts.t) == float(js.t) == 0.0
    for c in range(len(ts.u)):
        np.testing.assert_array_equal(ts.u[c].numpy(), np.asarray(js.u[c]))
    js, jd = jc.sim.run_scan(js, 10)
    ts, td = tc.sim.run_scan(ts, 10)
    _compare(js, jd, ts, td)
    assert float(ts.t) > 0.0


def test_pulsatile_channel_matches_exact_semidiscrete():
    """JAX's oracle: f_x(t) = A cos(omega t) in a periodic channel keeps u
    x-uniform with v = 0, so each eigenmode of the discrete wall-bounded
    Laplacian obeys dc/dt = -nu lam c + A_k cos(omega t) exactly; rk2 to
    t = 0.8 (8x32, Wo 4) is within 2e-3 of the closed form, the transient
    included, and t is n dt."""
    ny = 32
    case = tmake("pulsatile_channel", shape=(8, ny), womersley=4.0,
                 integrator="rk2", device="cpu")
    sim = case.sim
    nu, omega, dt = sim.params.nu, 2.0 * np.pi, sim.params.dt
    n_steps = int(0.8 / dt)
    st, _ = sim.run_scan(case.initial_state(), n_steps)
    t_end = float(st.t)
    np.testing.assert_allclose(t_end, n_steps * dt, rtol=1e-5)
    h = sim.grid.spacing[1]
    lap = np.zeros((ny, ny))
    for j in range(ny):
        lap[j, j] = -2.0
        if j > 0:
            lap[j, j - 1] = 1.0
        if j < ny - 1:
            lap[j, j + 1] = 1.0
    lap[0, 0] -= 1.0
    lap[-1, -1] -= 1.0
    lap /= h * h
    lam, vec = np.linalg.eigh(lap)
    d = -nu * lam
    c = (vec.T @ np.ones(ny)) * (
        (d * np.cos(omega * t_end) + omega * np.sin(omega * t_end)
         - d * np.exp(-d * t_end)) / (d * d + omega * omega))
    u_exact = vec @ c
    u = st.u[0][: sim.grid.shape[0]].numpy()
    assert np.max(np.abs(u - u[0:1, :])) < 1e-6
    err = np.max(np.abs(u[0] - u_exact)) / (np.max(np.abs(u_exact)) + 1e-30)
    assert err < 2e-3, err


def test_oscillating_lid_matches_per_step_static_rebuild():
    """JAX's oracle: a callable lid velocity reproduces the trajectory of
    a static simulation rebuilt every step with the lid evaluated at the
    step's start time (16^2, cg at tol 1e-7, 25 steps: atol 2e-6)."""
    n, omega = 16, 3.0
    g = tgrid.GridSpec((n, n), (1.0, 1.0))
    params = tsolver.SimParams(dt=2e-3, nu=0.05, poisson=PoissonConfig(
        method="cg", tol=1e-7, max_iters=400))
    bcs_td = tbcs.no_slip_box(g)
    bcs_td[(1, 1)] = tbcs.BCSpec.wall(
        (lambda t: 0.5 + 0.5 * torch.sin(omega * t), 0.0))
    sim_td = tsolver.Simulation.build(g, bcs_td, params, "cpu")
    assert sim_td.time_dependent
    st_td = sim_td.initial_state()
    out_td, _ = sim_td.run_scan(st_td, 25)
    st = None
    for k in range(25):
        bk = tbcs.no_slip_box(g)
        lid = float(0.5 + 0.5 * np.sin(omega * np.float32(k * params.dt)))
        bk[(1, 1)] = tbcs.BCSpec.wall((lid, 0.0))
        sk = tsolver.Simulation.build(g, bk, params, "cpu")
        st = sk.initial_state() if st is None else st
        st, _ = sk.step(st)
    for c in range(2):
        np.testing.assert_allclose(out_td.u[c].numpy(), st.u[c].numpy(),
                                   atol=2e-6)
    np.testing.assert_allclose(float(out_td.t), 25 * params.dt, rtol=1e-5)


@pytest.mark.parametrize("mode", ["euler", "rk2_cfl"])
def test_oscillating_lid_3d_matches_jax(mode):
    """JAX's 3D parity case (tests/test_timedep.py: 16^3, the lid cos(2 pi
    t) on face (0, 1), cg): the port's fused route against JAX's fused
    time-dependent scan, Euler, then rk2 with the CFL dt; u atol 3e-5, p
    atol 5e-4 (the cg tolerance), t rtol 1e-6 (JAX's parity tolerances)."""
    extra = dict(integrator="rk2", cfl=0.4) if mode == "rk2_cfl" else {}
    shape = (16, 16, 16)
    jg, tg = jgrid.GridSpec(shape, (1.0,) * 3), tgrid.GridSpec(shape,
                                                              (1.0,) * 3)
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[(0, 1)] = jbcs.BCSpec.wall(
        (0.0, lambda t: jnp.cos(2.0 * jnp.pi * t), 0.0))
    tb[(0, 1)] = tbcs.BCSpec.wall(
        (0.0, lambda t: torch.cos(2.0 * np.pi * t), 0.0))
    jp = jsolver.SimParams(dt=2e-3, nu=0.01, poisson=JPoisson(
        method="cg", tol=1e-6, max_iters=500), **extra)
    tp = tsolver.SimParams(dt=2e-3, nu=0.01, poisson=PoissonConfig(
        method="cg", tol=1e-6, max_iters=500), **extra)
    js_sim = jsolver.Simulation.build(jg, jb, jp)
    ts_sim = tsolver.Simulation.build(tg, tb, tp, "cpu")
    assert ts_sim.fused
    js, _ = js_sim.run_scan(js_sim.initial_state(), 5)
    ts, _ = ts_sim.run_scan(ts_sim.initial_state(), 5)
    for c in range(3):
        np.testing.assert_allclose(ts.u[c].numpy(), np.asarray(js.u[c]),
                                   atol=3e-5)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), atol=5e-4)
    np.testing.assert_allclose(float(ts.t), float(js.t), rtol=1e-6)


def _through_flow(m, grid, cap):
    """A box whose walls x = 0 and x = 1 carry the normal value
    g(t) = 1 + 10 t (inflow and outflow equal), the other walls at rest;
    Euler at cfl 0.4 under the cap ``cap``, cg at tol 1e-4; ``m`` the
    package's bcs module."""
    nd = grid.ndim
    b = m.no_slip_box(grid)
    for side in (0, 1):
        b[(0, side)] = m.BCSpec.wall(
            (lambda t: 1.0 + 10.0 * t,) + (0.0,) * (nd - 1))
    ps, pc = (jsolver, JPoisson) if m is jbcs else (tsolver, PoissonConfig)
    params = ps.SimParams(dt=cap, nu=0.01, cfl=0.4, poisson=pc(
        method="cg", tol=1e-4, max_iters=500))
    if m is jbcs:
        return ps.Simulation.build(grid, b, params)
    return ps.Simulation.build(grid, b, params, "cpu")


@pytest.mark.parametrize("nd", [2, 3])
def test_timedep_normal_wall_refresh_and_cfl(nd):
    """A callable normal wall value on the fused route: the stored
    boundary faces are rewritten at each step's t before the step, and the
    CFL dt comes from the rewritten field (JAX's
    refresh_dirichlet_faces_internal_3d, then vel_inv_internal_3d). 16^nd,
    6 steps, a cap of 0.05 above every CFL dt: the first dt are 0.4 h /
    g(t_k), set by the faces at the step's own t (the faces of the step
    before would give 0.4 h / g(t_{k-1})). Against JAX's run_scan (fields,
    dt, t; cg counts within one: at tol 1e-5 JAX's step 0 takes 22 cg
    iterations to the port's 11 in 3D, as does a static step with these
    faces, with equal fields) and against step_plain a step at a time."""
    shape = (16,) * nd
    jg, tg = jgrid.GridSpec(shape, (1.0,) * nd), tgrid.GridSpec(
        shape, (1.0,) * nd)
    js_sim, ts_sim = _through_flow(jbcs, jg, 0.05), _through_flow(tbcs, tg,
                                                                 0.05)
    assert ts_sim.fused and ts_sim.time_dependent
    js, jd = js_sim.run_scan(js_sim.initial_state(), 6)
    ts, td = ts_sim.run_scan(ts_sim.initial_state(), 6)
    _compare(js, jd, ts, td, atol_u=5e-6, atol_p=1e-4, slack=1)
    dt = td.dt.numpy().astype(np.float64)
    assert (dt < 0.05).all(), dt
    t_k = np.concatenate([[0.0], np.cumsum(dt)[:-1]])
    np.testing.assert_allclose(dt[:4], 0.4 / 16 / (1.0 + 10.0 * t_k[:4]),
                               rtol=1e-5)
    # the faces hold the last step's value
    t_last = float(ts.t) - float(td.dt[-1])
    for face in (ts.u[0][0], ts.u[0][-1]):
        np.testing.assert_allclose(face.numpy(), 1.0 + 10.0 * t_last,
                                   rtol=1e-6)
    sp = ts_sim.initial_state()
    for k in range(6):
        sp, dp = ts_sim.step_plain(sp)
        assert float(dp.dt) == float(td.dt[k])
    for c in range(nd):
        np.testing.assert_allclose(ts.u[c].numpy(), sp.u[c].numpy(),
                                   rtol=2e-5, atol=2e-6)
    assert float(sp.t) == float(ts.t)


def test_timedep_checkpoint_roundtrip(tmp_path):
    """JAX's oracle: t survives a checkpoint and the resumed run equals an
    unbroken one (atol 1e-6); the configuration hash is JAX's, and the
    checkpoints cross between the packages both ways with t."""
    name, kw = "pulsatile_channel", dict(shape=(8, 16), womersley=3.0)
    tc, jc = tmake(name, device="cpu", **kw), jmake(name, **kw)
    sim = tc.sim
    h = tio.config_hash(sim.grid, sim.params)
    assert h == jio.config_hash(jc.sim.grid, jc.sim.params)
    st0 = tc.initial_state()
    mid, _ = sim.run_scan(st0, 10)
    tio.save_checkpoint(str(tmp_path / "t.npz"), mid, 10, h)
    loaded, step = tio.load_checkpoint(str(tmp_path / "t.npz"), sim.grid, h,
                                       device="cpu")
    assert step == 10 and loaded.t is not None
    assert float(loaded.t) == float(mid.t)
    cont, _ = sim.run_scan(loaded, 10)
    full, _ = sim.run_scan(st0, 20)
    for c in range(2):
        np.testing.assert_allclose(cont.u[c].numpy(), full.u[c].numpy(),
                                   atol=1e-6)
    assert float(cont.t) == float(full.t)
    # JAX reads the port's checkpoint, the port JAX's
    js, jstep = jio.load_checkpoint(str(tmp_path / "t.npz"), jc.sim.grid, h)
    assert jstep == 10 and float(js.t) == float(mid.t)
    js, _ = jc.sim.run_scan(js, 5)
    jio.save_checkpoint(str(tmp_path / "j.npz"), js, 15, h)
    back, _ = tio.load_checkpoint(str(tmp_path / "j.npz"), sim.grid, h,
                                  device="cpu")
    assert float(back.t) == float(np.asarray(js.t))


def test_timedep_run_scan_zero_steps():
    """JAX's case: run_scan(state, 0) of a time-dependent run returns the
    state as it was (t included) and five empty diagnostics."""
    case = tmake("oscillating_lid", shape=(16, 16, 16), device="cpu")
    st0 = case.initial_state()
    out, diags = case.sim.run_scan(st0, 0)
    for c in range(3):
        assert torch.equal(out.u[c], st0.u[c])
    assert float(out.t) == 0.0
    assert all(x.shape[0] == 0 for x in diags)


def test_oscillating_lid_case_reverses():
    """JAX's registry case (tests/test_timedep.py): the near-lid tangential
    flow follows the lid, cos(omega t) = +1 at t = 0 and -1 at t = 0.5
    (16^3, Re 50, cg, dt 2.5e-3): positive near the lid after a quarter
    period, negative after three quarters."""
    case = tmake("oscillating_lid", shape=(16, 16, 16), re=50.0,
                 poisson_method="cg", dt=2.5e-3, device="cpu")
    sim = case.sim
    n_q = int(round(0.125 / sim.params.dt))
    st, _ = sim.run_scan(case.initial_state(), n_q)
    near = float(st.u[0][:, :, -1].mean())
    st, _ = sim.run_scan(st, 2 * int(round(0.25 / sim.params.dt)))
    near2 = float(st.u[0][:, :, -1].mean())
    assert near > 0.0 > near2, (near, near2)
    assert all(bool(torch.isfinite(c).all()) for c in st.u)


def _unfused_pair(kind):
    """A 32x16 channel whose drive depends on t on the unfused route, in
    both packages: a pulsatile uniform inflow (a normal value, the BC
    pass) or a wall sliding at sin(4 t) (a tangential value, kernel 8's
    ghost table refilled each step)."""
    grids = (jgrid.GridSpec((32, 16), (2.0, 1.0)),
             tgrid.GridSpec((32, 16), (2.0, 1.0)))
    out = []
    for m, g, sin, ps, pc in ((jbcs, grids[0], jnp.sin, jsolver, JPoisson),
                              (tbcs, grids[1], torch.sin, tsolver,
                               PoissonConfig)):
        b = {(0, 0): m.BCSpec.inflow((1.0, 0.0)), (0, 1): m.BCSpec.outflow(),
             (1, 0): m.BCSpec.wall((0.0, 0.0)),
             (1, 1): m.BCSpec.wall((0.0, 0.0))}
        if kind == "inflow":
            b[(0, 0)] = m.BCSpec.inflow(
                (lambda t, sin=sin: 1.0 + 0.5 * sin(4.0 * t), 0.0))
        else:
            b[(1, 1)] = m.BCSpec.wall((lambda t, sin=sin: sin(4.0 * t), 0.0))
        params = ps.SimParams(dt=5e-3, nu=0.02, poisson=pc(
            method="mg", tol=1e-5, max_iters=400))
        out.append(ps.Simulation.build(g, b, params) if m is jbcs else
                   ps.Simulation.build(g, b, params, "cpu"))
    return out


@pytest.mark.parametrize("kind", ["inflow", "wall"])
def test_timedep_unfused_route_matches_jax(kind):
    """The drive on the unfused 2D route (an OUTFLOW face: kernel 8), 10
    steps against JAX's jnp step: the inflow value through the BC passes,
    a sliding wall through kernel 8's ghost table, refilled in place; mg
    (tol 1e-5) V-cycle counts within one a step, the channel's slack
    (tests/test_torch_integrators.py)."""
    js_sim, ts_sim = _unfused_pair(kind)
    assert not ts_sim.fused and ts_sim.time_dependent
    before = ts_sim.ghosts.clone()
    js, jd = js_sim.run_scan(js_sim.initial_state(), 10)
    ts, td = ts_sim.run_scan(ts_sim.initial_state(), 10)
    _compare(js, jd, ts, td, atol_p=1e-4 * float(np.abs(np.asarray(
        js.p)).max()), slack=1)
    _, betas = predictor2d.ghost_parts(ts_sim.grid, ts_sim.ghosts)
    if kind == "wall":
        # the high wall's beta holds 2 u_bc of the last step's t
        t_last = float(ts.t) - float(td.dt[-1])
        np.testing.assert_allclose(betas[1].numpy(),
                                   2.0 * np.sin(4.0 * np.float32(t_last)),
                                   rtol=1e-6)
    else:
        assert torch.equal(before, ts_sim.ghosts)


def test_timedep_helpers_match_jax():
    """resolve_bcs, bcs_time_dependent and bcs_values_traced as JAX's:
    callables evaluated at t, the others untouched; the resolved table
    holds 0-d tensors (JAX: traced scalars inside jit)."""
    tb = tbcs.no_slip_box(tgrid.GridSpec((8, 8), (1.0, 1.0)))
    tb[(1, 1)] = tbcs.BCSpec.wall((lambda t: 2.0 * t, 0.0))
    assert tbcs.bcs_time_dependent(tb)
    assert not tbcs.bcs_values_traced(tb)
    r = tbcs.resolve_bcs(tb, torch.tensor(0.25))
    assert float(r[(1, 1)].velocity[0]) == 0.5
    assert r[(0, 0)] is tb[(0, 0)]
    assert not tbcs.bcs_time_dependent(r) and tbcs.bcs_values_traced(r)
    jb = jbcs.no_slip_box(jgrid.GridSpec((8, 8), (1.0, 1.0)))
    jb[(1, 1)] = jbcs.BCSpec.wall((lambda t: 2.0 * t, 0.0))
    assert float(jbcs.resolve_bcs(jb, 0.25)[(1, 1)].velocity[0]) == 0.5


def test_timedep_probes():
    """A state without t on a time-dependent simulation raises ValueError
    (initial_state sets it); a callable returning a profile, and the slab
    tier with a time-dependent value, raise naming their ROADMAP items."""
    from navierstokessolver_tpu_torch.parallel import (
        make_mesh, sharded_simulation,
    )

    case = tmake("oscillating_lid", shape=(16, 8, 8), device="cpu")
    st = dataclasses.replace(case.initial_state(), t=None)
    with pytest.raises(ValueError, match="carries t"):
        case.sim.step(st)
    g = tgrid.GridSpec((16, 16), (1.0, 1.0))
    b = tbcs.no_slip_box(g)
    b[(1, 1)] = tbcs.BCSpec.wall((lambda t: torch.ones(17) * t, 0.0))
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        tsolver.Simulation.build(g, b, tsolver.SimParams(dt=1e-3, nu=0.01),
                                 "cpu")
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="explicit-halo solvers"):
        sharded_simulation(case.sim, mesh)


def test_cli_resumes_a_timedep_run(tmp_path):
    """``--case oscillating_lid`` through the command line: a run of 6
    steps with a checkpoint, resumed for 6 more, equals 12 unbroken steps
    bit for bit, t included (the checkpoint carries it)."""
    base = ["--platform", "cpu", "--case", "oscillating_lid", "--shape",
            "8,8,8", "--chunk", "3"]
    a, b, c = (str(tmp_path / k) for k in "abc")
    assert cli_main([*base, "--steps", "6", "--out", a,
                     "--checkpoint-every", "6"]) == 0
    assert cli_main([*base, "--steps", "6", "--out", b, "--resume",
                     f"{a}/ckpt.npz", "--checkpoint-every", "6"]) == 0
    assert cli_main([*base, "--steps", "12", "--out", c,
                     "--checkpoint-every", "12"]) == 0
    with np.load(f"{a}/ckpt.npz") as za:
        assert "t" in za.files and float(za["t"]) > 0.0
    with np.load(f"{b}/ckpt.npz") as zb, np.load(f"{c}/ckpt.npz") as zc:
        for k in ("u0", "u1", "u2", "p", "t"):
            np.testing.assert_array_equal(zb[k], zc[k])
        assert int(zb["step"]) == int(zc["step"]) == 12
