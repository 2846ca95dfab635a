"""PyTorch port vs JAX package: body forcing on every route.

The cases of the forcing slice end to end, through both packages'
``make_case`` and ``run_scan`` from the same initial state:
``duct_periodic`` (kernel 1's static force), ``kolmogorov`` in 2D and 3D
(forcing volumes of kernels 4 and 1; JAX steps the 2D one on its jnp
predictor) and ``heated_enclosure`` (buoyancy around an obstacle: a
forcing volume of kernel 8 on the unfused route; JAX's jnp step). On the
CPU the port's wrappers run their plain versions. Tolerances are the
earlier slices' f32 ones (tests/test_torch_convection.py): u rtol 2e-5 /
atol 1e-6, p rtol 2e-4 / atol 1e-6 (the enclosure's mg solve: atol 1e-4
of max|p|), theta rtol 2e-5 / atol 1e-6, the dt series rtol 3e-5, equal
iteration counts. Each new mode's plain version against JAX's: the
Pallas ``predictor_rhs_3d`` with ``forcing`` and with ``forcing_fields``
in interpret mode (marked ``heavy``), ``stencils.predictor`` with
``forcing``. And the JAX package's oracles: the duct's series profile
(tests/test_channel.py), the Kolmogorov laminar balance in 2D and 3D
parity (tests/test_fused_step.py), the heated enclosure's energy balance
(tests/test_scalar.py: JAX runs to the balance, the port goes on from
JAX's state and keeps it; the port's discrete energy budget, the heat the
fluid stores equal to the body's flux minus the walls', every step).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.cases import make_case as jmake
from navierstokessolver_tpu.cases.convection import (
    wall_heat_flux as jwall_heat_flux,
)
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu.scalar import body_heat_flux as jbody_heat_flux
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case as tmake
from navierstokessolver_tpu_torch.cases.channel import duct_profile_exact
from navierstokessolver_tpu_torch.cases.convection import wall_heat_flux
from navierstokessolver_tpu_torch.grid import State
from navierstokessolver_tpu_torch.ops import fused3d, predictor2d, stencils
from navierstokessolver_tpu_torch.scalar import body_heat_flux

CASES = {
    "duct": ("duct_periodic", dict(shape=(16, 8, 8))),
    "kolmogorov2d": ("kolmogorov", dict(shape=(16, 16))),
    "kolmogorov3d": ("kolmogorov", dict(shape=(8, 8, 8))),
    "enclosure": ("heated_enclosure", dict(shape=(32, 32))),
}


def _pair(key, **extra):
    name, kw = CASES[key]
    return jmake(name, **kw, **extra), tmake(name, device="cpu", **kw,
                                            **extra)


def _compare(js, jd, ts, td, p_atol=1e-6, slack=0):
    u, p, theta = convert.state_to_numpy(ts, with_theta=True)
    for c in range(len(u)):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=p_atol)
    if theta is not None:
        np.testing.assert_allclose(theta, np.asarray(js.theta), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    it = np.abs(td.poisson_iters.numpy().astype(np.int64)
                - np.asarray(jd.poisson_iters).astype(np.int64))
    assert int(it.max()) <= slack, it


@pytest.mark.parametrize("key,mode", [
    ("duct", "euler"), ("duct", "rk2"), ("kolmogorov2d", "rk2"),
    ("kolmogorov2d", "euler"), ("kolmogorov3d", "rk2"),
    ("enclosure", "euler"), ("enclosure", "rk2")])
def test_forced_cases_match_jax(key, mode):
    """Ten steps of each forced case in both packages: the port's fused
    routes (the duct, Kolmogorov) and the unfused route (the enclosure)
    against JAX's steps, as the module docstring says."""
    jc, tc = _pair(key, integrator=mode)
    assert tc.sim.params.dt == jc.sim.params.dt
    assert tc.sim.fused == (key != "enclosure")
    assert not tc.sim.time_dependent
    js, ts = jc.initial_state(), tc.initial_state()
    js, jd = jc.sim.run_scan(js, 10)
    ts, td = tc.sim.run_scan(ts, 10)
    p_atol = (1e-4 * float(np.abs(np.asarray(js.p)).max())
              if key == "enclosure" else 1e-6)
    _compare(js, jd, ts, td, p_atol)
    # the force moved the flow
    assert max(float(c.abs().max()) for c in ts.u) > 1e-4


def test_forced_routes_and_volumes():
    """What each case holds: the duct's number in kernel 1's buffer
    (entry 18), Kolmogorov's array as its own volume in the forcing
    layout (all n faces on the periodic axis), the enclosure's volumes
    formed each step from theta (none stored); JAX's forcing arrays carry
    across as the same volumes (convert.force_volumes_from_numpy)."""
    duct = tmake("duct_periodic", shape=(16, 8, 8), device="cpu").sim
    assert duct.fused and duct.force_vol is None
    assert duct.bc.shape == (fused3d.BC_SIZE,)
    assert float(duct.bc[fused3d.FORCE_AT]) == pytest.approx(
        duct.forcing[0]) and float(duct.bc[fused3d.FORCE_AT + 1]) == 0.0
    jk = jmake("kolmogorov", shape=(16, 16)).sim
    tk = tmake("kolmogorov", shape=(16, 16), device="cpu").sim
    assert tk.force_vol[1] is None
    assert tuple(tk.force_vol[0].shape) == (16, 16)
    assert tk.force_vol[0] is tk.forcing[0]
    vols = convert.force_volumes_from_numpy(
        tk.grid, (True, True), [None if f is None else np.asarray(f)
                                for f in jk.forcing])
    np.testing.assert_array_equal(vols[0].numpy(), tk.force_vol[0].numpy())
    enc = tmake("heated_enclosure", shape=(32, 32), device="cpu").sim
    assert not enc.fused and enc.force_vol is None and enc.scalar.buoyant
    # a static number on the unfused route is a constant volume (kernel 8
    # has one force mode: volumes)
    ch = tmake("channel", shape=(32, 16), device="cpu").sim
    forced = tsolver.Simulation.build(ch.grid, ch.bcs, ch.params, "cpu",
                                      forcing=(0.25, None))
    assert not forced.fused and forced.force_vol[1] is None
    assert tuple(forced.force_vol[0].shape) == (31, 16)
    assert float(forced.force_vol[0].min()) == float(
        forced.force_vol[0].max()) == 0.25


@pytest.mark.parametrize("force", [(0.25, None), (None, -0.5)],
                         ids=["fx", "fy"])
def test_static_force_on_unfused_route_matches_jax(force):
    """A static force on the unfused 2D route (the Poiseuille channel's
    table; kernel 8's force volume) against JAX's jnp step: 5 steps, the
    V-cycle counts within one a step (the channel's slack of
    tests/test_torch_integrators.py: mg's stagnation rule at tol 1e-4)."""
    jc = jmake("channel", shape=(32, 16))
    tc = tmake("channel", shape=(32, 16), device="cpu")
    js_sim = dataclasses.replace(jc.sim, forcing=force)
    ts_sim = tsolver.Simulation.build(tc.sim.grid, tc.sim.bcs,
                                      tc.sim.params, "cpu", forcing=force)
    js, jd = js_sim.run_scan(jc.initial_state(), 5)
    ts, td = ts_sim.run_scan(ts_sim.initial_state(), 5)
    _compare(js, jd, ts, td, 1e-4 * float(np.abs(np.asarray(js.p)).max()),
             slack=1)


@pytest.mark.parametrize("gamma", [0.0, 0.2])
def test_predictor_2d_forcing_matches_jax(gamma):
    """Kernel 8's plain version with forcing volumes (u and v, and v's
    alone) against JAX's ``stencils.predictor`` with ``forcing`` on the
    cylinder's table (inflow, outflow, slip): atol 1e-6 on u* of O(1)."""
    shape = (24, 16)
    jg, tg = jgrid.GridSpec(shape, (3.0, 2.0)), tgrid.GridSpec(shape,
                                                               (3.0, 2.0))
    jb = {(0, 0): jbcs.BCSpec.inflow((1.0, 0.0)),
          (0, 1): jbcs.BCSpec.outflow(), (1, 0): jbcs.BCSpec.slip(),
          (1, 1): jbcs.BCSpec.slip()}
    tb = {(0, 0): tbcs.BCSpec.inflow((1.0, 0.0)),
          (0, 1): tbcs.BCSpec.outflow(), (1, 0): tbcs.BCSpec.slip(),
          (1, 1): tbcs.BCSpec.slip()}
    rng = np.random.default_rng(4)
    u = [rng.normal(size=jg.face_shape(a)).astype(np.float32)
         for a in range(2)]
    f = [rng.normal(size=fused3d.force_shape(tg, (False, False), a))
         .astype(np.float32) for a in range(2)]
    for forcing in (f, [None, f[1]]):
        ref = jst.predictor(jg, jb, tuple(jnp.asarray(c) for c in u), 0.01,
                            0.005, gamma,
                            [None if x is None else jnp.asarray(x)
                             for x in forcing])
        got = predictor2d.predictor_2d(
            tg, tb, tuple(torch.from_numpy(c) for c in u), 0.01, 0.005,
            gamma, forcing=[None if x is None else torch.from_numpy(x)
                            for x in forcing])
        for a in range(2):
            # the boundary faces of the own axis: the kernel keeps its
            # input, JAX's jnp predictor too (the BC pass writes them)
            np.testing.assert_allclose(got[a].numpy(), np.asarray(ref[a]),
                                       rtol=0.0, atol=1e-6)


def _tables_3d(per):
    shape = (16, 8, 8)
    jg, tg = jgrid.GridSpec(shape, (2.0, 0.5, 0.5)), tgrid.GridSpec(
        shape, (2.0, 0.5, 0.5))
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[(2, 1)] = jbcs.BCSpec.wall((1.0, 0.3, 0.0))
    tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    if per:
        jb[(0, 0)] = jb[(0, 1)] = jbcs.BCSpec.periodic()
        tb[(0, 0)] = tb[(0, 1)] = tbcs.BCSpec.periodic()
    return jg, tg, jb, tb


@pytest.mark.heavy
@pytest.mark.parametrize("mode", ["force", "fields"])
@pytest.mark.parametrize("per", [False, True], ids=["walls", "per0"])
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_predictor_rhs_3d_forced_vs_pallas_interpret(gamma, per, mode):
    """Kernel 1's forced mode (its plain version on the CPU) against the
    JAX Pallas kernel in interpret mode: ``forcing`` (a number a
    component) and ``forcing_fields`` (volumes of all three components in
    the forcing layout; JAX's forcing_to_internal_3d pads them): u* rtol =
    atol = 1e-5, the RHS rtol 1e-4 / atol 3e-7 of max|RHS|, on walls with
    a lid and with axis 0 periodic (the duct's PER 1)."""
    jg, tg, jb, tb = _tables_3d(per)
    rng = np.random.default_rng(13)
    ju = jbcs.apply_velocity_bcs(jg, jb, tuple(
        jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(np.float32))
        for a in range(3)))
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    periodic = (per, False, False)
    if mode == "force":
        force, jkw = (0.7, -0.2, 0.3), dict(forcing=(0.7, -0.2, 0.3))
        vols = None
    else:
        fields = [rng.normal(size=fused3d.force_shape(tg, periodic, a))
                  .astype(np.float32) for a in range(3)]
        jkw = dict(forcing_fields=tuple(jnp.asarray(f) for f in fields))
        force, vols = None, convert.force_volumes_from_numpy(tg, periodic,
                                                            fields)
    (o0, o1, o2), j_rhs = jpk.predictor_rhs_3d(
        jg, jb, ju, 1e-3, 0.02, gamma, rho=1.3, tile=8, interpret=True,
        **jkw)
    t_star, t_rhs = fused3d.predictor_rhs_3d(tg, tb, tu, 1e-3, 0.02, gamma,
                                             1.3, force=force,
                                             force_vol=vols)
    n0, n1, n2 = jg.shape
    np.testing.assert_allclose(t_star[0].numpy(),
                               np.asarray(o0[: n0 + 1, :n1, :n2]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_star[1].numpy(),
                               np.asarray(o1[:n0, : n1 + 1, :n2]),
                               rtol=1e-5, atol=1e-5)
    # the internal layout elides comp 2's last face (a BC value)
    np.testing.assert_allclose(t_star[2][:, :, :n2].numpy(),
                               np.asarray(o2[:n0, :n1, :n2]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_rhs.numpy(), np.asarray(j_rhs), rtol=1e-4,
                               atol=3e-7 * float(jnp.max(jnp.abs(j_rhs))))


@pytest.mark.parametrize("per", [False, True], ids=["walls", "per0"])
def test_stencils_predictor_forcing_matches_jax(per):
    """The plain predictor with a number and with a volume a component
    (the forced modes' reference) against JAX's jnp predictor: atol 1e-6
    of u* of O(1)."""
    jg, tg, jb, tb = _tables_3d(per)
    rng = np.random.default_rng(9)
    ju = jbcs.apply_velocity_bcs(jg, jb, tuple(
        jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(np.float32))
        for a in range(3)))
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    vol = rng.normal(size=fused3d.force_shape(tg, (per, False, False), 0)) \
        .astype(np.float32)
    ref = jst.predictor(jg, jb, ju, 1e-3, 0.02, 0.3,
                        (jnp.asarray(vol), 0.5, None))
    got = stencils.predictor(tg, tb, tu, 1e-3, 0.02, 0.3,
                             (torch.from_numpy(vol), 0.5, None))
    for a in range(3):
        np.testing.assert_allclose(got[a].numpy(), np.asarray(ref[a]),
                                   rtol=0.0, atol=1e-6)


def test_duct_exact_profile_persists():
    """JAX's oracle (tests/test_channel.py): the series profile is a steady
    state of the discrete duct to under 1% at a 16x16 cross-section after
    400 steps; the transverse velocities stay zero, max_div < 1e-4."""
    case = tmake("duct_periodic", shape=(32, 16, 16), device="cpu")
    sim = case.sim
    g = sim.grid
    fx = float(sim.forcing[0])
    exact = duct_profile_exact(16, 16, g.lengths[1], g.lengths[2],
                               fx / sim.params.nu)
    st = sim.initial_state()
    u0 = torch.as_tensor(exact, dtype=torch.float32)[None].expand(
        g.face_shape(0)).contiguous()
    u = tbcs.apply_velocity_bcs(g, sim.bcs, (u0, st.u[1], st.u[2]))
    st, d = sim.run_scan(State(u=u, p=st.p), 400)
    uc = st.u[0][:-1].mean(dim=0).numpy()
    rel = np.abs(uc - exact).max() / exact.max()
    assert rel < 0.01, rel
    assert float(d.max_div[-1]) < 1e-4
    assert float(st.u[1].abs().max()) < 1e-5
    assert float(st.u[2].abs().max()) < 1e-5


def test_kolmogorov_laminar_balance_2d():
    """JAX's oracle (tests/test_fused_step.py): low-Re Kolmogorov flow
    (32^2, Re 1, k_f 2) relaxes to the laminar profile, within 2e-3 of the
    discrete amplitude A / (nu lam_h) and 2% of the continuum's, on the
    fused route's forcing volume."""
    case = tmake("kolmogorov", shape=(32, 32), re=1.0, k_forcing=2,
                 device="cpu")
    sim = case.sim
    assert sim.fused and sim.force_vol[0] is not None
    nu, kf = sim.params.nu, 2
    n = int(8.0 / (nu * kf * kf) / sim.params.dt)
    st, diag = sim.run_scan(case.initial_state(), n)
    yc = sim.grid.cell_centers(1).astype(np.float64)
    h = sim.grid.spacing[1]
    u_disc = 1.0 / (nu * (2.0 - 2.0 * np.cos(kf * h)) / (h * h))
    u = st.u[0][:32].numpy()
    err = np.abs(u - u_disc * np.sin(kf * yc)[None, :]).max() / u_disc
    assert err < 2e-3, err
    u_lam = 1.0 / (nu * kf * kf)
    err_c = np.abs(u - (u_lam * np.sin(kf * yc))[None, :]).max() / u_lam
    assert err_c < 0.02, err_c
    assert np.isfinite(float(diag.max_div[-1]))


def test_kolmogorov_3d_matches_jax():
    """JAX's 3D parity case (tests/test_fused_step.py: 16^3, Re 5, k_f 2,
    Euler, 5 steps), kernel 1's forcing volume route against JAX's step:
    atol 5e-5, JAX's fused-against-jnp tolerance."""
    kw = dict(shape=(16, 16, 16), re=5.0, k_forcing=2, integrator="euler")
    jc, tc = jmake("kolmogorov", **kw), tmake("kolmogorov", device="cpu",
                                              **kw)
    assert tc.sim.fused and tc.sim.force_vol[0] is not None
    js, _ = jc.sim.run_scan(jc.initial_state(), 5)
    ts, _ = tc.sim.run_scan(tc.initial_state(), 5)
    for c in range(3):
        np.testing.assert_allclose(ts.u[c].numpy(), np.asarray(js.u[c]),
                                   rtol=0.0, atol=5e-5)


def test_heated_enclosure_energy_balance():
    """JAX's oracle (tests/test_scalar.py; 48^2, Ra 1e6, dt 4e-3): JAX
    runs in windows of 500 steps until the body's heat flux and the
    walls' balance within 0.8%; the port goes on 20 steps from JAX's
    state, and its own diagnostics hold the balance within 1% (the
    oracle's), with the plume rising above the body; its fields stay
    those of JAX's 20 further steps (u, theta atol 1e-5; equal V-cycle
    counts)."""
    jc = jmake("heated_enclosure", shape=(48, 48), ra=1e6, dt=4e-3)
    js_sim = jc.sim
    js = jc.initial_state()
    for _ in range(80):
        js, _ = js_sim.run_scan(js, 500)
        q = float(jbody_heat_flux(js_sim.grid, js_sim.scalar, js.theta,
                                  js_sim.scalar_solid))
        if abs(jwall_heat_flux(js_sim, js.theta) - q) < 8e-3 * abs(q):
            break
    tc = tmake("heated_enclosure", shape=(48, 48), ra=1e6, dt=4e-3,
               device="cpu")
    sim = tc.sim
    ts = convert.state_from_numpy([np.asarray(c) for c in js.u],
                                  np.asarray(js.p),
                                  theta=np.asarray(js.theta))
    js, jd = js_sim.run_scan(js, 20)
    ts, td = sim.run_scan(ts, 20)
    q_body = float(body_heat_flux(sim.grid, sim.scalar, ts.theta,
                                  sim.scalar_solid))
    q_wall = wall_heat_flux(sim, ts.theta)
    assert q_body > 0.0
    np.testing.assert_allclose(q_wall, q_body, rtol=1e-2)
    th = ts.theta.numpy()
    assert th[24, 38] > th[24, 9] + 0.05
    assert float(td.max_div[-1]) < 1e-4
    for c in range(2):
        np.testing.assert_allclose(ts.u[c].numpy(), np.asarray(js.u[c]),
                                   rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(th, np.asarray(js.theta), rtol=0.0, atol=1e-5)
    np.testing.assert_array_equal(td.poisson_iters.numpy(),
                                  np.asarray(jd.poisson_iters))


def test_heated_enclosure_energy_budget_every_step():
    """The energy balance in its conservative form, on the port's step
    from a conduction-like theta (the walls see heat from the first
    step): every step, the heat the fluid cells store, sum(theta' -
    theta) h^2 / dt, equals the body's flux minus the walls'. Each cell's
    update rounds at ulp(1) (theta is O(1)): their sum drifts like a
    random walk, so the bound is 16 sqrt(cells) ulps of 1 times h^2 / dt
    (kernel 5's wrap-conservation bound in chip_smoke.py); a flux lost or
    counted twice at a wall or at the body would be O(q)."""
    tc = tmake("heated_enclosure", shape=(48, 48), ra=1e6, dt=4e-3,
               device="cpu")
    sim = tc.sim
    st = tc.initial_state()
    g = sim.grid
    x = torch.as_tensor(g.cell_centers(0))[:, None]
    y = torch.as_tensor(g.cell_centers(1))[None, :]
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    theta = torch.clamp((0.5 - r) / 0.3, 0.0, 1.0)
    st = dataclasses.replace(st, theta=torch.where(sim.scalar_solid,
                                                   st.theta, theta))
    fluid = ~sim.scalar_solid
    vol = float(np.prod(g.spacing))
    for _ in range(5):
        th0 = st.theta
        q_body = float(body_heat_flux(g, sim.scalar, th0, sim.scalar_solid))
        q_wall = wall_heat_flux(sim, th0)
        st, d = sim.step(st)
        stored = float(((st.theta - th0).double() * fluid).sum()) * vol \
            / float(d.dt)
        assert q_wall > 0.1 * q_body > 0.0
        bound = 16 * np.sqrt(fluid.sum().item()) * 2.0 ** -23 * vol \
            / float(d.dt)
        assert abs(stored - (q_body - q_wall)) <= bound < 0.01 * q_body


def test_forcing_refusals():
    """What stays unported or malformed raises: a force component that
    does not broadcast to its faces (ValueError, as JAX's add), forcing of
    the wrong rank (ValueError), LES with a force on open faces or around
    an obstacle in 3D ('Physics extensions'; on the walls it builds since
    kernel 6's forced mode), a force in the slab tier ('parallel/: the
    explicit-halo solvers and the pencil tier')."""
    from navierstokessolver_tpu_torch.les import LESConfig
    from navierstokessolver_tpu_torch.parallel import (
        make_mesh, sharded_simulation,
    )

    c = tmake("kolmogorov", shape=(16, 16), device="cpu").sim
    with pytest.raises(ValueError, match="does not broadcast"):
        tsolver.Simulation.build(c.grid, c.bcs, c.params, "cpu",
                                 forcing=(np.ones((5, 16)), None))
    with pytest.raises(ValueError, match="wrong rank"):
        tsolver.Simulation.build(c.grid, c.bcs, c.params, "cpu",
                                 forcing=(1.0,))
    box = tmake("cavity3d", shape=(16, 8, 8), device="cpu").sim
    d = tsolver.Simulation.build(box.grid, box.bcs, box.params, "cpu",
                                 forcing=(0.5, None, None))
    assert dataclasses.replace(d, les=LESConfig(cs=0.17)).fused
    open_bcs = dict(box.bcs)
    open_bcs[(0, 0)] = tbcs.BCSpec.inflow((1.0, 0.0, 0.0))
    open_bcs[(0, 1)] = tbcs.BCSpec.outflow()
    o = tsolver.Simulation.build(box.grid, open_bcs, box.params, "cpu",
                                 forcing=(0.5, None, None))
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        dataclasses.replace(o, les=LESConfig(cs=0.17))
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="explicit-halo solvers"):
        sharded_simulation(d, mesh)
