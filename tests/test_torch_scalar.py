"""PyTorch port vs JAX package: the transported scalar (scalar.py).

Held to the JAX package on the CPU with the same numpy-seeded fields:
``pad_scalar`` (every kind of face), ``scalar_rhs`` (upwind gamma 0 and
0.5; no obstacle, an adiabatic body, an isothermal one),
``buoyancy_forcing``, ``body_heat_flux``, the cases' ``hot_wall_nusselt``
and ``wall_heat_flux``, the ghost table of the kernels' thermal modes and
the plain versions those modes are held to on the card (kernels 1, 2, 4
and 5 with theta, against the JAX jnp predictor with the buoyancy forcing
and ``theta + dt*scalar_rhs``). Tolerances: bit-equal where both packages
do the same float32 operations in the same order (the ghosts, the table),
else rtol 1e-5 / atol 1e-6 of the field's scale (float32 roundoff of a
few operations a cell, the division by h amplifying it). Also the build's
refusals, as JAX raises them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import scalar as jsc
from navierstokessolver_tpu.bcs import no_slip_box as jno_slip_box
from navierstokessolver_tpu.cases import make_case as jmake
from navierstokessolver_tpu.cases import convection as jconv
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import scalar as tsc
from navierstokessolver_tpu_torch.cases import convection as tconv
from navierstokessolver_tpu_torch.cases import make_case as tmake
from navierstokessolver_tpu_torch.ops import fused2d, fused3d
from navierstokessolver_tpu_torch.solver import SimParams, Simulation

SHAPES = {2: (16, 12), 3: (8, 6, 10)}


def _jcfg(nd, gamma=0.0, body=None, buoyancy=None, wrap0=False):
    """A JAX ScalarConfig with every face kind: axis 0 wrapped or
    Dirichlet / adiabatic, the others Dirichlet / Dirichlet."""
    bcs = {}
    for a in range(nd):
        if a == 0 and wrap0:
            bcs[(0, 0)] = bcs[(0, 1)] = jsc.ScalarBC.periodic()
        elif a == 0:
            bcs[(0, 0)] = jsc.ScalarBC.dirichlet(1.0)
            bcs[(0, 1)] = jsc.ScalarBC.adiabatic()
        else:
            bcs[(a, 0)] = jsc.ScalarBC.dirichlet(-0.25)
            bcs[(a, 1)] = jsc.ScalarBC.dirichlet(0.75)
    return jsc.ScalarConfig(
        bcs=bcs, diffusivity=0.02,
        buoyancy=buoyancy or tuple(0.3 + a for a in range(nd)),
        theta_ref=0.4, upwind_gamma=gamma, body_bc=body)


def _grids(nd):
    shape = SHAPES[nd]
    lengths = tuple(0.5 + 0.25 * a for a in range(nd))
    return (jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths))


def _fields(nd, seed, wrap0=False):
    """theta of O(1), the velocity of O(1) (face n equal to face 0 on a
    wrap axis 0) and a solid block, as numpy."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[nd]
    theta = rng.random(shape).astype(np.float32)
    u = []
    for a in range(nd):
        s = list(shape)
        s[a] += 1
        c = rng.normal(size=s).astype(np.float32)
        if a == 0 and wrap0:
            c[-1] = c[0]
        u.append(c)
    solid = np.zeros(shape, bool)
    solid[tuple(slice(2, 5) for _ in range(nd))] = True
    return theta, u, solid


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol_scale=1e-6):
    ref = np.asarray(ref)
    atol = atol_scale * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("wrap0", [False, True], ids=["walls", "wrap"])
def test_pad_scalar_and_ghost_table_match_jax(nd, wrap0):
    jg, tg = _grids(nd)
    jc = _jcfg(nd, wrap0=wrap0)
    tc = convert.scalar_config_from_jax(jc)
    theta, _, _ = _fields(nd, 1, wrap0)
    np.testing.assert_array_equal(
        tsc.pad_scalar(tg, tc, _t(theta)).numpy(),
        np.asarray(jsc.pad_scalar(jg, jc, jnp.asarray(theta))))
    assert tsc.theta_ghost_table(tc, nd) == jpk.theta_ghost_table(jc, nd)
    table = tsc.thermal_table(tc, nd, "cpu")
    assert table.shape == (tsc.thermal_table_size(nd),)
    assert tsc.wrap_mask(tc, nd) == int(wrap0)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("gamma", [0.0, 0.5])
@pytest.mark.parametrize("body", [None, "adiabatic", "isothermal"])
def test_scalar_rhs_matches_jax(nd, gamma, body):
    jg, tg = _grids(nd)
    jbody = {None: None, "adiabatic": jsc.ScalarBC.adiabatic(),
             "isothermal": jsc.ScalarBC.dirichlet(1.5)}[body]
    jc = _jcfg(nd, gamma, jbody)
    tc = convert.scalar_config_from_jax(jc)
    theta, u, solid = _fields(nd, 2)
    jsolid = None if body is None else jnp.asarray(solid)
    tsolid = None if body is None else _t(solid)
    ref = jsc.scalar_rhs(jg, jc, tuple(jnp.asarray(c) for c in u),
                         jnp.asarray(theta), solid=jsolid)
    got = tsc.scalar_rhs(tg, tc, tuple(_t(c) for c in u), _t(theta),
                         solid=tsolid)
    _close(got.numpy(), ref)
    if body is not None:
        np.testing.assert_array_equal(
            tsc.freeze_body(tc, _t(theta), tsolid).numpy(),
            np.asarray(jsc.freeze_body(jc, jnp.asarray(theta), jsolid)))
        _close(float(tsc.body_heat_flux(tg, tc, _t(theta), tsolid)),
               float(jsc.body_heat_flux(jg, jc, jnp.asarray(theta), jsolid)))


@pytest.mark.parametrize("nd", [2, 3])
def test_buoyancy_forcing_matches_jax(nd):
    jg, tg = _grids(nd)
    buoy = (0.0, 1.0) if nd == 2 else (0.3, 0.0, 1.0)
    jc = _jcfg(nd, buoyancy=buoy)
    tc = convert.scalar_config_from_jax(jc)
    theta, _, _ = _fields(nd, 3)
    ref = jsc.buoyancy_forcing(jg, jc, jnp.asarray(theta))
    got = tsc.buoyancy_forcing(tg, tc, _t(theta))
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    passive = convert.scalar_config_from_jax(_jcfg(nd, buoyancy=(0.0,) * nd))
    assert tsc.buoyancy_forcing(tg, passive, _t(theta)) is None


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_thermal_plain_versions_match_jax(nd, gamma):
    """What the thermal kernel modes are held to on the card, against
    JAX's jnp predictor (BC pass, buoyancy forcing of theta) and
    ``theta + dt*scalar_rhs`` after the correction: the predictor wrapper
    (on the CPU, its plain version) with theta, then the corrector wrapper
    advancing theta."""
    jg, tg = _grids(nd)
    buoy = (0.0, 1.0) if nd == 2 else (0.3, 0.0, 1.0)
    jc = _jcfg(nd, gamma, buoyancy=buoy)
    tc = convert.scalar_config_from_jax(jc)
    theta, u, _ = _fields(nd, 4)
    from navierstokessolver_tpu import bcs as jbcs

    jb, tb = jno_slip_box(jg), tbcs.no_slip_box(tg)
    ju = jbcs.apply_velocity_bcs(jg, jb, tuple(jnp.asarray(0.1 * c)
                                               for c in u))
    tu = tuple(_t(c) for c in ju)
    dt, nu, rho = 1e-3, 0.02, 1.3
    forcing = jsc.buoyancy_forcing(jg, jc, jnp.asarray(theta))
    j_star = jbcs.apply_velocity_bcs(
        jg, jb, jst.predictor(jg, jb, ju, dt, nu, gamma, forcing))
    wrapper = fused2d.predictor_rhs_2d if nd == 2 else fused3d.predictor_rhs_3d
    t_star, _ = wrapper(tg, tb, tu, dt, nu, gamma, rho, theta=_t(theta),
                        scalar=tc)
    for a in range(nd):
        _close(t_star[a].numpy(), j_star[a])
    rng = np.random.default_rng(5)
    p = (0.01 * rng.normal(size=SHAPES[nd])).astype(np.float32)
    j_new = jst.correct_velocity(jg, j_star, jnp.asarray(p), dt / rho)
    j_theta = jnp.asarray(theta) + dt * jsc.scalar_rhs(jg, jc, j_new,
                                                       jnp.asarray(theta))
    corr = fused2d.correct_diag_2d if nd == 2 else fused3d.correct_diag_3d
    t_new, _, _, t_theta = corr(tg, tuple(_t(c) for c in j_star), _t(p),
                                dt / rho, theta=_t(theta), scalar=tc, dt=dt)
    _close(t_theta.numpy(), j_theta)


@pytest.mark.parametrize("name,kw", [
    ("heated_cavity", dict(shape=(16, 16), ra=1e3)),
    ("heated_cavity", dict(shape=(8, 8, 8), ra=1e4)),
    ("rayleigh_benard", dict(shape=(16, 8), ra=5e3)),
], ids=["cavity2d", "cavity3d", "rayleigh_benard"])
def test_case_diagnostics_match_jax(name, kw):
    """The cases' own diagnostics on the same field: hot_wall_nusselt and
    wall_heat_flux (rtol 1e-5: float32 means in other summation orders)."""
    jc, tc = jmake(name, **kw), tmake(name, device="cpu", **kw)
    theta = np.random.default_rng(6).random(kw["shape"]).astype(np.float32)
    np.testing.assert_allclose(
        tconv.hot_wall_nusselt(tc.sim, _t(theta)),
        jconv.hot_wall_nusselt(jc.sim, jnp.asarray(theta)), rtol=1e-5)
    np.testing.assert_allclose(
        tconv.wall_heat_flux(tc.sim, _t(theta)),
        jconv.wall_heat_flux(jc.sim, jnp.asarray(theta)), rtol=1e-5)


def _cavity_parts(shape=(16, 16), periodic0=False):
    g = tgrid.GridSpec(shape, (1.0, 1.0))
    b = tbcs.no_slip_box(g)
    if periodic0:
        b[(0, 0)] = b[(0, 1)] = tbcs.BCSpec.periodic()
    return g, b, SimParams(dt=1e-3, nu=0.01)


def test_build_refusals():
    """As JAX's build: buoyancy along a periodic axis, an obstacle without
    body_bc (ValueError); and an array Dirichlet value, which the port does
    not take ('Physics extensions')."""
    g, b, pr = _cavity_parts(periodic0=True)
    sc_bcs = {(0, 0): tsc.ScalarBC.periodic(), (0, 1): tsc.ScalarBC.periodic(),
              (1, 0): tsc.ScalarBC.dirichlet(1.0),
              (1, 1): tsc.ScalarBC.dirichlet(0.0)}
    with pytest.raises(ValueError, match="buoyancy along a periodic axis"):
        Simulation.build(g, b, pr, "cpu", scalar=tsc.ScalarConfig(
            bcs=sc_bcs, diffusivity=0.01, buoyancy=(1.0, 0.0)))
    g, b, pr = _cavity_parts()
    adiabatic = {(a, s): tsc.ScalarBC.adiabatic()
                 for a in range(2) for s in (0, 1)}
    solid = np.zeros(g.shape, bool)
    solid[5:9, 5:9] = True
    pr_mg = dataclasses.replace(
        pr, poisson=dataclasses.replace(pr.poisson, method="mg"))
    with pytest.raises(ValueError, match="needs scalar.body_bc"):
        Simulation.build(g, b, pr_mg, "cpu", solid=solid,
                         scalar=tsc.ScalarConfig(bcs=adiabatic,
                                                 diffusivity=0.01))
    arr = dict(adiabatic)
    arr[(0, 0)] = tsc.ScalarBC.dirichlet(np.linspace(0.0, 1.0, g.shape[1]))
    with pytest.raises(NotImplementedError, match="'Physics extensions'"):
        Simulation.build(g, b, pr, "cpu",
                         scalar=tsc.ScalarConfig(bcs=arr, diffusivity=0.01))
    with pytest.raises(ValueError, match="PERIODIC scalar BC on one side"):
        one_side = dict(adiabatic)
        one_side[(1, 0)] = tsc.ScalarBC.periodic()
        Simulation.build(g, b, pr, "cpu", scalar=tsc.ScalarConfig(
            bcs=one_side, diffusivity=0.01))


@pytest.mark.parametrize("name,needs", [
    ("heated_enclosure", "array force"),
    ("oscillating_lid", "time-dependent BC values")])
def test_unported_convection_neighbours_name_their_item(name, needs):
    """The convection slice's neighbours raised 'Physics extensions'
    naming what they needed (an array force on the unfused route,
    time-dependent BC values) until the forcing slice ported it: they
    build now, with what they needed."""
    kw = dict(shape=(8, 8, 8)) if name == "oscillating_lid" else dict(
        shape=(16, 16))
    sim = tmake(name, device="cpu", **kw).sim
    if needs == "array force":
        assert not sim.fused and sim.scalar.buoyant
        f = sim._unfused_forcing(None, sim.initial_state().theta, False)
        assert f[0] is None and tuple(f[1].shape) == (16, 15)
    else:
        assert sim.fused and sim.time_dependent


def test_buoyant_scalar_on_the_unfused_route_raises():
    """A buoyant scalar with an obstacle (heated_enclosure's physics) runs
    the unfused route: it raised while the predictor kernel had no force
    mode; since the forcing slice its buoyancy is a forcing volume of
    kernel 8, and the kernel route (the plain versions here) equals
    step_plain over three steps, the hot body's plume starting."""
    g, b, pr = _cavity_parts((32, 32))
    pr = dataclasses.replace(
        pr, poisson=dataclasses.replace(pr.poisson, method="mg"))
    solid = np.zeros(g.shape, bool)
    solid[12:20, 12:20] = True
    cfg = tsc.ScalarConfig(
        bcs={(a, s): tsc.ScalarBC.dirichlet(0.0)
             for a in range(2) for s in (0, 1)},
        diffusivity=0.01, buoyancy=(0.0, 1.0),
        body_bc=tsc.ScalarBC.dirichlet(1.0))
    sim = Simulation.build(g, b, pr, "cpu", solid=solid, scalar=cfg)
    assert not sim.fused
    sk = sp = sim.initial_state()
    for _ in range(3):
        sk, _ = sim.step(sk)
        sp, _ = sim.step_plain(sp)
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=0.0, atol=0.0)
    torch.testing.assert_close(sk.theta, sp.theta, rtol=0.0, atol=0.0)
    assert float(sk.u[1].abs().max()) > 0.0
