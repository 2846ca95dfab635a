"""PyTorch port vs JAX package: the LES step beyond the walls, on the CPU.

The port's LES route on periodic axes and on open faces with an obstacle
(kernels 6-7's periodic and open modes, kernel 2's periodic, open and
masked modes; their plain versions run here on CPU tensors) against the
JAX package's own CPU run (its jnp LES step: ``stencils.predictor`` with
``les.sgs_forcing``, the BC pass with the face masks, ``_project``) from
the same numpy-seeded state:

  * ``taylor_green3d`` at 16^3 (every axis periodic), the static and the
    dynamic Smagorinsky model;
  * the sphere at 32x16x16 (INFLOW, four SLIP faces and an OUTFLOW or a
    CONVECTIVE outlet, the staircase obstacle's masks, dctcg) from the
    impulsive start;
  * a 3D box of INFLOW, SLIP and OUTFLOW faces without an obstacle (fft).

Each runs 5 Euler steps, 5 rk2 steps and 5 steps at cfl 0.4 under a cap
of 10x the case's dt (the CFL dt binds). u agrees within 1e-5 of max|u|,
p within 1e-4 of max|p|, max_div within rtol 1e-3 / atol 1e-6 (the
sphere tests' bound), the dt series within rtol 3e-5, and the iteration
counts are equal (dctcg within ``COUNT_SLACK``: a Richardson stopping
test at float32's floor, as in tests/test_torch_sphere.py).

The kernel module's wrappers on CPU tensors are held to the JAX jnp
composition (``les.eddy_viscosity``; ``stencils.predictor`` with
``les.sgs_forcing``, then the BC pass with the face masks) with the
tolerances of tests/test_torch_predictor3d.py (nu_t within 2e-6 of
max nu_t, u* atol 5e-5) on a periodic, an open and a masked table, and
(``heavy``) to the JAX Pallas kernels in interpret mode on a periodic
table whose axis 2 holds 128 cells (JAX's lane wrap needs n2 % 128 == 0)
and on an open one. Each JAX reference of the kernel checks is one jitted
program.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import les as jles
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu.ops.poisson import PoissonConfig as JaxPoisson
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import fused3d, predictor3d
from navierstokessolver_tpu_torch.ops.poisson import (
    PoissonConfig, build_poisson_op,
)

CPU = torch.device("cpu")
CS = 0.17
SPHERE = dict(shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0))
# the dctcg sphere's counts may differ by one sweep a step where a
# relative residual sits at float32's floor (tests/test_torch_sphere.py)
COUNT_SLACK = {"fft": 0, "dctcg": 1}
INTEGRATORS = ("euler", "rk2", "cfl")


def _with_les(jsim, tsim, model="smagorinsky", integrator="euler"):
    """Both simulations with the LES closure (as both CLIs add it:
    dataclasses.replace) and the step's integrator: rk2, or cfl 0.4 under
    a cap of 10x the case's dt."""
    jp, tp = jsim.params, tsim.params
    if integrator == "rk2":
        jp = dataclasses.replace(jp, integrator="rk2")
        tp = dataclasses.replace(tp, integrator="rk2")
    elif integrator == "cfl":
        jp = dataclasses.replace(jp, cfl=0.4, dt=10 * jp.dt)
        tp = dataclasses.replace(tp, cfl=0.4, dt=10 * tp.dt)
    jcfg = jles.LESConfig(cs=CS, model=model)
    return (dataclasses.replace(jsim, les=jcfg, params=jp),
            dataclasses.replace(tsim, les=convert.les_config_from_jax(jcfg),
                                params=tp))


def _to_port(st):
    return convert.state_from_numpy(
        [np.asarray(c) for c in st.u], np.asarray(st.p), CPU,
        p_prev=None if st.p_prev is None else np.asarray(st.p_prev))


def _check_run(jr, tr, slack, cfl_cap=None):
    """Final fields and per-step diagnostics of two run_scan results."""
    (js, jd), (ts, td) = jr, tr
    u_max = max(float(np.abs(np.asarray(c)).max()) for c in js.u)
    for a in range(3):
        np.testing.assert_allclose(ts.u[a].numpy(), np.asarray(js.u[a]),
                                   rtol=0.0, atol=1e-5 * u_max)
    p_max = float(np.abs(np.asarray(js.p)).max())
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0.0,
                               atol=1e-4 * p_max)
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    diff = np.abs(td.poisson_iters.numpy().astype(int)
                  - np.asarray(jd.poisson_iters).astype(int))
    assert diff.max() <= slack, (td.poisson_iters, jd.poisson_iters)
    if cfl_cap is not None:
        assert float(td.dt.min()) < 0.9 * cfl_cap     # the CFL dt binds


@pytest.mark.parametrize("model", ["smagorinsky", "dynamic"])
def test_taylor_green3d_les_matches_jax(model):
    """``--case taylor_green3d --les-cs 0.17`` at 16^3 (Re 1600, every axis
    periodic: kernels 6-7's periodic mode, kernel 2's wrap), Euler, rk2 and
    cfl 0.4, 5 steps each, against JAX's jnp LES step."""
    jc = jax_make_case("taylor_green3d", shape=(16, 16, 16))
    tc = make_case("taylor_green3d", shape=(16, 16, 16), device="cpu")
    for integrator in INTEGRATORS:
        jsim, tsim = _with_les(jc.sim, tc.sim, model, integrator)
        assert tsim.fused and all(tsim.op.periodic)
        st = jc.initial_state()
        _check_run(jsim.run_scan(st, 5), tsim.run_scan(_to_port(st), 5),
                   COUNT_SLACK["fft"],
                   jsim.params.dt if integrator == "cfl" else None)


@pytest.mark.parametrize("outlet", ["outflow", "convective"])
def test_sphere_les_matches_jax(outlet):
    """The sphere's LES (INFLOW, SLIP faces and the outlet, an OUTFLOW or
    a CONVECTIVE face; the obstacle's masks: kernels 6-7's open modes, the
    masked predictor; the RHS on fluid cells, kernel 2's masked mode, and
    its convective variant with the face transported after each stage's
    predictor; dctcg) from the impulsive start, Euler, rk2 and cfl 0.4, 5
    steps each."""
    kw = dict(SPHERE, outlet=outlet)
    jc, tc = jax_make_case("sphere", **kw), make_case("sphere", device="cpu",
                                                      **kw)
    for integrator in INTEGRATORS:
        jsim, tsim = _with_les(jc.sim, tc.sim, integrator=integrator)
        assert tsim.face_masks is not None and tsim._code is not None
        st = jax_impulsive_start(jsim)
        _check_run(jsim.run_scan(st, 5), tsim.run_scan(_to_port(st), 5),
                   COUNT_SLACK["dctcg"],
                   jsim.params.dt if integrator == "cfl" else None)


def _open_box():
    """A 3D box of INFLOW (with tangential components), SLIP and OUTFLOW
    faces, a resting and a moving wall, no obstacle; fft; a seeded
    BC-consistent random start (JAX state)."""
    shape, lengths = (16, 12, 8), (2.0, 1.5, 1.0)
    faces = {(0, 0): ("inflow", (1.0, 0.1, -0.2)), (0, 1): ("outflow", ()),
             (1, 0): ("slip", ()), (1, 1): ("outflow", ()),
             (2, 0): ("wall", (0.0, 0.0, 0.0)),
             (2, 1): ("wall", (0.4, -0.3, 0.0))}

    def table(mod):
        return {f: mod.BCSpec(mod.BCKind(k), v) for f, (k, v) in faces.items()}

    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    kw = dict(dt=2e-3, nu=0.01, upwind_gamma=0.3)
    jsim = jsolver.Simulation.build(jg, table(jbcs), jsolver.SimParams(
        poisson=JaxPoisson(method="fft"), **kw))
    tsim = tsolver.Simulation.build(tg, table(tbcs), tsolver.SimParams(
        poisson=PoissonConfig(method="fft"), **kw), CPU)
    rng = np.random.default_rng(11)
    u = jbcs.apply_velocity_bcs(jg, jsim.bcs, tuple(
        rng.normal(size=jg.face_shape(a)).astype(np.float32)
        for a in range(3)))
    return jsim, tsim, jsolver.State(u=u, p=np.zeros(shape, np.float32))


def test_open_box_les_matches_jax():
    """INFLOW, SLIP and OUTFLOW faces without an obstacle (kernels 6-7's
    open mode: the faces' kinds from the bc buffer, the OUTFLOW copies in
    the predictor), Euler, rk2 and cfl 0.4, 5 steps each; the outflow
    faces copy their inner face."""
    jsim0, tsim0, st = _open_box()
    for integrator in INTEGRATORS:
        jsim, tsim = _with_les(jsim0, tsim0, integrator=integrator)
        tr = tsim.run_scan(_to_port(st), 5)
        _check_run(jsim.run_scan(st, 5), tr, COUNT_SLACK["fft"],
                   jsim.params.dt if integrator == "cfl" else None)
        u = tr[0].u
        assert torch.equal(u[0][-1], u[0][-2])
        assert torch.equal(u[1][:, -1], u[1][:, -2])


# -- the kernel module's wrappers ---------------------------------------------

DT, NU = 1e-3, 0.05
CFG = jles.LESConfig(cs=0.2)


def _periodic_table(mod, g):
    """Axes 0 and 2 periodic, walls on axis 1, the high one moving."""
    b = mod.no_slip_box(g)
    b[(1, 1)] = mod.BCSpec.wall((0.7, 0.0, 0.2))
    for a in (0, 2):
        b[(a, 0)] = b[(a, 1)] = mod.BCSpec.periodic()
    return b


def _open_table(mod, g, w_in=-0.2):
    """Every open kind, an OUTFLOW face at the low side of axis 2 and at
    the high sides of axes 0 and 1 (the predictor's three ways of copying
    an inner face); ``w_in``: the inflow's axis-2 component."""
    return {(0, 0): mod.BCSpec.inflow((1.0, 0.1, w_in)),
            (0, 1): mod.BCSpec.outflow(),
            (1, 0): mod.BCSpec.slip(), (1, 1): mod.BCSpec.outflow(),
            (2, 0): mod.BCSpec.outflow(),
            (2, 1): mod.BCSpec.wall((0.4, -0.3, 0.0))}


def _solid(shape):
    """Blocks beside the outflow faces, the slip face and the moving wall,
    an interior block and an isolated cell."""
    solid = np.zeros(shape, bool)
    n0, n1, n2 = shape
    solid[n0 - 3:, 2:5, 3:7] = True
    solid[4:7, :3, n2 // 2:n2 // 2 + 3] = True
    solid[n0 // 2:n0 // 2 + 3, n1 // 2:n1 // 2 + 3, n2 - 3:] = True
    solid[2:4, 4:6, :2] = True
    solid[9, n1 - 1, 1] = True
    return solid


TABLES = {"periodic": ((12, 10, 16), (1.2, 1.0, 1.6), _periodic_table),
          "open": ((14, 11, 13), (1.4, 1.1, 1.3), _open_table),
          "masked": ((14, 11, 13), (1.4, 1.1, 1.3), _open_table)}


def _setup(name, seed=1):
    shape, lengths, table = TABLES[name]
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb, tb = table(jbcs, jg), table(tbcs, tg)
    solid = _solid(shape) if name == "masked" else None
    fm = None if solid is None else jbcs.face_masks_from_solid(jg, solid)
    rng = np.random.default_rng(seed)
    u = tuple(rng.normal(size=jg.face_shape(a)).astype(np.float32)
              for a in range(3))
    ju = jax.jit(lambda v: jbcs.apply_velocity_bcs(jg, jb, v, fm))(u)
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    code = (None if solid is None
            else build_poisson_op(tg, tb, CPU, solid).code)
    return jg, tg, jb, tb, fm, code, ju, tu


def _close_nu_t(got, ref):
    scale = float(jnp.max(ref))
    assert scale > 0.0
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 2e-6 * scale


@pytest.mark.parametrize("name", list(TABLES))
def test_les_wrappers_vs_jnp(name):
    """nu_t_3d and predictor_3d on CPU tensors (their plain versions) on a
    periodic, an open and a masked table, gamma 0.3, against JAX's jnp LES
    predictor with the BC pass and the face masks, every face compared."""
    jg, tg, jb, tb, fm, code, ju, tu = _setup(name)
    tcfg = convert.les_config_from_jax(CFG)

    def jnp_route(u):
        nt = jles.eddy_viscosity(jg, jb, u, CFG)
        forcing = jles.sgs_forcing(jg, jb, u, CFG, nu_t=nt)
        return nt, jbcs.apply_velocity_bcs(jg, jb, jst.predictor(
            jg, jb, u, jnp.float32(DT), NU, 0.3, forcing=forcing), fm)

    j_nt, ref = jax.jit(jnp_route)(ju)
    before = dict(predictor3d.LAUNCHES)
    t_nt = predictor3d.nu_t_3d(tg, tb, tu, tcfg)
    got = predictor3d.predictor_3d(tg, tb, tu, DT, NU, 0.3, nu_t=t_nt,
                                   code=code)
    assert predictor3d.LAUNCHES == before    # CPU tensors: plain versions
    _close_nu_t(t_nt, j_nt)
    for a in range(3):
        np.testing.assert_allclose(got[a].numpy(), np.asarray(ref[a]),
                                   rtol=0.0, atol=5e-5)
    # off the walls the predictor takes the LES term only
    with pytest.raises(ValueError, match="LES term only"):
        predictor3d.predictor_3d(tg, tb, tu, DT, NU, 0.3, code=code)


@pytest.mark.heavy
def test_les_kernels_vs_pallas_interpret():
    """nu_t_3d and predictor_3d (their plain versions) against JAX's
    Pallas kernels in interpret mode (nu_t_3d_from_canon,
    predictor_3d_from_canon with nt_canon_3d, then JAX's BC pass) on a
    periodic table with axis 2 of 128 cells (JAX's lane wrap) and on an
    open one, gamma 0.3. The open table's inflow has no axis-2 component:
    JAX's kernel gives u2's elided face n2 its face value in the axis-0
    ghost plane too, where JAX's jnp route (and the port) reflects it
    across the inflow, 2 w_in - u2; the two agree where w_in = 0."""
    for name, shape in (("periodic", (8, 6, 128)), ("open", (10, 9, 12))):
        lengths = tuple(0.1 * n for n in shape)
        table = TABLES[name][2]
        if name == "open":
            table = functools.partial(table, w_in=0.0)
        jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape,
                                                                lengths)
        jb, tb = table(jbcs, jg), table(tbcs, tg)
        assert jpk.predictor_3d_applicable(jg, jb)
        rng = np.random.default_rng(4)
        u = [rng.normal(size=jg.face_shape(a)).astype(np.float32)
             for a in range(3)]
        for a, per in enumerate(jbcs.periodic_axes(jg, jb)):
            if per:     # face n repeats face 0, as a step keeps it
                np.copyto(np.moveaxis(u[a], a, 0)[-1],
                          np.moveaxis(u[a], a, 0)[0])
        scale = CFG.cs ** 2 * CFG.filter_width(jg) ** 2

        def pallas_route(v):
            v = jbcs.apply_velocity_bcs(jg, jb, v)
            canon = jpk.build_canon_3d(jg, jb, v, tile=8)
            nt = jpk.nu_t_3d_from_canon(jg, jb, canon, scale, tile=8,
                                        interpret=True)
            star = jpk.predictor_3d_from_canon(
                jg, jb, canon, DT, NU, 0.3, 8, True,
                nt_canon=jpk.nt_canon_3d(jg, jb, nt, tile=8))
            return v, nt, jbcs.apply_velocity_bcs(jg, jb, star)

        ju, j_nt, ref = jax.jit(pallas_route)(u)
        tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
        t_nt = predictor3d.nu_t_3d(tg, tb, tu,
                                   convert.les_config_from_jax(CFG))
        _close_nu_t(t_nt, j_nt)
        got = predictor3d.predictor_3d(tg, tb, tu, DT, NU, 0.3, nu_t=t_nt)
        for a in range(3):
            np.testing.assert_allclose(got[a].numpy(), np.asarray(ref[a]),
                                       rtol=0.0, atol=5e-5)

