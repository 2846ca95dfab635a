"""PyTorch port vs JAX package: LES with a body force, with a scalar and
in 2D, on the CPU.

The port's 2D LES (the unfused route: the plain subgrid stress of each
stage's field added to the step's force and handed to the predictor kernel
8 as forcing volumes, its wrap modes on a periodic axis) and its 3D LES
with a force or a transported scalar (kernel 6's forced mode, kernel 2's
thermal modes; their plain versions run here on CPU tensors) against the
JAX package's own CPU run (its jnp step: ``_predict`` with
``les.sgs_forcing`` merged into the force, ``stencils.predictor``, the BC
pass, ``_project``, theta advanced after the projection) from the same
numpy-seeded state:

  * ``decaying_turbulence`` 32^2 with ``les_cs=0.2`` (rk2, 10 steps) and
    ``les_model="dynamic"`` (5 steps); 2D ``kolmogorov`` 32^2 and the 2D
    ``cavity`` with LES (``--les-cs``: ``dataclasses.replace``);
  * a 2D channel periodic in x past a block (no LES: the table that ran
    only in ``step_plain`` before kernel 8's wrap modes), 10 steps;
  * ``duct_periodic`` 16x8x8 with LES (Euler and rk2), 3D ``kolmogorov``
    16^3 (rk2), 3D ``heated_cavity`` 16^3 at Ra 1e6 (Euler and rk2) and the
    heated sphere 32x16x16 (Euler; a passive theta, the masked thermal
    corrector).

u agrees within 1e-5 of max|u|, p within 1e-4 of max|p|, max_div within
rtol 1e-3 / atol 1e-6, the dt series within rtol 3e-5
(tests/test_torch_les_bcs.py's bounds), theta within rtol 2e-5 / atol 2e-6
(tests/test_torch_heated3d.py's), and the pressure solves' counts are
equal (the multigrid ones within ``COUNT_SLACK``: a V-cycle's stopping
test at float32's floor, as in tests/test_torch_heated3d.py).

The plain closure in 2D (``les.eddy_viscosity``, ``les.dynamic_cs2``,
``les.sgs_forcing``) is held to JAX's on a periodic and a walled table
within 2e-6 of the reference's maximum, and the kernels' plain versions
(kernel 8's on periodic tables with and without a forcing volume, kernel
6's forced mode: a static force, a volume, buoyancy) to JAX's jnp
``stencils.predictor`` with the same forcing within 2e-6 of max|u*| on
the faces the kernels own. The cases loop inside one test a purpose
(``_each_case``), which names every failing case.
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import les as jles
from navierstokessolver_tpu import scalar as jsc
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.ops import fused3d, predictor2d, predictor3d

CPU = torch.device("cpu")
CS = 0.2
# the multigrid solves stop at float32's floor: one V-cycle apart a step
COUNT_SLACK = {"fft": 0, "mg": 1, "dctcg": 1}


def _each_case(cases, check) -> None:
    """``check(*case)`` for every case, then one assertion naming every
    case that failed."""
    failed = []
    for case in cases:
        try:
            check(*case)
        except AssertionError as e:
            lines = [x for x in str(e).splitlines() if x.strip()]
            failed.append(f"{case[0]}: {' | '.join(lines[:6])}")
    assert not failed, "\n".join(failed)


def _to_port(st):
    """A JAX state as the port's, on the CPU (theta and p_prev too)."""
    def opt(x):
        return None if x is None else np.asarray(x)
    return convert.state_from_numpy(
        [np.asarray(c) for c in st.u], np.asarray(st.p), CPU,
        p_prev=opt(st.p_prev), theta=opt(st.theta))


def _check_run(jr, tr, slack):
    """Final fields and per-step diagnostics of two run_scan results."""
    (js, jd), (ts, td) = jr, tr
    u_max = max(float(np.abs(np.asarray(c)).max()) for c in js.u)
    for a, c in enumerate(js.u):
        np.testing.assert_allclose(ts.u[a].numpy(), np.asarray(c), rtol=0.0,
                                   atol=1e-5 * u_max, err_msg=f"u[{a}]")
    p_max = float(np.abs(np.asarray(js.p)).max())
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0.0,
                               atol=1e-4 * p_max, err_msg="p")
    if js.theta is not None:
        np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta),
                                   rtol=2e-5, atol=2e-6, err_msg="theta")
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6, err_msg="max_div")
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5,
                               err_msg="dt")
    diff = np.abs(td.poisson_iters.numpy().astype(int)
                  - np.asarray(jd.poisson_iters).astype(int))
    assert diff.max() <= slack, (td.poisson_iters, jd.poisson_iters)


def _with_les(jsim, tsim, model="smagorinsky", integrator=None):
    """Both simulations with the LES closure as both CLIs add it
    (``dataclasses.replace``), and ``integrator`` where given."""
    jcfg = jles.LESConfig(cs=CS, model=model)
    kw_j, kw_t = {"les": jcfg}, {"les": convert.les_config_from_jax(jcfg)}
    if integrator is not None:
        kw_j["params"] = dataclasses.replace(jsim.params,
                                             integrator=integrator)
        kw_t["params"] = dataclasses.replace(tsim.params,
                                             integrator=integrator)
    return (dataclasses.replace(jsim, **kw_j),
            dataclasses.replace(tsim, **kw_t))


def _run_both(jsim, tsim, st, n):
    return jsim.run_scan(st, n), tsim.run_scan(_to_port(st), n)


def _perturbed(jsim, st, seed, amp=0.1):
    """``st`` plus a seeded perturbation with the BC values (face n equal
    to face 0 on a periodic axis): a start with strain and pressure where
    the case's own starts from rest."""
    g = jsim.grid
    per = tuple(jsim.bcs[(a, 0)].kind is jbcs.BCKind.PERIODIC
                for a in range(g.ndim))
    u = tuple(np.asarray(c) + amp * x
              for c, x in zip(st.u, _seeded_u(g, per, seed, smooth=1)))
    return dataclasses.replace(st, u=jbcs.apply_velocity_bcs(
        g, jsim.bcs, u, jsim.face_masks))


# -- the plain closure in 2D --------------------------------------------------


def _table_2d(mod, g, periodic):
    """A periodic box, or walls with a moving lid and a moving side."""
    if periodic:
        return {(a, s): mod.BCSpec.periodic() for a in range(2)
                for s in (0, 1)}
    b = mod.no_slip_box(g)
    b[(1, 1)] = mod.BCSpec.wall((1.0, 0.0))
    b[(0, 0)] = mod.BCSpec.wall((0.0, -0.3))
    return b


def _seeded_u(g, per, seed, smooth=0):
    """A seeded velocity, face n equal to face 0 on a periodic axis;
    ``smooth`` passes of the [1/4, 1/2, 1/4] filter along every axis."""
    rng = np.random.default_rng(seed)
    out = []
    for a in range(g.ndim):
        c = rng.normal(size=g.face_shape(a))
        for _ in range(smooth):
            for ax in range(g.ndim):
                c = 0.25 * (np.roll(c, 1, ax) + 2 * c + np.roll(c, -1, ax))
        c = c.astype(np.float32)
        if per[a]:
            idx = [slice(None)] * g.ndim
            idx[a] = -1
            src = [slice(None)] * g.ndim
            src[a] = 0
            c[tuple(idx)] = c[tuple(src)]
        out.append(c)
    return out


def test_les_closure_2d_matches_jax():
    """``eddy_viscosity`` (static and dynamic), ``dynamic_cs2`` (its test
    filter and global sums) and ``sgs_forcing`` on a 2D periodic and a 2D
    walled table, against JAX's, within 2e-6 of the reference's max."""
    def check(name, periodic, seed):
        shape, lengths = (24, 20), (2.0, 1.5)
        jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape,
                                                                lengths)
        jb, tb = _table_2d(jbcs, jg, periodic), _table_2d(tbcs, tg, periodic)
        u = _seeded_u(jg, (periodic, periodic), seed, smooth=1)
        ju, tu = tuple(u), tuple(torch.as_tensor(c) for c in u)
        for model in ("smagorinsky", "dynamic"):
            jcfg = jles.LESConfig(cs=0.17, model=model)
            tcfg = convert.les_config_from_jax(jcfg)
            pairs = [(tles.eddy_viscosity(tg, tb, tu, tcfg),
                      jles.eddy_viscosity(jg, jb, ju, jcfg))]
            pairs += list(zip(tles.sgs_forcing(tg, tb, tu, tcfg),
                              jles.sgs_forcing(jg, jb, ju, jcfg)))
            if model == "dynamic":
                # a smoothed seeded field with forward scatter: Cs^2 > 0
                pairs.append((tles.dynamic_cs2(tg, tb, tu, tcfg).reshape(1),
                              np.asarray(jles.dynamic_cs2(
                                  jg, jb, ju, jcfg)).reshape(1)))
                assert float(pairs[-1][1][0]) > 0.0
            for got, ref in pairs:
                ref = np.asarray(ref)
                assert tuple(got.shape) == ref.shape
                np.testing.assert_allclose(
                    got.numpy(), ref, rtol=0.0,
                    atol=2e-6 * float(np.abs(ref).max()), err_msg=model)

    _each_case([("periodic", True, 1), ("walls", False, 1)], check)


# -- the plain versions of kernels 8 and 6 -------------------------------------


def test_predictor_plain_versions_match_jnp():
    """Kernel 8's plain version on periodic rows, lanes and both (with and
    without a forcing volume; gamma 0 and 0.8) and kernel 6's forced mode
    (``predictor_3d`` on CPU tensors: a static force, a volume, the
    buoyancy of theta, with nu_t; walls and periodic masks) against JAX's
    jnp ``stencils.predictor`` with the same forcing (``f + sgs``), on the
    faces the kernels own, within 2e-6 of max|u*|."""
    dt, nu = 1e-3, 0.02

    def close(got, ref, per):
        for a, (x, y) in enumerate(zip(got, ref)):
            x, y = x.numpy(), np.asarray(y)
            if not per[a]:
                idx = [slice(None)] * y.ndim
                idx[a] = slice(1, -1)
                x, y = x[tuple(idx)], y[tuple(idx)]
            np.testing.assert_allclose(
                x, y, rtol=0.0, atol=2e-6 * float(np.abs(y).max()),
                err_msg=f"component {a}")

    def check_2d(name, per, vol, gamma):
        shape = (20, 14)
        jg, tg = jgrid.GridSpec(shape, (2.0, 1.3)), tgrid.GridSpec(
            shape, (2.0, 1.3))
        tables = []
        for mod, g in ((jbcs, jg), (tbcs, tg)):
            b = _table_2d(mod, g, False)
            for a in range(2):
                if per[a]:
                    b[(a, 0)] = b[(a, 1)] = mod.BCSpec.periodic()
            tables.append(b)
        jb, tb = tables
        u = _seeded_u(jg, per, 3)
        f = None
        if vol:
            rng = np.random.default_rng(4)
            f = [rng.normal(size=fused3d.force_shape(tg, per, a))
                 .astype(np.float32) for a in range(2)]
        got = predictor2d.predictor_2d(
            tg, tb, tuple(torch.as_tensor(c) for c in u), dt, nu, gamma,
            forcing=None if f is None else tuple(torch.as_tensor(x)
                                                 for x in f))
        ref = jst.predictor(jg, jb, tuple(u), dt, nu, gamma, f)
        close(got, ref, per)

    cases = [(f"k8 per={per} vol={vol} gamma={gamma}", per, vol, gamma)
             for per in ((True, False), (False, True), (True, True))
             for vol in (False, True) for gamma in (0.0, 0.8)]
    _each_case(cases, check_2d)

    def check_3d(name, per, mode, gamma):
        shape = (10, 9, 8)
        jg, tg = (m.GridSpec(shape, (1.0, 0.9, 1.2)) for m in (jgrid, tgrid))
        tables = []
        for mod, g in ((jbcs, jg), (tbcs, tg)):
            b = mod.no_slip_box(g)
            b[(2, 1)] = mod.BCSpec.wall((1.0, 0.3, 0.0))
            for a in range(3):
                if per[a]:
                    b[(a, 0)] = b[(a, 1)] = mod.BCSpec.periodic()
            tables.append(b)
        jb, tb = tables
        u = [np.asarray(c) for c in jbcs.apply_velocity_bcs(
            jg, jb, tuple(_seeded_u(jg, per, 5)))]
        tu = tuple(torch.as_tensor(np.array(c)) for c in u)
        cfg = jles.LESConfig(cs=0.17)
        nu_t = np.array(jles.eddy_viscosity(jg, jb, tuple(u), cfg))
        rng = np.random.default_rng(6)
        kw, force = {}, None
        if mode == "static":
            kw["force"] = force = (0.5, None, -0.25)
        elif mode == "volume":
            vols = [rng.normal(size=fused3d.force_shape(tg, per, a))
                    .astype(np.float32) if a != 1 else None
                    for a in range(3)]
            kw["force_vol"] = tuple(None if v is None else torch.as_tensor(v)
                                    for v in vols)
            force = vols
        else:
            theta = rng.random(shape).astype(np.float32)
            jcfg = jsc.ScalarConfig(
                bcs={(a, s): jsc.ScalarBC.adiabatic() for a in range(3)
                     for s in (0, 1)},
                diffusivity=1e-3, buoyancy=(0.0, 0.0, 9.8), theta_ref=0.5)
            kw.update(theta=torch.as_tensor(theta),
                      scalar=convert.scalar_config_from_jax(jcfg))
            force = jsc.buoyancy_forcing(jg, jcfg, theta)
        got = predictor3d.predictor_3d(tg, tb, tu, dt, nu, gamma,
                                       nu_t=torch.as_tensor(nu_t), **kw)
        sgs = jles.sgs_forcing(jg, jb, tuple(u), cfg, nu_t=nu_t)
        forcing = tuple(s if f is None else f + s
                        for f, s in zip(force, sgs))
        ref = jbcs.apply_velocity_bcs(
            jg, jb, jst.predictor(jg, jb, tuple(u), dt, nu, gamma, forcing))
        close(got, ref, (True,) * 3)

    cases = [(f"k6 per={per} {mode} gamma={gamma}", per, mode, gamma)
             for per in ((False,) * 3, (True, False, False),
                         (True, True, True))
             for mode in ("static", "volume", "buoyancy")
             if not (mode == "buoyancy" and per[2])
             for gamma in (0.0, 0.8)]
    _each_case(cases, check_3d)


# -- the runs -------------------------------------------------------------------


def test_les_2d_matches_jax():
    """2D LES through ``run_scan``: decaying turbulence 32^2 with
    ``les_cs`` (rk2, 10 steps) and the dynamic model (5 steps), 2D
    Kolmogorov flow 32^2 (its force volume plus the subgrid stress, rk2)
    and the 2D cavity 16^2 (``--les-cs``), each on the unfused route with
    kernel 8 (its wrap modes on the periodic boxes)."""
    def check(name, jsim, tsim, n):
        assert not tsim.fused and tsim.les is not None
        st = (jturb.initial_state() if name == "turbulence" else
              _perturbed(jsim, jsim.initial_state(), 3))
        _check_run(*_run_both(jsim, tsim, st, n), COUNT_SLACK["fft"])

    jturb = jax_make_case("decaying_turbulence", shape=(32, 32), seed=2,
                          les_cs=CS)
    tturb = make_case("decaying_turbulence", shape=(32, 32), seed=2,
                      les_cs=CS, device=CPU)
    assert jturb.sim.les is not None and tturb.sim.les.cs == CS
    jdyn = jax_make_case("decaying_turbulence", shape=(32, 32), seed=2,
                         les_model="dynamic")
    tdyn = make_case("decaying_turbulence", shape=(32, 32), seed=2,
                     les_model="dynamic", device=CPU)
    jk, tk = _with_les(jax_make_case("kolmogorov", shape=(32, 32)).sim,
                       make_case("kolmogorov", shape=(32, 32),
                                 device=CPU).sim)
    assert tk.force_vol[0] is not None
    jcav, tcav = _with_les(jax_make_case("cavity", shape=(16, 16)).sim,
                           make_case("cavity", shape=(16, 16),
                                     device=CPU).sim)
    _each_case([("turbulence", jturb.sim, tturb.sim, 10),
                ("turbulence", jdyn.sim, tdyn.sim, 5),
                ("kolmogorov", jk, tk, 5),
                ("cavity", jcav, tcav, 5)], check)


def test_periodic_channel_past_block_matches_jax():
    """A channel periodic in x (walls in y, the periodic channel's force)
    past a solid block, mg: the unfused route's predictor kernel in its
    periodic-rows mode (before it, ``step`` raised), 10 steps, Euler and
    rk2."""
    def check(name, integrator):
        sims = []
        for mk, mod, extra in ((jax_make_case, jsolver, {}),
                               (make_case, tsolver, {"device": CPU})):
            c = mk("channel_periodic", shape=(32, 16), **extra).sim
            pr = dataclasses.replace(
                c.params, integrator=integrator,
                poisson=dataclasses.replace(c.params.poisson, method="mg",
                                            tol=1e-6, max_iters=60))
            args = (c.grid, c.bcs, pr) + ((CPU,) if extra else ())
            sims.append(mod.Simulation.build(*args, solid=solid,
                                             forcing=(8 * c.params.nu, None)))
        jsim, tsim = sims
        assert not tsim.fused and tsim.ghosts is not None
        st = jsim.initial_state()
        jr, tr = _run_both(jsim, tsim, st, 10)
        # rk2: two solves a step, each within the slack
        _check_run(jr, tr, COUNT_SLACK["mg"] * (1 + (integrator == "rk2")))
        assert float(tr[0].u[0].abs().max()) > 0.0

    solid = np.zeros((32, 16), bool)
    solid[12:16, 6:10] = True
    _each_case([("euler", "euler"), ("rk2", "rk2")], check)


def test_les_3d_forced_and_scalar_match_jax():
    """3D LES with a force or a scalar through ``run_scan``:
    ``duct_periodic`` 16x8x8 (the static force, periodic axis 0; Euler and
    rk2), 3D Kolmogorov 16^3 (a force volume, every axis periodic; rk2),
    the 3D heated cavity 16^3 at Ra 1e6 (buoyancy on walls; theta by
    kernel 2's thermal mode; Euler and rk2) and the heated sphere
    32x16x16 (a passive theta, the masked thermal corrector; Euler)."""
    def check(name, jsim, tsim, st, n, method):
        assert tsim.fused and tsim.les is not None
        _check_run(*_run_both(jsim, tsim, st, n), COUNT_SLACK[method])

    cases = []
    for integ in ("euler", "rk2"):
        j, t = _with_les(
            jax_make_case("duct_periodic", shape=(16, 8, 8)).sim,
            make_case("duct_periodic", shape=(16, 8, 8), device=CPU).sim,
            integrator=integ)
        cases.append((f"duct {integ}", j, t,
                      _perturbed(j, j.initial_state(), 9), 5, "fft"))
    j, t = _with_les(jax_make_case("kolmogorov", shape=(16, 16, 16)).sim,
                     make_case("kolmogorov", shape=(16, 16, 16),
                               device=CPU).sim)
    cases.append(("kolmogorov3d", j, t, _perturbed(j, j.initial_state(), 8),
                  5, "fft"))
    for integ in ("euler", "rk2"):
        j, t = _with_les(
            jax_make_case("heated_cavity", shape=(16, 16, 16), ra=1e6).sim,
            make_case("heated_cavity", shape=(16, 16, 16), ra=1e6,
                      device=CPU).sim, integrator=integ)
        cases.append((f"heated_cavity {integ}", j, t, j.initial_state(), 6,
                      j.params.poisson.method))
    sphere = dict(shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0), heated=True)
    j, t = _with_les(jax_make_case("sphere", **sphere).sim,
                     make_case("sphere", device=CPU, **sphere).sim)
    st = dataclasses.replace(jax_impulsive_start(j),
                             theta=j.initial_state().theta)
    cases.append(("heated sphere", j, t, st, 5, j.params.poisson.method))
    _each_case(cases, check)


def test_les_route_follows_replace_and_cli(tmp_path):
    """``dataclasses.replace`` of a fused 2D simulation with ``les`` moves
    it to the unfused route and steps exactly as ``Simulation.build(...,
    les=)`` does; a replace back to ``les=None`` lands on the fused route
    again. ``--case decaying_turbulence --les-cs 0.17`` runs through the
    command line."""
    from navierstokessolver_tpu_torch.cli import main

    def check(name, make):
        case = make()
        sim = case.sim
        assert sim.fused
        cfg = tles.LESConfig(cs=0.17)
        rep = dataclasses.replace(sim, les=cfg)
        built = tsolver.Simulation.build(
            sim.grid, sim.bcs, sim.params, CPU, forcing=sim.forcing,
            scalar=sim.scalar, les=cfg)
        assert not rep.fused and not built.fused and rep.bc is None
        assert torch.equal(rep.ghosts, built.ghosts)
        st = case.initial_state()
        (a, da), (b, db) = rep.run_scan(st, 3), built.run_scan(st, 3)
        for x, y in zip((*a.u, a.p), (*b.u, b.p)):
            assert torch.equal(x, y)
        assert torch.equal(da.max_div, db.max_div)
        back = dataclasses.replace(rep, les=None)
        assert back.fused and back.ghosts is None
        (c, _), (d, _) = back.run_scan(st, 3), sim.run_scan(st, 3)
        for x, y in zip((*c.u, c.p), (*d.u, d.p)):
            assert torch.equal(x, y)

    _each_case([
        ("cavity", lambda: make_case("cavity", shape=(16, 16), device=CPU)),
        ("kolmogorov", lambda: make_case("kolmogorov", shape=(16, 16),
                                         device=CPU)),
        ("heated_cavity", lambda: make_case("heated_cavity", shape=(16, 16),
                                            ra=1e4, device=CPU)),
    ], check)
    out = tmp_path / "t"
    main(["--platform", "cpu", "--case", "decaying_turbulence", "--shape",
          "32,32", "--les-cs", "0.17", "--steps", "4", "--chunk", "2",
          "--checkpoint-every", "4", "--out", str(out)])
    ck = np.load(out / "ckpt.npz")
    assert np.isfinite(ck["u0"]).all() and np.isfinite(ck["u1"]).all()


def test_les_refusals_name_their_item():
    """What item 5.5 leaves open still raises NotImplementedError naming
    its ROADMAP item: LES with the IBM or the cut-cell pressure (2D and
    3D), a force or buoyancy with LES on open faces or an obstacle in 3D
    ('Physics extensions'); kernel 6's wrapper refuses a force on an open
    table. The tables item 5.5 ported build."""
    cfg = tles.LESConfig(cs=0.17)
    kw = dict(shape=(32, 16, 16), lengths=(8.0, 4.0, 4.0),
              center=(2.0, 2.03, 1.97), re=100.0, device=CPU)
    cyl = make_case("cylinder", shape=(64, 32), ibm=True, device=CPU).sim
    sph = make_case("sphere", ibm=True, **kw).sim
    cut = make_case("sphere", ibm=True, sharp_pressure=True,
                    poisson_method="mg", **kw).sim
    for sim in (cyl, sph, cut):
        with pytest.raises(NotImplementedError, match="Physics extensions"):
            dataclasses.replace(sim, les=cfg)
    plain = make_case("sphere", **kw).sim
    forced = tsolver.Simulation.build(plain.grid, plain.bcs, plain.params,
                                      CPU, solid=plain.scalar_solid
                                      if plain.scalar_solid is not None
                                      else _sphere_solid(plain),
                                      forcing=(0.1, None, None))
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        dataclasses.replace(forced, les=cfg)
    # buoyancy with open faces (the 3D heated enclosure has an obstacle)
    enc = make_case("heated_enclosure", shape=(16, 16, 16),
                    center=(0.5, 0.5, 0.45), device=CPU).sim
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        dataclasses.replace(enc, les=cfg)
    g = plain.grid
    u = tuple(torch.zeros(g.face_shape(a)) for a in range(3))
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        predictor3d.predictor_3d(g, plain.bcs, u, 1e-3, 0.01,
                                 nu_t=torch.zeros(g.shape),
                                 force=(0.1, None, None))
    # what builds now: a force and a buoyant scalar with LES on walls and
    # periodic axes, a passive scalar with open faces and an obstacle, 2D
    for name, kw2 in (("duct_periodic", dict(shape=(16, 8, 8))),
                      ("heated_cavity", dict(shape=(8, 8, 8))),
                      ("sphere", dict(kw, heated=True)),
                      ("decaying_turbulence", dict(shape=(16, 16))),
                      ("heated_cavity", dict(shape=(16, 16)))):
        kw2.setdefault("device", CPU)
        sim = dataclasses.replace(make_case(name, **kw2).sim, les=cfg)
        assert sim.les is cfg


def _sphere_solid(sim):
    """The sphere's solid cells from its Poisson operator (the fluid
    mask)."""
    return (sim.op.fluid == 0).cpu().numpy()
