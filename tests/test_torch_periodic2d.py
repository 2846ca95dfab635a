"""PyTorch port vs JAX package: periodic faces in 2D.

Held to the JAX package on the CPU, with numpy-seeded inputs:

  * the BC pass, the transverse ghosts and the obstacle masks on JAX's
    three periodic topologies (tests/test_pallas2d.py: a fully periodic
    box, periodic rows with walls, periodic lanes with walls);
  * the periodic stencils (the wrap predictor with a static force and in
    rk2's ``base`` form, the wrap correction);
  * the split circulant plan (``CircSplitPlan``) and a periodic-Neumann
    solve that takes it, at n = 1024;
  * kernel 4's and kernel 5's plain versions (what the CUDA kernels are
    held to on the card) against the JAX Pallas kernels in interpret
    mode, with JAX's interpret-parity tolerances: atol 2e-6 on O(0.1)
    fields, the RHS atol 2e-6 max(max|RHS|, 1);
  * five steps of ``taylor_green``, ``channel_periodic`` and
    ``decaying_turbulence`` (rk2, and at cfl 0.4) through ``step`` and
    ``run_scan`` against JAX's fused 2D sim in interpret mode and its jnp
    step: u rtol 2e-5 atol 2e-6, p rtol 2e-4 atol 2e-5, equal iteration
    counts (tests/test_pallas2d.py's whole-step tolerances);
  * the unfused route on a periodic box with an obstacle (``mg``), which
    needs the wrap faces corrected and the correction masks of a periodic
    axis shaped as JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jmake
from navierstokessolver_tpu.ops import dct as jdct
from navierstokessolver_tpu.ops import fft_poisson as jfft
from navierstokessolver_tpu.ops import pallas_2d as jp2
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu.utils import spectra as jspec
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case as tmake
from navierstokessolver_tpu_torch.grid import State
from navierstokessolver_tpu_torch.ops import dct as tdct
from navierstokessolver_tpu_torch.ops import fft_poisson as tfft
from navierstokessolver_tpu_torch.ops import fused2d
from navierstokessolver_tpu_torch.ops import poisson as tpois
from navierstokessolver_tpu_torch.ops import stencils as tst
from navierstokessolver_tpu_torch.utils import spectra as tspec

DT, NU, RHO = 1e-3, 0.01, 1.3
SCALE = 5e-3
FORCE = (0.7, -0.2)

# JAX's periodic topologies (tests/test_pallas2d.py), with moving walls:
# shape, lengths, periodic axes, the walls' values
TOPOLOGIES = {
    "box": ((64, 48), (1.0, 0.75), (True, True), {}),
    "rows": ((64, 32), (2.0, 1.0), (True, False),
             {(1, 1): (1.0, 0.0), (1, 0): (-0.3, 0.0)}),
    "lanes": ((32, 128), (1.0, 4.0), (False, True),
              {(0, 0): (0.0, 0.5), (0, 1): (0.0, -0.25)}),
}


def _tables(topology):
    """(jg, tg, jb, tb) of one topology."""
    shape, lengths, per, walls = TOPOLOGIES[topology]
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    for face, value in walls.items():
        jb[face] = jbcs.BCSpec.wall(value)
        tb[face] = tbcs.BCSpec.wall(value)
    for a in range(2):
        if per[a]:
            for s in (0, 1):
                jb[(a, s)] = jbcs.BCSpec.periodic()
                tb[(a, s)] = tbcs.BCSpec.periodic()
    return jg, tg, jb, tb


def _fields(shape, seed, scale=0.1):
    """Random O(scale) face fields (numpy float32), before any BC pass."""
    rng = np.random.default_rng(seed)
    n0, n1 = shape
    return [(rng.normal(size=s) * scale).astype(np.float32)
            for s in ((n0 + 1, n1), (n0, n1 + 1))]


def _state(jg, jb, seed, scale=0.1):
    """A random BC-consistent velocity (face n of a periodic axis equal to
    face 0), as JAX arrays and as port tensors."""
    ju = jbcs.apply_velocity_bcs(
        jg, jb, tuple(jnp.asarray(f) for f in _fields(jg.shape, seed, scale)))
    return ju, tuple(torch.from_numpy(np.array(c)) for c in ju)


def _close(got, ref, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _rhs_atol(ref):
    # the RHS carries rho/dt (values up to ~1e4 on a random field)
    return 2e-6 * max(float(np.abs(np.asarray(ref)).max()), 1.0)


# -- BCs, ghosts, masks and stencils ------------------------------------------


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_bc_pass_ghosts_and_masks_match_jax(topology):
    jg, tg, jb, tb = _tables(topology)
    tbcs.validate_bcs(tg, tb)
    assert fused2d.fused_step2d_applicable(tg, tb)
    per = jbcs.periodic_axes(jg, jb)
    assert tbcs.periodic_axes(tg, tb) == tuple(per)
    raw = _fields(jg.shape, 0)
    ju = jbcs.apply_velocity_bcs(jg, jb, tuple(jnp.asarray(f) for f in raw))
    tu = tbcs.apply_velocity_bcs(tg, tb, tuple(torch.from_numpy(f)
                                               for f in raw))
    for a in range(2):
        np.testing.assert_array_equal(tu[a].numpy(), np.asarray(ju[a]))
        if per[a]:
            np.testing.assert_array_equal(tu[a].select(a, 0).numpy(),
                                          tu[a].select(a, -1).numpy())
        np.testing.assert_array_equal(
            tbcs.pad_transverse(tg, tb, a, tu[a]).numpy(),
            np.asarray(jbcs.pad_transverse(jg, jb, a, ju[a])))
    # an obstacle touching the wrap faces of both axes
    solid = np.zeros(jg.shape, bool)
    solid[0:3, 5:9] = solid[-2:, 5:9] = True
    solid[10:14, 0:2] = solid[10:14, -1:] = True
    for jm, tm in (
            (jbcs.face_masks_from_solid(jg, solid, per),
             tbcs.face_masks_from_solid(tg, solid, "cpu", per)),
            (jbcs.correction_face_masks(jg, solid, per),
             tbcs.correction_face_masks(tg, solid, "cpu", per))):
        for a in range(2):
            np.testing.assert_array_equal(tm[a].numpy(), np.asarray(jm[a]))


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_periodic_stencils_match_jax(topology):
    """The wrap predictor (Euler, with a static force, rk2's base form),
    the wrap correction (with and without correction masks) and the
    divergence, within JAX's 2e-6."""
    jg, tg, jb, tb = _tables(topology)
    per = jbcs.periodic_axes(jg, jb)
    ju, tu = _state(jg, jb, 1)
    jbase, tbase = _state(jg, jb, 2)
    for gamma in (0.0, 0.3):
        for forcing, base in ((None, None), (FORCE, None), (FORCE, "base")):
            jb_ = jbase if base else None
            tb_ = tbase if base else None
            if jb_ is None:
                ref = jst.predictor(jg, jb, ju, jnp.float32(DT), NU, gamma,
                                    forcing)
            else:
                ref = tuple(
                    b + (s - c) for b, s, c in zip(jb_, jst.predictor(
                        jg, jb, ju, jnp.float32(DT), NU, gamma, forcing),
                        ju))
            got = tst.predictor(tg, tb, tu, DT, NU, gamma, forcing, tb_)
            for a in range(2):
                _close(got[a], ref[a], 2e-6)
                if per[a]:
                    np.testing.assert_array_equal(
                        got[a].select(a, 0).numpy(),
                        got[a].select(a, -1).numpy())
    p = np.random.default_rng(3).normal(size=jg.shape).astype(np.float32)
    solid = np.zeros(jg.shape, bool)
    solid[0:3, 5:9] = True
    for masks in (None, solid):
        jm = jbcs.correction_face_masks(jg, masks, per)
        tm = tbcs.correction_face_masks(tg, masks, "cpu", per)
        ref = jst.correct_velocity(jg, ju, jnp.asarray(p), SCALE, jm, per)
        got = tst.correct_velocity(tg, tu, torch.from_numpy(p), SCALE, tm,
                                   per)
        for a in range(2):
            _close(got[a], ref[a], 2e-6)
        _close(tst.divergence(tg, got), jst.divergence(jg, ref), 2e-4)


# -- the split circulant plan -------------------------------------------------


def test_circ_split_plan_matches_jax():
    """fwd, inv and the permutation against JAX's plan at n = 1024 (JAX's
    test_circulant_split_matches_dense tolerance, 3e-5), and against the
    dense eigenbasis."""
    n = 1024
    jp = jdct.CircSplitPlan(n, jnp.float32)
    tp = tdct.CircSplitPlan(n, torch.float32, "cpu")
    np.testing.assert_array_equal(tp.permutation(), jp.permutation())
    assert sorted(tp.permutation().tolist()) == list(range(n))
    x = np.random.default_rng(8).normal(size=(n, 5)).astype(np.float32)
    import jax
    hi = jax.lax.Precision.HIGHEST
    jf = np.asarray(jp.apply_fwd(jnp.asarray(x), 0, hi))
    tf = tp.fwd(torch.from_numpy(x), 0)
    _close(tf, jf, 3e-5)
    _close(tp.inv(tf, 0), jp.apply_inv(jnp.asarray(jf), 0, hi), 3e-5)
    _close(tp.inv(tf, 0), x, 3e-5)
    q = tdct.circulant_eigenbasis(n, 1.0)[0]
    _close(tf, (q.T @ x.astype(np.float64))[tp.permutation()], 3e-5)
    # along a trailing axis, the axis kept in place
    _close(tp.fwd(torch.from_numpy(x.T.copy()), 1), jf.T, 3e-5)


def test_periodic_neumann_solve_takes_the_split_plan():
    """A (1024, 8) periodic-Neumann direct solve: the circulant split plan
    on axis 0, as JAX picks it, and the same pressure as JAX's solver."""
    shape, lengths = (1024, 8), (1.0, 0.25)
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    kinds = ("per", "nn")
    js = jfft.DCTPoissonSolver.build(jg, kinds=kinds)
    ts = tfft.DCTPoissonSolver.build(tg, "cpu", kinds=kinds)
    assert isinstance(js.plans[0], jdct.CircSplitPlan)
    assert isinstance(ts.plans[0], tdct.CircSplitPlan)
    b = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    b -= b.mean()
    jb = jbcs.no_slip_box(jg)
    jb[(0, 0)] = jb[(0, 1)] = jbcs.BCSpec.periodic()
    tb = tbcs.no_slip_box(tg)
    tb[(0, 0)] = tb[(0, 1)] = tbcs.BCSpec.periodic()
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    jp = np.asarray(js.solve(jnp.asarray(b), jop))
    tp = ts.solve(torch.from_numpy(b), top)
    # both residuals sit at this shape's float32 floor (5.7e-5 and 5.9e-5
    # relative); the pressures differ by ~4e-5 of max|p| (1024-term float32
    # sums in another order)
    res = [np.linalg.norm(tpois.apply_A(top, torch.from_numpy(np.array(p)))
                          .numpy() - b) / np.linalg.norm(b) for p in (tp, jp)]
    assert res[0] < 1e-4 and res[0] <= 1.1 * res[1]
    _close(tp, jp, 1e-4 * float(np.abs(jp).max()))


# -- kernels 4 and 5: the plain versions against the Pallas kernels ------------


@pytest.mark.heavy
@pytest.mark.parametrize("topology,gamma,mode", [
    ("box", 0.3, "euler"), ("box", 0.0, "force"), ("rows", 0.0, "force"),
    ("lanes", 0.4, "base"), ("box", 0.3, "base"),
])
def test_predictor_rhs_2d_plain_vs_pallas_interpret(topology, gamma, mode):
    """Kernel 4's plain version (the CPU wrapper) against
    ``predictor_rhs_2d_internal`` in interpret mode, tile 32, through the
    internal layout and back (JAX's test_pred2d_matches_jnp)."""
    jg, tg, jb, tb = _tables(topology)
    ju, tu = _state(jg, jb, 4)
    force = FORCE if mode == "force" else None
    jbase = tbase = None
    if mode == "base":
        jbase, tbase = _state(jg, jb, 5)
    iu = jp2.to_internal_2d(jg, ju, tile=32)
    ibase = None if jbase is None else jp2.to_internal_2d(jg, jbase, tile=32)
    j_istar, j_rhs = jp2.predictor_rhs_2d_internal(
        jg, jb, iu, DT, NU, gamma, rho=RHO, tile=32, interpret=True,
        forcing=force, base=ibase)
    j_star = jp2.from_internal_2d(jg, jb, j_istar)
    before = dict(fused2d.LAUNCHES)
    t_star, t_rhs = fused2d.predictor_rhs_2d(tg, tb, tu, DT, NU, gamma, RHO,
                                             base=tbase, force=force)
    assert fused2d.LAUNCHES == before      # CPU tensors: the plain version
    for a in range(2):
        _close(t_star[a], j_star[a], 2e-6)
    _close(t_rhs, j_rhs, _rhs_atol(j_rhs))


@pytest.mark.heavy
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_correct_diag_2d_plain_vs_pallas_interpret(topology):
    """Kernel 5's plain version against ``correct_diag_2d_internal`` in
    interpret mode, on a random pressure (its gradient at the wrap faces
    is not zero): u atol 2e-6, max|div u| rtol 1e-3, max|u_a|/h_a rtol
    1e-4 (JAX's test_corr2d_matches_jnp)."""
    jg, tg, jb, tb = _tables(topology)
    ju, tu = _state(jg, jb, 6)
    p = (np.random.default_rng(7).normal(size=jg.shape) * 0.01).astype(
        np.float32)
    per = jbcs.periodic_axes(jg, jb)
    j_inew, j_div, j_vel = jp2.correct_diag_2d_internal(
        jg, jb, jp2.to_internal_2d(jg, ju, tile=32), jnp.asarray(p), SCALE,
        tile=32, interpret=True)
    j_new = jp2.from_internal_2d(jg, jb, j_inew)
    t_new, t_div, t_vel = fused2d.correct_diag_2d(
        tg, tu, torch.from_numpy(p), SCALE, tbcs.periodic_axes(tg, tb))
    for a in range(2):
        _close(t_new[a], j_new[a], 2e-6)
        if per[a]:
            np.testing.assert_array_equal(t_new[a].select(a, 0).numpy(),
                                          t_new[a].select(a, -1).numpy())
    _close(t_div, j_div, 0.0, 1e-3)
    _close(t_vel, j_vel, 0.0, 1e-4)


def test_bc_table_carries_the_force():
    _, tg, _, tb = _tables("rows")
    np.testing.assert_array_equal(
        fused2d.bc_table(tg, tb, "cpu", (0.5, None)),
        np.float32([0, 0, 0, 0, -0.3, 0, 1, 0, 0.5, 0]))
    np.testing.assert_array_equal(fused2d.bc_table(tg, tb, "cpu")[8:], [0, 0])
    assert fused2d.force_values((None, 2)) == (0.0, 2.0)


# -- the three periodic cases, five steps --------------------------------------


def _perturbed_channel(jc, tc):
    """``channel_periodic``'s parabola plus O(0.05) noise, as JAX arrays and
    port states (the parabola alone is the steady solution, which would
    leave the wrap and the force untested)."""
    js = jc.initial_state()
    noise = _fields(js.p.shape, 9, 0.05)
    ju = jbcs.apply_velocity_bcs(
        jc.sim.grid, jc.sim.bcs,
        tuple(c + jnp.asarray(n) for c, n in zip(js.u, noise)))
    ts = tc.initial_state()
    return (dataclasses.replace(js, u=ju),
            State(u=tuple(torch.from_numpy(np.array(c)) for c in ju),
                  p=ts.p, p_prev=ts.p_prev))


CASES = {
    "taylor_green": ("taylor_green", dict(shape=(32, 32), re=100.0)),
    "channel_periodic": ("channel_periodic", dict(shape=(64, 32))),
    "turbulence_rk2": ("decaying_turbulence", dict(shape=(64, 64), seed=3)),
    "turbulence_cfl": ("decaying_turbulence", dict(shape=(64, 64), seed=3,
                                                   cfl=0.4)),
}


@pytest.mark.heavy
@pytest.mark.parametrize("which", list(CASES))
def test_periodic_cases_match_jax(which):
    """Five steps of ``step`` and a five-step ``run_scan`` on the fused 2D
    route (the kernels' plain versions on the CPU) against JAX's fused sim
    in interpret mode and its jnp step (each a five-step ``run_scan``: the
    JAX step and scan run the same step function)."""
    name, kw = CASES[which]
    jc, tc = jmake(name, **kw), tmake(name, device="cpu", **kw)
    assert tc.sim.fused
    if name == "channel_periodic":
        assert tc.sim.forcing == (8.0 * tc.sim.params.nu, None)
        js, ts = _perturbed_channel(jc, tc)
    else:
        js, ts = jc.initial_state(), tc.initial_state()
        for a in range(2):
            np.testing.assert_array_equal(ts.u[a].numpy(),
                                          np.asarray(js.u[a]))
    jfused = dataclasses.replace(
        jc.sim, params=dataclasses.replace(jc.sim.params, use_pallas=True),
        pallas_interpret=True)
    assert jfused._fused2d_ok()
    jr, djr = jc.sim.run_scan(js, 5)
    jf, djf = jfused.run_scan(js, 5)
    tr = ts
    for k in range(5):
        tr, d = tc.sim.step(tr)
        assert int(d.poisson_iters) == int(djr.poisson_iters[k])
    ta, dta = tc.sim.run_scan(ts, 5)
    for ref in (jr, jf):
        for got in (tr, ta):
            for a in range(2):
                _close(got.u[a], ref.u[a], 2e-6, 2e-5)
            _close(got.p, ref.p, 2e-5, 2e-4)
    for dref in (djr, djf):
        np.testing.assert_array_equal(dta.poisson_iters.numpy(),
                                      np.asarray(dref.poisson_iters))
        _close(dta.dt, dref.dt, 0.0, 3e-5)
        # max|div u| sits at its float32 roundoff (~2-4e-6 at h = 2 pi / 64,
        # where the JAX fused and jnp steps differ by ~1e-6 too)
        assert float(dta.max_div.max()) < 1e-5
        _close(dta.max_div, dref.max_div, 2e-6)
        _close(dta.max_cfl, dref.max_cfl, 1e-8, 1e-3)


# -- the unfused route on a periodic box with an obstacle ---------------------


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_unfused_periodic_obstacle_matches_jax(integrator):
    """A fully periodic (64, 48) box with a square obstacle, ``mg`` at tol
    1e-6, 5 steps of ``step_plain`` against JAX's ``Simulation.step`` (its
    jnp step): the wrap faces corrected, the correction masks of the
    periodic axes all n faces. u atol 2e-6, p atol 2e-5; mg's V-cycle
    count may differ by one where it stops at its float32 floor. ``step``
    raises: kernel 8 has no periodic lanes yet."""
    shape, lengths = (64, 48), (1.0, 0.75)
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb = {(a, s): jbcs.BCSpec.periodic() for a in range(2) for s in (0, 1)}
    tb = {(a, s): tbcs.BCSpec.periodic() for a in range(2) for s in (0, 1)}
    solid = np.zeros(shape, bool)
    solid[14:20, 13:19] = True
    kw = dict(dt=2e-3, nu=0.01, upwind_gamma=0.2, integrator=integrator)
    jsim = jsolver.Simulation.build(
        jg, jb, jsolver.SimParams(poisson=jpois.PoissonConfig(
            method="mg", tol=1e-6), **kw), solid=solid)
    tsim = tsolver.Simulation.build(
        tg, tb, tsolver.SimParams(poisson=tpois.PoissonConfig(
            method="mg", tol=1e-6), **kw), "cpu", solid=solid)
    assert not tsim.fused
    assert [tuple(m.shape) for m in tsim.corr_masks] == [shape, shape]
    ju = jbcs.apply_velocity_bcs(
        jg, jb, tuple(jnp.asarray(f) for f in _fields(shape, 11, 0.5)),
        jsim.face_masks)
    js = jgrid.State(u=ju, p=jnp.zeros(shape, jnp.float32))
    ts = State(u=tuple(torch.from_numpy(np.array(c)) for c in ju),
               p=torch.zeros(shape))
    for _ in range(5):
        js, jd = jsim.step(js)
        ts, td = tsim.step_plain(ts)
        assert abs(int(td.poisson_iters) - int(jd.poisson_iters)) <= 1
    for a in range(2):
        _close(ts.u[a], js.u[a], 2e-6)
        np.testing.assert_array_equal(ts.u[a].select(a, 0).numpy(),
                                      ts.u[a].select(a, -1).numpy())
    _close(ts.p, js.p, 2e-5)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tsim.step(ts)


# -- spectra, and what stays unported ------------------------------------------


def test_turbulence_ic_and_spectra_match_jax():
    """The decaying-turbulence initial field equals JAX's bit for bit, is
    divergence-free to roundoff, and the port's spectrum and kinetic
    energy equal JAX's (tests/test_turbulence.py's Parseval check)."""
    jc = jmake("decaying_turbulence", shape=(64, 64), seed=3)
    tc = tmake("decaying_turbulence", shape=(64, 64), seed=3, device="cpu")
    assert tc.sim.params.integrator == "rk2"
    assert tc.sim.params.dt == jc.sim.params.dt
    js, ts = jc.initial_state(), tc.initial_state()
    for a in range(2):
        np.testing.assert_array_equal(ts.u[a].numpy(), np.asarray(js.u[a]))
    assert float(tst.divergence(tc.sim.grid, ts.u).abs().max()) < 1e-4
    k, e = tspec.energy_spectrum_2d(tc.sim.grid, ts.u)
    jk, je = jspec.energy_spectrum_2d(jc.sim.grid, js.u)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_allclose(e, je, rtol=1e-6, atol=1e-12)
    ke = tspec.total_kinetic_energy(tc.sim.grid, ts.u)
    np.testing.assert_allclose(ke, jspec.total_kinetic_energy(
        jc.sim.grid, js.u), rtol=1e-6)
    np.testing.assert_allclose(e.sum(), ke, rtol=2e-2)


def test_taylor_green_state_matches_jax():
    from navierstokessolver_tpu.cases.taylor_green import (
        taylor_green_state as jstate)
    from navierstokessolver_tpu_torch.cases.taylor_green import (
        taylor_green_state as tstate)

    jg, tg = (m.GridSpec((24, 16), (2 * np.pi, 2 * np.pi))
              for m in (jgrid, tgrid))
    js, ts = jstate(jg, 0.7, 0.01), tstate(tg, 0.7, 0.01, "cpu")
    for got, ref in zip((*ts.u, ts.p), (*js.u, js.p)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_periodic_2d_probes():
    """What this slice leaves unported raises naming its ROADMAP item
    (2D LES); what the forcing slice ported builds: kolmogorov, array
    and callable forcing (a volume of kernel 4; a force entry refilled
    from t), a force in 3D (kernel 1) and a static force on the unfused
    route (kernel 8's volume)."""
    k = tmake("kolmogorov", shape=(16, 16), device="cpu").sim
    assert k.fused and k.force_vol[0] is not None
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        tmake("decaying_turbulence", shape=(16, 16), les_cs=0.17,
              device="cpu")
    case = tmake("taylor_green", shape=(16, 16), device="cpu")
    g, b, pr = case.sim.grid, case.sim.bcs, case.sim.params
    # array and callable forcing, and a force in 3D
    arr = tsolver.Simulation.build(g, b, pr, "cpu",
                                   forcing=(np.ones((16, 16)), None))
    assert tuple(arr.force_vol[0].shape) == (16, 16)
    td = tsolver.Simulation.build(g, b, pr, "cpu",
                                  forcing=(lambda t: 1.0, None))
    assert td.time_dependent and td.force_vol is None
    assert td.initial_state().t is not None
    g3 = tgrid.GridSpec((8, 8, 8), (1.0, 1.0, 1.0))
    s3 = tsolver.Simulation.build(g3, tbcs.no_slip_box(g3), pr, "cpu",
                                  forcing=(1.0, None, None))
    assert s3.fused and s3.bc.tolist()[18:21] == [1.0, 0.0, 0.0]
    # a static force on the unfused route (kernel 8's force volume)
    ch = tmake("channel", shape=(32, 16), device="cpu").sim
    s2 = tsolver.Simulation.build(ch.grid, ch.bcs, ch.params, "cpu",
                                  forcing=(1.0, None))
    assert not s2.fused and float(s2.force_vol[0].mean()) == 1.0
    # a static force on the fused route builds, as JAX's _static_forcing
    # reads it
    sim = tsolver.Simulation.build(g, b, pr, "cpu",
                                   forcing=(np.asarray(0.5), None))
    assert sim.fused and sim.forcing == (0.5, None)
    assert sim.bc.tolist()[8:] == [0.5, 0.0]
