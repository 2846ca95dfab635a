"""PyTorch port vs JAX package: the mixed-BC spectral bases and ``dctcg``,
the capacitance-corrected DCT-preconditioned solve.

* The direct solve on 'nd', 'dn' and 'dd' axes (dense below 512, the
  DCT-IV split at 512) against the JAX solver's: the same multiplier bit
  for bit, p within 1e-5 of max|p| (float32 roundoff of the transforms),
  and the same plans in float64 solving the operator to float64
  roundoff.
* ``DCTPCGSolver.solve`` alone on the cylinder's operator at 128x64 and at
  512x256, whose axis 0 takes the DCT-IV split, from the
  same RHS and start: the same Richardson sweep count, residuals within
  20% (both near the float32 floor of ``b - A p``), p within 1e-4 of
  max|p|; the same against a port solver carried across from the JAX
  constants (convert.dctcg_solver_from_numpy).
* The preconditioner against a dense float64 solve of the masked
  operator.
* The capacitance matrix's inverse: tests/test_torch_cylinder.py.
* The flexible-CG branch (no capacitance: the all-wall cavity) through
  both packages' ``make_case``.

Each JAX reference runs as one ``jax.jit`` program.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.ops import fft_poisson as jfft
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import dct as tdct
from navierstokessolver_tpu_torch.ops import fft_poisson as tfft
from navierstokessolver_tpu_torch.ops import poisson as tpois

_KIND_FACES = {"nn": ("wall", "wall"), "nd": ("inflow", "outflow"),
               "dn": ("outflow", "slip"), "dd": ("outflow", "outflow")}


def _bcs(kinds):
    """The same table in both packages with the given axis kinds."""
    def make(m):
        spec = {"wall": m.BCSpec.wall((0.0, 0.0)),
                "inflow": m.BCSpec.inflow((1.0, 0.0)),
                "outflow": m.BCSpec.outflow(), "slip": m.BCSpec.slip()}
        return {(a, s): spec[_KIND_FACES[k][s]]
                for a, k in enumerate(kinds) for s in (0, 1)}
    return make(jbcs), make(tbcs)


def _close_rel(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0.0,
                               atol=rel * float(np.abs(ref).max()))


def _solver64(s):
    """The solver ``s`` with every plan matrix and the multiplier in
    float64 (the grid stays float32: only the arithmetic changes)."""
    def to64(plan):
        q = copy.copy(plan)
        for k, v in vars(plan).items():
            if isinstance(v, torch.Tensor):
                setattr(q, k, v.double())
            elif isinstance(v, list):
                setattr(q, k, [t.double() for t in v])
        return q

    return dataclasses.replace(s, inv_eig=s.inv_eig.double(),
                               plans=tuple(to64(p) for p in s.plans))


@pytest.mark.parametrize("shape,kinds", [
    ((128, 64), ("nd", "nn")),
    ((64, 48), ("dn", "dd")),
    ((512, 32), ("nd", "nn")),
    ((512, 32), ("dn", "dd")),
])
def test_mixed_direct_solve_matches_jax(shape, kinds):
    lengths = (4.0, 1.0)
    jg = jgrid.GridSpec(shape=shape, lengths=lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb, tb = _bcs(kinds)
    assert tfft.axis_kinds_from_bcs(tg, tb) == kinds
    js = jfft.DCTPoissonSolver.build(jg, kinds=kinds)
    ts = tfft.DCTPoissonSolver.build(tg, "cpu", kinds=kinds)
    split = [type(p).__name__ for p in ts.plans]
    assert split == [("Dct4SplitPlan" if type(p).__name__ == "Dct4SplitPlan"
                      else "SplitPlan") for p in js.plans]
    np.testing.assert_array_equal(ts.inv_eig.numpy(),
                                  np.asarray(js.inv_eig).T)
    assert not ts.singular
    b = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = jax.jit(js._direct)(jnp.asarray(b))
    got = ts._direct(torch.from_numpy(b))
    _close_rel(got.numpy(), ref, 1e-5)
    # the bases diagonalize the unmasked operator: the same plans in
    # float64 arithmetic leave a relative residual below 1e-4 (their
    # matrices hold float32 values; a wrong basis leaves O(1)), and the
    # float32 solve is within 1e-5 of max|p| of that solution
    ex = _solver64(ts)._direct(torch.from_numpy(b).double())
    op = tpois.build_poisson_op(tg, tb, "cpu")
    r = tpois.residual_norm(op, ex, torch.from_numpy(b).double())
    assert float(r) / float(np.linalg.norm(b)) < 1e-4
    _close_rel(got.numpy(), ex.numpy(), 1e-5)
    # carried across from the JAX constants
    cs = convert.dct_solver_from_numpy(
        tg, np.asarray(js.inv_eig),
        [None if not hasattr(p, "base_fwd") else np.asarray(p.base_fwd)
         for p in js.plans],
        [None if not hasattr(p, "base_inv") else np.asarray(p.base_inv)
         for p in js.plans], kinds=kinds, refine=0)
    _close_rel(cs._direct(torch.from_numpy(b)).numpy(), got.numpy(), 1e-6)


@pytest.mark.parametrize("n,flipped", [(512, False), (1024, True)])
def test_dct4_split_matches_dense(n, flipped):
    """The one-level DCT-IV split against the dense float64 DCT-IV (index-
    flipped for 'dn'), along a leading and a trailing axis, and its
    inverse."""
    plan = tdct.Dct4SplitPlan(n, torch.float32, "cpu", flipped=flipped)
    c = tdct.dct4_matrix(n)
    if flipped:
        c = c[:, ::-1]
    x = np.random.default_rng(n).standard_normal((n, 6))
    want = (c @ x)[plan.permutation()]
    xt = torch.from_numpy(x.astype(np.float32))
    _close_rel(plan.fwd(xt, 0).numpy(), want, 1e-5)
    _close_rel(plan.fwd(xt.T.contiguous(), 1).numpy(), want.T, 1e-5)
    _close_rel(plan.inv(plan.fwd(xt, 0), 0).numpy(), x, 1e-5)


def _cylinders(which):
    """The cylinder case in both packages at 128x64, or at BASELINE #3's
    512x256, whose axis 0 ('nd' at 512) takes the DCT-IV split."""
    kw = dict(shape=(128, 64) if which == "cylinder-128x64" else (512, 256))
    jc = jax_make_case("cylinder", ibm=True, **kw)
    tc = make_case("cylinder", ibm=True, device="cpu", **kw)
    return jc.sim.dctcg_solver, jc.sim.op, tc.sim


@pytest.mark.parametrize("which,rhs", [
    ("cylinder-128x64", "step"), ("cylinder-128x64", "noise"),
    ("cylinder-512x256", "step"), ("cylinder-512x256", "noise"),
])
def test_dctcg_solve_matches_jax(which, rhs):
    """From the second step's RHS and warm start (the impulsive start's
    first step taken by the port; p0 = p + 0.8 (p - p_prev)) both
    packages reach tol. A white-noise RHS drives Richardson to its
    stagnation bail above tol (the float32 floor of ``b - A p`` for that
    RHS) in both."""
    js, jop, sim = _cylinders(which)
    ts, top = sim.dctcg_solver, sim.op
    assert ts.cap_cinv is not None and ts.cap_vx is not None
    assert (type(ts.dct.plans[0]).__name__ == "Dct4SplitPlan") == (
        which.endswith("512x256"))
    fluid = top.fluid.numpy()
    st, _ = sim.step(impulsive_start_state(sim))
    p0 = (st.p + 0.8 * (st.p - st.p_prev)).numpy()
    if rhs == "step":
        b = sim.star_rhs(st)[1].numpy()
    else:
        b = (np.random.default_rng(11).standard_normal(fluid.shape)
             * fluid).astype(np.float32)
    tol, cap = 1e-5, 2000
    jp, jit_, jres = jax.jit(lambda bb, pp: js.solve(bb, pp, tol, cap, jop))(
        jnp.asarray(b), jnp.asarray(p0))
    tpois.reset_host_syncs()
    tp, tit, tres = ts.solve(torch.from_numpy(b), torch.from_numpy(p0), tol,
                             cap, top)
    assert int(tit) == int(jit_) >= 1
    # one host read per sweep: the first sweep runs before the loop
    assert tpois.HOST_SYNCS["poisson"] == int(tit)
    assert (float(tres) <= tol) == (rhs == "step")
    np.testing.assert_allclose(float(tres), float(jres), rtol=0.2)
    # p is held to its solve's tolerance: residuals of 1e-5 relative leave
    # a near-constant offset of a few 1e-5 max|p| between the packages
    _close_rel(tp.numpy(), jp, 1e-4)
    # the true residual is the reported one
    r = tpois.residual_norm(top, tp, torch.from_numpy(b))
    np.testing.assert_allclose(float(r) / np.linalg.norm(b), float(tres),
                               rtol=1e-3)
    # a port solver around the JAX constants solves the same
    jd = js.dct
    cd = convert.dct_solver_from_numpy(
        ts.dct.grid, np.asarray(jd.inv_eig),
        [np.asarray(p.base_fwd) if hasattr(p, "base_fwd") else None
         for p in jd.plans],
        [np.asarray(p.base_inv) if hasattr(p, "base_inv") else None
         for p in jd.plans], kinds=jd.kinds, refine=0)
    cs = convert.dctcg_solver_from_numpy(
        cd, *(np.asarray(getattr(js, f)) for f in (
            "cap_cinv", "cap_va", "cap_vb", "cap_idx_a", "cap_idx_b",
            "cap_vx", "cap_vy", "cap_fx", "cap_fy")))
    cp, cit, _ = cs.solve(torch.from_numpy(b), torch.from_numpy(p0), tol,
                          cap, top)
    assert int(cit) == int(jit_)
    _close_rel(cp.numpy(), jp, 1e-4)


def test_spectral_precond_is_masked_inverse():
    """The capacitance-corrected spectral-domain preconditioner applies
    the inverse of the masked operator on the fluid cells: against a dense
    float64 solve of the staircase cylinder's operator at 64x32, within
    1e-5 of max|z| (float32 transforms), and zero on the solid; and so
    does the 3D box path (JAX's generic one) on an 8^3 box with an outflow
    face and a 2^3 block."""
    sim = make_case("cylinder", shape=(64, 32), device="cpu").sim
    ts, top = sim.dctcg_solver, sim.op
    assert ts.cap_cinv is not None and ts.cap_vx is not None
    fluid = top.fluid.numpy().ravel() > 0
    n = fluid.size
    cols = []
    for j in range(n):
        e = torch.zeros(n, dtype=torch.float64)
        e[j] = 1.0
        cols.append(tpois.apply_A(top, e.reshape(sim.grid.shape)).ravel())
    a_ff = torch.stack(cols, dim=1).numpy()[np.ix_(fluid, fluid)]
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        sim.grid.shape).astype(np.float32)) * top.fluid
    want = np.zeros(n)
    want[fluid] = np.linalg.solve(a_ff, r.numpy().ravel()[fluid])
    z = ts._precond_apply(r, top.fluid).numpy().ravel()
    _close_rel(z, want, 1e-5)
    assert not z[~fluid].any()
    # the 3D obstacle (the box path since the sphere's slice)
    g3 = tgrid.GridSpec((8, 8, 8), (1.0, 1.0, 1.0))
    b3 = {(a, s): tbcs.BCSpec.wall((0.0, 0.0, 0.0)) for a in range(3)
          for s in (0, 1)}
    b3[(0, 1)] = tbcs.BCSpec.outflow()
    solid = np.zeros(g3.shape, bool)
    solid[3:5, 3:5, 3:5] = True
    s3 = tfft.DCTPCGSolver.build(g3, b3, "cpu", solid)
    assert s3.cap_wbox is not None and s3.cap_vx is None
    op3 = tpois.build_poisson_op(g3, b3, "cpu", solid)
    fl3 = op3.fluid.numpy().ravel() > 0
    n3 = fl3.size
    cols = [tpois.apply_A(op3, torch.eye(n3, dtype=torch.float64)[j]
                          .reshape(g3.shape)).ravel() for j in range(n3)]
    a3 = torch.stack(cols, dim=1).numpy()[np.ix_(fl3, fl3)]
    r3 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        g3.shape).astype(np.float32)) * op3.fluid
    want3 = np.zeros(n3)
    want3[fl3] = np.linalg.solve(a3, r3.numpy().ravel()[fl3])
    z3 = s3._precond_apply(r3, op3.fluid).numpy().ravel()
    _close_rel(z3, want3, 1e-5)
    assert not z3[~fl3].any()


def test_dctcg_cavity_steps_match_jax():
    """No obstacle, all walls: the singular operator takes no capacitance
    correction, and dctcg is flexible CG around the plain spectral
    inverse, in both packages."""
    kw = dict(shape=(32, 32), re=100.0, poisson_method="dctcg")
    jc = jax_make_case("cavity", **kw)
    tc = make_case("cavity", device="cpu", **kw)
    assert tc.sim.fused and tc.sim.dctcg_solver.cap_cinv is None
    js, jd = jc.sim.run_scan(jc.initial_state(), 3)
    ts, td = tc.sim.run_scan(tc.initial_state(), 3)
    assert td.poisson_iters.tolist() == np.asarray(jd.poisson_iters).tolist()
    u, p = convert.state_to_numpy(ts)
    for a in range(2):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-6)
    assert (td.poisson_res <= 1e-5).all()
