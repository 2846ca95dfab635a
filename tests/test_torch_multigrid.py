"""PyTorch port vs JAX package: the multigrid hierarchy, its transfers, the
three level kernels' plain versions and the V-cycle solves, on the CPU.

The level operators come from the same numpy builder in both packages, so
``diag`` and ``code`` must be bit-equal at every level. The kernels' plain
versions are held to the JAX Pallas kernels run in interpret mode
(``interpret=True, tile=64``, as tests/test_pallas_mg.py and
tests/test_pallas.py call them), with those tests' tolerances: p atol 3e-5
on O(1) random fields; the residual atol 2e-2 against the JAX residual of
the same iterate (the residual of a 3e-5 sweep difference would be
amplified by w ~ 1/h^2 ~ 2.6e4); the post kernel's sum of squares rtol
1e-3. The solves: cycle counts within one of each other (a residual
sitting on tol can shift the count by one), p relative error below 1e-3
(tests/test_pallas_mg.py::test_fused_solve_matches_jnp_solve). The CUDA
kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import multigrid as jmg
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import multigrid as tmg
from navierstokessolver_tpu_torch.ops import multigrid_kernels as tmk
from navierstokessolver_tpu_torch.ops import poisson as tpois

LENGTHS = (2.0, 1.0)


def _problem(shape, solid_block=False, outflow=False, block=(60, 100, 40, 80)):
    """(JAX grid, bcs, solid) and the port's grid and bcs."""
    jg = jgrid.GridSpec(shape, LENGTHS)
    tg = tgrid.GridSpec(shape, LENGTHS)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    if outflow:
        jb[(0, 1)] = jbcs.BCSpec.outflow()
        tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.OUTFLOW)
    solid = None
    if solid_block:
        solid = np.zeros(shape, bool)
        i0, i1, j0, j1 = block
        solid[i0:i1, j0:j1] = True
    return jg, jb, tg, tb, solid


def _fields(jop, seed, n=3):
    """``n`` O(1) random fields, zero on solid cells (the p = p*fluid
    invariant), as numpy float32."""
    rng = np.random.default_rng(seed)
    fl = np.asarray(jop.fluid)
    return [(rng.normal(size=fl.shape) * fl).astype(np.float32)
            for _ in range(n)]


def _port_op(jop):
    return convert.poisson_op_from_numpy(
        np.asarray(jop.diag), np.asarray(jop.code), jop.w, jop.singular,
        jop.inv_fluid_count, jop.periodic)


@pytest.mark.parametrize("solid_block", [False, True])
def test_hierarchy_bit_equal(solid_block):
    jg, jb, tg, tb, solid = _problem((192, 160), solid_block=solid_block)
    jsol = jmg.MGPoissonSolver.build(jg, jb, solid)
    tsol = tmg.MGPoissonSolver.build(tg, tb, "cpu", solid)
    assert len(tsol.ops) == len(jsol.ops) == 6      # 192x160 ... 6x5
    assert tsol.coarse_omega == jsol.coarse_omega
    assert not tsol.fused and not tsol.use_pallas   # CPU defaults
    for tl, jl in zip(tsol.ops, jsol.ops):
        np.testing.assert_array_equal(tl.diag.numpy(), np.asarray(jl.diag))
        np.testing.assert_array_equal(tl.code.numpy(), np.asarray(jl.code))
        assert tl.w == jl.w and tl.singular == jl.singular
        assert tl.inv_fluid_count == jl.inv_fluid_count
    # the carry-across gives the same hierarchy
    cs = convert.mg_solver_from_numpy(
        [(np.asarray(o.diag), np.asarray(o.code), o.w, o.singular,
          o.inv_fluid_count, o.periodic) for o in jsol.ops],
        coarse_omega=jsol.coarse_omega)
    for cl, tl in zip(cs.ops, tsol.ops):
        np.testing.assert_array_equal(cl.code.numpy(), tl.code.numpy())
        np.testing.assert_array_equal(cl.diag.numpy(), tl.diag.numpy())
    assert cs.coarse_omega == tsol.coarse_omega and not cs.fused


@pytest.mark.parametrize("shape,periodic", [
    ((12, 8), (False, False)),
    ((12, 8), (True, False)),
    ((6, 4, 8), (False, False, True)),
])
def test_restrict_prolong_match_jax(shape, periodic):
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(
        tmg._restrict(torch.from_numpy(x)).numpy(),
        np.asarray(jmg._restrict(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tmg._prolong(torch.from_numpy(x), periodic).numpy(),
        np.asarray(jmg._prolong(jnp.asarray(x), periodic)),
        rtol=1e-6, atol=1e-7)
    solid = rng.random(size=shape) < 0.7
    np.testing.assert_array_equal(tmg._coarsen_solid(solid),
                                  jmg._coarsen_solid(solid))
    assert tmg._can_coarsen(shape) == jmg._can_coarsen(shape)


# the operators of tests/test_pallas_mg.py (192x160, block 60:100 x 40:80)
# and tests/test_pallas.py (160x128, block 40:80 x 30:60)
MG_OPS = {"walls": ((192, 160), False, (60, 100, 40, 80)),
          "obstacle-outflow": ((192, 160), True, (60, 100, 40, 80))}
RB_OPS = {"walls": ((160, 128), False, (40, 80, 30, 60)),
          "obstacle-outflow": ((160, 128), True, (40, 80, 30, 60))}


def _kernel_case(table, name, seed):
    shape, obstacle, block = table[name]
    jg, jb, _, _, solid = _problem(shape, solid_block=obstacle,
                                   outflow=obstacle, block=block)
    jop = jpois.build_poisson_op(jg, jb, solid)
    return jop, _port_op(jop), _fields(jop, seed)


@pytest.mark.parametrize("name,omega,nsweeps", [
    ("walls", 1.0, 1), ("walls", 1.3, 3), ("obstacle-outflow", 1.0, 2)])
def test_mg_pre_plain_matches_jax_kernel(name, omega, nsweeps):
    jop, top, (p0, b, _) = _kernel_case(MG_OPS, name, 7)
    jp, jr = jpk.mg_pre_sweeps_residual(jop, jnp.asarray(p0), jnp.asarray(b),
                                        nsweeps, omega, tile=64,
                                        interpret=True)
    tp, tr = tmk.mg_pre_sweeps_residual(top, torch.from_numpy(p0),
                                        torch.from_numpy(b), nsweeps, omega)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=3e-5)
    ref_r = (jnp.asarray(b) - jpois.apply_A(jop, jnp.asarray(tp.numpy()))
             ) * jop.fluid
    np.testing.assert_allclose(tr.numpy(), np.asarray(ref_r), atol=2e-2)
    fl = top.fluid.numpy()
    assert np.abs(tp.numpy() * (1 - fl)).max() == 0.0
    assert np.abs(tr.numpy() * (1 - fl)).max() == 0.0


@pytest.mark.parametrize("name", ["walls", "obstacle-outflow"])
def test_mg_post_plain_matches_jax_kernel(name):
    jop, top, (p0, b, e) = _kernel_case(MG_OPS, name, 7)
    jp, jrsq = jpk.mg_add_post_sweeps(jop, jnp.asarray(p0), jnp.asarray(b),
                                      jnp.asarray(e), 2, 1.0, tile=64,
                                      interpret=True)
    tp, trsq = tmk.mg_add_post_sweeps(top, torch.from_numpy(p0),
                                      torch.from_numpy(b),
                                      torch.from_numpy(e), 2, 1.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=3e-5)
    rn = jpois.residual_norm(jop, jnp.asarray(tp.numpy()), jnp.asarray(b))
    np.testing.assert_allclose(float(torch.sqrt(trsq)), float(rn),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(trsq), float(jrsq), rtol=1e-3)


@pytest.mark.parametrize("name,omega,nsweeps", [
    ("walls", 1.0, 1), ("walls", 1.45, 3), ("obstacle-outflow", 1.0, 2)])
def test_rb_sweeps_plain_matches_jax_kernel(name, omega, nsweeps):
    jop, top, (p0, b, _) = _kernel_case(RB_OPS, name, 3)
    jp = jpk.rb_sweeps(jop, jnp.asarray(p0), jnp.asarray(b), omega, nsweeps,
                       tile=64, interpret=True)
    tp = tmk.rb_sweeps(top, torch.from_numpy(p0), torch.from_numpy(b),
                       omega, nsweeps)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=3e-5)
    assert np.abs(tp.numpy() * (1 - top.fluid.numpy())).max() == 0.0


def test_kernel_gates_match_jax():
    for shape in ((192, 160), (96, 160), (128, 128), (192, 160, 8)):
        assert (tmk.rb_sweeps_applicable(shape, torch.float32)
                == jpk.rb_sweeps_applicable(shape, jnp.float32))
    jg, jb, tg, tb, _ = _problem((192, 160))
    assert tmk.mg_fused_applicable(tpois.build_poisson_op(tg, tb, "cpu"))
    assert jpk.mg_fused_applicable(jpois.build_poisson_op(jg, jb))
    jb[(0, 0)] = jbcs.BCSpec.periodic()
    jb[(0, 1)] = jbcs.BCSpec.periodic()
    assert not tmk.mg_fused_applicable(_port_op(jpois.build_poisson_op(jg, jb)))
    with pytest.raises(ValueError, match="n_sweeps"):
        tmk.rb_sweeps(tpois.build_poisson_op(tg, tb, "cpu"),
                      torch.zeros(tg.shape), torch.zeros(tg.shape), 1.0, 9)


@pytest.mark.parametrize("method", ["solve", "solve_pcg"])
def test_fused_solve_matches_jax(method):
    """The port's fused route on the CPU (the kernels' plain versions)
    against the JAX solver's fused route in interpret mode, on the
    obstacle + outflow problem of tests/test_pallas_mg.py; tol 2e-4 sits
    above the float32 residual floor (~5e-5 here)."""
    jg, jb, tg, tb, solid = _problem((192, 160), solid_block=True,
                                     outflow=True)
    jbase = jmg.MGPoissonSolver.build(jg, jb, solid, fused=False)
    jfused = dataclasses.replace(jbase, fused=True, interpret=True)
    tsol = tmg.MGPoissonSolver.build(tg, tb, "cpu", solid, fused=True)
    assert jfused._fused_ok(0) and tsol._fused_ok(0)
    assert not tsol._fused_ok(1)                     # 96x80: plain
    op = jbase.ops[0]
    b = (np.random.default_rng(11).normal(size=(192, 160))
         * np.asarray(op.fluid)).astype(np.float32)
    p0 = np.zeros_like(b)
    jrun = jax.jit(lambda b, p: getattr(jfused, method)(b, p, 2e-4, 30))
    jp, jk, jres = jrun(jnp.asarray(b), jnp.asarray(p0))
    tp, tk, tres = getattr(tsol, method)(torch.from_numpy(b),
                                         torch.from_numpy(p0), 2e-4, 30)
    assert abs(int(tk) - int(jk)) <= 1, (int(tk), int(jk))
    assert float(tres) < 2e-4 and float(jres) < 2e-4
    jp = np.asarray(jp)
    rel = np.linalg.norm(tp.numpy() - jp) / max(np.linalg.norm(jp), 1e-30)
    assert rel < 1e-3, rel
    assert tp.dtype == torch.float32 and tk.dtype == torch.int32


def test_mg_build_options():
    _, _, tg, tb, _ = _problem((64, 32))
    sol = tmg.MGPoissonSolver.build(tg, tb, "cpu", max_levels=3)
    assert [tuple(o.diag.shape) for o in sol.ops] == [(64, 32), (32, 16),
                                                     (16, 8)]
    assert sol.coarse_omega == pytest.approx(2.0 / (1.0 + np.sin(np.pi / 8)))
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        tmg.MGPoissonSolver.build(tg, tb, "cpu", sdf=lambda x, y: x)
