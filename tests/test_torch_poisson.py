"""PyTorch port vs JAX package: Poisson operator and the DCT direct solve.

The operator data is built from the same numpy code in both packages, so
``diag`` and ``code`` must be bit-equal. The direct solve runs dense GEMM
chains in another association order than JAX's tensordots: rtol 1e-5
(plus 1e-5 of max|p| near zero) on the pressure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import fft_poisson as jfft
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import fft_poisson as tfft
from navierstokessolver_tpu_torch.ops import fused3d
from navierstokessolver_tpu_torch.ops import poisson as tpois

SHAPES = {3: ((12, 10, 8), (1.0, 0.8, 1.2)), 2: ((16, 12), (1.0, 0.75))}


def _setup(dim):
    shape, lengths = SHAPES[dim]
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    return jg, tg, jb, tb


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("dim,with_solid", [(2, False), (3, False),
                                            (3, True)])
def test_build_poisson_op_bit_equal(dim, with_solid):
    jg, tg, jb, tb = _setup(dim)
    solid = None
    if with_solid:   # the builder's obstacle rows, for the ports to come
        solid = np.zeros(tg.shape, bool)
        solid[3:6, 2:5, 1:4] = True
    jop = jpois.build_poisson_op(jg, jb, solid)
    top = tpois.build_poisson_op(tg, tb, "cpu", solid)
    np.testing.assert_array_equal(top.diag.numpy(), np.asarray(jop.diag))
    np.testing.assert_array_equal(top.code.numpy(), np.asarray(jop.code))
    assert top.code.dtype == torch.uint8
    assert top.w == jop.w and top.singular == jop.singular
    assert top.inv_fluid_count == jop.inv_fluid_count
    np.testing.assert_array_equal(top.fluid.numpy(), np.asarray(jop.fluid))
    # the carry-across gives the same operator
    cop = convert.poisson_op_from_numpy(
        np.asarray(jop.diag), np.asarray(jop.code), jop.w, jop.singular,
        jop.inv_fluid_count, jop.periodic,
    )
    np.testing.assert_array_equal(cop.diag.numpy(), top.diag.numpy())
    np.testing.assert_array_equal(cop.code.numpy(), top.code.numpy())


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_A_deflate_residual(dim):
    jg, tg, jb, tb = _setup(dim)
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    p, b = _rand(tg.shape, 0), _rand(tg.shape, 1)
    tp, tb_ = torch.from_numpy(p), torch.from_numpy(b)
    _close(tpois.apply_A(top, tp), jpois.apply_A(jop, jnp.asarray(p)), 1e-6)
    _close(tpois.deflate(top, tp), jpois.deflate(jop, jnp.asarray(p)), 1e-6)
    _close(fused3d.residual_plain(top, tp, tb_),
           (jnp.asarray(b) - jpois.apply_A(jop, jnp.asarray(p))) * jop.fluid,
           1e-6)
    np.testing.assert_allclose(
        float(tpois.residual_norm(top, tp, tb_)),
        float(jpois.residual_norm(jop, jnp.asarray(p), jnp.asarray(b))),
        rtol=1e-5,
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_dct_solver_constants(dim):
    jg, tg, jb, tb = _setup(dim)
    js = jfft.DCTPoissonSolver.build(jg, kinds=jfft.axis_kinds_from_bcs(jg, jb))
    ts = tfft.DCTPoissonSolver.build(tg, "cpu",
                                     kinds=tfft.axis_kinds_from_bcs(tg, tb))
    assert ts.kinds == js.kinds == ("nn",) * dim
    assert ts.singular and js.singular
    # JAX stores the multiplier axis-reversed; the port in natural order
    rev = tuple(range(dim - 1, -1, -1))
    np.testing.assert_array_equal(
        ts.inv_eig.numpy(), np.transpose(np.asarray(js.inv_eig), rev)
    )
    for a in range(dim):
        assert js.plans[a].levels == 0
        np.testing.assert_array_equal(ts.plans[a].base_fwd.numpy(),
                                      np.asarray(js.plans[a].base_fwd))
        np.testing.assert_array_equal(ts.plans[a].base_inv.numpy(),
                                      np.asarray(js.plans[a].base_inv))
    # self-check error: both at float32 transform roundoff
    assert ts._self_check_error() < 1e-4
    assert abs(ts._self_check_error() - js._self_check_error(js.kinds)) < 1e-4


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("diag_residual", [True, False])
def test_solve_with_residual(dim, diag_residual):
    jg, tg, jb, tb = _setup(dim)
    jop = jpois.build_poisson_op(jg, jb)
    js = jfft.DCTPoissonSolver.build(jg, kinds=jfft.axis_kinds_from_bcs(jg, jb))
    top = tpois.build_poisson_op(tg, tb, "cpu")
    ts = tfft.DCTPoissonSolver.build(tg, "cpu")
    b = _rand(tg.shape, 2)
    jp, jit, jres = jfft.solve_with_residual(js, jop, jnp.asarray(b),
                                             diag_residual=diag_residual)
    tp, tit, tres = tfft.solve_with_residual(ts, top, torch.from_numpy(b),
                                             diag_residual=diag_residual)
    _close(tp, jp, 1e-5)
    assert int(tit) == int(jit) == 1
    if diag_residual:
        # both at float32 roundoff of the refined solve
        assert 0.0 <= float(tres) < 1e-5 and 0.0 <= float(jres) < 1e-5
    else:
        assert float(tres) == float(jres) == -1.0
    # a port solver carried across from the JAX constants solves the same
    cs = convert.dct_solver_from_numpy(
        tg, np.asarray(js.inv_eig), [np.asarray(p.base_fwd) for p in js.plans],
        [np.asarray(p.base_inv) for p in js.plans],
    )
    _close(cs.solve(torch.from_numpy(b), top), tp, 1e-6)


def test_self_check_failure_raises(monkeypatch):
    tg = tgrid.GridSpec((8, 8, 8), (1.0, 1.0, 1.0))
    monkeypatch.setattr(tfft.DCTPoissonSolver, "_direct",
                        lambda self, b: torch.zeros_like(b))
    with pytest.raises(RuntimeError, match="self-check failed"):
        tfft.DCTPoissonSolver.build(tg, "cpu")


def test_not_ported_options_raise():
    assert tpois.PoissonConfig(method="dctcg").method == "dctcg"
    with pytest.raises(ValueError, match="unknown poisson method"):
        tpois.PoissonConfig(method="multigrid")
    # a periodic axis of 1024 or more takes JAX's split circulant plan,
    # which is not ported
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tfft.DCTPoissonSolver.build(tgrid.GridSpec((8, 1024), (1.0, 1.0)),
                                    "cpu", kinds=("nn", "per"))
