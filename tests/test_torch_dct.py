"""PyTorch port vs JAX package: the radix-split DCT and the split solve.

The factor matrices come from the same numpy code in both packages and
must be bit-equal. The transforms run GEMM chains in another association
order than JAX's tensordots (and with the axis kept in place), so they
agree to float32 roundoff: rtol 1e-5 (plus 1e-5 of max|X| near zero).
The split direct solve at (1024, 64) is held at the pressure tolerance of
the JAX package's whole-step tests, rtol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import dct as jdct
from navierstokessolver_tpu.ops import fft_poisson as jfft
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import dct as tdct
from navierstokessolver_tpu_torch.ops import fft_poisson as tfft
from navierstokessolver_tpu_torch.ops import poisson as tpois

HI = jax.lax.Precision.HIGHEST


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_split_dct_matches_jax(levels):
    n = 64
    jp = jdct.SplitPlan(n, levels, jnp.float32)
    tp = tdct.SplitPlan.build(n, levels, torch.float32, "cpu")
    assert tp.levels == levels and tp.n == n
    for name in ("d4", "d4inv"):
        for tm, jm in zip(getattr(tp, name), getattr(jp, name)):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.base_fwd.numpy(), np.asarray(jp.base_fwd))
    np.testing.assert_array_equal(tp.base_inv.numpy(), np.asarray(jp.base_inv))
    x = np.random.default_rng(levels).normal(size=(n, 12)).astype(np.float32)
    for axis, xa in ((0, x), (1, x.T.copy())):
        # JAX puts the transformed axis first; the port keeps it in place
        jX = jdct.split_dct_apply(jp, jnp.asarray(xa), axis, HI,
                                  block_order=True)
        tX = tdct.split_dct_apply(tp, torch.from_numpy(xa), axis)
        _close(tX.movedim(axis, 0), jX, 1e-5)
        jx = jdct.split_idct_apply(jp, jX, 0, HI, block_order=True)
        tx = tdct.split_idct_apply(tp, tX, axis)
        _close(tx.movedim(axis, 0), jx, 1e-5)
        _close(tx, xa, 1e-5)                       # exact inverse
    # block order: the natural-order DCT-II, permuted
    dense = tdct.dct2_matrix(n) @ x.astype(np.float64)
    perm = tdct.split_permutation(n, levels)
    _close(tdct.split_dct_apply(tp, torch.from_numpy(x), 0), dense[perm],
           1e-5)


@pytest.mark.parametrize("shape,levels", [((1024, 256), (3, 0)),
                                          ((1536, 64), (3, 0)),
                                          ((64, 48), (0, 0))])
def test_split_levels_match_jax(shape, levels):
    """The port's solver splits every axis as the JAX solver does, and
    holds the same constants (multiplier in natural axis order)."""
    jg = jgrid.GridSpec(shape, (1.0, 1.0))
    tg = tgrid.GridSpec(shape, (1.0, 1.0))
    js = jfft.DCTPoissonSolver.build(jg, kinds=("nn", "nn"))
    ts = tfft.DCTPoissonSolver.build(tg, "cpu", kinds=("nn", "nn"))
    assert tuple(p.levels for p in ts.plans) == levels
    assert tuple(p.levels for p in js.plans) == levels
    np.testing.assert_array_equal(ts.inv_eig.numpy(),
                                  np.asarray(js.inv_eig).T)
    for a in range(2):
        for tm, jm in zip(ts.plans[a].d4, js.plans[a].d4):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # an explicit level count is honored
    ts1 = tfft.DCTPoissonSolver.build(tg, "cpu", split_levels=1)
    assert tuple(p.levels for p in ts1.plans) == (1, 1)
    # float32 roundoff of transforms that sum up to ~1000 terms
    assert ts1._self_check_error() < 1e-3


def test_split_direct_solve_matches_jax():
    shape, lengths = (1024, 64), (1.0, 0.0625)     # h = 1/1024 on both axes
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    js = jfft.DCTPoissonSolver.build(jg, kinds=jfft.axis_kinds_from_bcs(jg, jb))
    assert js.plans[0].levels == 3
    b = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jp, _, jres = jfft.solve_with_residual(js, jop, jnp.asarray(b))
    cs = convert.dct_solver_from_numpy(
        tg, np.asarray(js.inv_eig),
        [np.asarray(p.base_fwd) for p in js.plans],
        [np.asarray(p.base_inv) for p in js.plans],
        d4=[[np.asarray(m) for m in p.d4] for p in js.plans],
    )
    ts = tfft.DCTPoissonSolver.build(tg, "cpu")
    np.testing.assert_array_equal(cs.inv_eig.numpy(), ts.inv_eig.numpy())
    for s in (cs, ts):
        tp, _, tres = tfft.solve_with_residual(s, top, torch.from_numpy(b))
        _close(tp, jp, 2e-4)
        # both at float32 roundoff of the refined solve (the residual of
        # a white-noise RHS at h = 1/1024 is ~2e-4 in both packages)
        assert 0.0 <= float(tres) < 1e-3 and 0.0 <= float(jres) < 1e-3
