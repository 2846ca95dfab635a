"""PyTorch port vs JAX package: BCs and stencils, numpy-seeded inputs.

Both packages run on the CPU in this process and get the same float32
arrays. The port writes the JAX package's arithmetic in the same order,
so the tolerance is float32 roundoff: rtol 1e-6 (plus 1e-6 of the field's
largest magnitude for entries near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import stencils as tst

CASES = {
    3: ((12, 10, 8), (1.0, 0.8, 1.2), (1.0, 0.3, 0.0)),
    2: ((12, 10), (1.0, 0.8), (1.0, 0.0)),
}


def _setup(dim):
    shape, lengths, lid = CASES[dim]
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[(dim - 1, 1)] = jbcs.BCSpec.wall(lid)
    tb[(dim - 1, 1)] = tbcs.BCSpec.wall(lid)
    return jg, tg, jb, tb


def _fields(tg, seed=0):
    rng = np.random.default_rng(seed)
    u = [rng.normal(size=tg.face_shape(a)).astype(np.float32)
         for a in range(tg.ndim)]
    p = rng.normal(size=tg.shape).astype(np.float32)
    return u, p


def _close(got, ref, rtol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max() or 1.0)
    )


def _pair(u):
    return (tuple(jnp.asarray(c) for c in u),
            tuple(torch.from_numpy(c.copy()) for c in u))


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_velocity_bcs(dim):
    jg, tg, jb, tb = _setup(dim)
    ju, tu = _pair(_fields(tg)[0])
    for a, (got, ref) in enumerate(zip(
            tbcs.apply_velocity_bcs(tg, tb, tu),
            jbcs.apply_velocity_bcs(jg, jb, ju))):
        _close(got, ref)
    # the input is not modified
    np.testing.assert_array_equal(tu[0].numpy(), np.asarray(ju[0]))


@pytest.mark.parametrize("dim", [2, 3])
def test_pad_transverse(dim):
    jg, tg, jb, tb = _setup(dim)
    ju, tu = _pair(_fields(tg)[0])
    for comp in range(dim):
        _close(tbcs.pad_transverse(tg, tb, comp, tu[comp]),
               jbcs.pad_transverse(jg, jb, comp, ju[comp]))


@pytest.mark.parametrize("dim", [2, 3])
def test_divergence_and_centers(dim):
    jg, tg, jb, tb = _setup(dim)
    ju, tu = _pair(_fields(tg)[0])
    _close(tst.divergence(tg, tu), jst.divergence(jg, ju))
    for got, ref in zip(tgrid.interpolate_to_centers(tg, tu),
                        jgrid.interpolate_to_centers(jg, ju)):
        _close(got, ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_correct_velocity(dim):
    jg, tg, jb, tb = _setup(dim)
    u, p = _fields(tg)
    ju, tu = _pair(u)
    scale = 1e-3 / 1.3
    got = tst.correct_velocity(tg, tu, torch.from_numpy(p), scale)
    ref = jst.correct_velocity(jg, ju, jnp.asarray(p), scale)
    for a in range(dim):
        _close(got[a], ref[a])
        _close(tst.pressure_gradient(tg, torch.from_numpy(p), a),
               jst.pressure_gradient(jg, jnp.asarray(p), a))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_predictor(dim, gamma):
    jg, tg, jb, tb = _setup(dim)
    ju, tu = _pair(_fields(tg)[0])
    dt, nu = 1e-3, 0.02
    got = tst.predictor(tg, tb, tu, dt, nu, gamma)
    ref = jst.predictor(jg, jb, ju, jnp.float32(dt), nu, gamma)
    for a in range(dim):
        _close(got[a], ref[a])
        _close(tst.advection_component(tg, tb, tu, a, gamma),
               jst.advection_component(jg, jb, ju, a, gamma))
        _close(tst.laplacian_component(tg, tb, a, tu[a]),
               jst.laplacian_component(jg, jb, a, ju[a]))


def test_upwind_zero_velocity_takes_forward_difference():
    """jnp.where(vel > 0, bwd, fwd): a face with zero advecting velocity
    takes the forward difference, in both packages."""
    jg, tg, jb, tb = _setup(3)
    u, _ = _fields(tg, seed=3)
    u[0][5, :, :] = 0.0          # zero own-axis velocity on one face plane
    ju, tu = _pair(u)
    got = tst.advection_component(tg, tb, tu, 0, 1.0)
    ref = jst.advection_component(jg, jb, ju, 0, 1.0)
    _close(got, ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_max_cfl(dim):
    jg, tg, jb, tb = _setup(dim)
    ju, tu = _pair(_fields(tg)[0])
    _close(tst.max_cfl(tg, tu, 1e-3), jst.max_cfl(jg, ju, jnp.float32(1e-3)))


def test_bcs_reject_what_is_not_ported():
    tg = tgrid.GridSpec((8, 8, 8), (1.0, 1.0, 1.0))
    tb = tbcs.no_slip_box(tg)
    tbcs.validate_bcs(tg, tb)
    # OUTFLOW (INFLOW, SLIP) faces validate in 3D since the sphere's
    # slice; CONVECTIVE faces and 3D profiles still raise
    tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.OUTFLOW)
    tbcs.validate_bcs(tg, tb)
    tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.CONVECTIVE, (1.0,))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tbcs.validate_bcs(tg, tb)
    tb[(0, 1)] = tbcs.BCSpec.inflow((np.ones((1, 8, 8)), 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tbcs.validate_bcs(tg, tb)
    tb = tbcs.no_slip_box(tg)
    del tb[(1, 0)]
    with pytest.raises(ValueError, match="missing BC"):
        tbcs.validate_bcs(tg, tb)
    with pytest.raises(NotImplementedError, match="float32"):
        tgrid.GridSpec((8, 8), (1.0, 1.0), dtype=torch.float64)
