"""PyTorch port vs JAX package: the fused 2D kernels' wrappers on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; these tests
hold that to the JAX package's jnp composition (stencils.predictor ->
apply_velocity_bcs -> divergence, and correct_velocity -> diagnostics),
with the tolerances of the JAX package's own 2D interpret-parity tests
(tests/test_pallas2d.py): u*, v* and the corrected velocity atol 2e-6 on
O(0.1) fields, the RHS atol 2e-6 max(max|RHS|, 1), max|div u| rtol 1e-3
(and max|u_a|/h_a rtol 1e-4, as in 3D). The ``heavy`` case runs the JAX
Pallas wrappers in interpret mode. The CUDA kernels themselves are held to
these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import pallas_2d as jp2
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import fused2d

DT, NU, RHO = 1e-3, 0.01, 1.3
SCALE = 5e-3
LID = (1.0, 0.0)
SHAPES = {(64, 48): (1.0, 0.75), (40, 24): (1.0, 0.6)}


def _setup(shape):
    lengths = SHAPES[shape]
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[(1, 1)] = jbcs.BCSpec.wall(LID)    # moving lid on the y-hi face
    tb[(1, 1)] = tbcs.BCSpec.wall(LID)
    return jg, tg, jb, tb


def _state(jg, jb, seed):
    """A random BC-consistent O(0.1) velocity, as JAX arrays and as port
    tensors."""
    rng = np.random.default_rng(seed)
    u = tuple(jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(np.float32))
              * 0.1 for a in range(2))
    ju = jbcs.apply_velocity_bcs(jg, jb, u)
    return ju, convert.state_from_numpy([np.asarray(c) for c in ju],
                                        np.zeros(jg.shape, np.float32)).u


def _pressure(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.01


def _close(got, ref, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _rhs_atol(ref):
    # the RHS carries rho/dt (values up to ~1e4 on a random field)
    return 2e-6 * max(float(jnp.max(jnp.abs(ref))), 1.0)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_predictor_rhs_2d_vs_jnp(shape, gamma):
    jg, tg, jb, tb = _setup(shape)
    ju, tu = _state(jg, jb, seed=0)
    before = dict(fused2d.LAUNCHES)
    t_star, t_rhs = fused2d.predictor_rhs_2d(tg, tb, tu, DT, NU, gamma, RHO)
    assert fused2d.LAUNCHES == before      # CPU tensors: the plain version
    j_star = jst.predictor(jg, jb, ju, jnp.float32(DT), NU, gamma)
    j_star = jbcs.apply_velocity_bcs(jg, jb, j_star)
    j_rhs = jst.divergence(jg, j_star) * (RHO / jnp.float32(DT))
    for a in range(2):
        assert tuple(t_star[a].shape) == tg.face_shape(a)
        _close(t_star[a], j_star[a], 2e-6)
    _close(t_rhs, j_rhs, _rhs_atol(j_rhs))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_correct_diag_2d_vs_jnp(shape):
    jg, tg, jb, tb = _setup(shape)
    ju, tu = _state(jg, jb, seed=1)
    p = _pressure(shape, 2)
    t_new, t_div, t_vel = fused2d.correct_diag_2d(tg, tu, torch.from_numpy(p),
                                                  SCALE)
    j_new = jst.correct_velocity(jg, ju, jnp.asarray(p), SCALE)
    for a in range(2):
        _close(t_new[a], j_new[a], 2e-6)
    _close(t_div, jnp.max(jnp.abs(jst.divergence(jg, j_new))), 0.0, 1e-3)
    _close(t_vel * DT, jst.max_cfl(jg, j_new, jnp.float32(DT)), 1e-8, 1e-4)


def test_correct_diag_2d_propagates_nan():
    """A NaN in the field shows up in both diagnostics, as jnp.max does."""
    tg = tgrid.GridSpec((8, 6), (1.0, 1.0))
    u = [torch.zeros(tg.face_shape(a)) for a in range(2)]
    u[1][3, 2] = float("nan")
    _, div, vel = fused2d.correct_diag_2d(tg, u, torch.zeros(tg.shape), 0.1)
    assert torch.isnan(div) and torch.isnan(vel)


def test_wrappers_2d_check_inputs():
    """A tensor neither on the CPU nor on a CUDA device is refused (no
    silent route), as are wrong shapes, dtypes, layouts and dimensions."""
    tg = tgrid.GridSpec((8, 6), (1.0, 1.0))
    tb = tbcs.no_slip_box(tg)
    u = [torch.zeros(tg.face_shape(a)) for a in range(2)]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        fused2d.predictor_rhs_2d(tg, tb, [c.to("meta") for c in u], DT, NU)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        fused2d.correct_diag_2d(tg, [c.to("meta") for c in u],
                                torch.zeros(tg.shape, device="meta"), 0.1)
    with pytest.raises(ValueError, match="shape"):
        fused2d.predictor_rhs_2d(tg, tb, [u[1], u[0]], DT, NU)
    with pytest.raises(TypeError, match="dtype"):
        fused2d.correct_diag_2d(tg, [c.double() for c in u],
                                torch.zeros(tg.shape), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused2d.correct_diag_2d(tg, u, torch.zeros(6, 8).T, 0.1)
    g3 = tgrid.GridSpec((8, 6, 4), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="2D"):
        fused2d.correct_diag_2d(g3, [torch.zeros(g3.face_shape(a))
                                     for a in range(3)],
                                torch.zeros(g3.shape), 0.1)
    assert fused2d.fused_step2d_applicable(tg, tb)
    assert not fused2d.fused_step2d_applicable(g3, tbcs.no_slip_box(g3))
    np.testing.assert_array_equal(
        fused2d.bc_table(tg, {**tb, (1, 1): tbcs.BCSpec.wall(LID)}, "cpu"),
        [0, 0, 0, 0, 0, 0, 1, 0])


# -- the JAX Pallas kernels in interpret mode (heavy tier) --------------------


@pytest.mark.heavy
def test_fused2d_vs_pallas_interpret():
    """Both wrappers against ``predictor_rhs_2d_internal`` and
    ``correct_diag_2d_internal`` run as tests/test_pallas2d.py runs them:
    tile 32, through the internal layout and back."""
    shape, gamma = (64, 48), 0.8
    jg, tg, jb, tb = _setup(shape)
    ju, tu = _state(jg, jb, seed=3)
    iu = jp2.to_internal_2d(jg, ju, tile=32)
    j_istar, j_rhs = jp2.predictor_rhs_2d_internal(
        jg, jb, iu, DT, NU, gamma, rho=RHO, tile=32, interpret=True)
    j_star = jp2.from_internal_2d(jg, jb, j_istar)
    t_star, t_rhs = fused2d.predictor_rhs_2d(tg, tb, tu, DT, NU, gamma, RHO)
    for a in range(2):
        _close(t_star[a], j_star[a], 2e-6)
    _close(t_rhs, j_rhs, _rhs_atol(j_rhs))

    p = _pressure(shape, 4)
    j_inew, j_div, j_vel = jp2.correct_diag_2d_internal(
        jg, jb, j_istar, jnp.asarray(p), SCALE, tile=32, interpret=True)
    j_new = jp2.from_internal_2d(jg, jb, j_inew)
    t_new, t_div, t_vel = fused2d.correct_diag_2d(
        tg, t_star, torch.from_numpy(p), SCALE)
    for a in range(2):
        _close(t_new[a], j_new[a], 2e-6)
    _close(t_div, j_div, 0.0, 1e-3)
    _close(t_vel, j_vel, 0.0, 1e-4)
