"""PyTorch port vs JAX package: the fused 3D kernels' wrappers on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; these tests
hold that to the JAX package, with the tolerances of the JAX package's own
interpret-parity tests (tests/test_fused_step.py): u* rtol=atol=1e-5, RHS
rtol 1e-4 with atol 3e-7 max|RHS|, diagnostics rtol 1e-4. The jnp route is
built as ``test_fused_step._check`` builds it; the ``heavy`` cases run the
JAX Pallas wrappers in interpret mode, one kernel each. The CUDA kernels
themselves are held to these plain versions on the card
(tests/test_torch_cavity.py, ``cuda`` marker, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import fused3d
from navierstokessolver_tpu_torch.ops import poisson as tpois

DT, NU, RHO = 1e-3, 0.02, 1.3
LID = (1.0, 0.3, 0.0)


def _setup(shape, lengths):
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[(2, 1)] = jbcs.BCSpec.wall(LID)
    tb[(2, 1)] = tbcs.BCSpec.wall(LID)
    return jg, tg, jb, tb


def _state(jg, jb, seed=0):
    """A random BC-consistent velocity, as JAX arrays and as port tensors."""
    rng = np.random.default_rng(seed)
    u = tuple(jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(np.float32))
              for a in range(3))
    ju = jbcs.apply_velocity_bcs(jg, jb, u)
    return ju, convert.state_from_numpy([np.asarray(c) for c in ju],
                                        np.zeros(jg.shape, np.float32)).u


def _close(got, ref, rtol, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _jnp_predictor(jg, jb, ju, gamma):
    ustar = jst.predictor(jg, jb, ju, jnp.float32(DT), NU, gamma)
    ustar = jbcs.apply_velocity_bcs(jg, jb, ustar)
    return ustar, jst.divergence(jg, ustar) * (RHO / jnp.float32(DT))


@pytest.mark.parametrize("gamma", [0.0, 0.7])
def test_predictor_rhs_3d_vs_jnp(gamma):
    jg, tg, jb, tb = _setup((16, 12, 16), (1.0, 0.8, 1.0))
    ju, tu = _state(jg, jb)
    before = dict(fused3d.LAUNCHES)
    t_star, t_rhs = fused3d.predictor_rhs_3d(tg, tb, tu, DT, NU, gamma, RHO)
    assert fused3d.LAUNCHES == before      # CPU tensors: the plain version
    j_star, j_rhs = _jnp_predictor(jg, jb, ju, gamma)
    for a in range(3):
        assert tuple(t_star[a].shape) == tg.face_shape(a)
        _close(t_star[a], j_star[a], 1e-5, 1e-5)
    _close(t_rhs, j_rhs, 1e-4, 3e-7 * float(jnp.max(jnp.abs(j_rhs))))


def test_correct_diag_3d_vs_jnp():
    jg, tg, jb, tb = _setup((16, 12, 16), (1.0, 0.8, 1.0))
    ju, tu = _state(jg, jb, seed=1)
    p = np.random.default_rng(2).normal(size=jg.shape).astype(np.float32)
    scale = DT / RHO
    t_new, t_div, t_vel = fused3d.correct_diag_3d(tg, tu, torch.from_numpy(p),
                                                  scale)
    j_new = jst.correct_velocity(jg, ju, jnp.asarray(p), scale)
    for a in range(3):
        _close(t_new[a], j_new[a], 1e-5, 1e-5)
    div_ref = jnp.max(jnp.abs(jst.divergence(jg, j_new)))
    cfl_ref = jst.max_cfl(jg, j_new, jnp.float32(DT))
    _close(t_div, div_ref, 1e-4, 1e-5)
    _close(t_vel * DT, cfl_ref, 1e-4, 1e-6)


def test_correct_diag_propagates_nan():
    """A NaN in the field shows up in both diagnostics, as jnp.max does."""
    tg = tgrid.GridSpec((8, 6, 4), (1.0, 1.0, 1.0))
    u = [torch.zeros(tg.face_shape(a)) for a in range(3)]
    u[1][3, 2, 1] = float("nan")
    _, div, vel = fused3d.correct_diag_3d(tg, u, torch.zeros(tg.shape), 0.1)
    assert torch.isnan(div) and torch.isnan(vel)


def test_residual_3d_vs_jnp():
    jg, tg, jb, tb = _setup((16, 12, 16), (1.0, 0.8, 1.0))
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    rng = np.random.default_rng(3)
    p = rng.normal(size=jg.shape).astype(np.float32)
    b = rng.normal(size=jg.shape).astype(np.float32)
    ref = (jnp.asarray(b) - jpois.apply_A(jop, jnp.asarray(p))) * jop.fluid
    got = fused3d.residual_3d(top, torch.from_numpy(p), torch.from_numpy(b))
    _close(got, ref, 1e-5, 1e-6 * float(jnp.max(jnp.abs(ref))))


def test_wrappers_check_inputs():
    """A tensor neither on the CPU nor on a CUDA device is refused (no
    silent route), as are wrong shapes, dtypes and layouts."""
    tg = tgrid.GridSpec((8, 6, 4), (1.0, 1.0, 1.0))
    tb = tbcs.no_slip_box(tg)
    u = [torch.zeros(tg.face_shape(a)) for a in range(3)]
    meta = [c.to("meta") for c in u]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        fused3d.predictor_rhs_3d(tg, tb, meta, DT, NU)
    with pytest.raises(ValueError, match="shape"):
        fused3d.predictor_rhs_3d(tg, tb, [u[1], u[0], u[2]], DT, NU)
    with pytest.raises(TypeError, match="dtype"):
        fused3d.correct_diag_3d(tg, [c.double() for c in u],
                                torch.zeros(tg.shape), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused3d.correct_diag_3d(tg, u, torch.zeros(tg.shape[::-1]).permute(2, 1, 0), 0.1)
    op = tpois.build_poisson_op(tg, tb, "cpu")
    with pytest.raises(ValueError, match="3D"):
        fused3d.residual_3d(op, torch.zeros(8, 6), torch.zeros(8, 6))
    assert fused3d.fused_step3d_applicable(tg, tb)
    assert not fused3d.fused_step3d_applicable(
        tgrid.GridSpec((8, 8), (1.0, 1.0)), tbcs.no_slip_box(tg))


# -- the JAX Pallas kernels in interpret mode (heavy tier) --------------------

HEAVY_SHAPE, HEAVY_LENGTHS = (16, 8, 8), (1.0, 0.5, 0.5)


@pytest.mark.heavy
def test_predictor_rhs_3d_vs_pallas_interpret():
    jg, tg, jb, tb = _setup(HEAVY_SHAPE, HEAVY_LENGTHS)
    ju, tu = _state(jg, jb, seed=4)
    n0, n1, n2 = jg.shape
    (o0, o1, o2), j_rhs = jpk.predictor_rhs_3d(
        jg, jb, ju, DT, NU, 0.8, rho=RHO, tile=8, interpret=True)
    t_star, t_rhs = fused3d.predictor_rhs_3d(tg, tb, tu, DT, NU, 0.8, RHO)
    _close(t_star[0], o0[: n0 + 1, :n1, :n2], 1e-5, 1e-5)
    _close(t_star[1], o1[:n0, : n1 + 1, :n2], 1e-5, 1e-5)
    # the internal layout elides comp 2's last face (a BC value)
    _close(t_star[2][:, :, :n2], o2[:n0, :n1, :n2], 1e-5, 1e-5)
    _close(t_rhs, j_rhs, 1e-4, 3e-7 * float(jnp.max(jnp.abs(j_rhs))))


@pytest.mark.heavy
def test_correct_diag_3d_vs_pallas_interpret():
    jg, tg, jb, tb = _setup(HEAVY_SHAPE, HEAVY_LENGTHS)
    ju, tu = _state(jg, jb, seed=5)
    p = np.random.default_rng(6).normal(size=jg.shape).astype(np.float32)
    scale = DT / RHO
    iu = jpk.to_internal_3d(jg, ju, 8)
    j_new, j_div, j_vel = jpk.correct_diag_3d(
        jg, jb, iu, jnp.asarray(p), scale, tile=8, interpret=True)
    t_new, t_div, t_vel = fused3d.correct_diag_3d(tg, tu, torch.from_numpy(p),
                                                  scale)
    for a in range(3):
        _close(t_new[a], j_new[a], 1e-5, 1e-5)
    _close(t_div, j_div, 1e-4, 1e-5)
    _close(t_vel, j_vel, 1e-4, 1e-6)


@pytest.mark.heavy
def test_residual_3d_vs_pallas_interpret():
    jg, tg, jb, tb = _setup(HEAVY_SHAPE, HEAVY_LENGTHS)
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    rng = np.random.default_rng(7)
    p = rng.normal(size=jg.shape).astype(np.float32)
    b = rng.normal(size=jg.shape).astype(np.float32)
    ref = jpk.residual_3d(jop, jnp.asarray(p), jnp.asarray(b), interpret=True)
    got = fused3d.residual_3d(top, torch.from_numpy(p), torch.from_numpy(b))
    _close(got, ref, 1e-5, 1e-6 * float(jnp.max(jnp.abs(ref))))
