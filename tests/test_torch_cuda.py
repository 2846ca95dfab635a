"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. No JAX import, so the file also runs on a
machine without JAX; on the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances are those of the JAX package's interpret-parity tests
(tests/test_fused_step.py); the residual's atol is 1e-6 of max|r| (float32
roundoff of a sum whose terms reach 12 w max|p|, w = 1/h^2).
"""

import pytest
import torch

from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.ops import fused3d
from navierstokessolver_tpu_torch.ops import poisson as tpois


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_cuda_kernels_match_plain(cuda_device, gamma):
    tg = tgrid.GridSpec((40, 24, 72), (1.0, 0.6, 1.8))
    tb = tbcs.no_slip_box(tg)
    tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    u = tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(3)))
    fused3d.reset_launch_counts()
    ks, krhs = fused3d.predictor_rhs_3d(tg, tb, u, 1e-3, 0.02, gamma, 1.3)
    ps, prhs = fused3d.predictor_rhs_plain(tg, tb, u, 1e-3, 0.02, gamma, 1.3)
    for a in range(3):
        torch.testing.assert_close(ks[a], ps[a], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(krhs, prhs, rtol=1e-4,
                               atol=3e-7 * float(prhs.abs().max()))
    p = torch.randn(tg.shape, generator=gen, device=cuda_device)
    kn, kdiv, kvel = fused3d.correct_diag_3d(tg, ks, p, 1e-3 / 1.3)
    pn, pdiv, pvel = fused3d.correct_diag_plain(tg, ks, p, 1e-3 / 1.3)
    for a in range(3):
        torch.testing.assert_close(kn[a], pn[a], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kdiv, pdiv, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(kvel, pvel, rtol=1e-4, atol=0.0)
    op = tpois.build_poisson_op(tg, tb, cuda_device)
    kr = fused3d.residual_3d(op, p, krhs)
    pr = fused3d.residual_plain(op, p, krhs)
    torch.testing.assert_close(kr, pr, rtol=1e-5,
                               atol=1e-6 * float(pr.abs().max()))
    assert fused3d.LAUNCHES == {"predictor_rhs_3d": 1, "correct_diag_3d": 1,
                                "residual_3d": 1}


@pytest.mark.cuda
def test_cuda_cavity3d_kernels_match_plain_steps(cuda_device):
    case = make_case("cavity3d", shape=(32, 32, 32), re=100.0,
                     device=cuda_device)
    sk = sp = case.initial_state()
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
    for a in range(3):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=2e-4, atol=1e-6)
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


@pytest.mark.cuda
def test_cuda_corrector_diagnostics_propagate_nan(cuda_device):
    """A NaN in the field shows up in both kernel diagnostics (the max
    runs on float bit patterns, where NaN orders above +inf)."""
    tg = tgrid.GridSpec((40, 24, 72), (1.0, 0.6, 1.8))
    u = [torch.zeros(tg.face_shape(a), device=cuda_device) for a in range(3)]
    u[1][17, 5, 33] = float("nan")
    p = torch.zeros(tg.shape, device=cuda_device)
    _, div, vel = fused3d.correct_diag_3d(tg, u, p, 0.1)
    assert torch.isnan(div) and torch.isnan(vel)
    u[1][17, 5, 33] = float("inf")
    _, div, vel = fused3d.correct_diag_3d(tg, u, p, 0.1)
    assert torch.isinf(vel) and not torch.isnan(vel)
