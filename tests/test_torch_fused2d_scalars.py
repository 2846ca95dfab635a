"""The float32 constants the wrappers of kernels 4-5 hand to the CUDA
kernels (ops/fused2d.py), formed in one numpy conversion: the reciprocal
spacings that replace the divisions, as the JAX kernels form them
(``pallas_2d.py`` ``_pred2d_kernel``: ``1.0 / hx``, ``1.0 / (2 * hx)``,
``1.0 / (hx * hx)``; ``_corr2d_kernel``: ``1.0 / hx``): a Python double
rounded once to float32; nu, gamma and 1 - gamma as the JAX step rounds
them (dt and rho/dt reach the kernels through the step-size buffer,
tests/test_torch_fused3d_scalars.py). numpy on both sides; no JAX program
is compiled."""

import numpy as np
import pytest

from navierstokessolver_tpu_torch.grid import GridSpec
from navierstokessolver_tpu_torch.ops import fused2d, fused3d

GRIDS = {
    # the 2048^2 flagship (bench.py's default), h = 2^-11
    "cavity_2048": GridSpec((2048, 2048), (1.0, 1.0)),
    # the ragged grids of the kernel tests
    "ragged": GridSpec((200, 136), (1.0, 0.68)),
    "ragged_small": GridSpec((37, 45), (0.9, 1.3)),
}


def _one_at_a_time(h, nu, gamma):
    """The constants converted one ``np.float32`` at a time, the JAX
    kernel's expressions."""
    f = np.float32
    return ([float(f(1.0 / x)) for x in h]
            + [float(f(1.0 / (2 * x))) for x in h]
            + [float(f(1.0 / (x * x))) for x in h]
            + [float(f(nu)), float(f(gamma)), float(f(1 - gamma))])


@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_kernel_constants_equal_jax_constants(name, gamma):
    grid = GRIDS[name]
    nu = 1e-4
    got = fused2d.predictor_scalars(grid, nu, gamma)
    assert got == _one_at_a_time(grid.spacing, nu, gamma)
    assert len(got) == 9    # the C signature's float arguments
    corr = fused3d.corrector_scalars(grid)
    assert corr == [float(np.float32(1.0 / x)) for x in grid.spacing]


def test_power_of_two_spacing_products_equal_divisions():
    """At h = 2^-11 (the flagship) every reciprocal is exact, so the
    kernels' products equal the plain versions' divisions bit for bit."""
    grid = GRIDS["cavity_2048"]
    invh, inv2h, invhh = np.float32(
        fused2d.predictor_scalars(grid, 0.02, 0.0)[0:6:2])
    h = np.float32(grid.spacing[0])
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert np.array_equal(x * invh, x / h)
    assert np.array_equal(x * inv2h, x / (np.float32(2) * h))
    assert np.array_equal(x * invhh, x / (h * h))
