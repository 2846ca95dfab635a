"""The float32 constants the wrappers of kernels 1-2 hand to the CUDA
kernels (ops/fused3d.py): the reciprocal spacings that replace the
divisions, formed as the JAX kernels form them (``pallas_kernels.py``
``_fused_pred_kernel``: ``inv2h = 1.0 / (2.0 * h[ax])``, ``invh = 1.0 /
h[ax]``, ``invh2 = 1.0 / (h[ax] * h[ax])``; ``_fused_corr_kernel``: ``1.0 /
h[a]``): a Python double rounded once to float32; and the step-size
buffer the kernels read dt, rho/dt and dt/rho from (ops/step_size.py), in
float32 arithmetic as the JAX step forms them from a traced dt. numpy on
both sides; no JAX program is compiled."""

import math

import numpy as np
import pytest

from navierstokessolver_tpu_torch.grid import GridSpec, slab_grid
from navierstokessolver_tpu_torch.ops import fused3d, step_size

GRIDS = {
    # the 256^3 unit cavity (BASELINE config #5), h = 2^-8
    "cavity3d_256": GridSpec((256, 256, 256), (1.0, 1.0, 1.0)),
    # the ragged grid of the kernel tests
    "ragged": GridSpec((40, 24, 72), (1.0, 0.6, 1.8)),
    # the Taylor-Green box (cases/taylor_green.py), h = 2 pi / 256
    "taylor_green3d_256": GridSpec((256, 256, 256), (2.0 * math.pi,) * 3),
    # one slab of 16 rows of the cavity (the halo-mode wrappers' grid)
    "cavity3d_256_slab16": slab_grid(
        GridSpec((256, 256, 256), (1.0, 1.0, 1.0)), 16),
}


def _jax_constants(h):
    return ([np.float32(1.0 / (2.0 * x)) for x in h],
            [np.float32(1.0 / x) for x in h],
            [np.float32(1.0 / (x * x)) for x in h])


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_kernel_reciprocals_equal_jax_constants(name):
    grid = GRIDS[name]
    want = _jax_constants(grid.spacing)
    dt, nu, gamma, rho = 1e-3, 0.02, 0.8, 1.3
    pred = fused3d.predictor_scalars(grid, nu, gamma)
    assert pred[:9] == [float(x) for w in want for x in w]
    assert pred[9:] == [float(np.float32(nu)), float(np.float32(gamma)),
                        float(np.float32(1 - gamma))]
    assert step_size.values(dt, rho) == [
        float(np.float32(dt)), float(np.float32(rho) / np.float32(dt)),
        float(np.float32(dt) / np.float32(rho))]
    corr = fused3d.corrector_scalars(grid)
    assert corr == [float(x) for x in want[1]]


def test_power_of_two_spacing_products_equal_divisions():
    """At h = 2^-8 (the 256^3 cavity) every reciprocal is exact, so the
    kernels' products equal the plain versions' divisions bit for bit."""
    grid = GRIDS["cavity3d_256"]
    inv2h, invh, invh2 = np.float32(
        fused3d.predictor_scalars(grid, 0.02, 0.0)[0:9:3])
    h = np.float32(grid.spacing[0])
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert np.array_equal(x * inv2h, x / (np.float32(2) * h))
    assert np.array_equal(x * invh, x / h)
    assert np.array_equal(x * invh2, x / (h * h))
