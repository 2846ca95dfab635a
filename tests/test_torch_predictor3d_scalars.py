"""The float32 constants the wrappers of kernels 6-7 hand to the CUDA
kernels (ops/predictor3d.py): the reciprocal spacings and the Smagorinsky
scale, formed as the JAX kernels form them (``pallas_kernels.py``
``_predictor3d_kernel``: ``inv2h = 1.0 / (2.0 * h[ax])``, ``invh = 1.0 /
h[ax]``, ``invh2 = 1.0 / (h[ax] * h[ax])``; ``_nu_t3d_kernel``: ``inv = 1.0
/ h[ax]`` and the scale ``cs * cs * filter_width ** 2`` as float32, as
``Simulation._predict`` passes it): a Python double rounded once to
float32. numpy on both sides; no JAX program is compiled."""

import math

import numpy as np
import pytest

from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import les as jles
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch.grid import GridSpec
from navierstokessolver_tpu_torch.ops import predictor3d

GRIDS = {
    # the 256^3 unit cavity of the LES step, h = 2^-8
    "cavity3d_256": ((256, 256, 256), (1.0, 1.0, 1.0)),
    # the ragged grids of the kernel tests
    "ragged": ((40, 24, 72), (1.0, 0.6, 1.8)),
    "ragged_wall": ((37, 19, 45), (1.0, 0.6, 1.8)),
    # the JAX LES tests' grid
    "les_tests": ((16, 16, 8), (1.0, 1.0, 0.5)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_kernel_constants_equal_jax_constants(name):
    shape, lengths = GRIDS[name]
    grid = GridSpec(shape, lengths)
    h = jgrid.GridSpec(shape, lengths).spacing
    assert tuple(grid.spacing) == tuple(h)
    nu, gamma = 0.05, 0.8
    got = predictor3d.predictor_scalars(grid, nu, gamma)
    want = ([np.float32(1.0 / x) for x in h]
            + [np.float32(1.0 / (x * x)) for x in h]
            + [np.float32(nu), np.float32(gamma), np.float32(1.0 - gamma)])
    assert got == [float(x) for x in want]
    jcfg = jles.LESConfig(cs=0.17)
    want = ([np.float32(1.0 / x) for x in h]
            + [np.float32(jcfg.cs * jcfg.cs
                          * jcfg.filter_width(jgrid.GridSpec(shape, lengths))
                          ** 2)])
    got = predictor3d.nu_t_scalars(grid, convert.les_config_from_jax(jcfg))
    assert got == [float(x) for x in want]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_half_reciprocal_is_jax_inv2h(name):
    """Kernel 6 forms 1/(2h) as 0.5 * float32(1/h) on the host side of its
    C entry point: halving is exact in float32, so it equals the JAX
    kernel's float32(1/(2h))."""
    grid = GridSpec(*GRIDS[name])
    inv_h = np.float32(predictor3d.predictor_scalars(grid, 0.05, 0.0)[:3])
    want = np.float32([1.0 / (2.0 * x) for x in grid.spacing])
    assert np.array_equal(np.float32(0.5) * inv_h, want)
    assert all(math.isfinite(x) and x > 0 for x in inv_h)
