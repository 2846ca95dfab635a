"""PyTorch port vs JAX package: the Smagorinsky LES module, numpy-seeded.

Both packages run on the CPU in this process and get the same float32
velocity on two WALL tables: a moving lid on an anisotropic 16x8x16 grid,
and a wall moving on axis 0's high face of a 16x16x8 grid. The port writes
the JAX module's arithmetic in the same order, so the tolerance is float32
roundoff: rtol 1e-6 plus 1e-6 of the field's largest magnitude for
entries near zero, except where a global sum enters (the dynamic
coefficient: XLA and PyTorch add its ~4000 terms in another order), where
it is rtol 1e-4. Each JAX reference runs as one jitted program: the
suite's workers share a process across files, so the file keeps its
number of XLA compiles small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import les as jles
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch.ops import stencils as tst

# name -> (shape, lengths, face, wall velocity)
TABLES = {
    "lid": ((16, 8, 16), (1.0, 0.5, 1.0), (2, 1), (1.0, 0.0, 0.0)),
    "axis0-wall": ((16, 16, 8), (1.0, 1.0, 0.5), (0, 1), (0.7, 0.2, 0.0)),
}


def _jax(fn, jg, jb, *arrays, **static):
    """``fn(jg, jb, *arrays, **static)`` compiled as one program."""
    return jax.jit(lambda *a: fn(jg, jb, *a, **static))(*arrays)


def _setup(name, seed=0):
    """Both grids and BC tables, and a BC-consistent random velocity (JAX
    arrays, port tensors)."""
    shape, lengths, face, vel = TABLES[name]
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[face] = jbcs.BCSpec.wall(vel)
    tb[face] = tbcs.BCSpec.wall(vel)
    rng = np.random.default_rng(seed)
    u = tuple(rng.normal(size=jg.face_shape(a)).astype(np.float32)
              for a in range(3))
    ju = _jax(jbcs.apply_velocity_bcs, jg, jb, u)
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    return jg, tg, jb, tb, ju, tu


def _close(got, ref, rtol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(
        got, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max() or 1.0)
    )


@pytest.mark.parametrize("name", sorted(TABLES))
def test_strain_rates_match_jax(name):
    jg, tg, jb, tb, ju, tu = _setup(name)
    jdiag, joff = _jax(jles.strain_rates, jg, jb, ju)
    tdiag, toff = tles.strain_rates(tg, tb, tu)
    for a in range(3):
        _close(tdiag[a], jdiag[a])
    assert sorted(toff) == sorted(joff) == [(0, 1), (0, 2), (1, 2)]
    for k in joff:
        _close(toff[k], joff[k])
    jS, jmag = _jax(jles._center_strain_tensor, jg, jb, ju)
    tS, tmag = tles._center_strain_tensor(tg, tb, tu)
    for k in jS:
        _close(tS[k], jS[k])
    _close(tmag, jmag)


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("model", ["smagorinsky", "dynamic"])
def test_eddy_viscosity_matches_jax(name, model):
    jg, tg, jb, tb, ju, tu = _setup(name, seed=1)
    jcfg = jles.LESConfig(cs=0.2, model=model)
    tcfg = convert.les_config_from_jax(jcfg)
    assert tcfg.filter_width(tg) == jcfg.filter_width(jg)
    rtol = 1e-6
    if model == "dynamic":
        j_cs2 = float(_jax(jles.dynamic_cs2, jg, jb, ju, cfg=jcfg))
        t_cs2 = tles.dynamic_cs2(tg, tb, tu, tcfg)
        assert t_cs2.shape == () and t_cs2.dtype == torch.float32
        # a random field is far from resolved: the coefficient is positive
        # and below the clip, so the comparison sees the least squares
        assert 0.0 < j_cs2 < jcfg.cs2_max
        np.testing.assert_allclose(float(t_cs2), j_cs2, rtol=1e-4)
        rtol = 1e-4
    ref = _jax(jles.eddy_viscosity, jg, jb, ju, cfg=jcfg)
    got = tles.eddy_viscosity(tg, tb, tu, tcfg)
    assert got.dtype == torch.float32
    _close(got, ref, rtol)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_sgs_forcing_matches_jax(name):
    jg, tg, jb, tb, ju, tu = _setup(name, seed=2)
    jcfg = jles.LESConfig(cs=0.2)
    tcfg = convert.les_config_from_jax(jcfg)
    ref = _jax(jles.sgs_forcing, jg, jb, ju, cfg=jcfg)
    got = tles.sgs_forcing(tg, tb, tu, tcfg)
    for a in range(3):
        _close(got[a], ref[a], 2e-6)
    # a given nu_t replaces the model's (cfg unused)
    nu_t = np.random.default_rng(3).uniform(0.0, 0.01, jg.shape).astype(
        np.float32)
    ref = _jax(lambda g, b, u, n: jles.sgs_forcing(g, b, u, jcfg, nu_t=n),
               jg, jb, ju, nu_t)
    got = tles.sgs_forcing(tg, tb, tu, None, nu_t=torch.from_numpy(nu_t))
    for a in range(3):
        _close(got[a], ref[a], 2e-6)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_test_filter_and_centered_velocity_match_jax(name):
    jg, tg, jb, tb, ju, tu = _setup(name, seed=4)
    f = np.random.default_rng(5).normal(size=jg.shape).astype(np.float32)
    _close(tles.test_filter(tg, tb, torch.from_numpy(f)),
           _jax(jles.test_filter, jg, jb, f))
    for t, j in zip(tles._centered_velocity(tg, tu),
                    _jax(lambda g, b, u: jles._centered_velocity(g, u),
                         jg, jb, ju)):
        _close(t, j)


@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_predictor_with_forcing_matches_jax(gamma):
    """``stencils.predictor(..., forcing=...)`` adds the forcing to the RHS
    on interior faces, as the JAX one does."""
    jg, tg, jb, tb, ju, tu = _setup("axis0-wall", seed=6)
    rng = np.random.default_rng(7)
    forcing = [rng.normal(size=tuple(n - 2 * (a == ax) for ax, n in
                                     enumerate(jg.face_shape(a))))
               .astype(np.float32) for a in range(3)]
    def jax_predictor(g, b, u, f):
        return jst.predictor(g, b, u, jnp.float32(1e-3), 0.05, gamma,
                             forcing=f)

    ref = _jax(jax_predictor, jg, jb, ju, forcing)
    got = tst.predictor(tg, tb, tu, 1e-3, 0.05, gamma,
                        forcing=[torch.from_numpy(f) for f in forcing])
    for a in range(3):
        _close(got[a], ref[a])
    # None entries are skipped
    ref = _jax(jax_predictor, jg, jb, ju, [None, forcing[1], None])
    got = tst.predictor(tg, tb, tu, 1e-3, 0.05, gamma,
                        forcing=[None, torch.from_numpy(forcing[1]), None])
    for a in range(3):
        _close(got[a], ref[a])


def test_les_config_and_errors():
    tg = tgrid.GridSpec((8, 4, 2), (1.0, 2.0, 4.0))
    cfg = tles.LESConfig()
    assert cfg.filter_width(tg) == jles.LESConfig().filter_width(
        jgrid.GridSpec((8, 4, 2), (1.0, 2.0, 4.0)))
    assert tles.LESConfig(delta=0.3).filter_width(tg) == 0.3
    tb = tbcs.no_slip_box(tg)
    u = tuple(torch.zeros(tg.face_shape(a)) for a in range(3))
    with pytest.raises(ValueError, match="unknown LES model"):
        tles.eddy_viscosity(tg, tb, u, tles.LESConfig(model="wale"))
    # the predictor's periodic branch (axis 0 periodic) against JAX's on
    # a random field: float32 roundoff, as the other predictor tests
    jg = jgrid.GridSpec((8, 4, 2), (1.0, 2.0, 4.0))
    jb = jbcs.no_slip_box(jg)
    tb_per = dict(tb)
    jb[(0, 0)] = jb[(0, 1)] = jbcs.BCSpec.periodic()
    tb_per[(0, 0)] = tb_per[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.PERIODIC)
    rng = np.random.default_rng(8)
    u = tuple(rng.normal(size=jg.face_shape(a)).astype(np.float32)
              for a in range(3))
    ref = _jax(lambda g, b, u: jst.predictor(g, b, u, jnp.float32(1e-3), 0.1),
               jg, jb, u)
    got = tst.predictor(tg, tb_per, [torch.from_numpy(c) for c in u], 1e-3,
                        0.1)
    for a in range(3):
        _close(got[a], ref[a])
