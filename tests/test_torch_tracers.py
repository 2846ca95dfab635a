"""PyTorch port vs JAX package: Lagrangian tracers (tracers.py,
``Simulation.run_scan_tracers``).

Interpolation is exact (to 1e-5) on linear fields; periodic axes wrap and
the others clamp; the numpy threefry draw gives ``jax.random.uniform``'s
bits, so ``seed_tracers`` gives JAX's positions bit for bit; the
interpolation agrees with JAX's on random fields to 4 ulps of the field's
max; ``run_scan_tracers`` equals a hand loop of ``step`` and
``advect_tracers`` bit for bit, and JAX's ``run_scan_tracers`` within 1e-5
after 10 steps (the flow fields already differ at float32 roundoff).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu.bcs import BCSpec as JBCSpec
from navierstokessolver_tpu.bcs import no_slip_box as jax_no_slip_box
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.grid import GridSpec as JGrid
from navierstokessolver_tpu import tracers as jtr
from navierstokessolver_tpu_torch import tracers as ttr
from navierstokessolver_tpu_torch.bcs import BCSpec, no_slip_box
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.grid import GridSpec

EPS = float(np.finfo(np.float32).eps)


def _periodic(nd, spec=BCSpec):
    return {(a, s): spec.periodic() for a in range(nd) for s in (0, 1)}


@pytest.mark.parametrize("nd", [2, 3])
def test_interpolation_exact_on_linear_field(nd):
    n = 12
    g = GridSpec((n,) * nd, (1.0,) * nd)
    h = g.spacing[0]
    coef = np.arange(1.0, 1.0 + nd * (nd + 1)).reshape(nd, nd + 1) / 4
    u = []
    for a in range(nd):
        axes = [np.arange(n + 1) * h if b == a else (np.arange(n) + 0.5) * h
                for b in range(nd)]
        grids = np.meshgrid(*axes, indexing="ij")
        u.append(torch.from_numpy((coef[a, 0] + sum(
            coef[a, b + 1] * grids[b] for b in range(nd))).astype(np.float32)))
    pos = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 0.9, size=(64, nd)).astype(np.float32))
    v = ttr.velocity_at(g, no_slip_box(g), u, pos).numpy()
    p = pos.numpy().astype(np.float64)
    for a in range(nd):
        np.testing.assert_allclose(v[:, a], coef[a, 0] + p @ coef[a, 1:],
                                   rtol=0, atol=1e-5)


def test_wrap_and_clamp():
    """Uniform flow moves tracers in a straight line; a periodic axis
    wraps them, a wall axis clamps them."""
    n = 8
    g = GridSpec((n, n), (1.0, 1.0))
    u = (torch.full((n + 1, n), 0.3), torch.full((n, n + 1), -0.2))
    pos = torch.tensor([[0.5, 0.5], [0.9, 0.05]])
    per = _periodic(2)
    out = ttr.advect_tracers(g, per, u, pos, 0.5, integrator="euler")
    np.testing.assert_allclose(out.numpy(), [[0.65, 0.4], [0.05, 0.95]],
                               atol=1e-6)
    walls = no_slip_box(g)
    out = ttr.advect_tracers(g, walls, u, pos, 0.5)
    assert float(out[1, 1]) == 0.0 and float(out[1, 0]) == 1.0
    far = torch.tensor([[-0.3, 2.5], [1.7, -4.0]])
    np.testing.assert_allclose(ttr.confine(g, per, far).numpy(),
                               [[0.7, 0.5], [0.7, 0.0]], atol=1e-6)
    np.testing.assert_array_equal(ttr.confine(g, walls, far).numpy(),
                                  [[0.0, 1.0], [1.0, 0.0]])


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
@pytest.mark.parametrize("shape", [(7, 2), (1000, 3), (5,)], ids=str)
def test_uniform_bits_match_jax_random(seed, shape):
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                        dtype=jnp.float32))
    got = ttr.jax_uniform(seed, shape)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("lengths", [(1.0, 1.0), (4.0, 1.0),
                                     (2 * np.pi,) * 3], ids=str)
def test_seed_tracers_match_jax(lengths):
    shape = (16,) * len(lengths)
    ref = np.asarray(jtr.seed_tracers(JGrid(shape, lengths), 500, 7))
    got = ttr.seed_tracers(GridSpec(shape, lengths), 500, 7, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (500, len(lengths))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("nd,periodic", list(itertools.product(
    (2, 3), (False, True))))
def test_velocity_at_and_advection_match_jax(nd, periodic):
    shape = (16, 12, 8)[:nd]
    lengths = (1.0, 0.75, 0.5)[:nd]
    g, jg = GridSpec(shape, lengths), JGrid(shape, lengths)
    bcs = _periodic(nd) if periodic else no_slip_box(g)
    jbcs = _periodic(nd, JBCSpec) if periodic else jax_no_slip_box(jg)
    rng = np.random.default_rng(nd)
    u = [rng.standard_normal(g.face_shape(a)).astype(np.float32)
         for a in range(nd)]
    pos = (rng.uniform(-0.1, 1.1, size=(300, nd)) * np.asarray(lengths)
           ).astype(np.float32)
    tu = [torch.from_numpy(c) for c in u]
    ju = [jnp.asarray(c) for c in u]
    tol = 4 * EPS * max(np.abs(c).max() for c in u)
    np.testing.assert_allclose(
        ttr.velocity_at(g, bcs, tu, torch.from_numpy(pos)).numpy(),
        np.asarray(jtr.velocity_at(jg, jbcs, ju, jnp.asarray(pos))),
        rtol=0, atol=tol)
    got = ttr.advect_tracers(g, bcs, tu, torch.from_numpy(pos), 0.01)
    ref = np.asarray(jtr.advect_tracers(jg, jbcs, ju, jnp.asarray(pos),
                                        0.01))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tracer_runs():
    tc = make_case("taylor_green", shape=(16, 16), device="cpu")
    pos = ttr.seed_tracers(tc.sim.grid, 64, 3, device="cpu")
    st, pos_end, diag, traj = tc.sim.run_scan_tracers(tc.initial_state(),
                                                      pos, 10)
    return tc, pos, st, pos_end, diag, traj


def test_run_scan_tracers_equals_hand_loop(tracer_runs):
    tc, pos, st_end, pos_end, diag, traj = tracer_runs
    assert traj.shape == (10, 64, 2) and diag.dt.shape == (10,)
    st, p = tc.initial_state(), pos
    for k in range(10):
        st, d = tc.sim.step(st)
        p = ttr.advect_tracers(tc.sim.grid, tc.sim.bcs, st.u, p, d.dt)
        assert torch.equal(traj[k], p)
    assert torch.equal(p, pos_end) and torch.equal(st.p, st_end.p)
    st0 = tc.initial_state()
    _, same, d0, empty = tc.sim.run_scan_tracers(st0, pos, 0)
    assert torch.equal(same, pos) and empty.shape == (0, 64, 2)
    assert d0.dt.shape == (0,)


def test_run_scan_tracers_matches_jax(tracer_runs):
    tc, pos, _, pos_end, _, traj = tracer_runs
    jc = jax_make_case("taylor_green", shape=(16, 16))
    _, jpos, _, jtraj = jc.sim.run_scan_tracers(
        jc.initial_state(), jnp.asarray(pos.numpy()), 10)
    assert tuple(jtraj.shape) == tuple(traj.shape)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pos_end.numpy(), np.asarray(jpos), rtol=0,
                               atol=1e-5)
