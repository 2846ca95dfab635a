"""PyTorch port vs JAX package: the control-volume force diagnostics
(``utils/forces.py``) and ``Simulation.run_scan_forces``.

The cases of the JAX package's tests/test_forces.py on the port (the
rank-generic terms against the hand-unrolled 2D form, 3D uniform flow,
in-scan sampling against post-hoc, the synthetic frequency), and the port
held to the JAX package: ``cv_terms_nd`` on one random 2D and one 3D state
(rtol 1e-5: the same slices summed in another order), and the force series
of a 6-step staircase cylinder at 64x32 (its step matches JAX's with the
tolerances of tests/test_torch_cylinder.py; the surface force sums p over
the box's 72 face cells of area 0.125, so p's atol 1e-5 + rtol 2e-4 of
max|p| ~1.2 bounds it by 72 x 0.125 x 2.5e-4 ~ 2.3e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.utils import forces as jforces
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.grid import GridSpec, State
from navierstokessolver_tpu_torch.utils.forces import (
    cv_terms, cv_terms_nd, dominant_frequency, drag_lift_series,
)

CYL = dict(shape=(64, 32), lengths=(8.0, 4.0), center=(2.0, 2.01))
BOX = (8, 24, 6, 26)


def _random_state(shape, lengths, seed):
    rng = np.random.default_rng(seed)
    nd = len(shape)
    u = []
    for a in range(nd):
        s = list(shape)
        s[a] += 1
        u.append(rng.normal(size=s).astype(np.float32))
    return u, rng.normal(size=shape).astype(np.float32)


def test_cv_terms_nd_matches_2d():
    """The rank-generic terms reproduce the hand-unrolled 2D form on a
    random (divergent, irregular) field, as in JAX."""
    u, p = _random_state((24, 20), (1.2, 1.0), 11)
    g = GridSpec((24, 20), (1.2, 1.0))
    st = State(u=tuple(torch.from_numpy(c) for c in u), p=torch.from_numpy(p))
    box = (5, 17, 4, 15)
    sfx, sfy, mx, my = cv_terms(g, st, 0.02, box)
    sf, mom = cv_terms_nd(g, st, 0.02, box)
    np.testing.assert_allclose(float(sf[0]), float(sfx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(sf[1]), float(sfy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(mom[0]), float(mx), rtol=1e-6)
    np.testing.assert_allclose(float(mom[1]), float(my), rtol=1e-6)


def test_cv_terms_nd_3d_uniform_flow():
    """Uniform flow through a body-free box exerts no net force; the
    carried momentum is the box volume times u."""
    g = GridSpec((16, 12, 12), (1.6, 1.2, 1.2))
    st = State(u=(torch.ones(g.face_shape(0)), torch.zeros(g.face_shape(1)),
                  torch.zeros(g.face_shape(2))),
               p=torch.full(g.shape, 0.7))
    sf, mom = cv_terms_nd(g, st, 0.01, (4, 12, 3, 9, 3, 9))
    for c in sf:
        assert abs(float(c)) < 1e-5
    assert abs(float(mom[0]) - 0.8 * 0.6 * 0.6) < 1e-5
    assert abs(float(mom[1])) < 1e-6 and abs(float(mom[2])) < 1e-6


@pytest.mark.parametrize("shape,lengths,box", [
    ((24, 20), (1.2, 1.0), (0, 17, 4, 20)),          # two domain faces
    ((12, 10, 14), (1.2, 1.0, 1.4), (2, 12, 0, 7, 3, 11)),
], ids=["2d", "3d"])
def test_cv_terms_nd_matches_jax(shape, lengths, box):
    u, p = _random_state(shape, lengths, len(shape))
    jg = jgrid.GridSpec(shape=shape, lengths=lengths)
    jsf, jmom = jforces.cv_terms_nd(
        jg, jgrid.State(u=tuple(jnp.asarray(c) for c in u),
                        p=jnp.asarray(p)), 0.03, box)
    tg = GridSpec(shape, lengths)
    tsf, tmom = cv_terms_nd(
        tg, State(u=tuple(torch.from_numpy(c) for c in u),
                  p=torch.from_numpy(p)), 0.03, box)
    for got, want in ((tsf, jsf), (tmom, jmom)):
        assert len(got) == len(want) == len(shape)
        for a in range(len(shape)):
            np.testing.assert_allclose(float(got[a]), float(want[a]),
                                       rtol=1e-5, atol=1e-5)


def test_run_scan_forces_matches_post_hoc():
    """The in-scan per-step series equals cv_terms_nd on each post-step
    state (1-step scans), and the final states agree (JAX's test)."""
    sim = make_case("cylinder", device="cpu", **CYL).sim
    n = 6
    st_scan, d, sf, mom = sim.run_scan_forces(impulsive_start_state(sim), n,
                                              BOX)
    assert sf.shape == (n, 2) and mom.shape == (n, 2)
    assert d.max_div.shape == (n,)
    st2 = impulsive_start_state(sim)
    for k in range(n):
        st2, _ = sim.run_scan(st2, 1)
        sfk, momk = cv_terms_nd(sim.grid, st2, sim.params.nu, BOX)
        np.testing.assert_allclose(sf[k].numpy(), torch.stack(sfk).numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(mom[k].numpy(), torch.stack(momk).numpy(),
                                   atol=1e-4)
    np.testing.assert_allclose(st_scan.p.numpy(), st2.p.numpy(), atol=1e-5)
    # 0 steps: the state as given and empty series, as run_scan
    st0 = impulsive_start_state(sim)
    st, d0, sf0, mom0 = sim.run_scan_forces(st0, 0, BOX)
    assert st is st0 and sf0.shape == mom0.shape == (0, 2)
    assert d0.max_div.shape == (0,)


def test_run_scan_forces_matches_jax():
    jc = jax_make_case("cylinder", **CYL)
    tc = make_case("cylinder", device="cpu", **CYL)
    js, jd, jsf, jmom = jc.sim.run_scan_forces(jax_impulsive_start(jc.sim), 6,
                                               BOX)
    ts, td, tsf, tmom = tc.sim.run_scan_forces(impulsive_start_state(tc.sim),
                                               6, BOX)
    assert td.poisson_iters.tolist() == np.asarray(jd.poisson_iters).tolist()
    np.testing.assert_allclose(tsf.numpy(), np.asarray(jsf), rtol=0.0,
                               atol=2.5e-3)
    np.testing.assert_allclose(tmom.numpy(), np.asarray(jmom), rtol=0.0,
                               atol=1e-4)
    jcd, jcl = jforces.drag_lift_series(jc.sim.grid, jc.sim.params.nu, BOX,
                                        *np.asarray(jsf).T,
                                        *np.asarray(jmom).T, 0.1)
    tcd, tcl = drag_lift_series(tc.sim.grid, tc.sim.params.nu, BOX,
                                tsf[:, 0], tsf[:, 1], tmom[:, 0], tmom[:, 1],
                                0.1)
    # Cd = 2 (sf - d mom/dt): 2 (2.5e-3 + 2 x 1e-4 / 0.1) < 1e-2
    np.testing.assert_allclose(tcd, jcd, rtol=0.0, atol=1e-2)
    np.testing.assert_allclose(tcl, jcl, rtol=0.0, atol=1e-2)


def test_dominant_frequency_synthetic():
    """Peak picking with sub-bin interpolation recovers a known frequency
    to ~0.5% from a short noisy series, as JAX's."""
    rng = np.random.default_rng(7)
    dt = 0.05
    t = np.arange(400) * dt
    f0 = 0.73
    x = 1.5 + 0.8 * np.sin(2 * np.pi * f0 * t + 0.3) \
        + 0.05 * rng.normal(size=t.shape)
    f = dominant_frequency(x, dt)
    assert abs(f - f0) / f0 < 0.005, f
    assert f == jforces.dominant_frequency(x, dt)
    assert dominant_frequency(torch.from_numpy(x), dt) == f
    assert dominant_frequency(np.ones(100), dt) == 0.0
