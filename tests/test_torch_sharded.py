"""PyTorch port vs JAX package: the slab-sharded fused 3D step
(parallel/fused_sharded.py, parallel/sharding.py) and the halo mode of
the fused 3D kernels.

* The halo-mode plain versions of kernels 1 and 2 on the first, a middle
  and the last of three slabs, on a bounded table (walls, a moving lid)
  and on a ring (axis 0 periodic), against the port's unsharded plain
  versions on the whole field: the same arithmetic per point, so equal
  bit for bit on every row a slab writes. Ghost rows that a wall side
  must not read hold garbage.
* The whole slice, ``sharded_simulation(..., rdma=True).run_scan`` of
  ``cavity3d`` (32, 16, 16) at Re 100 with the direct solve, 4 slabs of 8
  rows, 3 steps, against JAX's ``run_scan_sharded_fused(..., rdma=True)``
  with the Pallas kernels in interpret mode on ``make_mesh(4)`` of the
  virtual CPU mesh, with tests/test_fused_step.py's whole-step tolerances
  (u rtol 2e-5 / atol 2e-6, p rtol 2e-4 / atol 2e-5, max_div and max_cfl
  rtol 1e-3); ``taylor_green3d`` in 4 slabs (a ring) against JAX's
  unsharded jnp ``run_scan`` with the same tolerances.
* Sharded against the port's unsharded ``run_scan``: equal bit for bit
  (on the CPU both run the plain versions, with the same solve).
* What the slab tier does not take raises, naming its ROADMAP item.

Each JAX reference is one jitted program.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.parallel import make_mesh as jax_make_mesh
from navierstokessolver_tpu.parallel import shard_state as jax_shard_state
from navierstokessolver_tpu.parallel import (
    sharded_simulation as jax_sharded_simulation,
)
from navierstokessolver_tpu.parallel.fused_sharded import (
    run_scan_sharded_fused as jax_run_scan_sharded_fused,
)
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.ops import fused3d, stencils
from navierstokessolver_tpu_torch.parallel import (
    make_mesh, shard_state, sharded_simulation,
)
from navierstokessolver_tpu_torch.parallel import remote_dma
from navierstokessolver_tpu_torch.solver import SimParams

CPU = torch.device("cpu")
SHAPE, LENGTHS = (24, 6, 10), (1.2, 0.6, 1.0)
N_SLABS, B = 3, 8
DT, NU, RHO = 1e-3, 0.02, 1.3


def _table(ring: bool):
    """Bounded: walls, a lid moving on (1, 1). Ring: axes 0 and 2
    periodic, walls (one moving) on axis 1."""
    g = tgrid.GridSpec(SHAPE, LENGTHS)
    bcs = tbcs.no_slip_box(g)
    bcs[(1, 1)] = tbcs.BCSpec.wall((0.7, 0.0, 0.2))
    if ring:
        for a in (0, 2):
            bcs[(a, 0)] = bcs[(a, 1)] = tbcs.BCSpec.periodic()
    tbcs.validate_bcs(g, bcs)
    return g, bcs


def _slab_rows(field, k, rows, ring, garbage):
    """A slab buffer of ``rows`` rows: buffer row r holds global row k*B +
    r - 1 (wrapping on a ring), ``garbage`` where that row is outside the
    field (ghost rows a wall side must not read)."""
    buf = garbage.clone()
    for r in range(rows):
        g = k * B + r - 1
        if ring:
            g %= SHAPE[0]
        if 0 <= g < field.shape[0]:
            buf[r] = field[g]
    return buf


def _buffers(fields, k, ring, rng):
    """Slab k's buffers of ``fields`` (u0, u1, u2[, p])."""
    slab = tgrid.slab_grid(tgrid.GridSpec(SHAPE, LENGTHS), B)
    out = []
    for a, f in enumerate(fields):
        shape = fused3d.halo_shape(slab, a)   # a = 3: the pressure
        garbage = torch.from_numpy(
            rng.normal(1e3, 1.0, size=shape).astype(np.float32))
        out.append(_slab_rows(f, k, shape[0], ring, garbage))
    return slab, out


@pytest.mark.parametrize("gamma", [0.0, 0.7])
@pytest.mark.parametrize("k", [0, 1, 2], ids=["first", "middle", "last"])
@pytest.mark.parametrize("ring", [False, True], ids=["bounded", "ring"])
def test_halo_plain_matches_unsharded(ring, k, gamma):
    g, bcs = _table(ring)
    rng = np.random.default_rng(10 * k + int(10 * gamma) + 100 * ring)
    u = tbcs.apply_velocity_bcs(g, bcs, tuple(
        torch.from_numpy(rng.normal(size=g.face_shape(a)).astype(np.float32))
        for a in range(3)))
    p = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    halo = (ring or k > 0, ring or k < N_SLABS - 1)
    per = tbcs.periodic_axes(g, bcs)

    star, rhs = fused3d.predictor_rhs_plain(g, bcs, u, DT, NU, gamma, RHO)
    slab, ub = _buffers(u, k, ring, rng)
    before = dict(fused3d.LAUNCHES)
    s_star, s_rhs = fused3d.predictor_rhs_3d_halo(slab, bcs, ub, DT, NU,
                                                  gamma, RHO, halo=halo)
    rows = slice(k * B, (k + 1) * B)
    np.testing.assert_array_equal(s_rhs.numpy(), rhs[rows].numpy())
    for a in range(3):
        np.testing.assert_array_equal(s_star[a][1:B + 1].numpy(),
                                      star[a][rows].numpy())
    if not halo[1]:   # the wall face n0 on the last slab of a bounded axis
        np.testing.assert_array_equal(s_star[0][B + 1].numpy(),
                                      star[0][SHAPE[0]].numpy())

    scale = DT / RHO
    new, div, vel = fused3d.correct_diag_plain(g, star, p, scale, per)
    # u* with the shared face from the next slab, p with its ghost rows
    _, sb = _buffers((*star, p), k, ring, rng)
    maxes = torch.zeros(2, dtype=torch.int32)
    s_new = fused3d.correct_diag_3d_halo(slab, sb[:3], sb[3], scale, maxes,
                                         periodic=per, halo=halo)
    for a in range(3):
        np.testing.assert_array_equal(s_new[a][1:B + 1].numpy(),
                                      new[a][rows].numpy())
    if not halo[1]:
        np.testing.assert_array_equal(s_new[0][B + 1].numpy(),
                                      new[0][SHAPE[0]].numpy())
    s_div, s_vel = maxes.view(torch.float32)
    full_div = stencils.divergence(g, new).abs()
    assert float(s_div) == float(full_div[rows].max())
    h = g.spacing
    faces = B + (0 if halo[1] else 1)
    exp_vel = max(float((new[0][k * B:k * B + faces] / h[0]).abs().max()),
                  *(float((new[a][rows] / h[a]).abs().max()) for a in (1, 2)))
    assert float(s_vel) == exp_vel
    assert float(s_div) <= float(div) and float(s_vel) <= float(vel)
    assert fused3d.LAUNCHES == before          # CPU: the plain versions


def _port_sharded(name, n_slabs, steps, **kw):
    case = make_case(name, device="cpu", **kw)
    mesh = make_mesh(n_slabs, devices=[CPU] * n_slabs)
    sim = sharded_simulation(case.sim, mesh, rdma=True)
    assert sim.mesh is mesh
    st, d = sim.run_scan(shard_state(case.initial_state(), mesh,
                                     case.sim.grid), steps)
    return case, st, d


def _hold_to_jax(ts, td, js, jd):
    u, p = convert.state_to_numpy(ts)
    for a in range(3):
        assert u[a].shape == np.asarray(js.u[a]).shape
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_array_equal(td.poisson_iters.numpy(),
                                  np.asarray(jd.poisson_iters))


def test_sharded_cavity3d_matches_jax_rdma():
    """4 slabs of 8 rows, fft, 3 steps: the port's slab tier against JAX's
    (kernel-initiated exchanges, Pallas kernels in interpret mode)."""
    kw = dict(shape=(32, 16, 16), re=100.0)
    jc = jax_make_case("cavity3d", **kw)
    mesh = jax_make_mesh(4)
    sim = dataclasses.replace(
        jc.sim, params=dataclasses.replace(jc.sim.params, use_pallas=True),
        pallas_interpret=True)
    sim = jax_sharded_simulation(sim, mesh, rdma=True)
    st = jax_shard_state(jc.initial_state(), mesh, jc.sim.grid)
    js, jd = jax.jit(lambda s: jax_run_scan_sharded_fused(
        sim, mesh, s, 3, rdma=True))(st)
    before = dict(remote_dma.LAUNCHES)
    tc, ts, td = _port_sharded("cavity3d", 4, 3, **kw)
    assert tc.sim.params.poisson.method == "fft"
    assert remote_dma.LAUNCHES == before       # CPU: the plain version
    _hold_to_jax(ts, td, js, jd)
    assert float(td.max_div.max()) < 5e-6


def test_sharded_zero_steps_match_jax():
    """4 slabs, 0 steps: JAX's ``run_scan_sharded_fused(..., 0,
    rdma=True)`` scans a length-0 ``lax.scan`` and returns the state, with
    diagnostics of length 0; the port returns the state as given and five
    empty tensors of the same dtypes."""
    kw = dict(shape=(32, 16, 16), re=100.0)
    jc = jax_make_case("cavity3d", **kw)
    mesh = jax_make_mesh(4)
    sim = dataclasses.replace(
        jc.sim, params=dataclasses.replace(jc.sim.params, use_pallas=True),
        pallas_interpret=True)
    sim = jax_sharded_simulation(sim, mesh, rdma=True)
    st = jax_shard_state(jc.initial_state(), mesh, jc.sim.grid)
    js, jd = jax.jit(lambda s: jax_run_scan_sharded_fused(
        sim, mesh, s, 0, rdma=True))(st)
    tc, ts, td = _port_sharded("cavity3d", 4, 0, **kw)
    u, p = convert.state_to_numpy(ts)
    for a in range(3):
        np.testing.assert_array_equal(u[a], np.asarray(js.u[a]))
    np.testing.assert_array_equal(p, np.asarray(js.p))
    for f in td._fields:
        got, want = getattr(td, f), np.asarray(getattr(jd, f))
        assert got.shape == want.shape == (0,), f
        assert str(got.dtype).split(".")[-1] == str(want.dtype), f


def test_sharded_taylor_green3d_ring_matches_jax():
    """taylor_green3d in 4 slabs: axis 0 periodic, the slabs a ring."""
    kw = dict(shape=(32, 16, 16), re=200.0)
    jc = jax_make_case("taylor_green3d", **kw)
    js, jd = jc.sim.run_scan(jc.initial_state(), 3)
    tc, ts, td = _port_sharded("taylor_green3d", 4, 3, **kw)
    assert tbcs.periodic_axes(tc.sim.grid, tc.sim.bcs)[0]
    _hold_to_jax(ts, td, js, jd)


@pytest.mark.parametrize("name,n_slabs,method", [
    ("cavity3d", 4, "fft"), ("cavity3d", 2, "cg"), ("taylor_green3d", 4, "fft"),
    ("taylor_green3d", 2, "fft"),
])
def test_sharded_matches_unsharded(name, n_slabs, method):
    kw = dict(shape=(32, 16, 16))
    if method != "fft":
        kw.update(poisson_method=method, poisson_iters=50)
    case, ts, td = _port_sharded(name, n_slabs, 3, **kw)
    us, ud = case.sim.run_scan(case.initial_state(), 3)
    for a in range(3):
        assert torch.equal(ts.u[a], us.u[a]), a
    assert torch.equal(ts.p, us.p)
    for f in ("poisson_iters", "poisson_res", "max_div", "max_cfl", "dt"):
        assert torch.equal(getattr(td, f), getattr(ud, f)), f


def test_sharded_probes():
    """What the slab tier does not take raises at sharded_simulation (or
    make_mesh), naming its ROADMAP item; a sharded simulation steps from
    run_scan only."""
    case = make_case("cavity3d", shape=(32, 8, 8), device="cpu")
    sim = case.sim
    mesh4 = make_mesh(4, devices=[CPU] * 4)
    tier = "parallel/: the explicit-halo solvers and the pencil tier"
    with pytest.raises(NotImplementedError, match=tier):
        sharded_simulation(sim, make_mesh((2, 2), devices=[CPU] * 4))
    with pytest.raises(NotImplementedError, match=tier):
        sharded_simulation(sim, mesh4, poisson_comm="halo")
    with pytest.raises(ValueError, match="unknown poisson_comm"):
        sharded_simulation(sim, mesh4, poisson_comm="psum")
    with pytest.raises(NotImplementedError, match=tier):
        sharded_simulation(dataclasses.replace(
            sim, les=tles.LESConfig(cs=0.17)), mesh4)
    with pytest.raises(NotImplementedError, match=tier):   # b = 4 < 8
        sharded_simulation(sim, make_mesh(8, devices=[CPU] * 8))
    with pytest.raises(NotImplementedError, match=tier):   # 32 % 3
        sharded_simulation(sim, make_mesh(3, devices=[CPU] * 3))
    with pytest.raises(NotImplementedError, match=tier):   # one slab
        sharded_simulation(sim, make_mesh(1, devices=[CPU]))
    sim2 = make_case("cavity", shape=(32, 16), device="cpu").sim
    with pytest.raises(NotImplementedError, match=tier):
        sharded_simulation(sim2, mesh4)
    cyl = make_case("cylinder", shape=(64, 32), ibm=True, device="cpu").sim
    with pytest.raises(NotImplementedError, match=tier):
        sharded_simulation(cyl, mesh4)
    with pytest.raises(NotImplementedError, match="parallel/ across cards"):
        sharded_simulation(sim, make_mesh(
            2, devices=[CPU, torch.device("meta")]))
    with pytest.raises(ValueError, match="mesh on meta"):
        sharded_simulation(sim, make_mesh(4, devices=["meta"] * 4))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 4 devices, have 0"):
            make_mesh(4)
    # rk2 and the CFL-adaptive dt build (and shard); float64 does not
    assert SimParams(dt=1e-3, nu=0.01, integrator="rk2").integrator == "rk2"
    assert SimParams(dt=1e-3, nu=0.01, cfl=0.5).cfl == 0.5
    with pytest.raises(NotImplementedError, match="RK2, CFL-adaptive dt"):
        tgrid.GridSpec((32, 16, 16), (1.0,) * 3, dtype=torch.float64)
    sharded = sharded_simulation(sim, mesh4)
    assert sharded.mesh is mesh4 and sim.mesh is None
    st = shard_state(case.initial_state(), mesh4, sim.grid)
    with pytest.raises(NotImplementedError, match="run_scan only"):
        sharded.step(st)
    # 0 steps return the state as given (test_sharded_zero_steps_match_jax)
    st0, d0 = sharded.run_scan(st, 0)
    assert st0 is st and all(f.shape == (0,) for f in d0)
    with pytest.raises(ValueError, match="n_steps >= 0"):
        sharded.run_scan(st, -1)
    with pytest.raises(ValueError, match="shape"):
        shard_state(make_case("cavity3d", shape=(16, 8, 8),
                              device="cpu").initial_state(), mesh4, sim.grid)
