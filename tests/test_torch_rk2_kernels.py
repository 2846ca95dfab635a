"""PyTorch port vs JAX package: the rk2 ``base`` mode of kernels 1 and 4.

rk2's stage 2 streams the midpoint field as the stencil source and anchors
u* at the step-start state, ``u* = base + dt*RHS(u_mid)``
(``ops/pallas_kernels.py`` ``_fused_pred_kernel``, ``ops/pallas_2d.py``
``_pred2d_kernel``). On CPU tensors the port's wrappers run their plain
versions, which compute that sum as one expression; these tests hold them
to the JAX Pallas kernels run in interpret mode, as
tests/test_torch_fused3d.py and tests/test_torch_fused2d.py run them, with
the tolerances of those files: 3D u* rtol = atol = 1e-5 and the RHS rtol
1e-4 / atol 3e-7 of max|RHS|; 2D u* atol 2e-6 and the RHS atol 2e-6 of
max(max|RHS|, 1). Also the halo mode's plain version in ``base`` mode
against the unsharded one. The CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import pallas_2d as jp2
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import fused2d, fused3d, step_size

DT, NU, RHO = 1e-3, 0.02, 1.3


def _tables(shape, lengths, face, wall):
    jg, tg = jgrid.GridSpec(shape, lengths), tgrid.GridSpec(shape, lengths)
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[face] = jbcs.BCSpec.wall(wall)
    tb[face] = tbcs.BCSpec.wall(wall)
    return jg, tg, jb, tb


def _fields(jg, jb, seed, scale=1.0):
    """Two BC-consistent random velocities (the midpoint field and the
    base), as JAX arrays and as port tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        u = tuple(jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(
            np.float32)) * scale for a in range(jg.ndim))
        ju = jbcs.apply_velocity_bcs(jg, jb, u)
        tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
        out.append((ju, tu))
    return out


def _close(got, ref, rtol, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.heavy
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_predictor_rhs_3d_base_vs_pallas_interpret(gamma):
    jg, tg, jb, tb = _tables((16, 8, 8), (1.0, 0.5, 0.5), (2, 1),
                             (1.0, 0.3, 0.0))
    (jmid, tmid), (jbase, tbase) = _fields(jg, jb, seed=11)
    n0, n1, n2 = jg.shape
    (o0, o1, o2), j_rhs = jpk.predictor_rhs_3d_internal(
        jg, jb, jpk.to_internal_3d(jg, jmid, 8), DT, NU, gamma, rho=RHO,
        tile=8, interpret=True, base=jpk.to_internal_3d(jg, jbase, 8))
    t_star, t_rhs = fused3d.predictor_rhs_3d(tg, tb, tmid, DT, NU, gamma,
                                             RHO, base=tbase)
    _close(t_star[0], o0[: n0 + 1, :n1, :n2], 1e-5, 1e-5)
    _close(t_star[1], o1[:n0, : n1 + 1, :n2], 1e-5, 1e-5)
    # the internal layout elides comp 2's last face (a BC value)
    _close(t_star[2][:, :, :n2], o2[:n0, :n1, :n2], 1e-5, 1e-5)
    _close(t_rhs, j_rhs, 1e-4, 3e-7 * float(jnp.max(jnp.abs(j_rhs))))
    # the base moves u*: the anchor is not the midpoint field
    e_star, _ = fused3d.predictor_rhs_3d(tg, tb, tmid, DT, NU, gamma, RHO)
    assert float((e_star[0] - t_star[0]).abs().max()) > 0.1


@pytest.mark.heavy
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_predictor_rhs_2d_base_vs_pallas_interpret(gamma):
    jg, tg, jb, tb = _tables((64, 48), (1.0, 0.75), (1, 1), (1.0, 0.0))
    (jmid, tmid), (jbase, tbase) = _fields(jg, jb, seed=12, scale=0.1)
    j_istar, j_rhs = jp2.predictor_rhs_2d_internal(
        jg, jb, jp2.to_internal_2d(jg, jmid, tile=32), DT, NU, gamma,
        rho=RHO, tile=32, interpret=True,
        base=jp2.to_internal_2d(jg, jbase, tile=32))
    j_star = jp2.from_internal_2d(jg, jb, j_istar)
    t_star, t_rhs = fused2d.predictor_rhs_2d(tg, tb, tmid, DT, NU, gamma,
                                             RHO, base=tbase)
    for a in range(2):
        _close(t_star[a], j_star[a], 0.0, 2e-6)
    _close(t_rhs, j_rhs, 0.0, 2e-6 * max(float(jnp.max(jnp.abs(j_rhs))), 1.0))


@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
def test_base_plain_is_one_sum(periodic):
    """The plain version's stage 2 is ``base + dt*RHS(u_mid)`` on every
    face that the Euler form updates, and the BC values elsewhere: u*
    with base minus u* without equals base - u_mid there, to the rounding
    of the two sums."""
    tg = tgrid.GridSpec((12, 10, 14), (1.0, 0.8, 1.2))
    tb = tbcs.no_slip_box(tg)
    if periodic:
        for a in range(3):
            tb[(a, 0)] = tb[(a, 1)] = tbcs.BCSpec.periodic()
    rng = np.random.default_rng(13)
    mid, base = (tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.from_numpy(rng.normal(size=tg.face_shape(a)).astype(np.float32))
        for a in range(3))) for _ in range(2))
    euler, _ = fused3d.predictor_rhs_plain(tg, tb, mid, DT, NU, 0.5, RHO)
    based, _ = fused3d.predictor_rhs_plain(tg, tb, mid, DT, NU, 0.5, RHO,
                                           base=base)
    for a in range(3):
        torch.testing.assert_close(based[a] - euler[a], base[a] - mid[a],
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["cavity3d", "taylor_green3d"])
def test_halo_base_plain_matches_unsharded(name):
    """Kernel 1's halo mode in ``base`` mode (its plain version): the
    slabs of a split field, their ghost rows filled as the step's velocity
    refresh fills them, give the unsharded based u* and RHS rows."""
    from navierstokessolver_tpu_torch.cases import make_case
    from navierstokessolver_tpu_torch.parallel import (
        fused_sharded, make_mesh, sharded_simulation,
    )

    case = make_case(name, shape=(32, 12, 10), device="cpu")
    sim = case.sim
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    step = fused_sharded.SlabStep(sharded_simulation(sim, mesh), mesh)
    rng = np.random.default_rng(14)
    mid, base = (tbcs.apply_velocity_bcs(sim.grid, sim.bcs, tuple(
        torch.from_numpy(rng.normal(size=sim.grid.face_shape(a)).astype(
            np.float32)) for a in range(3))) for _ in range(2))
    step.load(base)
    step.refresh[step.cur].run()
    slabs_base = [tuple(c.clone() for c in blk) for blk in step.u[step.cur]]
    step.load(mid)
    step.refresh[step.cur].run()
    dts = step_size.buffer(DT, 1.0, "cpu")
    ref, ref_rhs = fused3d.predictor_rhs_plain(sim.grid, sim.bcs, mid, DT,
                                               sim.params.nu, 0.0, 1.0,
                                               base=base)
    b = step.b
    for k in range(4):
        out, rhs = fused3d.predictor_rhs_3d_halo(
            step.slab, sim.bcs, step.u[step.cur][k], dts[0], sim.params.nu,
            0.0, 1.0, halo=step.halo[k], base=slabs_base[k], dts=dts)
        torch.testing.assert_close(rhs, ref_rhs[k * b:(k + 1) * b],
                                   rtol=1e-5, atol=1e-3)
        for a in range(3):
            torch.testing.assert_close(out[a].narrow(0, 1, b),
                                       ref[a][k * b:(k + 1) * b],
                                       rtol=1e-6, atol=1e-6)
