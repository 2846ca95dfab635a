"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. No JAX import, so the file also runs on a
machine without JAX; on the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances are those of the JAX package's interpret-parity tests
(tests/test_fused_step.py in 3D, tests/test_pallas2d.py in 2D,
tests/test_pallas.py for the LES kernels, tests/test_pallas_mg.py for the
multigrid kernels); the residual's atol is 1e-6 of max|r| (float32 roundoff
of a sum whose terms reach 12 w max|p|, w = 1/h^2). The 2D per-component
predictor is held to tests/test_pallas.py's atol 2e-5, on every face (its
boundary faces keep their input, as the plain version's do), with
constant BC values and with profiles. The fused
trailing-axes kernel is held to its plain version (the same bf16 split
products as bf16-valued cuBLAS SGEMMs, and the multiply) within 5e-5 of
max|out|, at 3 and at 1 pass: both sum the same exact products in float32,
in different orders. The exchange kernel moves values and must
equal its plain version; the halo-mode kernels and the sharded step run
the unsharded kernels' arithmetic per cell and are held to them within
rtol = atol = 1e-6. rk2's ``base`` mode of kernels 1 and 4 and the step
size read from a device buffer (kernels 1, 2, 4, 5, 6 and 8, fed a dt of
0.37 times the usual one as a 0-d tensor) are held to the plain versions
called with that dt as a float, at the tolerances of the same kernels'
Euler tests; rk2 and CFL steps to ``step_plain`` at the JAX whole-step
tolerances, their dt series within rtol 3e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.channel import (
    parabolic_profile, poiseuille_state,
)
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import (
    fft_poisson, fused2d, fused3d, multigrid, multigrid_kernels, predictor2d,
    predictor3d, step_size, trailing_dct,
)
from navierstokessolver_tpu_torch.ops import poisson as tpois
from navierstokessolver_tpu_torch.parallel import (
    fused_sharded, make_mesh, remote_dma, shard_state, sharded_simulation,
)
from navierstokessolver_tpu_torch.utils.forces import cv_terms_nd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("shape", [(40, 24, 72), (37, 19, 45)], ids=str)
def test_cuda_kernels_match_plain(cuda_device, gamma, shape):
    """Walls only, a moving lid; (37, 19, 45) is a multiple of no tile
    extent of kernels 1-2 (8 rows of axis 1, 32 cells of axis 2, runs of
    8-32 planes of axis 0)."""
    tg = tgrid.GridSpec(shape, (1.0, 0.6, 1.8))
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


def _walls_2d(tg, walls):
    """No-slip walls with the lid (1, 0) on face (1, 1) (``"lid"``), or
    nonzero values of both components on all four faces (``"all"``)."""
    tb = tbcs.no_slip_box(tg)
    if walls == "lid":
        tb[(1, 1)] = tbcs.BCSpec.wall((1.0, 0.0))
    else:
        for face, value in (((0, 0), (0.2, -0.3)), ((0, 1), (-0.1, 0.4)),
                            ((1, 0), (0.5, 0.15)), ((1, 1), (1.0, -0.25))):
            tb[face] = tbcs.BCSpec.wall(value)
    return tb


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("shape,lengths,walls", [
    ((200, 136), (1.0, 0.68), "lid"),
    ((37, 45), (0.9, 1.3), "all"),
    ((20, 136), (0.3, 1.0), "all"),
    ((200, 13), (1.0, 0.2), "lid"),
], ids=["200x136-lid", "37x45-all", "20x136-all", "200x13-lid"])
def test_cuda_2d_kernels_match_plain(cuda_device, gamma, shape, lengths,
                                     walls):
    """On ragged grids, O(0.1) fields: u*, v*, u_new atol 2e-6; RHS atol
    2e-6 max(max|RHS|, 1); max_div rtol 1e-3; max_vel rtol 1e-4. The
    predictor's warps own 29 cells of axis 1 and march runs of 32-64 rows:
    no axis here is a multiple of either, (20, 136) has fewer rows than a
    run, (200, 13) fewer columns than a warp, n1 % 4 != 0 in two of them,
    and two have nonzero wall values on all four faces."""
    tg = tgrid.GridSpec(shape, lengths)
    tb = _walls_2d(tg, walls)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    u = tbcs.apply_velocity_bcs(tg, tb, tuple(
        0.1 * torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(2)))
    fused2d.reset_launch_counts()
    ks, krhs = fused2d.predictor_rhs_2d(tg, tb, u, 1e-3, 0.01, gamma, 1.3)
    ps, prhs = fused2d.predictor_rhs_2d_plain(tg, tb, u, 1e-3, 0.01, gamma,
                                              1.3)
    for a in range(2):
        torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=2e-6)
    torch.testing.assert_close(
        krhs, prhs, rtol=0.0, atol=2e-6 * max(float(prhs.abs().max()), 1.0))
    p = 0.01 * torch.randn(tg.shape, generator=gen, device=cuda_device)
    kn, kdiv, kvel = fused2d.correct_diag_2d(tg, ks, p, 1e-3 / 1.3)
    pn, pdiv, pvel = fused2d.correct_diag_2d_plain(tg, ks, p, 1e-3 / 1.3)
    for a in range(2):
        torch.testing.assert_close(kn[a], pn[a], rtol=0.0, atol=2e-6)
    torch.testing.assert_close(kdiv, pdiv, rtol=1e-3, atol=0.0)
    torch.testing.assert_close(kvel, pvel, rtol=1e-4, atol=0.0)
    assert fused2d.LAUNCHES == {"predictor_rhs_2d": 1, "correct_diag_2d": 1}


@pytest.mark.cuda
def test_cuda_cavity2d_kernels_match_plain_steps(cuda_device):
    """Five kernel steps against step_plain at 256^2, with the JAX 2D
    whole-step tolerances (tests/test_pallas2d.py)."""
    case = make_case("cavity", shape=(256, 256), re=1e3, upwind_gamma=0.8,
                     device=cuda_device)
    fused2d.reset_launch_counts()
    sk = sp = case.initial_state()
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
    assert fused2d.LAUNCHES == {"predictor_rhs_2d": 5, "correct_diag_2d": 5}
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dk.max_cfl, dp.max_cfl, rtol=1e-3, atol=1e-8)
    # max_div is float32 roundoff noise, summed in another order in each
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


def _periodic_2d(tg, per):
    """Walls with nonzero values on every bounded face, and the ``per``
    axes periodic."""
    tb = _walls_2d(tg, "all")
    for a in range(2):
        if per[a]:
            tb[(a, 0)] = tb[(a, 1)] = tbcs.BCSpec.periodic()
    return tb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["euler", "force", "base"])
@pytest.mark.parametrize("per", [(True, True), (True, False), (False, True)],
                         ids=["box", "rows", "lanes"])
@pytest.mark.parametrize("shape", [(200, 136), (38, 46), (20, 14)], ids=str)
def test_cuda_periodic_2d_kernels_match_plain(cuda_device, shape, per, mode):
    """Kernels 4 and 5 in their wrap modes (with a static force, in rk2's
    base form) against the plain versions, at the tolerances of
    test_cuda_2d_kernels_match_plain, on even extents that are multiples
    neither of a warp's 29 columns nor of a run's rows ((20, 14): fewer of
    both); face n of a periodic axis bit-equal to face 0."""
    tg = tgrid.GridSpec(shape, (1.0, shape[1] / shape[0]))
    tb = _periodic_2d(tg, per)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)

    def field():
        return tbcs.apply_velocity_bcs(tg, tb, tuple(
            0.1 * torch.randn(tg.face_shape(a), generator=gen,
                              device=cuda_device) for a in range(2)))

    u = field()
    base = field() if mode == "base" else None
    force = (0.7, -0.2) if mode == "force" else None
    fused2d.reset_launch_counts()
    ks, krhs = fused2d.predictor_rhs_2d(tg, tb, u, 1e-3, 0.01, 0.3, 1.3,
                                        base=base, force=force)
    ps, prhs = fused2d.predictor_rhs_2d_plain(tg, tb, u, 1e-3, 0.01, 0.3,
                                              1.3, base=base, force=force)
    for a in range(2):
        torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=2e-6)
        if per[a]:
            assert torch.equal(ks[a].select(a, 0), ks[a].select(a, -1))
    torch.testing.assert_close(
        krhs, prhs, rtol=0.0, atol=2e-6 * max(float(prhs.abs().max()), 1.0))
    p = 0.01 * torch.randn(tg.shape, generator=gen, device=cuda_device)
    kn, kdiv, kvel = fused2d.correct_diag_2d(tg, ks, p, 1e-3 / 1.3, per)
    pn, pdiv, pvel = fused2d.correct_diag_2d_plain(tg, ks, p, 1e-3 / 1.3,
                                                   per)
    for a in range(2):
        torch.testing.assert_close(kn[a], pn[a], rtol=0.0, atol=2e-6)
        if per[a]:
            assert torch.equal(kn[a].select(a, 0), kn[a].select(a, -1))
    torch.testing.assert_close(kdiv, pdiv, rtol=1e-3, atol=0.0)
    torch.testing.assert_close(kvel, pvel, rtol=1e-4, atol=0.0)
    assert fused2d.LAUNCHES == {"predictor_rhs_2d": 1, "correct_diag_2d": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("taylor_green", dict(shape=(256, 256))),
    ("channel_periodic", dict(shape=(256, 64))),
    ("decaying_turbulence", dict(shape=(256, 256), seed=3)),
    ("decaying_turbulence", dict(shape=(256, 256), seed=3, cfl=0.4)),
], ids=["taylor_green", "channel_periodic", "turbulence", "turbulence-cfl"])
def test_cuda_periodic_2d_cases_match_plain_steps(cuda_device, name, kw):
    """Five kernel steps of the periodic 2D cases against step_plain, with
    the JAX 2D whole-step tolerances; the dt series within rtol 3e-5."""
    case = make_case(name, device=cuda_device, **kw)
    assert case.sim.fused
    fused2d.reset_launch_counts()
    sk = sp = case.initial_state()
    dts = []
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
        dts.append((dk.dt, dp.dt))
    per_step = 2 if case.sim.params.integrator == "rk2" else 1
    assert fused2d.LAUNCHES == {"predictor_rhs_2d": 5 * per_step,
                                "correct_diag_2d": 5 * per_step}
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(torch.stack([k for k, _ in dts]),
                               torch.stack([q for _, q in dts]),
                               rtol=3e-5, atol=0.0)
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


@pytest.mark.cuda
def test_cuda_2d_corrector_diagnostics_propagate_nan(cuda_device):
    tg = tgrid.GridSpec((200, 136), (1.0, 0.68))
    u = [torch.zeros(tg.face_shape(a), device=cuda_device) for a in range(2)]
    u[1][117, 53] = float("nan")
    p = torch.zeros(tg.shape, device=cuda_device)
    _, div, vel = fused2d.correct_diag_2d(tg, u, p, 0.1)
    assert torch.isnan(div) and torch.isnan(vel)
    u[1][117, 53] = float("inf")
    _, div, vel = fused2d.correct_diag_2d(tg, u, p, 0.1)
    assert torch.isinf(vel) and not torch.isnan(vel)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("shape", [(40, 24, 72), (37, 19, 45)], ids=str)
def test_cuda_les_kernels_match_plain(cuda_device, gamma, shape):
    """nu_t within 2e-6 of max(nu_t); u* (with and without the LES term)
    atol 5e-5, on ragged grids with a moving lid and O(1) fields;
    (37, 19, 45) is a multiple of no tile extent of kernels 6-7."""
    tg = tgrid.GridSpec(shape, (1.0, 0.6, 1.8))
    tb = tbcs.no_slip_box(tg)
    tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    u = tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(3)))
    cfg = tles.LESConfig(cs=0.2)
    predictor3d.reset_launch_counts()
    k_nt = predictor3d.nu_t_3d(tg, tb, u, cfg)
    p_nt = tles.eddy_viscosity(tg, tb, u, cfg)
    assert float((k_nt - p_nt).abs().max()) < 2e-6 * float(p_nt.max())
    for nu_t in (None, p_nt):
        ks = predictor3d.predictor_3d(tg, tb, u, 1e-3, 0.05, gamma,
                                      nu_t=nu_t)
        ps = predictor3d.predictor_3d_plain(tg, tb, u, 1e-3, 0.05, gamma,
                                            nu_t=nu_t)
        for a in range(3):
            torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=5e-5)
    assert predictor3d.LAUNCHES == {"nu_t_3d": 1, "predictor_3d": 2}


@pytest.mark.cuda
def test_cuda_les_steps_match_plain(cuda_device):
    """Five LES steps, kernels against step_plain (tests/test_pallas.py's
    kernel-vs-jnp LES step tolerance, u atol 5e-5)."""
    case = make_case("cavity3d", shape=(32, 32, 32), re=500.0,
                     device=cuda_device)
    sim = dataclasses.replace(case.sim, les=tles.LESConfig(cs=0.17))
    predictor3d.reset_launch_counts()
    sk = sp = case.initial_state()
    for _ in range(5):
        sk, dk = sim.step(sk)
        sp, dp = sim.step_plain(sp)
    assert predictor3d.LAUNCHES == {"nu_t_3d": 5, "predictor_3d": 5}
    for a in range(3):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=0.0, atol=5e-5)
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


def _mg_operator(device, shape=(200, 136), lengths=(1.0, 0.68)):
    """A ragged 2D operator with a solid block and an OUTFLOW face."""
    tg = tgrid.GridSpec(shape, lengths)
    tb = tbcs.no_slip_box(tg)
    tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.OUTFLOW)
    solid = np.zeros(shape, bool)
    solid[60:100, 30:70] = True
    return tg, tb, tpois.build_poisson_op(tg, tb, device, solid)


def _offset(t):
    """``t``'s values in a view one element into a larger buffer: 4 bytes
    off a 16-byte boundary, contiguous."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("omega,n", [(1.0, 1), (1.0, 2), (1.45, 8)])
@pytest.mark.parametrize("case", [
    "200x136", "131x45", "200x136-offset", "mgcg-128"])
def test_cuda_mg_kernels_match_plain(cuda_device, omega, n, case):
    """The three multigrid kernels against their plain versions on O(1)
    random fields (zero on solid cells): p atol 3e-5 and rsq rtol 1e-3
    (tests/test_pallas_mg.py); r against the plain residual of the
    kernel's own iterate, atol 1e-6 w max|p| (a few float32 ulps of the
    largest of the five terms, summed in the Pallas order by the kernel
    and in the jnp order by the plain version). The kernels copy 16
    bytes a piece where n1 % 4 == 0 and the fields are 16-byte aligned
    (200x136) and 4 where not (131x45; 200x136-offset, fields 4 bytes off
    a 16-byte boundary); mgcg-128 is the 128^2 level of the 2048^2 mgcg
    hierarchy, where mg_pre and mg_post take their smaller tile."""
    if case == "mgcg-128":
        tg = tgrid.GridSpec((2048, 2048), (1.0, 1.0))
        op = multigrid.MGPoissonSolver.build(
            tg, tbcs.no_slip_box(tg), cuda_device).ops[4]
        assert tuple(op.diag.shape) == (128, 128)
    else:
        shape, lengths = {"131x45": ((131, 45), (1.0, 0.4))}.get(
            case, ((200, 136), (1.0, 0.68)))
        _, _, op = _mg_operator(cuda_device, shape, lengths)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    p, b, e = (torch.randn(op.diag.shape, generator=gen, device=cuda_device)
               * op.fluid for _ in range(3))
    if case.endswith("-offset"):
        p, b, e = map(_offset, (p, b, e))
    multigrid_kernels.reset_launch_counts()
    k = multigrid_kernels.rb_sweeps(op, p, b, omega, n)
    torch.testing.assert_close(
        k, multigrid_kernels.rb_sweeps_plain(op, p, b, omega, n),
        rtol=0.0, atol=3e-5)
    kp, kr = multigrid_kernels.mg_pre_sweeps_residual(op, p, b, n, omega)
    pp, _ = multigrid_kernels.mg_pre_sweeps_residual_plain(op, p, b, n,
                                                           omega)
    torch.testing.assert_close(kp, pp, rtol=0.0, atol=3e-5)
    own = (b - tpois.apply_A(op, kp)) * op.fluid
    torch.testing.assert_close(
        kr, own, rtol=0.0, atol=1e-6 * max(op.w) * float(kp.abs().max()))
    kp, krsq = multigrid_kernels.mg_add_post_sweeps(op, p, b, e, n, omega)
    pp, _ = multigrid_kernels.mg_add_post_sweeps_plain(op, p, b, e, n,
                                                       omega)
    torch.testing.assert_close(kp, pp, rtol=0.0, atol=3e-5)
    rn = tpois.residual_norm(op, kp, b)
    torch.testing.assert_close(torch.sqrt(krsq), rn, rtol=1e-3, atol=0.0)
    assert multigrid_kernels.LAUNCHES == {
        "mg_pre_sweeps_residual": 1, "mg_add_post_sweeps": 1, "rb_sweeps": 1}
    # solid cells stay exactly zero
    assert float((kp * (1.0 - op.fluid)).abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_mgcg_steps_match_plain(cuda_device):
    """Five mgcg steps at 256^2 (levels 256 and 128 on the fused kernels)
    against step_plain (the plain V-cycle route), with the 2D whole-step
    tolerances; the same CG iteration count per step."""
    case = make_case("cavity", shape=(256, 256), re=1e3, upwind_gamma=0.8,
                     poisson_method="mgcg", device=cuda_device)
    assert case.sim.mg_solver.fused
    multigrid_kernels.reset_launch_counts()
    sk = sp = case.initial_state()
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
        assert int(dk.poisson_iters) == int(dp.poisson_iters)
    assert multigrid_kernels.LAUNCHES["mg_pre_sweeps_residual"] > 0
    assert multigrid_kernels.LAUNCHES["mg_add_post_sweeps"] > 0
    assert multigrid_kernels.LAUNCHES["rb_sweeps"] == 0
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=2e-4, atol=2e-5)
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


def _cylinder_table():
    return {(0, 0): tbcs.BCSpec.inflow((1.0, 0.0)),
            (0, 1): tbcs.BCSpec.outflow(),
            (1, 0): tbcs.BCSpec.slip(), (1, 1): tbcs.BCSpec.slip()}


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.2])
def test_cuda_predictor_2d_matches_plain(cuda_device, gamma):
    """On a ragged grid (no axis a multiple of 32) with the cylinder's BC
    table (inflow / outflow / slip / slip) and O(1) fields."""
    tg = tgrid.GridSpec((200, 136), (6.25, 4.25))
    tb = _cylinder_table()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    u = tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(2)))
    predictor2d.reset_launch_counts()
    ks = predictor2d.predictor_2d(tg, tb, u, 0.01, 0.005, gamma)
    ps = predictor2d.predictor_2d_plain(tg, tb, u, 0.01, 0.005, gamma)
    for a in range(2):
        torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=2e-5)
    assert predictor2d.LAUNCHES == {"predictor_2d": 1}


def _profile_table(grid, table, device):
    """The channel's table with a tangential inflow profile of v, or no-slip
    walls with a lid profile of u (shape (n0 + 1, 1)), from a seed."""
    n0, n1 = grid.shape
    rng = np.random.default_rng(n0 + n1)
    if table == "channel":
        return tbcs.bcs_on_device({
            (0, 0): tbcs.BCSpec.inflow((
                parabolic_profile(grid, 1.0),
                0.1 * rng.standard_normal(n1 + 1).astype(np.float32))),
            (0, 1): tbcs.BCSpec.outflow(),
            (1, 0): tbcs.BCSpec.wall((0.0, 0.0)),
            (1, 1): tbcs.BCSpec.wall((0.0, 0.0))}, device)
    bcs = tbcs.no_slip_box(grid)
    bcs[(1, 1)] = tbcs.BCSpec.wall((torch.as_tensor(
        rng.standard_normal((n0 + 1, 1)).astype(np.float32), device=device),
        0.0))
    return bcs


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.2])
@pytest.mark.parametrize("table", ["channel", "lid"])
@pytest.mark.parametrize("shape", [(200, 136), (37, 45)], ids=str)
def test_cuda_predictor_2d_profiles_match_plain(cuda_device, shape, table,
                                                gamma):
    """Profiles in the ghost table (a tangential inflow profile, a lid
    profile) on grids that are multiples of no strip or run of the kernel
    (30 columns, 16-64 rows), on a random O(1) state, on fields 4 bytes off
    a 16-byte boundary and on a state with exact zero velocities."""
    tg = tgrid.GridSpec(shape, (6.25, 4.25))
    tb = _profile_table(tg, table, cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    for mode in ("random", "offset", "zeros"):
        u = [torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
             for a in range(2)]
        if mode == "zeros":
            for c in u:
                c[torch.rand(c.shape, generator=gen,
                             device=cuda_device) < 0.3] = 0.0
        u = tbcs.apply_velocity_bcs(tg, tb, u)
        if mode == "offset":
            u = tuple(torch.empty(c.numel() + 1, device=cuda_device)[1:]
                      .view(c.shape).copy_(c) for c in u)
        predictor2d.reset_launch_counts()
        ks = predictor2d.predictor_2d(tg, tb, u, 0.01, 0.005, gamma)
        ps = predictor2d.predictor_2d_plain(tg, tb, u, 0.01, 0.005, gamma)
        for a in range(2):
            torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=2e-5)
        assert predictor2d.LAUNCHES == {"predictor_2d": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["steady", "developing"])
def test_cuda_channel_steps_match_plain(cuda_device, start):
    """Five steps of the channel at 256x64 (mg), the predictor kernel (the
    inflow profile in its ghost table) against step_plain: u with the 2D
    whole-step tolerances, p within 1e-4 of max|p|. From the Poiseuille
    state ("steady") mg stops at the float32 residual floor by its
    stagnation rule, so the cycle counts may move by roundoff: within 2 a
    step. From the case's own start ("developing") at tol 1e-3, above the
    floor (1-2e-4 at this size), every solve ends on its tolerance: the
    same counts."""
    if start == "steady":
        case = make_case("channel", shape=(256, 64), device=cuda_device)
        sk = sp = poiseuille_state(case.sim)
    else:
        case = make_case("channel", shape=(256, 64), poisson_tol=1e-3,
                         device=cuda_device)
        sk = sp = case.initial_state()
    assert not case.sim.fused and case.sim.ghosts.device.type == "cuda"
    predictor2d.reset_launch_counts()
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
        if start == "steady":
            assert abs(int(dk.poisson_iters) - int(dp.poisson_iters)) <= 2
        else:
            assert int(dk.poisson_iters) == int(dp.poisson_iters)
            assert float(dk.poisson_res) <= 1e-3
    assert predictor2d.LAUNCHES == {"predictor_2d": 5}
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=0.0,
                               atol=1e-4 * float(sp.p.abs().max()))
    div = 1e-4 if start == "steady" else 1e-3
    assert float(dk.max_div) < div and float(dp.max_div) < div


@pytest.mark.cuda
def test_cuda_run_scan_forces_matches_post_hoc(cuda_device):
    """The force terms sampled on the card after every step equal
    cv_terms_nd after each step of a run_scan (the IBM cylinder at
    256x128, 6 steps)."""
    sim = make_case("cylinder", shape=(256, 128), ibm=True,
                    device=cuda_device).sim
    box = (40, 104, 40, 88)
    st0 = impulsive_start_state(sim)
    _, _, sf, mom = sim.run_scan_forces(st0, 6, box)
    assert sf.device.type == "cuda" and sf.shape == (6, 2)
    st = st0
    for k in range(6):
        st, _ = sim.run_scan(st, 1)
        sfk, momk = cv_terms_nd(sim.grid, st, sim.params.nu, box)
        torch.testing.assert_close(sf[k], torch.stack(sfk), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(mom[k], torch.stack(momk), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_cuda_cylinder_steps_match_plain(cuda_device):
    """Five steps of the IBM cylinder at 256x128 (dctcg), the predictor
    kernel against step_plain: the same Richardson sweeps every step, u
    with the 2D whole-step tolerances, p within 1e-4 of max|p| (the solve
    stops at a relative residual of 1e-5)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    case = make_case("cylinder", shape=(256, 128), ibm=True,
                     device=cuda_device)
    assert not case.sim.fused
    predictor2d.reset_launch_counts()
    sk = sp = impulsive_start_state(case.sim)
    for _ in range(5):
        sk, dk = case.sim.step(sk)
        sp, dp = case.sim.step_plain(sp)
        assert int(dk.poisson_iters) == int(dp.poisson_iters)
    assert predictor2d.LAUNCHES == {"predictor_2d": 5}
    for a in range(2):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=0.0,
                               atol=1e-4 * float(sp.p.abs().max()))
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


def _periodic_table(tg, wall=(1.0, 0.3, 0.0)):
    """Axes 0 and 2 periodic, walls on axis 1 (the high one moving)."""
    tb = tbcs.no_slip_box(tg)
    tb[(1, 1)] = tbcs.BCSpec.wall(wall)
    for a in (0, 2):
        tb[(a, 0)] = tb[(a, 1)] = tbcs.BCSpec.periodic()
    return tb


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("shape", [(40, 24, 72), (38, 22, 46)], ids=str)
def test_cuda_periodic_kernels_match_plain(cuda_device, gamma, shape):
    """The three fused 3D kernels in their periodic mode, on a ragged grid
    with a mixed wall/periodic table (axes 0 and 2 periodic, so even
    extents; (38, 22, 46) is a multiple of no tile extent), with the
    tolerances of test_cuda_kernels_match_plain."""
    tg = tgrid.GridSpec(shape, (1.0, 0.6, 1.8))
    tb = _periodic_table(tg)
    per = tbcs.periodic_axes(tg, tb)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
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
    kn, kdiv, kvel = fused3d.correct_diag_3d(tg, ks, p, 1e-3 / 1.3, per)
    pn, pdiv, pvel = fused3d.correct_diag_plain(tg, ks, p, 1e-3 / 1.3, per)
    for a in range(3):
        torch.testing.assert_close(kn[a], pn[a], rtol=1e-5, atol=1e-5)
        if per[a]:
            assert torch.equal(kn[a].select(a, tg.shape[a]),
                               kn[a].select(a, 0))
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
@pytest.mark.parametrize("kinds", [("nn", "nn", "nn"), ("nd", "nn", "per"),
                                   ("per", "per", "per")], ids="-".join)
def test_cuda_fused_trailing_matches_plain(cuda_device, kinds):
    """Kernel 12 on a solver's own per-axis matrices (split once, as the
    solver keeps them), with and without the multiplier, on a ragged grid;
    and a non-square product (k1, k2 not multiples of 64); at 3 and 1
    bf16 passes."""
    assert not torch.backends.cuda.matmul.allow_tf32
    tg = tgrid.GridSpec((40, 24, 72), (1.0, 0.6, 1.8))
    ts = fft_poisson.DCTPoissonSolver.build(tg, cuda_device, kinds=kinds)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    x = torch.randn(tg.shape, generator=gen, device=cuda_device)
    (f1, v1), (f2, v2) = (tuple(trailing_dct.split_matrix(m)
                                for m in ts.axis_matrices(a))
                          for a in (1, 2))
    m1, m2 = (trailing_dct.split_matrix(torch.randn(
        s, generator=gen, device=cuda_device)) for s in ((100, 24), (300, 72)))
    trailing_dct.reset_launch_counts()
    for passes in (3, 1):
        for a1, a2, eig in ((f1, f2, ts.inv_eig), (v1, v2, None),
                            (m1, m2, None)):
            got = trailing_dct.fused_trailing(x, a1, a2, eig, passes)
            ref = trailing_dct.fused_trailing_plain(x, a1, a2, eig, passes)
            torch.testing.assert_close(got, ref, rtol=0.0,
                                       atol=5e-5 * float(ref.abs().max()))
    assert trailing_dct.LAUNCHES == {"fused_trailing": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_trailing", [False, True],
                         ids=["chain", "fuse_trailing"])
def test_cuda_taylor_green3d_steps_match_plain(cuda_device, fuse_trailing):
    """Five taylor_green3d steps at 32^3, kernels against step_plain (the
    chain, or with ``fuse_trailing`` the fused route's plain version), with
    tests/test_fused_step.py's periodic whole-step tolerances; the fused
    route launches kernel 12 four times a step."""
    case = make_case("taylor_green3d", shape=(32, 32, 32), device=cuda_device)
    sim = case.sim
    if fuse_trailing:
        sim = dataclasses.replace(sim, dct_solver=dataclasses.replace(
            sim.dct_solver, fuse_trailing=True))
    fused3d.reset_launch_counts()
    trailing_dct.reset_launch_counts()
    sk = sp = case.initial_state()
    for _ in range(5):
        sk, dk = sim.step(sk)
        sp, dp = sim.step_plain(sp)
    assert fused3d.LAUNCHES == {"predictor_rhs_3d": 5, "correct_diag_3d": 5,
                                "residual_3d": 10}
    assert trailing_dct.LAUNCHES == {"fused_trailing": 20 if fuse_trailing
                                     else 0}
    for a in range(3):
        torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(sk.p, sp.p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dk.max_cfl, dp.max_cfl, rtol=1e-3, atol=1e-8)
    assert float(dk.max_div) < 1e-4 and float(dp.max_div) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True], ids=["bounded", "ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_cuda_exchange_matches_plain(cuda_device, ring, dtype):
    """Kernels 13 and 14 against their plain versions (a slice and copy_
    per message): equal, on messages of unequal lengths (1 and 2 rows of
    volumes from 36 bytes to 64 KiB a row): float32 rows that are multiples of 16 bytes,
    of 4 but not 16 (the 4-byte path), and uint8 rows of odd lengths (the
    1-byte path)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)

    def volumes(shapes):
        return [[torch.randint(0, 200, s, generator=gen, device=cuda_device)
                 .to(dtype) for _ in range(4)] for s in shapes]

    shapes = [(12, 8, 128), (12, 17, 5), (12, 3, 3), (12, 64, 256)]
    msgs = ((7, 1, 11, "fwd"), (0, 2, 8, "bwd"))
    xs = volumes(shapes)
    ys = [[t.clone() for t in v] for v in xs]
    remote_dma.reset_launch_counts()
    remote_dma.exchange_rows_multi(xs, msgs, ring)
    remote_dma.exchange_rows_multi_plain(ys, msgs, ring)
    for v, w in zip(xs, ys):
        assert all(torch.equal(a, b) for a, b in zip(v, w))
    (x,) = volumes([(16, 9, 7)])
    y = [t.clone() for t in x]
    remote_dma.exchange_ghost_rows(x, 8, ring)
    remote_dma.exchange_ghost_rows_plain(y, 8, ring)
    assert all(torch.equal(a, b) for a, b in zip(x, y))
    assert remote_dma.LAUNCHES == {"exchange_rows_multi": 1,
                                   "exchange_ghost_rows": 1}


def _slab_step(name, shape, n_slabs, device, seed):
    """A random O(1) velocity (BC values on its boundary faces) loaded
    into the slabs of ``name`` at ``shape``, their ghost rows exchanged."""
    case = make_case(name, shape=shape, device=device)
    sim, g = case.sim, case.sim.grid
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = tbcs.apply_velocity_bcs(g, sim.bcs, tuple(
        torch.randn(g.face_shape(a), generator=gen, device=device)
        for a in range(3)))
    mesh = make_mesh(n_slabs, devices=[device] * n_slabs)
    step = fused_sharded.SlabStep(sharded_simulation(sim, mesh), mesh)
    step.load(u)
    step.refresh[step.cur].run()
    p = torch.randn(g.shape, generator=gen, device=device)
    return sim, step, u, p


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cavity3d", "taylor_green3d"])
def test_cuda_halo_kernels_match_plain(cuda_device, name):
    """Kernels 1 and 2 in halo mode on the first, middle and last of three
    slabs (bounded for the cavity, a ring for the Taylor-Green box)
    against their halo-mode plain versions, with the JAX interpret-parity
    tolerances, and against the unsharded kernels' rows of the whole
    field within rtol = atol = 1e-6."""
    sim, step, u, p = _slab_step(name, (48, 24, 40), 3, cuda_device, 2)
    g, bcs, b = sim.grid, sim.bcs, step.b
    dt, nu, gamma, rho = 1e-3, 0.02, 0.8, 1.3
    g_star, g_rhs = fused3d.predictor_rhs_3d(g, bcs, u, dt, nu, gamma, rho)
    per = tbcs.periodic_axes(g, bcs)
    g_new, _, _ = fused3d.correct_diag_3d(g, g_star, p, dt / rho, per)
    for k in range(3):
        halo = step.halo[k]
        faces = b if halo[1] else b + 1
        rows = slice(k * b, k * b + b)
        ks, krhs = fused3d.predictor_rhs_3d_halo(
            step.slab, bcs, step.u[step.cur][k], dt, nu, gamma, rho, halo=halo,
            out=step.u_star[k], rhs=step.rhs[k])
        ps, prhs = fused3d.predictor_rhs_halo_plain(
            step.slab, bcs, step.u[step.cur][k], dt, nu, gamma, rho, halo)
        for a in range(3):
            n = faces if a == 0 else b
            torch.testing.assert_close(ks[a][1:n + 1], ps[a][1:n + 1],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(ks[a][1:n + 1],
                                       g_star[a][k * b:k * b + n],
                                       rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(krhs, prhs, rtol=1e-4,
                                   atol=3e-7 * float(prhs.abs().max()))
        torch.testing.assert_close(krhs, g_rhs[rows], rtol=1e-6,
                                   atol=1e-6 * float(g_rhs.abs().max()))
    step.shared_face.run()
    for k in range(3):
        step.p[k][1:b + 1] = p[k * b:(k + 1) * b]
    step.p_halo.run()
    for k in range(3):
        halo = step.halo[k]
        faces = b if halo[1] else b + 1
        kmax = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        pmax = torch.zeros(2, dtype=torch.int32)
        kn = fused3d.correct_diag_3d_halo(step.slab, step.u_star[k],
                                          step.p[k], dt / rho, kmax, per,
                                          halo)
        pn = fused3d.correct_diag_3d_halo(
            step.slab, [t.cpu() for t in step.u_star[k]], step.p[k].cpu(),
            dt / rho, pmax, per, halo)
        torch.testing.assert_close(kmax.view(torch.float32).cpu(),
                                   pmax.view(torch.float32), rtol=1e-4,
                                   atol=0.0)
        for a in range(3):
            n = faces if a == 0 else b
            torch.testing.assert_close(kn[a][1:n + 1].cpu(), pn[a][1:n + 1],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(kn[a][1:n + 1],
                                       g_new[a][k * b:k * b + n],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cavity3d", "taylor_green3d"])
def test_cuda_sharded_steps_match_unsharded(cuda_device, name):
    """Five steps in 4 slabs against the unsharded kernel step, within
    rtol = atol = 1e-6; 3 exchange launches a step."""
    case = make_case(name, shape=(64, 32, 32), device=cuda_device)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    sim = sharded_simulation(case.sim, mesh, rdma=True)
    ref, rd = case.sim.run_scan(case.initial_state(), 5)
    fused3d.reset_launch_counts()
    remote_dma.reset_launch_counts()
    st, d = sim.run_scan(shard_state(case.initial_state(), mesh,
                                     case.sim.grid), 5)
    assert remote_dma.LAUNCHES == {"exchange_rows_multi": 15,
                                   "exchange_ghost_rows": 0}
    assert fused3d.LAUNCHES == {"predictor_rhs_3d": 20, "correct_diag_3d": 20,
                                "residual_3d": 10}
    for a in range(3):
        torch.testing.assert_close(st.u[a], ref.u[a], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st.p, ref.p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d.max_div, rd.max_div, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(d.max_cfl, rd.max_cfl, rtol=1e-6, atol=1e-9)


# -- rk2's base mode and the step size on the device --------------------------

DT_DEV = 0.37e-3   # a dt unequal to the float ones above


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("table", ["walls", "periodic"])
def test_cuda_base_mode_and_device_dt_3d(cuda_device, gamma, table):
    """Kernel 1 with and without ``base`` and kernel 2, reading the step
    size from a device buffer, against the plain versions given the same
    dt as a float (kernel 1's tolerances above)."""
    tg = tgrid.GridSpec((37, 19, 45) if table == "walls" else (38, 22, 46),
                        (1.0, 0.6, 1.8))
    tb = tbcs.no_slip_box(tg)
    if table == "periodic":
        for a in range(3):
            tb[(a, 0)] = tb[(a, 1)] = tbcs.BCSpec.periodic()
    else:
        tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    mid, base = (tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(3))) for _ in range(2))
    dts = step_size.buffer(torch.tensor(DT_DEV, device=cuda_device), 1.3,
                           cuda_device)
    per = tbcs.periodic_axes(tg, tb)
    for b in (None, base):
        ks, krhs = fused3d.predictor_rhs_3d(tg, tb, mid, dts[0], 0.02, gamma,
                                            1.3, base=b, dts=dts)
        ps, prhs = fused3d.predictor_rhs_plain(tg, tb, mid, DT_DEV, 0.02,
                                               gamma, 1.3, base=b)
        for a in range(3):
            torch.testing.assert_close(ks[a], ps[a], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(krhs, prhs, rtol=1e-4,
                                   atol=3e-7 * float(prhs.abs().max()))
    p = torch.randn(tg.shape, generator=gen, device=cuda_device)
    kn, kdiv, kvel = fused3d.correct_diag_3d(tg, mid, p, dts[2], per)
    pn, pdiv, pvel = fused3d.correct_diag_plain(tg, mid, p, float(dts[2]),
                                                per)
    for a in range(3):
        torch.testing.assert_close(kn[a], pn[a], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kvel, pvel, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.8])
def test_cuda_base_mode_and_device_dt_2d(cuda_device, gamma):
    """Kernel 4 with and without ``base`` and kernel 5 on a device dt
    (the 2D tolerances above), on the ragged (200, 136) grid."""
    tg = tgrid.GridSpec((200, 136), (1.0, 0.68))
    tb = _walls_2d(tg, "all")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(8)
    mid, base = (tbcs.apply_velocity_bcs(tg, tb, tuple(
        0.1 * torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(2))) for _ in range(2))
    dts = step_size.buffer(torch.tensor(DT_DEV, device=cuda_device), 1.3,
                           cuda_device)
    for b in (None, base):
        ks, krhs = fused2d.predictor_rhs_2d(tg, tb, mid, dts[0], 0.01, gamma,
                                            1.3, base=b, dts=dts)
        ps, prhs = fused2d.predictor_rhs_2d_plain(tg, tb, mid, DT_DEV, 0.01,
                                                  gamma, 1.3, base=b)
        for a in range(2):
            torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=2e-6)
        torch.testing.assert_close(
            krhs, prhs, rtol=0.0,
            atol=2e-6 * max(float(prhs.abs().max()), 1.0))
    p = 0.01 * torch.randn(tg.shape, generator=gen, device=cuda_device)
    kn, _, kvel = fused2d.correct_diag_2d(tg, mid, p, dts[2])
    pn, _, pvel = fused2d.correct_diag_2d_plain(tg, mid, p, float(dts[2]))
    for a in range(2):
        torch.testing.assert_close(kn[a], pn[a], rtol=0.0, atol=2e-6)
    torch.testing.assert_close(kvel, pvel, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_cuda_device_dt_per_component_predictors(cuda_device):
    """Kernels 6 (with nu_t) and 8 read dt from a device buffer; against
    their plain versions at that dt as a float (their tolerances above)."""
    tg = tgrid.GridSpec((37, 19, 45), (1.0, 0.6, 1.8))
    tb = tbcs.no_slip_box(tg)
    tb[(2, 1)] = tbcs.BCSpec.wall((1.0, 0.3, 0.0))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(9)
    u = tbcs.apply_velocity_bcs(tg, tb, tuple(
        torch.randn(tg.face_shape(a), generator=gen, device=cuda_device)
        for a in range(3)))
    dt = torch.tensor(DT_DEV, device=cuda_device)
    nu_t = tles.eddy_viscosity(tg, tb, u, tles.LESConfig(cs=0.2))
    ks = predictor3d.predictor_3d(tg, tb, u, dt, 0.05, 0.8, nu_t=nu_t)
    ps = predictor3d.predictor_3d_plain(tg, tb, u, DT_DEV, 0.05, 0.8,
                                        nu_t=nu_t)
    for a in range(3):
        torch.testing.assert_close(ks[a], ps[a], rtol=0.0, atol=5e-5)
    case = make_case("cylinder", shape=(256, 128), ibm=True,
                     device=cuda_device)
    st = impulsive_start_state(case.sim)
    g, b = case.sim.grid, case.sim.bcs
    ku = predictor2d.predictor_2d(g, b, st.u, dt, 0.005, 0.2,
                                  ghosts=case.sim.ghosts)
    pu = predictor2d.predictor_2d_plain(g, b, st.u, DT_DEV, 0.005, 0.2)
    for a in range(2):
        torch.testing.assert_close(ku[a], pu[a], rtol=0.0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", [
    ("cavity3d", dict(re=100.0), (32, 32, 32)),
    ("taylor_green3d", dict(), (32, 32, 32)),
    ("cavity", dict(re=1e3, upwind_gamma=0.8), (256, 256)),
    ("cylinder", dict(ibm=True), (256, 128)),
    ("cavity3d-les", dict(re=500.0), (32, 32, 32)),
], ids=["cavity3d", "taylor_green3d", "cavity2d", "cylinder", "les"])
@pytest.mark.parametrize("mode", ["rk2", "cfl"])
def test_cuda_rk2_and_cfl_steps_match_plain(cuda_device, name, kw, shape,
                                            mode):
    """Five kernel steps against step_plain under rk2, and under cfl 0.4
    with a cap of 10x the case's dt (the limiter binds): the dt series
    within rtol 3e-5, the fields at the JAX whole-step tolerances (the LES
    step's u atol 5e-5, as above)."""
    les = name.endswith("-les")
    case_name = name.split("-")[0]
    base_dt = make_case(case_name, shape=shape, device=cuda_device,
                        **kw).sim.params.dt
    extra = (dict(integrator="rk2") if mode == "rk2"
             else dict(cfl=0.4, dt=10 * base_dt))
    case = make_case(case_name, shape=shape, device=cuda_device, **kw,
                     **extra)
    sim = case.sim
    if les:
        sim = dataclasses.replace(sim, les=tles.LESConfig(cs=0.17))
    st0 = (impulsive_start_state(sim) if case_name == "cylinder"
           else case.initial_state())
    sk = sp = st0
    dk, dp = [], []
    for _ in range(5):
        sk, d1 = sim.step(sk)
        sp, d2 = sim.step_plain(sp)
        dk.append(d1.dt)
        dp.append(d2.dt)
    torch.testing.assert_close(torch.stack(dk), torch.stack(dp), rtol=3e-5,
                               atol=0.0)
    for a in range(len(shape)):
        if les:
            torch.testing.assert_close(sk.u[a], sp.u[a], rtol=0.0, atol=5e-5)
        else:
            torch.testing.assert_close(sk.u[a], sp.u[a], rtol=2e-5,
                                       atol=2e-6)
    assert bool(torch.isfinite(sk.p).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(integrator="rk2"), dict(cfl=0.3),
                                dict(integrator="rk2", cfl=0.3)],
                         ids=["rk2", "cfl", "rk2-cfl"])
def test_cuda_sharded_rk2_cfl_matches_unsharded(cuda_device, kw):
    """Five steps in 4 slabs against the unsharded kernel step (rtol = atol
    = 1e-6, the dt series within 1e-6); 6 exchange launches a step under
    rk2, 3 under Euler, and kernel 1's stage 2 in halo + base mode."""
    case = make_case("cavity3d", shape=(64, 32, 32), device=cuda_device,
                     **kw)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    sim = sharded_simulation(case.sim, mesh, rdma=True)
    ref, rd = case.sim.run_scan(case.initial_state(), 5)
    remote_dma.reset_launch_counts()
    st, d = sim.run_scan(shard_state(case.initial_state(), mesh,
                                     case.sim.grid), 5)
    per_step = 6 if kw.get("integrator") == "rk2" else 3
    assert remote_dma.LAUNCHES["exchange_rows_multi"] == 5 * per_step
    for a in range(3):
        torch.testing.assert_close(st.u[a], ref.u[a], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d.dt, rd.dt, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cavity3d", "taylor_green3d"])
def test_cuda_halo_base_mode_matches_plain(cuda_device, name):
    """Kernel 1 in halo and ``base`` mode on three slabs, on a device dt,
    against its halo-mode plain version and against the unsharded based
    kernel's rows (the tolerances of test_cuda_halo_kernels_match_plain);
    the base buffers' ghost rows refreshed as the step's first exchange
    refreshes them."""
    sim, step, u, _ = _slab_step(name, (48, 24, 40), 3, cuda_device, 3)
    g, bcs, b = sim.grid, sim.bcs, step.b
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    base = tbcs.apply_velocity_bcs(g, bcs, tuple(
        torch.randn(g.face_shape(a), generator=gen, device=cuda_device)
        for a in range(3)))
    step.cur = 1
    step.load(base)
    step.refresh[1].run()
    step.cur = 0
    dts = step_size.buffer(torch.tensor(DT_DEV, device=cuda_device), 1.3,
                           cuda_device)
    g_star, g_rhs = fused3d.predictor_rhs_3d(g, bcs, u, dts[0], 0.02, 0.8,
                                             1.3, base=base, dts=dts)
    for k in range(3):
        halo = step.halo[k]
        faces = b if halo[1] else b + 1
        ks, krhs = fused3d.predictor_rhs_3d_halo(
            step.slab, bcs, step.u[0][k], dts[0], 0.02, 0.8, 1.3, halo=halo,
            base=step.u[1][k], dts=dts)
        ps, prhs = fused3d.predictor_rhs_halo_plain(
            step.slab, bcs, step.u[0][k], DT_DEV, 0.02, 0.8, 1.3, halo,
            base=step.u[1][k])
        for a in range(3):
            n = faces if a == 0 else b
            torch.testing.assert_close(ks[a][1:n + 1], ps[a][1:n + 1],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(ks[a][1:n + 1],
                                       g_star[a][k * b:k * b + n],
                                       rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(krhs, prhs, rtol=1e-4,
                                   atol=3e-7 * float(prhs.abs().max()))
        torch.testing.assert_close(krhs, g_rhs[k * b:(k + 1) * b], rtol=1e-6,
                                   atol=1e-6 * float(g_rhs.abs().max()))
