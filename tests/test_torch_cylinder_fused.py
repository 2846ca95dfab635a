"""PyTorch port vs JAX package: the staircase cylinder on the fused 2D
kernels (kernels 4-5's open and masked modes).

``make_case("cylinder")`` is the JAX package's BASELINE #3 topology: a
uniform INFLOW at (0, 0), an OUTFLOW at (0, 1), SLIP faces on axis 1 and a
staircase obstacle. The port runs it on the fused 2D route, as JAX's fused
2D step takes it: the predictor and the corrector in their masked mode
(the kinds from the bc buffer's ghost maps, the obstacle's open and
correction bits from the Poisson stencil code). On the CPU the kernels'
plain versions run, the JAX jnp step's composition; five steps from the
impulsive start equal JAX's ``run_scan`` (its jnp step) within the
tolerances of JAX's own fused-2D test (``tests/test_pallas2d.py``
``test_fused2d_sim_matches_reference``): u rtol 2e-5 / atol 2e-6, p rtol
2e-4 / atol 2e-5, max_cfl rtol 1e-3 / atol 1e-8, the iteration counts
equal (mg) or within one (dctcg); max_div rtol 1e-3 / atol 1e-6 with mg
under Euler and cfl. Where max_div is the residual of a solve that stops
at 1e-5 it follows the two packages' roundoff (dctcg: the first step's
1.07e-5 against 1.29e-5 at 128x64; rk2, whose stage 2 the port forms as
JAX's fused kernel does, base + dt RHS(u_mid), and JAX's jnp step as u +
(u*_mid - u_mid): 2.10e-5 against 1.97e-5 with mg, 1.44e-5 against
1.11e-5 with dctcg; JAX's own rk2 test with an obstacle holds u only):
held as tests/test_torch_cylinder.py holds it, below 5e-5 in both, and
within 50% of each other.
"""

import numpy as np
import torch

from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import fused2d, fused3d, predictor2d

MG = dict(shape=(64, 32), re=100.0, poisson_method="mg")
DCTCG = dict(shape=(128, 64))
MODES = {"euler": {}, "rk2": dict(integrator="rk2"), "cfl": dict(cfl=0.4)}
COUNT_SLACK = 1


def _cases(**kw):
    return (jax_make_case("cylinder", **kw),
            make_case("cylinder", device="cpu", **kw))


def test_staircase_cylinder_on_fused_kernels_matches_jax():
    """The route, five steps of each configuration against JAX's
    run_scan, and the CPU step against the plain step (one test: the
    suite's count of collected tests stays where its worker split keeps
    JAX's sharded tests apart, .claude/skills/verify/SKILL.md)."""
    _takes_the_fused_route()
    for method in ("mg", "dctcg"):
        for mode in MODES:
            _matches_jax(method, mode)
    _kernel_step_equals_plain_step_on_cpu()


def _takes_the_fused_route():
    """The staircase cylinder (Euler, rk2, cfl) builds on the fused 2D
    route: the open mode's bc buffer (the face values, no force, each
    value's ghost map: SLIP faces copy, the INFLOW face reflects), the
    open mask with the OUTFLOW face at (0, 1), and the stencil code for
    the masked mode. The IBM cylinder and a heated one stay unfused."""
    for mode in MODES.values():
        sim = make_case("cylinder", shape=(64, 32), device="cpu",
                        **mode).sim
        assert sim.fused and sim.ghosts is None
        assert sim._code is sim.op.code
    g, b = sim.grid, sim.bcs
    assert sim.bc.shape == (fused2d.BC_SIZE_OPEN,)
    np.testing.assert_array_equal(
        sim.bc.numpy(),
        np.float32([1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                    0, -1, 1, 1, 1, 0, 1, 0]))
    assert fused3d.open_mask(g, b) == fused3d.OPEN_KINDS | (1 << 1)
    assert fused2d.fused_step2d_applicable(g, b)
    for kw in (dict(ibm=True), dict(heated=True)):
        assert not make_case("cylinder", shape=(64, 32), device="cpu",
                             **kw).sim.fused
    # what the open modes do not take stays off the fused route: a force,
    # a periodic axis with an obstacle (JAX's gate), open faces with a
    # periodic axis (no such instantiation)
    solid = ~fused3d.masks_from_code(g, sim.op.code)[2].bool().numpy()
    forced = type(sim).build(g, b, sim.params, "cpu", solid=solid,
                             forcing=(0.1, None))
    assert not forced.fused
    per = dict(b)
    per[(1, 0)] = per[(1, 1)] = tbcs.BCSpec.periodic()
    assert not fused2d.fused_step2d_applicable(g, per)


def _matches_jax(method, mode):
    """Five steps of the staircase cylinder from the impulsive start on
    the fused route's plain versions against JAX's run_scan: mg at 64x32
    (the JAX fused-2D test's case), dctcg (the case's default) at 128x64;
    Euler, rk2 and cfl 0.4."""
    kw = dict(MG if method == "mg" else DCTCG, **MODES[mode])
    jc, tc = _cases(**kw)
    assert tc.sim.fused
    js0, ts0 = jax_impulsive_start(jc.sim), impulsive_start_state(tc.sim)
    js, jd = jc.sim.run_scan(js0, 5)
    fused2d.reset_launch_counts()
    predictor2d.reset_launch_counts()
    ts, td = tc.sim.run_scan(ts0, 5)
    # the CPU runs the plain versions: no launch counted
    assert fused2d.LAUNCHES == {"predictor_rhs_2d": 0, "correct_diag_2d": 0}
    assert predictor2d.LAUNCHES["predictor_2d"] == 0
    u, p = convert.state_to_numpy(ts)
    for a in range(2):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=2e-5)
    t_it = td.poisson_iters.tolist()
    j_it = np.asarray(jd.poisson_iters).tolist()
    t_div, j_div = td.max_div.numpy(), np.asarray(jd.max_div)
    assert max(abs(a - b) for a, b in zip(t_it, j_it)) <= (
        0 if method == "mg" else COUNT_SLACK)
    if method == "mg" and mode != "rk2":
        np.testing.assert_allclose(t_div, j_div, rtol=1e-3, atol=1e-6)
    else:
        assert t_div.max() < 5e-5 and j_div.max() < 5e-5
        np.testing.assert_allclose(t_div, j_div, rtol=0.5)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=1e-6)


def _kernel_step_equals_plain_step_on_cpu():
    """On the CPU the kernel step is the plain one (the wrappers run the
    plain versions): step and step_plain agree bit for bit, and the
    masked mode keeps the obstacle's faces at zero and the OUTFLOW face a
    copy of its inner face."""
    sim = make_case("cylinder", device="cpu", **MG).sim
    s0 = impulsive_start_state(sim)
    sk, dk = sim.step(s0)
    sp, dp = sim.step_plain(s0)
    for a in range(2):
        assert torch.equal(sk.u[a], sp.u[a])
        assert torch.equal(sk.u[a] * (1 - sim.face_masks[a]),
                           torch.zeros_like(sk.u[a]))
    assert torch.equal(sk.p, sp.p)
    assert torch.equal(sk.u[0][-1], sk.u[0][-2] * sim.face_masks[0][-1])
