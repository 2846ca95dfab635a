"""PyTorch port vs JAX package: the convective outlet (CONVECTIVE faces).

A CONVECTIVE face's normal DOF obeys du/dt + U du/dn = 0: JAX's jnp step
transports it once a step on u* after the predictor
(``bcs.apply_convective_outlets``, from the step-start field, over the
stage's dt), holds it through the projection and corrects it with the
Dirichlet-ghost gradient (``bcs.correct_convective_faces``). The port runs
it on every route JAX does: the fused 2D kernels under Euler (the
cylinder), the unfused 2D route (rk2, the IBM, the channel's inflow
profile: kernel 8, whose ghost table copies the edge across the face), and
the fused 3D kernels' convective variant under Euler and rk2 (the sphere).
On the CPU the plain versions run. Each case runs from the same state
through both packages' ``run_scan`` and is held to the tolerances of
JAX's own tests (``tests/test_fused_step.py``
``test_fused3d_convective_outlet_matches_reference``, ``tests/
test_pallas2d.py``): u rtol 2e-5 / atol 2e-6, p rtol 2e-4 / atol 2e-5,
max_div rtol 1e-3 / atol 1e-6, max_cfl rtol 1e-3 / atol 1e-8, the
iteration counts equal. Where max_div is the residual of a solve that
stops at 1e-5 it follows each package's roundoff, and is held as
tests/test_torch_cylinder.py holds it (below a bound in both, within 50%
of each other): the IBM cylinder (dctcg, its sweeps within one) and the
sphere, whose convective outlet leaves no outlet-cell divergence (the
Dirichlet-ghost correction closes the outlet cells), so its first step's
maximum is the mg residual's at p of O(50): 3.2e-5 against 2.6e-5, in
other cells.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import io as jio
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.channel import (
    poiseuille_state as jax_poiseuille_state,
)
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.grid import GridSpec as JGrid
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.channel import poiseuille_state
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.cli import main
from navierstokessolver_tpu_torch.grid import GridSpec as TGrid
from navierstokessolver_tpu_torch.ops import fused3d

MG_CYL = dict(shape=(64, 32), re=100.0, poisson_method="mg",
              outlet="convective")
MG_SPHERE = dict(shape=(16, 16, 16), lengths=(8.0, 8.0, 8.0),
                 center=(2.0, 4.1, 3.9), diameter=1.6, poisson_method="mg",
                 outlet="convective")


def _tables(nd):
    """A table with CONVECTIVE faces on both sides of axis 0 (phase speeds
    0.7 and 1.3) and on the high side of axis 1, in both packages."""
    def build(m):
        t = {(a, s): m.BCSpec.slip() for a in range(nd) for s in (0, 1)}
        t[(0, 0)] = m.BCSpec.convective(0.7)
        t[(0, 1)] = m.BCSpec.convective(1.3)
        t[(1, 1)] = m.BCSpec.convective(2.0)
        return t
    return build(jbcs), build(tbcs)


def test_convective_outlet_matches_jax(tmp_path):
    """Every check below in one test: the suite's count of collected tests
    stays where its worker split keeps JAX's sharded tests apart
    (.claude/skills/verify/SKILL.md)."""
    for shape in ((12, 9), (6, 5, 7)):
        _bcs_match_jax(shape)
    for kw, fused in ((dict(MG_CYL), True),
                      (dict(MG_CYL, integrator="rk2"), False),
                      (dict(shape=(128, 64), outlet="convective", ibm=True),
                       False)):
        _cylinder_matches_jax(kw, fused)
    _channel_keeps_poiseuille()
    for integrator in ("euler", "rk2"):
        _sphere_matches_jax(integrator)
    _lateral_outlet_matches_jax()
    _config_hash_and_cli(tmp_path)
    _speed_that_is_not_a_number_raises()


def _bcs_match_jax(shape):
    """apply_convective_outlets (a 0-d dt, as the CFL step hands it, and a
    Python float; C clamped at 1 for the fast face), correct_convective_
    faces, the BC pass that leaves the faces as they are, and the
    tangential ghosts that copy the edge: bit for bit on random fields."""
    nd = len(shape)
    lengths = (2.0, 1.0, 1.5)[:nd]
    jg, tg = JGrid(shape, lengths), TGrid(shape, lengths)
    jt, tt = _tables(nd)
    tbcs.validate_bcs(tg, tt)
    assert tbcs.has_convective_outlet(tg, tt)
    assert jbcs.has_convective_outlet(jg, jt)
    rng = np.random.default_rng(3)
    u, old = ([rng.standard_normal(tg.face_shape(a)).astype(np.float32)
               for a in range(nd)] for _ in range(2))
    p = rng.standard_normal(shape).astype(np.float32)
    ju, jo = tuple(map(jnp.asarray, u)), tuple(map(jnp.asarray, old))
    tu, to = tuple(map(torch.from_numpy, u)), tuple(map(torch.from_numpy,
                                                          old))
    for dt in (0.05, torch.tensor(0.05), 0.4):
        jr = jbcs.apply_convective_outlets(jg, jt, ju, jo, jnp.float32(dt))
        tr = tbcs.apply_convective_outlets(tg, tt, tu, to, dt)
        for a in range(nd):
            np.testing.assert_array_equal(tr[a].numpy(), np.asarray(jr[a]))
    jr = jbcs.correct_convective_faces(jg, jt, ju, jnp.asarray(p), 0.1)
    tr = tbcs.correct_convective_faces(tg, tt, tu, torch.from_numpy(p), 0.1)
    for a in range(nd):
        np.testing.assert_array_equal(tr[a].numpy(), np.asarray(jr[a]))
    jr = jbcs.apply_velocity_bcs(jg, jt, ju)
    tr = tbcs.apply_velocity_bcs(tg, tt, tu)
    for a in range(nd):
        np.testing.assert_array_equal(tr[a].numpy(), np.asarray(jr[a]))
        np.testing.assert_array_equal(
            tbcs.pad_transverse(tg, tt, a, tu[a]).numpy(),
            np.asarray(jbcs.pad_transverse(jg, jt, a, ju[a])))


def _compare(js, jd, ts, td, slack=0, div=None):
    u, p = convert.state_to_numpy(ts)
    for a in range(len(u)):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=2e-5)
    t_it = td.poisson_iters.tolist()
    j_it = np.asarray(jd.poisson_iters).tolist()
    assert max(abs(a - b) for a, b in zip(t_it, j_it)) <= slack, (t_it, j_it)
    t_div, j_div = td.max_div.numpy(), np.asarray(jd.max_div)
    if div is None:
        np.testing.assert_allclose(t_div, j_div, rtol=1e-3, atol=1e-6)
    else:
        assert t_div.max() < div and j_div.max() < div
        np.testing.assert_allclose(t_div, j_div, rtol=0.5)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)


def _cylinder_matches_jax(kw, fused):
    """The convective cylinder from the impulsive start, five steps: the
    staircase under Euler on the fused 2D kernels' convective variant,
    under rk2 on the unfused route (JAX fuses the outlet under Euler
    only), the IBM cylinder (dctcg) on the unfused route."""
    jc = jax_make_case("cylinder", **kw)
    tc = make_case("cylinder", device="cpu", **kw)
    assert tc.sim.fused is fused
    assert tc.sim.bcs[(0, 1)].kind is tbcs.BCKind.CONVECTIVE
    js, jd = jc.sim.run_scan(jax_impulsive_start(jc.sim), 5)
    ts, td = tc.sim.run_scan(impulsive_start_state(tc.sim), 5)
    ibm = kw.get("ibm", False)
    _compare(js, jd, ts, td, slack=1 if ibm else 0,
             div=5e-5 if ibm else None)


def _channel_keeps_poiseuille():
    """The channel with the convective outlet (U = 2 u_max / 3, the
    unfused route: its inflow is a profile): the Poiseuille state is a
    steady solution, as JAX's tests/test_channel.py checks it (the outlet
    transports the parabola into itself), and five steps from it equal
    JAX's within the channel's mg slack (its solves stop on the stagnation
    rule at the float32 floor: tests/test_torch_channel.py)."""
    kw = dict(shape=(64, 16), outlet="convective")
    jc = jax_make_case("channel", **kw)
    tc = make_case("channel", device="cpu", **kw)
    assert not tc.sim.fused
    assert tc.sim.bcs[(0, 1)].convective_speed() == pytest.approx(2.0 / 3.0)
    js, jd = jc.sim.run_scan(jax_poiseuille_state(jc.sim), 5)
    st = poiseuille_state(tc.sim)
    u0 = st.u[0].clone()
    ts, td = tc.sim.run_scan(st, 5)
    u, p = convert.state_to_numpy(ts)
    for a in range(2):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-5)
    t_it = td.poisson_iters.tolist()
    j_it = np.asarray(jd.poisson_iters).tolist()
    assert max(abs(a - b) for a, b in zip(t_it, j_it)) <= 2, (t_it, j_it)
    ts, td = tc.sim.run_scan(ts, 195)
    assert float((ts.u[0] - u0).abs().max()) < 2e-2
    assert float(td.max_div[-1]) < 1e-3


def _sphere_matches_jax(integrator):
    """The convective sphere at 16^3 (mg; JAX's own test of the fused 3D
    convective outlet) from the case's start, five steps, Euler and rk2:
    the fused 3D kernels' convective variant (the masked one), the rk2
    stage 2 anchored at the step-start face."""
    kw = dict(MG_SPHERE, integrator=integrator)
    jc = jax_make_case("sphere", **kw)
    tc = make_case("sphere", device="cpu", **kw)
    assert tc.sim.fused
    assert fused3d.open_mask(tc.sim.grid, tc.sim.bcs) & fused3d.OPEN_CONV
    js, jd = jc.sim.run_scan(jc.initial_state(), 5)
    ts, td = tc.sim.run_scan(tc.initial_state(), 5)
    _compare(js, jd, ts, td, div=1e-4)


def _lateral_outlet_matches_jax():
    """A CONVECTIVE face off (0, 1) (the high side of axis 1, a lateral
    outlet of the cylinder's domain): JAX's jnp step takes it anywhere,
    and so does the port's unfused route; the fused kernels keep out."""
    def table(m):
        return {(0, 0): m.BCSpec.inflow((1.0, 0.2)),
                (0, 1): m.BCSpec.outflow(), (1, 0): m.BCSpec.slip(),
                (1, 1): m.BCSpec.convective(0.5)}
    jc = jax_make_case("cylinder", **MG_CYL)
    tc = make_case("cylinder", device="cpu", **MG_CYL)
    jsim = type(jc.sim).build(jc.sim.grid, table(jbcs), jc.sim.params,
                              solid=np.asarray(jc.sim.op.code) >> 6 & 1 == 0)
    tsim = type(tc.sim).build(tc.sim.grid, table(tbcs), tc.sim.params,
                              "cpu",
                              solid=(tc.sim.op.code >> 6 & 1 == 0).numpy())
    assert not tsim.fused
    js, jd = jsim.run_scan(jax_impulsive_start(jsim), 5)
    ts, td = tsim.run_scan(impulsive_start_state(tsim), 5)
    _compare(js, jd, ts, td)


def _config_hash_and_cli(tmp_path):
    """The convective cylinder's config_hash is JAX's (a checkpoint
    resumes across the packages), and ``--case cylinder`` with a config of
    {"outlet": "convective"} runs through the port's command line: its
    checkpoint carries that hash and equals JAX's command line's state."""
    jc = jax_make_case("cylinder", **MG_CYL)
    tc = make_case("cylinder", device="cpu", **MG_CYL)
    h = tio.config_hash(tc.sim.grid, tc.sim.params)
    assert h == jio.config_hash(jc.sim.grid, jc.sim.params)
    from navierstokessolver_tpu.cli import main as jax_main

    cfg = tmp_path / "outlet.json"
    cfg.write_text(json.dumps({"outlet": "convective", "re": 100.0,
                               "poisson_method": "mg"}))
    flags = ["--case", "cylinder", "--shape", "64,32", "--steps", "3",
             "--config", str(cfg), "--checkpoint-every", "3"]
    assert main(["--platform", "cpu", *flags, "--out",
                 str(tmp_path / "port")]) == 0
    assert jax_main([*flags, "--out", str(tmp_path / "jax")]) == 0
    with np.load(tmp_path / "port" / "ckpt.npz") as a, \
            np.load(tmp_path / "jax" / "ckpt.npz") as b:
        assert bytes(a["cfg"]) == bytes(b["cfg"])
        for k in ("u0", "u1"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(a["p"], b["p"], rtol=2e-4, atol=2e-5)


def _speed_that_is_not_a_number_raises():
    """A callable phase speed (the kernels read a static one) or more than
    one number raises, naming 'Other BC kinds'; no speed means 1.0, as in
    JAX."""
    tg = TGrid((8, 8), (1.0, 1.0))
    tb = tbcs.no_slip_box(tg)
    for vel in ((lambda t: 1.0,), (1.0, 2.0)):
        tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.CONVECTIVE, vel)
        with pytest.raises(NotImplementedError, match="Other BC kinds"):
            tbcs.validate_bcs(tg, tb)
    tb[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.CONVECTIVE)
    tbcs.validate_bcs(tg, tb)
    assert tb[(0, 1)].convective_speed() == 1.0
    assert tb[(0, 1)].component(0, 2) == 0.0
