"""PyTorch port vs JAX package: the Poiseuille channel (BASELINE config #2).

The builders agree bit for bit (the parabolic inflow profile, the BC
table, dt and nu, ``poiseuille_state``); five steps of a 64x16 channel
with mg and with mgcg through both packages' ``make_case`` agree with the
tolerances of tests/test_torch_cylinder.py (u rtol 2e-5 / atol 1e-6, p
rtol 2e-4 / atol 1e-5; the same iteration counts wherever the solve ends
on its tolerance, see the tests for mg's), from the Poiseuille state and
from the case's own start (a developing flow); and the port keeps the JAX
package's
oracles (tests/test_channel.py): the profile persists for 200 steps (drift
< 2e-2, max_div < 1e-3) and outflow flux tracks inflow flux after 100
(5e-3). The inflow profile reaches the step through the BC passes and
the predictor kernel's ghost table (on the CPU its plain version); the
CUDA kernel is held to the plain version on a GPU in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.channel import (
    parabolic_profile as jax_parabolic_profile,
    poiseuille_state as jax_poiseuille_state,
)
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch.bcs import BCKind
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.channel import (
    parabolic_profile, poiseuille_state,
)
from navierstokessolver_tpu_torch.ops import predictor2d

SMALL = dict(shape=(64, 16), lengths=(4.0, 1.0))


@pytest.fixture(scope="module")
def channels():
    return jax_make_case("channel", **SMALL), make_case("channel",
                                                       device="cpu", **SMALL)


def test_channel_builders_match_jax(channels):
    jc, tc = channels
    js, ts = jc.sim, tc.sim
    assert tc.name == "channel"
    assert ts.params.dt == js.params.dt and ts.params.nu == js.params.nu
    assert ts.params.poisson.method == js.params.poisson.method == "mg"
    assert ts.params.poisson.tol == js.params.poisson.tol
    assert ts.params.poisson.max_iters == js.params.poisson.max_iters
    assert tc.suggested_steps == jc.suggested_steps
    np.testing.assert_array_equal(parabolic_profile(ts.grid, 1.0),
                                  np.asarray(jax_parabolic_profile(js.grid,
                                                                   1.0)))
    for face in js.bcs:
        jb, tb = js.bcs[face], ts.bcs[face]
        assert tb.kind.value == jb.kind.value
        assert len(tb.velocity) == len(jb.velocity)
        for tv, jv in zip(tb.velocity, jb.velocity):
            np.testing.assert_array_equal(np.asarray(tv, np.float32),
                                          np.asarray(jv, np.float32))
    # the profile lives on the simulation's device as float32, once
    prof = ts.bcs[(0, 0)].velocity[0]
    assert isinstance(prof, torch.Tensor) and prof.dtype == torch.float32
    # the unfused route with the kernel's ghost table: v across the inflow
    # (reflected, beta 0) and outflow (copied) faces, u across the walls
    assert not ts.fused and ts.ghosts is not None
    alpha, betas = predictor2d.ghost_parts(ts.grid, ts.ghosts)
    assert alpha.tolist() == [-1.0, -1.0, -1.0, 1.0]
    assert not any(bool(b.any()) for b in betas)
    assert ts.mg_solver is not None and ts.bcs[(0, 1)].kind is BCKind.OUTFLOW


def test_poiseuille_state_matches_jax(channels):
    jc, tc = channels
    jst, tst = jax_poiseuille_state(jc.sim), poiseuille_state(tc.sim)
    for a in range(2):
        np.testing.assert_array_equal(tst.u[a].numpy(), np.asarray(jst.u[a]))
    np.testing.assert_array_equal(tst.p.numpy(), np.asarray(jst.p))


@pytest.mark.parametrize("method,start,tol", [
    pytest.param("mg", "steady", None, id="mg"),
    pytest.param("mgcg", "steady", None, id="mgcg"),
    pytest.param("mg", "developing", 1e-4, id="mg-developing"),
])
def test_channel_five_steps_match_jax(method, start, tol):
    """From the Poiseuille state ("steady") with the case's tol 1e-5: mg,
    the channel's default, stops each solve at the float32 residual floor
    (relative residuals 3-5e-5 at this size in both packages; 2-3e-5 from
    the developing start) by its stagnation rule (a cycle that gains less
    than 10%), so its cycle counts move with roundoff: held within 2 a
    step, every residual below 1e-4. mgcg converges to tol: the same
    counts. From the case's own start (fluid at rest, the inflow profile
    on: "developing") mg at tol 1e-4, above the floor, ends every solve on
    its tolerance in both packages: the same counts."""
    kw = dict(SMALL, poisson_method=method)
    if tol is not None:
        kw["poisson_tol"] = tol
    jc = jax_make_case("channel", **kw)
    tc = make_case("channel", device="cpu", **kw)
    if start == "steady":
        j0, t0 = jax_poiseuille_state(jc.sim), poiseuille_state(tc.sim)
    else:
        j0, t0 = jc.initial_state(), tc.initial_state()
    js, jd = jc.sim.run_scan(j0, 5)
    predictor2d.reset_launch_counts()
    ts, td = tc.sim.run_scan(t0, 5)
    assert predictor2d.LAUNCHES["predictor_2d"] == 0   # CPU: the plain one
    u, p = convert.state_to_numpy(ts)
    for a in range(2):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-5)
    t_it, j_it = td.poisson_iters.tolist(), np.asarray(jd.poisson_iters).tolist()
    if method == "mgcg" or start == "developing":
        t_tol = tol or 1e-5
        assert t_it == j_it
        assert (td.poisson_res <= t_tol).all()
        assert (np.asarray(jd.poisson_res) <= t_tol).all()
    else:
        assert max(abs(a - b) for a, b in zip(t_it, j_it)) <= 2, (t_it, j_it)
        assert (td.poisson_res < 1e-4).all()
        assert (np.asarray(jd.poisson_res) < 1e-4).all()
    div = 1e-4 if start == "steady" else 1e-3
    assert float(td.max_div.max()) < div and float(jd.max_div.max()) < div
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)


def test_poiseuille_profile_persists(channels):
    """JAX's oracle (tests/test_channel.py) on the port."""
    sim = channels[1].sim
    st = poiseuille_state(sim)
    u0 = st.u[0].clone()
    st, diag = sim.run_scan(st, 200)
    drift = float((st.u[0] - u0).abs().max())
    assert drift < 2e-2, f"Poiseuille drift {drift:.3e}"
    assert float(diag.max_div[-1]) < 1e-3


def test_mass_conservation_inflow_outflow(channels):
    """Outflow flux tracks inflow flux once the field is divergence-free
    (JAX's oracle)."""
    sim = channels[1].sim
    st, _ = sim.run_scan(poiseuille_state(sim), 100)
    q_in = float(st.u[0][0, :].sum())
    q_out = float(st.u[0][-1, :].sum())
    assert abs(q_out - q_in) / abs(q_in) < 5e-3


@pytest.mark.parametrize("name,kw,title", [
    ("channel", dict(outlet="convective"), "Other BC kinds"),
    ("kolmogorov", {}, "Physics extensions"),
    ("duct_periodic", {}, "Physics extensions"),
    ("pulsatile_channel", {}, "Physics extensions"),
])
def test_unported_channels_raise(name, kw, title):
    """What raised its ROADMAP item builds now: the convective outlet
    (since the convective slice: the unfused route, two steps from the
    Poiseuille state equal to JAX's; tests/test_torch_convective.py holds
    it further) and the forced cases of the forcing slice (a forcing
    volume, a 3D static force, a callable of t), which take a step
    (tests/test_torch_forcing.py, tests/test_torch_timedep.py hold them to
    JAX)."""
    if name == "channel":
        jc = jax_make_case(name, shape=(32, 16), **kw)
        case = make_case(name, shape=(32, 16), device="cpu", **kw)
        assert not case.sim.fused and title == "Other BC kinds"
        assert case.sim.bcs[(0, 1)].kind is BCKind.CONVECTIVE
        js, _ = jc.sim.run_scan(jax_poiseuille_state(jc.sim), 2)
        ts, _ = case.sim.run_scan(poiseuille_state(case.sim), 2)
        for a in range(2):
            np.testing.assert_allclose(ts.u[a].numpy(), np.asarray(js.u[a]),
                                       rtol=2e-5, atol=1e-6)
        return
    shape = (16, 8, 8) if name == "duct_periodic" else (32, 16)
    case = make_case(name, shape=shape, device="cpu", **kw)
    assert case.sim.forcing is not None and case.sim.fused
    st, d = case.sim.step(case.initial_state())
    assert max(float(c.abs().max()) for c in st.u) > 0.0


def test_channel_2048x512_mg_floor_matches_jax():
    """mg's stall at 2048x512 from rest is the JAX package's too: three
    steps of each package (the port's plain step) take the same V-cycles
    a step (2, 2, 12: the stagnation rule stops each solve far above tol,
    relative residuals 0.07, 0.81, 0.04), and max_div agrees within rtol
    0.1 (22.2, 9.19, 0.226 in both). A reference behaviour the port
    matches, not a fault of the port."""
    jc = jax_make_case("channel", shape=(2048, 512))
    tc = make_case("channel", shape=(2048, 512), device="cpu")
    js, ts = jc.initial_state(), tc.initial_state()
    j_it, t_it, j_div, t_div = [], [], [], []
    for _ in range(3):
        js, jd = jc.sim.run_scan(js, 1)
        ts, td = tc.sim.step_plain(ts)
        j_it.append(int(np.asarray(jd.poisson_iters)[0]))
        t_it.append(int(td.poisson_iters))
        j_div.append(float(np.asarray(jd.max_div)[0]))
        t_div.append(float(td.max_div))
    assert t_it == j_it, (t_it, j_it)
    np.testing.assert_allclose(t_div, j_div, rtol=0.1)
    assert max(j_it) < jc.sim.params.poisson.max_iters
