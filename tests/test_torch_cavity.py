"""PyTorch port vs JAX package: the lid-driven cavity slice end to end.

Five projection steps of ``cavity3d`` (16^3), ``cavity`` (32^2) and a
``cavity`` whose axis 0 runs the split DCT (1024x64, upwind_gamma 0.8) at
Re=100 from the same initial state through both packages' ``make_case``
entry points, with the tolerances of the JAX package's fused-vs-jnp step
test (tests/test_fused_step.py): u rtol 2e-5/atol 1e-6, p rtol 2e-4/atol
1e-6, max_cfl rtol 1e-3, and max_div bounded in both (it is roundoff noise
with another summation order in each, and grows as 1/h). The CUDA kernels
are held to their plain versions on a GPU in tests/test_torch_cuda.py.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokessolver_tpu.cases import make_case as jax_make_case
from test_cavity import GHIA_U, GHIA_V
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch.cases import make_case


@pytest.mark.parametrize("name,shape,gamma,div_bound,p_atol", [
    pytest.param("cavity3d", (16, 16, 16), 0.0, 5e-6, 1e-6,
                 id="cavity3d-shape0"),
    pytest.param("cavity", (32, 32), 0.0, 5e-6, 1e-6, id="cavity-shape1"),
    pytest.param("cavity", (1024, 64), 0.8, 1e-4, 1e-3,
                 id="cavity-split-gamma0.8"),
])
def test_cavity_five_steps_match_jax(name, shape, gamma, div_bound, p_atol):
    """The 1024x64 case runs the JAX package's fused 2D step, its Pallas
    kernels in interpret mode (``use_pallas=True``, ``pallas_interpret``),
    with the split-level DCT on axis 0; the others its default step. At
    1024x64 (max|p| 3.8) the JAX package's own fused and jnp steps differ
    by 3.6e-4 in p after 5 steps, float32 roundoff of 1024-term
    transforms, hence p atol 1e-3 there."""
    kw = dict(shape=shape, re=100.0, upwind_gamma=gamma)
    if shape[0] >= 1024:
        jc = jax_make_case(name, use_pallas=True, **kw)
        jsim = dataclasses.replace(jc.sim, pallas_interpret=True)
        assert jsim._fused2d_ok() and jsim.dct_solver.plans[0].levels == 3
    else:
        jc = jax_make_case(name, **kw)
        jsim = jc.sim
    tc = make_case(name, device="cpu", **kw)
    assert tc.sim.params.dt == jc.sim.params.dt
    assert ([p.levels for p in tc.sim.dct_solver.plans]
            == [p.levels for p in jsim.dct_solver.plans])
    js, ts = jc.initial_state(), tc.initial_state()
    for c in range(len(shape)):
        np.testing.assert_array_equal(ts.u[c].numpy(), np.asarray(js.u[c]))
    for _ in range(5):
        js, jd = jsim.step(js)
        ts, td = tc.sim.step(ts)
    u, p = convert.state_to_numpy(ts)
    for c in range(len(shape)):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=p_atol)
    assert float(td.max_div) < div_bound and float(jd.max_div) < div_bound
    np.testing.assert_allclose(float(td.max_cfl), float(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    assert int(td.poisson_iters) == int(jd.poisson_iters) == 1
    # float32 roundoff of the refined solve: 1.5e-4 in both packages at
    # 1024x64, well below 1e-4 on the small grids
    assert 0.0 <= float(td.poisson_res) < 1e-4 * max(1, shape[0] // 256)
    assert float(td.dt) == np.float32(jc.sim.params.dt)


@pytest.mark.parametrize("model", ["smagorinsky", "dynamic"])
def test_les_cavity_five_steps_match_jax(model):
    """The LES step: ``cavity3d`` 16^3 at Re=500 with the closure set by
    ``dataclasses.replace(sim, les=...)`` in both packages. On the CPU the
    JAX package takes its jnp LES route (its own test holds that to the
    kernel route, tests/test_pallas.py::test_les_step_kernel_path_matches_
    jnp_step); the port's step runs its kernels' plain versions. The
    tolerances are those of test_cavity_five_steps_match_jax."""
    from navierstokessolver_tpu.les import LESConfig

    jcfg = LESConfig(cs=0.2, model=model)
    jc = jax_make_case("cavity3d", shape=(16, 16, 16), re=500.0)
    jsim = dataclasses.replace(jc.sim, les=jcfg)
    tc = make_case("cavity3d", shape=(16, 16, 16), re=500.0, device="cpu")
    tsim = dataclasses.replace(tc.sim, les=convert.les_config_from_jax(jcfg))
    assert tsim.les.model == model and tc.sim.les is None
    # the JAX side as one jitted scan (one compile, not one per eager op)
    js, jd = jsim.run_scan(jc.initial_state(), 5)
    ts, td = tsim.run_scan(tc.initial_state(), 5)
    u, p = convert.state_to_numpy(ts)
    for c in range(3):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-6)
    assert float(td.max_div[-1]) < 5e-6 and float(jd.max_div[-1]) < 5e-6
    np.testing.assert_allclose(float(td.max_cfl[-1]), float(jd.max_cfl[-1]),
                               rtol=1e-3, atol=1e-8)
    assert int(td.poisson_iters[-1]) == int(jd.poisson_iters[-1]) == 1
    # the closure changes the flow: the LES run differs from a plain one
    plain = tc.initial_state()
    for _ in range(5):
        plain, _ = tc.sim.step(plain)
    if model == "smagorinsky":
        assert float((plain.u[0] - ts.u[0]).abs().max()) > 1e-3


def test_cavity_64_matches_ghia():
    """The port's own physics oracle: the 64x64 Re=100 cavity at steady
    state against Ghia, Ghia & Shin (1982), with the JAX package's
    tolerance (tests/test_cavity.py)."""
    case = make_case("cavity", shape=(64, 64), dt=0.005, device="cpu")
    sim = case.sim
    st = case.initial_state()
    for _ in range(16):  # up to t = 40, with early exit at steadiness
        prev = st
        st, diag = sim.run_scan(st, 500)
        change = max(float((a - b).abs().max()) for a, b in zip(st.u, prev.u))
        if change / (sim.params.dt * 500) < 2e-4:
            break
    u, _ = convert.state_to_numpy(st)
    n = 64
    centers = (np.arange(n) + 0.5) / n
    ext = np.concatenate([[0.0], centers, [1.0]])
    u_ext = np.concatenate([[0.0], u[0][n // 2, :], [1.0]])   # x = 0.5
    v_ext = np.concatenate([[0.0], u[1][:, n // 2], [0.0]])   # y = 0.5
    err_u = np.abs(np.interp(GHIA_U[:, 0], ext, u_ext) - GHIA_U[:, 1])
    err_v = np.abs(np.interp(GHIA_V[:, 0], ext, v_ext) - GHIA_V[:, 1])
    assert err_u.max() < 0.035 and err_v.max() < 0.035, (err_u.max(),
                                                         err_v.max())
    assert float(diag.max_div[-1]) < 5e-4


def test_run_scan_stacks_step_diagnostics():
    tc = make_case("cavity3d", shape=(8, 8, 8), re=100.0, device="cpu")
    st0 = tc.initial_state()
    st, diag = tc.sim.run_scan(st0, 3)
    ref = st0
    for _ in range(3):
        ref, _ = tc.sim.step(ref)
    for c in range(3):
        np.testing.assert_array_equal(st.u[c].numpy(), ref.u[c].numpy())
    for field in diag:
        assert field.shape == (3,)
    assert diag.poisson_iters.dtype == torch.int32
    # the step of the fused composition equals the plain composition
    sp, _ = tc.sim.step_plain(st0)
    sk, _ = tc.sim.step(st0)
    for c in range(3):
        np.testing.assert_allclose(sk.u[c].numpy(), sp.u[c].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,shape,method", [
    ("cavity3d", (8, 8, 8), "fft"), ("cavity", (16, 16), "fft"),
    ("cavity", (16, 16), "mgcg"),
])
def test_run_scan_zero_steps_matches_jax(name, shape, method):
    """``run_scan(state, 0)`` returns the state as given and diagnostics of
    length 0, as JAX's length-0 ``lax.scan`` does (tests/test_timedep.py
    holds the JAX side): the same fields, shapes and dtypes."""
    kw = dict(shape=shape, re=100.0, poisson_method=method)
    jc = jax_make_case(name, **kw)
    js, jd = jc.sim.run_scan(jc.initial_state(), 0)
    tc = make_case(name, device="cpu", **kw)
    st0 = tc.initial_state()
    st, diag = tc.sim.run_scan(st0, 0)
    assert st is st0
    u, p = convert.state_to_numpy(st)
    for c in range(len(shape)):
        np.testing.assert_array_equal(u[c], np.asarray(js.u[c]))
    np.testing.assert_array_equal(p, np.asarray(js.p))
    for f in diag._fields:
        got, want = getattr(diag, f), np.asarray(getattr(jd, f))
        assert got.shape == want.shape == (0,), f
        assert got.device == tc.sim.device
        assert str(got.dtype).split(".")[-1] == str(want.dtype), f
    with pytest.raises(ValueError, match="n_steps >= 0"):
        tc.sim.run_scan(st0, -1)


def test_flagship_2048_builds():
    """The headline configuration (bench.py's default: 2048^2, Re=1e4,
    upwind_gamma 0.8, fft) builds on the CPU with the JAX solver's four
    split levels per axis; it is run on the card by chip_smoke.py."""
    tc = make_case("cavity", shape=(2048, 2048), re=1e4, upwind_gamma=0.8,
                   device="cpu")
    sim = tc.sim
    assert [p.levels for p in sim.dct_solver.plans] == [4, 4]
    assert sim.params.dt == 2.0 ** -12 and sim.params.nu == 1e-4
    assert sim.bc.tolist() == [0, 0, 0, 0, 0, 0, 1, 0, 0, 0]   # no force


def test_cavity_hi_re_builds_jax_parameters():
    """BASELINE config #4 by name: JAX's registry entry (2048^2, Re 1e4,
    fft, upwind gamma 0.8) with its dt, nu and split levels; an override
    reaches the builder as in JAX."""
    tc = make_case("cavity_hi_re", device="cpu")
    jc = jax_make_case("cavity_hi_re", shape=(64, 64))
    sim = tc.sim
    assert sim.grid.shape == (2048, 2048)
    assert sim.params.dt == 2.0 ** -12 and sim.params.nu == 1e-4
    assert sim.params.upwind_gamma == 0.8 and sim.params.poisson.method == "fft"
    assert [p.levels for p in sim.dct_solver.plans] == [4, 4]
    small = make_case("cavity_hi_re", shape=(64, 64), device="cpu").sim
    js = jc.sim
    assert small.grid.shape == js.grid.shape == (64, 64)
    assert small.params.dt == js.params.dt and small.params.nu == js.params.nu
    assert small.params.upwind_gamma == js.params.upwind_gamma == 0.8
    assert small.params.poisson.method == js.params.poisson.method == "fft"
    assert small.params.poisson.tol == js.params.poisson.tol


@pytest.mark.parametrize("method,n", [("mg", 64), ("mgcg", 64),
                                      ("cg", 32)])
def test_iterative_cavity_five_steps_match_jax(method, n):
    """Five steps of the Re=100 cavity with an iterative pressure solve
    (tol 1e-5, 2000 iterations, warm-started from the previous pressure)
    through both packages' ``make_case``; the JAX side is one
    ``run_scan``. On the CPU both multigrid solvers take their plain
    V-cycle route. Tolerances of test_cavity_five_steps_match_jax for u,
    p, max_div and max_cfl; per step the same iteration count, and
    residuals at most tol that agree within 20% (they sit a few float32
    roundoffs of ``b - A p`` apart, summed in another order in each)."""
    kw = dict(shape=(n, n), re=100.0, poisson_method=method)
    jc = jax_make_case("cavity", **kw)
    tc = make_case("cavity", device="cpu", **kw)
    assert tc.sim.params.poisson.max_iters == 2000
    js, jd = jc.sim.run_scan(jc.initial_state(), 5)
    ts, td = tc.sim.run_scan(tc.initial_state(), 5)
    u, p = convert.state_to_numpy(ts)
    for c in range(2):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-6)
    assert float(td.max_div[-1]) < 5e-5 and float(jd.max_div[-1]) < 5e-5
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    assert td.poisson_iters.tolist() == np.asarray(jd.poisson_iters).tolist()
    assert (td.poisson_res <= 1e-5).all()
    np.testing.assert_allclose(td.poisson_res.numpy(),
                               np.asarray(jd.poisson_res), rtol=0.2)


def test_extrapolated_warm_start_matches_jax():
    """``poisson_extrapolate=0.5``: each solve starts from p + 0.5 (p -
    p_prev) and the state carries p_prev (the previous step's p) in both
    packages."""
    kw = dict(shape=(32, 32), re=100.0, poisson_method="cg",
              poisson_extrapolate=0.5)
    jc = jax_make_case("cavity", **kw)
    tc = make_case("cavity", device="cpu", **kw)
    t0 = tc.initial_state()
    assert tc.sim.params.poisson.extrapolate == 0.5
    assert t0.p_prev is not None and float(t0.p_prev.abs().max()) == 0.0
    js, jd = jc.sim.run_scan(jc.initial_state(), 4)
    ts, td = tc.sim.run_scan(t0, 3)
    ts4, td4 = tc.sim.step(ts)
    np.testing.assert_array_equal(ts4.p_prev.numpy(), ts.p.numpy())
    np.testing.assert_allclose(ts4.p.numpy(), np.asarray(js.p),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(ts4.p_prev.numpy(), np.asarray(js.p_prev),
                               rtol=2e-4, atol=1e-6)
    assert (td.poisson_iters.tolist() + [int(td4.poisson_iters)]
            == np.asarray(jd.poisson_iters).tolist())
    # the fft solve ignores it, as in JAX
    assert make_case("cavity", shape=(8, 8), poisson_extrapolate=0.5,
                     device="cpu").initial_state().p_prev is None


def test_default_device_is_the_card():
    """``make_case`` without ``device`` builds on the card; without one it
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        case = make_case("cavity", shape=(32, 32))
        assert case.sim.op.diag.device.type == "cuda"
        assert case.initial_state().p.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_case("cavity", shape=(32, 32))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_case("cavity3d", shape=(8, 8, 8), poisson_method="mg")


def test_make_case_errors():
    # a name neither package registers
    with pytest.raises(KeyError, match="cavity3d.*channel.*cylinder"):
        make_case("lid_driven_annulus")
    # rk2 and the CFL-adaptive dt build; float64 stays unported
    rk2 = make_case("cavity", shape=(8, 8), integrator="rk2", device="cpu")
    assert rk2.sim.params.integrator == "rk2"
    cfl = make_case("cavity", shape=(8, 8), cfl=0.5, device="cpu")
    assert cfl.sim.params.cfl == 0.5
    with pytest.raises(NotImplementedError, match="RK2, CFL-adaptive dt"):
        make_case("cavity", shape=(8, 8), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown integrator"):
        make_case("cavity", shape=(8, 8), integrator="rk4", device="cpu")
    # the sphere builds since its slice; its convective outlet still raises
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        make_case("sphere", shape=(8, 8, 8), device="cpu",
                  outlet="convective")
    with pytest.raises(ValueError, match="unknown poisson method"):
        make_case("cavity", shape=(8, 8), poisson_method="fmg")


@pytest.mark.parametrize("name", ["oscillating_lid", "heated_enclosure"])
def test_jax_only_cases_raise_physics_extensions(name):
    """The cases JAX builds with time-dependent BC values, or with buoyancy
    around an obstacle, raised 'Physics extensions' until the forcing
    slice ported them; they build on the CPU now and take a step (the
    oscillating lid on the fused route carrying t, the enclosure on the
    unfused route with its buoyancy; tests/test_torch_timedep.py and
    tests/test_torch_forcing.py hold them to JAX). Since the sphere's
    slice no registered case raises; the sphere's unported options do
    (test_make_case_errors, tests/test_torch_sphere.py)."""
    kw = dict(shape=(8, 8, 8)) if name == "oscillating_lid" else dict(
        shape=(16, 16))
    case = make_case(name, device="cpu", **kw)
    st, d = case.sim.step(case.initial_state())
    assert case.sim.fused == (name == "oscillating_lid")
    assert (st.t is not None) == (name == "oscillating_lid")
    assert float(d.max_div) < 1e-4


def test_import_leaves_jax_out():
    code = ("import sys, navierstokessolver_tpu_torch, "
            "navierstokessolver_tpu_torch.cases, "
            "navierstokessolver_tpu_torch.convert, "
            "navierstokessolver_tpu_torch.les, "
            "navierstokessolver_tpu_torch.ops.fused2d, "
            "navierstokessolver_tpu_torch.ops.fused3d, "
            "navierstokessolver_tpu_torch.ops.predictor3d, "
            "navierstokessolver_tpu_torch.ops.poisson, "
            "navierstokessolver_tpu_torch.ops.multigrid, "
            "navierstokessolver_tpu_torch.ops.multigrid_kernels, "
            "navierstokessolver_tpu_torch.ops.predictor2d, "
            "navierstokessolver_tpu_torch.ops.fft_poisson, "
            "navierstokessolver_tpu_torch.ibm, "
            "navierstokessolver_tpu_torch.cases.cylinder, "
            "navierstokessolver_tpu_torch.cases.channel, "
            "navierstokessolver_tpu_torch.utils.forces, "
            "navierstokessolver_tpu_torch.drag_lift, "
            "navierstokessolver_tpu_torch.cases.taylor_green, "
            "navierstokessolver_tpu_torch.cases.turbulence, "
            "navierstokessolver_tpu_torch.utils.spectra, "
            "navierstokessolver_tpu_torch.ops.trailing_dct, "
            "navierstokessolver_tpu_torch.step_profile; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'navierstokessolver_tpu.')) or m == "
            "'navierstokessolver_tpu']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stdout + out.stderr
