"""PyTorch port vs JAX package: the lid-driven cavity slice end to end.

Five projection steps of ``cavity3d`` (16^3) and ``cavity`` (32^2) at
Re=100 from the same initial state through both packages' ``make_case``
entry points, with the tolerances of the JAX package's fused-vs-jnp step
test (tests/test_fused_step.py): u rtol 2e-5/atol 1e-6, p rtol 2e-4/atol
1e-6, max_cfl rtol 1e-3, and max_div bounded in both (it is roundoff noise
with another summation order in each). The CUDA kernels are held to their
plain versions on a GPU in tests/test_torch_cuda.py.
"""

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


@pytest.mark.parametrize("name,shape", [("cavity3d", (16, 16, 16)),
                                        ("cavity", (32, 32))])
def test_cavity_five_steps_match_jax(name, shape):
    jc = jax_make_case(name, shape=shape, re=100.0)
    tc = make_case(name, shape=shape, re=100.0, device="cpu")
    assert tc.sim.params.dt == jc.sim.params.dt
    js, ts = jc.initial_state(), tc.initial_state()
    for c in range(len(shape)):
        np.testing.assert_array_equal(ts.u[c].numpy(), np.asarray(js.u[c]))
    for _ in range(5):
        js, jd = jc.sim.step(js)
        ts, td = tc.sim.step(ts)
    u, p = convert.state_to_numpy(ts)
    for c in range(len(shape)):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-6)
    assert float(td.max_div) < 5e-6 and float(jd.max_div) < 5e-6
    np.testing.assert_allclose(float(td.max_cfl), float(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    assert int(td.poisson_iters) == int(jd.poisson_iters) == 1
    assert 0.0 <= float(td.poisson_res) < 1e-4
    assert float(td.dt) == np.float32(jc.sim.params.dt)


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


def test_make_case_errors():
    with pytest.raises(KeyError, match="cavity3d"):
        make_case("cylinder")
    with pytest.raises(NotImplementedError, match="RK2"):
        make_case("cavity", shape=(8, 8), integrator="rk2")
    with pytest.raises(NotImplementedError, match="RK2"):
        make_case("cavity", shape=(8, 8), cfl=0.5)
    with pytest.raises(NotImplementedError, match="Iterative"):
        make_case("cavity", shape=(8, 8), poisson_method="cg")


def test_import_leaves_jax_out():
    code = ("import sys, navierstokessolver_tpu_torch, "
            "navierstokessolver_tpu_torch.cases, "
            "navierstokessolver_tpu_torch.convert, "
            "navierstokessolver_tpu_torch.ops.fused3d; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'navierstokessolver_tpu.')) or m == "
            "'navierstokessolver_tpu']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stdout + out.stderr
