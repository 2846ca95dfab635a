"""PyTorch port vs JAX package: running flow statistics (stats.py,
``Simulation.run_scan_stats``).

The 16^2 cavity runs 12 steps through both packages' ``run_scan_stats``
from the same initial state: the finalized means and second moments agree
within the cavity slice's field tolerances (rtol 2e-5 of each field's max,
as the steps themselves differ at float32 roundoff), and the count is
exact. Within the port: the accumulator matches a float64 numpy two-pass
over the same states (rtol 1e-5 of each field's max), chunked
accumulation equals one run bit for bit, and a checkpoint resume equals an
unbroken run bit for bit.
"""

import numpy as np
import pytest
import torch

from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch import stats as tstats
from navierstokessolver_tpu_torch.cases import make_case

STEPS = 12


@pytest.fixture(scope="module")
def cavity():
    return make_case("cavity", shape=(16, 16), device="cpu")


def _two_pass(samples):
    """float64 mean and population variance / covariance of the samples."""
    x = np.stack(samples).astype(np.float64)
    mean = x.mean(axis=0)
    return mean, x - mean


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def test_run_scan_stats_matches_jax(cavity):
    from navierstokessolver_tpu import stats as jstats

    jc = jax_make_case("cavity", shape=(16, 16))
    js, jd, jacc = jc.sim.run_scan_stats(jc.initial_state(), STEPS)
    ts, td, tacc = cavity.sim.run_scan_stats(cavity.initial_state(), STEPS)
    assert tacc.n.dtype == torch.int32 and int(tacc.n) == STEPS
    assert td.max_div.shape == (STEPS,)
    got, ref = tstats.finalize(tacc), jstats.finalize(jacc)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        _close(got[k], ref[k], 2e-5)
    raw_t, raw_j = tstats.to_arrays(tacc), jstats.to_arrays(jacc)
    assert sorted(raw_t) == sorted(raw_j)
    assert all(raw_t[k].dtype == raw_j[k].dtype for k in raw_j)


def test_stats_against_two_pass(cavity):
    sim = cavity.sim
    st = cavity.initial_state()
    samples = {"u0": [], "u1": [], "p": []}
    acc = tstats.init_stats(sim.grid, device="cpu")
    from navierstokessolver_tpu_torch.grid import interpolate_to_centers

    for _ in range(STEPS):
        st, _ = sim.step(st)
        acc = tstats.accumulate(sim.grid, acc, st)
        uc = interpolate_to_centers(sim.grid, st.u)
        samples["u0"].append(uc[0].numpy())
        samples["u1"].append(uc[1].numpy())
        samples["p"].append(st.p.numpy())
    out = tstats.finalize(acc)
    (m0, d0), (m1, d1) = _two_pass(samples["u0"]), _two_pass(samples["u1"])
    mp, dp = _two_pass(samples["p"])
    for k, ref in (("u_mean_0", m0), ("u_mean_1", m1), ("p_mean", mp),
                   ("uu_00", (d0 * d0).mean(0)), ("uu_11", (d1 * d1).mean(0)),
                   ("uu_01", (d0 * d1).mean(0)), ("p_var", (dp * dp).mean(0))):
        _close(out[k], ref, 1e-5)
    assert float(out["n"]) == STEPS


def test_chunked_stats_equal_one_run(cavity):
    sim = cavity.sim
    s0 = cavity.initial_state()
    a, da, acc_a = sim.run_scan_stats(s0, STEPS)
    b, db, acc_b = sim.run_scan_stats(s0, 5)
    b, db2, acc_b = sim.run_scan_stats(b, 0, acc_b)
    assert db2.max_div.shape == (0,)
    b, _, acc_b = sim.run_scan_stats(b, STEPS - 5, acc_b)
    assert torch.equal(a.p, b.p)
    ra, rb = tstats.to_arrays(acc_a), tstats.to_arrays(acc_b)
    assert sorted(ra) == sorted(rb)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])


def test_stats_checkpoint_resume_equals_unbroken(tmp_path, cavity):
    sim = cavity.sim
    h = tio.config_hash(sim.grid, sim.params)
    s0 = cavity.initial_state()
    full, _, acc_full = sim.run_scan_stats(s0, STEPS)
    half, _, acc_half = sim.run_scan_stats(s0, 6)
    path = str(tmp_path / "ckpt.npz")
    tio.save_checkpoint(path, half, 6, h, stats=acc_half)
    st, step = tio.load_checkpoint(path, sim.grid, h, device="cpu")
    acc = tio.load_checkpoint_stats(path, sim.grid.dtype, device="cpu")
    assert step == 6 and int(acc.n) == 6 and acc.n.dtype == torch.int32
    st, _, acc = sim.run_scan_stats(st, STEPS - 6, acc)
    a, b = tstats.finalize(acc_full), tstats.finalize(acc)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert torch.equal(st.u[0], full.u[0])


def test_stats_from_float_count_and_empty():
    """A count saved as float32 (checkpoints of an older layout) loads as
    int32; finalizing no samples raises."""
    g = make_case("cavity", shape=(8, 8), device="cpu").sim.grid
    d = tstats.to_arrays(tstats.init_stats(g, device="cpu"))
    d["n"] = np.float32(3.0)
    acc = tstats.from_arrays(d, device="cpu")
    assert acc.n.dtype == torch.int32 and int(acc.n) == 3
    with pytest.raises(ValueError, match="no samples"):
        tstats.finalize(tstats.init_stats(g, device="cpu"))
