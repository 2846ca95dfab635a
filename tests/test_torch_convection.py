"""PyTorch port vs JAX package: the convection cases end to end.

Ten steps of ``heated_cavity`` (16^2, and 8^3), ``rayleigh_benard``
(16x8, Ra 5e3: axis 0 periodic) and ``heated_cylinder`` (64x32, Re 20: a
passive scalar with an isothermal staircase body on the unfused route)
through both packages' ``make_case`` and ``run_scan``, from the same
initial state, and the 2D cavity also under rk2 at cfl 0.4 (the case's
dt the cap: it is half the explicit scalar update's diffusive limit, and
a cap of 10x, as the isothermal tests take, makes the first steps from
rest unstable, where roundoff grows to 2e-2 in theta). On the CPU the
JAX package takes its jnp step; the port's step runs the kernels' plain
versions (the thermal modes' plain versions on the fused route).
Tolerances are the earlier slices' f32 ones
(tests/test_torch_cavity.py): u rtol 2e-5 / atol 1e-6, p rtol 2e-4 /
atol 1e-6 (the cylinder's iterative solve: atol 1e-4 of max|p|, as in
tests/test_torch_cylinder.py), theta rtol 2e-5 / atol 1e-6. Also: the
fused route carries theta through every step (rk2 included), the
configuration hash and the checkpoints with theta cross between the
packages both ways, and the command line runs a convection case with
snapshots carrying theta and a resume equal to the unbroken run.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from navierstokessolver_tpu import io as jio
from navierstokessolver_tpu.cases import make_case as jmake
from navierstokessolver_tpu_torch import cli as tcli
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch.cases import make_case as tmake

CASES = {
    "cavity2d": ("heated_cavity", dict(shape=(16, 16), ra=1e3)),
    "cavity3d": ("heated_cavity", dict(shape=(8, 8, 8), ra=1e4)),
    "rayleigh_benard": ("rayleigh_benard", dict(shape=(16, 8), ra=5e3)),
    "cylinder": ("heated_cylinder", dict(shape=(64, 32), re=20.0)),
}


def _pair(key, **extra):
    name, kw = CASES[key]
    return (jmake(name, **kw, **extra),
            tmake(name, device="cpu", **kw, **extra))


@pytest.mark.parametrize("key,mode", [
    ("cavity2d", "euler"), ("cavity2d", "rk2"), ("cavity3d", "euler"),
    ("rayleigh_benard", "euler"), ("cylinder", "euler")])
def test_ten_steps_match_jax(key, mode):
    extra = dict(integrator="rk2", cfl=0.4) if mode == "rk2" else {}
    jc, tc = _pair(key, **extra)
    assert tc.sim.params.dt == jc.sim.params.dt
    assert tc.sim.fused == (key != "cylinder")
    js, ts = jc.initial_state(), tc.initial_state()
    np.testing.assert_array_equal(ts.theta.numpy(), np.asarray(js.theta))
    js, jd = jc.sim.run_scan(js, 10)
    ts, td = tc.sim.run_scan(ts, 10)
    u, p, theta = convert.state_to_numpy(ts, with_theta=True)
    for c in range(len(u)):
        np.testing.assert_allclose(u[c], np.asarray(js.u[c]), rtol=2e-5,
                                   atol=1e-6)
    p_atol = (1e-4 * float(np.abs(np.asarray(js.p)).max())
              if key == "cylinder" else 1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=p_atol)
    np.testing.assert_allclose(theta, np.asarray(js.theta), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    # the scalar moved: the flow and the diffusion changed it
    assert np.abs(theta - tc.initial_state().theta.numpy()).max() > 1e-6
    if key == "cylinder":
        solid = tc.sim.scalar_solid.numpy()
        np.testing.assert_array_equal(theta[solid], 1.0)


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_fused_route_carries_theta_every_step(integrator):
    """The fused route's new state holds the new theta after every step
    (a step that dropped it would stop the scalar after one step)."""
    c = tmake("heated_cavity", shape=(16, 16), ra=1e4, device="cpu",
              integrator=integrator)
    assert c.sim.fused and c.sim.thermal is not None
    st = c.initial_state()
    for _ in range(3):
        new, _ = c.sim.step(st)
        assert new.theta is not None
        assert float((new.theta - st.theta).abs().max()) > 0.0
        st = new
    ref = c.initial_state()
    for _ in range(3):
        ref, _ = c.sim.step_plain(ref)
    torch.testing.assert_close(st.theta, ref.theta, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("key", ["cavity2d", "rayleigh_benard", "cylinder"])
def test_config_hash_matches_jax(key):
    jc, tc = _pair(key)
    assert (tio.config_hash(tc.sim.grid, tc.sim.params, tc.sim.scalar)
            == jio.config_hash(jc.sim.grid, jc.sim.params, jc.sim.scalar))
    assert (tio.config_hash(tc.sim.grid, tc.sim.params, tc.sim.scalar)
            != tio.config_hash(tc.sim.grid, tc.sim.params))


def test_checkpoint_with_theta_crosses_both_ways(tmp_path):
    """A JAX checkpoint with theta resumes in the port and the port's in
    JAX, bit for bit; a theta-less checkpoint refuses a scalar run."""
    jc, tc = _pair("cavity2d")
    h = jio.config_hash(jc.sim.grid, jc.sim.params, jc.sim.scalar)
    js, _ = jc.sim.run_scan(jc.initial_state(), 4)
    jio.save_checkpoint(str(tmp_path / "j.npz"), js, 4, h)
    ts, step = tio.load_checkpoint(str(tmp_path / "j.npz"), tc.sim.grid, h,
                                   expect_scalar=True, device="cpu")
    assert step == 4
    np.testing.assert_array_equal(ts.theta.numpy(), np.asarray(js.theta))
    ts, _ = tc.sim.run_scan(ts, 3)
    tio.save_checkpoint(str(tmp_path / "t.npz"), ts, 7, h)
    back, step = jio.load_checkpoint(str(tmp_path / "t.npz"), jc.sim.grid, h,
                                     expect_scalar=True)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(back.theta), ts.theta.numpy())
    for c in range(2):
        np.testing.assert_array_equal(np.asarray(back.u[c]), ts.u[c].numpy())
    plain = tmake("cavity", shape=(16, 16), device="cpu")
    tio.save_checkpoint(str(tmp_path / "p.npz"), plain.initial_state(), 0,
                        "x")
    with pytest.raises(ValueError, match="no theta"):
        tio.load_checkpoint(str(tmp_path / "p.npz"), plain.sim.grid,
                            expect_scalar=True, device="cpu")


def test_cli_runs_a_convection_case_and_resumes(tmp_path):
    """``--case heated_cavity`` with ra / pr from a config file: snapshots
    carry theta, the checkpoint holds it, and a resumed run ends where the
    unbroken one does, bit for bit."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ra": 2e3, "pr": 0.71}))
    common = ["--platform", "cpu", "--config", str(cfg), "--case",
              "heated_cavity", "--shape", "16,16", "--chunk", "4"]
    a, full = tmp_path / "a", tmp_path / "full"
    assert tcli.main(common + ["--steps", "8", "--snapshot-every", "4",
                               "--checkpoint-every", "4",
                               "--out", str(a)]) == 0
    with np.load(a / "snap_00000004.npz") as z:
        assert "theta" in z.files and z["theta"].shape == (16, 16)
    assert tcli.main(common + ["--steps", "4", "--resume",
                               str(a / "ckpt.npz"), "--checkpoint-every",
                               "4", "--out", str(a)]) == 0
    assert tcli.main(common + ["--steps", "12", "--checkpoint-every", "12",
                               "--out", str(full)]) == 0
    with np.load(a / "ckpt.npz") as r, np.load(full / "ckpt.npz") as f:
        assert int(r["step"]) == int(f["step"]) == 12
        for k in ("theta", "p", "u0", "u1"):
            np.testing.assert_array_equal(r[k], f[k], err_msg=k)
    c = tmake("heated_cavity", shape=(16, 16), ra=2e3, pr=0.71, device="cpu")
    st, _ = c.sim.run_scan(c.initial_state(), 12)
    with np.load(full / "ckpt.npz") as f:
        np.testing.assert_array_equal(f["theta"], st.theta.numpy())


def test_snapshot_writer_takes_theta_on_the_cpu(tmp_path):
    c = tmake("rayleigh_benard", shape=(16, 8), device="cpu")
    st, _ = c.sim.run_scan(c.initial_state(), 2)
    w = tio.AsyncSnapshotWriter(str(tmp_path), c.sim.grid, "cpu",
                                scalar=True)
    w.enqueue(st, step=2, time=0.1)
    w.close()
    with np.load(tmp_path / "snap_00000002.npz") as z:
        np.testing.assert_array_equal(z["theta"], st.theta.numpy())
    assert tio.snapshot_shapes(c.sim.grid, theta=True)["theta"] == (16, 8)


def test_state_conversion_carries_theta():
    jc, _ = _pair("rayleigh_benard")
    js = jc.initial_state()
    ts = convert.state_from_numpy([np.asarray(c) for c in js.u],
                                  np.asarray(js.p),
                                  theta=np.asarray(js.theta))
    u, p, theta = convert.state_to_numpy(ts, with_theta=True)
    np.testing.assert_array_equal(theta, np.asarray(js.theta))
    assert len(convert.state_to_numpy(ts)) == 2
    assert dataclasses.replace(ts, theta=None).theta is None
