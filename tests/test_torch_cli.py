"""The port's command line (cli.py, ``python -m navierstokessolver_tpu_torch``)
on the CPU (``--platform cpu``), against the JAX package's CLI.

End to end with snapshots, checkpoints and resume; snapshot cadence cut
into the window and neutral on the trajectory bit for bit (also with the
CFL dt, whose carried reduction must equal the one recomputed at a
segment's entry); the config file; statistics, tracers and force samples;
the unported options raising their ROADMAP item; and the same flags
through both CLIs: the same files, the same CSV columns, and final fields
within the cavity slice's tolerances (u rtol 2e-5 / atol 1e-6, p rtol
2e-4 / atol 1e-6). Without ``--platform`` and without a card the run exits
non-zero with "no CUDA device".
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parent.parent
BASE = ["--platform", "cpu", "--case", "cavity", "--shape", "16,16"]


def _run(tmp_path, name, *flags):
    out = str(tmp_path / name)
    assert main([*BASE, "--out", out, *flags]) == 0
    return out


def _ckpt(out):
    with np.load(os.path.join(out, "ckpt.npz")) as z:
        return {k: z[k] for k in z.files}


def test_cli_end_to_end_and_resume(tmp_path):
    out = _run(tmp_path, "run", "--steps", "40", "--chunk", "20",
               "--snapshot-every", "20", "--checkpoint-every", "20", "--vtk",
               "--csv", str(tmp_path / "m.csv"))
    assert sorted(os.listdir(out)) == [
        "ckpt.npz", "snap_00000020.npz", "snap_00000020.vtk",
        "snap_00000040.npz", "snap_00000040.vtk"]
    assert int(_ckpt(out)["step"]) == 40
    rows = list(csv.DictReader(open(tmp_path / "m.csv")))
    assert [int(r["step"]) for r in rows] == [20, 40]
    # resumed 20 steps equal 60 unbroken ones
    assert main([*BASE, "--out", out, "--steps", "20", "--chunk", "20",
                 "--resume", os.path.join(out, "ckpt.npz"),
                 "--checkpoint-every", "20"]) == 0
    full = _run(tmp_path, "full", "--steps", "60", "--chunk", "30",
                "--checkpoint-every", "60")
    a, b = _ckpt(out), _ckpt(full)
    assert int(a["step"]) == int(b["step"]) == 60
    for k in ("u0", "u1", "p"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cfl", [None, 0.5], ids=["fixed_dt", "cfl0.5"])
def test_snapshot_cadence_is_trajectory_neutral(tmp_path, cfl):
    """--snapshot-every 7 --chunk 200 writes exactly every 7 steps, and the
    fields equal a run without snapshots bit for bit."""
    cfg = tmp_path / "c.json"
    # with the CFL dt a cap of 4x the case's dt, so that the limit sets it
    cfg.write_text(json.dumps({} if cfl is None else {"cfl": cfl,
                                                      "dt": 0.125}))
    flags = ["--config", str(cfg), "--steps", "21", "--chunk", "200",
             "--checkpoint-every", "1000"]
    with_snaps = _run(tmp_path, "snaps", *flags, "--snapshot-every", "7")
    assert sorted(f for f in os.listdir(with_snaps)
                  if f.startswith("snap_")) == [
        "snap_00000007.npz", "snap_00000014.npz", "snap_00000021.npz"]
    plain = _run(tmp_path, "plain", *flags)
    a, b = _ckpt(with_snaps), _ckpt(plain)
    if cfl is not None:
        assert not np.array_equal(a["u0"], _ckpt(_run(
            tmp_path, "fixed", "--steps", "21", "--chunk", "200",
            "--checkpoint-every", "1000"))["u0"])
    for k in ("u0", "u1", "p"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name,shape", [("cavity", (16, 16)),
                                        ("taylor_green", (16, 16)),
                                        ("taylor_green3d", (8, 8, 8))])
def test_segments_equal_one_run_with_cfl(name, shape):
    """run_scan(a) then run_scan(b) is run_scan(a + b) bit for bit under
    the CFL dt: the fused routes carry the corrector's max|u_a|/h_a, and
    a segment's entry recomputes the same number."""
    dt = make_case(name, shape=shape, device="cpu").sim.params.dt
    # a cap of 4x the case's dt, so that the CFL limit sets the dt
    case = make_case(name, shape=shape, cfl=0.5, dt=4 * dt, device="cpu")
    sim = case.sim
    s0 = case.initial_state()
    a, da = sim.run_scan(s0, 9)
    b, db = sim.run_scan(s0, 4)
    b, db2 = sim.run_scan(b, 5)
    assert torch.equal(torch.cat([db.dt, db2.dt]), da.dt)
    assert float(da.dt.min()) < float(da.dt.max())
    for x, y in zip((*a.u, a.p), (*b.u, b.p)):
        assert torch.equal(x, y)


def test_cli_config_file_and_case_flag(tmp_path):
    """--config supplies overrides and the reserved keys; flags win, and
    the file's 'case' never reaches the case builder."""
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"case": "channel", "shape": [16, 16],
                               "re": 250.0, "steps": 4}))
    out = str(tmp_path / "o")
    assert main(["--platform", "cpu", "--config", str(cfg), "--case",
                 "cavity", "--out", out, "--checkpoint-every", "4",
                 "--chunk", "4"]) == 0
    z = _ckpt(out)
    assert int(z["step"]) == 4 and z["u0"].shape == (17, 16)
    assert main(["--platform", "cpu", "--config", str(cfg), "--case",
                 "cavity", "--shape", "12,12", "--steps", "2", "--out", out,
                 "--checkpoint-every", "2", "--chunk", "2"]) == 0
    z = _ckpt(out)
    assert int(z["step"]) == 2 and z["u0"].shape == (13, 12)


def test_cli_stats_tracers_forces(tmp_path, capsys):
    out = _run(tmp_path, "stats", "--steps", "12", "--chunk", "5",
               "--stats-start", "4", "--checkpoint-every", "5")
    with np.load(os.path.join(out, "stats.npz")) as z:
        assert float(z["n"]) == 8 and z["uu_01"].shape == (16, 16)
    assert int(_ckpt(out)["stats_n"]) == 8
    # the statistics resume with the checkpoint, whatever --stats-start
    assert main([*BASE, "--out", out, "--steps", "3", "--resume",
                 os.path.join(out, "ckpt.npz")]) == 0
    with np.load(os.path.join(out, "stats.npz")) as z:
        assert float(z["n"]) == 11
    out = _run(tmp_path, "tr", "--steps", "6", "--chunk", "4", "--tracers",
               "16", "--tracer-seed", "2", "--forces-box", "2,14,2,14",
               "--checkpoint-every", "6")
    with np.load(os.path.join(out, "tracers.npz")) as z:
        assert z["traj"].shape == (6, 16, 2)
        np.testing.assert_array_equal(z["final"], z["traj"][-1])
    assert _ckpt(out)["tracer_pos"].shape == (16, 2)
    rows = list(csv.reader(open(os.path.join(out, "forces.csv"))))
    assert rows[0] == ["step", "sf_x", "sf_y", "mom_x", "mom_y"]
    assert [r[0] for r in rows[1:]] == ["4", "6"]
    capsys.readouterr()
    out = _run(tmp_path, "both", "--steps", "2", "--tracers", "4",
               "--stats-start", "0")
    assert "mutually exclusive" in capsys.readouterr().err
    assert sorted(os.listdir(out)) == ["stats.npz"]


def test_cli_resume_backfills_p_prev(tmp_path):
    """A checkpoint without p_prev resumes an extrapolated run with
    p_prev = p, as the JAX CLI backfills it."""
    from navierstokessolver_tpu_torch import io as tio

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"poisson_method": "mg",
                               "poisson_extrapolate": 0.5}))
    case = make_case("cavity", shape=(16, 16), poisson_method="mg",
                     poisson_extrapolate=0.5, device="cpu")
    st, _ = case.sim.run_scan(case.initial_state(), 3)
    h = tio.config_hash(case.sim.grid, case.sim.params)
    path = str(tmp_path / "old.npz")
    tio.save_checkpoint(path, type(st)(u=st.u, p=st.p), 3, h)
    out = _run(tmp_path, "r", "--config", str(cfg), "--steps", "2",
               "--resume", path, "--checkpoint-every", "2")
    ref, _ = case.sim.run_scan(type(st)(u=st.u, p=st.p, p_prev=st.p), 2)
    z = _ckpt(out)
    np.testing.assert_array_equal(z["p"], ref.p.numpy())
    np.testing.assert_array_equal(z["p_prev"], ref.p_prev.numpy())


def test_cli_sharded_devices_3d(tmp_path):
    """--devices 2 runs the slab-sharded 3D step (both slabs on the run's
    device), equal to the unsharded run on the CPU."""
    flags = ["--platform", "cpu", "--case", "cavity3d", "--shape", "16,8,8",
             "--steps", "3", "--checkpoint-every", "3"]
    assert main([*flags, "--out", str(tmp_path / "sh"), "--devices",
                 "2"]) == 0
    assert main([*flags, "--out", str(tmp_path / "un")]) == 0
    a, b = _ckpt(str(tmp_path / "sh")), _ckpt(str(tmp_path / "un"))
    for k in ("u0", "u1", "u2", "p"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)


PORTED_CASES = {
    "cavity": ["--shape", "16,16"],
    "cavity_hi_re": ["--shape", "32,32"],
    "cavity3d": ["--shape", "8,8,8"],
    "cavity3d_les": ["--shape", "8,8,8", "--les-cs", "0.17"],
    "channel": ["--shape", "32,16"],
    "channel_periodic": ["--shape", "32,16"],
    "cylinder": ["--shape", "64,32"],
    "cylinder_ibm": ["--shape", "64,32", "--ibm"],
    "taylor_green": ["--shape", "16,16"],
    "taylor_green3d": ["--shape", "8,8,8"],
    "decaying_turbulence": ["--shape", "32,32"],
}
INTEGRATORS = {"euler": {"integrator": "euler"}, "rk2": {"integrator": "rk2"},
               "cfl": {"cfl": 0.5}}


@pytest.mark.parametrize("integrator", list(INTEGRATORS))
@pytest.mark.parametrize("key", list(PORTED_CASES))
def test_cli_runs_every_ported_case(tmp_path, key, integrator):
    """Every case the port runs goes through the command line, under each
    integrator (the CFL dt from the config file): three steps, a
    checkpoint of the case's shapes, finite fields, a CSV row."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(INTEGRATORS[integrator]))
    name = key.removesuffix("_les").removesuffix("_ibm")
    out = str(tmp_path / "o")
    assert main(["--platform", "cpu", "--case", name, *PORTED_CASES[key],
                 "--config", str(cfg), "--steps", "3", "--chunk", "2",
                 "--checkpoint-every", "3", "--out", out, "--csv",
                 str(tmp_path / "m.csv")]) == 0
    z = _ckpt(out)
    shape = tuple(int(x) for x in PORTED_CASES[key][1].split(","))
    assert int(z["step"]) == 3 and z["p"].shape == shape
    for a in range(len(shape)):
        assert z[f"u{a}"].shape[a] == shape[a] + 1
    assert all(np.isfinite(z[k]).all() for k in ("u0", "u1", "p"))
    rows = list(csv.DictReader(open(tmp_path / "m.csv")))
    assert [int(r["steps"]) for r in rows] == [2, 1]
    assert all(float(r["max_div"]) < 1e-3 for r in rows)


@pytest.mark.parametrize("name,title", [
    ("sphere", "Other BC kinds"), ("kolmogorov", "Physics extensions"),
    ("duct_periodic", "Physics extensions"),
    ("pulsatile_channel", "Physics extensions"),
    ("oscillating_lid", "Physics extensions"),
    ("heated_enclosure", "Physics extensions"),
])
def test_cli_jax_only_cases_raise(tmp_path, name, title):
    """The JAX CLI's cases through the port's command line: the six that
    raised their ROADMAP item until the forcing slice and the sphere's
    slice run two steps at a small shape and write their checkpoint (a
    time-dependent one with t); the sphere's unported convective outlet
    (through --config) raises, naming its item, before anything is
    written."""
    out = tmp_path / "x"
    if name == "sphere":
        cfg = tmp_path / "outlet.json"
        cfg.write_text(json.dumps({"outlet": "convective"}))
        with pytest.raises(NotImplementedError, match=title):
            main(["--platform", "cpu", "--case", name, "--steps", "1",
                  "--config", str(cfg), "--out", str(out)])
        assert not out.exists()
    shape = ("32,16,16" if name == "sphere" else
             "16,8,8" if name in ("duct_periodic", "oscillating_lid")
             else "16,16")
    assert main(["--platform", "cpu", "--case", name, "--shape", shape,
                 "--steps", "2", "--out", str(out),
                 "--checkpoint-every", "2"]) == 0
    with np.load(out / "ckpt.npz") as z:
        assert int(z["step"]) == 2
        assert ("t" in z.files) == (name in ("pulsatile_channel",
                                              "oscillating_lid"))


@pytest.mark.parametrize("flags,title", [
    (["--sharp-pressure"], "Physics extensions"),
    (["--poisson-comm", "halo"], "explicit-halo solvers"),
    (["--devices", "4"], "explicit-halo solvers"),
    (["--les-cs", "0.17"], "Physics extensions"),
    (["--case", "heated_cavity", "--shape", "8,8,8", "--les-cs", "0.17"],
     "Physics extensions"),
], ids=["sharp_pressure", "poisson_comm_halo", "devices_2d", "les_2d",
        "heated_cavity"])
def test_cli_unported_options_raise(tmp_path, flags, title):
    with pytest.raises(NotImplementedError, match=title):
        main([*BASE, "--steps", "1", "--out", str(tmp_path / "x"), *flags])


@pytest.mark.parametrize("iters", [[1, 1, 1], [3, 7, 2, 5]],
                         ids=["direct", "iterative"])
def test_window_stats_match_jax(iters):
    """A window's log line and CSV row: the JAX package's keys and values
    for the same per-step diagnostics."""
    from navierstokessolver_tpu.utils.metrics import WindowStats as JWindow

    from navierstokessolver_tpu_torch.solver import StepDiagnostics
    from navierstokessolver_tpu_torch.utils.metrics import WindowStats

    rng = np.random.default_rng(len(iters))
    n = len(iters)
    cols = dict(poisson_iters=np.asarray(iters, np.int32),
                poisson_res=rng.random(n).astype(np.float32) * 1e-5,
                max_div=rng.random(n).astype(np.float32) * 1e-6,
                max_cfl=rng.random(n).astype(np.float32),
                dt=np.full(n, 0.03125, np.float32))
    diag = StepDiagnostics(**{k: torch.from_numpy(v) for k, v in
                              cols.items()})
    kw = dict(step=40, dt=0.03125, wall_s=0.0125, n_cells=256)
    got = WindowStats.from_diag(diag, **kw).as_dict()
    ref = JWindow.from_diag(StepDiagnostics(**cols), **kw).as_dict()
    assert list(got) == list(ref)
    assert got == ref


def test_cli_platform_choice():
    with pytest.raises(ValueError, match="--platform 'tpu'"):
        main(["--platform", "tpu"])


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    """The same flags through the JAX CLI (in-process) and the port's
    (``python -m navierstokessolver_tpu_torch``, a subprocess)."""
    from navierstokessolver_tpu.cli import main as jax_main

    tmp = tmp_path_factory.mktemp("clis")
    flags = ["--case", "cavity", "--shape", "16,16", "--steps", "40",
             "--chunk", "20", "--snapshot-every", "20",
             "--checkpoint-every", "20"]
    assert jax_main([*flags, "--out", str(tmp / "jax"), "--csv",
                     str(tmp / "jax.csv")]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "navierstokessolver_tpu_torch", "--platform",
         "cpu", *flags, "--out", str(tmp / "port"), "--csv",
         str(tmp / "port.csv")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return tmp, proc.stderr


def test_cli_matches_jax_cli(both_clis):
    tmp, stderr = both_clis
    assert "[cli] done at step 40" in stderr
    assert (sorted(os.listdir(tmp / "port"))
            == sorted(os.listdir(tmp / "jax")))
    jr = list(csv.DictReader(open(tmp / "jax.csv")))
    tr = list(csv.DictReader(open(tmp / "port.csv")))
    assert list(tr[0]) == list(jr[0])
    assert [r["step"] for r in tr] == [r["step"] for r in jr]
    for k in ("poisson_iters_max", "n_cells", "steps", "dt", "sim_time"):
        assert [r[k] for r in tr] == [r[k] for r in jr]
    a, b = _ckpt(str(tmp / "port")), _ckpt(str(tmp / "jax"))
    assert sorted(a) == sorted(b) and bytes(a["cfg"]) == bytes(b["cfg"])
    for k in ("u0", "u1"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(a["p"], b["p"], rtol=2e-4, atol=1e-6)
    for name in ("snap_00000020.npz", "snap_00000040.npz"):
        with np.load(tmp / "port" / name) as zt, \
                np.load(tmp / "jax" / name) as zj:
            assert zt.files == zj.files
            assert str(zt["__meta__"]) == str(zj["__meta__"])
            assert all(zt[k].shape == zj[k].shape for k in zj.files)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the run without a card")
def test_cli_without_card_raises():
    proc = subprocess.run(
        [sys.executable, "-m", "navierstokessolver_tpu_torch", "--case",
         "cavity", "--shape", "16,16", "--steps", "2", "--out", "unused"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "no CUDA device" in proc.stderr
    assert not (ROOT / "unused").exists()


def test_new_modules_leave_jax_out():
    mods = ("cli", "io", "native", "stats", "tracers", "utils.metrics",
            "utils.spectra", "__main__")
    code = ("import sys; " + "; ".join(
        f"import navierstokessolver_tpu_torch.{m}" for m in mods)
        + "; bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'navierstokessolver_tpu.')) or m == "
        "'navierstokessolver_tpu']; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
