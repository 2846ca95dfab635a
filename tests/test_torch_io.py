"""PyTorch port vs JAX package: the I/O tier (io.py, native.py, the derived
fields of ops/stencils.py, utils/spectra.energy_spectrum_3d).

The same fields, made from a seed with numpy, go into both packages'
snapshot code at 16^2 and 8^3. Snapshots carry the same keys, shapes,
dtypes and ``__meta__``; the face and centred velocities, the pressure,
the 2D vorticity and the Q-criterion are bit-equal; the streamfunction
(a prefix sum in another order) is held to n1 ulps of max|psi| and the
3D vorticity magnitude to 4 ulps of its max. VTK files of identical arrays
are byte-equal to the JAX package's, binary (both native codecs) and
ASCII. ``config_hash`` gives JAX's string for six configurations, and
checkpoints cross between the packages in both directions and continue
10 steps within the cavity slice's tolerances (u rtol 2e-5 / atol 1e-6,
p rtol 2e-4 / atol 1e-6, as tests/test_torch_cavity.py).
"""

import dataclasses
import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import io as jio
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.grid import GridSpec as JGrid
from navierstokessolver_tpu.grid import State as JState
from navierstokessolver_tpu.les import LESConfig as JLES
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu.utils import spectra as jspectra
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.grid import GridSpec, State
from navierstokessolver_tpu_torch.les import LESConfig
from navierstokessolver_tpu_torch.ops import stencils as tst
from navierstokessolver_tpu_torch.utils import spectra as tspectra

EPS = float(np.finfo(np.float32).eps)
U_TOL = dict(rtol=2e-5, atol=1e-6)
P_TOL = dict(rtol=2e-4, atol=1e-6)
SHAPES = {"2d": ((16, 16), (1.0, 1.0)), "2d_rect": ((12, 20), (1.5, 0.7)),
          "3d": ((8, 8, 8), (1.0, 0.7, 1.3))}


def _fields(shape, lengths, seed=0):
    """Seeded velocity and pressure as numpy, and both packages' grid and
    state built from them."""
    rng = np.random.default_rng(seed)
    tg, jg = GridSpec(shape, lengths), JGrid(shape, lengths)
    u = [rng.standard_normal(tg.face_shape(a)).astype(np.float32)
         for a in range(len(shape))]
    p = rng.standard_normal(shape).astype(np.float32)
    ts = convert.state_from_numpy(u, p)
    js = JState(u=tuple(jnp.asarray(c) for c in u), p=jnp.asarray(p))
    return tg, jg, ts, js


@pytest.fixture(scope="module", params=list(SHAPES))
def pair(request):
    return _fields(*SHAPES[request.param])


def _check_arrays(a, b, ny):
    """Port snapshot ``a`` against JAX's ``b``: keys in order, shapes,
    dtypes, values at the stated tolerances."""
    assert list(a) == list(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if k == "streamfunction":
            tol = ny * EPS * np.abs(b[k]).max()
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol)
        elif k == "vorticity_mag":
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=4 * EPS * np.abs(b[k]).max())
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshot_arrays_match_jax(pair):
    tg, jg, ts, js = pair
    a = tio.snapshot_arrays(tg, ts)
    b = jio.snapshot_arrays(jg, js)
    _check_arrays(a, b, tg.shape[-1])


def test_snapshot_file_matches_jax(tmp_path, pair):
    """The npz files: the same keys, shapes, dtypes and ``__meta__``; the
    ``.npy`` member of each bit-equal field, and of ``__meta__``, byte for
    byte JAX's (whose file is deflated; the port's is stored)."""
    tg, jg, ts, js = pair
    tio.write_snapshot(str(tmp_path / "t.npz"), tg, ts, step=20, time=0.625)
    jio.write_snapshot(str(tmp_path / "j.npz"), jg, js, step=20, time=0.625)
    with zipfile.ZipFile(tmp_path / "t.npz") as zt, \
            zipfile.ZipFile(tmp_path / "j.npz") as zj:
        assert zt.namelist() == zj.namelist()
        for n in zj.namelist():
            if n not in ("streamfunction.npy", "vorticity_mag.npy"):
                assert zt.read(n) == zj.read(n), n
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert zt.files == zj.files and zt.files[0] == "__meta__"
        assert str(zt["__meta__"]) == str(zj["__meta__"])
        assert json.loads(str(zt["__meta__"])) == dict(
            step=20, time=0.625, shape=list(tg.shape),
            lengths=list(tg.lengths))
        _check_arrays({k: zt[k] for k in zt.files[1:]},
                      {k: zj[k] for k in zj.files[1:]}, tg.shape[-1])


def test_derived_fields_match_jax(pair):
    """Each derived field, and torch.gradient (edge_order=1) as the
    q-criterion's jnp.gradient: central inside, one-sided at the edges,
    bit for bit."""
    tg, jg, ts, js = pair
    if tg.ndim == 2:
        np.testing.assert_array_equal(tst.vorticity_2d(tg, ts.u).numpy(),
                                      np.asarray(jst.vorticity_2d(jg, js.u)))
        ref = np.asarray(jst.streamfunction_2d(jg, js.u))
        got = tst.streamfunction_2d(tg, ts.u).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=16 * EPS
                                   * np.abs(ref).max())
        np.testing.assert_array_equal(got[:, 0], 0.0)
        with pytest.raises(ValueError, match="3D only"):
            tst.q_criterion_3d(tg, ts.u)
        return
    for j, h in enumerate(tg.spacing):
        np.testing.assert_array_equal(
            torch.gradient(ts.p, spacing=h, dim=j, edge_order=1)[0].numpy(),
            np.asarray(jnp.gradient(js.p, h, axis=j)))
    np.testing.assert_array_equal(tst.q_criterion_3d(tg, ts.u).numpy(),
                                  np.asarray(jst.q_criterion_3d(jg, js.u)))
    ref = np.asarray(jst.vorticity_magnitude_3d(jg, js.u))
    np.testing.assert_allclose(tst.vorticity_magnitude_3d(tg, ts.u).numpy(),
                               ref, rtol=0, atol=4 * EPS * ref.max())
    with pytest.raises(ValueError, match="2D only"):
        tst.vorticity_2d(tg, ts.u)


def test_energy_spectrum_3d_matches_jax():
    tg, jg, ts, js = _fields((8, 8, 8), (1.0, 1.0, 1.0), seed=3)
    k_t, e_t = tspectra.energy_spectrum_3d(tg, ts.u)
    k_j, e_j = jspectra.energy_spectrum_3d(jg, js.u)
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-12)
    tg2, _, ts2, _ = _fields(*SHAPES["2d"])
    with pytest.raises(ValueError, match="3D only"):
        tspectra.energy_spectrum_3d(tg2, ts2.u)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_vtk_bytes_match_jax(tmp_path, pair, binary, monkeypatch):
    """The same arrays through both packages' VTK writers give the same
    bytes: the port's native codec against JAX's, and the port's ASCII
    writer against JAX's (its codec switched off, so it writes ASCII)."""
    tg, jg, ts, js = pair
    arrays = tio.snapshot_arrays(tg, ts)
    meta = dict(step=7, time=0.21875, shape=list(tg.shape),
                lengths=list(tg.lengths))
    if binary:
        tio.write_vtk(str(tmp_path / "t.vtk"), tg, arrays, meta)
    else:
        from navierstokessolver_tpu import native as jnative

        monkeypatch.setattr(jnative, "write_vtk_binary",
                            lambda *a, **k: False)
        tio.write_vtk_ascii(str(tmp_path / "t.vtk"), tg, arrays, meta)
    jio.write_vtk(str(tmp_path / "j.vtk"), jg, arrays, meta)
    got = (tmp_path / "t.vtk").read_bytes()
    ref = (tmp_path / "j.vtk").read_bytes()
    assert (b"BINARY" in ref) == binary
    assert got == ref


def _jax_params(case, **poisson):
    p = case.sim.params
    return dataclasses.replace(p, poisson=dataclasses.replace(p.poisson,
                                                              **poisson))


HASH_CASES = {
    "cavity": ("cavity", dict(shape=(16, 16)), {}, None),
    "cavity3d_les": ("cavity3d", dict(shape=(8, 8, 8), re=500.0), {},
                     0.17),
    "cylinder_ibm_dctcg": ("cylinder", dict(shape=(64, 32), ibm=True,
                                             poisson_method="dctcg"), {},
                           None),
    "channel_mg_extrapolate": ("channel", dict(shape=(32, 16),
                                                poisson_method="mg"),
                               dict(extrapolate=0.5), None),
    "cavity_rk2_cfl": ("cavity", dict(shape=(16, 16), integrator="rk2",
                                      cfl=0.5), {}, None),
    "taylor_green": ("taylor_green", dict(shape=(16, 16)), {}, None),
}


@pytest.mark.parametrize("key", list(HASH_CASES))
def test_config_hash_matches_jax(key):
    """JAX's hex string for the same configuration, so checkpoints resume
    across the packages; and a different one when the physics differs."""
    name, kw, poisson, les = HASH_CASES[key]
    jc, tc = jax_make_case(name, **kw), make_case(name, device="cpu", **kw)
    jp, tp = _jax_params(jc, **poisson), _jax_params(tc, **poisson)
    jl = None if les is None else JLES(cs=les)
    tl = None if les is None else LESConfig(cs=les)
    h = tio.config_hash(tc.sim.grid, tp, les=tl, ibm=tc.sim.ibm is not None)
    assert h == jio.config_hash(jc.sim.grid, jp, jc.sim.scalar, jl,
                                ibm=jc.sim.ibm is not None,
                                sharp_pressure=jc.sim.op.ap is not None)
    assert len(h) == 16
    other = dataclasses.replace(tp, nu=tp.nu * 2)
    assert tio.config_hash(tc.sim.grid, other, les=tl) != h


@pytest.fixture(scope="module")
def cavity_runs():
    """The 16^2 cavity in both packages: JAX's state after 10 steps and
    the port's, each from its own package's initial state."""
    jc = jax_make_case("cavity", shape=(16, 16))
    tc = make_case("cavity", shape=(16, 16), device="cpu")
    js, _ = jc.sim.run_scan(jc.initial_state(), 10)
    ts, _ = tc.sim.run_scan(tc.initial_state(), 10)
    h = tio.config_hash(tc.sim.grid, tc.sim.params)
    assert h == jio.config_hash(jc.sim.grid, jc.sim.params)
    return jc, tc, js, ts, h


def test_jax_checkpoint_resumes_in_port(tmp_path, cavity_runs):
    jc, tc, js, _, h = cavity_runs
    path = str(tmp_path / "ckpt.npz")
    jio.save_checkpoint(path, js, step=10, cfg_hash=h)
    st, step = tio.load_checkpoint(path, tc.sim.grid, h, device="cpu")
    assert step == 10 and st.p_prev is None and st.theta is None
    np.testing.assert_array_equal(st.u[0].numpy(), np.asarray(js.u[0]))
    ts2, _ = tc.sim.run_scan(st, 10)
    js2, _ = jc.sim.run_scan(js, 10)
    for a in range(2):
        np.testing.assert_allclose(ts2.u[a].numpy(), np.asarray(js2.u[a]),
                                   **U_TOL)
    np.testing.assert_allclose(ts2.p.numpy(), np.asarray(js2.p), **P_TOL)


def test_port_checkpoint_resumes_in_jax(tmp_path, cavity_runs):
    jc, tc, _, ts, h = cavity_runs
    path = str(tmp_path / "ckpt.npz")
    tio.save_checkpoint(path, ts, step=10, cfg_hash=h)
    with np.load(path) as z:
        assert z["step"].dtype == np.int64 and int(z["step"]) == 10
        assert bytes(z["cfg"]) == h.encode()
        assert sorted(z.files) == ["cfg", "p", "step", "u0", "u1"]
    js, step = jio.load_checkpoint(path, jc.sim.grid, h)
    assert step == 10
    js2, _ = jc.sim.run_scan(js, 10)
    ts2, _ = tc.sim.run_scan(ts, 10)
    for a in range(2):
        np.testing.assert_allclose(ts2.u[a].numpy(), np.asarray(js2.u[a]),
                                   **U_TOL)
    np.testing.assert_allclose(ts2.p.numpy(), np.asarray(js2.p), **P_TOL)


def test_checkpoint_round_trip_carries_every_field(tmp_path):
    """p_prev, theta and t ride along when set, and come back bit-equal on
    the named device; the resumed run equals the unbroken one."""
    tc = make_case("cavity", shape=(16, 16), poisson_method="mg",
                   poisson_extrapolate=0.5, device="cpu")
    st, _ = tc.sim.run_scan(tc.initial_state(), 5)
    assert st.p_prev is not None
    st = dataclasses.replace(st, theta=st.p * 2, t=torch.tensor(0.5))
    path = str(tmp_path / "c.npz")
    h = tio.config_hash(tc.sim.grid, tc.sim.params)
    tio.save_checkpoint(path, st, 5, h)
    back, step = tio.load_checkpoint(path, tc.sim.grid, h, device="cpu")
    assert step == 5
    for a, b in [(back.p, st.p), (back.p_prev, st.p_prev),
                 (back.theta, st.theta), (back.t, st.t), *zip(back.u, st.u)]:
        assert torch.equal(a, b)
    run = dataclasses.replace(st, theta=None, t=None)
    a, _ = tc.sim.run_scan(run, 5)
    b, _ = tc.sim.run_scan(dataclasses.replace(back, theta=None, t=None), 5)
    assert torch.equal(a.p, b.p) and torch.equal(a.u[0], b.u[0])


def test_checkpoint_refusals(tmp_path, cavity_runs):
    """A checkpoint of another configuration, and one without theta where
    the simulation expects a scalar, are refused as in JAX."""
    _, tc, _, ts, h = cavity_runs
    path = str(tmp_path / "c.npz")
    tio.save_checkpoint(path, ts, step=5, cfg_hash="deadbeefdeadbeef")
    with pytest.raises(ValueError, match="config hash"):
        tio.load_checkpoint(path, tc.sim.grid, h, device="cpu")
    tio.save_checkpoint(path, ts, step=5, cfg_hash=h)
    with pytest.raises(ValueError, match="no theta field"):
        tio.load_checkpoint(path, tc.sim.grid, h, expect_scalar=True,
                            device="cpu")
    with pytest.raises(ValueError, match="no theta field"):
        jio.load_checkpoint(path, JGrid((16, 16), (1.0, 1.0)), h,
                            expect_scalar=True)
    assert tio.load_checkpoint_stats(path, device="cpu") is None
    assert tio.load_checkpoint_tracers(path, device="cpu") is None


def test_async_writer_files(tmp_path, pair):
    """Queued snapshots land as ``snap_<step>.npz`` (and ``.vtk``) with the
    contents of a direct write of the same state, even when the state is
    written in place after ``enqueue``; more enqueues than ``max_pending``
    wait for the writer."""
    tg, _, ts, _ = pair
    state = State(u=tuple(c.clone() for c in ts.u), p=ts.p.clone())
    w = tio.AsyncSnapshotWriter(str(tmp_path), tg, "cpu", vtk=True,
                                max_pending=2)
    for k in range(5):
        w.enqueue(state, step=k, time=k * 0.01)
        state.p.add_(1.0)
    w.close()
    w.close()
    files = sorted(os.listdir(tmp_path))
    assert files == sorted([f"snap_{k:08d}.{e}" for k in range(5)
                            for e in ("npz", "vtk")])
    ref = tio.snapshot_arrays(tg, ts)
    p3 = ts.p.clone()
    for _ in range(3):
        p3.add_(1.0)
    with np.load(tmp_path / "snap_00000003.npz") as z:
        assert json.loads(str(z["__meta__"]))["step"] == 3
        np.testing.assert_array_equal(z["p"], p3.numpy())
        np.testing.assert_array_equal(z["ux_face"], ref["ux_face"])
    with pytest.raises(RuntimeError, match="closed"):
        w.enqueue(ts, 9, 0.0)


def test_async_writer_error_surfaces(tmp_path, pair):
    """A write that fails in the writer thread raises at ``close`` (and at
    the next ``enqueue``), as the JAX writer's do."""
    tg, _, ts, _ = pair
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    w = tio.AsyncSnapshotWriter(str(blocker), tg, "cpu")
    w.enqueue(ts, step=1, time=0.0)
    w._thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="snapshot writer failed"):
        w.enqueue(ts, step=2, time=0.0)
    with pytest.raises(RuntimeError, match="snapshot writer failed"):
        w.close()


def test_native_codec_builds_into_the_package():
    """The codec library is built from the package's own source into its
    ``_build`` directory, named by a hash of the source and flags."""
    from navierstokessolver_tpu_torch import native

    native.get_lib()
    so = native._so_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.SRC.parent.parent.name == "navierstokessolver_tpu_torch"
