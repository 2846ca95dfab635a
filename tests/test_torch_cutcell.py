"""PyTorch port vs JAX package: the cut-cell pressure and the 3D sharp
interface on the CPU.

The geometry (``cutcell.face_apertures``, ``volume_fractions``,
``cut_geometry``), the cut operator (``build_poisson_op_cut``: diag, code,
apertures), every multigrid level's cut operator and the 3D IBM's build
(masks, weights, ``ub``, ``wet``, ``ub_wet``, ``fused_ok``) are bit-equal
to the JAX package's. The steps run the port's routes with the kernels'
plain versions (the sphere: the fused 3D route's composition, kernels 1-2
masked, the corrector in its coded mode for a moving body or a cut band;
the cylinder: the unfused 2D route) against JAX's ``run_scan`` on the CPU
(its jnp step), from the same impulsive start: u within 1e-5 of max|u|, p
within 1e-4 of max|p|, max_div rtol 1e-3 / atol 1e-6, max_cfl rtol 1e-3,
the dt series, and the iteration counts equal (dctcg within
``COUNT_SLACK``: its Richardson stopping test at float32's floor, as in
tests/test_torch_sphere.py). The sphere is JAX's own fused-IBM test's
(32x16x16 over 8x4x4, 4 cells a diameter, its band strictly inside the
domain); the cylinder 128x64 over 8x4 diameters.
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu import cutcell as jcut
from navierstokessolver_tpu import io as jio
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.grid import GridSpec as JGrid
from navierstokessolver_tpu.ops import poisson as jpoisson
from navierstokessolver_tpu.ops import stencils as jstencils
from navierstokessolver_tpu_torch import cli as tcli
from navierstokessolver_tpu_torch import cutcell
from navierstokessolver_tpu_torch import io as tio
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.grid import GridSpec
from navierstokessolver_tpu_torch.ops import fused3d, multigrid_kernels
from navierstokessolver_tpu_torch.ops import poisson as tpoisson
from navierstokessolver_tpu_torch.ops import stencils as tstencils

SPHERE = dict(shape=(32, 16, 16), lengths=(8.0, 4.0, 4.0),
              center=(2.0, 2.03, 1.97), re=100.0)
CYLINDER = dict(shape=(128, 64), lengths=(8.0, 4.0))
# the sphere's paths of the slice: the IBM sphere (dctcg, the case's
# method), the spinning sphere and the cut-cell sphere (mgcg)
PATHS = {"ibm": dict(ibm=True), "spin": dict(ibm=True, spin=0.5),
         "sharp": dict(ibm=True, sharp_pressure=True,
                       poisson_method="mgcg")}
COUNT_SLACK = {"dctcg": 1}


def _sdf(center, radius):
    return lambda *cs: np.sqrt(
        sum((c - c0) ** 2 for c, c0 in zip(cs, center))) - radius


def _check_run(jr, tr, slack=0):
    """Final fields and per-step diagnostics of two run_scan results."""
    (js, jd), (ts, td) = jr, tr
    for a in range(len(js.u)):
        ref = np.asarray(js.u[a])
        np.testing.assert_allclose(ts.u[a].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(js.p)
    np.testing.assert_allclose(ts.p.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(td.max_div.numpy(), np.asarray(jd.max_div),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=3e-5)
    diff = np.abs(td.poisson_iters.numpy().astype(int)
                  - np.asarray(jd.poisson_iters).astype(int))
    assert diff.max() <= slack, (td.poisson_iters, jd.poisson_iters)


def _runs(name, base, kw, steps):
    """Euler ``steps[0]`` and rk2 ``steps[1]`` steps of both packages'
    case from the impulsive start."""
    for integrator, n in zip(("euler", "rk2"), steps):
        opts = dict(base, integrator=integrator, **kw)
        jc = jax_make_case(name, **opts)
        tc = make_case(name, device="cpu", **opts)
        yield jc, tc, (jc.sim.run_scan(jax_impulsive_start(jc.sim), n),
                       tc.sim.run_scan(impulsive_start_state(tc.sim), n))


def test_cut_geometry_matches_jax():
    """Apertures, volume fractions and the cut classification bit for bit
    in 2D (a circle, a tilted line) and 3D (the sphere, a tilted plane), at
    the subcell counts the builders use."""
    cases = [
        (CYLINDER["shape"], CYLINDER["lengths"], _sdf((2.0, 2.003), 0.5)),
        ((24, 24), (1.0, 1.0), lambda x, y: 0.3 * x + 0.8 * y - 0.41),
        (SPHERE["shape"], SPHERE["lengths"], _sdf(SPHERE["center"], 0.5)),
        ((8, 10, 12), (1.0, 1.2, 1.5),
         lambda x, y, z: 0.2 * x - 0.5 * y + 0.84 * z - 0.6),
    ]
    for shape, lengths, sdf in cases:
        jg, tg = JGrid(shape, lengths), GridSpec(shape, lengths)
        for k in (4, 8):
            for j, t in zip(jcut.face_apertures(jg, sdf, k),
                            cutcell.face_apertures(tg, sdf, k)):
                np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(cutcell.volume_fractions(tg, sdf, 4),
                                      jcut.volume_fractions(jg, sdf, 4))
        jap, jfl, jso = jcut.cut_geometry(jg, sdf)
        tap, tfl, tso = cutcell.cut_geometry(tg, sdf)
        np.testing.assert_array_equal(tfl, jfl)
        np.testing.assert_array_equal(tso, jso)
        for j, t in zip(jap, tap):
            np.testing.assert_array_equal(t, j)
        assert any(((a > 0) & (a < 1)).any() for a in tap), shape


def test_cut_operator_and_solves_match_jax():
    """The cut operator (diag, code, apertures) bit for bit and its matvec,
    the apertured divergence and each iterative solve (jacobi, gs, sor, cg:
    the apertured matvec in every loop) on a seeded RHS; every multigrid
    level's cut operator (rediscretized from the sdf) of the cylinder and
    the sphere, and a V-cycle solve's p and count."""
    rng = np.random.default_rng(5)
    for base, name in ((CYLINDER, "cylinder"), (SPHERE, "sphere")):
        kw = dict(base, ibm=True, sharp_pressure=True, poisson_method="mg")
        if name == "sphere":
            kw.pop("re")
        jsim = jax_make_case(name, **kw).sim
        tsim = make_case(name, device="cpu", **kw).sim
        jo, to = jsim.op, tsim.op
        np.testing.assert_array_equal(to.code.numpy(), np.asarray(jo.code))
        np.testing.assert_array_equal(to.diag.numpy(), np.asarray(jo.diag))
        assert to.singular is jo.singular
        for a in range(len(to.ap)):
            np.testing.assert_array_equal(to.ap[a].numpy(),
                                          np.asarray(jo.ap[a]))
            np.testing.assert_array_equal(tsim.face_masks[a].numpy(),
                                          np.asarray(jsim.face_masks[a]))
            np.testing.assert_array_equal(tsim.corr_masks[a].numpy(),
                                          np.asarray(jsim.corr_masks[a]))
        g = tsim.grid
        p = rng.normal(size=g.shape).astype(np.float32) * np.asarray(jo.fluid)
        ref = np.asarray(jpoisson.apply_A(jo, p))
        np.testing.assert_allclose(
            tpoisson.apply_A(to, torch.from_numpy(p)).numpy(), ref, rtol=0,
            atol=1e-6 * np.abs(ref).max())
        u = [rng.normal(size=g.face_shape(a)).astype(np.float32)
             for a in range(g.ndim)]
        ref = np.asarray(jstencils.divergence_ap(jsim.grid, u, jo.ap))
        np.testing.assert_allclose(
            tstencils.divergence_ap(g, [torch.from_numpy(c) for c in u],
                                    to.ap).numpy(), ref, rtol=0,
            atol=1e-6 * np.abs(ref).max())
        for jl, tl in zip(jsim.mg_solver.ops, tsim.mg_solver.ops):
            np.testing.assert_array_equal(tl.code.numpy(), np.asarray(jl.code))
            np.testing.assert_array_equal(tl.diag.numpy(), np.asarray(jl.diag))
            for a in range(g.ndim):
                np.testing.assert_array_equal(tl.ap[a].numpy(),
                                              np.asarray(jl.ap[a]))
        assert len(tsim.mg_solver.ops) == len(jsim.mg_solver.ops) > 2
        b = rng.normal(size=g.shape).astype(np.float32) * np.asarray(jo.fluid)
        jp, jit, _ = jsim.mg_solver.solve(b, np.zeros_like(b), 1e-5, 30)
        tp, tit, _ = tsim.mg_solver.solve(torch.from_numpy(b),
                                          torch.zeros(g.shape), 1e-5, 30)
        assert int(tit) == int(jit)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(jp)).max())
        if name != "cylinder":
            continue
        for method in ("jacobi", "gs", "sor", "cg"):
            cfg = dict(method=method, tol=1e-4, max_iters=400)
            jp, jit, jres = jpoisson.solve_poisson(
                jo, b, np.zeros_like(b), jsim.grid,
                jpoisson.PoissonConfig(**cfg))
            tp, tit, tres = tpoisson.solve_poisson(
                to, torch.from_numpy(b), torch.zeros(g.shape), g,
                tpoisson.PoissonConfig(**cfg))
            assert int(tit) == int(jit), method
            np.testing.assert_allclose(
                tp.numpy(), np.asarray(jp), rtol=0,
                atol=1e-4 * np.abs(np.asarray(jp)).max(), err_msg=method)


def test_kernel_gates_refuse_apertures():
    """No apertured operator reaches kernels 3, 9, 10 or 11: their gates
    refuse it (the plain versions and the plain V-cycle take it, as JAX's
    jnp levels do), and the cut multigrid's levels run plain even with
    the kernels' routes switched on."""
    tsim = make_case("cylinder", device="cpu", ibm=True, sharp_pressure=True,
                     poisson_method="mg", shape=(256, 128),
                     lengths=(8.0, 4.0)).sim
    op = tsim.op
    assert op.ap is not None and min(op.diag.shape) >= 128
    assert not multigrid_kernels.mg_fused_applicable(op)
    staircase = dataclasses.replace(op, ap=None)
    assert multigrid_kernels.mg_fused_applicable(staircase)
    x = torch.zeros(op.diag.shape)
    for fn in (lambda: multigrid_kernels.rb_sweeps(op, x, x, 1.0, 2),
               lambda: multigrid_kernels.mg_pre_sweeps_residual(op, x, x, 2,
                                                                1.0),
               lambda: multigrid_kernels.mg_add_post_sweeps(op, x, x, x, 2,
                                                            1.0)):
        with pytest.raises(ValueError, match="apertured"):
            fn()
    mg = dataclasses.replace(tsim.mg_solver, fused=True, use_pallas=True)
    assert not any(mg._fused_ok(level) for level in range(len(mg.ops)))
    b = torch.randn(op.diag.shape, generator=torch.Generator().manual_seed(1))
    b = b * op.fluid
    v = mg._v_cycle(0, torch.zeros_like(b), b)
    ref = tsim.mg_solver._v_cycle(0, torch.zeros_like(b), b)
    assert torch.equal(v, ref)
    sph = make_case("sphere", device="cpu", ibm=True, sharp_pressure=True,
                    poisson_method="mg", **SPHERE).sim
    p = torch.zeros(sph.grid.shape)
    with pytest.raises(ValueError, match="apertured"):
        fused3d.residual_3d(sph.op, p, p)


def test_sphere_ibm_build_matches_jax():
    """The 3D IBM's masks, weights, band, ub, wet, ub_wet and fused_ok bit
    for bit (stationary and spinning); the corrector codes: the stencil
    code's masks equal the cut masks (the masked kernels derive theirs from
    it), the wet faces and the cut band survive the 16-bit code, and the
    fused composition's box, boxed apertures and band equal JAX's
    ``fused_cut_consts``."""
    for path, kw in PATHS.items():
        jsim = jax_make_case("sphere", **SPHERE, **kw).sim
        tsim = make_case("sphere", device="cpu", **SPHERE, **kw).sim
        ji, ti = jsim.ibm, tsim.ibm
        assert tsim.fused and ti.fused_ok and ji.fused_ok
        assert ti.dirs == ji.dirs
        g = tsim.grid
        names = ["w", "band"] + (["ub", "wet", "ub_wet"]
                                 if ji.wet is not None else [])
        assert (ti.wet is None) == (ji.wet is None)
        for name in names:
            for a, arr in enumerate(ti.full(g, name)):
                np.testing.assert_array_equal(arr, np.asarray(
                    getattr(ji, name)[a]), err_msg=f"{path} {name}")
        for a in range(3):
            for d in range(6):
                np.testing.assert_array_equal(
                    _full_dir(ti, g, a, d), np.asarray(ji.masks[a][d]))
        opened, corr, fluid = fused3d.masks_from_code(g, tsim.op.code)
        for a in range(3):
            assert torch.equal(opened[a], tsim.face_masks[a])
            assert torch.equal(corr[a], tsim.corr_masks[a])
        np.testing.assert_array_equal(fluid.numpy(),
                                      np.asarray(jsim.op.fluid))
        if tsim.corr_code is None:
            assert path == "ibm" and tsim.cut_box is None
            continue
        code = tsim.corr_code
        assert code.dtype == torch.int16
        assert torch.equal((code & 0x7f).to(torch.uint8), tsim.op.code)
        wet = fused3d.wet_from_code(g, code)
        for a in range(3):
            ref = (np.zeros(g.face_shape(a), bool) if ji.wet is None
                   else np.asarray(ji.wet[a]) > 0)
            np.testing.assert_array_equal(wet[a].numpy(), ref)
        if path == "sharp":
            box, alb, band = jcut.fused_cut_consts(
                jsim.grid, jsim.op.ap, ji.wet)
            assert tsim.cut_box == box
            for t, j in zip(tsim.cut_ap, alb):
                np.testing.assert_array_equal(t.numpy(), j.astype(np.float32))
            np.testing.assert_array_equal(
                (((code >> fused3d.DIV_SKIP) & 1) > 0).numpy(), band)


def _full_dir(ti, g, a, d):
    out = np.zeros(g.face_shape(a), np.float32)
    sl = tuple(slice(l, l + s) for l, s in zip(*ti.box[a]))
    out[sl] = ti.masks[a][d].numpy()
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sphere_paths_match_jax(path):
    """5 Euler and 3 rk2 steps of the sphere's path (the fused 3D route:
    the IBM forcing between the kernels, the RHS patches, the corrector's
    coded mode for the moving body and the cut band, the cut band's
    apertured max|div u|) against JAX's run_scan."""
    kw = PATHS[path]
    method = kw.get("poisson_method", "dctcg")
    for jc, tc, (jr, tr) in _runs("sphere", SPHERE, kw, (5, 3)):
        assert tc.sim.fused and jc.sim.ibm.fused_ok
        _check_run(jr, tr, COUNT_SLACK.get(method, 0))
        if kw.get("spin"):
            # the wet faces carry the body velocity after every step
            st = tr[0]
            for a, (w, ubw) in enumerate(zip(tc.sim.ibm.full(
                    tc.sim.grid, "wet"), tc.sim.ibm.full(tc.sim.grid,
                                                          "ub_wet"))):
                got = st.u[a].numpy()[w > 0]
                np.testing.assert_array_equal(got, ubw[w > 0])


def test_cut_cylinder_matches_jax():
    """10 Euler and 3 rk2 steps of the cut-cell cylinder (mg, the unfused
    2D route: kernel 8, the IBM forcing, divergence_ap, the cut V-cycle on
    every level's apertured operator) against JAX's run_scan."""
    kw = dict(ibm=True, sharp_pressure=True, poisson_method="mg")
    for jc, tc, (jr, tr) in _runs("cylinder", CYLINDER, kw, (10, 3)):
        assert not tc.sim.fused and tc.sim.op.ap is not None
        _check_run(jr, tr)


def test_cli_sharp_paths_resume(tmp_path):
    """``--case sphere --ibm --sharp-pressure --poisson mgcg`` and the cut
    cylinder through the port's CLI: the checkpoint's config hash is JAX's
    for the same flags, and a run resumed from the first window's
    checkpoint ends bit for bit where the unbroken run does."""
    for case, shape, extra in (
            ("sphere", "32,16,16", ["--ibm", "--sharp-pressure", "--poisson",
                                    "mgcg"]),
            ("cylinder", "64,32", ["--ibm", "--sharp-pressure", "--poisson",
                                   "mg"])):
        flags = ["--platform", "cpu", "--case", case, "--shape", shape,
                 *extra, "--chunk", "2", "--checkpoint-every", "2"]
        full, part = tmp_path / f"{case}_full", tmp_path / f"{case}_part"
        assert tcli.main([*flags, "--steps", "4", "--out", str(full)]) == 0
        assert tcli.main([*flags, "--steps", "2", "--out", str(part)]) == 0
        ckpt = str(part / "ckpt.npz")
        assert tcli.main([*flags, "--steps", "2", "--out", str(part),
                          "--resume", ckpt]) == 0
        a = np.load(full / "ckpt.npz")
        b = np.load(part / "ckpt.npz")
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case} {k}")
        sim = make_case(case, device="cpu", shape=tuple(
            int(n) for n in shape.split(",")), ibm=True, sharp_pressure=True,
            poisson_method=extra[-1]).sim
        jsim = jax_make_case(case, shape=tuple(
            int(n) for n in shape.split(",")), ibm=True, sharp_pressure=True,
            poisson_method=extra[-1]).sim
        assert tio.config_hash(sim.grid, sim.params, ibm=True,
                               sharp_pressure=True) == jio.config_hash(
            jsim.grid, jsim.params, ibm=True, sharp_pressure=True)
        assert a["cfg"].item().decode() == tio.config_hash(
            sim.grid, sim.params, ibm=True, sharp_pressure=True)


def test_cli_cut_cylinder_windows_match_jax(tmp_path):
    """The cut cylinder through both CLIs from rest at 256x128, whose
    first V-cycles stop on the stagnation rule far above tol (the inflow
    meets a fluid at rest): the port's window lines against JAX's for the
    same flags, the same steps and solve counts, and the residual, max|div
    u| and max CFL within rtol 1e-3."""
    from navierstokessolver_tpu.cli import main as jax_main

    flags = ["--case", "cylinder", "--shape", "256,128", "--ibm",
             "--sharp-pressure", "--poisson", "mg", "--steps", "4",
             "--chunk", "2"]
    assert jax_main([*flags, "--out", str(tmp_path / "jax"), "--csv",
                     str(tmp_path / "jax.csv")]) == 0
    assert tcli.main(["--platform", "cpu", *flags, "--out",
                      str(tmp_path / "port"), "--csv",
                      str(tmp_path / "port.csv")]) == 0
    with open(tmp_path / "jax.csv") as fj, open(tmp_path / "port.csv") as ft:
        jr, tr = list(csv.DictReader(fj)), list(csv.DictReader(ft))
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == ["2", "4"]
    for t, j in zip(tr, jr):
        for k in ("poisson_iters_mean", "poisson_iters_max"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("residual", "max_div", "max_cfl"):
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-3,
                                       err_msg=f"step {t['step']} {k}")
    assert float(jr[0]["residual"]) > 1e-2
