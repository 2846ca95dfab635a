"""PyTorch port vs JAX package: the 2D cylinder step (BASELINE config #3's
topology at 128x64: inflow / outflow / slip faces, a staircase obstacle,
the sharp-interface immersed boundary and the ``dctcg`` solve).

The builders (face and correction masks, the Poisson operator, the IBM
masks and weights, the capacitance links) are bit-equal to the JAX
package's; five steps from ``impulsive_start_state`` through both
packages' ``make_case("cylinder", ...)`` agree with the JAX jnp step, with
equal Richardson sweep counts every step. Tolerances: u rtol 2e-5 / atol
1e-6 (tests/test_fused_step.py's); p and p_prev rtol 2e-4 / atol 1e-5,
since the solve stops at a relative residual of 1e-5 after sweeps whose
spectral transforms round differently in each package (2.5e-6 apart at
max|p| 1.2 measured); residuals within 20% of each other; max_div bounded
in both (float32 roundoff); max_cfl rtol 1e-3. Each JAX reference runs as
one ``jax.jit`` program (``run_scan``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import (
    cylinder_mask, impulsive_start_state,
)
from navierstokessolver_tpu_torch.ibm import _crop
from navierstokessolver_tpu_torch.solver import Simulation

SHAPE = (128, 64)


def _cases(**kw):
    return (jax_make_case("cylinder", shape=SHAPE, **kw),
            make_case("cylinder", shape=SHAPE, device="cpu", **kw))


def _full(ibm, x, a, shape):
    """A port IBM array (cropped to its box) embedded in zeros."""
    out = torch.zeros(shape)
    _crop(out, ibm.box[a]).copy_(x)
    return out.numpy()


@pytest.mark.parametrize("kw", [dict(ibm=True), dict(ibm=True, spin=0.5)],
                         ids=["ibm", "spin"])
def test_cylinder_builders_match_jax(kw):
    jc, tc = _cases(**kw)
    js, ts = jc.sim, tc.sim
    assert ts.params.dt == js.params.dt and ts.params.nu == js.params.nu
    assert not ts.fused and ts.ghosts is not None
    np.testing.assert_array_equal(ts.op.code.numpy(), np.asarray(js.op.code))
    np.testing.assert_array_equal(ts.op.diag.numpy(), np.asarray(js.op.diag))
    assert ts.op.singular is js.op.singular is False
    for a in range(2):
        np.testing.assert_array_equal(ts.face_masks[a].numpy(),
                                      np.asarray(js.face_masks[a]))
        np.testing.assert_array_equal(ts.corr_masks[a].numpy(),
                                      np.asarray(js.corr_masks[a]))
    ji, ti = js.ibm, ts.ibm
    assert ti.dirs == ji.dirs
    for a in range(2):
        shape = np.asarray(ji.w[a]).shape
        for d in range(4):
            np.testing.assert_array_equal(
                _full(ti, ti.masks[a][d], a, shape), np.asarray(ji.masks[a][d]))
        for name in ("w", "band") + (("ub", "wet", "ub_wet") if "spin" in kw
                                     else ()):
            np.testing.assert_array_equal(
                _full(ti, getattr(ti, name)[a], a, shape),
                np.asarray(getattr(ji, name)[a]), err_msg=name)
    if "spin" not in kw:
        assert ti.ub is ji.ub is None
    # the apply (and apply_wet) on one random field: the JAX operator's,
    # and the port's built from the JAX arrays (convert.ibm_from_numpy)
    rng = np.random.default_rng(9)
    u = [rng.standard_normal(ts.grid.face_shape(a)).astype(np.float32)
         for a in range(2)]
    jf = jax.jit(lambda uu, vv: (ji.apply((uu, vv)), ji.apply_wet((uu, vv))))
    jout, jwet = jf(*(jnp.asarray(c) for c in u))
    names = ("ub", "wet", "ub_wet") if "spin" in kw else ()
    ci = convert.ibm_from_numpy(
        ts.grid, ji.dirs, ji.masks, ji.w, ji.band,
        **{n: getattr(ji, n) for n in names})
    # (bit for bit for a stationary body; with a surface velocity XLA
    # contracts w acc + (1 - w) ub into a fused multiply-add: one ulp)
    atol = 1e-6 if names else 0.0
    tu = tuple(torch.from_numpy(c) for c in u)
    for op in (ti, ci):
        for a in range(2):
            np.testing.assert_allclose(op.apply(tu)[a].numpy(),
                                       np.asarray(jout[a]), rtol=0.0,
                                       atol=atol)
            np.testing.assert_array_equal(op.apply_wet(tu)[a].numpy(),
                                          np.asarray(jwet[a]))
    jd, td = js.dctcg_solver, ts.dctcg_solver
    assert td.dct.kinds == jd.dct.kinds == ("nd", "nn")
    np.testing.assert_array_equal(td.cap_idx_a, jd.cap_idx_a)
    np.testing.assert_array_equal(td.cap_idx_b, jd.cap_idx_b)
    np.testing.assert_array_equal(td.cap_va.numpy(), np.asarray(jd.cap_va))
    np.testing.assert_array_equal(td.cap_vb.numpy(), np.asarray(jd.cap_vb))
    # C^-1 from float32 spectral solves in each package, inverted in
    # float64: close to float32 roundoff of C's entries
    np.testing.assert_allclose(td.cap_cinv.numpy(), np.asarray(jd.cap_cinv),
                               rtol=0.0, atol=1e-5)
    for name in ("cap_vx", "cap_vy", "cap_fx", "cap_fy"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   rtol=0.0, atol=1e-5, err_msg=name)
    # the float32 mask of the cylinder: the JAX grid's coordinates, bit for
    # bit, and the one the simulation carries
    for a in range(2):
        np.testing.assert_array_equal(ts.grid.cell_centers(a),
                                      np.asarray(js.grid.cell_centers(a)))
        np.testing.assert_array_equal(ts.grid.face_coords(a),
                                      np.asarray(js.grid.face_coords(a)))
    jm = np.asarray(js.op.code) >> 6 & 1
    np.testing.assert_array_equal(
        cylinder_mask(ts.grid, (4.0, 4.003), 0.5), jm == 0)


@pytest.mark.parametrize("kw", [dict(ibm=True), dict(ibm=False),
                                dict(ibm=True, spin=0.5)],
                         ids=["ibm", "staircase", "spin"])
def test_cylinder_five_steps_match_jax(kw):
    """``ibm=False`` (the staircase) runs the JAX jnp step too: the JAX
    package's fused 2D kernels with obstacle codes, which would take it on
    the TPU, are not ported."""
    jc, tc = _cases(**kw)
    js0 = jax_impulsive_start(jc.sim)
    ts0 = impulsive_start_state(tc.sim)
    for a in range(2):
        np.testing.assert_array_equal(ts0.u[a].numpy(), np.asarray(js0.u[a]))
    js, jd = jc.sim.run_scan(js0, 5)
    ts, td = tc.sim.run_scan(ts0, 5)
    u, p = convert.state_to_numpy(ts)
    for a in range(2):
        np.testing.assert_allclose(u[a], np.asarray(js.u[a]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(js.p), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(ts.p_prev.numpy(), np.asarray(js.p_prev),
                               rtol=2e-4, atol=1e-5)
    assert td.poisson_iters.tolist() == np.asarray(jd.poisson_iters).tolist()
    assert (td.poisson_res <= 1e-5).all()
    np.testing.assert_allclose(td.poisson_res.numpy(),
                               np.asarray(jd.poisson_res), rtol=0.2)
    assert float(td.max_div.max()) < 5e-5 and float(jd.max_div.max()) < 5e-5
    np.testing.assert_allclose(td.max_cfl.numpy(), np.asarray(jd.max_cfl),
                               rtol=1e-3, atol=1e-8)
    # a state carried across from the JAX run steps on as the JAX one does
    tstate = convert.state_from_numpy(
        [np.asarray(c) for c in js.u], np.asarray(js.p),
        p_prev=np.asarray(js.p_prev))
    js6, jd6 = jc.sim.run_scan(js, 1)
    ts6, td6 = tc.sim.step(tstate)
    assert int(td6.poisson_iters) == int(np.asarray(jd6.poisson_iters)[0])
    np.testing.assert_allclose(ts6.p.numpy(), np.asarray(js6.p),
                               rtol=2e-4, atol=1e-5)


def test_bcs_match_jax():
    """apply_velocity_bcs (with the obstacle's face masks) and
    pad_transverse of every component for the cylinder's table and one
    with WALL faces, bit for bit."""
    jc, tc = _cases(ibm=False)
    jg, tg = jc.sim.grid, tc.sim.grid
    rng = np.random.default_rng(5)
    u = [rng.standard_normal(tg.face_shape(a)).astype(np.float32)
         for a in range(2)]
    tables = [(jc.sim.bcs, tc.sim.bcs)]
    jw = {(a, s): jbcs.BCSpec.wall((0.2, -0.4)) for a in range(2)
          for s in (0, 1)}
    jw[(0, 1)] = jbcs.BCSpec.outflow()
    tw = {(a, s): tbcs.BCSpec.wall((0.2, -0.4)) for a in range(2)
          for s in (0, 1)}
    tw[(0, 1)] = tbcs.BCSpec.outflow()
    tables.append((jw, tw))
    for jb, tb in tables:
        @jax.jit
        def ref(uu, vv):
            ub = jbcs.apply_velocity_bcs(jg, jb, (uu, vv), jc.sim.face_masks)
            return ub, [jbcs.pad_transverse(jg, jb, a, (uu, vv)[a])
                        for a in range(2)]

        jub, jpad = ref(*(jnp.asarray(c) for c in u))
        tu = tuple(torch.from_numpy(c) for c in u)
        tub = tbcs.apply_velocity_bcs(tg, tb, tu, tc.sim.face_masks)
        for a in range(2):
            np.testing.assert_array_equal(tub[a].numpy(), np.asarray(jub[a]))
            np.testing.assert_array_equal(
                tbcs.pad_transverse(tg, tb, a, tu[a]).numpy(),
                np.asarray(jpad[a]))


def test_cylinder_entry_points_raise():
    """Without a CUDA device the default device raises; what is not ported
    raises naming its ROADMAP item."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_case("cylinder", shape=(32, 16))
    kw = dict(shape=(32, 16), device="cpu")
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        make_case("cylinder", heated=True, **kw)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        make_case("cylinder", ibm=True, sharp_pressure=True, **kw)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        make_case("cylinder", outlet="convective", **kw)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        make_case("sphere", shape=(32, 16, 16), device="cpu")
    with pytest.raises(ValueError, match="requires ibm"):
        make_case("cylinder", spin=0.5, **kw)
    with pytest.raises(ValueError, match="needs an obstacle-free"):
        make_case("cylinder", poisson_method="fft", **kw)
    sim = make_case("cylinder", **kw).sim
    per = dict(sim.bcs)
    per[(1, 0)] = per[(1, 1)] = tbcs.BCSpec(tbcs.BCKind.PERIODIC)
    sim_per = Simulation.build(sim.grid, per, sim.params, "cpu")
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        sim_per.step(sim_per.initial_state())
