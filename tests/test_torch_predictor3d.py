"""PyTorch port vs JAX package: the LES step's kernel wrappers on the CPU.

On CPU tensors ``predictor3d.nu_t_3d`` and ``predictor3d.predictor_3d`` run
their plain versions; these tests hold them to the JAX package with the
tolerances of its own LES kernel tests (tests/test_pallas.py): nu_t within
2e-6 of max(nu_t), u* atol 5e-5 on interior faces (O(1) random fields).
The cheap cases hold them to the JAX jnp route; the ``heavy`` ones run the
JAX Pallas kernels in interpret mode (three calls). Each JAX reference runs
as one jitted program, so the file adds few XLA compiles to the worker
process it shares with other files. The CUDA kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py, ``cuda``
marker, and chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import les as jles
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import les as tles
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.ops import predictor3d

DT, NU = 1e-3, 0.05
CFG = jles.LESConfig(cs=0.2)


def _jax(fn, *arrays):
    """``fn(*arrays)`` compiled as one program."""
    return jax.jit(fn)(*arrays)


def _setup(shape=(16, 16, 8), lengths=(1.0, 1.0, 0.5), seed=1):
    """The JAX LES tests' first table (a wall moving on axis 0's high face)
    and a BC-consistent random velocity, in both packages."""
    jg = jgrid.GridSpec(shape, lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[(0, 1)] = jbcs.BCSpec.wall((0.7, 0.2, 0.0))
    tb[(0, 1)] = tbcs.BCSpec.wall((0.7, 0.2, 0.0))
    rng = np.random.default_rng(seed)
    u = tuple(rng.normal(size=jg.face_shape(a)).astype(np.float32)
              for a in range(3))
    ju = _jax(lambda v: jbcs.apply_velocity_bcs(jg, jb, v), u)
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    return jg, tg, jb, tb, ju, tu


def _interior(x, a):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    idx = [slice(None)] * 3
    idx[a] = slice(1, -1)
    return x[tuple(idx)]


def _close_nu_t(got, ref):
    scale = float(jnp.max(ref))
    assert scale > 0.0
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 2e-6 * scale


# the JAX LES tests' grid, and one whose extents are multiples of none of
# the CUDA kernels' tile extents (8 rows of axis 1, 32 cells of axis 2,
# runs of 8-32 planes of axis 0), the grid the card holds kernels 6-7 to
# these plain versions on
GRIDS = {"les_tests": ((16, 16, 8), (1.0, 1.0, 0.5)),
         "ragged_wall": ((37, 19, 45), (1.0, 0.6, 1.8))}
CASES = [(grid, gamma, les) for grid in GRIDS for gamma in (0.0, 0.3)
         for les in (False, True)]


# the first grid's cases keep the ids they had before the second was added
@pytest.mark.parametrize(
    "grid,gamma,les", CASES,
    ids=[("" if g == "les_tests" else f"{g}-") + f"{gm}-{lz}"
         for g, gm, lz in CASES])
def test_predictor_3d_vs_jnp(grid, gamma, les):
    """The wrapper on CPU tensors against the JAX jnp route
    (``stencils.predictor`` with ``les.sgs_forcing``, then the BC pass),
    every face compared: the wrapper writes the BC values itself."""
    jg, tg, jb, tb, ju, tu = _setup(*GRIDS[grid])
    tcfg = convert.les_config_from_jax(CFG)

    def jnp_route(u):
        nt = jles.eddy_viscosity(jg, jb, u, CFG) if les else None
        forcing = jles.sgs_forcing(jg, jb, u, CFG, nu_t=nt) if les else None
        return nt, jbcs.apply_velocity_bcs(jg, jb, jst.predictor(
            jg, jb, u, jnp.float32(DT), NU, gamma, forcing=forcing))

    j_nt, ref = _jax(jnp_route, ju)
    before = dict(predictor3d.LAUNCHES)
    t_nt = predictor3d.nu_t_3d(tg, tb, tu, tcfg) if les else None
    got = predictor3d.predictor_3d(tg, tb, tu, DT, NU, gamma, nu_t=t_nt)
    assert predictor3d.LAUNCHES == before    # CPU tensors: plain versions
    if les:
        _close_nu_t(t_nt, j_nt)
    for a in range(3):
        assert tuple(got[a].shape) == tg.face_shape(a)
        np.testing.assert_allclose(got[a].numpy(), np.asarray(ref[a]),
                                   rtol=0.0, atol=5e-5)


def test_wrappers_check_inputs():
    """Tensors on a device that is neither the CPU nor CUDA are refused (no
    silent route), as are wrong shapes, dtypes and the dynamic model."""
    tg = tgrid.GridSpec((8, 6, 4), (1.0, 1.0, 1.0))
    tb = tbcs.no_slip_box(tg)
    u = [torch.zeros(tg.face_shape(a)) for a in range(3)]
    cfg = tles.LESConfig(cs=0.2)
    meta = [c.to("meta") for c in u]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        predictor3d.predictor_3d(tg, tb, meta, DT, NU)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        predictor3d.nu_t_3d(tg, tb, meta, cfg)
    with pytest.raises(ValueError, match="shape"):
        predictor3d.predictor_3d(tg, tb, [u[1], u[0], u[2]], DT, NU)
    with pytest.raises(TypeError, match="dtype"):
        predictor3d.nu_t_3d(tg, tb, [c.double() for c in u], cfg)
    with pytest.raises(ValueError, match="shape"):
        predictor3d.predictor_3d(tg, tb, u, DT, NU,
                                 nu_t=torch.zeros(tg.shape[::-1]))
    with pytest.raises(ValueError, match="static Smagorinsky"):
        predictor3d.nu_t_3d(tg, tb, u, tles.LESConfig(model="dynamic"))
    with pytest.raises(ValueError, match="3D"):
        predictor3d.predictor_3d(tgrid.GridSpec((8, 6), (1.0, 1.0)),
                                 tbcs.no_slip_box(tg), u[:2], DT, NU)
    # an all-zero field has no strain: nu_t is zero, u* keeps the walls
    assert float(predictor3d.nu_t_3d(tg, tb, u, cfg).abs().max()) == 0.0


def test_les_config_is_3d_only():
    """LES on a 2D grid raises from build and from dataclasses.replace."""
    case = make_case("cavity", shape=(8, 8), device="cpu")
    with pytest.raises(NotImplementedError, match="2D LES"):
        dataclasses.replace(case.sim, les=tles.LESConfig())
    from navierstokessolver_tpu_torch.solver import Simulation
    sim = case.sim
    with pytest.raises(NotImplementedError, match="2D LES"):
        Simulation.build(sim.grid, sim.bcs, sim.params, "cpu",
                         les=tles.LESConfig())
    with pytest.raises(NotImplementedError, match="forcing"):
        Simulation.build(sim.grid, sim.bcs, sim.params, "cpu",
                         forcing=(np.ones(sim.grid.face_shape(0)), None))


# -- the JAX Pallas kernels in interpret mode (heavy tier) --------------------


@pytest.mark.heavy
def test_nu_t_3d_vs_pallas_interpret():
    jg, tg, jb, tb, ju, tu = _setup(seed=0)
    ref = _jax(lambda u: jpk.nu_t_3d_from_canon(
        jg, jb, jpk.build_canon_3d(jg, jb, u, tile=8),
        CFG.cs ** 2 * CFG.filter_width(jg) ** 2, tile=8, interpret=True), ju)
    got = predictor3d.nu_t_3d(tg, tb, tu, convert.les_config_from_jax(CFG))
    _close_nu_t(got, ref)


@pytest.mark.heavy
@pytest.mark.parametrize("les,gamma", [(True, 0.3), (False, 0.0)])
def test_predictor_3d_vs_pallas_interpret(les, gamma):
    """Interior faces only: the TPU kernel leaves the boundary faces to the
    caller's BC pass."""
    jg, tg, jb, tb, ju, tu = _setup(seed=1 if les else 2)
    j_nt = (_jax(lambda u: jles.eddy_viscosity(jg, jb, u, CFG), ju) if les
            else None)
    ref = _jax(lambda u, nt: jpk.predictor_3d(
        jg, jb, u, DT, NU, gamma, tile=8, interpret=True, nu_t=nt), ju, j_nt)
    t_nt = (torch.from_numpy(np.array(j_nt)) if les else None)
    got = predictor3d.predictor_3d(tg, tb, tu, DT, NU, gamma, nu_t=t_nt)
    for a in range(3):
        np.testing.assert_allclose(_interior(got[a], a),
                                   _interior(ref[a], a), rtol=0.0, atol=5e-5)
