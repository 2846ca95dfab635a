"""PyTorch port vs JAX package: the 2D per-component predictor (the Pallas
kernel ``_predictor_component_kernel`` and its CUDA counterpart
``ops/predictor2d.predictor_2d``), and the BC kinds it reads.

On the CPU the port's wrapper runs its plain version
(``stencils.predictor``); it is held to the JAX Pallas kernel in
interpret mode (``tile=16``) on interior faces with the JAX test's
tolerance (tests/test_pallas.py: atol 2e-5; the kernel's boundary faces
are garbage by contract) and to the JAX ``stencils.predictor`` on every
face (atol 1e-6: the same jnp-order arithmetic in both packages). Each
JAX reference runs as one ``jax.jit`` program. The CUDA kernel is held to
the plain version on a GPU in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu.ops import stencils as jst
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import predictor2d

DT, NU = 1e-3, 0.05


def _tables(name, shape=(12, 10)):
    """The same BC table in both packages: ``cavity`` (walls, moving lid),
    ``inflow`` (inflow (1, 0) / outflow / walls), ``slip`` (inflow /
    outflow / slip / slip, the cylinder's), ``profile`` (profiles from a
    seed: on the inflow face u normal (n1,) and v tangential (n1 + 1,), on
    the low wall u tangential (n0 + 1, 1) and v normal (n0,), a lid of
    (n0 + 1, 1); outflow)."""
    n0, n1 = shape
    rng = np.random.default_rng(n0 * 100 + n1)
    prof = [rng.standard_normal(s).astype(np.float32)
            for s in ((n1,), (n1 + 1,), (n0 + 1, 1), (n0,), (n0 + 1, 1))]

    def make(m):
        if name == "cavity":
            t = {(a, s): m.BCSpec.wall((0.0, 0.0))
                 for a in range(2) for s in (0, 1)}
            t[(1, 1)] = m.BCSpec.wall((1.0, 0.0))
            return t
        if name == "profile":
            return {(0, 0): m.BCSpec.inflow((prof[0], prof[1])),
                    (0, 1): m.BCSpec.outflow(),
                    (1, 0): m.BCSpec.wall((prof[2], prof[3])),
                    (1, 1): m.BCSpec.wall((prof[4], 0.0))}
        side = m.BCSpec.wall((0.0, 0.3)) if name == "inflow" else m.BCSpec.slip()
        return {(0, 0): m.BCSpec.inflow((1.0, 0.0)),
                (0, 1): m.BCSpec.outflow(),
                (1, 0): side, (1, 1): side}
    return make(jbcs), make(tbcs)


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((shape[0] + (a == 0), shape[1] + (a == 1)))
            .astype(np.float32) for a in range(2)]


@pytest.mark.parametrize("shape,gamma,table", [
    ((24, 16), 0.0, "cavity"),
    ((24, 16), 0.7, "cavity"),
    ((24, 16), 0.0, "inflow"),
    ((32, 8), 0.7, "inflow"),
    ((32, 8), 0.0, "slip"),
    ((24, 16), 0.7, "slip"),
    ((24, 16), 0.0, "profile"),
    ((32, 8), 0.7, "profile"),
])
def test_predictor_2d_plain_matches_jax_kernel(shape, gamma, table):
    lengths = (1.0, 0.7)
    jg = jgrid.GridSpec(shape=shape, lengths=lengths)
    tg = tgrid.GridSpec(shape, lengths)
    jb, tb = _tables(table, shape)
    u = _fields(shape, seed=len(table) + int(10 * gamma))

    @jax.jit
    def ref(uu, vv):
        ub = jbcs.apply_velocity_bcs(jg, jb, (uu, vv))
        return (ub, jpk.predictor_2d(jg, jb, ub, DT, NU, gamma, tile=16,
                                     interpret=True),
                jst.predictor(jg, jb, ub, DT, NU, gamma))

    ub, kern, plain = ref(*(jnp.asarray(c) for c in u))
    tu = tbcs.apply_velocity_bcs(tg, tb, tuple(torch.from_numpy(c) for c in u))
    for a in range(2):
        np.testing.assert_array_equal(tu[a].numpy(), np.asarray(ub[a]))
    predictor2d.reset_launch_counts()
    got = predictor2d.predictor_2d(tg, tb, tu, DT, NU, gamma)
    assert predictor2d.LAUNCHES["predictor_2d"] == 0   # CPU: the plain one
    for a in range(2):
        sl = [slice(None)] * 2
        sl[a] = slice(1, -1)     # interior faces: boundary faces are garbage
        np.testing.assert_allclose(got[a].numpy()[tuple(sl)],
                                   np.asarray(kern[a])[tuple(sl)], atol=2e-5)
        np.testing.assert_allclose(got[a].numpy(), np.asarray(plain[a]),
                                   rtol=0.0, atol=1e-6)
        # own-axis boundary faces keep their input: the BC pass's territory
        np.testing.assert_array_equal(got[a].numpy()[tuple(
            slice(None) if d != a else [0, -1] for d in range(2))],
            tu[a].numpy()[tuple(slice(None) if d != a else [0, -1]
                                for d in range(2))])


@pytest.mark.parametrize("table", ["cavity", "inflow", "slip", "profile"])
def test_ghost_table_reproduces_pad_transverse(table):
    """The kernel's ghosts alpha*edge + beta[pos] are pad_transverse's, bit
    for bit (-1, 2 u_bc across WALL and INFLOW, a constant broadcast into
    its vector as a profile is; 1, 0 across SLIP and OUTFLOW)."""
    tg = tgrid.GridSpec((12, 10), (1.0, 1.0))
    _, tb = _tables(table)
    g = predictor2d.ghost_table(tg, tb, "cpu")
    assert g.dtype == torch.float32
    assert g.shape == (4 + 2 * 13 + 2 * 11,)
    alpha, betas = predictor2d.ghost_parts(tg, g)
    u = tuple(torch.from_numpy(c) for c in _fields(tg.shape, 7))
    for k, (comp, axis) in enumerate(((0, 1), (0, 1), (1, 0), (1, 0))):
        side = k % 2
        padded = tbcs.pad_transverse(tg, tb, comp, u[comp])
        n = padded.shape[axis]
        ghost = padded.narrow(axis, 0 if side == 0 else n - 1, 1)
        edge = u[comp].narrow(axis, 0 if side == 0 else u[comp].shape[axis] - 1, 1)
        beta = betas[k].reshape(edge.shape)   # by u row, by v column
        want = alpha[k] * edge + beta
        np.testing.assert_array_equal(ghost.numpy(), want.numpy())
    if table == "slip":   # u: slip / slip; v: inflow (v = 0) / outflow
        assert alpha.tolist() == [1.0, 1.0, -1.0, 1.0]
        assert not any(bool(b.any()) for b in betas)
    if table == "profile":   # u: wall / wall; v: inflow / outflow
        assert alpha.tolist() == [-1.0, -1.0, -1.0, 1.0]
        np.testing.assert_array_equal(
            betas[2].numpy(), 2.0 * tb[(0, 0)].velocity[1])


def test_predictor_2d_wrapper_checks():
    tg = tgrid.GridSpec((12, 10), (1.0, 1.0))
    _, tb = _tables("slip")
    u = tuple(torch.zeros(tg.face_shape(a)) for a in range(2))
    with pytest.raises(ValueError, match="shape"):
        predictor2d.predictor_2d(tg, tb, (u[0][:-1], u[1]), DT, NU)
    with pytest.raises(TypeError, match="dtype"):
        predictor2d.predictor_2d(tg, tb, (u[0].double(), u[1].double()),
                                 DT, NU)
    meta = tuple(torch.empty(tg.face_shape(a), device="meta")
                 for a in range(2))
    with pytest.raises(ValueError, match="CUDA devices"):
        predictor2d.predictor_2d(tg, tb, meta, DT, NU)
    per = dict(tb)
    per[(1, 0)] = per[(1, 1)] = tbcs.BCSpec(tbcs.BCKind.PERIODIC)
    assert not predictor2d.predictor_2d_applicable(tg, per)
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        predictor2d.predictor_2d(tg, per, u, DT, NU)
    g3 = tgrid.GridSpec((4, 4, 4), (1.0, 1.0, 1.0))
    assert not predictor2d.predictor_2d_applicable(g3, tbcs.no_slip_box(g3))
