"""PyTorch port vs JAX package: the fused trailing-axes direct solve, the
circulant (periodic) eigenbasis and the periodic DCT solver.

On CPU tensors ``trailing_dct.fused_trailing`` runs its plain version (two
``torch.matmul`` and the multiply), so these tests drive the port's fused
route end to end; the CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py). The JAX reference is its
``_direct_fused3d`` with the Pallas kernel in interpret mode, held as the
JAX package's own test holds it (tests/test_fft_poisson.py): max error
below 5e-4 of max|ref|. Constants built by the same numpy code are
bit-equal; solves agree to float32 roundoff of the transforms (rtol 1e-5 of
max|p| where the two run the same route, 2e-4 where one runs the chain and
the other the fused route). Each JAX reference is one jitted program.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu.ops import dct as jdct
from navierstokessolver_tpu.ops import fft_poisson as jfft
from navierstokessolver_tpu.ops import pallas_dct as jpd
from navierstokessolver_tpu.ops import poisson as jpois
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import dct as tdct
from navierstokessolver_tpu_torch.ops import fft_poisson as tfft
from navierstokessolver_tpu_torch.ops import poisson as tpois
from navierstokessolver_tpu_torch.ops import trailing_dct

SHAPE, LENGTHS = (16, 16, 128), (1.0, 1.0, 8.0)
KINDS = [("nn", "nn", "nn"), ("nd", "nn", "per")]


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


def _rhs(singular: bool, seed: int = 7) -> np.ndarray:
    b = np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)
    return b - b.mean() if singular else b


def _port(kinds, fuse: bool = True):
    tg = tgrid.GridSpec(SHAPE, LENGTHS)
    ts = tfft.DCTPoissonSolver.build(tg, "cpu", kinds=kinds)
    return dataclasses.replace(ts, fuse_trailing=fuse)


@pytest.mark.parametrize("kinds", KINDS, ids="-".join)
def test_direct_fused3d_matches_jax(kinds):
    """The port's fused route (CPU: fused_trailing_plain) against JAX's
    ``_direct_fused3d`` with the Pallas kernel in interpret mode, and
    fused_trailing_plain on JAX's own per-axis matrices against one call of
    the Pallas kernel."""
    jg = jgrid.GridSpec(SHAPE, LENGTHS)
    js = jfft.DCTPoissonSolver.build(jg, kinds=kinds)
    assert jpd.direct_applicable(jg.shape, jg.dtype)
    prec = js._prec(None, js.precision)
    b = _rhs(js.singular)
    (_, _), (f1, _), (f2, _) = js._fused3d_consts()
    inv_nat = jnp.transpose(js.inv_eig, (2, 1, 0))

    @jax.jit
    def jax_ref(b):
        return (js._direct_fused3d(b, prec, interpret=True),
                jpd.fused_trailing(b, f1, f2, eig=inv_nat, precision=prec,
                                   interpret=True))

    j_direct, j_trail = jax_ref(jnp.asarray(b))
    got = trailing_dct.fused_trailing_plain(
        *(torch.from_numpy(np.array(a)) for a in (b, f1, f2, inv_nat)))
    assert _rel(got, j_trail) < 5e-4
    ts = _port(kinds)
    assert ts._fused3d_route_ok() and ts.kinds == kinds
    before = dict(trailing_dct.LAUNCHES)
    out = ts._direct(torch.from_numpy(b))
    assert trailing_dct.LAUNCHES == before      # CPU: the plain version
    assert _rel(out, j_direct) < 5e-4, kinds


@pytest.mark.parametrize("kinds", KINDS, ids="-".join)
def test_fused_route_matches_chain(kinds):
    """The fused route and the chain compute the same operator (float32
    roundoff of 16 + 16 + 128-term sums), and ``use_kernel=False`` takes
    the chain."""
    ts = _port(kinds)
    b = torch.from_numpy(_rhs(ts.singular, seed=8))
    chain = ts._inv(ts._fwd(b) * ts.inv_eig)
    assert _rel(ts._direct(b), chain) < 1e-5
    assert torch.equal(ts._direct(b, use_kernel=False), chain)
    assert not _port(kinds, fuse=False)._fused3d_route_ok()
    f, v = ts.axis_matrices(2)
    assert tuple(f.shape) == tuple(v.shape) == (128, 128)
    torch.testing.assert_close(v @ f, torch.eye(128), rtol=0.0, atol=2e-6)


def test_circulant_basis_and_periodic_build_match_jax():
    """circulant_eigenbasis bit for bit; the per-axis plans and the
    multiplier of a mixed periodic solver bit for bit (the multiplier in
    natural axis order); both self-checks at float32 roundoff."""
    for n, h in ((8, 0.5), (16, 2 * np.pi / 16)):
        tq, tl = tdct.circulant_eigenbasis(n, h)
        jq, jl = jdct.circulant_eigenbasis(n, h)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError, match="even"):
        tdct.circulant_eigenbasis(7, 1.0)
    kinds = ("per", "nn", "per")
    shape, lengths = (8, 12, 16), (1.0, 1.5, 2.0)
    js = jfft.DCTPoissonSolver.build(jgrid.GridSpec(shape, lengths),
                                     kinds=kinds)
    ts = tfft.DCTPoissonSolver.build(tgrid.GridSpec(shape, lengths), "cpu",
                                     kinds=kinds)
    assert ts.singular and js.singular
    np.testing.assert_array_equal(ts.inv_eig.numpy(),
                                  np.transpose(np.asarray(js.inv_eig),
                                               (2, 1, 0)))
    for tp, jp in zip(ts.plans, js.plans):
        assert tp.levels == jp.levels == 0
        np.testing.assert_array_equal(tp.base_fwd.numpy(),
                                      np.asarray(jp.base_fwd))
        np.testing.assert_array_equal(tp.base_inv.numpy(),
                                      np.asarray(jp.base_inv))
    assert ts._self_check_error() < 1e-5
    assert js._self_check_error(kinds) < 1e-5


def test_dct_solver_from_numpy_carries_periodic_and_fuse_trailing():
    """A JAX periodic solver carried across (with ``fuse_trailing``)
    solves as the port's own build does, and as the JAX solver does with
    its refinement pass (rtol 2e-4: the fused route against JAX's
    chain)."""
    kinds = ("nd", "nn", "per")
    jg = jgrid.GridSpec(SHAPE, LENGTHS)
    tg = tgrid.GridSpec(SHAPE, LENGTHS)
    jb = jbcs.no_slip_box(jg)
    tb = tbcs.no_slip_box(tg)
    jb[(0, 1)] = jbcs.BCSpec.outflow()
    tb[(0, 1)] = tbcs.BCSpec.outflow()
    jb[(2, 0)] = jb[(2, 1)] = jbcs.BCSpec.periodic()
    tb[(2, 0)] = tb[(2, 1)] = tbcs.BCSpec.periodic()
    assert jfft.axis_kinds_from_bcs(jg, jb) == kinds
    assert tfft.axis_kinds_from_bcs(tg, tb) == kinds
    js = jfft.DCTPoissonSolver.build(jg, kinds=kinds)
    jop = jpois.build_poisson_op(jg, jb)
    top = tpois.build_poisson_op(tg, tb, "cpu")
    b = _rhs(False, seed=9)
    jp, _, jres = jax.jit(lambda b: jfft.solve_with_residual(js, jop, b))(
        jnp.asarray(b))
    cs = convert.dct_solver_from_numpy(
        tg, np.asarray(js.inv_eig),
        [np.asarray(p.base_fwd) for p in js.plans],
        [np.asarray(p.base_inv) for p in js.plans],
        kinds=kinds, fuse_trailing=True,
    )
    assert cs.fuse_trailing and cs._fused3d_route_ok()
    ts = _port(kinds)
    np.testing.assert_array_equal(cs.inv_eig.numpy(), ts.inv_eig.numpy())
    for s in (cs, ts):
        tp, _, tres = tfft.solve_with_residual(s, top, torch.from_numpy(b))
        assert _rel(tp, jp) < 2e-4
        assert 0.0 <= float(tres) < 1e-4 and 0.0 <= float(jres) < 1e-4


def test_fused_trailing_checks_and_gate():
    """The wrapper refuses what the kernel does not take, and a tensor on
    neither the CPU nor a CUDA device; the gate is the kernel's shared
    memory and grid, not the TPU's tiling."""
    x = torch.zeros(4, 6, 10)
    m1, m2 = torch.zeros(5, 6), torch.zeros(3, 10)
    out = trailing_dct.fused_trailing(x, m1, m2, torch.ones(4, 5, 3))
    assert tuple(out.shape) == (4, 5, 3)
    with pytest.raises(ValueError, match="shape"):
        trailing_dct.fused_trailing(x, m2, m1)
    with pytest.raises(ValueError, match="shape"):
        trailing_dct.fused_trailing(x, m1, m2, torch.ones(4, 3, 5))
    with pytest.raises(TypeError, match="dtype"):
        trailing_dct.fused_trailing(x.double(), m1, m2)
    with pytest.raises(ValueError, match="3D"):
        trailing_dct.fused_trailing(torch.zeros(6, 10), m1, m2)
    with pytest.raises(ValueError, match="CUDA devices"):
        trailing_dct.fused_trailing(x.to("meta"), m1.to("meta"),
                                    m2.to("meta"))
    assert trailing_dct.applicable((256, 256, 256))
    assert trailing_dct.applicable((40, 24, 72))
    assert trailing_dct.applicable((8, 8, 816))
    assert not trailing_dct.applicable((8, 8, 817))
    assert not trailing_dct.applicable((65536, 2, 2))
    assert not trailing_dct.applicable((8, 8))
    assert trailing_dct.smem_bytes(256) == 4 * (64 * 256 + 64 * 16 + 16 * 260)
