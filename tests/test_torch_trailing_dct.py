"""PyTorch port vs JAX package: the fused trailing-axes direct solve, the
circulant (periodic) eigenbasis and the periodic DCT solver.

On CPU tensors ``trailing_dct.fused_trailing`` runs its plain version (the
JAX kernel's bf16 split products as bf16-valued ``torch.matmul``s, and the
multiply), so these tests drive the port's fused route end to end; the CUDA
kernel is held to the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py). The JAX reference is its ``_direct_fused3d`` with the
Pallas kernel in interpret mode, held as the JAX package's own test holds
it (tests/test_fft_poisson.py): max error below 5e-4 of max|ref|; one call
of the kernel at Precision.HIGH is matched within 2e-6 of max|ref| (the
same split products, summed in another order). Constants built by the same
numpy code are bit-equal; solves agree to float32 roundoff of the
transforms (rtol 1e-5 of max|p| where the two run the same route, 2e-4
where one runs the chain and the other the fused route's 3-pass bf16
products). Each JAX reference is one jitted program.
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
from navierstokessolver_tpu_torch.ops import fused3d
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
    tb, tf1, tf2, tinv = (torch.from_numpy(np.array(a))
                          for a in (b, f1, f2, inv_nat))
    got = trailing_dct.fused_trailing_plain(
        tb, trailing_dct.split_matrix(tf1), trailing_dct.split_matrix(tf2),
        tinv)
    assert _rel(got, j_trail) < 5e-4
    ts = _port(kinds)
    assert ts._fused3d_route_ok() and ts.kinds == kinds
    before = dict(trailing_dct.LAUNCHES)
    out = ts._direct(torch.from_numpy(b))
    assert trailing_dct.LAUNCHES == before      # CPU: the plain version
    assert _rel(out, j_direct) < 5e-4, kinds


@pytest.mark.parametrize("kinds", KINDS, ids="-".join)
def test_fused_route_matches_chain(kinds):
    """The fused route and the chain compute the same operator (the
    route's 3-pass bf16 products drop the lo*lo term, ~2^-16 of each
    product: 2e-4 of max|p|, the JAX package's own test holds the two at
    5e-4); ``use_kernel=False`` takes the route's plain version (on the CPU
    the kernel's wrapper does too), and 'highest' the chain."""
    ts = _port(kinds)
    b = torch.from_numpy(_rhs(ts.singular, seed=8))
    chain = ts._inv(ts._fwd(b) * ts.inv_eig)
    assert _rel(ts._direct(b), chain) < 2e-4
    assert torch.equal(ts._direct(b, use_kernel=False), ts._direct(b))
    assert torch.equal(ts._direct(b, precision="highest"), chain)
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
    m1, m2 = (trailing_dct.split_matrix(torch.zeros(s)) for s in
              ((5, 6), (3, 10)))
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
        trailing_dct.fused_trailing(
            x.to("meta"), *(trailing_dct.split_matrix(m.full.to("meta"))
                            for m in (m1, m2)))
    with pytest.raises(ValueError, match="Splits"):
        trailing_dct.fused_trailing(x, m1.full, m2.full)
    with pytest.raises(ValueError, match="passes"):
        trailing_dct.fused_trailing(x, m1, m2, passes=2)
    assert trailing_dct.applicable((256, 256, 256))
    assert trailing_dct.applicable((40, 24, 72))
    assert trailing_dct.applicable((8, 1024, 256))
    assert not trailing_dct.applicable((8, 8, 257))
    assert not trailing_dct.applicable((65536, 2, 2))
    assert not trailing_dct.applicable((8, 8))
    # the B tile / Y, the x ring / m2 slices, the m1 slices, alignment
    assert trailing_dct.smem_bytes() == (64 + 32 + 16 + 1) * 1024


def _bf16_bits(a) -> np.ndarray:
    """A torch bf16 tensor's bit patterns, or a numpy float32 array rounded
    to bf16 (nearest even) as bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a, np.float32).astype(jnp.bfloat16).view(np.uint16)


def _np_split(a):
    """JAX's ``_split_bf16`` in numpy: float32 hi, lo."""
    a = np.asarray(a, np.float32)
    hi = a.astype(jnp.bfloat16).astype(np.float32)
    return hi, (a - hi).astype(jnp.bfloat16).astype(np.float32)


def test_fused_trailing_plain_matches_jax_kernel():
    """The plain version at 3 passes against one call of the Pallas kernel
    at Precision.HIGH in interpret mode (its ``_dot``: the same 3-pass bf16
    split products of both stages), on x (8, 16, 128) with a non-square
    m1 (24 x 16) and the multiplier: within 2e-6 of max|ref| (measured
    3.7e-7; the float32 product is 7.6e-6 away). At 1 pass, against the
    one-bf16-pass product built in numpy (bf16-rounded operands, float64
    sums): JAX's interpret mode computes Precision.DEFAULT in full float32
    on the CPU, so it is no reference for one pass."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 128)).astype(np.float32)
    m1 = rng.standard_normal((24, 16)).astype(np.float32)
    m2 = rng.standard_normal((128, 128)).astype(np.float32)
    eig = rng.standard_normal((8, 24, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x, m1, m2, eig: jpd.fused_trailing(
        x, m1, m2, eig=eig, precision=jax.lax.Precision.HIGH,
        interpret=True))(x, m1, m2, eig))
    args = [torch.from_numpy(a) for a in (x, m1, m2, eig)]
    args[1:3] = (trailing_dct.split_matrix(m) for m in args[1:3])
    assert _rel(trailing_dct.fused_trailing_plain(*args, passes=3), ref) < 2e-6
    got = trailing_dct.fused_trailing_plain(*args, passes=1)
    y = np.matmul(_np_split(m1)[0].astype(np.float64),
                  _np_split(x)[0].astype(np.float64)).astype(np.float32)
    one = np.matmul(_np_split(y)[0].astype(np.float64),
                    _np_split(m2)[0].T.astype(np.float64)) * eig
    assert _rel(got, one) < 1e-6
    # on the CPU the wrapper is its plain version
    for passes in (1, 3):
        assert torch.equal(
            trailing_dct.fused_trailing(*args, passes=passes),
            trailing_dct.fused_trailing_plain(*args, passes=passes))


@pytest.mark.parametrize("kinds", KINDS, ids="-".join)
def test_split_constants_match_jax(kinds):
    """The fused route's bf16 hi/lo constants, from the port's build and
    from ``convert.dct_solver_from_numpy``, equal JAX's ``_fused3d_consts()``
    split in numpy bit for bit; the kernel's packed pair holds them, zero
    outside (rows padded to 128, columns to 64)."""
    jg = jgrid.GridSpec(SHAPE, LENGTHS)
    js = jfft.DCTPoissonSolver.build(jg, kinds=kinds)
    cs = convert.dct_solver_from_numpy(
        tgrid.GridSpec(SHAPE, LENGTHS), np.asarray(js.inv_eig),
        [np.asarray(p.base_fwd) for p in js.plans],
        [np.asarray(p.base_inv) for p in js.plans],
        kinds=kinds, fuse_trailing=True)
    jconsts = js._fused3d_consts()[1:]
    for ts in (_port(kinds), cs):
        for (jf, jv), splits in zip(jconsts, ts._fused3d_split):
            for jm, sm in zip((jf, jv), splits):
                jm = np.asarray(jm)
                hi, lo = _np_split(jm)
                np.testing.assert_array_equal(_bf16_bits(sm.hi),
                                              _bf16_bits(hi))
                np.testing.assert_array_equal(_bf16_bits(sm.lo),
                                              _bf16_bits(lo))
                k, n = jm.shape
                assert tuple(sm.packed.shape) == (2, -(-k // 128) * 128,
                                                  -(-n // 64) * 64)
                assert int(sm.packed.float().abs().sum()) == int(
                    sm.hi.float().abs().sum() + sm.lo.float().abs().sum())


def test_precision_routing_matches_jax():
    """As JAX's ``_fused3d_route_ok`` and ``solve``: 'highest' keeps the
    chain, 'high' and 'default' take the fused route at 3 and 1 bf16
    passes, and each refinement solve runs at ``refine_precision``."""
    kinds = ("nn", "nn", "nn")
    jg = jgrid.GridSpec(SHAPE, LENGTHS)
    js = dataclasses.replace(jfft.DCTPoissonSolver.build(jg, kinds=kinds),
                             fuse_trailing=True)
    ts = _port(kinds)
    assert ts._fused3d_route_ok() and ts._fused3d_route_ok("default")
    assert not ts._fused3d_route_ok("highest")
    assert not dataclasses.replace(ts, precision="highest")._fused3d_route_ok()
    # JAX refuses 'highest' the same way (and any route off the TPU)
    assert not js._fused3d_route_ok("highest")
    b = torch.from_numpy(_rhs(True, seed=11))
    chain = ts._inv(ts._fwd(b) * ts.inv_eig)
    assert torch.equal(ts._direct(b, precision="highest"), chain)
    one = ts._direct(b, precision="default")
    assert _rel(one, chain) > 1e-4 > _rel(ts._direct(b), chain)
    top = tpois.build_poisson_op(tgrid.GridSpec(SHAPE, LENGTHS),
                                 tbcs.no_slip_box(tgrid.GridSpec(SHAPE,
                                                                 LENGTHS)),
                                 "cpu")
    calls = []
    direct = tfft.DCTPoissonSolver._direct

    def spy(self, b, offset=0, use_kernel=True, precision=None):
        calls.append(precision)
        return direct(self, b, offset, use_kernel, precision)

    for refine_prec in ("default", "highest"):
        s = dataclasses.replace(ts, refine_precision=refine_prec)
        calls.clear()
        tfft.DCTPoissonSolver._direct = spy
        try:
            p = s.solve(b, top)
        finally:
            tfft.DCTPoissonSolver._direct = direct
        assert calls == [None, refine_prec]
        p0 = s._direct(b)
        want = p0 + s._direct(fused3d.residual_plain(top, p0, b),
                              precision=refine_prec)
        assert torch.equal(p, want)


def test_step_plain_takes_the_fused_routes_plain_version(monkeypatch):
    """On a solver with ``fuse_trailing``, ``step_plain`` (use_kernel
    False) runs the fused route through ``fused_trailing_plain``, four
    calls a step at 3 passes, not the chain; on the CPU the kernel step
    runs the same arithmetic, bit for bit."""
    from navierstokessolver_tpu_torch.cases import make_case

    case = make_case("taylor_green3d", shape=(16, 16, 16), re=200.0,
                     device="cpu")
    sim = dataclasses.replace(case.sim, dct_solver=dataclasses.replace(
        case.sim.dct_solver, fuse_trailing=True))
    passes = []
    plain = trailing_dct.fused_trailing_plain

    def spy(x, m1, m2, eig=None, p=3):
        passes.append(p)
        return plain(x, m1, m2, eig, p)

    monkeypatch.setattr(trailing_dct, "fused_trailing_plain", spy)
    st = case.initial_state()
    sp, dp = sim.step_plain(st)
    assert passes == [3, 3, 3, 3]
    sk, dk = sim.step(st)
    assert len(passes) == 8
    for a in range(3):
        assert torch.equal(sk.u[a], sp.u[a])
    assert torch.equal(sk.p, sp.p)
