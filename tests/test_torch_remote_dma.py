"""PyTorch port vs JAX package: the row exchanges between slabs (kernels 13
and 14, parallel/remote_dma.py).

The same numpy-seeded volumes go through the JAX exchange in TPU-interpret
mode under ``shard_map`` on a 4-device virtual mesh, and through the
port's exchange on four per-shard CPU tensors (its plain version: a slice
and ``copy_`` per message). An exchange moves values, so the two must be
equal bit for bit. Message sets: the JAX package's own test's (two volumes
of different widths), kernel 13's fixed set, and the three exchanges of
the port's sharded step (velocity ghost refresh, shared face, pressure
halo), ring and bounded. Each JAX reference is one jitted program.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from navierstokessolver_tpu.parallel import remote_dma as jrd
from navierstokessolver_tpu_torch.parallel import fused_sharded, remote_dma

N_DEV = 4
B = 8


def _jax_exchange(vols, msgs, ring, ghost_b=None):
    """JAX's exchange of ``vols`` (numpy (N_DEV, RP, S, L) each) on the
    virtual mesh; per-shard numpy outputs."""
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("sx",))
    interp = pltpu.InterpretParams()
    if ghost_b is not None:
        body = lambda x: jrd.exchange_ghost_rows(  # noqa: E731
            x, ghost_b, "sx", N_DEV, ring, interpret=interp)
        specs = P("sx")
    else:
        body = lambda *xs: jrd.exchange_rows_multi(  # noqa: E731
            xs, msgs, "sx", N_DEV, ring, interpret=interp)
        specs = tuple(P("sx") for _ in vols)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                               out_specs=specs, check_vma=False))
    out = fn(*(v.reshape((-1,) + v.shape[2:]) for v in vols))
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o).reshape(v.shape) for o, v in zip(out, vols)]


def _volumes(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N_DEV,) + s).astype(np.float32)
            for s in shapes]


def _port(vols):
    """Per-shard CPU tensors (copies) of the numpy volumes."""
    return [[torch.from_numpy(v[k].copy()) for k in range(N_DEV)]
            for v in vols]


# message set -> (per-volume (RP, S, L) shapes, messages)
CASES = {
    # tests/test_remote_dma.py::test_exchange_rows_multi_generic_msgs
    "generic": ([(12, 8, 128), (12, 16, 128)],
                ((B - 1, 1, 11, "fwd"), (0, 1, B, "bwd"))),
    # the sharded step's three exchanges, on a slab of B rows of a
    # (N_DEV*B, 6, 5) grid (fused_sharded's layout)
    "velocity": ([(B + 3, 6, 5), (B + 3, 7, 5), (B + 3, 6, 6)],
                 fused_sharded.velocity_messages(B)),
    "shared_face": ([(B + 3, 6, 5)], fused_sharded.shared_face_messages(B)),
    "pressure": ([(B + 2, 6, 5)], fused_sharded.pressure_messages(B)),
}


@pytest.mark.parametrize("ring", [False, True], ids=["bounded", "ring"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_exchange_rows_multi_matches_jax(case, ring):
    shapes, msgs = CASES[case]
    vols = _volumes(shapes, seed=len(case) + 7 * ring)
    ref = _jax_exchange(vols, msgs, ring)
    xs = _port(vols)
    before = dict(remote_dma.LAUNCHES)
    out = remote_dma.exchange_rows_multi(xs, msgs, ring)
    assert out is xs                         # in place
    assert remote_dma.LAUNCHES == before     # CPU: the plain version
    for v, (r, x) in enumerate(zip(ref, xs)):
        for k in range(N_DEV):
            np.testing.assert_array_equal(x[k].numpy(), r[k],
                                          err_msg=f"volume {v} shard {k}")
    # the plain version on its own gives the same
    again = _port(vols)
    remote_dma.exchange_rows_multi_plain(again, msgs, ring)
    for x, y in zip(xs, again):
        for k in range(N_DEV):
            assert torch.equal(x[k], y[k])


@pytest.mark.parametrize("ring", [False, True], ids=["bounded", "ring"])
def test_exchange_ghost_rows_matches_jax(ring):
    """Kernel 13: tests/test_remote_dma.py's volume (RP 16, b 8)."""
    (vol,) = _volumes([(16, 8, 128)], seed=11 + ring)
    (ref,) = _jax_exchange([vol], None, ring, ghost_b=B)
    (x,) = _port([vol])
    assert remote_dma.exchange_ghost_rows(x, B, ring) is x
    for k in range(N_DEV):
        np.testing.assert_array_equal(x[k].numpy(), ref[k])
        exp = vol[k].copy()
        if ring or k > 0:
            exp[15] = vol[(k - 1) % N_DEV][B - 1]
        if ring or k < N_DEV - 1:
            exp[B:B + 2] = vol[(k + 1) % N_DEV][0:2]
        np.testing.assert_array_equal(x[k].numpy(), exp)
    (y,) = _port([vol])
    remote_dma.exchange_ghost_rows_plain(y, B, ring)
    assert all(torch.equal(a, b) for a, b in zip(x, y))


def test_exchange_probes():
    """Overlapping destinations, a source that is a destination, shards on
    two devices, and a device that is neither CPU nor CUDA raise."""
    xs = _port(_volumes([(12, 4, 3)], seed=0))
    with pytest.raises(ValueError, match="overlapping dst"):
        remote_dma.exchange_rows_multi(xs, ((0, 2, 8, "fwd"),
                                            (1, 2, 9, "bwd")))
    with pytest.raises(ValueError, match="overlap the destination"):
        remote_dma.exchange_rows_multi(xs, ((0, 2, 1, "fwd"),))
    with pytest.raises(ValueError, match="outside"):
        remote_dma.exchange_rows_multi(xs, ((11, 2, 0, "fwd"),))
    with pytest.raises(ValueError, match="direction"):
        remote_dma.exchange_rows_multi(xs, ((0, 1, 5, "up"),))
    with pytest.raises(ValueError, match="share one tensor"):
        remote_dma.exchange_rows_multi([[xs[0][0]] * N_DEV],
                                       ((0, 1, 5, "fwd"),))
    mixed = [xs[0][:3] + [torch.empty((12, 4, 3), device="meta")]]
    with pytest.raises(NotImplementedError, match="parallel/ across cards"):
        remote_dma.exchange_rows_multi(mixed, ((0, 1, 5, "fwd"),))
    meta = [[torch.empty((12, 4, 3), device="meta") for _ in range(N_DEV)]]
    with pytest.raises(ValueError, match="the kernel runs on CUDA"):
        remote_dma.exchange_rows_multi(meta, ((0, 1, 5, "fwd"),))
    with pytest.raises(ValueError, match="the kernel runs on CUDA"):
        remote_dma.exchange_ghost_rows(meta[0], 8)
