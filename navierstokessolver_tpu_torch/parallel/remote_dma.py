"""Row messages between the slabs of a sharded volume: the wrappers of the
exchange kernel and their plain versions.

Counterpart of ``navierstokessolver_tpu/parallel/remote_dma.py``:

  ====================  =============================  ==========================
  wrapper               replaces                       plain version
  ====================  =============================  ==========================
  exchange_rows_multi   _exchange_rows_multi_kernel    exchange_rows_multi_plain
  exchange_ghost_rows   _exchange_kernel               exchange_ghost_rows_plain
  ====================  =============================  ==========================

Both run the one CUDA kernel of ``csrc/remote_dma.cu`` (built and loaded by
ops/_native.py); kernel 13 is kernel 14 with its fixed message set
``((b-1, 1, RP-1, 'fwd'), (0, 2, b, 'bwd'))``.

The JAX functions run per shard inside ``shard_map``. Here one process
holds every shard, as the JAX package's tests hold every shard of a virtual
mesh in one process: ``xs[v][k]`` is volume ``v`` on shard ``k``, each shard
a tensor of its own, and rows cross between shards only through these
messages. A message ``(src_row, n_rows, dst_row, dir)`` moves ``n_rows``
rows from ``src_row`` of shard k's volume to ``dst_row`` of shard k+1
(``'fwd'``) or k-1 (``'bwd'``); ``ring=True`` closes the wraparound link,
and on a bounded axis the edge shards send nothing outward, so their
destination rows keep what the caller put there. Every other row is left
as it was. Unlike the JAX functions, which return fresh volumes, these
write in place (and return ``xs``): the destination rows may not overlap,
and no message's source rows may be a destination, so the stores never
race and no pass-through copy is needed.

:class:`RowExchange` builds a message set's table once and keeps it on the
card: the sharded step makes one per exchange, so a step copies nothing
from the host for it. On CPU tensors it runs the plain version (a slice and
``copy_`` per message); on a CUDA device it launches the kernel and adds
one to ``LAUNCHES[<wrapper name>]``. Shards on more than one device raise:
a store through a peer pointer across the cards of one host is the ROADMAP
item 'parallel/ across cards'.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ops import _native

LAUNCHES = {"exchange_rows_multi": 0, "exchange_ghost_rows": 0}

Message = tuple[int, int, int, str]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ghost_messages(b: int, rows: int) -> tuple[Message, ...]:
    """Kernel 13's fixed message set for ``rows`` (RP) rows a shard, data
    rows [0, b): row b-1 to the right neighbour's lo ghost slot RP-1, rows
    [0, 2) to the left neighbour's hi ghost slots [b, b+2)."""
    return ((b - 1, 1, rows - 1, "fwd"), (0, 2, b, "bwd"))


def check_messages(msgs: Sequence[Message], rows: int) -> tuple[Message, ...]:
    """The message set as ints, or ValueError: each range inside [0,
    ``rows``), a direction 'fwd' or 'bwd', destination ranges that do not
    overlap (as JAX asserts) and no source range that overlaps a
    destination (what makes the in-place stores race-free)."""
    out = []
    for m in msgs:
        src, n, dst, d = int(m[0]), int(m[1]), int(m[2]), m[3]
        if d not in ("fwd", "bwd"):
            raise ValueError(f"message {m}: direction must be 'fwd' or 'bwd'")
        if n < 1 or min(src, dst) < 0 or max(src, dst) + n > rows:
            raise ValueError(f"message {m}: rows outside [0, {rows})")
        out.append((src, n, dst, d))
    dsts = sorted((d, d + n) for (_, n, d, _) in out)
    for (a0, a1), (b0, _) in zip(dsts, dsts[1:]):
        if a1 > b0:
            raise ValueError(f"overlapping dst ranges {dsts}")
    for src, n, _, _ in out:
        for d0, d1 in dsts:
            if src < d1 and d0 < src + n:
                raise ValueError(
                    f"source rows [{src}, {src + n}) overlap the destination "
                    f"rows [{d0}, {d1}): the in-place exchange would race"
                )
    return tuple(out)


def _routes(n_dev: int, d: str, ring: bool):
    """(sender, receiver) shard pairs of direction ``d``."""
    step = 1 if d == "fwd" else -1
    return [(k, (k + step) % n_dev) for k in range(n_dev)
            if ring or 0 <= k + step < n_dev]


def _check_volumes(xs) -> tuple[list[list[torch.Tensor]], int, torch.device]:
    """``xs`` as lists, its shard count and its one device; raises on
    ragged or non-contiguous volumes, and on shards on several devices."""
    vols = [list(v) for v in xs]
    if not vols or not vols[0]:
        raise ValueError("need at least one volume with at least one shard")
    n_dev = len(vols[0])
    devices = {t.device for v in vols for t in v}
    if len(devices) > 1:
        raise NotImplementedError(
            f"shards on several devices {sorted(map(str, devices))}: not "
            "ported yet (ROADMAP Queue A, 'parallel/ across cards')"
        )
    device = devices.pop()
    if device.type != "cpu":
        _native.cuda_or_raise(device, "the row exchange")
    rows = vols[0][0].shape[0]
    for i, v in enumerate(vols):
        if len(v) != n_dev:
            raise ValueError(f"volume {i}: {len(v)} shards, expected {n_dev}")
        for k, t in enumerate(v):
            _native.check(f"volume {i} shard {k}", t,
                          (rows,) + tuple(v[0].shape[1:]), v[0].dtype, device)
        if len({t.data_ptr() for t in v}) != n_dev:
            raise ValueError(f"volume {i}: two shards share one tensor")
    return vols, n_dev, device


def message_views(xs, msgs: Sequence[Message], ring: bool = False):
    """The (source, destination) row views of every message of every volume
    and shard, after the checks of :func:`check_messages`."""
    vols, n_dev, _ = _check_volumes(xs)
    msgs = check_messages(msgs, vols[0][0].shape[0])
    src, dst = [], []
    for v in vols:
        for s, n, d, direction in msgs:
            for ks, kd in _routes(n_dev, direction, ring):
                src.append(v[ks].narrow(0, s, n))
                dst.append(v[kd].narrow(0, d, n))
    return src, dst


def exchange_rows_multi_plain(xs, msgs: Sequence[Message],
                              ring: bool = False):
    """The exchange as a slice and ``copy_`` per message, in place;
    returns ``xs``."""
    for s, d in zip(*message_views(xs, msgs, ring)):
        d.copy_(s)
    return xs


def exchange_ghost_rows_plain(x: Sequence[torch.Tensor], b: int,
                              ring: bool = False):
    """Kernel 13's exchange of one volume (``x[k]``: shard k's (RP, S, L)
    block, data rows [0, b)) as plain copies; returns ``x``."""
    exchange_rows_multi_plain((x,), ghost_messages(b, x[0].shape[0]), ring)
    return x


# C signature in csrc/remote_dma.cu: table, message count, longest message
# in bytes, the stream
_ARGTYPES = [_native.P, _native.I, ctypes.c_longlong, _native.P]


class RowExchange:
    """One message set over the shards of ``xs`` with its table built once
    (on a CUDA device: int64 triples of source address, destination
    address and bytes, kept on the card). :meth:`run` moves every message
    in one launch; the table stays valid as long as the tensors of ``xs``
    live, so the caller keeps them (the sharded step reuses its buffers
    every step). ``counter``: the ``LAUNCHES`` key a launch adds to."""

    def __init__(self, xs, msgs: Sequence[Message], ring: bool = False,
                 counter: str = "exchange_rows_multi"):
        vols, self.n_dev, self.device = _check_volumes(xs)
        self.xs = xs
        self.msgs = check_messages(msgs, vols[0][0].shape[0])
        self.ring = ring
        self.counter = counter
        self.table = None
        if self.device.type == "cpu":
            return
        rows = []
        for v in vols:
            row_bytes = v[0][0].numel() * v[0].element_size()
            for s, n, d, direction in self.msgs:
                for ks, kd in _routes(self.n_dev, direction, ring):
                    rows.append((v[ks].data_ptr() + s * row_bytes,
                                 v[kd].data_ptr() + d * row_bytes,
                                 n * row_bytes))
        if not rows:
            raise ValueError("the message set sends nothing")
        self.n_msgs = len(rows)
        self.max_bytes = max(r[2] for r in rows)
        self.table = torch.tensor(rows, dtype=torch.int64, device=self.device)

    def run(self):
        """Move the messages (in place); returns ``xs``."""
        if self.table is None:
            return exchange_rows_multi_plain(self.xs, self.msgs, self.ring)
        _native.launch("remote_dma", "nss_exchange_rows", _ARGTYPES,
                       self.device, _native.ptr(self.table), self.n_msgs,
                       self.max_bytes)
        LAUNCHES[self.counter] += 1
        return self.xs


def exchange_rows_multi(xs, msgs: Sequence[Message], ring: bool = False):
    """One launch moving ``msgs`` for every volume of ``xs`` (``xs[v][k]``:
    volume v's (RP, S_v, L_v) block on shard k; S and L may differ per
    volume), in place; returns ``xs``. Bounded edge shards keep their
    destination rows. Builds the table on each call: a caller that repeats
    a message set keeps a :class:`RowExchange`."""
    return RowExchange(xs, msgs, ring).run()


def exchange_ghost_rows(x: Sequence[torch.Tensor], b: int,
                        ring: bool = False):
    """Kernel 13: the axis-0 ghost refresh of one halo-layout volume
    (``x[k]``: shard k's (RP, S, L) block, rows [0, b) data), in place: row
    RP-1 takes the left link's row b-1, rows [b, b+2) the right link's rows
    [0, 2); bounded edge shards keep their slots. Returns ``x``. Like the
    JAX package's, no step calls it."""
    RowExchange((x,), ghost_messages(b, x[0].shape[0]), ring,
                counter="exchange_ghost_rows").run()
    return x
