"""Lagrangian tracer particles: MAC-aware interpolation and advection
(PyTorch).

Counterpart of ``navierstokessolver_tpu/tracers.py``. Positions live on the
device as one ``(n, nd)`` tensor; the interpolation is a vectorized gather
at the 2^nd corners, and ``Simulation.run_scan_tracers`` advects them after
every step with that step's dt from its device buffer, so tracking them
reads nothing on the host.

Component ``a`` is sampled on its face lattice (integer coordinates along
axis ``a``, cell centres on the others) with multilinear weights. Periodic
axes wrap; the others clamp to the outermost sample.

``seed_tracers`` draws JAX's positions: ``jax.random.uniform`` of
``PRNGKey(seed)`` (threefry2x32, the partitionable bit layout JAX uses
now), reproduced in numpy, so the same ``--tracer-seed`` seeds the same
tracers in both packages.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from .bcs import BCTable, periodic_axes
from .grid import GridSpec


def _face_axis_weights(x: torch.Tensor, h: float, n_cells: int):
    """Weights along a component's own (face) axis: samples at i*h, i =
    0..n_cells (a periodic axis's duplicate face included)."""
    s = x / h
    i0 = torch.clamp(torch.floor(s), 0, n_cells - 1).to(torch.int64)
    w = torch.clamp(s - i0, 0.0, 1.0)
    return i0, i0 + 1, w


def _center_axis_weights(x: torch.Tensor, h: float, n_cells: int,
                         wrap: bool):
    """Weights along a transverse (cell-centre) axis: samples at
    (i + 0.5)*h; periodic axes wrap, the others clamp."""
    s = x / h - 0.5
    if wrap:
        base = torch.floor(s)
        w = s - base
        i0 = torch.remainder(base.to(torch.int64), n_cells)
        i1 = torch.remainder(i0 + 1, n_cells)
    else:
        i0 = torch.clamp(torch.floor(s), 0, n_cells - 2).to(torch.int64)
        w = torch.clamp(s - i0, 0.0, 1.0)
        i1 = i0 + 1
    return i0, i1, w


def velocity_at(grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
                pos: torch.Tensor) -> torch.Tensor:
    """Multilinear MAC interpolation of the velocity at ``pos`` (n, nd);
    exact for fields (multi)linear in the coordinates."""
    nd = grid.ndim
    h = grid.spacing
    per = periodic_axes(grid, bcs)
    out = []
    for a in range(nd):
        idx0, idx1, ws = [], [], []
        for ax in range(nd):
            x = pos[:, ax]
            if ax == a:
                i0, i1, w = _face_axis_weights(x, h[ax], grid.shape[ax])
            else:
                i0, i1, w = _center_axis_weights(x, h[ax], grid.shape[ax],
                                                 per[ax])
            idx0.append(i0)
            idx1.append(i1)
            ws.append(w)
        val = torch.zeros(pos.shape[0], dtype=grid.dtype, device=pos.device)
        for corner in itertools.product((0, 1), repeat=nd):
            idx = tuple(idx1[ax] if c else idx0[ax]
                        for ax, c in enumerate(corner))
            wgt = torch.ones(pos.shape[0], dtype=grid.dtype,
                             device=pos.device)
            for ax, c in enumerate(corner):
                wgt = wgt * (ws[ax] if c else (1.0 - ws[ax]))
            val = val + wgt * u[a][idx]
        out.append(val)
    return torch.stack(out, dim=1)


def confine(grid: GridSpec, bcs: BCTable, pos: torch.Tensor) -> torch.Tensor:
    """Keep tracers in the domain: wrap periodic axes, clamp the rest."""
    per = periodic_axes(grid, bcs)
    cols = []
    for ax in range(grid.ndim):
        length = grid.lengths[ax]
        x = pos[:, ax]
        cols.append(torch.remainder(x, length) if per[ax]
                    else torch.clamp(x, 0.0, length))
    return torch.stack(cols, dim=1)


def advect_tracers(grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor],
                   pos: torch.Tensor, dt,
                   integrator: str = "rk2") -> torch.Tensor:
    """One explicit advection step of the positions: the midpoint rule
    (``rk2``, the default) or ``euler``. ``dt``: a Python float or a 0-d
    tensor on the positions' device."""
    v1 = velocity_at(grid, bcs, u, pos)
    if integrator == "euler":
        return confine(grid, bcs, pos + dt * v1)
    mid = confine(grid, bcs, pos + (0.5 * dt) * v1)
    v2 = velocity_at(grid, bcs, u, mid)
    return confine(grid, bcs, pos + dt * v2)


# -- JAX's uniform draw: threefry2x32 in numpy ---------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``, as JAX's ``threefry2x32_p`` computes it (uint32
    arithmetic, wrapping)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def jax_uniform(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` in float32:
    the key ``(seed >> 32, seed & 0xFFFFFFFF)``, one hash of each flat
    index's (high, low) 32-bit halves, the two words xor-ed, their top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    key = ((int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF)
    count = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(count, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    bits = b0 ^ b1
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(tuple(shape))


def seed_tracers(grid: GridSpec, n: int, seed: int = 0, margin: float = 0.05,
                 device="cuda") -> torch.Tensor:
    """``n`` deterministic uniform-random positions on ``device``, inset by
    ``margin`` (a fraction of each extent) from the boundaries: the JAX
    package's positions for the same seed."""
    unit = torch.from_numpy(jax_uniform(seed, (n, grid.ndim)))
    lo = torch.tensor([m * margin for m in grid.lengths], dtype=grid.dtype)
    span = torch.tensor([m * (1.0 - 2.0 * margin) for m in grid.lengths],
                        dtype=grid.dtype)
    return (lo + unit * span).to(device)
