"""Running flow statistics accumulated after every step (PyTorch).

Counterpart of ``navierstokessolver_tpu/stats.py``: time-averaged fields and
Reynolds stresses by Welford's incremental moments, carried on the device
beside the state (``Simulation.run_scan_stats``), so collecting them costs
a few elementwise passes a step and no host read; memory stays O(grid).

Welford, not naive sums: a float32 running sum loses the new sample's low
bits once ``n`` is large; Welford keeps the carried quantities at the scale
of the fields. Per step and field:

    d1    = x - mean            # deviation from the OLD mean
    mean' = mean + d1 / n
    M2'   = M2 + d1 * (x - mean')
    C'    = C  + d1x * (y - mean_y')   # the cross terms

``finalize`` divides by n (population normalization). Velocities are
interpolated to cell centres first, where the cross moments live.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from .grid import GridSpec, State, interpolate_to_centers


@dataclasses.dataclass
class FlowStats:
    """Welford accumulator over cell-centred fields, tensors on one device.

    ``mean_u``/``m2_u`` have one entry per velocity component; ``c_uv`` one
    per unordered component pair in ``itertools.combinations`` order (2D
    ``(01,)``, 3D ``(01, 02, 12)``). The theta entries are None without a
    transported scalar."""

    n: torch.Tensor                # 0-d int32 sample count: exact to 2^31,
                                   # where a float32 count freezes at 2^24
    mean_u: tuple[torch.Tensor, ...]
    m2_u: tuple[torch.Tensor, ...]
    c_uv: tuple[torch.Tensor, ...]
    mean_p: torch.Tensor
    m2_p: torch.Tensor
    mean_theta: Optional[torch.Tensor] = None
    m2_theta: Optional[torch.Tensor] = None


def pair_indices(ndim: int) -> tuple[tuple[int, int], ...]:
    """Component pairs of the off-diagonal Reynolds-stress entries."""
    return tuple(itertools.combinations(range(ndim), 2))


def init_stats(grid: GridSpec, with_theta: bool = False,
               device="cuda") -> FlowStats:
    """A zero accumulator of the grid's cell-centred shapes on ``device``."""
    def z():
        return torch.zeros(grid.shape, dtype=grid.dtype, device=device)

    nd = grid.ndim
    return FlowStats(
        n=torch.zeros((), dtype=torch.int32, device=device),
        mean_u=tuple(z() for _ in range(nd)),
        m2_u=tuple(z() for _ in range(nd)),
        c_uv=tuple(z() for _ in pair_indices(nd)),
        mean_p=z(),
        m2_p=z(),
        mean_theta=z() if with_theta else None,
        m2_theta=z() if with_theta else None,
    )


def _welford(mean, m2, x, inv_n):
    d1 = x - mean
    mean_new = mean + d1 * inv_n
    return mean_new, m2 + d1 * (x - mean_new), d1


def accumulate(grid: GridSpec, stats: FlowStats, state: State) -> FlowStats:
    """One Welford update from ``state``, on its device; reads nothing on
    the host."""
    n = stats.n + 1
    # the ratio in the field dtype; the int32 count itself stays exact
    inv_n = 1.0 / n.to(state.p.dtype)
    uc = interpolate_to_centers(grid, state.u)
    mean_u, m2_u, d1 = [], [], []
    for a, x in enumerate(uc):
        m, s, d = _welford(stats.mean_u[a], stats.m2_u[a], x, inv_n)
        mean_u.append(m)
        m2_u.append(s)
        d1.append(d)
    c_uv = tuple(
        c + d1[i] * (uc[j] - mean_u[j])
        for c, (i, j) in zip(stats.c_uv, pair_indices(grid.ndim))
    )
    mean_p, m2_p, _ = _welford(stats.mean_p, stats.m2_p, state.p, inv_n)
    mean_theta, m2_theta = stats.mean_theta, stats.m2_theta
    if mean_theta is not None and state.theta is not None:
        mean_theta, m2_theta, _ = _welford(mean_theta, m2_theta, state.theta,
                                           inv_n)
    return FlowStats(n=n, mean_u=tuple(mean_u), m2_u=tuple(m2_u), c_uv=c_uv,
                     mean_p=mean_p, m2_p=m2_p, mean_theta=mean_theta,
                     m2_theta=m2_theta)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_arrays(stats: FlowStats) -> dict:
    """Named numpy arrays (the checkpoint's ``stats_*`` entries)."""
    out = {"n": _host(stats.n)}
    for a, x in enumerate(stats.mean_u):
        out[f"mean_u_{a}"] = _host(x)
        out[f"m2_u_{a}"] = _host(stats.m2_u[a])
    for i, c in enumerate(stats.c_uv):
        out[f"c_uv_{i}"] = _host(c)
    out["mean_p"] = _host(stats.mean_p)
    out["m2_p"] = _host(stats.m2_p)
    if stats.mean_theta is not None:
        out["mean_theta"] = _host(stats.mean_theta)
        out["m2_theta"] = _host(stats.m2_theta)
    return out


def from_arrays(d: dict, dtype=torch.float32, device="cuda") -> FlowStats:
    """Inverse of :func:`to_arrays`, the tensors on ``device``."""
    nd = sum(1 for k in d if k.startswith("mean_u_"))
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))

    def j(k):
        return torch.from_numpy(np.array(d[k], dtype=np_dtype)).to(device)

    return FlowStats(
        # float32 in checkpoints written before the count became int32
        n=torch.tensor(int(np.asarray(d["n"])), dtype=torch.int32,
                       device=device),
        mean_u=tuple(j(f"mean_u_{a}") for a in range(nd)),
        m2_u=tuple(j(f"m2_u_{a}") for a in range(nd)),
        c_uv=tuple(j(f"c_uv_{i}") for i in range(len(pair_indices(nd)))),
        mean_p=j("mean_p"),
        m2_p=j("m2_p"),
        mean_theta=j("mean_theta") if "mean_theta" in d else None,
        m2_theta=j("m2_theta") if "m2_theta" in d else None,
    )


def finalize(stats: FlowStats) -> dict:
    """Moments -> named numpy fields: ``u_mean_<i>``, ``p_mean``,
    ``theta_mean``, the Reynolds stresses ``uu_<i><j>`` (i <= j), ``p_var``,
    ``theta_var`` and the sample count ``n``."""
    n = float(stats.n)
    if n <= 0:
        raise ValueError("no samples accumulated")
    out = {"n": np.asarray(n)}
    nd = len(stats.mean_u)
    for a in range(nd):
        out[f"u_mean_{a}"] = _host(stats.mean_u[a])
        out[f"uu_{a}{a}"] = _host(stats.m2_u[a]) / n
    for c, (i, j) in zip(stats.c_uv, pair_indices(nd)):
        out[f"uu_{i}{j}"] = _host(c) / n
    out["p_mean"] = _host(stats.mean_p)
    out["p_var"] = _host(stats.m2_p) / n
    if stats.mean_theta is not None:
        out["theta_mean"] = _host(stats.mean_theta)
        out["theta_var"] = _host(stats.m2_theta) / n
    return out
