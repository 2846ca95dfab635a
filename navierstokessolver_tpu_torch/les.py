"""Smagorinsky LES subgrid model on the staggered (MAC) grid (PyTorch).

Counterpart of ``navierstokessolver_tpu/les.py``, the whole module. The
resolved strain-rate tensor sets a local eddy viscosity

    nu_t = (Cs * Delta)^2 * |S|,      |S| = sqrt(2 S_ij S_ij),

and the subgrid stress divergence ``F_i = d/dx_j (2 nu_t S_ij)`` is added
to the momentum predictor as a per-face forcing term.

Staggering follows grid.py's MAC layout, as in the JAX module:

  * S_aa lives at cell centres (own-axis difference of component ``a``).
  * S_ab (a != b) lives at the edge points that are integer in axes a and b
    and half-integer elsewhere, with tangential ghosts from
    :func:`bcs.pad_transverse`.
  * nu_t is computed at centres and averaged to the S_ab points; beyond a
    wall it is edge-replicated (zero normal gradient), across a periodic
    face it wraps.
  * F_a comes out on the interior faces of component ``a``: the shape
    :func:`ops.stencils.predictor` takes as a forcing term.

Everything here is plain PyTorch on any device and in 2D or 3D.
:func:`eddy_viscosity` is the plain version of the ``nu_t_3d`` kernel and
:func:`sgs_forcing` the plain version of the LES term of the
``predictor_3d`` kernel (ops/predictor3d.py). The arithmetic is written in
the JAX module's order, so the two agree to float32 roundoff.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .bcs import BCTable, pad_transverse, periodic_axes
from .grid import GridSpec


@dataclasses.dataclass(frozen=True)
class LESConfig:
    """Smagorinsky model parameters.

    Attributes:
      cs:    Smagorinsky constant (0.1-0.2 typical; 0.17 is the classical
             Lilly value). Ignored by the dynamic model.
      delta: filter width. ``None`` = geometric mean of the grid spacings.
      model: "smagorinsky" (static cs) or "dynamic" (Germano-Lilly: one
             global coefficient per step from a 2x test filter).
      cs2_max: stability clip for the dynamic coefficient (Cs^2).
    """

    cs: float = 0.17
    delta: Optional[float] = None
    model: str = "smagorinsky"
    cs2_max: float = 0.09

    def filter_width(self, grid: GridSpec) -> float:
        if self.delta is not None:
            return float(self.delta)
        prod = 1.0
        for v in grid.spacing:
            prod *= v
        return float(prod ** (1.0 / grid.ndim))


def _sl(x: torch.Tensor, axis: int, start: int, stop: Optional[int] = None):
    """``x[start:stop]`` along ``axis`` (a view)."""
    n = x.shape[axis]
    start = start % n if start < 0 else start
    stop = n if stop is None else (stop % n if stop < 0 else stop)
    return x.narrow(axis, start, stop - start)


def _diff(arr: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    return (_sl(arr, axis, 1) - _sl(arr, axis, 0, -1)) / h


def _avg(arr: torch.Tensor, axis: int) -> torch.Tensor:
    return 0.5 * (_sl(arr, axis, 1) + _sl(arr, axis, 0, -1))


def strain_rates(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor]
) -> tuple[list[torch.Tensor], dict[tuple[int, int], torch.Tensor]]:
    """All distinct components of the resolved strain-rate tensor:
    ``(diag, off)`` with ``diag[a] = S_aa`` at cell centres and
    ``off[(a, b)] = S_ab`` (a < b) at the integer-(a,b) edge points (n+1
    along axes a and b, n elsewhere)."""
    nd = grid.ndim
    h = grid.spacing
    diag = [_diff(u[a], a, h[a]) for a in range(nd)]
    off: dict[tuple[int, int], torch.Tensor] = {}
    for a in range(nd):
        for b in range(a + 1, nd):
            # du_a/dx_b at the (a,b) edge: ghost-pad a's transverse axes,
            # difference along b, then strip the pad from the axes that are
            # neither a nor b
            pa = _diff(pad_transverse(grid, bcs, a, u[a]), b, h[b])
            pb = _diff(pad_transverse(grid, bcs, b, u[b]), a, h[a])
            for c in range(nd):
                if c != a and c != b:
                    pa = _sl(pa, c, 1, -1)
                    pb = _sl(pb, c, 1, -1)
            off[(a, b)] = 0.5 * (pa + pb)
    return diag, off


def _off_at_centers(off_ab: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return _avg(_avg(off_ab, a), b)


def _center_strain_tensor(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], raw=None
) -> tuple[dict[tuple[int, int], torch.Tensor], torch.Tensor]:
    """The strain tensor collocated at cell centres (off-diagonal entries
    averaged from their edge points) and ``|S| = sqrt(2 S_ij S_ij)``.
    ``raw``: a precomputed :func:`strain_rates` result."""
    nd = grid.ndim
    diag, off = raw if raw is not None else strain_rates(grid, bcs, u)
    S = {(a, a): diag[a] for a in range(nd)}
    for (a, b), s_ab in off.items():
        S[(a, b)] = _off_at_centers(s_ab, a, b)
    s2 = sum(S[(a, a)] * S[(a, a)] for a in range(nd))
    for a in range(nd):
        for b in range(a + 1, nd):
            s2 = s2 + 2.0 * S[(a, b)] * S[(a, b)]
    return S, torch.sqrt(2.0 * s2)


def _pad_cells(
    grid: GridSpec, bcs: BCTable, arr: torch.Tensor, axis: int
) -> torch.Tensor:
    """One ghost cell on each side along ``axis``: wrap when periodic,
    edge-replicate (zero normal gradient) otherwise."""
    if periodic_axes(grid, bcs)[axis]:
        lo, hi = _sl(arr, axis, -1), _sl(arr, axis, 0, 1)
    else:
        lo, hi = _sl(arr, axis, 0, 1), _sl(arr, axis, -1)
    return torch.cat([lo, arr, hi], dim=axis)


def test_filter(grid: GridSpec, bcs: BCTable, f: torch.Tensor) -> torch.Tensor:
    """2x top-hat test filter of a cell-centred field: the separable
    trapezoidal kernel [1/4, 1/2, 1/4] per axis (wrap on periodic axes,
    edge-replicate otherwise). Preserves constants exactly."""
    for ax in range(grid.ndim):
        fp = _pad_cells(grid, bcs, f, ax)
        f = (0.25 * _sl(fp, ax, 0, -2) + 0.5 * _sl(fp, ax, 1, -1)
             + 0.25 * _sl(fp, ax, 2))
    return f


def _centered_velocity(
    grid: GridSpec, u: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Velocity components averaged from their faces to cell centres."""
    return [_avg(u[a], a) for a in range(grid.ndim)]


def dynamic_cs2(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], cfg: LESConfig,
    strains=None,
) -> torch.Tensor:
    """Germano-Lilly dynamic coefficient ``Cs^2`` (a 0-d tensor):

        L_ij = F(u_i u_j) - F(u_i) F(u_j)
        M_ij = 2 Delta^2 [ F(|S| S_ij) - 4 |S~| S~_ij ],  S~_ij = F(S_ij)
        Cs^2 = < L_ij M_ij > / < M_ij M_ij >,  clipped to [0, cs2_max]

    with F the 2x test filter and <.> a global sum."""
    nd = grid.ndim
    S, mag = (strains if strains is not None
              else _center_strain_tensor(grid, bcs, u))
    dev = mag.device
    uc = _centered_velocity(grid, u)
    fuc = [test_filter(grid, bcs, c) for c in uc]
    Sf = {k: test_filter(grid, bcs, v) for k, v in S.items()}
    s2f = sum(Sf[(a, a)] * Sf[(a, a)] for a in range(nd))
    for a in range(nd):
        for b in range(a + 1, nd):
            s2f = s2f + 2.0 * Sf[(a, b)] * Sf[(a, b)]
    magf = torch.sqrt(2.0 * s2f)
    delta2 = torch.tensor(cfg.filter_width(grid) ** 2, dtype=grid.dtype,
                          device=dev)
    num = torch.zeros((), dtype=grid.dtype, device=dev)
    den = torch.zeros((), dtype=grid.dtype, device=dev)
    for a in range(nd):
        for b in range(a, nd):
            mult = 1.0 if a == b else 2.0   # symmetric-tensor multiplicity
            L = test_filter(grid, bcs, uc[a] * uc[b]) - fuc[a] * fuc[b]
            M = 2.0 * delta2 * (
                test_filter(grid, bcs, mag * S[(a, b)])
                - 4.0 * magf * Sf[(a, b)]
            )
            num = num + mult * torch.sum(L * M)
            den = den + mult * torch.sum(M * M)
    cs2 = num / torch.clamp(den, min=1e-30)
    return torch.clamp(cs2, 0.0, cfg.cs2_max)


def eddy_viscosity(
    grid: GridSpec, bcs: BCTable, u: Sequence[torch.Tensor], cfg: LESConfig,
    raw_strains=None,
) -> torch.Tensor:
    """Cell-centred Smagorinsky eddy viscosity ``Cs^2 Delta^2 |S|`` (static
    ``cs``, or the Germano-Lilly dynamic coefficient). ``Cs^2`` is formed
    as a float32 scalar first and then scaled by ``Delta^2``, as the JAX
    module does."""
    S, mag = _center_strain_tensor(grid, bcs, u, raw=raw_strains)
    if cfg.model == "dynamic":
        cs2 = dynamic_cs2(grid, bcs, u, cfg, strains=(S, mag))
    elif cfg.model == "smagorinsky":
        cs2 = torch.tensor(cfg.cs * cfg.cs, dtype=grid.dtype,
                           device=mag.device)
    else:
        raise ValueError(f"unknown LES model {cfg.model!r}")
    scale = cs2 * cfg.filter_width(grid) ** 2
    return (scale * mag).to(grid.dtype)


def sgs_forcing(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[torch.Tensor],
    cfg: Optional[LESConfig],
    nu_t: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """Subgrid momentum forcing ``F_a = d/dx_b (2 nu_t S_ab)`` per component,
    on the interior faces along each component's own axis (all n faces
    when that axis is periodic), full cell extent on the others.

    ``nu_t`` overrides the viscosity from ``cfg`` with a cell-centred
    tensor (``cfg`` is then unused and may be None).
    """
    nd = grid.ndim
    h = grid.spacing
    per = periodic_axes(grid, bcs)
    diag, off = strain_rates(grid, bcs, u)
    if nu_t is None:
        nu_t = eddy_viscosity(grid, bcs, u, cfg, raw_strains=(diag, off))

    def nu_at_edge(a: int, b: int) -> torch.Tensor:
        # pad one ghost cell along a and b, average the 4 surrounding centres
        x = _pad_cells(grid, bcs, nu_t, a)
        x = _pad_cells(grid, bcs, x, b)
        return _avg(_avg(x, a), b)

    out = []
    for a in range(nd):
        # diagonal: d/dx_a (2 nu_t S_aa), centres -> faces of a
        tau = 2.0 * nu_t * diag[a]
        if per[a]:
            tau = torch.cat([_sl(tau, a, -1), tau], dim=a)
        f = _diff(tau, a, h[a])
        # off-diagonal: d/dx_b (2 nu_t S_ab), edges -> faces of a
        for b in range(nd):
            if b == a:
                continue
            key = (min(a, b), max(a, b))
            tau_ab = 2.0 * nu_at_edge(*key) * off[key]
            g = _diff(tau_ab, b, h[b])
            # along a the edge points sit at all faces 0..n: keep the
            # interior ones (faces 0..n-1 on a periodic axis)
            g = _sl(g, a, 0, -1) if per[a] else _sl(g, a, 1, -1)
            f = f + g
        out.append(f.to(grid.dtype))
    return tuple(out)
