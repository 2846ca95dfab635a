"""Carry state and constants across from the JAX package, as numpy arrays.

The JAX package and this port store the same quantities in the same MAC
layout, with two exceptions: the JAX DCT solver keeps its spectral
multiplier axis-reversed (its tensordot chain leaves the spectrum that way),
while the port keeps natural axis order (both permute each axis to its
plan's block order); and the JAX immersed-boundary operator keeps
full-field arrays where the port keeps them cropped to a box. These functions take the JAX
package's arrays as numpy (``np.asarray(jax_array)``) and give the port's
objects, so a test can feed both packages the same state and constants.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .grid import GridSpec, State
from .ibm import IBMForcing
from .les import LESConfig
from .scalar import ScalarBC, ScalarBCKind, ScalarConfig
from .ops import dct as dct_mod
from .ops.fft_poisson import DCTPCGSolver, DCTPoissonSolver
from .ops.multigrid import MGPoissonSolver
from .ops.poisson import PoissonOp


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(device)


def state_from_numpy(
    u: Sequence[np.ndarray], p: np.ndarray, device="cpu",
    p_prev: Optional[np.ndarray] = None,
    theta: Optional[np.ndarray] = None,
    t: Optional[np.ndarray] = None,
) -> State:
    """A port State from the velocity components, the pressure, (for the
    extrapolated warm start) the previous pressure, the transported scalar
    and (a time-dependent run) the time."""
    def opt(x):
        return None if x is None else _f32(x, device)

    return State(u=tuple(_f32(c, device) for c in u), p=_f32(p, device),
                 theta=opt(theta), p_prev=opt(p_prev), t=opt(t))


def force_volumes_from_numpy(
    grid: GridSpec, periodic: Sequence[bool],
    forcing: Sequence[Optional[np.ndarray]], device="cpu",
) -> tuple[Optional[torch.Tensor], ...]:
    """The port's forcing volumes (``ops.fused3d.force_shape``: the
    interior faces of a bounded own axis, all n of a periodic one) from
    the JAX package's forcing arrays as numpy, each broadcast to its
    component's layout as JAX's predictor adds it; None stays None."""
    from .ops.fused3d import force_shape

    return tuple(
        None if f is None else _f32(np.broadcast_to(
            np.asarray(f, dtype=np.float32),
            force_shape(grid, periodic, a)), device)
        for a, f in enumerate(forcing))


def state_to_numpy(state: State, with_theta: bool = False) -> tuple:
    """``(u components, p)`` as host numpy arrays; with ``with_theta``
    ``(u components, p, theta)``, theta None when the state has none."""
    out = (tuple(c.detach().cpu().numpy() for c in state.u),
           state.p.detach().cpu().numpy())
    if with_theta:
        out += (None if state.theta is None
                else state.theta.detach().cpu().numpy(),)
    return out


def scalar_config_from_jax(cfg) -> ScalarConfig:
    """The port's ScalarConfig with the fields of a JAX
    ``scalar.ScalarConfig`` (its BC kinds by value; array values and the
    initial field as numpy)."""
    def bc(b):
        v = b.value
        v = float(v) if np.ndim(v) == 0 else np.asarray(v)
        return ScalarBC(ScalarBCKind(b.kind.value), v)

    init = cfg.theta_init
    return ScalarConfig(
        bcs={k: bc(b) for k, b in cfg.bcs.items()},
        diffusivity=float(cfg.diffusivity),
        buoyancy=tuple(float(b) for b in cfg.buoyancy),
        theta_ref=float(cfg.theta_ref),
        upwind_gamma=float(cfg.upwind_gamma),
        theta_init=None if init is None else np.asarray(init),
        body_bc=None if cfg.body_bc is None else bc(cfg.body_bc),
    )


def poisson_op_from_numpy(
    diag: np.ndarray,
    code: np.ndarray,
    w: Sequence[float],
    singular: bool,
    inv_fluid_count: float,
    periodic: Sequence[bool] = (),
    device="cpu",
) -> PoissonOp:
    """A port PoissonOp from a JAX ``PoissonOp``'s fields."""
    return PoissonOp(
        diag=_f32(diag, device),
        code=torch.from_numpy(np.array(code, dtype=np.uint8)).to(device),
        w=tuple(float(x) for x in w),
        singular=bool(singular),
        inv_fluid_count=float(inv_fluid_count),
        periodic=tuple(bool(x) for x in periodic),
    )


def mg_solver_from_numpy(
    levels: Sequence[tuple],
    pre: int = 2,
    post: int = 2,
    coarse_iters: int = 60,
    omega: float = 1.0,
    coarse_omega: float = 1.0,
    device="cpu",
    use_pallas: bool = False,
    fused: Optional[bool] = None,
) -> MGPoissonSolver:
    """A port MGPoissonSolver from a JAX one's hierarchy: ``levels`` holds,
    finest first, each level operator's ``(diag, code, w, singular,
    inv_fluid_count, periodic)``. ``fused=None``: on for a CUDA
    ``device``, as ``MGPoissonSolver.build`` decides."""
    device = torch.device(device)
    return MGPoissonSolver(
        ops=[poisson_op_from_numpy(*lv, device=device) for lv in levels],
        pre=pre, post=post, coarse_iters=coarse_iters, omega=float(omega),
        coarse_omega=float(coarse_omega), use_pallas=use_pallas,
        fused=device.type == "cuda" if fused is None else fused,
    )


def dct_solver_from_numpy(
    grid: GridSpec,
    inv_eig_reversed: np.ndarray,
    fwd: Sequence[Optional[np.ndarray]],
    inv: Sequence[Optional[np.ndarray]],
    kinds: Optional[Sequence[str]] = None,
    refine: int = 1,
    device="cpu",
    d4: Optional[Sequence[Sequence[np.ndarray]]] = None,
    fuse_trailing: bool = False,
    precision: str = "high",
    refine_precision: str = "high",
) -> DCTPoissonSolver:
    """A port DCTPoissonSolver from a JAX one: ``inv_eig_reversed`` is its
    ``inv_eig`` (axis-reversed, each axis in its plan's block order),
    ``fwd``/``inv`` its per-axis ``plans[a].base_fwd`` and
    ``plans[a].base_inv``, and ``d4`` its per-axis ``plans[a].d4`` (the
    split levels' factors; None for dense plans; a periodic axis's dense
    circulant plan carries over as it is). An axis whose ``fwd`` is
    None (a JAX ``Dct4SplitPlan``, which holds no such matrix) takes the
    port's own split DCT-IV of its kind, built from the same formulas.
    ``fuse_trailing``, ``precision``, ``refine_precision``: the JAX
    solver's fields of those names."""
    nd = grid.ndim
    inv_nat = np.transpose(np.asarray(inv_eig_reversed), tuple(range(nd - 1, -1, -1)))
    kinds = tuple(kinds) if kinds is not None else ("nn",) * nd
    d4 = d4 if d4 is not None else [()] * nd
    plans = tuple(
        dct_mod.Dct4SplitPlan(grid.shape[a], grid.dtype, device,
                              flipped=(kinds[a] == "dn"))
        if f is None else
        dct_mod.SplitPlan([np.asarray(m) for m in lv], np.asarray(f),
                          np.asarray(i), grid.dtype, device)
        for a, (lv, f, i) in enumerate(zip(d4, fwd, inv))
    )
    return DCTPoissonSolver(
        grid=grid,
        inv_eig=_f32(inv_nat, device),
        plans=plans,
        precision=precision,
        refine=refine,
        refine_precision=refine_precision,
        kinds=kinds,
        fuse_trailing=fuse_trailing,
    )


def dctcg_solver_from_numpy(
    dct: DCTPoissonSolver,
    cap_cinv: Optional[np.ndarray] = None,
    cap_va: Optional[np.ndarray] = None,
    cap_vb: Optional[np.ndarray] = None,
    cap_idx_a: Optional[np.ndarray] = None,
    cap_idx_b: Optional[np.ndarray] = None,
    cap_vx: Optional[np.ndarray] = None,
    cap_vy: Optional[np.ndarray] = None,
    cap_fx: Optional[np.ndarray] = None,
    cap_fy: Optional[np.ndarray] = None,
    cap_wbox: Optional[np.ndarray] = None,
    cap_origin: Optional[tuple[int, ...]] = None,
) -> DCTPCGSolver:
    """A port DCTPCGSolver from a JAX one's fields, around ``dct`` (its
    ``dct``, carried across by :func:`dct_solver_from_numpy` with
    ``refine=0``). The capacitance arrays need no relayout: ``cap_vx``,
    ``cap_fx`` belong to axis 0 and ``cap_vy``, ``cap_fy`` to axis 1 in
    both packages (the packages apply them to spectra of opposite axis
    order); a 3D solver's ``cap_wbox`` (W over the links' box) and
    ``cap_origin`` are the same in both."""
    device = dct.inv_eig.device

    def opt(x):
        return None if x is None else _f32(x, device)

    return DCTPCGSolver(
        dct=dct, cap_cinv=opt(cap_cinv), cap_va=opt(cap_va),
        cap_vb=opt(cap_vb), cap_vx=opt(cap_vx), cap_vy=opt(cap_vy),
        cap_fx=opt(cap_fx), cap_fy=opt(cap_fy),
        cap_idx_a=None if cap_idx_a is None else np.asarray(cap_idx_a),
        cap_idx_b=None if cap_idx_b is None else np.asarray(cap_idx_b),
        cap_wbox=opt(cap_wbox),
        cap_origin=None if cap_origin is None else tuple(
            int(o) for o in cap_origin),
    )


def ibm_from_numpy(
    grid: GridSpec,
    dirs: Sequence[tuple[int, int]],
    masks: Sequence[Sequence[np.ndarray]],
    w: Sequence[np.ndarray],
    band: Sequence[np.ndarray],
    device="cpu",
    ub: Optional[Sequence[np.ndarray]] = None,
    wet: Optional[Sequence[np.ndarray]] = None,
    ub_wet: Optional[Sequence[np.ndarray]] = None,
) -> IBMForcing:
    """A port IBMForcing from a JAX one's full-field arrays (its ``box``,
    aligned to the TPU's tiles, is not carried: the port crops to its own
    unaligned box)."""
    def arrs(t):
        return None if t is None else [np.asarray(x) for x in t]

    return IBMForcing.from_numpy(
        grid, dirs, [arrs(m) for m in masks], arrs(w), arrs(band), device,
        ub=arrs(ub), wet=arrs(wet), ub_wet=arrs(ub_wet),
    )


def les_config_from_jax(cfg) -> LESConfig:
    """The port's LESConfig with the fields of a JAX ``les.LESConfig``."""
    return LESConfig(cs=float(cfg.cs),
                     delta=None if cfg.delta is None else float(cfg.delta),
                     model=str(cfg.model), cs2_max=float(cfg.cs2_max))
