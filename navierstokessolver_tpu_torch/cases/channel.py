"""Poiseuille channel: parabolic inflow at x=0, outflow at x=Lx, no-slip
walls (PyTorch port).

Counterpart of ``navierstokessolver_tpu/cases/channel.py``: BASELINE config
#2 (256x64, inflow-outflow + no-slip). Oracle: the analytic parabolic
profile ``u(y) = 4 u_max y (Ly - y) / Ly^2`` is a steady solution of the
discrete system and must persist. The inflow profile is a BC value array
(bcs.py): the unfused 2D step reads it through the predictor kernel's
ghost table (ops/predictor2d.py) and the BC passes.

The body-forced channels of the JAX package (``channel_periodic``,
``duct_periodic``, ``pulsatile_channel``) are registered and raise: body
forcing is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bcs import BCSpec, apply_velocity_bcs
from ..grid import GridSpec, State
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation
from .cavity import _stable_dt


def parabolic_profile(grid: GridSpec, u_max: float) -> np.ndarray:
    """Inflow u(y) at the cell-centre heights (the u component's face
    slice), numpy float32: the JAX profile's arithmetic."""
    y = grid.cell_centers(1)
    ly = grid.lengths[1]
    return 4.0 * u_max * y * (ly - y) / (ly * ly)


def build_channel(
    shape=(256, 64),
    lengths=(4.0, 1.0),
    re: float = 100.0,
    u_max: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "mg",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    outlet: str = "outflow",
    device="cuda",
    **params_kw,
):
    """``device``: the card unless the caller names another; without a
    CUDA device the default raises. ``outlet="convective"`` is not ported
    yet and raises."""
    from . import Case

    if outlet != "outflow":
        raise NotImplementedError(
            f"outlet {outlet!r}: CONVECTIVE faces are not ported yet "
            "(ROADMAP Queue A, 'Other BC kinds')"
        )
    grid = GridSpec(shape=tuple(shape), lengths=tuple(lengths),
                    dtype=dtype or torch.float32)
    nu = u_max * grid.lengths[1] / re
    bcs = {
        (0, 0): BCSpec.inflow((parabolic_profile(grid, u_max), 0.0)),
        (0, 1): BCSpec.outflow(),
        (1, 0): BCSpec.wall((0.0, 0.0)),
        (1, 1): BCSpec.wall((0.0, 0.0)),
    }
    dt = dt if dt is not None else _stable_dt(grid, nu, u_max, upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
    )
    sim = Simulation.build(grid, bcs, params, device)
    return Case(
        name="channel",
        sim=sim,
        suggested_steps=int(8.0 / dt),
        description=f"Poiseuille channel Re={re} {shape}",
    )


def poiseuille_state(sim: Simulation, u_max: float = 1.0) -> State:
    """Exact steady state: parabolic u everywhere, v = 0, p = 0 (the linear
    pressure is left out, as in JAX)."""
    grid = sim.grid
    profile = torch.as_tensor(parabolic_profile(grid, u_max),
                              device=sim.device)
    st = sim.initial_state()
    u0 = profile[None, :].expand(grid.face_shape(0)).contiguous()
    u = apply_velocity_bcs(grid, sim.bcs, (u0, st.u[1]), sim.face_masks)
    return State(u=u, p=st.p, p_prev=st.p_prev)


def _body_forced(name: str):
    def build(**kw):
        raise NotImplementedError(
            f"{name} (body forcing): not ported yet (ROADMAP Queue A, "
            "'Physics extensions')"
        )
    build.__name__ = f"build_{name}"
    build.__doc__ = f"The JAX package's {name}: needs body forcing, which " \
        "is not ported yet."
    return build


build_channel_periodic = _body_forced("channel_periodic")
build_duct_periodic = _body_forced("duct_periodic")
build_pulsatile_channel = _body_forced("pulsatile_channel")
