"""Case registry of the PyTorch port.

Ported so far:
  cavity        -- 2D lid-driven cavity, Re=100, 64x64 (BASELINE config #1)
  channel       -- 2D Poiseuille channel, inflow profile / outflow / no-slip
                   walls, 256x64 (BASELINE config #2)
  cylinder      -- 2D flow past a cylinder, Re=200, 512x256 (BASELINE config
                   #3), staircase or (``ibm=True``) sharp-interface obstacle
  cavity_hi_re  -- 2D cavity, Re=1e4, 2048^2, fft, upwind gamma 0.8
                   (BASELINE config #4)
  cavity3d      -- 3D lid-driven cavity, 256^3 (BASELINE config #5)
  taylor_green  -- 2D Taylor-Green vortex, fully periodic, analytic decay
  taylor_green3d -- 3D Taylor-Green vortex, fully periodic, Re 1600
  decaying_turbulence -- 2D periodic turbulence, inverse-cascade oracle
  channel_periodic -- 2D channel, periodic along x, driven by a static
                   body force (the Poiseuille parabola persists)
  heated_cavity -- de Vahl Davis natural convection (2D and 3D; the fused
                   kernels' thermal modes)
  rayleigh_benard -- periodic-x convection, the critical-Ra oracle
  heated_cylinder -- forced convection from an isothermal cylinder (a
                   passive scalar on the unfused route)
  kolmogorov    -- a periodic box driven by a sinusoidal force (2D and 3D;
                   a forcing volume of kernels 4 and 1)
  duct_periodic -- the body-force-driven periodic duct (kernel 1's static
                   force), the exact series profile
  pulsatile_channel -- the Womersley channel, a force that is a callable of
                   t (kernel 4's force entry refilled each step)
  oscillating_lid -- the cavity whose lid velocity is a callable of t (3D
                   and 2D; the fused kernels' wall entry refilled each step)
  heated_enclosure -- a hot cylinder in a cold enclosure (buoyancy around
                   an obstacle: a forcing volume of the unfused route's
                   predictor kernel)
  sphere        -- 3D flow past a sphere, Re=300, 256x128x128: inflow,
                   outflow, slip walls and the staircase sphere (the fused
                   3D kernels' masked mode, the 3D dctcg)

Each builder accepts the JAX package's overrides (so tests can shrink
grids) plus ``device``: the card (``"cuda"``) unless the caller names
another; without a CUDA device the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..grid import State
from ..solver import Simulation
from .cavity import build_cavity, build_cavity3d, build_oscillating_lid
from .convection import (
    build_heated_cavity, build_heated_enclosure, build_rayleigh_benard,
)
from .channel import (
    build_channel, build_channel_periodic, build_duct_periodic,
    build_pulsatile_channel,
)
from .cylinder import build_cylinder, build_sphere
from .kolmogorov import build_kolmogorov
from .taylor_green import build_taylor_green, build_taylor_green3d
from .turbulence import build_decaying_turbulence


@dataclasses.dataclass(eq=False)
class Case:
    name: str
    sim: Simulation
    suggested_steps: int
    description: str = ""
    # the case's own initial field from its Simulation (None: at rest)
    init: Optional[Callable[[Simulation], State]] = None

    def initial_state(self) -> State:
        if self.init is not None:
            return self.init(self.sim)
        return self.sim.initial_state()


_REGISTRY: dict[str, Callable[..., Case]] = {
    "cavity": build_cavity,
    "cavity_hi_re": lambda **kw: build_cavity(
        **{
            "shape": (2048, 2048),
            "re": 10_000.0,
            "poisson_method": "fft",
            "upwind_gamma": 0.8,
            **kw,
        }
    ),
    "cavity3d": build_cavity3d,
    "oscillating_lid": build_oscillating_lid,
    "channel": build_channel,
    "channel_periodic": build_channel_periodic,
    "duct_periodic": build_duct_periodic,
    "pulsatile_channel": build_pulsatile_channel,
    "cylinder": build_cylinder,
    "heated_cylinder": lambda **kw: build_cylinder(**{"heated": True, **kw}),
    "decaying_turbulence": build_decaying_turbulence,
    "heated_cavity": build_heated_cavity,
    "heated_enclosure": build_heated_enclosure,
    "kolmogorov": build_kolmogorov,
    "rayleigh_benard": build_rayleigh_benard,
    "sphere": build_sphere,
    "taylor_green": build_taylor_green,
    "taylor_green3d": build_taylor_green3d,
}


def available_cases() -> list[str]:
    return sorted(_REGISTRY)


def make_case(name: str, **overrides) -> Case:
    if name not in _REGISTRY:
        raise KeyError(f"unknown case {name!r}; available: {available_cases()}")
    return _REGISTRY[name](**overrides)
