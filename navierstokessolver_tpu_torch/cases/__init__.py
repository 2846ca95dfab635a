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

Registered, raising until what they need is ported:
  sphere        -- 3D obstacles
  kolmogorov    -- array (sinusoidal) forcing
  duct_periodic -- a body force in 3D
  pulsatile_channel -- a time-dependent body force
  oscillating_lid -- time-dependent BC values
  heated_enclosure -- buoyancy with an obstacle (an array force on the
                   unfused 2D route)

Each builder accepts the JAX package's overrides (so tests can shrink
grids) plus ``device``: the card (``"cuda"``) unless the caller names
another; without a CUDA device the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..grid import State
from ..solver import Simulation
from .cavity import build_cavity, build_cavity3d
from .convection import (
    build_heated_cavity, build_heated_enclosure, build_rayleigh_benard,
)
from .channel import (
    build_channel, build_channel_periodic, build_duct_periodic,
    build_pulsatile_channel,
)
from .cylinder import build_cylinder, build_sphere
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


def build_kolmogorov(**kw):
    """The JAX package's Kolmogorov flow: its sinusoidal force is an array
    (the jnp predictor in 2D, kernel 1's forcing volumes in 3D), which is
    not ported yet."""
    raise NotImplementedError(
        "kolmogorov (array forcing): not ported yet (ROADMAP Queue A, "
        "'Physics extensions')"
    )


def _physics_extension(name: str, needs: str) -> Callable[..., Case]:
    """The build function of a JAX case that needs a physics extension
    the port lacks: it raises, naming the ROADMAP item."""
    def build(**kw):
        raise NotImplementedError(
            f"{name} ({needs}): not ported yet (ROADMAP Queue A, 'Physics "
            "extensions')"
        )
    return build


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
    "oscillating_lid": _physics_extension(
        "oscillating_lid", "time-dependent BC values"),
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
