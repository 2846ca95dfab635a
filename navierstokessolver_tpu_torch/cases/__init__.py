"""Case registry of the PyTorch port.

Ported so far:
  cavity    -- 2D lid-driven cavity, Re=100, 64x64 (BASELINE config #1)
  cavity3d  -- 3D lid-driven cavity, 256^3 (BASELINE config #5)
  cylinder  -- 2D flow past a cylinder, Re=200, 512x256 (BASELINE config
               #3), staircase or (``ibm=True``) sharp-interface obstacle
  sphere    -- registered; raises (3D obstacles are not ported yet)
  taylor_green3d -- 3D Taylor-Green vortex, fully periodic, Re 1600
  taylor_green   -- registered; raises (2D periodic faces are not ported
                    yet)

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
from .cylinder import build_cylinder, build_sphere
from .taylor_green import build_taylor_green, build_taylor_green3d


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
    "cavity3d": build_cavity3d,
    "cylinder": build_cylinder,
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
