"""Case registry of the PyTorch port.

Ported so far:
  cavity    -- 2D lid-driven cavity, Re=100, 64x64 (BASELINE config #1)
  cavity3d  -- 3D lid-driven cavity, 256^3 (BASELINE config #5)

Each builder accepts the JAX package's overrides (so tests can shrink
grids) plus ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..grid import State
from ..solver import Simulation
from .cavity import build_cavity, build_cavity3d


@dataclasses.dataclass(eq=False)
class Case:
    name: str
    sim: Simulation
    suggested_steps: int
    description: str = ""

    def initial_state(self) -> State:
        return self.sim.initial_state()


_REGISTRY: dict[str, Callable[..., Case]] = {
    "cavity": build_cavity,
    "cavity3d": build_cavity3d,
}


def available_cases() -> list[str]:
    return sorted(_REGISTRY)


def make_case(name: str, **overrides) -> Case:
    if name not in _REGISTRY:
        raise KeyError(f"unknown case {name!r}; available: {available_cases()}")
    return _REGISTRY[name](**overrides)
