"""The step size as the kernels read it: one small float32 device buffer.

The kernels that use the step size (the fused predictors and correctors,
the LES predictor and the 2D per-component predictor) read it from a
buffer on the card, as the JAX kernels read theirs from scalar memory,
so a CFL-adaptive dt computed on the device reaches them without a host
read. The buffer holds three float32 values,

    [dt, rho/dt, dt/rho]

each formed in float32 as the JAX step forms it from a traced dt
(``jnp.asarray(rho, f32) / dt`` and ``dt / rho`` with dt a float32
array). The predictors read elements 0 and 1, the correctors element 2
(their ``scale``).

:func:`constant` builds the buffer of a fixed dt once (it is cached), and
:func:`from_tensor` forms it on the device from a 0-d dt tensor, with
PyTorch operations that never read the host.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

Step = Union[float, torch.Tensor]
# JAX's _dt_from_vel floor on the CFL reduction
VEL_FLOOR = 1e-12


def values(dt: float, rho: float) -> list[float]:
    """``[dt, rho/dt, dt/rho]`` for a fixed dt, in float32 arithmetic."""
    d, r = np.float32(dt), np.float32(rho)
    return [float(d), float(r / d), float(d / r)]


@functools.lru_cache(maxsize=64)
def _on_device(vals: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32, device=device)


def constant(dt: float, rho: float, device) -> torch.Tensor:
    """The buffer of a fixed dt on ``device``, built once for each
    (dt, rho, device): a wrapper called with a Python float dt in a loop
    copies nothing from the host after its first call. Every caller gets
    the same tensor, which nothing writes."""
    return _on_device(tuple(values(dt, rho)), torch.device(device))


def from_tensor(dt: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """The buffer of a 0-d float32 dt on its device; ``rho`` a 0-d float32
    tensor there (a true division on both sides, never a multiply by a
    reciprocal)."""
    return torch.stack((dt, rho / dt, dt / rho))


def buffer(dt: Step, rho: float, device) -> torch.Tensor:
    """The buffer of ``dt`` (a Python float or a 0-d tensor) on
    ``device``."""
    if isinstance(dt, torch.Tensor):
        dt = dt.to(device=device, dtype=torch.float32).reshape(())
        return from_tensor(dt, torch.full((), rho, dtype=torch.float32,
                                          device=device))
    return constant(float(dt), float(rho), torch.device(device))


def scalar(x: Step, device, what: str) -> torch.Tensor:
    """A float32 value the kernel reads through a pointer: a Python float
    as a cached one-element buffer, a tensor of one element as it is (on
    ``device``, float32, or ValueError / TypeError)."""
    if not isinstance(x, torch.Tensor):
        return _on_device((float(np.float32(x)),), torch.device(device))
    if x.numel() != 1:
        raise ValueError(f"{what}: one value, got shape {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{what}: on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {x.dtype}, expected torch.float32")
    return x


def check(dts: torch.Tensor, device, what: str) -> torch.Tensor:
    """Raise unless ``dts`` is a buffer of this module on ``device``."""
    if not isinstance(dts, torch.Tensor) or dts.dtype != torch.float32:
        raise TypeError(f"{what}: a float32 step-size buffer expected")
    if tuple(dts.shape) != (3,) or not dts.is_contiguous():
        raise ValueError(f"{what}: shape {tuple(dts.shape)}, expected (3,)")
    if dts.device != device:
        raise ValueError(f"{what}: on {dts.device}, expected {device}")
    return dts
