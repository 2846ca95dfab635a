"""Spectral diagnostics of periodic 2D fields: the radial kinetic-energy
spectrum and the total kinetic energy.

The port's copy of ``navierstokessolver_tpu/utils/spectra.py`` (numpy,
post-processing, not step-loop code). A state's tensors come to the host
with ``.cpu().numpy()`` (one device-to-host copy a call).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..grid import GridSpec


def _centers(grid: GridSpec, u: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """The face-normal velocities averaged to the cell centres, as numpy
    arrays on the host."""
    out = []
    for a, comp in enumerate(u):
        c = np.asarray(comp.detach().cpu().numpy())
        lo = [slice(None)] * grid.ndim
        hi = [slice(None)] * grid.ndim
        lo[a], hi[a] = slice(0, -1), slice(1, None)
        out.append(0.5 * (c[tuple(lo)] + c[tuple(hi)]))
    return out


def energy_spectrum_2d(grid: GridSpec,
                       u: Sequence[torch.Tensor]) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """Radially binned kinetic-energy spectrum E(k) of a 2D periodic field.

    Returns (k, E) with integer wavenumber shells k = 1..n/2; the total
    0.5 <|u|^2> equals sum(E) by Parseval (up to the interpolation to cell
    centres). Wavenumbers are in box units (k = 1: one wavelength per
    domain length)."""
    if grid.ndim != 2:
        raise ValueError("energy_spectrum_2d is 2D only")
    uc, vc = _centers(grid, u)
    nx, ny = uc.shape
    uh = np.fft.fft2(uc) / (nx * ny)
    vh = np.fft.fft2(vc) / (nx * ny)
    e = 0.5 * (np.abs(uh) ** 2 + np.abs(vh) ** 2)
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    ky = np.fft.fftfreq(ny, d=1.0 / ny)
    kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    kmax = min(nx, ny) // 2
    shells = np.arange(1, kmax + 1)
    idx = np.rint(kmag).astype(int)
    sums = np.bincount(idx.ravel(), weights=e.ravel(), minlength=kmax + 1)
    return shells, sums[1:kmax + 1]


def total_kinetic_energy(grid: GridSpec, u: Sequence[torch.Tensor]) -> float:
    """0.5 * mean(|u|^2) from the cell-centred field."""
    return float(sum(0.5 * np.mean(c ** 2) for c in _centers(grid, u)))
