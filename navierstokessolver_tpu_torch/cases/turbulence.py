"""2D decaying turbulence in a periodic box, PyTorch port.

Counterpart of ``navierstokessolver_tpu/cases/turbulence.py``. A
band-limited random initial field built from a NODE streamfunction whose
discrete curl lands exactly on the MAC faces:

    u[i, j+1/2] =  (psi[i, j+1] - psi[i, j]) / hy
    v[i+1/2, j] = -(psi[i+1, j] - psi[i, j]) / hx

so the staggered divergence is zero to roundoff by construction
(telescoping), and the first projection has nothing to fix. The field
comes from numpy's ``default_rng(seed)``, the JAX case's generator, so
both packages start from the same numbers. The oracle is the classic 2D
phenomenology: viscous decay, and the energy centroid moving to larger
scales (the inverse cascade; utils/spectra.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bcs import BCSpec
from ..grid import GridSpec, State
from ..les import LESConfig
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation


def _random_streamfunction(nx, ny, k0, seed):
    """psi on the periodic node grid with E(k) ~ k exp(-(k/k0)^2) (the JAX
    function, copied as it is)."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    ky = np.fft.fftfreq(ny, d=1.0 / ny)
    kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        # velocity ~ k psi => E(k) ~ k^2 |psi_k|^2 * k; target E ~ k e^-..
        amp = np.where(kmag > 0, kmag ** -1.0 * np.exp(-((kmag / k0) ** 2)), 0.0)
    phase = np.exp(2j * np.pi * rng.random((nx, ny)))
    psi_h = amp * phase
    psi = np.real(np.fft.ifft2(psi_h)) * nx * ny
    return psi / max(np.abs(psi).max(), 1e-30)


def build_decaying_turbulence(
    shape=(256, 256),
    re: float = 5000.0,
    k0: float = 6.0,
    u_rms: float = 1.0,
    seed: int = 0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.05,
    les_cs: float | None = None,
    les_model: str = "smagorinsky",
    device="cuda",
    **params_kw,
):
    """JAX's defaults: rk2 (``setdefault``; forward Euler with central
    advection is unstable for advection-dominated flows), a 5% donor-cell
    blend, and dt a quarter of the advective and diffusive limits of the
    initial field. ``les_cs`` (or ``les_model="dynamic"``): the 2D LES
    closure, the unfused route with the subgrid stress in the predictor
    kernel's forcing volumes, as JAX's jnp step. ``device``: the card unless the caller names another; without a CUDA
    device the default raises."""
    from . import Case

    nx, ny = shape
    L = 2.0 * math.pi
    grid = GridSpec(shape=tuple(shape), lengths=(L, L))
    hx, hy = grid.spacing
    bcs = {(a, s): BCSpec.periodic() for a in range(2) for s in (0, 1)}
    nu = u_rms * L / re

    psi = _random_streamfunction(nx, ny, k0, seed)
    # discrete curl: u at x-faces (nx+1, ny), v at y-faces (nx, ny+1); the
    # duplicate wrap faces mirror index 0
    u0 = (np.roll(psi, -1, axis=1) - psi) / hy
    v0 = -(np.roll(psi, -1, axis=0) - psi) / hx
    # normalize so <|u|^2> = u_rms^2 (kinetic energy = u_rms^2 / 2)
    rms = math.sqrt(float((u0 ** 2).mean() + (v0 ** 2).mean()))
    scale = u_rms / max(rms, 1e-30)
    u0 *= scale
    v0 *= scale
    u_faces = np.concatenate([u0, u0[:1, :]], axis=0)
    v_faces = np.concatenate([v0, v0[:, :1]], axis=1)

    if dt is None:
        h = min(hx, hy)
        umax = max(np.abs(u_faces).max(), np.abs(v_faces).max(), 1e-12)
        dt = 0.25 * min(h / umax, h * h / (4.0 * nu))
    params_kw.setdefault("integrator", "rk2")
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
        **params_kw,
    )
    les = None
    if les_cs or les_model != "smagorinsky":
        les = LESConfig(cs=les_cs or 0.17, model=les_model)
    sim = Simulation.build(grid, bcs, params, device, les=les)

    def init(s: Simulation) -> State:
        def dev(a):
            return torch.as_tensor(a.astype(np.float32)).to(s.device)

        return State(u=(dev(u_faces), dev(v_faces)),
                     p=torch.zeros(grid.shape, dtype=grid.dtype,
                                   device=s.device))

    return Case(
        name="decaying_turbulence",
        sim=sim,
        suggested_steps=int(round(10.0 / dt)),
        description=f"2D decaying turbulence Re={re:g} k0={k0} {shape}",
        init=init,
    )
