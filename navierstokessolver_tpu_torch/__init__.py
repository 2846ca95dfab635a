"""navierstokessolver_tpu_torch: the PyTorch + CUDA port of navierstokessolver_tpu.

Ported so far: the lid-driven cavity projection step (2D and 3D) and the
2D cylinder (inflow, outflow and slip faces, a staircase obstacle or the
sharp-interface immersed boundary of ibm.py) with the direct spectral
(DCT) pressure solve or an iterative one (damped Jacobi, red-black GS and
SOR, CG, multigrid, MG-preconditioned CG, the capacitance-corrected
DCT-preconditioned dctcg), explicit Euler or rk2 at a fixed or a
CFL-adaptive dt (formed on the device; ops/step_size.py), and the
Smagorinsky LES closure in 3D (les.py). In 3D the
step runs hand-written CUDA kernels for Hopper (sm_90a): the fused
predictor + BCs + Poisson RHS, the Poisson residual of the refinement
pass, and the fused corrector + step diagnostics (ops/fused3d.py,
csrc/fused3d.cu); with LES, the eddy viscosity and the predictor with the
subgrid stress in place of the fused predictor (ops/predictor3d.py,
csrc/predictor3d.cu). In 2D it runs the fused 2D predictor and corrector
(ops/fused2d.py, csrc/fused2d.cu), and the multigrid V-cycle runs its
large levels on the level kernels (ops/multigrid_kernels.py,
csrc/multigrid.cu); the unfused 2D step (the cylinder) runs the
per-component predictor (ops/predictor2d.py, csrc/predictor2d.cu). The
3D kernels take PERIODIC axes (the Taylor-Green vortex, cases
``taylor_green3d``) and, on bounded grids, INFLOW, OUTFLOW and SLIP faces
and an obstacle (their open modes; the flow past a sphere, ``sphere``,
whose dctcg builds the 3D capacitance), and the 3D direct solve's
opt-in fused trailing-axes route (``fuse_trailing``) runs its
transforms' trailing axes on one
kernel (ops/trailing_dct.py, csrc/trailing_dct.cu). Body forces (numbers,
arrays, callables of t) and BC values that are callables of t run on
every unsharded route: the predictors' forced modes, the buffers they read
refilled from the carried ``State.t`` on the device (``kolmogorov``,
``duct_periodic``, ``pulsatile_channel``, ``oscillating_lid``,
``heated_enclosure``). On CPU tensors the same entry points run the
kernels' plain PyTorch versions.

The command line, ``python -m navierstokessolver_tpu_torch`` (cli.py),
takes the JAX CLI's flags and writes its files: snapshots streamed off the
card (io.py), checkpoints either package resumes, running statistics
(stats.py) and Lagrangian tracers (tracers.py).

The JAX package is the reference this port is held to; this package never
imports it, nor JAX.

    from navierstokessolver_tpu_torch.cases import make_case
    case = make_case("cavity3d", shape=(256, 256, 256))   # on the card
    st = case.initial_state()
    st, diag = case.sim.run_scan(st, 100)
    # with the LES closure
    import dataclasses
    sim = dataclasses.replace(case.sim, les=LESConfig(cs=0.17))
"""

from .grid import GridSpec, State, zero_state, interpolate_to_centers
from .bcs import BCKind, BCSpec, BCTable, no_slip_box
from .les import LESConfig
from .ops.poisson import PoissonConfig, PoissonOp, build_poisson_op
from .solver import SimParams, Simulation, StepDiagnostics

__all__ = [
    "GridSpec",
    "State",
    "zero_state",
    "interpolate_to_centers",
    "BCKind",
    "BCSpec",
    "BCTable",
    "no_slip_box",
    "LESConfig",
    "PoissonConfig",
    "PoissonOp",
    "build_poisson_op",
    "SimParams",
    "Simulation",
    "StepDiagnostics",
]
