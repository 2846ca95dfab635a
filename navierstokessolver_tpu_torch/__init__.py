"""navierstokessolver_tpu_torch: the PyTorch + CUDA port of navierstokessolver_tpu.

Ported so far: the lid-driven cavity projection step (2D and 3D) with the
direct spectral (DCT) pressure solve, explicit Euler at a fixed dt. In 3D
the step runs three hand-written CUDA kernels for Hopper (sm_90a):
the fused predictor + BCs + Poisson RHS, the Poisson residual of the
refinement pass, and the fused corrector + step diagnostics
(ops/fused3d.py, csrc/fused3d.cu). On CPU tensors the same entry points
run the kernels' plain PyTorch versions.

The JAX package is the reference this port is held to; this package never
imports it, nor JAX.

    from navierstokessolver_tpu_torch.cases import make_case
    case = make_case("cavity3d", shape=(256, 256, 256), device="cuda")
    st = case.initial_state()
    st, diag = case.sim.run_scan(st, 100)
"""

from .grid import GridSpec, State, zero_state, interpolate_to_centers
from .bcs import BCKind, BCSpec, BCTable, no_slip_box
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
    "PoissonConfig",
    "PoissonOp",
    "build_poisson_op",
    "SimParams",
    "Simulation",
    "StepDiagnostics",
]
