"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source, all
started together), holds each against its plain PyTorch version on the
card, runs the main paths through the library entry points, with the
kernels and with the plain composition:

  * the 3D lid-driven cavity at 256^3 (BASELINE config #5),
  * the 2D flagship, ``make_case("cavity", shape=(2048, 2048), re=1e4,
    upwind_gamma=0.8)`` (bench.py's default configuration), whose pressure
    solve runs the split-level DCT,
  * the 3D LES step: the 256^3 cavity with the Smagorinsky closure,
    ``dataclasses.replace(case.sim, les=LESConfig(cs=0.17))``, what the JAX
    package's ``cli --case cavity3d --les-cs 0.17`` runs, and
  * the iterative pressure solves at the flagship's size (BASELINE config
    #4's 2048^2 at Re 1e4): ``poisson_method="mgcg"`` (multigrid-
    preconditioned CG, the V-cycle's large levels on the fused level
    kernels), ``"mg"`` on the RB route (the rb_sweeps kernel) and ``"cg"``
    from the fft run's final state (no multigrid kernel; for its
    iteration count),
  * the immersed-boundary cylinder, ``make_case("cylinder", ibm=True)``
    (BASELINE config #3's topology, Re 200: inflow, outflow and slip faces,
    the sharp-interface direct forcing, the ``dctcg`` solve), at its
    512x256 and at 2048x1024 (D = 128 cells), from the impulsive start; its
    predictor is the per-component 2D kernel (predictor_2d); at 512x256
    also ``run_scan_forces`` (the control-volume force terms sampled after
    every step) against ``cv_terms_nd`` after each step of a ``run_scan``,
  * the Poiseuille channel, ``make_case("channel")`` (BASELINE config #2:
    a parabolic inflow profile, outflow and no-slip walls, mg): at its
    256x64 from ``poiseuille_state`` for 200 steps against the analytic
    profile (the JAX package's tests/test_channel.py bounds) and inflow
    against outflow flux, and timed at 2048x512 (square cells) from the
    case's own start (fluid at rest, the inflow profile switched on: a
    developing flow), where the V-cycle's three largest levels run the
    fused level kernels; its predictor is predictor_2d, the inflow profile
    in the kernel's ghost table,
  * the 3D Taylor-Green vortex, ``make_case("taylor_green3d",
    shape=(256, 256, 256))`` (Re 1600, every axis periodic: the three 3D
    kernels in their periodic mode, the direct solve on the circulant
    eigenbasis), on the transform chain and on the fused trailing-axes
    route, and the 256^3 cavity on that route: ``dataclasses.replace(sim,
    dct_solver=dataclasses.replace(sim.dct_solver, fuse_trailing=True))``,
    whose two direct solves a step run kernel 12 (fused_trailing, the JAX
    kernel's 3-pass bf16 split product on wgmma) twice each,
  * the slab-sharded fused 3D step (BASELINE config #5's domain
    decomposition), every slab on this card: ``sharded_simulation(sim,
    make_mesh(n, devices=[card] * n), rdma=True)``, cavity3d 256^3 in 4
    and in 16 slabs and taylor_green3d 256^3 in 4 (a ring along the
    sharded axis), which runs kernels 1 and 2 in their halo mode on each
    slab and the row-exchange kernel (kernel 14, exchange_rows_multi) 3
    times a step; kernel 13 (exchange_ghost_rows) is the exchange kernel
    with its fixed message set, which no step calls, as in JAX,
  * the periodic 2D cases (kernels 4 and 5 in their wrap modes, the direct
    solve's split circulant plan): ``make_case("taylor_green",
    shape=(2048, 2048))`` (Re 100, Euler; the analytic decay after 210
    steps), ``"decaying_turbulence"`` at 2048^2 (Re 5000, k0 6, seed 0,
    rk2, gamma 0.05; its inverse-cascade oracle at the JAX test's 128^2 to
    t = 4) and ``"channel_periodic"`` at 2048x512 (periodic along x, walls,
    the static body force f_x = 8 nu u_max / Ly^2; the parabola persists
    and the flux is the same through every x face), each 200 timed steps;
    phase 2 holds kernels 4 and 5 in every wrap mode (a periodic box,
    periodic rows, periodic lanes), Euler, with the force and in rk2's
    base form, to their plain versions, phase 3 runs 5 Euler and 5 rk2
    steps of each case against step_plain, and phase 4 counts the
    synchronizing calls a step of the turbulence at cfl 0.5 (none),

and rk2 and the CFL-adaptive dt (``SimParams(integrator="rk2")``,
``cfl=...``) on every route: phase 2 holds kernels 1 and 4 in rk2's
``base`` mode (the 256^3 cavity and Taylor-Green box, a halo slab, the
flagship) and kernels 1, 2, 4, 5, 6 and 8 reading a step size of 0.37
times their usual one from a device buffer to their plain versions; phase
3 runs 5 steps of every route (the 256^3 cavity and Taylor-Green box, the
flagship, the 512x256 cylinder, the LES cavity, and the cavity in 4 slabs
against the unsharded step) under rk2 and under cfl 0.4, kernels against
step_plain; phase 4 times taylor_green3d 256^3 and the flagship under rk2
with cfl 0.5, the LES cavity and the 2048x1024 cylinder under rk2, each
beside its Euler run, kernels 1 and 4 in base mode, and counts the
synchronizing calls a step of the Taylor-Green and flagship loops under
``torch.cuda.set_sync_debug_mode("warn")``, Euler against rk2 with the
CFL dt (which must add none),

then times a run of each (launch counts reset just before each run and
read just after), each kernel against its plain version (the 2D kernels
and the multigrid's, at every level, also by CUDA-graph replay over
rotated inputs: their device time, beside the wrappers' host time; the
level kernels mg_pre and mg_post also at each tile of MG_TILES), the
split direct solve against the dense one, the LES step and the cylinder
step against their plain compositions, one V-cycle on each route, the
periodic modes of the 3D kernels and the fused route's direct solve
against the chain's, the exchanges and the halo-mode kernels at the 4-
and 16-slab sizes and the sharded step in 4 and in 16 slabs against the
unsharded one. Any failed check raises; nothing is caught.

Output: one line per phase; then, before the last line, a JSON object with
each kernel's launches in its path's timed run, its largest error against
the plain version, both times, the least time the card could take for the
same work (its bytes over 3.35 TB/s or its operations over the card's
peak rate for their type, the larger: float32 at 67 TFLOP/s, for
fused_trailing its bf16 passes at 989 TFLOP/s) and a library call's time
(for fused_trailing two batched float32 cuBLAS SGEMMs and the multiply,
the chain's arithmetic; for the exchanges one ``torch._foreach_copy_``
over the same messages, whose CUDA-graph replay times, on buffers that
stay in L2, print beside; null for the others: no
single PyTorch call computes their functions); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    return torch


def _require_port() -> None:
    try:
        import navierstokessolver_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        sys.exit(f"chip_smoke.py: {e}; run it from the root of a checkout "
                 "of the repository, which holds the port's package")


torch = _require_cuda()
_require_port()

from navierstokessolver_tpu_torch.bcs import (  # noqa: E402
    BCSpec, apply_velocity_bcs, no_slip_box,
)
from navierstokessolver_tpu_torch.cases import make_case  # noqa: E402
from navierstokessolver_tpu_torch.cases.channel import (  # noqa: E402
    parabolic_profile, poiseuille_state,
)
from navierstokessolver_tpu_torch.cases.cylinder import (  # noqa: E402
    impulsive_start_state,
)
from navierstokessolver_tpu_torch.cases.taylor_green import (  # noqa: E402
    taylor_green_state,
)
from navierstokessolver_tpu_torch.step_profile import (  # noqa: E402
    device_profile,
)
from navierstokessolver_tpu_torch.utils.spectra import (  # noqa: E402
    energy_spectrum_2d, total_kinetic_energy,
)
from navierstokessolver_tpu_torch.grid import GridSpec  # noqa: E402
from navierstokessolver_tpu_torch.les import (  # noqa: E402
    LESConfig, eddy_viscosity,
)
from navierstokessolver_tpu_torch.bcs import (  # noqa: E402
    BCKind, periodic_axes,
)
from navierstokessolver_tpu_torch.ops import (  # noqa: E402
    _native, fft_poisson, fused2d, fused3d, multigrid_kernels, poisson,
    predictor2d, predictor3d, step_size, trailing_dct,
)
from navierstokessolver_tpu_torch.ops.poisson import (  # noqa: E402
    apply_A, build_poisson_op, residual_norm,
)
from navierstokessolver_tpu_torch.parallel import (  # noqa: E402
    fused_sharded, make_mesh, remote_dma, shard_state, sharded_simulation,
)
from navierstokessolver_tpu_torch.utils.forces import (  # noqa: E402
    cv_terms_nd,
)

DEV = torch.device("cuda", 0)
SHAPE = (256, 256, 256)
RAGGED = (40, 24, 72)
# kernels 1-2 and 6-7 march tiles of 8 rows of axis 1 by 32 cells of axis
# 2 in runs of 8-32 planes of axis 0; these extents are multiples of none
# of them: walls only with a moving lid, and axes 0 and 2 periodic (even
# extents)
RAGGED_WALL = (37, 19, 45)
RAGGED_PER = (38, 22, 46)
SHAPE2 = (2048, 2048)
FLAGSHIP = dict(shape=SHAPE2, re=1e4, upwind_gamma=0.8)
RAGGED2 = (200, 136)           # no axis a multiple of 32
TIMED_STEPS = 200
MGCG_STEPS = 200               # the mgcg main path
MG_STEPS = 50                  # the mg run on the RB route
CG_STEPS = 10                  # the cg run (~10^3 iterations a step)
CYL_SHAPE = (2048, 1024)       # the cylinder's timed size, D = 128 cells
CYL_BASE = (512, 256)          # BASELINE config #3's size
CYL_STEPS = 200
CHANNEL_BASE = (256, 64)       # BASELINE config #2's size
CHANNEL_BASE_STEPS = 200       # the JAX oracle's run (tests/test_channel.py)
CHANNEL_SHAPE = (2048, 512)    # the channel's timed size, h = 1/512
CHANNEL_STEPS = 20             # from the developing start, host-bound
FORCES_STEPS = 20              # run_scan_forces against post-hoc sampling
# the periodic 2D cases at full width: the Taylor-Green vortex and decaying
# turbulence (both axes periodic, the split circulant plan on both) and the
# body-forced channel (axis 0 periodic, walls on axis 1)
PER_SHAPE = (2048, 2048)
PER_CHANNEL = (2048, 512)
# kernels 4-5's wrap modes in phase 2 on these shapes (n1 % 29 != 0 in
# each; (20, 14): fewer rows than a run and fewer columns than a warp), on
# a fully periodic box, periodic rows and periodic lanes
PER_P2 = (PER_SHAPE, PER_CHANNEL, (994, 1002), (20, 14))
PER_TOPOLOGIES = {"box": (True, True), "rows": (True, False),
                  "lanes": (False, True)}
PER_FORCE = (0.7, -0.2)        # phase 2's static body force
# the decaying-turbulence oracle at the JAX test's size
# (tests/test_turbulence.py::test_decay_and_inverse_cascade), to t = 4
TURB_ORACLE = dict(shape=(128, 128), re=2000.0, k0=12.0, seed=1)
# kernel 8 marches warps of 30 cells of axis 1 down runs of 16-64 rows:
# (200, 136) with no axis a multiple of 32 or 30; (37, 45): fewer rows
# than a run, n1 % 30 != 0, n1 % 29 != 0 and (n1 + 1) % 4 != 0
RAGGED_P2 = (RAGGED2, (37, 45))
# and at the cylinder's timed size with the ragged grids' lengths, dt and
# nu, where O(1) random states give u* of O(100) (h ~ 1/300)
P2_LARGE = (CYL_SHAPE, (6.25, 4.25), 0.01, 0.005)
# kernel -> (the TPU kernel it replaces, its CUDA source)
KERNELS = {
    "predictor_rhs_3d": ("navierstokessolver_tpu/ops/pallas_kernels.py:1766",
                         "fused3d"),
    "correct_diag_3d": ("navierstokessolver_tpu/ops/pallas_kernels.py:2588",
                        "fused3d"),
    "residual_3d": ("navierstokessolver_tpu/ops/pallas_kernels.py:3330",
                    "fused3d"),
    "predictor_rhs_2d": ("navierstokessolver_tpu/ops/pallas_2d.py:241",
                         "fused2d"),
    "correct_diag_2d": ("navierstokessolver_tpu/ops/pallas_2d.py:704",
                        "fused2d"),
    "predictor_3d": ("navierstokessolver_tpu/ops/pallas_kernels.py:198",
                     "predictor3d"),
    "nu_t_3d": ("navierstokessolver_tpu/ops/pallas_kernels.py:624",
                "predictor3d"),
    "mg_pre_sweeps_residual": (
        "navierstokessolver_tpu/ops/pallas_kernels.py:938", "multigrid"),
    "mg_add_post_sweeps": (
        "navierstokessolver_tpu/ops/pallas_kernels.py:972", "multigrid"),
    "rb_sweeps": ("navierstokessolver_tpu/ops/pallas_kernels.py:757",
                  "multigrid"),
    "predictor_2d": ("navierstokessolver_tpu/ops/pallas_kernels.py:63",
                     "predictor2d"),
    "fused_trailing": ("navierstokessolver_tpu/ops/pallas_dct.py:59",
                       "trailing_dct"),
    "exchange_ghost_rows": (
        "navierstokessolver_tpu/parallel/remote_dma.py:56", "remote_dma"),
    "exchange_rows_multi": (
        "navierstokessolver_tpu/parallel/remote_dma.py:162", "remote_dma"),
}
SOURCES = ("fused3d", "fused2d", "predictor3d", "multigrid", "predictor2d",
           "trailing_dct", "remote_dma")
SLABS = (4, 16)                # the sharded runs: 4 slabs and BASELINE #5's 16
# the tiles mg_pre and mg_post are timed at on each V-cycle level: those of
# the plan's table (ops/multigrid_kernels.TILES) and 16 rows between
MG_TILES = ((32, 88), (16, 88), (8, 88), (8, 24))
# the kernels each redesigned source reports in phase 1, and the redesigned
# kernels (the axis-0 marches, the multigrid level and sweep tiles), which
# must not spill
PTXAS_KERNELS = {"fused3d": 68, "predictor3d": 5, "fused2d": 36,
                 "multigrid": 3, "predictor2d": 2}
# the Euler instantiations' registers in the sm_90a build of the commit
# before the step size moved to a device buffer and kernels 1 and 4 gained
# rk2's base mode, printed beside this build's
EULER_REGISTERS_BEFORE = {
    "predictor_rhs_kernel": {
        "0, 0": 72, "0, 1": 72, "0, 2": 72, "0, 3": 64, "0, 4": 69,
        "0, 5": 64, "0, 6": 60, "0, 7": 56, "1, 0": 72, "1, 2": 72,
        "1, 4": 70, "1, 6": 64, "2, 0": 80, "2, 2": 72, "2, 4": 64,
        "2, 6": 64, "3, 0": 72, "3, 2": 72, "3, 4": 58, "3, 6": 61},
    "correct_diag_kernel": {
        "0, 0": 39, "0, 1": 39, "0, 2": 40, "0, 3": 40, "0, 4": 40,
        "0, 5": 40, "0, 6": 40, "0, 7": 40, "1, 0": 39, "1, 2": 40,
        "1, 4": 40, "1, 6": 40, "2, 0": 39, "2, 2": 40, "2, 4": 40,
        "2, 6": 40, "3, 0": 39, "3, 2": 40, "3, 4": 40, "3, 6": 40},
    "predictor_rhs_2d_kernel": {"0": 64, "1": 64},
    "correct_diag_2d_kernel": {"": 32},
    "predictor_3d_kernel": {"0, 0, 0": 80, "0, 0, 1": 80, "0, 1, 0": 80,
                            "0, 1, 1": 80},
    "predictor_2d_kernel": {"0": 80, "1": 80},
}
# the template arguments that follow the table's in the Euler walls-only
# instantiation's name: kernels 1 and 4 gained BASE (PR 14), kernel 4 PER
# and FORCE and kernel 5 PER (PR 15)
EULER_SUFFIX = {"predictor_rhs_kernel": ", 0",
                "predictor_rhs_2d_kernel": ", 0, 0, 0",
                "correct_diag_2d_kernel": "0"}
# the device dt of phase 2's step-size checks: this factor times the
# kernels' usual dt, a value no case uses
DT_FACTOR = 0.37
NO_SPILL_KERNELS = ("predictor_rhs_kernel<", "correct_diag_kernel<",
                    "predictor_3d_kernel<", "nu_t_3d_kernel<",
                    "predictor_rhs_2d_kernel<", "correct_diag_2d_kernel<",
                    "rb_sweeps_kernel",
                    "level_kernel<", "predictor_2d_kernel<")
# the peak rates of one H100 SXM at 700 W that bound a kernel's time
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12        # dense tensor-core rate (kernel 12's wgmma)
L2_BYTES = 50 * 2**20          # the card's L2 cache
# float32 operations per cell of each kernel, counted from its source
# (per cell: the 2D predictor computes 2 face updates of ~36 operations,
# 3% more where its runs start, and the divergence; the 3D one 3 of ~64, the upwind blend counted, 5% more on its
# tiles' high edges and the divergence; the LES predictor 3 of ~70 with
# the upwind blend and its face's stress terms, and 3 edge stresses of
# ~13; nu_t 3 diagonal and 6 telescoped off-diagonal gradients and the
# norm, ~60; a red-black update is ~17 operations, the residual 11; the
# rest as commented at each kernel)
OPS_PER_CELL = {
    "predictor_rhs_3d": 210, "correct_diag_3d": 30, "residual_3d": 15,
    "predictor_rhs_2d": 80, "correct_diag_2d": 20,
    "predictor_3d": 250, "nu_t_3d": 60,
    "predictor_2d": 72,   # two face updates of ~36 operations
}
# the launch counters of the LES step's path
LES_PATH = ("nu_t_3d", "predictor_3d", "residual_3d", "correct_diag_3d")


def line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _name(shape) -> str:
    return "x".join(map(str, shape))


def close(name, got, ref, rtol, atol) -> float:
    """Assert |got - ref| <= atol + rtol*|ref| elementwise (``atol`` a
    number or a tensor of ref's shape); max abs error."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside rtol={rtol} "
            f"atol={float(torch.as_tensor(atol).max()):.3g}; "
            f"max abs err {float(err.max()):.3g}"
        )
    return float(err.max())


def random_state(grid, bcs, gen, scale=1.0):
    u = tuple(scale * torch.randn(grid.face_shape(a), generator=gen,
                                  device=DEV)
              for a in range(grid.ndim))
    return apply_velocity_bcs(grid, bcs, u)


def compare_kernels(grid, bcs, gamma, gen, errs) -> None:
    """Each kernel against its plain version on one random state. Tolerances
    are the JAX interpret-parity ones (tests/test_fused_step.py): u*
    rtol=atol=1e-5; RHS rtol 1e-4, atol 3e-7 max|RHS|; diagnostics rtol
    1e-4; residual rtol 1e-5, atol 1e-6 max|r| (float32 roundoff of a sum
    whose terms reach 12 w max|p|, w = 1/h^2)."""
    dt, nu, rho = 1e-3, 0.02, 1.3
    u = random_state(grid, bcs, gen)
    (k_u, k_rhs) = fused3d.predictor_rhs_3d(grid, bcs, u, dt, nu, gamma, rho)
    (p_u, p_rhs) = fused3d.predictor_rhs_plain(grid, bcs, u, dt, nu, gamma, rho)
    e = max(close(f"u*[{a}]", k_u[a], p_u[a], 1e-5, 1e-5) for a in range(3))
    rhs_atol = 3e-7 * float(p_rhs.abs().max())
    e = max(e, close("rhs", k_rhs, p_rhs, 1e-4, rhs_atol))
    errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)

    p = torch.randn(grid.shape, generator=gen, device=DEV)
    scale = dt / rho
    per = periodic_axes(grid, bcs)
    k_n, k_div, k_vel = fused3d.correct_diag_3d(grid, k_u, p, scale, per)
    p_n, p_div, p_vel = fused3d.correct_diag_plain(grid, k_u, p, scale, per)
    e = max(close(f"u_new[{a}]", k_n[a], p_n[a], 1e-5, 1e-5) for a in range(3))
    e = max(e, close("max_div", k_div, p_div, 1e-4, 0.0))
    e = max(e, close("max_vel", k_vel, p_vel, 1e-4, 0.0))
    errs["correct_diag_3d"] = max(errs["correct_diag_3d"], e)

    op = build_poisson_op(grid, bcs, DEV)
    b = torch.randn(grid.shape, generator=gen, device=DEV)
    k_r = fused3d.residual_3d(op, p, b)
    p_r = fused3d.residual_plain(op, p, b)
    e = close("residual", k_r, p_r, 1e-5, 1e-6 * float(p_r.abs().max()))
    errs["residual_3d"] = max(errs["residual_3d"], e)
    torch.cuda.synchronize()
    line("phase2", shape=_name(grid.shape), gamma=gamma,
         periodic=json.dumps(per),
         max_abs_err=json.dumps({k: errs[k] for k, (_, src) in KERNELS.items()
                                 if src == "fused3d"}))


def compare_trailing(solver, gen, errs) -> None:
    """Kernel 12 on ``solver``'s own split per-axis matrices against its
    plain version on one O(1) random field, at 3 and at 1 bf16 pass: the
    forward pair with the multiplier and the inverse pair without. Both sum
    the same exact bf16 products in float32, in different orders (the
    kernel inside the tensor cores), so the tolerance is 5e-5 of max|out|.
    At one pass the stage-1 result Y enters stage 2 as bf16(Y) alone, and a
    float32 roundoff difference in Y flips that rounding for a small
    fraction of Y's entries; a flip moves bf16(Y) by one
    bf16 ulp, at most 2^-7 |Y|, and output (i, j, k) by at most 2^-7 max|Y|
    max|m2| |eig[i, j, k]| (no lo term to make up for it), so one pass
    holds each entry to 5e-5 of max|out| plus one such flip of its own
    (eig 1 for the inverse pair). The rare output that meets two flips
    stays inside: a flipped entry and its m2 weight lie far below their
    maxima."""
    g = solver.grid
    x = torch.randn(g.shape, generator=gen, device=DEV)
    (f1, v1), (f2, v2) = solver._fused3d_split
    worst = {}
    for passes in (3, 1):
        e = 0.0
        for m1, m2, eig in ((f1, f2, solver.inv_eig), (v1, v2, None)):
            got = trailing_dct.fused_trailing(x, m1, m2, eig, passes)
            ref = trailing_dct.fused_trailing_plain(x, m1, m2, eig, passes)
            atol = 5e-5 * float(ref.abs().max())
            if passes == 1:
                flip = 2.0**-7 * float(torch.matmul(m1.full, x).abs().max()) \
                    * float(m2.full.abs().max())
                atol = atol + flip * (torch.ones_like(ref) if eig is None
                                      else eig.abs())
            e = max(e, close(f"fused_trailing {solver.kinds} passes={passes} "
                             f"eig={eig is not None}", got, ref, 0.0, atol))
        worst[passes] = e
        errs["fused_trailing"] = max(errs["fused_trailing"], e)
    torch.cuda.synchronize()
    line("phase2", shape=_name(g.shape), kinds=json.dumps(solver.kinds),
         fused_trailing_max_abs_err_by_passes=json.dumps(worst))


def sharded(case, n):
    """``case`` with its simulation sharded into ``n`` slabs on the card."""
    mesh = make_mesh(n, devices=[DEV] * n)
    return dataclasses.replace(case, sim=sharded_simulation(case.sim, mesh,
                                                            rdma=True))


def exchange_sets(step):
    """The sharded step's three exchanges on ``step``'s buffers, and kernel
    13 on the slabs' u0 buffers: name -> (RowExchange, volumes, messages,
    ring)."""
    b, ring = step.b, step.periodic[0]
    u0 = [blk[0] for blk in step.u[step.cur]]
    return {
        "velocity": (step.refresh[step.cur],
                     [[blk[a] for blk in step.u[step.cur]] for a in range(3)],
                     fused_sharded.velocity_messages(b), ring),
        "shared_face": (step.shared_face, [[s[0] for s in step.u_star]],
                        fused_sharded.shared_face_messages(b), ring),
        "pressure": (step.p_halo, [step.p], fused_sharded.pressure_messages(b),
                     ring),
        "ghost_rows": (remote_dma.RowExchange(
            [u0], remote_dma.ghost_messages(b, u0[0].shape[0]), ring,
            counter="exchange_ghost_rows"), [u0],
            remote_dma.ghost_messages(b, u0[0].shape[0]), ring),
    }


def compare_exchanges(step, gen, errs) -> None:
    """Kernels 13 and 14 against their plain versions on ``step``'s buffers
    filled with random values: each exchange on one copy by the kernel and
    on another by the plain version; they move values, so max_abs_err
    must be 0.0."""
    for bufs in (*step.u, step.u_star, [(p,) for p in step.p]):
        for blk in bufs:
            for t in blk:
                t.copy_(torch.randn(t.shape, generator=gen, device=DEV))
    worst = {}
    for what, (plan, vols, msgs, ring) in exchange_sets(step).items():
        copies = [[t.clone() for t in v] for v in vols]
        plan.run()
        remote_dma.exchange_rows_multi_plain(copies, msgs, ring)
        e = max(float((a - b).abs().max()) for v, c in zip(vols, copies)
                for a, b in zip(v, c))
        if e != 0.0:
            raise AssertionError(f"exchange {what}: max abs err {e}")
        name = ("exchange_ghost_rows" if what == "ghost_rows"
                else "exchange_rows_multi")
        errs[name] = max(errs[name], e)
        worst[what] = e
    torch.cuda.synchronize()
    line("phase2", slabs=step.n_dev, b=step.b, ring=step.periodic[0],
         exchange_max_abs_err=json.dumps(worst))


def compare_halo_kernels(case, n, gen, errs) -> None:
    """Kernels 1 and 2 in halo mode on every slab of ``case`` cut into
    ``n`` (the first, the middle ones and the last), from one random O(1)
    state: against their halo-mode plain versions with the JAX
    interpret-parity tolerances of compare_kernels, and against the
    unsharded kernels' rows of the whole field (the same arithmetic per
    cell) within rtol = atol = 1e-6."""
    dt, nu, gamma, rho = 1e-3, 0.02, 0.8, 1.3
    sim = sharded(case, n).sim
    g, bcs = sim.grid, sim.bcs
    step = fused_sharded.SlabStep(sim, sim.mesh)
    u = random_state(g, bcs, gen)
    step.load(u)
    step.refresh[step.cur].run()
    g_star, g_rhs = fused3d.predictor_rhs_3d(g, bcs, u, dt, nu, gamma, rho)
    p = torch.randn(g.shape, generator=gen, device=DEV)
    per = periodic_axes(g, bcs)
    g_new, _, _ = fused3d.correct_diag_3d(g, g_star, p, dt / rho, per)
    b = step.b
    vs_unsharded = 0.0
    for k in range(n):
        halo = step.halo[k]
        ks, krhs = fused3d.predictor_rhs_3d_halo(
            step.slab, bcs, step.u[step.cur][k], dt, nu, gamma, rho, halo=halo,
            bc=sim.bc, out=step.u_star[k], rhs=step.rhs[k])
        ps, prhs = fused3d.predictor_rhs_halo_plain(
            step.slab, bcs, step.u[step.cur][k], dt, nu, gamma, rho, halo)
        for a in range(3):
            rows = b + (a == 0 and not halo[1])
            e = close(f"halo u*[{a}] slab {k}", ks[a][1:rows + 1],
                      ps[a][1:rows + 1], 1e-5, 1e-5)
            errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)
            vs_unsharded = max(vs_unsharded, close(
                f"halo u*[{a}] slab {k} vs unsharded", ks[a][1:rows + 1],
                g_star[a][k * b:k * b + rows], 1e-6, 1e-6))
        e = close(f"halo rhs slab {k}", krhs, prhs, 1e-4,
                  3e-7 * float(prhs.abs().max()))
        errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)
        vs_unsharded = max(vs_unsharded, close(
            f"halo rhs slab {k} vs unsharded", krhs, g_rhs[k * b:(k + 1) * b],
            1e-6, 1e-6 * float(g_rhs.abs().max())))
    step.shared_face.run()
    for k in range(n):
        step.p[k][1:b + 1] = p[k * b:(k + 1) * b]
    step.p_halo.run()
    for k in range(n):
        halo = step.halo[k]
        kmax = torch.zeros(2, dtype=torch.int32, device=DEV)
        kn = fused3d.correct_diag_3d_halo(step.slab, step.u_star[k], step.p[k],
                                          dt / rho, kmax, per, halo)
        pn, pdiv, pvel = fused3d.correct_diag_halo_plain(
            step.slab, step.u_star[k], step.p[k], dt / rho, per, halo)
        for a in range(3):
            rows = b + (a == 0 and not halo[1])
            e = close(f"halo u_new[{a}] slab {k}", kn[a][1:rows + 1],
                      pn[a][1:rows + 1], 1e-5, 1e-5)
            errs["correct_diag_3d"] = max(errs["correct_diag_3d"], e)
            vs_unsharded = max(vs_unsharded, close(
                f"halo u_new[{a}] slab {k} vs unsharded", kn[a][1:rows + 1],
                g_new[a][k * b:k * b + rows], 1e-6, 1e-6))
        kdiv, kvel = kmax.view(torch.float32)
        e = max(close(f"halo max_div slab {k}", kdiv, pdiv, 1e-4, 0.0),
                close(f"halo max_vel slab {k}", kvel, pvel, 1e-4, 0.0))
        errs["correct_diag_3d"] = max(errs["correct_diag_3d"], e)
    torch.cuda.synchronize()
    line("phase2", case=case.name, slabs=n, b=b, halo=json.dumps(step.halo),
         halo_max_abs_err_vs_plain=json.dumps(
             {k: errs[k] for k in ("predictor_rhs_3d", "correct_diag_3d")}),
         halo_max_abs_err_vs_unsharded=vs_unsharded)


def with_fused_trailing(case):
    """``case`` with its direct solver on the fused trailing-axes route."""
    sim = case.sim
    return dataclasses.replace(case, sim=dataclasses.replace(
        sim, dct_solver=dataclasses.replace(sim.dct_solver,
                                            fuse_trailing=True)))


def periodic_bcs(grid, wall=(1.0, 0.3, 0.0)):
    """Axes 0 and 2 periodic, walls on axis 1 (the high one moving)."""
    bcs = no_slip_box(grid)
    bcs[(1, 1)] = BCSpec.wall(wall)
    for a in (0, 2):
        bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
    return bcs


def compare_les_kernels(grid, bcs, gamma, gen, errs) -> None:
    """Both LES kernels against their plain versions on one random O(1)
    state with LESConfig(cs=0.2), the predictor with and without nu_t, with
    the JAX interpret-parity tolerances (tests/test_pallas.py): nu_t max
    error < 2e-6 max(nu_t); u* atol 5e-5."""
    dt, nu = 1e-3, 0.05
    cfg = LESConfig(cs=0.2)
    u = random_state(grid, bcs, gen)
    k_nt = predictor3d.nu_t_3d(grid, bcs, u, cfg)
    p_nt = eddy_viscosity(grid, bcs, u, cfg)
    e = close("nu_t", k_nt, p_nt, 0.0, 2e-6 * float(p_nt.max()))
    errs["nu_t_3d"] = max(errs["nu_t_3d"], e)
    for nu_t in (None, p_nt):
        k_u = predictor3d.predictor_3d(grid, bcs, u, dt, nu, gamma,
                                       nu_t=nu_t)
        p_u = predictor3d.predictor_3d_plain(grid, bcs, u, dt, nu, gamma,
                                             nu_t=nu_t)
        e = max(close(f"u*[{a}] les={nu_t is not None}", k_u[a], p_u[a],
                      0.0, 5e-5) for a in range(3))
        errs["predictor_3d"] = max(errs["predictor_3d"], e)
    torch.cuda.synchronize()
    line("phase2", shape=_name(grid.shape), gamma=gamma, les_cs=cfg.cs,
         max_nu_t=float(p_nt.max()),
         max_abs_err=json.dumps({k: errs[k]
                                 for k in ("nu_t_3d", "predictor_3d")}))


def compare_kernels_2d(grid, bcs, dt, nu, gamma, gen, errs) -> None:
    """Both 2D kernels against their plain versions on one random O(0.1)
    state, with the JAX 2D interpret-parity tolerances
    (tests/test_pallas2d.py): u*, v* and the corrected velocity atol 2e-6;
    RHS atol 2e-6 max(max|RHS|, 1); max_div rtol 1e-3; max_vel rtol 1e-4."""
    rho = 1.3
    u = random_state(grid, bcs, gen, scale=0.1)
    k_u, k_rhs = fused2d.predictor_rhs_2d(grid, bcs, u, dt, nu, gamma, rho)
    p_u, p_rhs = fused2d.predictor_rhs_2d_plain(grid, bcs, u, dt, nu, gamma,
                                                rho)
    e = max(close(f"u*[{a}]", k_u[a], p_u[a], 0.0, 2e-6) for a in range(2))
    rhs_atol = 2e-6 * max(float(p_rhs.abs().max()), 1.0)
    e = max(e, close("rhs", k_rhs, p_rhs, 0.0, rhs_atol))
    errs["predictor_rhs_2d"] = max(errs["predictor_rhs_2d"], e)

    p = 0.01 * torch.randn(grid.shape, generator=gen, device=DEV)
    scale = dt / rho
    k_n, k_div, k_vel = fused2d.correct_diag_2d(grid, k_u, p, scale)
    p_n, p_div, p_vel = fused2d.correct_diag_2d_plain(grid, k_u, p, scale)
    e = max(close(f"u_new[{a}]", k_n[a], p_n[a], 0.0, 2e-6) for a in range(2))
    e = max(e, close("max_div", k_div, p_div, 1e-3, 0.0))
    e = max(e, close("max_vel", k_vel, p_vel, 1e-4, 0.0))
    errs["correct_diag_2d"] = max(errs["correct_diag_2d"], e)
    torch.cuda.synchronize()
    line("phase2", shape=_name(grid.shape), gamma=gamma,
         max_abs_err=json.dumps({k: errs[k] for k in KERNELS
                                 if k.endswith("2d")}))


def walls_2d(grid, walls):
    """No-slip walls with the lid (1, 0) on face (1, 1) (``"lid"``), or
    with nonzero values of both components on all four faces (``"all"``)."""
    bcs = no_slip_box(grid)
    if walls == "lid":
        bcs[(1, 1)] = BCSpec.wall((1.0, 0.0))
    else:
        for face, value in (((0, 0), (0.2, -0.3)), ((0, 1), (-0.1, 0.4)),
                            ((1, 0), (0.5, 0.15)), ((1, 1), (1.0, -0.25))):
            bcs[face] = BCSpec.wall(value)
    return bcs


def cylinder_bcs():
    """The cylinder's BC table: inflow (1, 0) / outflow / slip / slip."""
    return {(0, 0): BCSpec.inflow((1.0, 0.0)), (0, 1): BCSpec.outflow(),
            (1, 0): BCSpec.slip(), (1, 1): BCSpec.slip()}


def channel_bcs(grid, gen):
    """The channel's BC table (the parabolic inflow profile, outflow, no-slip
    walls) with a nonzero tangential profile on the inflow face: v of
    O(0.1) on its n1 + 1 faces."""
    u_in = torch.as_tensor(parabolic_profile(grid, 1.0), device=DEV)
    v_in = 0.1 * torch.randn(grid.shape[1] + 1, generator=gen, device=DEV)
    return {(0, 0): BCSpec.inflow((u_in, v_in)), (0, 1): BCSpec.outflow(),
            (1, 0): BCSpec.wall((0.0, 0.0)), (1, 1): BCSpec.wall((0.0, 0.0))}


def lid_profile_bcs(grid, gen):
    """No-slip walls and a lid whose u is a profile of O(1) along it, of
    shape (n0 + 1, 1), as JAX takes a tangential profile there."""
    bcs = no_slip_box(grid)
    lid = torch.randn((grid.shape[0] + 1, 1), generator=gen, device=DEV)
    bcs[(1, 1)] = BCSpec.wall((lid, 0.0))
    return bcs


def compare_predictor_2d(grid, bcs, dt, nu, gamma, gen, errs, what,
                         mode="random") -> None:
    """The 2D per-component predictor kernel against its plain version on
    one random O(1) state, on every face: the kernel leaves the own-axis
    boundary faces at their input, as the plain version does (the JAX
    kernel's are garbage, its test compares the interior). Tolerance: the
    JAX interpret-parity atol 2e-5 (tests/test_pallas.py), or 8 float32
    ulps of max|u*| where that is larger. The kernel lets nvcc contract
    a * b + c into one fused multiply-add where the plain version rounds
    the product: about eight roundings differ, each by at most half an
    ulp of a term of the update, and the terms are as large as the output.
    On outputs below 16 (the solver's own dt and nu give O(1)) the
    tolerance is 2e-5; on P2_LARGE's O(100) outputs 2e-5 is under 3 ulps.
    ``mode``: ``"offset"`` puts the fields 4 bytes off a 16-byte
    boundary; ``"zeros"`` makes 30% of the velocities exactly 0 (the
    upwind tie: zero velocity takes the forward difference)."""
    u = [torch.randn(grid.face_shape(a), generator=gen, device=DEV)
         for a in range(2)]
    if mode == "zeros":
        for c in u:
            c[torch.rand(c.shape, generator=gen, device=DEV) < 0.3] = 0.0
    u = apply_velocity_bcs(grid, bcs, u)
    if mode == "offset":
        u = tuple(torch.empty(c.numel() + 1, device=DEV)[1:].view(c.shape)
                  .copy_(c) for c in u)
    k_u = predictor2d.predictor_2d(grid, bcs, u, dt, nu, gamma)
    p_u = predictor2d.predictor_2d_plain(grid, bcs, u, dt, nu, gamma)
    top = max(float(c.abs().max()) for c in p_u)
    atol = max(2e-5, 8 * 2.0 ** (math.floor(math.log2(top)) - 23))
    e = max(close(f"predictor_2d {what} {mode} u*[{a}]", k_u[a], p_u[a],
                  0.0, atol) for a in range(2))
    errs["predictor_2d"] = max(errs["predictor_2d"], e)
    torch.cuda.synchronize()
    line("phase2", kernel="predictor_2d", shape=_name(grid.shape),
         table=what, mode=mode, gamma=gamma, dt=dt, nu=nu, max_abs_err=e,
         max_u_star=top, atol=atol)


def device_dts(dt, rho):
    """The step-size buffer [dt, rho/dt, dt/rho] of ``dt`` formed on the
    card from a 0-d tensor, as a CFL step forms it."""
    return step_size.buffer(torch.tensor(dt, device=DEV), rho, DEV)


def compare_based_3d(grid, bcs, gamma, gen, errs, dt=1e-3) -> None:
    """Kernel 1 in rk2's ``base`` mode and in its Euler form, and kernel 2,
    each reading the step size from a device buffer of DT_FACTOR * dt,
    against the plain versions given that dt as a float: the tolerances
    of compare_kernels."""
    nu, rho = 0.02, 1.3
    mid, base = random_state(grid, bcs, gen), random_state(grid, bcs, gen)
    dts = device_dts(DT_FACTOR * dt, rho)
    dt_f = float(dts[0])
    e = 0.0
    for b in (base, None):
        k_u, k_rhs = fused3d.predictor_rhs_3d(grid, bcs, mid, dts[0], nu,
                                              gamma, rho, base=b, dts=dts)
        p_u, p_rhs = fused3d.predictor_rhs_plain(grid, bcs, mid, dt_f, nu,
                                                 gamma, rho, base=b)
        e = max(e, *(close(f"u*[{a}] base={b is not None}", k_u[a], p_u[a],
                           1e-5, 1e-5) for a in range(3)))
        e = max(e, close("rhs", k_rhs, p_rhs, 1e-4,
                         3e-7 * float(p_rhs.abs().max())))
    errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)
    p = torch.randn(grid.shape, generator=gen, device=DEV)
    per = periodic_axes(grid, bcs)
    k_n, k_div, k_vel = fused3d.correct_diag_3d(grid, mid, p, dts[2], per)
    p_n, p_div, p_vel = fused3d.correct_diag_plain(grid, mid, p,
                                                   float(dts[2]), per)
    e2 = max(close(f"u_new[{a}]", k_n[a], p_n[a], 1e-5, 1e-5)
             for a in range(3))
    e2 = max(e2, close("max_vel", k_vel, p_vel, 1e-4, 0.0))
    errs["correct_diag_3d"] = max(errs["correct_diag_3d"], e2)
    torch.cuda.synchronize()
    line("phase2", shape=_name(grid.shape), gamma=gamma,
         periodic=json.dumps(per), base_and_device_dt=dt_f,
         max_abs_err=json.dumps({"predictor_rhs_3d": e,
                                 "correct_diag_3d": e2}))


def compare_based_halo(case, n, gen, errs) -> None:
    """Kernel 1 in halo + ``base`` mode on every slab of ``case`` cut into
    ``n``, on a device dt: against its halo-mode plain version and the
    unsharded based kernel's rows, as compare_halo_kernels; the base
    buffers' ghost rows refreshed by the exchange, as the step's first
    refresh leaves them."""
    dt, nu, gamma, rho = DT_FACTOR * 1e-3, 0.02, 0.8, 1.3
    sim = sharded(case, n).sim
    g, bcs = sim.grid, sim.bcs
    step = fused_sharded.SlabStep(sim, sim.mesh)
    mid, base = random_state(g, bcs, gen), random_state(g, bcs, gen)
    step.cur = 1
    step.load(base)
    step.refresh[1].run()
    step.cur = 0
    step.load(mid)
    step.refresh[0].run()
    dts = device_dts(dt, rho)
    g_star, g_rhs = fused3d.predictor_rhs_3d(g, bcs, mid, dts[0], nu, gamma,
                                             rho, base=base, dts=dts)
    b, e, vs_unsharded = step.b, 0.0, 0.0
    for k in range(n):
        halo = step.halo[k]
        ks, krhs = fused3d.predictor_rhs_3d_halo(
            step.slab, bcs, step.u[0][k], dts[0], nu, gamma, rho, halo=halo,
            bc=sim.bc, base=step.u[1][k], dts=dts)
        ps, prhs = fused3d.predictor_rhs_halo_plain(
            step.slab, bcs, step.u[0][k], float(dts[0]), nu, gamma, rho,
            halo, base=step.u[1][k])
        for a in range(3):
            rows = b + (a == 0 and not halo[1])
            e = max(e, close(f"halo base u*[{a}] slab {k}",
                             ks[a][1:rows + 1], ps[a][1:rows + 1], 1e-5,
                             1e-5))
            vs_unsharded = max(vs_unsharded, close(
                f"halo base u*[{a}] slab {k} vs unsharded",
                ks[a][1:rows + 1], g_star[a][k * b:k * b + rows], 1e-6,
                1e-6))
        e = max(e, close(f"halo base rhs slab {k}", krhs, prhs, 1e-4,
                         3e-7 * float(prhs.abs().max())))
        vs_unsharded = max(vs_unsharded, close(
            f"halo base rhs slab {k} vs unsharded", krhs,
            g_rhs[k * b:(k + 1) * b], 1e-6, 1e-6 * float(g_rhs.abs().max())))
    errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)
    torch.cuda.synchronize()
    line("phase2", case=case.name, slabs=n, halo_base_max_abs_err_vs_plain=e,
         halo_base_max_abs_err_vs_unsharded=vs_unsharded)


def compare_based_2d(grid, bcs, dt, nu, gamma, gen, errs) -> None:
    """Kernel 4 in rk2's ``base`` mode and its Euler form, and kernel 5, on
    a device buffer of DT_FACTOR * dt, against the plain versions at that
    dt as a float: the tolerances of compare_kernels_2d."""
    rho = 1.3
    mid = random_state(grid, bcs, gen, scale=0.1)
    base = random_state(grid, bcs, gen, scale=0.1)
    dts = device_dts(DT_FACTOR * dt, rho)
    dt_f = float(dts[0])
    e = 0.0
    for b in (base, None):
        k_u, k_rhs = fused2d.predictor_rhs_2d(grid, bcs, mid, dts[0], nu,
                                              gamma, rho, base=b, dts=dts)
        p_u, p_rhs = fused2d.predictor_rhs_2d_plain(grid, bcs, mid, dt_f, nu,
                                                    gamma, rho, base=b)
        e = max(e, *(close(f"2D u*[{a}] base={b is not None}", k_u[a],
                           p_u[a], 0.0, 2e-6) for a in range(2)))
        e = max(e, close("2D rhs", k_rhs, p_rhs, 0.0,
                         2e-6 * max(float(p_rhs.abs().max()), 1.0)))
    errs["predictor_rhs_2d"] = max(errs["predictor_rhs_2d"], e)
    p = 0.01 * torch.randn(grid.shape, generator=gen, device=DEV)
    k_n, _, k_vel = fused2d.correct_diag_2d(grid, mid, p, dts[2])
    p_n, _, p_vel = fused2d.correct_diag_2d_plain(grid, mid, p,
                                                  float(dts[2]))
    e2 = max(close(f"2D u_new[{a}]", k_n[a], p_n[a], 0.0, 2e-6)
             for a in range(2))
    e2 = max(e2, close("2D max_vel", k_vel, p_vel, 1e-4, 0.0))
    errs["correct_diag_2d"] = max(errs["correct_diag_2d"], e2)
    torch.cuda.synchronize()
    line("phase2", shape=_name(grid.shape), gamma=gamma,
         base_and_device_dt=dt_f,
         max_abs_err=json.dumps({"predictor_rhs_2d": e,
                                 "correct_diag_2d": e2}))


def periodic_2d_bcs(grid, per):
    """Walls with nonzero values of both components on every bounded face,
    and the ``per`` axes periodic."""
    bcs = walls_2d(grid, "all")
    for a in range(2):
        if per[a]:
            bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
    return bcs


def compare_periodic_2d(grid, bcs, dt, nu, gamma, gen, errs, force=None,
                        based=False) -> tuple:
    """Kernels 4 and 5 in their wrap modes (``force``: the static body
    force; ``based``: rk2's base form) against their plain versions on
    random O(0.1) fields and a random pressure, whose gradient at the wrap
    faces is not zero: compare_kernels_2d's tolerances, and face n of a
    periodic axis bit-equal to face 0 in both kernels' outputs. Returns the
    two kernels' errors."""
    rho = 1.3
    per = periodic_axes(grid, bcs)
    u = random_state(grid, bcs, gen, scale=0.1)
    base = random_state(grid, bcs, gen, scale=0.1) if based else None
    k_u, k_rhs = fused2d.predictor_rhs_2d(grid, bcs, u, dt, nu, gamma, rho,
                                          base=base, force=force)
    p_u, p_rhs = fused2d.predictor_rhs_2d_plain(grid, bcs, u, dt, nu, gamma,
                                                rho, base=base, force=force)
    e = max(close(f"wrap u*[{a}]", k_u[a], p_u[a], 0.0, 2e-6)
            for a in range(2))
    e = max(e, close("wrap rhs", k_rhs, p_rhs, 0.0,
                     2e-6 * max(float(p_rhs.abs().max()), 1.0)))
    p = 0.01 * torch.randn(grid.shape, generator=gen, device=DEV)
    scale = dt / rho
    k_n, k_div, k_vel = fused2d.correct_diag_2d(grid, k_u, p, scale, per)
    p_n, p_div, p_vel = fused2d.correct_diag_2d_plain(grid, k_u, p, scale,
                                                      per)
    e2 = max(close(f"wrap u_new[{a}]", k_n[a], p_n[a], 0.0, 2e-6)
             for a in range(2))
    e2 = max(e2, close("wrap max_div", k_div, p_div, 1e-3, 0.0))
    e2 = max(e2, close("wrap max_vel", k_vel, p_vel, 1e-4, 0.0))
    for a in range(2):
        for what, t in (("u*", k_u[a]), ("u_new", k_n[a])):
            if per[a] and not torch.equal(t.select(a, 0), t.select(a, -1)):
                raise AssertionError(f"{what}[{a}]: face n differs from "
                                     "face 0 on a periodic axis")
    errs["predictor_rhs_2d"] = max(errs["predictor_rhs_2d"], e)
    errs["correct_diag_2d"] = max(errs["correct_diag_2d"], e2)
    return e, e2


def perturbed(case, gen, amp=0.05):
    """``case``'s initial state plus O(``amp``) noise, BC-applied (the
    periodic channel's parabola alone is its steady state)."""
    st = case.initial_state()
    g, bcs = case.sim.grid, case.sim.bcs
    u = apply_velocity_bcs(g, bcs, tuple(
        c + amp * torch.randn(c.shape, generator=gen, device=DEV)
        for c in st.u))
    return dataclasses.replace(st, u=u)


def check_wrap_modes_2d(gen, errs):
    """Phase 2 of the periodic 2D cases: kernels 4-5 in their wrap modes
    (:func:`compare_periodic_2d`) on a periodic box, periodic rows and
    periodic lanes on each of PER_P2, Euler at both gammas, with the static
    force, and in rk2's base form with the force; at 2048^2 and 2048x512
    the Taylor-Green and periodic-channel cases' dt and nu, elsewhere h =
    1e-3 with nu dt / h^2 = 0.1. Returns the cases at full width:
    taylor_green, channel_periodic and decaying_turbulence."""
    case_tgp = make_case("taylor_green", shape=PER_SHAPE, device=DEV)
    case_chp = make_case("channel_periodic", shape=PER_CHANNEL, device=DEV)
    case_turb = make_case("decaying_turbulence", shape=PER_SHAPE, device=DEV)
    by_shape = {PER_SHAPE: case_tgp.sim, PER_CHANNEL: case_chp.sim}
    for shape in PER_P2:
        if shape in by_shape:
            s_ = by_shape[shape]
            grid, dt, nu = s_.grid, s_.params.dt, s_.params.nu
        else:
            grid = GridSpec(shape, (1e-3 * shape[0], 1e-3 * shape[1]))
            dt, nu = 1e-5, 0.01
        wrap_errs = {}
        for topo, per in PER_TOPOLOGIES.items():
            bcs = periodic_2d_bcs(grid, per)
            for gamma, force, based in ((0.0, None, False),
                                        (0.8, None, False),
                                        (0.3, PER_FORCE, False),
                                        (0.3, PER_FORCE, True)):
                mode = ("base+force" if based else "force" if force
                        else f"gamma {gamma}")
                wrap_errs[f"{topo} {mode}"] = compare_periodic_2d(
                    grid, bcs, dt, nu, gamma, gen, errs, force, based)
        torch.cuda.synchronize()
        line("phase2", wrap_modes_2d=_name(shape), dt=dt, nu=nu,
             max_abs_err_pred_corr=json.dumps(wrap_errs))
    return case_tgp, case_chp, case_turb


def periodic_steps_vs_plain(case_tgp, case_chp, case_turb, gen) -> None:
    """Phase 3 of the periodic 2D cases at full width, Euler and rk2:
    kernels against step_plain with the 2D whole-step tolerances on u
    (rtol 2e-5 / atol 2e-6) and p rtol 2e-4, p atol 2e-4 of max|p|: the
    float32 roundoff of div u* (~ulp(u)/h a cell) is amplified by rho/dt
    (~5300 at 2048^2) and by the inverse Laplacian of a 2 pi box (the
    flagship's is a unit box), which sends it to the smooth low modes of
    p; the two pressures then differ by ~1.1e-4 of max|p| at 2048^2 while
    u agrees within its tolerance (the p atol 2e-5 of the flagship's check
    fails at 5.4e-5 on the Taylor-Green vortex, max|p| ~0.5). The channel
    starts from its parabola plus O(0.05) noise (:func:`perturbed`)."""
    ch_state = perturbed(case_chp, gen)
    for c, state in ((case_tgp, None), (case_turb, None),
                     (case_chp, ch_state)):
        for integ in ("euler", "rk2"):
            steps_vs_plain(with_params(c, integrator=integ),
                           f"{c.name} {integ}", (2e-5, 2e-6), (2e-4, None),
                           state, p_rel=2e-4)


def periodic_runs(case_tgp, case_chp, case_turb, reset_all) -> None:
    """Phase 4 of the periodic 2D cases at full width: 200 timed steps each
    (after 10 warm-up steps), all launches a step over 5 profiled steps;
    the oracles (the Taylor-Green vortex against its analytic decay, the
    periodic channel's parabola and flux, decaying turbulence at the JAX
    test's size to t = 4); no synchronizing call a step of the turbulence
    under rk2 at cfl 0.5; kernels 4-5 in their wrap modes on the runs'
    states, events against the plain versions and the device time by
    graph replay over rotated input sets beside the host's time a call."""
    per_runs = {}
    for c in (case_tgp, case_turb, case_chp):
        r = timed_run(c, reset_all, lambda: dict(fused2d.LAUNCHES))
        _, _, all_launches = device_profile(
            lambda c=c, r=r: c.sim.run_scan(r["state"], 5), 1)
        per_runs[c.name] = r
        line("phase4", case=c.name, shape=_name(c.sim.grid.shape),
             integrator=c.sim.params.integrator,
             kernel_launches_per_step=json.dumps(
                 {k: v / r["steps"] for k, v in r["launches"].items()}),
             all_launches_per_step=all_launches / 5,
             plans=json.dumps([type(pl).__name__
                               for pl in c.sim.dct_solver.plans]))
    # the Taylor-Green vortex against its analytic decay after its 210
    # steps, within 0.02 exp(-2 nu t) (tests/test_periodic.py)
    sim_t2, r = case_tgp.sim, per_runs["taylor_green"]
    t_end = (r["steps"] + 10) * sim_t2.params.dt
    exact = taylor_green_state(sim_t2.grid, t_end, sim_t2.params.nu, DEV)
    amp = math.exp(-2.0 * sim_t2.params.nu * t_end)
    tg_err = [float((r["state"].u[a] - exact.u[a]).abs().max())
              for a in range(2)]
    if not max(tg_err) < 0.02 * amp:
        raise AssertionError(f"taylor_green decay error {tg_err}, "
                             f"amplitude {amp}")
    # the periodic channel: the parabola persists (drift below 2e-2 of
    # u_max, tests/test_channel.py's bound) and the flux through every x
    # face is the same (within 1e-4 of its mean)
    sim_c2, st_c2 = case_chp.sim, per_runs["channel_periodic"]["state"]
    profile = torch.as_tensor(parabolic_profile(sim_c2.grid, 1.0),
                              device=DEV)
    drift = float((st_c2.u[0] - profile[None, :]).abs().max())
    flux = st_c2.u[0].double().sum(dim=1) * sim_c2.grid.spacing[1]
    flux_spread = float((flux.max() - flux.min()) / flux.mean().abs())
    if not (drift < 2e-2 and flux_spread < 1e-4):
        raise AssertionError(f"periodic channel drift {drift}, flux spread "
                             f"{flux_spread}")
    # decaying turbulence at the JAX test's size to t = 4: the energy
    # decays but keeps 30% of its start, the energy-centroid wavenumber
    # falls below 0.9 of its start (the inverse cascade)
    c_o = make_case("decaying_turbulence", device=DEV, **TURB_ORACLE)
    st_o = c_o.initial_state()
    k_o, e0 = energy_spectrum_2d(c_o.sim.grid, st_o.u)
    ke0 = total_kinetic_energy(c_o.sim.grid, st_o.u)
    n_o = int(round(4.0 / c_o.sim.params.dt))
    st_o, d_o = c_o.sim.run_scan(st_o, n_o)
    _, e1 = energy_spectrum_2d(c_o.sim.grid, st_o.u)
    ke1 = total_kinetic_energy(c_o.sim.grid, st_o.u)
    cen = (float((k_o * e0).sum() / e0.sum()),
           float((k_o * e1).sum() / e1.sum()))
    div_o = float(d_o.max_div[-1])
    if not (0.3 * ke0 < ke1 < ke0 and cen[1] < 0.9 * cen[0]
            and div_o < 1e-4):
        raise AssertionError(f"turbulence oracle: ke {ke0} -> {ke1}, "
                             f"centroid {cen}, max_div {div_o}")
    # rk2 with the CFL dt (cfl 0.5, a cap of 4x the case's dt): no
    # synchronizing call a step, as on the flagship
    sync_turb = syncs_per_step(
        with_params(case_turb, cfl=0.5, dt=4 * case_turb.sim.params.dt).sim,
        case_turb.initial_state())
    if sync_turb != 0:
        raise AssertionError(f"decaying_turbulence rk2 cfl 0.5: {sync_turb} "
                             "synchronizing calls a step")
    line("phase4", taylor_green_err_uv=json.dumps(tg_err),
         taylor_green_amplitude=amp, t_end=t_end,
         channel_periodic_drift=drift, channel_periodic_flux_spread=flux_spread,
         turbulence_ke0_ke1=json.dumps([ke0, ke1]),
         turbulence_centroid0_1=json.dumps(cen), turbulence_steps=n_o,
         turbulence_max_div=div_o, turbulence_rk2_cfl_sync_calls_per_step=0)
    # kernels 4-5 in their wrap modes at full width, on the timed runs'
    # states: the box (the Taylor-Green field, Euler; the turbulence field
    # in rk2's base form) and the periodic rows with the force (the
    # channel); events against the plain versions, and the device time by
    # graph replay over rotated input sets beside the host's time a call
    wraps = {}
    for what, c, based in (("box", case_tgp, False),
                           ("box base", case_turb, True),
                           ("rows force", case_chp, False)):
        s_, st_w = c.sim, per_runs[c.name]["state"]
        g_w, bcs_w, pr_w = s_.grid, s_.bcs, s_.params
        dts_w = s_._dts(None)
        base_w = tuple(x.clone() for x in st_w.u) if based else None
        per_w = periodic_axes(g_w, bcs_w)
        kw_w = dict(bc=s_.bc, dts=dts_w, force=s_.forcing)
        us_w, rhs_w = fused2d.predictor_rhs_2d(
            g_w, bcs_w, st_w.u, dts_w[0], pr_w.nu, pr_w.upwind_gamma,
            pr_w.rho, base=base_w, **kw_w)
        wraps[what] = (c, st_w, base_w, us_w, rhs_w, kw_w, per_w)
    times_w, bounds_w = {}, {}
    calls_w = {}
    for what, (c, st_w, base_w, us_w, rhs_w, kw_w, per_w) in wraps.items():
        s_ = c.sim
        g_w, bcs_w, pr_w = s_.grid, s_.bcs, s_.params
        cells_w = math.prod(g_w.shape)
        calls_w[f"predictor_rhs_2d {what}"] = (
            lambda g_w=g_w, bcs_w=bcs_w, pr_w=pr_w, st_w=st_w, b=base_w,
            kw=kw_w: fused2d.predictor_rhs_2d(
                g_w, bcs_w, st_w.u, kw["dts"][0], pr_w.nu, pr_w.upwind_gamma,
                pr_w.rho, base=b, **kw),
            lambda g_w=g_w, bcs_w=bcs_w, pr_w=pr_w, st_w=st_w, b=base_w,
            kw=kw_w: fused2d.predictor_rhs_2d_plain(
                g_w, bcs_w, st_w.u, float(kw["dts"][0]), pr_w.nu,
                pr_w.upwind_gamma, pr_w.rho, base=b, force=kw["force"]),
            nbytes(*st_w.u, *(base_w or ()), *us_w, rhs_w, s_.bc),
            OPS_PER_CELL["predictor_rhs_2d"] * cells_w)
        if base_w is None:
            scale_w = pr_w.dt / pr_w.rho
            calls_w[f"correct_diag_2d {what}"] = (
                lambda g_w=g_w, us=us_w, st_w=st_w, sc=scale_w, per=per_w:
                fused2d.correct_diag_2d(g_w, us, st_w.p, sc, per),
                lambda g_w=g_w, us=us_w, st_w=st_w, sc=scale_w, per=per_w:
                fused2d.correct_diag_2d_plain(g_w, us, st_w.p, sc, per),
                nbytes(*us_w, st_w.p, *us_w) + 8,
                OPS_PER_CELL["correct_diag_2d"] * cells_w)
    time_pairs(calls_w, times_w, bounds_w)
    for what, (c, st_w, base_w, us_w, rhs_w, kw_w, per_w) in wraps.items():
        s_ = c.sim
        g_w, bcs_w, pr_w = s_.grid, s_.bcs, s_.params
        sets = rotated((*st_w.u, *(base_w or ())),
                       nbytes(*st_w.u, *(base_w or ()), *us_w, rhs_w))
        device_times(f"predictor_rhs_2d {what}", [
            lambda s=s, g_w=g_w, bcs_w=bcs_w, pr_w=pr_w, kw=kw_w:
            fused2d.predictor_rhs_2d(
                g_w, bcs_w, s[:2], kw["dts"][0], pr_w.nu, pr_w.upwind_gamma,
                pr_w.rho, base=s[2:] or None, **kw)
            for s in sets],
            min(times_w[f"predictor_rhs_2d {what}"][0],
                times_w[f"predictor_rhs_2d {what}"][3]))
        if base_w is None:
            scale_w = pr_w.dt / pr_w.rho
            device_times(f"correct_diag_2d {what}", [
                lambda s=s, g_w=g_w, sc=scale_w, per=per_w:
                fused2d.correct_diag_2d(g_w, s[:2], s[2], sc, per)
                for s in rotated((*us_w, st_w.p),
                                 nbytes(*us_w, st_w.p, *us_w))],
                min(times_w[f"correct_diag_2d {what}"][0],
                    times_w[f"correct_diag_2d {what}"][3]))


def compare_device_dt_predictors(grid3, bcs3, sim_p2, gen, errs) -> None:
    """Kernel 6 (with nu_t) on a ragged 3D grid and kernel 8 at the
    cylinder's size, each reading a device dt of DT_FACTOR times the usual
    one, against the plain versions at that dt as a float: the tolerances
    of compare_les_kernels and compare_predictor_2d."""
    u = random_state(grid3, bcs3, gen)
    nu_t = eddy_viscosity(grid3, bcs3, u, LESConfig(cs=0.2))
    dt = torch.tensor(DT_FACTOR * 1e-3, device=DEV)
    k_u = predictor3d.predictor_3d(grid3, bcs3, u, dt, 0.05, 0.8, nu_t=nu_t)
    p_u = predictor3d.predictor_3d_plain(grid3, bcs3, u, float(dt), 0.05, 0.8,
                                         nu_t=nu_t)
    e6 = max(close(f"device-dt u*[{a}] les", k_u[a], p_u[a], 0.0, 5e-5)
             for a in range(3))
    errs["predictor_3d"] = max(errs["predictor_3d"], e6)
    g, b, pr = sim_p2.grid, sim_p2.bcs, sim_p2.params
    u2 = impulsive_start_state(sim_p2).u
    dt2 = torch.tensor(DT_FACTOR * pr.dt, device=DEV)
    k2 = predictor2d.predictor_2d(g, b, u2, dt2, pr.nu, pr.upwind_gamma,
                                  sim_p2.ghosts)
    p2 = predictor2d.predictor_2d_plain(g, b, u2, float(dt2), pr.nu,
                                        pr.upwind_gamma)
    e8 = max(close(f"device-dt predictor_2d u*[{a}]", k2[a], p2[a], 0.0,
                   2e-5) for a in range(2))
    errs["predictor_2d"] = max(errs["predictor_2d"], e8)
    torch.cuda.synchronize()
    line("phase2", device_dt=json.dumps([float(dt), float(dt2)]),
         max_abs_err=json.dumps({"predictor_3d": e6, "predictor_2d": e8}))


def mg_fields(op, gen, offset=False):
    """O(1) random p, b, e on the card, zero on solid cells (the solver's
    p = p * fluid invariant); ``offset``: each a view one element into a
    larger buffer, so 4 bytes off a 16-byte boundary."""
    def field():
        f = torch.randn(op.diag.shape, generator=gen, device=DEV) * op.fluid
        if not offset:
            return f
        buf = torch.empty(f.numel() + 1, device=DEV)
        buf[1:] = f.reshape(-1)
        return buf[1:].view(f.shape)
    return tuple(field() for _ in range(3))


def compare_mg_kernels(op, gen, errs, what, offset=False) -> None:
    """The three multigrid kernels against their plain versions on O(1)
    random fields (``offset``: as :func:`mg_fields` makes them), for
    omega 1.0 and 1.45 and 1, 2 and 8 sweeps. Tolerances
    (tests/test_pallas_mg.py, tests/test_pallas.py): p atol 3e-5; the sum
    of squares rtol 1e-3 against the plain residual norm of the kernel's
    own iterate; r against the plain residual of the kernel's own iterate,
    atol 1e-6 w max|p|: r's terms reach 4 w max|p| (w = 1/h^2, 4.2e6 at
    2048^2), and the kernel adds its five terms in the Pallas order where
    the plain version adds them in the jnp order, so the two differ by a
    few float32 ulps of 4 w max|p| (JAX's 2e-2 at 192x160 is 1.7e-7 w
    max|p|, met there with both sides in XLA's CPU arithmetic)."""
    p, b, e = mg_fields(op, gen, offset)
    w = max(op.w)
    worst = {"r_over_w_maxp": 0.0, "rsq_rel": 0.0}
    for omega in (1.0, 1.45):
        for n in (1, 2, 8):
            k = multigrid_kernels.rb_sweeps(op, p, b, omega, n)
            ref = multigrid_kernels.rb_sweeps_plain(op, p, b, omega, n)
            errs["rb_sweeps"] = max(errs["rb_sweeps"], close(
                f"rb_sweeps w={omega} n={n}", k, ref, 0.0, 3e-5))
            kp, kr = multigrid_kernels.mg_pre_sweeps_residual(op, p, b, n,
                                                              omega)
            pp, _ = multigrid_kernels.mg_pre_sweeps_residual_plain(
                op, p, b, n, omega)
            errs["mg_pre_sweeps_residual"] = max(
                errs["mg_pre_sweeps_residual"],
                close(f"mg_pre p w={omega} n={n}", kp, pp, 0.0, 3e-5))
            scale = w * float(kp.abs().max())
            own = (b - apply_A(op, kp)) * op.fluid
            er = close(f"mg_pre r w={omega} n={n}", kr, own, 0.0,
                       1e-6 * scale)
            worst["r_over_w_maxp"] = max(worst["r_over_w_maxp"], er / scale)
            kp, krsq = multigrid_kernels.mg_add_post_sweeps(op, p, b, e, n,
                                                            omega)
            pp, _ = multigrid_kernels.mg_add_post_sweeps_plain(op, p, b, e,
                                                               n, omega)
            errs["mg_add_post_sweeps"] = max(
                errs["mg_add_post_sweeps"],
                close(f"mg_post p w={omega} n={n}", kp, pp, 0.0, 3e-5))
            rn = residual_norm(op, kp, b)
            close(f"mg_post rsq w={omega} n={n}", torch.sqrt(krsq), rn,
                  1e-3, 0.0)
            worst["rsq_rel"] = max(worst["rsq_rel"], float(
                (torch.sqrt(krsq) - rn).abs() / rn))
            if float((kp * (1.0 - op.fluid)).abs().max()) != 0.0:
                raise AssertionError("mg_post: a solid cell is not zero")
    torch.cuda.synchronize()
    line("phase2", mg_op=what, shape=_name(op.diag.shape), w=w,
         plans=json.dumps({n: multigrid_kernels.level_plan(
             tuple(op.diag.shape), n).args(post=True) for n in (1, 2, 8)}),
         max_abs_err=json.dumps({k: errs[k] for k, (_, src) in KERNELS.items()
                                 if src == "multigrid"}),
         **worst)


def level_calls(n, omega):
    """The three multigrid kernels as calls on (op, p, b, e), ``n``
    sweeps at ``omega``."""
    mk = multigrid_kernels
    return {
        "mg_pre_sweeps_residual":
            lambda op, p, b, e: mk.mg_pre_sweeps_residual(op, p, b, n, omega),
        "mg_add_post_sweeps":
            lambda op, p, b, e: mk.mg_add_post_sweeps(op, p, b, e, n, omega),
        "rb_sweeps": lambda op, p, b, e: mk.rb_sweeps(op, p, b, omega, n),
    }


def tile_calls(n, omega):
    """mg_pre and mg_post as calls on (op, p, b, e, tile=)."""
    mk = multigrid_kernels
    return (lambda op, p, b, e, tile: mk.mg_pre_sweeps_residual(
                op, p, b, n, omega, tile=tile),
            lambda op, p, b, e, tile: mk.mg_add_post_sweeps(
                op, p, b, e, n, omega, tile=tile))


def v_cycle_routes(mg):
    """The solver with each V-cycle route: (fused, rb, plain)."""
    return {"fused": dataclasses.replace(mg, fused=True, use_pallas=False),
            "rb": dataclasses.replace(mg, fused=False, use_pallas=True),
            "plain": dataclasses.replace(mg, fused=False, use_pallas=False)}


def check_iterative(sim, st, diag) -> dict:
    """The gates of a run with an iterative pressure solve, which leaves
    a divergence set by its tolerance rather than by roundoff: the
    corrector makes div u_new = dt/rho (b - A p) exactly, so max|div u_new|
    <= dt/rho ||b - A p||_2. On one more step from ``st`` (after the timed
    run): max_div within that bound plus the direct solve's float32 floor
    (1e-3, the fft gate). Every step of the run: a finite residual, and mg,
    mgcg and dctcg stopped below their cap (on tol, or on the float32
    floor: the stagnation rules of mg and dctcg, mgcg's patience; cg may
    stop at its cap, as bench.py labels it). The bound takes the RHS of
    the extra step's last solve (rk2's stage 2) and its dt. Returns the
    numbers of the extra step."""
    pr, cfg = sim.params, sim.params.poisson
    res = float(diag.poisson_res.max())
    if not math.isfinite(res):
        raise AssertionError(f"{cfg.method}: residual {res}")
    capped = int(diag.poisson_iters.max()) >= cfg.max_iters
    if cfg.method in ("mg", "mgcg", "dctcg") and capped:
        raise AssertionError(f"{cfg.method}: a step ran to its cap")
    rhs = []
    solve = sim._solve_pressure
    sim._solve_pressure = lambda b, *a, **k: (rhs.append(b), solve(b, *a,
                                                                   **k))[1]
    try:
        st_n, d = sim.step(st)
    finally:
        del sim._solve_pressure
    b = poisson.deflate(sim.op, rhs[-1] * sim.op.fluid)
    r2 = float(poisson.residual_norm(sim.op, st_n.p, b))
    bound = 1e-3 + float(d.dt) / pr.rho * r2
    max_div = float(d.max_div)
    if not max_div <= bound:
        raise AssertionError(f"max_div {max_div} above dt/rho ||b - A p|| + "
                             f"1e-3 = {bound}")
    return {"max_res": res, "capped": capped, "next_max_div": max_div,
            "div_bound": bound,
            "next_true_res": r2 / float(torch.linalg.norm(b)),
            "next_res": float(d.poisson_res)}


def with_params(case, **params):
    """``case`` with its simulation's SimParams replaced by ``params``
    (rk2, the CFL dt and its cap)."""
    sim = case.sim
    return dataclasses.replace(case, sim=dataclasses.replace(
        sim, params=dataclasses.replace(sim.params, **params)))


def integrator_modes(case):
    """The rk2 and the CFL variants of ``case`` of phase 3: rk2 at the
    case's dt, and cfl 0.4 with a cap of 10x the case's dt (JAX's
    test_fused3d_cfl_adaptive_matches_reference), where the limiter binds
    from the second step on."""
    return (("rk2", with_params(case, integrator="rk2")),
            ("cfl", with_params(case, cfl=0.4, dt=10 * case.sim.params.dt)))


def steps_vs_plain(case, what, u_tol, p_tol, state=None, steps=5,
                   count_slack=0, p_rel=1e-4) -> None:
    """``steps`` kernel steps against step_plain from ``state`` (the
    case's initial state): the dt series within rtol 3e-5, u and p within
    ``u_tol`` and ``p_tol`` ((rtol, atol); a p atol of None: ``p_rel`` of
    max|p|), solve counts within ``count_slack`` a step, max_div of both
    < 1e-3."""
    sim = case.sim
    st_k = st_p = case.initial_state() if state is None else state
    dk, dp, its = [], [], []
    for _ in range(steps):
        st_k, d_k = sim.step(st_k)
        st_p, d_p = sim.step_plain(st_p)
        dk.append(d_k.dt)
        dp.append(d_p.dt)
        its.append((int(d_k.poisson_iters), int(d_p.poisson_iters)))
    dk, dp = torch.stack(dk), torch.stack(dp)
    close(f"{what} dt series", dk, dp, 3e-5, 0.0)
    eu = max(close(f"{what} u[{a}]", st_k.u[a], st_p.u[a], *u_tol)
             for a in range(sim.grid.ndim))
    max_p = float(st_p.p.abs().max())
    ep = close(f"{what} p", st_k.p, st_p.p, p_tol[0],
               p_rel * max_p if p_tol[1] is None else p_tol[1])
    if any(abs(a - b) > count_slack for a, b in its):
        raise AssertionError(f"{what}: solve counts kernel vs plain {its}")
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"{what} max_div {divs} not < 1e-3")
    line("phase3", case=json.dumps(what), shape=_name(sim.grid.shape),
         integrator=sim.params.integrator, cfl=sim.params.cfl, steps=steps,
         dt_series=json.dumps([float(x) for x in dk]),
         iters_kernel_plain=json.dumps(its), u_max_abs_err=eu,
         p_max_abs_err=ep, max_abs_p=max_p, max_div_kernel=divs[0],
         max_div_plain=divs[1])


def timed_run(case, reset, counts, steps=TIMED_STEPS, state=None,
              warmup=10) -> dict:
    """``warmup`` steps (from ``state``, else the case's initial state),
    then ``steps`` steps of ``case`` by CUDA events, the launch counts
    reset just before and read just after (``counts()``: the path's
    counters); checks the gates (every kernel launched, finite fields of
    the right shape, max_div < 1e-3 for the direct solve and
    :func:`check_iterative` for the iterative ones). Returns the run's
    numbers."""
    sim = case.sim
    st, _ = sim.run_scan(case.initial_state() if state is None else state,
                         warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    poisson.reset_host_syncs()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    st, diag = sim.run_scan(st, steps)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    syncs = poisson.HOST_SYNCS["poisson"]
    ms = start.elapsed_time(stop) / steps
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} launched {n} times in the run")
    for a, t in enumerate((*st.u, st.p)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite field {a} after the timed run")
    for a in range(sim.grid.ndim):
        if tuple(st.u[a].shape) != sim.grid.face_shape(a):
            raise AssertionError(f"u[{a}] shape {tuple(st.u[a].shape)}")
    max_div = float(diag.max_div.max())
    dt_range = (float(diag.dt.min()), float(diag.dt.max()))
    extra = {}
    if sim.dct_solver is not None:
        extra["fuse_trailing"] = sim.dct_solver.fuse_trailing
    if sim.mesh is not None:
        extra["slabs"] = sim.mesh.size
    if sim.params.poisson.method == "fft":
        if not max_div < 1e-3:
            raise AssertionError(f"max_div {max_div} not < 1e-3")
    else:
        extra = check_iterative(sim, st, diag)
    iters = diag.poisson_iters.float()
    cells = math.prod(sim.grid.shape)
    line("phase4", case=case.name, shape=_name(sim.grid.shape),
         poisson=sim.params.poisson.method,
         les=None if sim.les is None else sim.les.cs,
         ibm=sim.ibm is not None, integrator=sim.params.integrator,
         cfl=sim.params.cfl, dt_min_max=json.dumps(dt_range), steps=steps,
         ms_per_step=f"{ms:.4f}",
         mlups=f"{cells * 1e-3 / ms:.1f}", wall_s=f"{wall:.3f}",
         max_div=max_div, max_div_at_step=int(diag.max_div.argmax()),
         max_cfl=float(diag.max_cfl[-1]),
         poisson_res=float(diag.poisson_res[-1]),
         poisson_iters_mean_min_max=json.dumps(
             [float(iters.mean()), int(iters.min()), int(iters.max())]),
         host_syncs_per_step=syncs / steps,
         launches=json.dumps(launches),
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         **extra)
    return {"state": st, "launches": launches, "ms": ms, "max_div": max_div,
            "dt": dt_range, "steps": steps}


def syncs_per_step(sim, state, steps=20) -> float:
    """Synchronizing CUDA calls a step of ``run_scan`` from ``state``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (after a
    2-step warm-up, which builds what a simulation caches)."""
    import warnings

    st, _ = sim.run_scan(state, 2)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run_scan(st, steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught) / steps


def time_pairs(calls, times, bounds) -> None:
    """Each (kernel, plain, bytes, operations[, peak operations/s]) entry
    timed in the order kernel, plain, plain, kernel (20 calls each), into
    ``times``; its bound (the larger of bytes over the memory rate and
    operations over their peak rate, float32 unless given, in ms, and which
    one) into ``bounds``."""
    for k, (kern, plain, nbytes, ops, *rate) in calls.items():
        times[k] = (time_ms(kern, 20), time_ms(plain, 20),
                    time_ms(plain, 20), time_ms(kern, 20))
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / (rate[0] if rate else FP32_OPS_PER_S) * 1e3
        bounds[k] = ((by_bytes, "bytes") if by_bytes >= by_ops
                     else (by_ops, "operations"))
        line("phase4", kernel=k, ms_kernel_plain_plain_kernel=json.dumps(
            [round(x, 4) for x in times[k]]), bound_ms=f"{bounds[k][0]:.4f}",
            bound_by=bounds[k][1], mbytes=f"{nbytes / 1e6:.1f}",
            gops=f"{ops / 1e9:.3f}")


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_summary(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` report as kernel -> "registers/spill bytes/
    static shared memory bytes", the kernel named by its template
    arguments (``predictor_rhs_kernel<3, 6>``: halo mask 3, periodic mask
    6; ``predictor_3d_kernel<0, 1, 0>``: a bool is 0 or 1)."""
    out, name, spill = {}, None, ""
    for l in log.splitlines():
        if "Compiling entry function" in l:
            # the mangled name's length-prefixed identifier ending in
            # "kernel" (not the anonymous namespace's tag before it)
            m = next((m for m in re.finditer(
                r"(?=(\d+)([a-z_][a-z0-9_]*kernel)((?:I?L[ib]\d+E)*))", l)
                if len(m.group(2)) == int(m.group(1))), None)
            args = re.findall(r"L[ib](\d+)E", m.group(3)) if m else []
            name = (m.group(2) + (f"<{', '.join(args)}>" if args else "")
                    if m else l.strip())
        elif "spill stores" in l:
            spill = l.split(",")[1].strip().split()[0]
        elif "Used" in l and "registers" in l and name is not None:
            regs = re.search(r"Used (\d+) registers", l).group(1)
            smem = re.search(r"(\d+) bytes smem", l)
            out[name] = f"{regs}/{spill}/{smem.group(1) if smem else 0}"
    return out


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of ``fn``: the enqueue alone, the host
    clock around ``reps`` calls with no synchronize inside (the calls'
    device work queues behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after two warm-up calls, by
    CUDA events."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_graph_ms(fns, reps: int = 20) -> float:
    """Mean ms per call without the host's enqueue: ``reps`` calls (at
    least one a callable) captured in one CUDA graph after an eager call of
    each, call r running ``fns[r % len(fns)]``, the graph replayed 5 times
    between CUDA events. Each call's outputs stay alive until the timing
    ends, so no call writes into another's memory. With one callable whose
    buffers fit in L2 this reads below a kernel's HBM bound; over the sets
    of :func:`rotated` every call reads its inputs from HBM."""
    reps = max(reps, len(fns))
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    keep = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            keep.append(fns[r % len(fns)]())
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del keep, graph
    return start.elapsed_time(stop) / (5 * reps)


def rotated(inputs, call_bytes: int) -> list:
    """``inputs`` (a tuple of tensors, or of a PoissonOp and tensors) and
    copies of it: enough sets that one pass of calls over them moves three
    times the L2 cache (``call_bytes`` a call), at least two."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return dataclasses.replace(x, diag=x.diag.clone(), code=x.code.clone())
    n = max(2, math.ceil(3 * L2_BYTES / call_bytes))
    return [inputs] + [tuple(copy(x) for x in inputs) for _ in range(n - 1)]


def device_times(name, fns, event_ms) -> None:
    """Prints kernel ``name``'s device time by CUDA-graph replay over
    ``fns`` (one callable a rotated input set) beside its CUDA-event time
    ``event_ms`` and the host's microseconds a call (the wrapper's
    enqueue): the events read the host wherever it is slower."""
    line("phase4", kernel=name, device_ms_graph=f"{time_graph_ms(fns):.4f}",
         event_ms=f"{event_ms:.4f}", host_us_per_call=f"{host_us(fns[0]):.1f}",
         input_sets=len(fns))


def main() -> None:
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("phase1", card=json.dumps(smi), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    _native.load_all(SOURCES)                 # one nvcc per source, together
    build_s = time.perf_counter() - t0
    ptxas_all = {}
    for src in SOURCES:
        ptxas = ptxas_summary(_native.BUILD_INFO[src][1])
        line("phase1", source=src, build_seconds=f"{build_s:.2f}",
             nvcc_seconds=f"{_native.BUILD_INFO[src][0]:.2f}",
             ptxas=json.dumps(ptxas))
        # the redesigned kernels must not spill: kernels 1-2 (68
        # instantiations in all), 4 (32) and 5 (4), 6 (4), 7, 8 (2), 9-10
        # (one each) and 11; a library loaded from an earlier build has no
        # report
        spilled = {k: v for k, v in ptxas.items()
                   if k.startswith(NO_SPILL_KERNELS) and v.split("/")[1] != "0"}
        built = _native.BUILD_INFO[src][0] > 0
        if (src in PTXAS_KERNELS and built
                and (len(ptxas) != PTXAS_KERNELS[src] or spilled)):
            raise AssertionError(f"{src} ptxas: {len(ptxas)} kernels, "
                                 f"expected {PTXAS_KERNELS[src]}; spills "
                                 f"{spilled}")
        ptxas_all.update(ptxas)
    # the Euler instantiations' registers, before beside this build's
    # (with the template arguments added since, 0 for the Euler walls form)
    regs = {}
    for kern, table in EULER_REGISTERS_BEFORE.items():
        suffix = EULER_SUFFIX.get(kern, "")
        for args, old in table.items():
            now = f"{kern}<{args}{suffix}>" if args or suffix else kern
            if now in ptxas_all:
                regs[now] = [old, int(ptxas_all[now].split("/")[0])]
    line("phase1", euler_registers_before_now=json.dumps(regs))

    # -- phase 2: each kernel against its plain version --------------------
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    big = GridSpec(SHAPE, (1.0, 1.0, 1.0))
    big_bcs = no_slip_box(big)
    big_bcs[(2, 1)] = BCSpec.wall((1.0, 0.0, 0.0))
    rag = GridSpec(RAGGED, (1.0, 0.6, 1.8))
    rag_bcs = no_slip_box(rag)
    rag_bcs[(2, 1)] = BCSpec.wall((1.0, 0.3, 0.0))
    for grid, bcs in ((rag, rag_bcs), (big, big_bcs)):
        for gamma in (0.0, 0.8):
            compare_kernels(grid, bcs, gamma, gen, errs)
            compare_les_kernels(grid, bcs, gamma, gen, errs)
    rag_w = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    rag_w_bcs = no_slip_box(rag_w)
    rag_w_bcs[(2, 1)] = BCSpec.wall((1.0, 0.3, 0.0))
    rag_p = GridSpec(RAGGED_PER, (1.0, 0.6, 1.8))
    for grid, bcs in ((rag_w, rag_w_bcs), (rag_p, periodic_bcs(rag_p))):
        for gamma in (0.0, 0.8):
            compare_kernels(grid, bcs, gamma, gen, errs)
    # kernels 6-7 march the same tiles
    for gamma in (0.0, 0.8):
        compare_les_kernels(rag_w, rag_w_bcs, gamma, gen, errs)
    # kernel 1's rk2 base mode and kernels 1-2 on a device step size: the
    # ragged tables (walls, mixed periodic) at both gammas, then 256^3
    for grid, bcs in ((rag_w, rag_w_bcs), (rag_p, periodic_bcs(rag_p)),
                      (rag, periodic_bcs(rag))):
        for gamma in (0.0, 0.8):
            compare_based_3d(grid, bcs, gamma, gen, errs)
    # the periodic modes of the three 3D kernels: a ragged mixed
    # wall/periodic table and the Taylor-Green box at 256^3 (every axis
    # periodic); then kernel 12 on the per-axis matrices of the 256^3
    # cavity ('nn'), of the Taylor-Green box ('per') and of a ragged mixed
    # solver
    case_tg = make_case("taylor_green3d", shape=SHAPE, device=DEV)
    sim_tg = case_tg.sim
    for grid, bcs in ((rag, periodic_bcs(rag)), (sim_tg.grid, sim_tg.bcs)):
        for gamma in (0.0, 0.8):
            compare_kernels(grid, bcs, gamma, gen, errs)
    for grid, bcs in ((big, big_bcs), (sim_tg.grid, sim_tg.bcs)):
        compare_based_3d(grid, bcs, 0.8, gen, errs)
    for solver in (fft_poisson.DCTPoissonSolver.build(big, DEV),
                   sim_tg.dct_solver,
                   fft_poisson.DCTPoissonSolver.build(
                       rag, DEV, kinds=("nd", "nn", "per"))):
        compare_trailing(solver, gen, errs)
    # the sharded step's kernels at 256^3 in 4 slabs of 64 rows and in 16
    # of 16: the exchanges bounded (the cavity) and on a ring (the
    # Taylor-Green box), and kernels 1 and 2 in their halo mode on every slab
    case = make_case("cavity3d", shape=SHAPE, device=DEV)
    for n in SLABS:
        for c in (case, case_tg):
            sim_s = sharded(c, n).sim
            compare_exchanges(fused_sharded.SlabStep(sim_s, sim_s.mesh), gen,
                              errs)
            compare_halo_kernels(c, n, gen, errs)
    for c in (case, case_tg):
        compare_based_halo(c, SLABS[0], gen, errs)
    case2 = make_case("cavity", device=DEV, **FLAGSHIP)
    sim2 = case2.sim
    # kernel 4 marches warps of 29 cells of axis 1 down runs of 32-64 rows:
    # (200, 136) with a lid; (37, 45) and (20, 136) (fewer rows than a
    # run) with nonzero wall values on all four faces; (200, 13) (fewer
    # columns than a warp); n1 % 4 != 0 in (37, 45) and (200, 13)
    grids2 = []
    for shape, lengths, walls in ((RAGGED2, (1.0, 0.68), "lid"),
                                  ((37, 45), (0.9, 1.3), "all"),
                                  ((20, 136), (0.3, 1.0), "all"),
                                  ((200, 13), (1.0, 0.2), "lid")):
        grid = GridSpec(shape, lengths)
        grids2.append((grid, walls_2d(grid, walls), 1e-3, 0.01))
    grids2.append((sim2.grid, sim2.bcs, sim2.params.dt, sim2.params.nu))
    for grid, bcs, dt, nu in grids2:
        for gamma in (0.0, 0.8):
            compare_kernels_2d(grid, bcs, dt, nu, gamma, gen, errs)
    # kernel 4's rk2 base mode and kernels 4-5 on a device step size: the
    # ragged grids at both gammas and the flagship at its own
    for grid, bcs, dt, nu in grids2[:-1]:
        for gamma in (0.0, 0.8):
            compare_based_2d(grid, bcs, dt, nu, gamma, gen, errs)
    compare_based_2d(sim2.grid, sim2.bcs, sim2.params.dt, sim2.params.nu,
                     sim2.params.upwind_gamma, gen, errs)
    case_tgp, case_chp, case_turb = check_wrap_modes_2d(gen, errs)
    # the per-component 2D predictor at the cylinder's and the channel's
    # timed sizes with their tables, dt and nu, and on the ragged grids of
    # RAGGED_P2 (h = 1/32 and 1/6) and on P2_LARGE with the cylinder's
    # table, the channel's with a tangential inflow profile and a lid
    # profile; each on a random state, on fields 4 bytes off a 16-byte
    # boundary and on a state with exact zero velocities
    case_cyl = make_case("cylinder", shape=CYL_SHAPE, ibm=True, device=DEV)
    sim_cyl = case_cyl.sim
    case_ch = make_case("channel", shape=CHANNEL_SHAPE, device=DEV)
    sim_ch = case_ch.sim
    p2_cases = [(sim_cyl.grid, cylinder_bcs(), sim_cyl.params.dt,
                 sim_cyl.params.nu, "cylinder"),
                (sim_ch.grid, channel_bcs(sim_ch.grid, gen),
                 sim_ch.params.dt, sim_ch.params.nu, "channel")]
    for shape, lengths, dt, nu in [(s, (6.25, 4.25), 0.01, 0.005)
                                   for s in RAGGED_P2] + [P2_LARGE]:
        grid = GridSpec(shape, lengths)
        p2_cases += [(grid, cylinder_bcs(), dt, nu, "cylinder"),
                     (grid, channel_bcs(grid, gen), dt, nu, "channel"),
                     (grid, lid_profile_bcs(grid, gen), dt, nu, "lid")]
    for grid, bcs, dt, nu, what in p2_cases:
        for gamma in (0.0, 0.2):
            for mode in ("random", "offset", "zeros"):
                compare_predictor_2d(grid, bcs, dt, nu, gamma, gen, errs,
                                     what, mode)
    # kernels 6 and 8 on a device dt
    compare_device_dt_predictors(rag_w, rag_w_bcs, sim_cyl, gen, errs)
    # the split-level direct solve (4 levels per axis at 2048) against the
    # dense one on the same RHS: both exact up to float32 roundoff of
    # 2048-term transforms, so rtol 1e-3 of max|p|
    split = sim2.dct_solver
    dense = fft_poisson.DCTPoissonSolver.build(sim2.grid, DEV, split_levels=0)
    levels = [pl.levels for pl in split.plans]
    if levels != [fft_poisson.auto_split_levels(n) for n in SHAPE2]:
        raise AssertionError(f"split levels {levels}")
    b2 = torch.randn(SHAPE2, generator=gen, device=DEV)
    b2 = b2 - b2.mean()
    p_split, p_dense = split._direct(b2), dense._direct(b2)
    e = close("split vs dense solve", p_split, p_dense, 0.0,
              1e-3 * float(p_dense.abs().max()))
    line("phase2", split_levels=json.dumps(levels),
         split_vs_dense_max_abs_err=e, max_abs_p=float(p_dense.abs().max()))
    # the multigrid level kernels on a ragged operator with a solid block
    # and an OUTFLOW face, and on the mgcg flagship's level-0 operator
    case_mg = make_case("cavity", device=DEV, poisson_method="mgcg",
                        **FLAGSHIP)
    sim_mg = case_mg.sim
    mg = sim_mg.mg_solver
    mg_levels = [tuple(o.diag.shape) for o in mg.ops]
    if mg_levels[-1] != (16, 16) or len(mg_levels) != 8 or not mg.fused:
        raise AssertionError(f"mgcg hierarchy {mg_levels}, fused {mg.fused}")
    rag_mg = GridSpec(RAGGED2, (1.0, 0.68))
    rag_mg_bcs = no_slip_box(rag_mg)
    rag_mg_bcs[(0, 1)] = BCSpec(BCKind.OUTFLOW)
    solid = torch.zeros(RAGGED2, dtype=torch.bool)
    solid[60:100, 30:70] = True
    op_rag = build_poisson_op(rag_mg, rag_mg_bcs, DEV, solid.numpy())
    # the kernels copy 16 bytes a piece where n1 % 4 == 0 and the arrays
    # are 16-byte aligned, else 4: a (131, 45) operator and fields 4 bytes
    # off a 16-byte boundary take the second way; the mgcg levels 0 and 4
    # (2048^2, 128^2) take the level kernels' two tile sizes
    rag_odd = GridSpec((131, 45), (1.0, 0.4))
    op_odd = build_poisson_op(rag_odd, no_slip_box(rag_odd), DEV)
    for op, what, offset in ((op_rag, "solid+outflow", False),
                             (op_rag, "solid+outflow, 4-byte offset", True),
                             (op_odd, "131x45", False),
                             (mg.ops[0], "mgcg level 0", False),
                             (mg.ops[4], "mgcg level 4", False)):
        compare_mg_kernels(op, gen, errs, what, offset)
    # one whole V-cycle on the fused and RB routes against the plain route
    # (the same smoother arithmetic up to float32 roundoff): p within 1e-3
    # relative, tests/test_pallas_mg.py's solve tolerance
    routes = v_cycle_routes(mg)
    b_v = torch.randn(SHAPE2, generator=gen, device=DEV)
    b_v = b_v - b_v.mean()
    p_ref = routes["plain"]._v_cycle(0, torch.zeros_like(b_v), b_v)
    rels = {}
    for name in ("fused", "rb"):
        got = routes[name]._v_cycle(0, torch.zeros_like(b_v), b_v)
        rels[name] = float(torch.linalg.norm(got - p_ref)
                           / torch.linalg.norm(p_ref))
        if not rels[name] < 1e-3:
            raise AssertionError(f"{name} V-cycle vs plain: rel {rels[name]}")
    line("phase2", v_cycle_levels=json.dumps(mg_levels),
         v_cycle_rel_err_vs_plain=json.dumps(rels))

    # -- phase 3: 5 steps, kernels vs plain composition --------------------
    # 256^3: tests/test_fused_step.py's tolerances, except max_div: its
    # 5e-6 bound is for 16^3; float32 roundoff of the divergence at h =
    # 1/256 is ~3e-5, so both runs are held below 1e-3.
    sim = case.sim
    st_k = st_p = case.initial_state()
    for _ in range(5):
        st_k, d_k = sim.step(st_k)
        st_p, d_p = sim.step_plain(st_p)
    for a in range(3):
        close(f"5-step u[{a}]", st_k.u[a], st_p.u[a], 2e-5, 1e-6)
    close("5-step p", st_k.p, st_p.p, 2e-4, 1e-6)
    close("5-step max_cfl", d_k.max_cfl, d_p.max_cfl, 1e-3, 1e-8)
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"5-step max_div {divs} not < 1e-3")
    line("phase3", shape=_name(SHAPE), steps=5, max_div_kernel=divs[0],
         max_div_plain=divs[1], max_cfl=float(d_k.max_cfl),
         poisson_res=float(d_k.poisson_res))
    # 2048^2 flagship: tests/test_pallas2d.py's whole-step tolerances
    st_k = st_p = case2.initial_state()
    for _ in range(5):
        st_k, d_k = sim2.step(st_k)
        st_p, d_p = sim2.step_plain(st_p)
    for a in range(2):
        close(f"2D 5-step u[{a}]", st_k.u[a], st_p.u[a], 2e-5, 2e-6)
    close("2D 5-step p", st_k.p, st_p.p, 2e-4, 2e-5)
    close("2D 5-step max_cfl", d_k.max_cfl, d_p.max_cfl, 1e-3, 1e-8)
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"2D 5-step max_div {divs} not < 1e-3")
    line("phase3", shape=_name(SHAPE2), steps=5, max_div_kernel=divs[0],
         max_div_plain=divs[1], max_cfl=float(d_k.max_cfl),
         poisson_res=float(d_k.poisson_res))
    # 256^3 LES: tests/test_pallas.py's kernel-vs-jnp LES step tolerance
    # (u atol 5e-5), max_div of both < 1e-3
    case_les = dataclasses.replace(
        case, sim=dataclasses.replace(sim, les=LESConfig(cs=0.17)))
    sim_les = case_les.sim
    st_k = st_p = case_les.initial_state()
    for _ in range(5):
        st_k, d_k = sim_les.step(st_k)
        st_p, d_p = sim_les.step_plain(st_p)
    e = max(close(f"LES 5-step u[{a}]", st_k.u[a], st_p.u[a], 0.0, 5e-5)
            for a in range(3))
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"LES 5-step max_div {divs} not < 1e-3")
    line("phase3", shape=_name(SHAPE), les_cs=0.17, steps=5,
         u_max_abs_err=e, max_div_kernel=divs[0], max_div_plain=divs[1],
         max_cfl=float(d_k.max_cfl), poisson_res=float(d_k.poisson_res))
    # 2048^2 mgcg, kernels against step_plain (the plain V-cycle route):
    # the flagship's whole-step tolerances; CG iterations per step equal,
    # or one apart where a residual sits within float32 roundoff of tol
    st_k = st_p = case_mg.initial_state()
    its, ress = [], []
    for _ in range(5):
        st_k, d_k = sim_mg.step(st_k)
        st_p, d_p = sim_mg.step_plain(st_p)
        its.append((int(d_k.poisson_iters), int(d_p.poisson_iters)))
        ress.append((float(d_k.poisson_res), float(d_p.poisson_res)))
    line("phase3", shape=_name(SHAPE2), poisson="mgcg", steps=5,
         iters_kernel_plain=json.dumps(its),
         res_kernel_plain=json.dumps(ress))
    if any(abs(a - b) > 1 for a, b in its):
        raise AssertionError(f"mgcg iterations kernel vs plain {its}")
    for a in range(2):
        close(f"mgcg 5-step u[{a}]", st_k.u[a], st_p.u[a], 2e-5, 2e-6)
    e = close("mgcg 5-step p", st_k.p, st_p.p, 2e-4, 2e-5)
    close("mgcg 5-step max_cfl", d_k.max_cfl, d_p.max_cfl, 1e-3, 1e-8)
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"mgcg 5-step max_div {divs} not < 1e-3")
    line("phase3", shape=_name(SHAPE2), poisson="mgcg", steps=5,
         p_max_abs_err=e, max_abs_p=float(st_p.p.abs().max()),
         max_div_kernel=divs[0], max_div_plain=divs[1])
    # the IBM cylinder at 512x256 from the impulsive start, the predictor
    # kernel against step_plain: Richardson sweeps equal every step, u with
    # the 2D whole-step tolerances, p within 1e-4 of max|p| (the solve
    # stops at a relative residual of 1e-5), max_div of both < 1e-3
    case_base = make_case("cylinder", shape=CYL_BASE, ibm=True, device=DEV)
    sim_base = case_base.sim
    st_k = st_p = impulsive_start_state(sim_base)
    its, ress = [], []
    for _ in range(5):
        st_k, d_k = sim_base.step(st_k)
        st_p, d_p = sim_base.step_plain(st_p)
        its.append((int(d_k.poisson_iters), int(d_p.poisson_iters)))
        ress.append((float(d_k.poisson_res), float(d_p.poisson_res)))
    line("phase3", shape=_name(CYL_BASE), case="cylinder", ibm=True,
         poisson="dctcg", steps=5, sweeps_kernel_plain=json.dumps(its),
         res_kernel_plain=json.dumps(ress))
    if any(a != b for a, b in its):
        raise AssertionError(f"cylinder sweeps kernel vs plain {its}")
    e = max(close(f"cylinder 5-step u[{a}]", st_k.u[a], st_p.u[a], 2e-5,
                  2e-6) for a in range(2))
    ep = close("cylinder 5-step p", st_k.p, st_p.p, 0.0,
               1e-4 * float(st_p.p.abs().max()))
    divs = (float(d_k.max_div), float(d_p.max_div))
    if not max(divs) < 1e-3:
        raise AssertionError(f"cylinder 5-step max_div {divs} not < 1e-3")
    line("phase3", shape=_name(CYL_BASE), case="cylinder", steps=5,
         u_max_abs_err=e, p_max_abs_err=ep,
         max_abs_p=float(st_p.p.abs().max()), max_div_kernel=divs[0],
         max_div_plain=divs[1], max_cfl=float(d_k.max_cfl))
    # taylor_green3d 256^3: the 3D kernels in their periodic mode against
    # step_plain, with tests/test_fused_step.py's periodic whole-step
    # tolerances (u rtol 2e-5 / atol 2e-6, p rtol 2e-4 / atol 2e-5, max_cfl
    # rtol 1e-3); taylor_green3d and cavity3d 256^3 with fuse_trailing
    # against step_plain, which takes the fused route's plain version (the
    # same 3-pass bf16 products): u rtol 2e-5 / atol 1e-5 and p rtol 2e-4 /
    # atol 1e-5 max|p|, since the two 768-term transform chains sum in other
    # orders and differ by a few ulps of max|p| after the refinement pass,
    # and the corrector passes dt/h (~0.5) of that gradient on to u. max_div
    # of both < 1e-3.
    case_tg_f = with_fused_trailing(case_tg)
    case_f = with_fused_trailing(case)
    for c, u_atol, p_atol, what in (
            (case_tg, 2e-6, 2e-5, "taylor_green3d"),
            (case_tg_f, 1e-5, None, "taylor_green3d fuse_trailing"),
            (case_f, 1e-5, None, "cavity3d fuse_trailing")):
        st_k = st_p = c.initial_state()
        for _ in range(5):
            st_k, d_k = c.sim.step(st_k)
            st_p, d_p = c.sim.step_plain(st_p)
        e = max(close(f"{what} 5-step u[{a}]", st_k.u[a], st_p.u[a], 2e-5,
                      u_atol) for a in range(3))
        max_p = float(st_p.p.abs().max())
        ep = close(f"{what} 5-step p", st_k.p, st_p.p, 2e-4,
                   p_atol if p_atol is not None else 1e-5 * max_p)
        close(f"{what} 5-step max_cfl", d_k.max_cfl, d_p.max_cfl, 1e-3, 1e-8)
        divs = (float(d_k.max_div), float(d_p.max_div))
        if not max(divs) < 1e-3:
            raise AssertionError(f"{what} 5-step max_div {divs} not < 1e-3")
        line("phase3", shape=_name(SHAPE), case=json.dumps(what), steps=5,
             u_max_abs_err=e, p_max_abs_err=ep, max_abs_p=max_p,
             max_div_kernel=divs[0], max_div_plain=divs[1],
             max_cfl=float(d_k.max_cfl), poisson_res=float(d_k.poisson_res))
    # the sharded step in 4 and in 16 slabs against the unsharded kernel
    # step: the same arithmetic per cell and the same solve of the joined
    # RHS, so the fields should agree exactly; held within rtol = atol = 1e-6
    for c in (case, case_tg):
        ref, d_u = c.sim.run_scan(c.initial_state(), 5)
        for n in SLABS:
            sim_s = sharded(c, n).sim
            st_s, d_s = sim_s.run_scan(
                shard_state(c.initial_state(), sim_s.mesh, sim_s.grid), 5)
            what = f"{c.name} in {n} slabs"
            eu = max(close(f"{what} 5-step u[{a}]", st_s.u[a], ref.u[a],
                           1e-6, 1e-6) for a in range(3))
            ep = close(f"{what} 5-step p", st_s.p, ref.p, 1e-6, 1e-6)
            close(f"{what} max_div", d_s.max_div, d_u.max_div, 1e-6, 1e-12)
            close(f"{what} max_cfl", d_s.max_cfl, d_u.max_cfl, 1e-6, 1e-12)
            line("phase3", shape=_name(SHAPE), case=c.name,
                 ring=periodic_axes(c.sim.grid, c.sim.bcs)[0], slabs=n,
                 steps=5, u_max_abs_diff=eu, p_max_abs_diff=ep,
                 max_div_sharded_unsharded=json.dumps(
                     [float(d_s.max_div[-1]), float(d_u.max_div[-1])]))

    # rk2 and the CFL dt on every route, kernels against step_plain, with
    # the tolerances of the CPU tests (tests/test_torch_integrators.py):
    # rk2 u rtol 2e-5 / atol 2e-6 and p rtol 2e-4 / atol 2e-5, the CFL dt
    # u rtol 5e-5 / atol 5e-6 and p rtol 5e-4 / atol 5e-5; the LES step's
    # u atol 5e-5 (its kernels' tolerance, as above); the cylinder's p
    # within 1e-4 of max|p| (its solve stops at a relative residual of
    # 1e-5, as above), its sweeps within one a solve of the plain run's
    # (a residual at the float32 floor may sit on either side of tol)
    tol = {"rk2": ((2e-5, 2e-6), (2e-4, 2e-5)),
           "cfl": ((5e-5, 5e-6), (5e-4, 5e-5))}
    for c, what in ((case, "cavity3d"), (case_tg, "taylor_green3d"),
                    (case2, "cavity 2048^2"), (case_base, "cylinder ibm"),
                    (case_les, "cavity3d les")):
        for mode, cm in integrator_modes(c):
            u_tol, p_tol = tol[mode]
            slack = 0
            state = None
            if c is case_les:
                u_tol = (0.0, 5e-5)
            if c is case_base:
                p_tol, state = (0.0, None), impulsive_start_state(cm.sim)
                slack = 2 if mode == "rk2" else 1
            steps_vs_plain(cm, f"{what} {mode}", u_tol, p_tol, state,
                           count_slack=slack)
    # the slab tier in 4 slabs against the unsharded kernel step, rk2 and
    # the CFL dt: rtol = atol = 1e-6 (the Euler check's) on the fields and
    # the dt series; kernel 14 six times a step under rk2 (three under
    # Euler)
    for mode, cm in integrator_modes(case):
        ref, d_u = cm.sim.run_scan(cm.initial_state(), 5)
        sim_s = sharded(cm, SLABS[0]).sim
        remote_dma.reset_launch_counts()
        st_s, d_s = sim_s.run_scan(
            shard_state(cm.initial_state(), sim_s.mesh, sim_s.grid), 5)
        n_ex = remote_dma.LAUNCHES["exchange_rows_multi"]
        want_ex = (6 if mode == "rk2" else 3) * 5
        if n_ex != want_ex:
            raise AssertionError(f"{mode} in 4 slabs: {n_ex} exchange "
                                 f"launches in 5 steps, expected {want_ex}")
        what = f"cavity3d {mode} in {SLABS[0]} slabs"
        eu = max(close(f"{what} u[{a}]", st_s.u[a], ref.u[a], 1e-6, 1e-6)
                 for a in range(3))
        close(f"{what} p", st_s.p, ref.p, 1e-6, 1e-6)
        close(f"{what} dt series", d_s.dt, d_u.dt, 1e-6, 0.0)
        line("phase3", case=json.dumps(what), steps=5,
             exchange_launches_per_step=n_ex / 5, u_max_abs_diff=eu,
             dt_series=json.dumps(d_s.dt.tolist()))

    periodic_steps_vs_plain(case_tgp, case_chp, case_turb, gen)

    # -- phase 4: the timed main paths --------------------------------------
    def reset_all():
        fused3d.reset_launch_counts()
        fused2d.reset_launch_counts()
        predictor3d.reset_launch_counts()
        multigrid_kernels.reset_launch_counts()
        predictor2d.reset_launch_counts()
        trailing_dct.reset_launch_counts()
        remote_dma.reset_launch_counts()

    def counts_2d(*keys):
        """The 2D path's counters and ``keys`` of the multigrid's."""
        return lambda: {**fused2d.LAUNCHES, **{
            k: multigrid_kernels.LAUNCHES[k] for k in keys}}

    run3 = timed_run(case, reset_all, lambda: dict(fused3d.LAUNCHES))
    if trailing_dct.LAUNCHES["fused_trailing"] != 0:
        raise AssertionError("the chain launched fused_trailing")
    st = run3["state"]
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    u_star, rhs = fused3d.predictor_rhs_3d(g, bcs, st.u, pr.dt, pr.nu,
                                           pr.upwind_gamma, pr.rho, bc=sim.bc)
    scale = pr.dt / pr.rho
    cells3 = math.prod(SHAPE)
    times, bounds = {}, {}
    time_pairs({
        "predictor_rhs_3d": (
            lambda: fused3d.predictor_rhs_3d(g, bcs, st.u, pr.dt, pr.nu,
                                             pr.upwind_gamma, pr.rho,
                                             bc=sim.bc),
            lambda: fused3d.predictor_rhs_plain(g, bcs, st.u, pr.dt, pr.nu,
                                                pr.upwind_gamma, pr.rho),
            nbytes(*st.u, *u_star, rhs, sim.bc),
            OPS_PER_CELL["predictor_rhs_3d"] * cells3),
        "correct_diag_3d": (
            lambda: fused3d.correct_diag_3d(g, u_star, st.p, scale),
            lambda: fused3d.correct_diag_plain(g, u_star, st.p, scale),
            nbytes(*u_star, st.p, *u_star) + 8,
            OPS_PER_CELL["correct_diag_3d"] * cells3),
        "residual_3d": (
            lambda: fused3d.residual_3d(sim.op, st.p, rhs),
            lambda: fused3d.residual_plain(sim.op, st.p, rhs),
            nbytes(st.p, rhs, sim.op.diag, sim.op.code, rhs),
            OPS_PER_CELL["residual_3d"] * cells3),
    }, times, bounds)
    solve_ms = time_ms(lambda: sim.dct_solver._direct(rhs), 10)
    line("phase4", shape=_name(SHAPE), dct_direct_ms=f"{solve_ms:.4f}")

    run2 = timed_run(case2, reset_all, lambda: dict(fused2d.LAUNCHES))
    st2 = run2["state"]
    g2, bcs2, pr2 = sim2.grid, sim2.bcs, sim2.params
    u_star2, rhs2 = fused2d.predictor_rhs_2d(
        g2, bcs2, st2.u, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho,
        bc=sim2.bc)
    scale2 = pr2.dt / pr2.rho
    cells2 = math.prod(SHAPE2)
    time_pairs({
        "predictor_rhs_2d": (
            lambda: fused2d.predictor_rhs_2d(g2, bcs2, st2.u, pr2.dt, pr2.nu,
                                             pr2.upwind_gamma, pr2.rho,
                                             bc=sim2.bc),
            lambda: fused2d.predictor_rhs_2d_plain(
                g2, bcs2, st2.u, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho),
            nbytes(*st2.u, *u_star2, rhs2, sim2.bc),
            OPS_PER_CELL["predictor_rhs_2d"] * cells2),
        "correct_diag_2d": (
            lambda: fused2d.correct_diag_2d(g2, u_star2, st2.p, scale2),
            lambda: fused2d.correct_diag_2d_plain(g2, u_star2, st2.p,
                                                  scale2),
            nbytes(*u_star2, st2.p, *u_star2) + 8,
            OPS_PER_CELL["correct_diag_2d"] * cells2),
    }, times, bounds)
    # device time of kernels 4-5: a CUDA-graph replay over rotated input
    # sets of the flagship's fields, beside the events and the wrappers'
    # host time
    def event_ms(k):
        return min(times[k][0], times[k][3])

    device_times("predictor_rhs_2d", [
        lambda s=s: fused2d.predictor_rhs_2d(
            g2, bcs2, s, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho,
            bc=sim2.bc)
        for s in rotated(tuple(st2.u), nbytes(*st2.u, *u_star2, rhs2))],
        event_ms("predictor_rhs_2d"))
    device_times("correct_diag_2d", [
        lambda s=s: fused2d.correct_diag_2d(g2, s[:2], s[2], scale2)
        for s in rotated((*u_star2, st2.p),
                         nbytes(*u_star2, st2.p, *u_star2))],
        event_ms("correct_diag_2d"))
    # split vs dense direct solve, and the whole step vs step_plain, in
    # the order a, b, b, a
    solve = (time_ms(lambda: split._direct(rhs2), 10),
             time_ms(lambda: dense._direct(rhs2), 10),
             time_ms(lambda: dense._direct(rhs2), 10),
             time_ms(lambda: split._direct(rhs2), 10))
    steps = (time_ms(lambda: sim2.step(st2), 10),
             time_ms(lambda: sim2.step_plain(st2), 10),
             time_ms(lambda: sim2.step_plain(st2), 10),
             time_ms(lambda: sim2.step(st2), 10))
    line("phase4", shape=_name(SHAPE2),
         dct_direct_ms_split_dense_dense_split=json.dumps(
             [round(x, 4) for x in solve]),
         step_ms_kernel_plain_plain_kernel=json.dumps(
             [round(x, 4) for x in steps]))

    # the LES step: its 200-step run (launch counts of its own path), both
    # kernels against their plain versions, the step against step_plain
    run_les = timed_run(case_les, reset_all, lambda: {
        k: {**fused3d.LAUNCHES, **predictor3d.LAUNCHES}[k] for k in LES_PATH})
    st3 = run_les["state"]
    cfg = sim_les.les
    nu_t = predictor3d.nu_t_3d(g, bcs, st3.u, cfg, bc=sim.bc)
    time_pairs({
        "nu_t_3d": (
            lambda: predictor3d.nu_t_3d(g, bcs, st3.u, cfg, bc=sim.bc),
            lambda: eddy_viscosity(g, bcs, st3.u, cfg),
            nbytes(*st3.u, nu_t, sim.bc),
            OPS_PER_CELL["nu_t_3d"] * cells3),
        "predictor_3d": (
            lambda: predictor3d.predictor_3d(g, bcs, st3.u, pr.dt, pr.nu,
                                             pr.upwind_gamma, nu_t=nu_t,
                                             bc=sim.bc),
            lambda: predictor3d.predictor_3d_plain(g, bcs, st3.u, pr.dt,
                                                   pr.nu, pr.upwind_gamma,
                                                   nu_t=nu_t),
            nbytes(*st3.u, nu_t, *st3.u, sim.bc),
            OPS_PER_CELL["predictor_3d"] * cells3),
    }, times, bounds)
    steps = (time_ms(lambda: sim_les.step(st3), 10),
             time_ms(lambda: sim_les.step_plain(st3), 10),
             time_ms(lambda: sim_les.step_plain(st3), 10),
             time_ms(lambda: sim_les.step(st3), 10))
    line("phase4", shape=_name(SHAPE), les_cs=cfg.cs,
         step_ms_kernel_plain_plain_kernel=json.dumps(
             [round(x, 4) for x in steps]))

    # the iterative solves at 2048^2. The mgcg main path: its run, each
    # level kernel against its plain version on the level-0 operator, one
    # V-cycle on each route
    run_mgcg = timed_run(case_mg, reset_all, counts_2d(
        "mg_pre_sweeps_residual", "mg_add_post_sweeps"), steps=MGCG_STEPS)
    if multigrid_kernels.LAUNCHES["rb_sweeps"] != 0:
        raise AssertionError("the fused route launched rb_sweeps")
    stm = run_mgcg["state"]
    op0 = mg.ops[0]
    _, b0 = fused2d.predictor_rhs_2d(g2, bcs2, stm.u, pr2.dt, pr2.nu,
                                     pr2.upwind_gamma, pr2.rho, bc=sim2.bc)
    p0 = stm.p
    e0 = 0.01 * torch.randn(SHAPE2, generator=gen, device=DEV)
    n, om = mg.pre, mg.omega
    mk = multigrid_kernels
    n_blocks = mk.level_plan(SHAPE2, n).blocks
    # float32 operations per cell: ~17 per red-black update (a division,
    # 4 coefficient and 5 stencil products, 5 sums, the omega blend), 11
    # for the residual, 2 more for the post kernel's add and square
    time_pairs({
        "mg_pre_sweeps_residual": (
            lambda: mk.mg_pre_sweeps_residual(op0, p0, b0, n, om),
            lambda: mk.mg_pre_sweeps_residual_plain(op0, p0, b0, n, om),
            nbytes(p0, b0, op0.diag, op0.code, p0, p0),
            (17 * n + 11) * cells2),
        "mg_add_post_sweeps": (
            lambda: mk.mg_add_post_sweeps(op0, p0, b0, e0, n, om),
            lambda: mk.mg_add_post_sweeps_plain(op0, p0, b0, e0, n, om),
            nbytes(p0, b0, op0.diag, op0.code, e0, p0) + 4 * n_blocks,
            (17 * n + 13) * cells2),
        "rb_sweeps": (
            lambda: mk.rb_sweeps(op0, p0, b0, om, n),
            lambda: mk.rb_sweeps_plain(op0, p0, b0, om, n),
            nbytes(p0, b0, op0.diag, op0.code, p0),
            17 * n * cells2),
    }, times, bounds)
    sets = rotated((op0, p0, b0, e0), nbytes(p0, b0, op0.diag, op0.code, p0,
                                             p0))
    for name, call in level_calls(n, om).items():
        device_times(name, [lambda s=s, call=call: call(*s) for s in sets],
                     event_ms(name))
    # every V-cycle launches mg_pre and mg_post once at each level of at
    # least 128^2 but the coarsest (rb_sweeps twice, on the RB route): each
    # level's device time by graph replay, the same way, beside its bound
    # (21 bytes a cell: mg_pre reads p, b, diag, the code and writes p, r;
    # mg_post reads e for r), and mg_pre's and mg_post's at each tile of
    # MG_TILES
    fused_levels = [lv for lv in range(len(mg.ops)) if mg._fused_ok(lv)]
    for lv in fused_levels:
        op_l = mg.ops[lv]
        plan_l = mk.level_plan(tuple(op_l.diag.shape), n)
        fields = mg_fields(op_l, gen)
        level_bytes = nbytes(*fields, op_l.diag, op_l.code, op_l.diag)
        sets = rotated((op_l, *fields), level_bytes)
        by_level = {name: round(time_graph_ms(
            [lambda s=s, call=call: call(*s) for s in sets]), 4)
            for name, call in level_calls(n, om).items()}
        by_tile = {_name(tile): [round(time_graph_ms(
            [lambda s=s, call=call: call(*s, tile=tile) for s in sets]),
            4) for call in tile_calls(n, om)] for tile in MG_TILES}
        line("phase4", mg_level=lv, shape=_name(op_l.diag.shape),
             device_ms_graph=json.dumps(by_level),
             bound_ms=f"{level_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
             tile=f"{plan_l.tile_rows}x{plan_l.tile_cols}",
             pre_post_ms_by_tile=json.dumps(by_tile),
             input_sets=len(sets))
    line("phase4", mg_fused_levels=len(fused_levels),
         launches_per_level_per_step=json.dumps({
             k: run_mgcg["launches"][k] / MGCG_STEPS / len(fused_levels)
             for k in ("mg_pre_sweeps_residual", "mg_add_post_sweeps")}))
    v_ms = {}
    for name in ("fused", "rb", "plain", "plain", "rb", "fused"):
        mg_r = routes[name]
        v_ms.setdefault(name, []).append(round(time_ms(
            lambda: mg_r._v_cycle(0, torch.zeros_like(b0), b0), 3), 4))
    line("phase4", shape=_name(SHAPE2), v_cycle_ms_by_route=json.dumps(v_ms))

    # mg on the RB route (the rb_sweeps kernel for the pre and post sweeps)
    case_rb = make_case("cavity", device=DEV, poisson_method="mg",
                        **FLAGSHIP)
    case_rb = dataclasses.replace(case_rb, sim=dataclasses.replace(
        case_rb.sim, mg_solver=routes["rb"]))
    run_rb = timed_run(case_rb, reset_all, counts_2d("rb_sweeps"),
                       steps=MG_STEPS)
    # cg from the fft run's final state, as bench.py's companion runs it
    case_cg = make_case("cavity", device=DEV, poisson_method="cg",
                        **FLAGSHIP)
    timed_run(case_cg, reset_all, lambda: dict(fused2d.LAUNCHES),
              steps=CG_STEPS, state=st2, warmup=2)

    rb_levels = sum(mk.rb_sweeps_applicable(tuple(o.diag.shape), o.diag.dtype)
                    for o in mg.ops)
    line("phase4", rb_levels=rb_levels,
         rb_sweeps_launches_per_level_per_step=run_rb["launches"]["rb_sweeps"]
         / MG_STEPS / rb_levels)

    # the IBM cylinder: its main path at 2048x1024 and at 512x256 from the
    # impulsive start, then kernel 8 against its plain version and the
    # step against step_plain at 2048x1024
    run_cyl = timed_run(case_cyl, reset_all, lambda: dict(predictor2d.LAUNCHES),
                        steps=CYL_STEPS, state=impulsive_start_state(sim_cyl))
    timed_run(case_base, reset_all, lambda: dict(predictor2d.LAUNCHES),
              steps=CYL_STEPS, state=impulsive_start_state(sim_base))
    stc = run_cyl["state"]
    gc, bcsc, prc = sim_cyl.grid, sim_cyl.bcs, sim_cyl.params
    u_star_c = predictor2d.predictor_2d(gc, bcsc, stc.u, prc.dt, prc.nu,
                                        prc.upwind_gamma, sim_cyl.ghosts)
    time_pairs({
        "predictor_2d": (
            lambda: predictor2d.predictor_2d(gc, bcsc, stc.u, prc.dt, prc.nu,
                                             prc.upwind_gamma,
                                             sim_cyl.ghosts),
            lambda: predictor2d.predictor_2d_plain(gc, bcsc, stc.u, prc.dt,
                                                   prc.nu, prc.upwind_gamma),
            nbytes(*stc.u, *u_star_c),
            OPS_PER_CELL["predictor_2d"] * math.prod(CYL_SHAPE)),
    }, times, bounds)
    device_times("predictor_2d", [
        lambda s=s: predictor2d.predictor_2d(gc, bcsc, s, prc.dt, prc.nu,
                                             prc.upwind_gamma, sim_cyl.ghosts)
        for s in rotated(tuple(stc.u), nbytes(*stc.u, *u_star_c))],
        event_ms("predictor_2d"))
    poisson.reset_host_syncs()
    steps = (time_ms(lambda: sim_cyl.step(stc), 10),
             time_ms(lambda: sim_cyl.step_plain(stc), 10),
             time_ms(lambda: sim_cyl.step_plain(stc), 10),
             time_ms(lambda: sim_cyl.step(stc), 10))
    line("phase4", shape=_name(CYL_SHAPE), case="cylinder",
         step_ms_kernel_plain_plain_kernel=json.dumps(
             [round(x, 4) for x in steps]),
         capacitance_links=int(sim_cyl.dctcg_solver.cap_cinv.shape[0]))
    # the cylinder's force diagnostics at 512x256: run_scan_forces (the
    # control-volume terms sampled on the card after every step) against
    # cv_terms_nd after each step of a run_scan over the same steps; the
    # same kernels in the same order, so rtol 1e-5 (atol 1e-6 for the
    # lift's terms near 0)
    hb = sim_base.grid.spacing
    box = (int(2.5 / hb[0]), int(5.5 / hb[0]), int(2.5 / hb[1]),
           int(5.5 / hb[1]))
    st_f0 = impulsive_start_state(sim_base)
    _, d_f, sf, mom = sim_base.run_scan_forces(st_f0, FORCES_STEPS, box)
    st_r, post = st_f0, []
    for _ in range(FORCES_STEPS):
        st_r, _ = sim_base.run_scan(st_r, 1)
        sf_k, mom_k = cv_terms_nd(sim_base.grid, st_r, sim_base.params.nu,
                                  box)
        post.append(torch.stack([*sf_k, *mom_k]))
    post = torch.stack(post)
    if tuple(sf.shape) != (FORCES_STEPS, 2) or tuple(mom.shape) != (
            FORCES_STEPS, 2):
        raise AssertionError(f"run_scan_forces shapes {sf.shape} {mom.shape}")
    e = close("run_scan_forces vs post-hoc cv_terms_nd",
              torch.cat([sf, mom], 1), post, 1e-5, 1e-6)
    line("phase4", shape=_name(CYL_BASE), case="cylinder",
         run_scan_forces_steps=FORCES_STEPS, box=json.dumps(box),
         max_abs_err_vs_post_hoc=e, sf_last=json.dumps(sf[-1].tolist()),
         mom_last=json.dumps(mom[-1].tolist()))

    # the channel: at 256x64 the JAX oracle's 200 steps from the
    # Poiseuille state (drift of u < 2e-2, max_div < 1e-3, and outflow
    # against inflow flux to 1e-4 of the inflow); at 2048x512 a timed run
    # of the developing flow from the case's own start (at the steady
    # state the pressure RHS is roundoff and mg stops after ~2 cycles)
    # with the V-cycle's fused level kernels (levels of >= 128 cells a
    # side), then kernel 8 there by graph replay beside its bound
    def counts_channel(*keys):
        return lambda: {**predictor2d.LAUNCHES, **{
            k: multigrid_kernels.LAUNCHES[k] for k in keys}}

    case_chb = make_case("channel", shape=CHANNEL_BASE, device=DEV)
    st_p = poiseuille_state(case_chb.sim)
    run_chb = timed_run(case_chb, reset_all, counts_channel(),
                        steps=CHANNEL_BASE_STEPS, state=st_p, warmup=0)
    u_end = run_chb["state"].u[0]
    drift = float((u_end - st_p.u[0]).abs().max())
    q_in, q_out = float(u_end[0].sum()), float(u_end[-1].sum())
    line("phase4", case="channel", shape=_name(CHANNEL_BASE),
         steps=CHANNEL_BASE_STEPS, drift=drift, q_in=q_in, q_out=q_out,
         max_div=run_chb["max_div"],
         mg_kernel_launches=json.dumps({
             k: multigrid_kernels.LAUNCHES[k]
             for k in ("mg_pre_sweeps_residual", "mg_add_post_sweeps")}))
    if not (drift < 2e-2 and run_chb["max_div"] < 1e-3):
        raise AssertionError(f"channel Poiseuille drift {drift}, max_div "
                             f"{run_chb['max_div']}")
    if not abs(q_out - q_in) <= 1e-4 * abs(q_in):
        raise AssertionError(f"channel flux in {q_in} out {q_out}")
    run_ch = timed_run(case_ch, reset_all, counts_channel(
        "mg_pre_sweeps_residual", "mg_add_post_sweeps"), steps=CHANNEL_STEPS,
        warmup=2)
    mg_ch = sim_ch.mg_solver
    line("phase4", case="channel", shape=_name(CHANNEL_SHAPE),
         mg_levels=json.dumps([tuple(o.diag.shape) for o in mg_ch.ops]),
         fused_levels=sum(mg_ch._fused_ok(lv) for lv in range(len(mg_ch.ops))),
         rb_sweeps_launches=multigrid_kernels.LAUNCHES["rb_sweeps"])
    st_ch = run_ch["state"]
    gh, bcsh, prh = sim_ch.grid, sim_ch.bcs, sim_ch.params
    u_star_h = predictor2d.predictor_2d(gh, bcsh, st_ch.u, prh.dt, prh.nu,
                                        prh.upwind_gamma, sim_ch.ghosts)
    bytes_ch = nbytes(*st_ch.u, *u_star_h)
    ev_ch = min(time_ms(lambda: predictor2d.predictor_2d(
        gh, bcsh, st_ch.u, prh.dt, prh.nu, prh.upwind_gamma,
        sim_ch.ghosts), 20) for _ in range(2))
    line("phase4", kernel="predictor_2d", case="channel",
         shape=_name(CHANNEL_SHAPE),
         bound_ms=f"{bytes_ch / HBM_BYTES_PER_S * 1e3:.4f}",
         mbytes=f"{bytes_ch / 1e6:.1f}")
    device_times("predictor_2d channel", [
        lambda s=s: predictor2d.predictor_2d(gh, bcsh, s, prh.dt, prh.nu,
                                             prh.upwind_gamma, sim_ch.ghosts)
        for s in rotated(tuple(st_ch.u), bytes_ch)], ev_ch)

    # taylor_green3d 256^3 on the chain and on the fused trailing-axes route,
    # and cavity3d 256^3 on that route; kernel 12 launches 4 times a step
    # (2 direct solves x 2 calls) on the fused route and never on the chain
    def counts_3d():
        return {**fused3d.LAUNCHES, **trailing_dct.LAUNCHES}

    run_tg = timed_run(case_tg, reset_all, lambda: dict(fused3d.LAUNCHES))
    if trailing_dct.LAUNCHES["fused_trailing"] != 0:
        raise AssertionError("the chain launched fused_trailing")
    run_tg_f = timed_run(case_tg_f, reset_all, counts_3d)
    run_cav_f = timed_run(case_f, reset_all, counts_3d)
    for r in (run_tg_f, run_cav_f):
        if r["launches"]["fused_trailing"] != 4 * TIMED_STEPS:
            raise AssertionError(f"fused_trailing launches {r['launches']}")
    # kernel 12 against its plain version and the library composition on
    # the forward call's inputs of the Taylor-Green run's direct solve; the
    # 3D kernels in their periodic mode; the direct solve and the step on
    # the chain against the fused route (order a, b, b, a)
    st_t = run_tg_f["state"]
    sim_t, sim_tf = case_tg.sim, case_tg_f.sim
    g_t, bcs_t, pr_t = sim_t.grid, sim_t.bcs, sim_t.params
    u_star_t, rhs_t = fused3d.predictor_rhs_3d(
        g_t, bcs_t, st_t.u, pr_t.dt, pr_t.nu, pr_t.upwind_gamma, pr_t.rho,
        bc=sim_t.bc)
    sol_f = sim_tf.dct_solver
    (f0, _), (f1, _), (f2, _) = sol_f._fused3d_consts
    (s1, _), (s2, _) = sol_f._fused3d_split
    n0, n1, n2 = SHAPE
    x_t = (f0 @ rhs_t.reshape(n0, n1 * n2)).reshape(SHAPE)
    eig_t = sol_f.inv_eig
    out_t = trailing_dct.fused_trailing(x_t, s1, s2, eig_t)
    k1, k2 = f1.shape[0], f2.shape[0]
    passes = trailing_dct.PASSES[sol_f.precision]
    flops = 2 * n0 * k1 * n2 * (n1 + k2)
    # the bound of the kernel's arithmetic: its bf16 passes on the tensor
    # cores, or x, eig and out once through memory (the split constants,
    # 0.5 MB, count as read once)
    time_pairs({
        "fused_trailing": (
            lambda: trailing_dct.fused_trailing(x_t, s1, s2, eig_t, passes),
            lambda: trailing_dct.fused_trailing_plain(x_t, s1, s2, eig_t,
                                                      passes),
            nbytes(x_t, s1.packed, s2.packed, eig_t, out_t),
            passes * flops, BF16_OPS_PER_S),
    }, times, bounds)
    library_ms = {"fused_trailing": time_ms(
        lambda: torch.matmul(torch.matmul(f1, x_t), f2.T) * eig_t, 20)}
    no_eig_ms = 1e3 * max(passes * flops / BF16_OPS_PER_S,
                          nbytes(x_t, out_t) / HBM_BYTES_PER_S)
    line("phase4", kernel="fused_trailing", passes=passes,
         bound_ms_bf16_with_eig=f"{bounds['fused_trailing'][0]:.4f}",
         bound_ms_bf16_without_eig=f"{no_eig_ms:.4f}",
         bound_ms_fp32_fma=f"{flops / FP32_OPS_PER_S * 1e3:.4f}",
         library_ms_fp32_cublas=f"{library_ms['fused_trailing']:.4f}")
    per_t = periodic_axes(g_t, bcs_t)
    times_per, bounds_per = {}, {}
    time_pairs({
        "predictor_rhs_3d periodic": (
            lambda: fused3d.predictor_rhs_3d(g_t, bcs_t, st_t.u, pr_t.dt,
                                             pr_t.nu, pr_t.upwind_gamma,
                                             pr_t.rho, bc=sim_t.bc),
            lambda: fused3d.predictor_rhs_plain(g_t, bcs_t, st_t.u, pr_t.dt,
                                                pr_t.nu, pr_t.upwind_gamma,
                                                pr_t.rho),
            nbytes(*st_t.u, *u_star_t, rhs_t, sim_t.bc),
            OPS_PER_CELL["predictor_rhs_3d"] * cells3),
        "correct_diag_3d periodic": (
            lambda: fused3d.correct_diag_3d(g_t, u_star_t, st_t.p,
                                            pr_t.dt / pr_t.rho, per_t),
            lambda: fused3d.correct_diag_plain(g_t, u_star_t, st_t.p,
                                               pr_t.dt / pr_t.rho, per_t),
            nbytes(*u_star_t, st_t.p, *u_star_t) + 8,
            OPS_PER_CELL["correct_diag_3d"] * cells3),
        "residual_3d periodic": (
            lambda: fused3d.residual_3d(sim_t.op, st_t.p, rhs_t),
            lambda: fused3d.residual_plain(sim_t.op, st_t.p, rhs_t),
            nbytes(st_t.p, rhs_t, sim_t.op.diag, sim_t.op.code, rhs_t),
            OPS_PER_CELL["residual_3d"] * cells3),
    }, times_per, bounds_per)
    solve = (time_ms(lambda: sim_t.dct_solver._direct(rhs_t), 10),
             time_ms(lambda: sol_f._direct(rhs_t), 10),
             time_ms(lambda: sol_f._direct(rhs_t), 10),
             time_ms(lambda: sim_t.dct_solver._direct(rhs_t), 10))
    steps = (time_ms(lambda: sim_t.step(st_t), 10),
             time_ms(lambda: sim_tf.step(st_t), 10),
             time_ms(lambda: sim_tf.step(st_t), 10),
             time_ms(lambda: sim_t.step(st_t), 10))
    line("phase4", shape=_name(SHAPE), case="taylor_green3d",
         library_ms_fused_trailing=f"{library_ms['fused_trailing']:.4f}",
         dct_direct_ms_chain_fused_fused_chain=json.dumps(
             [round(x, 4) for x in solve]),
         step_ms_chain_fused_fused_chain=json.dumps(
             [round(x, 4) for x in steps]))

    # the slab-sharded step: 200-step runs of cavity3d 256^3 in 4 and in 16
    # slabs and taylor_green3d 256^3 in 4 (a ring), each with 3 exchange
    # launches a step and kernels 1 and 2 once a slab; then kernels 13 and
    # 14 against their plain versions and one torch._foreach_copy_ over the
    # same messages, on the 4-slab cavity's buffers at the run's state, by
    # events (as every kernel) and by CUDA-graph replay beside (without the
    # host's enqueue; the buffers stay in L2);
    # kernels 1 and 2 in halo mode on a middle slab against their plain
    # versions; each wrapper's host time per call; kernel 1 by mode on the
    # Taylor-Green field; the unsharded and the 4-slab step in one call,
    # order a, b, b, a
    def counts_sharded():
        return {**fused3d.LAUNCHES,
                "exchange_rows_multi": remote_dma.LAUNCHES[
                    "exchange_rows_multi"]}

    runs_sh = {}
    for label, c, n in (("cavity3d", case, SLABS[0]),
                        ("cavity3d", case, SLABS[1]),
                        ("taylor_green3d", case_tg, SLABS[0])):
        r = timed_run(sharded(c, n), reset_all, counts_sharded)
        # kernel 13's counter, reset with the others just before the run
        # (timed_run requires its counters above 0): no step calls it, as
        # in JAX
        r["launches"]["exchange_ghost_rows"] = remote_dma.LAUNCHES[
            "exchange_ghost_rows"]
        want = {"exchange_ghost_rows": 0,
                "exchange_rows_multi": 3 * TIMED_STEPS,
                "predictor_rhs_3d": n * TIMED_STEPS,
                "correct_diag_3d": n * TIMED_STEPS,
                "residual_3d": 2 * TIMED_STEPS}
        if r["launches"] != want:
            raise AssertionError(f"{label} in {n} slabs: launches "
                                 f"{r['launches']}, expected {want}")
        runs_sh[(label, n)] = r
    case_s = sharded(case, SLABS[0])
    sim_s = case_s.sim
    st_s = runs_sh[("cavity3d", SLABS[0])]["state"]
    step = fused_sharded.SlabStep(sim_s, sim_s.mesh)
    step.load(st_s.u)
    step.step(st_s.p)          # fills every buffer from the run's state
    ex = exchange_sets(step)
    for name, what in (("exchange_rows_multi", "velocity"),
                       ("exchange_ghost_rows", "ghost_rows")):
        plan, vols, msgs, ring = ex[what]
        src, dst = remote_dma.message_views(vols, msgs, ring)
        time_pairs({name: (
            plan.run,
            lambda vols=vols, msgs=msgs, ring=ring:
                remote_dma.exchange_rows_multi_plain(vols, msgs, ring),
            2 * nbytes(*src), 0)}, times, bounds)
        copy = (lambda src=src, dst=dst: torch._foreach_copy_(dst, src))
        library_ms[name] = time_ms(copy, 20)
        graph = (time_graph_ms([plan.run]), time_graph_ms([copy]))
        line("phase4", kernel=name, messages=plan.n_msgs,
             event_ms_kernel_library=json.dumps(
                 [round(min(times[name][0], times[name][3]), 4),
                  round(library_ms[name], 4)]),
             graph_ms_kernel_library_l2_resident=json.dumps(
                 [round(x, 4) for x in graph]))
    k = 1                      # a middle slab: both sides halo sides
    u_k, us_k, p_k = step.u[step.cur][k], step.u_star[k], step.p[k]
    halo_k = step.halo[k]
    kmax = torch.zeros(2, dtype=torch.int32, device=DEV)
    cells_k = math.prod(step.slab.shape)
    times_halo, bounds_halo = {}, {}
    time_pairs({
        "predictor_rhs_3d halo": (
            lambda: fused3d.predictor_rhs_3d_halo(
                step.slab, sim_s.bcs, u_k, pr.dt, pr.nu, pr.upwind_gamma,
                pr.rho, halo=halo_k, bc=sim_s.bc, out=us_k,
                rhs=step.rhs[k]),
            lambda: fused3d.predictor_rhs_halo_plain(
                step.slab, sim_s.bcs, u_k, pr.dt, pr.nu, pr.upwind_gamma,
                pr.rho, halo_k),
            nbytes(*u_k, *us_k, step.rhs[k], sim_s.bc),
            OPS_PER_CELL["predictor_rhs_3d"] * cells_k),
        "correct_diag_3d halo": (
            lambda: fused3d.correct_diag_3d_halo(
                step.slab, us_k, p_k, pr.dt / pr.rho, kmax, (), halo_k),
            lambda: fused3d.correct_diag_halo_plain(
                step.slab, us_k, p_k, pr.dt / pr.rho, (), halo_k),
            nbytes(*us_k, p_k, *us_k) + 8,
            OPS_PER_CELL["correct_diag_3d"] * cells_k),
    }, times_halo, bounds_halo)
    # the host's share: each wrapper's enqueue time (its checks, the
    # ctypes call), against the device time of its kernel
    enqueue = {
        "predictor_rhs_3d": host_us(lambda: fused3d.predictor_rhs_3d(
            g, bcs, run3["state"].u, pr.dt, pr.nu, pr.upwind_gamma, pr.rho,
            bc=sim.bc)),
        "predictor_rhs_3d halo": host_us(lambda: fused3d.predictor_rhs_3d_halo(
            step.slab, sim_s.bcs, u_k, pr.dt, pr.nu, pr.upwind_gamma, pr.rho,
            halo=halo_k, bc=sim_s.bc, out=us_k, rhs=step.rhs[k])),
        "correct_diag_3d halo": host_us(lambda: fused3d.correct_diag_3d_halo(
            step.slab, us_k, p_k, pr.dt / pr.rho, kmax, (), halo_k)),
        "exchange_rows_multi": host_us(ex["velocity"][0].run),
        "nu_t_3d": host_us(lambda: predictor3d.nu_t_3d(g, bcs, st3.u, cfg,
                                                       bc=sim.bc)),
        "predictor_3d": host_us(lambda: predictor3d.predictor_3d(
            g, bcs, st3.u, pr.dt, pr.nu, pr.upwind_gamma, nu_t=nu_t,
            bc=sim.bc)),
    }
    line("phase4", host_us_per_call=json.dumps(
        {k: round(v, 1) for k, v in enqueue.items()}))
    # kernel 1 by mode on the Taylor-Green field at the run's state:
    # unsharded with every axis periodic (mask 7), unsharded with axis 0
    # made walls (mask 6), and 4 x one ring slab (halo 3, mask 6)
    st_tg = runs_sh[("taylor_green3d", SLABS[0])]["state"]
    sim_tgs = sharded(case_tg, SLABS[0]).sim
    step_tg = fused_sharded.SlabStep(sim_tgs, sim_tgs.mesh)
    step_tg.load(st_tg.u)
    bcs6 = dict(bcs_t)
    bcs6[(0, 0)] = bcs6[(0, 1)] = BCSpec.wall()
    bc6 = fused3d.bc_table(g_t, bcs6, DEV)
    args_t = (pr_t.dt, pr_t.nu, pr_t.upwind_gamma, pr_t.rho)
    mode_ms = {
        "mask7": time_ms(lambda: fused3d.predictor_rhs_3d(
            g_t, bcs_t, st_tg.u, *args_t, bc=sim_t.bc), 20),
        "mask6": time_ms(lambda: fused3d.predictor_rhs_3d(
            g_t, bcs6, st_tg.u, *args_t, bc=bc6), 20),
        "4x_halo3_mask6": SLABS[0] * time_ms(
            lambda: fused3d.predictor_rhs_3d_halo(
                step_tg.slab, bcs_t, step_tg.u[0][1], *args_t,
                halo=(True, True), bc=sim_tgs.bc, out=step_tg.u_star[1],
                rhs=step_tg.rhs[1]), 20),
    }
    line("phase4", case="taylor_green3d", predictor_rhs_3d_ms_by_mode=json.dumps(
        {k: round(v, 4) for k, v in mode_ms.items()}))
    st_u = run3["state"]
    st_sh = shard_state(st_u, sim_s.mesh, sim_s.grid)
    steps = (time_ms(lambda: sim.run_scan(st_u, 10), 2),
             time_ms(lambda: sim_s.run_scan(st_sh, 10), 2),
             time_ms(lambda: sim_s.run_scan(st_sh, 10), 2),
             time_ms(lambda: sim.run_scan(st_u, 10), 2))
    line("phase4", shape=_name(SHAPE), case="cavity3d",
         library_ms_exchanges=json.dumps(
             {k: round(library_ms[k], 4) for k in
              ("exchange_rows_multi", "exchange_ghost_rows")}),
         ms_per_step_unsharded_4slabs_4slabs_unsharded=json.dumps(
             [round(x / 10, 4) for x in steps]))

    # rk2 and the CFL dt at full width, each beside its Euler run:
    # taylor_green3d 256^3 and the flagship with cfl 0.5 (caps of 4x and
    # 2x the cases' dt, so that the limiter sets the dt), the LES cavity
    # and the 2048x1024 cylinder at their fixed dt; kernels 1 and 4 in base
    # mode against their Euler form on the same inputs; the synchronizing
    # calls a step of the Taylor-Green and flagship loops, Euler and then
    # rk2 with the CFL dt, under set_sync_debug_mode("warn")
    rk2_runs = (
        ("taylor_green3d", run_tg,
         with_params(case_tg, integrator="rk2", cfl=0.5,
                     dt=4 * case_tg.sim.params.dt),
         lambda: dict(fused3d.LAUNCHES), None),
        ("cavity 2048^2", run2,
         with_params(case2, integrator="rk2", cfl=0.5,
                     dt=2 * case2.sim.params.dt),
         lambda: dict(fused2d.LAUNCHES), None),
        ("cavity3d les", run_les, with_params(case_les, integrator="rk2"),
         lambda: {k: {**fused3d.LAUNCHES, **predictor3d.LAUNCHES}[k]
                  for k in LES_PATH}, None),
        ("cylinder ibm", run_cyl, with_params(case_cyl, integrator="rk2"),
         lambda: dict(predictor2d.LAUNCHES), impulsive_start_state),
    )
    rk2_ms = {}
    for what, euler, c, counts, start in rk2_runs:
        r = timed_run(c, reset_all, counts,
                      steps=CYL_STEPS if start else TIMED_STEPS,
                      state=start(c.sim) if start else None)
        per_step = {k: v / r["steps"] for k, v in r["launches"].items()}
        euler_per_step = {k: v / euler["steps"]
                          for k, v in euler["launches"].items()}
        rk2_ms[what] = (euler["ms"], r["ms"])
        line("phase4", case=json.dumps(what), integrator="rk2",
             cfl=c.sim.params.cfl,
             ms_per_step_euler_rk2=json.dumps([round(euler["ms"], 4),
                                               round(r["ms"], 4)]),
             rk2_over_euler=f"{r['ms'] / euler['ms']:.3f}",
             launches_per_step_euler=json.dumps(euler_per_step),
             launches_per_step_rk2=json.dumps(per_step),
             dt_min_max_euler=json.dumps(euler["dt"]),
             dt_min_max_rk2=json.dumps(r["dt"]))
    # kernels 1 and 4 in base mode (the step-start field a second buffer)
    # against their Euler form, on the Euler runs' states
    st_tg = run_tg["state"]
    base_tg = tuple(c.clone() for c in st_tg.u)
    dts_tg = sim_t._dts(None)
    st_fl = run2["state"]
    base_fl = tuple(c.clone() for c in st_fl.u)
    dts_fl = sim2._dts(None)
    u_star_fl, rhs_fl = fused2d.predictor_rhs_2d(
        g2, bcs2, st_fl.u, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho,
        bc=sim2.bc)
    times_base, bounds_base = {}, {}
    time_pairs({
        "predictor_rhs_3d base": (
            lambda: fused3d.predictor_rhs_3d(
                g_t, bcs_t, st_tg.u, dts_tg[0], pr_t.nu, pr_t.upwind_gamma,
                pr_t.rho, bc=sim_t.bc, base=base_tg, dts=dts_tg),
            lambda: fused3d.predictor_rhs_3d(
                g_t, bcs_t, st_tg.u, dts_tg[0], pr_t.nu, pr_t.upwind_gamma,
                pr_t.rho, bc=sim_t.bc, dts=dts_tg),
            nbytes(*st_tg.u, *base_tg, *u_star_t, rhs_t, sim_t.bc),
            OPS_PER_CELL["predictor_rhs_3d"] * cells3),
        "predictor_rhs_2d base": (
            lambda: fused2d.predictor_rhs_2d(
                g2, bcs2, st_fl.u, dts_fl[0], pr2.nu, pr2.upwind_gamma,
                pr2.rho, bc=sim2.bc, base=base_fl, dts=dts_fl),
            lambda: fused2d.predictor_rhs_2d(
                g2, bcs2, st_fl.u, dts_fl[0], pr2.nu, pr2.upwind_gamma,
                pr2.rho, bc=sim2.bc, dts=dts_fl),
            nbytes(*st_fl.u, *base_fl, *u_star_fl, rhs_fl, sim2.bc),
            OPS_PER_CELL["predictor_rhs_2d"] * cells2),
    }, times_base, bounds_base)
    base_sets = rotated((*st_fl.u, *base_fl),
                        nbytes(*st_fl.u, *base_fl, *u_star_fl, rhs_fl))
    device_times("predictor_rhs_2d base", [
        lambda s=s: fused2d.predictor_rhs_2d(
            g2, bcs2, s[:2], dts_fl[0], pr2.nu, pr2.upwind_gamma, pr2.rho,
            bc=sim2.bc, base=s[2:], dts=dts_fl)
        for s in base_sets], times_base["predictor_rhs_2d base"][0])
    syncs = {}
    for what, c in (("taylor_green3d", case_tg), ("cavity 2048^2", case2)):
        rk2_cfl = with_params(c, integrator="rk2", cfl=0.5)
        syncs[what] = (syncs_per_step(c.sim, c.initial_state()),
                       syncs_per_step(rk2_cfl.sim, c.initial_state()))
        if syncs[what][1] > syncs[what][0]:
            raise AssertionError(f"{what}: rk2 with the CFL dt makes "
                                 f"{syncs[what][1]} synchronizing calls a "
                                 f"step, Euler {syncs[what][0]}")
    line("phase4", sync_calls_per_step_euler_rk2_cfl=json.dumps(syncs))

    periodic_runs(case_tgp, case_chp, case_turb, reset_all)

    launches = {**run_les["launches"], **run3["launches"], **run2["launches"],
                "mg_pre_sweeps_residual":
                    run_mgcg["launches"]["mg_pre_sweeps_residual"],
                "mg_add_post_sweeps":
                    run_mgcg["launches"]["mg_add_post_sweeps"],
                "rb_sweeps": run_rb["launches"]["rb_sweeps"],
                "predictor_2d": run_cyl["launches"]["predictor_2d"],
                "fused_trailing": run_tg_f["launches"]["fused_trailing"],
                **{k: runs_sh[("cavity3d", SLABS[0])]["launches"][k]
                   for k in ("exchange_ghost_rows", "exchange_rows_multi")}}
    report = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"navierstokessolver_tpu_torch/csrc/{src}.cu",
         "replaces": tpu, "launches": launches[k],
         "max_abs_err": errs[k],
         "ms": min(times[k][0], times[k][3]),
         "plain_ms": min(times[k][1], times[k][2]),
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library_ms.get(k)}
        for k, (tpu, src) in KERNELS.items()
    ]}
    line("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    print(f"card: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
