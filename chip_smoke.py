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
  * the convection cases (the transported scalar with Boussinesq
    buoyancy; kernels 1, 2, 4 and 5 in their thermal modes):
    ``make_case("heated_cavity", shape=(2048, 2048), ra=1e8)``,
    ``"rayleigh_benard"`` at 2048x1024 (Ra 1e8, axis 0 periodic), the 3D
    ``"heated_cavity"`` at 256^3 (Ra 1e6) and ``"heated_cylinder"`` at
    2048x1024 (Re 200, the staircase body, a passive scalar on the unfused
    route); phase 2 holds the thermal modes to their plain versions
    (theta within THETA_ULPS ulps of max|theta|) on every kind of theta
    face, with rk2's base, the force and a device dt, and kernel 5's wrap
    conservation; phase 3 runs 5 Euler and 5 rk2 steps of each path
    against step_plain (u, p and theta); phase 4 times each path beside
    its athermal twin (200 steps, the 3D cavity 50; launches a step, busy
    ms and idle share), the thermal modes' device times, and the JAX
    package's convection oracles on the kernel route (de Vahl Davis at Ra
    1e3, Rayleigh-Benard criticality, sum(theta) conserved, the 3D cavity);
    phase 5 runs ``--case heated_cavity`` through the CLI at 2048^2 with
    snapshots carrying theta and a resume equal to the unbroken run,

  * the forcing slice (body forces and the time-dependent drive; kernels
    1, 4 and 8 in their forced modes, the kernels' tables refilled from
    the carried t): ``make_case("duct_periodic", shape=(512, 128, 128))``
    (Re 100, kernel 1's static force, axis 0 periodic), ``"kolmogorov"``
    at 256^3 and 2048^2 (Re 30, k_f 4, rk2: forcing volumes of kernels 1
    and 4, every axis periodic), ``"pulsatile_channel"`` at 2048x1024 (Wo
    5: kernel 4's force entry refilled from t each step),
    ``"oscillating_lid"`` at 256^3 and 2048^2 (Re 100: the lid's wall
    entry refilled from t) and ``"heated_enclosure"`` at 2048^2 (Ra 1e6,
    mg: buoyancy around the body as kernel 8's forcing volume); phase 2
    holds the forced modes to their plain versions (kernel 1's force,
    volumes with PER and with base; kernel 4's volumes on every wrap
    topology, Euler and base; kernel 8's volumes), face n of a wrap axis
    equal to face 0; phase 3 runs 5 Euler and 5 rk2 steps of each path
    (the time-dependent ones also at cfl 0.4) against step_plain; phase 4
    times each path beside its twin (the same simulation without its
    force, or with the lid held at its t = 0 value; the enclosure, whose
    host-bound mg steps vary more than its force costs, alone), the
    forced modes' device times and bounds beside their unforced forms,
    the synchronizing calls a step at cfl 0.5 (no more than the twin's),
    and the JAX package's oracles of the slice at its tests' sizes (the
    Womersley response, the lid against per-step rebuilds, the duct's
    series profile, the Kolmogorov laminar balance, the enclosure's energy
    budget) with a through-flow whose normal wall value is a callable of
    t (the stored faces refreshed, the CFL dt taken from them); phase 5
    resumes ``--case
    oscillating_lid`` at 256^3 through the CLI, t included, bit for bit,

  * the sphere (``make_case("sphere")``: 256x128x128 over 16x8x8
    diameters, Re 300, inflow, outflow, four slip walls and the staircase
    sphere, the 3D ``dctcg`` with its capacitance over the links' box):
    phase 2 holds kernels 1-2 to their plain versions with open faces and
    no obstacle (every open kind, a ragged shape), in the masked mode on
    that shape with solid blocks beside every face kind and on the sphere
    itself (Euler and base, gamma 0 and 0.2), and kernel 3 on the
    sphere's operator; phase 3 runs 5 Euler, 5 rk2 and 5 cfl 0.4 steps
    against step_plain; phase 4 times SPHERE_STEPS Euler and rk2 steps
    (launches a step, busy ms, idle share), checks the inflow flux
    against the outflow flux and max|div u| against what the solve's
    residual leaves, and times the new modes (events beside their plain
    versions, device time by graph replay, their bounds),

  * the convective slice: JAX's default ``make_case("cylinder")`` (the
    staircase cylinder, dctcg) at its published 512x256 and at 2048x1024
    on kernels 4-5's masked mode, the convective cylinder
    (``outlet="convective"``) at 2048x1024 (Euler: the masked mode's
    convective variant; rk2: the unfused route), the convective sphere at
    256x128x128 (kernels 1-2's convective variant, Euler and rk2) and the
    convective channel at 2048x512 (mg, the unfused route, kernel 8):
    phase 2 holds kernels 4-5's open modes to their plain versions on
    blocks beside every face kind (INFLOW, SLIP, WALL, OUTFLOW at (0, 0)
    and (0, 1), CONVECTIVE at (0, 1), an obstacle one cell from the
    outlet; Euler and base, gamma 0 and 0.2) and on the staircase
    cylinder, and kernels 1-2's convective variants on a ragged shape and
    on the convective sphere; phase 3 runs 5 Euler, 5 rk2 and 5 cfl 0.4
    steps of each path against step_plain; phase 4 times CONV_STEPS steps
    of each (the staircase and the sphere also under rk2; launches a step,
    busy ms, idle share, synchronizing calls a step), checks the inflow
    flux against the outflow flux and max|div u| against what the solve's
    residual leaves, and times the new modes (events beside their plain
    versions, device time by graph replay, their bounds),

  * the LES slice: ``--case taylor_green3d --les-cs 0.17`` at 256^3
    (kernels 6-7's periodic mode, every axis periodic) and the sphere's
    LES at 256x128x128 (kernels 6-7's open modes, the masked predictor,
    the RHS on fluid cells, kernel 2's masked mode, dctcg): phase 2 holds
    kernels 6-7 to their plain versions in every periodic mask on a
    ragged shape and on the box, in the open and masked modes on a ragged
    shape with OUTFLOW faces on high and on low sides and on the sphere;
    phase 3 runs 5 Euler, 5 rk2 and 5 cfl 0.4 steps of each case against
    step_plain; phase 4 times LES_STEPS Euler and rk2 steps of each
    (launches a step, busy ms, idle share, host syncs a step), checks the
    sphere's inflow flux against its outflow flux and the box's kinetic
    energy against its no-LES twin's, and times the new modes (events
    beside their plain versions, device time by graph replay, their
    bounds),

  * the heated-bodies slice (kernels 1-2's forced and thermal open
    modes): the heated sphere, ``make_case("sphere", heated=True)`` at
    256x128x128 (Re 300, Pr 0.7, dctcg; a passive temperature, an
    isothermal body at 1), and ``make_case("heated_enclosure")`` in 3D at
    128^3 (Ra 1e4, mg; natural convection from a hot sphere in a cold
    box: theta's buoyancy through kernel 1's forced masked mode); phase 2
    holds the modes to their plain versions on a ragged shape (open faces
    with a buoyant scalar, the static force and volumes; the masked mode
    with an isothermal and an adiabatic body) and on both paths' own
    tables (theta within THETA_ULPS ulps of max|theta|, the solid cells
    exactly the body's value or their own); phase 3 runs 5 Euler, 5 rk2
    and 5 cfl 0.4 steps of each against step_plain (theta too); phase 4
    times HEATED_STEPS steps of each under Euler and rk2 and of two
    variants that launch the remaining modes (the sphere with an
    adiabatic body, the open plume: the sphere's table without the
    sphere, a buoyant scalar), with the body, downstream-theta, buoyant-w,
    flux and divergence gates, the host syncs against the solves' checks,
    the sphere's Nusselt number, and the new modes' device times,

  * LES with a body force, with a scalar and in 2D (kernel 6's forced
    mode, kernel 8's wrap modes): ``decaying_turbulence`` at 2048^2 with
    ``les_cs=0.17`` and with the dynamic model, 2D ``kolmogorov`` at
    2048^2 with LES (the unfused 2D route: the plain subgrid stress in
    kernel 8's forcing volumes, its wrap mode), ``duct_periodic`` at
    512x128x128 (the static force, axis 0 periodic), 3D ``kolmogorov`` at
    256^3 (a force volume), the 3D ``heated_cavity`` at 256^3, Ra 1e6
    (buoyancy; kernel 2's thermal mode) and the heated sphere at
    256x128x128 with LES (kernels 7 open, 6 masked, 2 masked-thermal):
    phase 2 holds kernel 8's wrap modes (rows, lanes, both; with and
    without volumes) and kernel 6's forced mode (every periodic mask;
    the static force, volumes, buoyancy) to their plain versions, also on
    the paths' own tables; phase 3 runs 5 Euler, 5 rk2 and 5 cfl 0.4 steps
    of each path against step_plain; phase 4 times LES_FORCED_STEPS steps
    of each (launches a step, busy ms, idle share, synchronizing calls a
    step), with the boxes' kinetic energy below their no-LES twins' and
    the sphere's flux gate, and the new modes' device times,

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

The adjoint phase (after phase 4) takes gradients through ``run_scan``
(``adjoint.differentiable``) at full width: the flagship (fft, 4 Euler
steps), cavity3d 256^3 (fft, 2 Euler, 1 rk2), the sphere (dctcg, 2 Euler)
and the mgcg cavity at 2048^2 (1 Euler), and the cg cavity at 512^2 (the
unrolled tape's memory against the implicit-function solve's): the
differentiable forward equal to ``run_scan`` bit for bit on the path's
kernels, the solve's VJP the solve of the cotangent, the gradient with the
kernels forward against the one with the plain step forward, the IFT
gradient against autograd through the plain step, forward and backward
ms a step and peak memory beside the card.

Phase 5 drives the entry point: ``cli.main`` in this process on the card,
``--case cavity_hi_re`` (the flagship, 2048^2): 200 steps with snapshots
(and VTK) every 100 and a checkpoint, resumed for 200 more with snapshots
every 50, against 400 unbroken steps without any (the fields bit for bit;
kernels 4 and 5 once a step; the snapshot's fields against the plain
derived fields of the checkpoint), a 100-step window with two snapshot
enqueues and without (the same synchronizing calls, by the line that made
them), the CLI's window loop with snapshots every 50 steps and without,
timed in turns, the CFL dt's run_scan(10) twice against
run_scan(20), ``run_scan_stats`` against a float64 two-pass over 20 steps,
``run_scan_tracers`` with 65 536 tracers against a hand loop, the cost a
step of both passes; ``--case oscillating_lid`` 256^3 resumed against an
unbroken run (t included) with a snapshot whose 3D derived fields match
their plain versions; and ``python -m navierstokessolver_tpu_torch`` once
in a subprocess.

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
prints no result. Needs one card; imports nothing of JAX; takes no
arguments.
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
from navierstokessolver_tpu_torch.cases.convection import (  # noqa: E402
    ENCLOSURE_CENTER_3D, hot_wall_nusselt,
)
from navierstokessolver_tpu_torch.scalar import (  # noqa: E402
    ScalarBC, ScalarConfig, body_heat_flux, buoyancy_forcing,
    combined_forcing, freeze_body, thermal_table,
)
from navierstokessolver_tpu_torch.solver import (  # noqa: E402
    SimParams, Simulation,
)
from navierstokessolver_tpu_torch.step_profile import (  # noqa: E402
    device_profile,
)
from navierstokessolver_tpu_torch.utils.spectra import (  # noqa: E402
    energy_spectrum_2d, total_kinetic_energy,
)
from navierstokessolver_tpu_torch.grid import GridSpec  # noqa: E402
from navierstokessolver_tpu_torch.les import (  # noqa: E402
    LESConfig, eddy_viscosity, sgs_forcing,
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
MGCG_STEPS = 50                # the mgcg main path
MG_STEPS = 20                  # the mg run on the RB route
CG_STEPS = 5                   # the cg run (~10^3 iterations a step)
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
PTXAS_KERNELS = {"fused3d": 112, "predictor3d": 47, "fused2d": 88,
                 "multigrid": 3, "predictor2d": 16}
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
# instantiation's name: kernels 1 and 4 gained BASE, kernel 4 PER and
# FORCE, kernel 5 PER, kernels 1, 2, 4 and 5 THERMAL (kernel 1's is its
# FORCE since), kernel 8 FORCE and kernels 1 and 2 OPEN since
EULER_SUFFIX = {"predictor_rhs_kernel": ", 0, 0, 0",
                "correct_diag_kernel": ", 0, 0",
                "predictor_rhs_2d_kernel": ", 0, 0, 0, 0",
                "correct_diag_2d_kernel": "0, 0",
                "predictor_2d_kernel": ", 0"}
# the device dt of phase 2's step-size checks: this factor times the
# kernels' usual dt, a value no case uses
DT_FACTOR = 0.37
NO_SPILL_KERNELS = ("predictor_rhs_kernel<", "correct_diag_kernel<",
                    "predictor_rhs_2d_open_kernel<",
                    "correct_diag_2d_open_kernel<",
                    "predictor_3d_kernel<", "nu_t_3d_kernel<",
                    "predictor_3d_open_kernel<", "nu_t_3d_open_kernel",
                    "predictor_3d_forced_kernel<",
                    "predictor_2d_wrap_kernel<",
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
# the convection slice at full width (the cases' own defaults otherwise):
# the de Vahl Davis cavity at the top of Le Quere's range, Rayleigh-Benard
# in an aspect-2 box, the 3D differentially heated cube, the heated
# staircase cylinder (Re 200, Pr 0.7, dctcg)
CONV_2D = dict(shape=(2048, 2048), ra=1e8, pr=0.71)
CONV_RB = dict(shape=(2048, 1024), ra=1e8, pr=0.71)
CONV_3D = dict(shape=(256, 256, 256), ra=1e6)
CONV_CYL = dict(shape=(2048, 1024))
CONV_3D_STEPS = 50
# the thermal modes' phase-2 shapes in 2D: the cavity's, Rayleigh-Benard's
# (axis 0 periodic) and the wrap modes' ragged ones (PER_P2)
THERMAL_P2 = ((2048, 2048), (2048, 1024), (994, 1002), (20, 14))
# the thermal modes hold theta within this many ulps of max|theta| of the
# plain version (measured on the card: at most 1.92; the kernels form the
# diffusion with the 3-point Laplacian, the plain version as face fluxes)
THETA_ULPS = 8
# float32 operations per cell the thermal modes add: two buoyancy terms
# (2D) or three (3D) of 5; the update's fluxes (~7 each, with the upwind
# blend), its Laplacian and the step (2D ~45, 3D ~65)
THERMAL_OPS = {"predictor_rhs_2d": 10, "correct_diag_2d": 45,
               "predictor_rhs_3d": 15, "correct_diag_3d": 65}
# the launch counters of the LES step's path
LES_PATH = ("nu_t_3d", "predictor_3d", "residual_3d", "correct_diag_3d")
# the forcing slice at full width: the periodic duct (kernel 1's static
# force), Kolmogorov flow in 3D and 2D (forcing volumes of kernels 1 and
# 4, rk2), the Womersley channel (kernel 4's force entry refilled from t),
# the oscillating lid in 3D and 2D (the wall entry refilled from t) and the
# heated enclosure (kernel 8's forcing volume: buoyancy around the body)
FORCING_PATHS = {
    "duct_periodic": ("duct_periodic", dict(shape=(512, 128, 128),
                                            lengths=(4.0, 1.0, 1.0),
                                            re=100.0)),
    "kolmogorov3d": ("kolmogorov", dict(shape=SHAPE, re=30.0, k_forcing=4)),
    "kolmogorov2d": ("kolmogorov", dict(shape=SHAPE2, re=30.0, k_forcing=4)),
    "pulsatile_channel": ("pulsatile_channel", dict(shape=(2048, 1024),
                                                    womersley=5.0)),
    "oscillating_lid3d": ("oscillating_lid", dict(shape=SHAPE, re=100.0)),
    "oscillating_lid2d": ("oscillating_lid", dict(shape=SHAPE2, re=100.0)),
    "heated_enclosure": ("heated_enclosure", dict(shape=SHAPE2, ra=1e6)),
}
FORCING_STEPS = 30             # each timed run of the forcing slice ...
ENCLOSURE_STEPS = 3            # ... but the enclosure's (mg, host-bound:
                               # ~0.3 s and ~2e4 launches a step at 2048^2;
                               # timed alone, for its counters)
FORCE3 = (0.7, -0.2, 0.3)      # phase 2's static force in 3D
# kernel 4's forcing volumes in phase 2 on these shapes (PER_P2's but the
# channel's), kernel 8's on the enclosure's and a ragged table
FORCING_P2 = (PER_SHAPE, (994, 1002), (20, 14))
# float32 operations per cell a forced mode adds: one add a face (kernel
# 6's: and the force's add to the subgrid stress; its buoyancy's are
# THERMAL_OPS["predictor_rhs_3d"])
FORCE_OPS = {"predictor_rhs_3d": 3, "predictor_rhs_2d": 2,
             "predictor_2d": 2, "predictor_3d": 6}
# the sphere's slice at its published size (make_case("sphere"): 256x128x128
# over 16x8x8 diameters, Re 300, dctcg): each timed run's steps, and the
# float32 operations a cell the masked mode adds (the six faces' open
# bits and the RHS's fluid select)
SPHERE_STEPS = 20
MASK_OPS = 7
# float32 roundoff of max|div u| at the sphere's h = 1/16 (|u|/h ~ 30):
# what its check may exceed dt/rho ||b - A p||_2 by
SPHERE_DIV_FLOOR = 1e-5
# the masked mode's entries of the report, the kernels they run in
SPHERE_MODES = ("predictor_rhs_3d masked", "correct_diag_3d masked")
# the LES slice (taylor_green3d 256^3 and the sphere 256x128x128 with the
# Smagorinsky closure at the CLIs' default constant): each timed run's
# steps, and kernels 6-7's new modes in the report with the run that
# launches them (the Euler run of the case)
LES_CS = 0.17
LES_STEPS = 20
LES_MODES = {"nu_t_3d periodic": "taylor_green3d les euler",
             "predictor_3d periodic": "taylor_green3d les euler",
             "nu_t_3d open": "sphere les euler",
             "predictor_3d masked": "sphere les euler"}
# the sharp-interface slice (the sphere's IBM, its spinning and its
# cut-cell variants at 256x128x128, the cut-cell cylinder at 2048x1024):
# each timed run's steps (Euler, rk2; the cut paths' plain V-cycles take
# 1-3.6 s a step; the cut cylinder's outflow flux is 2.6e-6 off its
# inflow after two rk2 steps from the impulsive start, 3e-8 after four)
# and warm-up steps, phase 3's steps of the cut cylinder (Euler, rk2,
# cfl), and kernel 2's coded mode in the report with the run that
# launches it (the moving body's wet faces; the cut band's cells left out
# of max|div u|); the cut paths run few steps and the cut sphere is not
# profiled, to keep the script within its run time (PERF.md §2: 959.8 s
# without these cuts and with the 3D enclosure's rk2 step profiled)
SHARP_STEPS = {"ibm sphere": (20, 20), "spin sphere": (20, 20),
               "sharp sphere": (2, 1), "sharp cylinder": (3, 3)}
SHARP_WARMUP = 1
CUT_CYLINDER_STEPS = {"euler": 3, "rk2": 2, "cfl": 2}
SHARP_MODES = {"correct_diag_3d coded": "spin sphere euler",
               "correct_diag_3d coded cut": "sharp sphere euler"}
# the convective slice: kernels 4-5's open modes on these shapes in phase
# 2 (with fewer rows than a run and n1 % 29 != 0; several runs, strips and
# warps), each timed path's steps, the float32 operations a cell the 2D
# masked mode adds (four faces' open bits and the RHS's fluid select), and
# the modes of kernels 1, 2, 4, 5 on the slice's main paths in the report
# with the run that launches them
OPEN_P2 = ((37, 45), (130, 70))
CONV_STEPS = 20
MASK_OPS_2D = 5
CONV_MODES = {
    "predictor_rhs_2d masked": "staircase euler",
    "predictor_rhs_2d masked base": "staircase rk2",
    "correct_diag_2d masked": "staircase euler",
    "predictor_rhs_2d masked convective": "convective cylinder euler",
    "correct_diag_2d masked convective": "convective cylinder euler",
    "predictor_rhs_3d masked convective": "convective sphere euler",
    "predictor_rhs_3d masked convective base": "convective sphere rk2",
    "correct_diag_3d masked convective": "convective sphere euler",
}


_T0 = time.perf_counter()


def line(phase: str, **kv) -> None:
    """One line of the report; ``at_s``: seconds since the script started,
    so that a run's output shows where its time goes."""
    kv["at_s"] = f"{time.perf_counter() - _T0:.1f}"
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
                        based=False, force_vol=None) -> tuple:
    """Kernels 4 and 5 in their wrap modes (``force``: the static body
    force; ``force_vol``: forcing volumes; ``based``: rk2's base form)
    against their plain versions on
    random O(0.1) fields and a random pressure, whose gradient at the wrap
    faces is not zero: compare_kernels_2d's tolerances, and face n of a
    periodic axis bit-equal to face 0 in both kernels' outputs. Returns the
    two kernels' errors."""
    rho = 1.3
    per = periodic_axes(grid, bcs)
    u = random_state(grid, bcs, gen, scale=0.1)
    base = random_state(grid, bcs, gen, scale=0.1) if based else None
    k_u, k_rhs = fused2d.predictor_rhs_2d(grid, bcs, u, dt, nu, gamma, rho,
                                          base=base, force=force,
                                          force_vol=force_vol)
    p_u, p_rhs = fused2d.predictor_rhs_2d_plain(grid, bcs, u, dt, nu, gamma,
                                                rho, base=base, force=force,
                                                force_vol=force_vol)
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
    cfg = sim.params.poisson
    res = float(diag.poisson_res.max())
    if not math.isfinite(res):
        raise AssertionError(f"{cfg.method}: residual {res}")
    capped = int(diag.poisson_iters.max()) >= cfg.max_iters
    if cfg.method in ("mg", "mgcg", "dctcg") and capped:
        raise AssertionError(f"{cfg.method}: a step ran to its cap")
    _, d, bound, true_res, _ = step_div_bound(sim, st)
    max_div = float(d.max_div)
    if not max_div <= bound:
        raise AssertionError(f"max_div {max_div} above dt/rho ||b - A p|| + "
                             f"1e-3 = {bound}")
    return {"max_res": res, "capped": capped, "next_max_div": max_div,
            "div_bound": bound, "next_true_res": true_res,
            "next_res": float(d.poisson_res)}


def step_div_bound(sim, st, plain=False, replay=None):
    """One step of ``sim`` from ``st`` (``plain``: step_plain) and the
    bound its corrector leaves on max|div u_new|: dt/rho ||b - A p||_2, b
    the RHS of the step's last solve (rk2's stage 2), plus the direct
    solve's float32 floor (1e-3, the fft gate). ``replay``: the solves of
    another step, whose outputs stand in for this step's own, in order.
    Returns (state, diag, bound, ||b - A p||_2 / ||b||_2, solves), solves
    the step's (rhs, (p, iters, res)) in order."""
    solves = []
    solve = sim._solve_pressure

    def hook(b, *a, **k):
        out = solve(b, *a, **k) if replay is None else replay[len(solves)][1]
        solves.append((b, out))
        return out

    sim._solve_pressure = hook
    try:
        st_n, d = (sim.step_plain if plain else sim.step)(st)
    finally:
        del sim._solve_pressure
    b = poisson.deflate(sim.op, solves[-1][0] * sim.op.fluid)
    r2 = float(poisson.residual_norm(sim.op, st_n.p, b))
    return (st_n, d, 1e-3 + float(d.dt) / sim.params.rho * r2,
            r2 / float(torch.linalg.norm(b)), solves)


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
                   count_slack=0, p_rel=1e-4, theta_rel=None,
                   p_witness=False) -> None:
    """``steps`` kernel steps against step_plain from ``state`` (the
    case's initial state): the dt series within rtol 3e-5, u and p within
    ``u_tol`` and ``p_tol`` ((rtol, atol); a p atol of None: ``p_rel`` of
    max|p|), theta (``theta_rel``: a case with a scalar) within
    ``theta_rel`` of max|theta|, solve counts within ``count_slack`` a
    step, max_div of both < 1e-3. ``p_witness``: p's atol at least twice
    the witness, the p gap of step_plain run from the start one ulp up
    (u's roundoff floor carried into p by rho/dt: a small-dt step whose p
    is small)."""
    sim = case.sim
    st_k = st_p = case.initial_state() if state is None else state
    st_w = None
    if p_witness:
        st_w = dataclasses.replace(st_p, u=tuple(
            torch.nextafter(c, torch.full_like(c, math.inf))
            for c in st_p.u))
    dk, dp, its = [], [], []
    for _ in range(steps):
        st_k, d_k = sim.step(st_k)
        st_p, d_p = sim.step_plain(st_p)
        if st_w is not None:
            st_w, _ = sim.step_plain(st_w)
        dk.append(d_k.dt)
        dp.append(d_p.dt)
        its.append((int(d_k.poisson_iters), int(d_p.poisson_iters)))
    dk, dp = torch.stack(dk), torch.stack(dp)
    close(f"{what} dt series", dk, dp, 3e-5, 0.0)
    eu = max(close(f"{what} u[{a}]", st_k.u[a], st_p.u[a], *u_tol)
             for a in range(sim.grid.ndim))
    max_p = float(st_p.p.abs().max())
    p_atol = p_rel * max_p if p_tol[1] is None else p_tol[1]
    extra = {}
    if st_w is not None:
        extra["p_witness"] = float((st_w.p - st_p.p).abs().max())
        p_atol = max(p_atol, 2.0 * extra["p_witness"])
    ep = close(f"{what} p", st_k.p, st_p.p, p_tol[0], p_atol)
    if theta_rel is not None:
        if st_k.theta is None or st_p.theta is None:
            raise AssertionError(f"{what}: a step dropped theta")
        max_t = float(st_p.theta.abs().max())
        extra = dict(theta_max_abs_err=close(f"{what} theta", st_k.theta,
                                             st_p.theta, 0.0,
                                             theta_rel * max_t),
                     max_abs_theta=max_t)
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
         max_div_plain=divs[1], **extra)


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
    # the warning of a synchronizing call; not the mode's own first-use
    # warning ("... does not yet detect all synchronizing operations")
    return sum("called a synchronizing" in str(w.message)
               for w in caught) / steps


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
            # the mangled name's last length-prefixed identifier ending in
            # "kernel" (not the internal namespace's tag before it, whose
            # hash of the source's path can read as a length prefix too)
            m = ([m for m in re.finditer(
                r"(?=(\d+)([a-z_][a-z0-9_]*kernel)((?:I?L[ib]\d+E)*))", l)
                if len(m.group(2)) == int(m.group(1))] or [None])[-1]
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


# -- the convection slice: the transported scalar, kernels 1, 2, 4, 5 in
# their thermal modes -------------------------------------------------------


def thermal_scalar(nd, wrap, buoyancy, gamma, alpha=1e-3):
    """A scalar on every kind of face: Dirichlet on axis 0's low face,
    adiabatic on its high face, each axis in ``wrap`` wrapped, Dirichlet
    on both faces of the other axes; theta_ref 0.5, diffusivity
    ``alpha``."""
    bcs = {}
    for a in range(nd):
        if wrap[a]:
            bcs[(a, 0)] = bcs[(a, 1)] = ScalarBC.periodic()
        elif a == 0:
            bcs[(0, 0)] = ScalarBC.dirichlet(1.0)
            bcs[(0, 1)] = ScalarBC.adiabatic()
        else:
            bcs[(a, 0)] = ScalarBC.dirichlet(0.8)
            bcs[(a, 1)] = ScalarBC.dirichlet(0.1)
    return ScalarConfig(bcs=bcs, diffusivity=alpha, buoyancy=buoyancy,
                        theta_ref=0.5, upwind_gamma=gamma)


def theta_atol(ref) -> float:
    """THETA_ULPS ulps of max|theta| (at least of 1)."""
    return THETA_ULPS * 2.0 ** -23 * max(float(ref.abs().max()), 1.0)


def compare_thermal(grid, bcs, cfg, dt, nu, gen, errs, based=False,
                    force=None, device_dt=False) -> tuple:
    """The predictor (kernel 4 or 1) with theta's buoyancy and the
    corrector (kernel 5 or 2) advancing theta against their plain versions
    on random fields: theta of O(1) (uniform on [0, 1)), the velocity of
    O(0.1) in 2D and O(1) in 3D, a random pressure; ``based``: rk2's base
    form; ``force``: kernel 4's static force with it; ``device_dt``: the
    step size a device buffer of DT_FACTOR * dt. The velocity and RHS
    tolerances of compare_kernels_2d / compare_kernels, theta within
    THETA_ULPS ulps of max|theta|. Returns (predictor error, corrector
    error, theta error in ulps of max|theta|)."""
    nd, rho = grid.ndim, 1.3
    scale_u = 0.1 if nd == 2 else 1.0
    mid = random_state(grid, bcs, gen, scale=scale_u)
    base = random_state(grid, bcs, gen, scale=scale_u) if based else None
    theta = torch.rand(grid.shape, generator=gen, device=DEV)
    if device_dt:
        dts = device_dts(DT_FACTOR * dt, rho)
        dt_k, dt_f = dts[0], float(dts[0])
    else:
        dts, dt_k, dt_f = None, dt, dt
    per = periodic_axes(grid, bcs)
    if nd == 2:
        k_u, k_rhs = fused2d.predictor_rhs_2d(
            grid, bcs, mid, dt_k, nu, cfg.upwind_gamma, rho, base=base,
            dts=dts, force=force, theta=theta, scalar=cfg)
        p_u, p_rhs = fused2d.predictor_rhs_2d_plain(
            grid, bcs, mid, dt_f, nu, cfg.upwind_gamma, rho, base=base,
            force=force, theta=theta, scalar=cfg)
        u_tol, rhs_tol = (0.0, 2e-6), 2e-6 * max(float(p_rhs.abs().max()),
                                                 1.0)
        rhs_rtol, corr = 0.0, fused2d.correct_diag_2d
        p = 0.01 * torch.randn(grid.shape, generator=gen, device=DEV)
    else:
        k_u, k_rhs = fused3d.predictor_rhs_3d(
            grid, bcs, mid, dt_k, nu, cfg.upwind_gamma, rho, base=base,
            dts=dts, theta=theta, scalar=cfg)
        p_u, p_rhs = fused3d.predictor_rhs_plain(
            grid, bcs, mid, dt_f, nu, cfg.upwind_gamma, rho,
            forcing=buoyancy_forcing(grid, cfg, theta), base=base)
        u_tol, rhs_tol = (1e-5, 1e-5), 3e-7 * float(p_rhs.abs().max())
        rhs_rtol, corr = 1e-4, fused3d.correct_diag_3d
        p = torch.randn(grid.shape, generator=gen, device=DEV)
    e = max(close(f"thermal u*[{a}]", k_u[a], p_u[a], *u_tol)
            for a in range(nd))
    e = max(e, close("thermal rhs", k_rhs, p_rhs, rhs_rtol, rhs_tol))
    scale_k = dts[2] if device_dt else dt / rho
    k_n, _, k_vel, k_th = corr(grid, k_u, p, scale_k, per, theta=theta,
                               scalar=cfg, dt=dt_k)
    p_n, _, p_vel, p_th = fused3d.correct_diag_thermal_plain(
        grid, k_u, p, float(dts[2]) if device_dt else dt / rho, per, theta,
        cfg, dt_f)
    e2 = max(close(f"thermal u_new[{a}]", k_n[a], p_n[a], *u_tol)
             for a in range(nd))
    e2 = max(e2, close("thermal max_vel", k_vel, p_vel, 1e-4, 0.0))
    et = close("thermal theta", k_th, p_th, 0.0, theta_atol(p_th))
    e2 = max(e2, et)
    kp, kc = (("predictor_rhs_2d", "correct_diag_2d") if nd == 2
              else ("predictor_rhs_3d", "correct_diag_3d"))
    errs[kp] = max(errs[kp], e)
    errs[kc] = max(errs[kc], e2)
    return e, e2, et / (2.0 ** -23 * max(float(p_th.abs().max()), 1.0))


def check_thermal_modes(gen, errs) -> None:
    """Phase 2 of the convection slice: the thermal modes of kernels 4-5
    on 2048^2 (walls), 2048x1024 (axis 0 periodic, as rayleigh_benard),
    and the ragged (994, 1002) and (20, 14), and of kernels 1-2 on
    256^3, a ragged (37, 19, 45) and a mixed periodic (38, 22, 46); at
    gamma 0 and 0.8, with theta on Dirichlet, adiabatic and wrap faces
    and buoyancy on every bounded axis ((0.3, 1.0), (0.3, 0.0, 1.0); on
    axis 1 alone where axis 0 wraps); kernels 4-5 also in thermal + base
    and thermal + force mode, and all four on a device dt. Then the wrap
    conservation of kernel 5: a passive scalar with adiabatic walls and
    periodic rows keeps sum(theta) to the rounding of the cell updates.
    The step: in 2D dt = h/4 with nu 1e-4 (the velocity of O(0.1): a CFL
    number of 0.025; the 2D kernels' tolerance assumes u* of O(0.1)), in
    3D compare_kernels' dt = 1e-3 and nu 0.02; alpha is 0.2 h^2 / dt, a
    stable explicit diffusion number."""
    shapes2 = ((THERMAL_P2[0], (1.0, 1.0), (False, False)),
               (THERMAL_P2[1], (2.0, 1.0), (True, False)),
               (THERMAL_P2[2], (1.0, 1.0), (False, False)),
               (THERMAL_P2[3], (0.3, 0.2), (False, False)))
    for shape, lengths, per in shapes2:
        grid = GridSpec(shape, lengths)
        bcs = periodic_2d_bcs(grid, per)
        dt, nu = 0.25 * min(grid.spacing), 1e-4
        alpha = 0.2 * min(grid.spacing) ** 2 / dt
        buoy = (0.0, 1.0) if per[0] else (0.3, 1.0)
        out = {}
        for gamma in (0.0, 0.8):
            cfg = thermal_scalar(2, per, buoy, gamma, alpha)
            out[f"gamma {gamma}"] = compare_thermal(grid, bcs, cfg, dt, nu,
                                                    gen, errs)
        cfg = thermal_scalar(2, per, buoy, 0.3, alpha)
        out["base"] = compare_thermal(grid, bcs, cfg, dt, nu, gen, errs,
                                      based=True)
        out["force"] = compare_thermal(grid, bcs, cfg, dt, nu, gen, errs,
                                       force=PER_FORCE)
        out["device dt"] = compare_thermal(grid, bcs, cfg, dt, nu, gen, errs,
                                           based=True, device_dt=True)
        torch.cuda.synchronize()
        line("phase2", thermal_2d=_name(shape), periodic=json.dumps(per),
             buoyancy=json.dumps(buoy),
             err_pred_corr_theta_ulps=json.dumps(out))
    rag_p = (38, 22, 46)
    for shape, per in ((SHAPE, (False,) * 3), (RAGGED_WALL, (False,) * 3),
                       (rag_p, (True, False, True))):
        grid = GridSpec(shape, (1.0, 0.6, 1.8))
        bcs = no_slip_box(grid)
        bcs[(2, 1)] = BCSpec.wall((1.0, 0.3, 0.0))
        for a in range(3):
            if per[a]:
                bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
        buoy = (0.0, 1.0, 0.0) if per[0] else (0.3, 0.0, 1.0)
        dt, nu = 1e-3, 0.02
        alpha = 0.2 * min(grid.spacing) ** 2 / dt
        out = {}
        for gamma in (0.0, 0.8):
            cfg = thermal_scalar(3, per, buoy, gamma, alpha)
            out[f"gamma {gamma}"] = compare_thermal(grid, bcs, cfg, dt, nu,
                                                    gen, errs)
        out["base device dt"] = compare_thermal(grid, bcs, cfg, dt, nu, gen,
                                                errs, based=True,
                                                device_dt=True)
        torch.cuda.synchronize()
        line("phase2", thermal_3d=_name(shape), periodic=json.dumps(per),
             buoyancy=json.dumps(buoy),
             err_pred_corr_theta_ulps=json.dumps(out))
    # the wrap conservation of kernel 5
    grid = GridSpec(THERMAL_P2[1], (2.0, 1.0))
    bcs = no_slip_box(grid)
    bcs[(0, 0)] = bcs[(0, 1)] = BCSpec.periodic()
    cfg = ScalarConfig(bcs={(0, 0): ScalarBC.periodic(),
                            (0, 1): ScalarBC.periodic(),
                            (1, 0): ScalarBC.adiabatic(),
                            (1, 1): ScalarBC.adiabatic()},
                       diffusivity=1e-3, upwind_gamma=0.5)
    us = random_state(grid, bcs, gen, scale=0.5)
    p = 0.01 * torch.randn(grid.shape, generator=gen, device=DEV)
    theta = torch.rand(grid.shape, generator=gen, device=DEV)
    dt = 0.25 * min(grid.spacing)
    *_, th1 = fused2d.correct_diag_2d(grid, us, p, dt, (True, False),
                                      theta=theta, scalar=cfg, dt=dt)
    s0, s1 = float(theta.double().sum()), float(th1.double().sum())
    # the cell updates each round at ulp(1): their sum drifts like a random
    # walk, ~sqrt(cells) ulps; a flux counted twice or lost at the wrap
    # face would move it by ~u dt / h theta per cell of the face
    drift_ulps = abs(s1 - s0) / 2.0 ** -23
    bound = 16 * math.sqrt(math.prod(grid.shape))
    if not drift_ulps < bound:
        raise AssertionError(f"kernel 5 wrap: sum(theta) moved {drift_ulps} "
                             f"ulps, bound {bound}")
    line("phase2", thermal_wrap_conservation=_name(grid.shape),
         sum_before=s0, sum_after=s1, drift_ulps=drift_ulps,
         bound_ulps=bound)


def thermal_cases() -> dict:
    """The convection slice's four paths at full width, with their athermal
    twins (the same grid, table and solver without the scalar, on the
    route build would give it: the heated cylinder's twin fuses)."""
    cases = {
        "heated_cavity": make_case("heated_cavity", device=DEV, **CONV_2D),
        "rayleigh_benard": make_case("rayleigh_benard", device=DEV,
                                     **CONV_RB),
        "heated_cavity3d": make_case("heated_cavity", device=DEV, **CONV_3D),
        "heated_cylinder": make_case("heated_cylinder", device=DEV,
                                     **CONV_CYL),
    }
    # each twin shares its path's solver: the simulation without the scalar
    twins = {k: dataclasses.replace(
        c, name=f"{k} athermal twin", sim=dataclasses.replace(
            c.sim, scalar=None, scalar_solid=None, thermal=None))
        for k, c in cases.items()}
    return cases, twins


def thermal_steps_vs_plain(cases) -> None:
    """Phase 3 of the convection slice: 5 Euler and 5 rk2 steps of each
    path against step_plain, u and p with the 2D and 3D whole-step
    tolerances (p atol 2e-4 of max|p|, as the periodic cases: rho/dt of
    ~4000 at 2048^2 amplifies the divergence's roundoff into the smooth
    modes of p) and theta within 1e-5 of max|theta|. The cylinder's dctcg
    solve stops at a relative residual of 1e-5, so its p is held within
    1e-4 of max|p| and its u within what that passes on through the
    correction, dt/h 1e-4 max|p| (4.4e-5 at 2048x1024: u atol 5e-5)."""
    for k, c in cases.items():
        for integ in ("euler", "rk2"):
            cm = with_params(c, integrator=integ)
            u_tol, p_rel, slack = (2e-5, 2e-6), 2e-4, 0
            if k == "heated_cylinder":
                u_tol, p_rel = (2e-5, 5e-5), 1e-4
                slack = 2 if integ == "rk2" else 1
            steps_vs_plain(cm, f"{k} {integ}", u_tol, (2e-4, None),
                           count_slack=slack, p_rel=p_rel, theta_rel=1e-5)


def profile_launches(sim, st, steps=20):
    """(launches a step, kernel busy ms a step) of ``steps`` steps of
    ``run_scan`` from ``st`` under torch.profiler (step_profile's
    device_profile)."""
    kernels, _, launches = device_profile(lambda: sim.run_scan(st, steps), 1)
    return launches / steps, sum(kernels.values()) / steps


def thermal_runs(cases, twins, reset_all) -> dict:
    """Phase 4 of the convection slice: each path timed (200 steps; the 3D
    cavity 50) beside its athermal twin, in turns path, twin, twin, path;
    launches a step and busy ms a step over 20 profiled steps after them,
    the device's idle share (busy over the faster run's ms); the fused
    thermal paths launch what their twins do, within one launch a step (a
    thermal launch would add one or more every step; the profiler's count
    of a window varies by a launch or two, as a twin's 274.8 against 275.0
    over 5 steps showed, and it can drop records: counts that differ are
    profiled once more and the larger kept). Then the thermal
    modes' device times at full width (events beside the plain versions,
    kernels 4-5 also by graph replay), no synchronizing call a step of the
    2D cavity under rk2 at cfl 0.5, and the oracles on the kernel route.
    Returns the runs."""
    def counts_for(sim):
        # the heated cylinder runs the unfused route, its athermal twin the
        # fused one (a replaced 2D simulation takes build's route)
        if sim.grid.ndim == 3:
            return lambda: dict(fused3d.LAUNCHES)
        if not sim.fused:
            return lambda: dict(predictor2d.LAUNCHES)
        return lambda: dict(fused2d.LAUNCHES)

    runs = {}
    for k, c in cases.items():
        steps = CONV_3D_STEPS if k == "heated_cavity3d" else TIMED_STEPS
        pair = {"thermal": [], "twin": []}
        # timed in the order path, twin, twin, path (the host's speed drifts
        # within a call), then both profiled, after the four timed runs
        for what in ("thermal", "twin", "twin", "thermal"):
            cc = c if what == "thermal" else twins[k]
            pair[what].append(timed_run(cc, reset_all, counts_for(cc.sim),
                                        steps=steps))
        t, w = pair["thermal"][-1], pair["twin"][-1]
        # the profiler can drop records, never add them (a twin once read
        # 32.9 launches a step against 35.2, its busy ms short by as much):
        # where the two counts differ both are taken again, the larger kept
        for attempt in range(2):
            for r, cc in ((t, c), (w, twins[k])):
                per_step, busy = profile_launches(cc.sim, r["state"])
                if per_step <= r.get("launches_per_step", -1.0):
                    continue
                ms = min(x["ms"] for x in pair["thermal" if r is t
                                                else "twin"])
                r.update(launches_per_step=per_step, busy_ms=busy,
                         idle_share=max(0.0, 1.0 - busy / ms))
            # (the unfused cylinder's scalar update adds launches: no retry)
            if not c.sim.fused or abs(t["launches_per_step"]
                                      - w["launches_per_step"]) < 1.0:
                break
        runs[k] = {"thermal": t, "twin": w}
        line("phase4", convection=k, shape=_name(c.sim.grid.shape),
             poisson=c.sim.params.poisson.method, fused=c.sim.fused,
             ms_per_step_thermal_twin_twin_thermal=json.dumps(
                 [round(pair[a][i]["ms"], 4)
                  for a, i in (("thermal", 0), ("twin", 0), ("twin", 1),
                               ("thermal", 1))]),
             busy_ms_per_step_thermal_twin=json.dumps(
                 [round(t["busy_ms"], 4), round(w["busy_ms"], 4)]),
             idle_share_thermal_twin=json.dumps(
                 [round(t["idle_share"], 4), round(w["idle_share"], 4)]),
             launches_per_step_thermal_twin=json.dumps(
                 [t["launches_per_step"], w["launches_per_step"]]),
             kernel_launches_thermal=json.dumps(t["launches"]),
             theta_min_max=json.dumps([float(t["state"].theta.min()),
                                       float(t["state"].theta.max())]))
        if c.sim.fused and not abs(t["launches_per_step"]
                                   - w["launches_per_step"]) < 1.0:
            raise AssertionError(f"{k}: {t['launches_per_step']} launches a "
                                 f"step, its twin {w['launches_per_step']}")
    # the thermal modes at full width, on the timed runs' states
    times, bounds = {}, {}
    calls, graph = {}, []
    for k, kp, kc in (("heated_cavity", "predictor_rhs_2d",
                       "correct_diag_2d"),
                      ("rayleigh_benard", "predictor_rhs_2d",
                       "correct_diag_2d"),
                      ("heated_cavity3d", "predictor_rhs_3d",
                       "correct_diag_3d")):
        s_ = cases[k].sim
        st = runs[k]["thermal"]["state"]
        g_, b_, pr_ = s_.grid, s_.bcs, s_.params
        per_ = periodic_axes(g_, b_)
        dts = s_._dts(None)
        pred = fused2d.predictor_rhs_2d if g_.ndim == 2 \
            else fused3d.predictor_rhs_3d
        corr = fused2d.correct_diag_2d if g_.ndim == 2 \
            else fused3d.correct_diag_3d
        kw = dict(bc=s_.bc, dts=dts, theta=st.theta, scalar=s_.scalar,
                  thermal=s_.thermal)
        us, rhs = pred(g_, b_, st.u, dts[0], pr_.nu, pr_.upwind_gamma,
                       pr_.rho, **kw)
        cells = math.prod(g_.shape)
        plain_kw = dict(theta=st.theta, scalar=s_.scalar)
        if g_.ndim == 2:
            plain_pred = (lambda g_=g_, b_=b_, st=st, pr_=pr_, dts=dts,
                          pk=plain_kw: fused2d.predictor_rhs_2d_plain(
                              g_, b_, st.u, float(dts[0]), pr_.nu,
                              pr_.upwind_gamma, pr_.rho, **pk))
        else:
            plain_pred = (lambda g_=g_, b_=b_, st=st, pr_=pr_, dts=dts,
                          s_=s_: fused3d.predictor_rhs_plain(
                              g_, b_, st.u, float(dts[0]), pr_.nu,
                              pr_.upwind_gamma, pr_.rho,
                              buoyancy_forcing(g_, s_.scalar, st.theta)))
        calls[f"{kp} thermal {k}"] = (
            lambda pred=pred, g_=g_, b_=b_, st=st, pr_=pr_, dts=dts, kw=kw:
            pred(g_, b_, st.u, dts[0], pr_.nu, pr_.upwind_gamma, pr_.rho,
                 **kw),
            plain_pred,
            nbytes(*st.u, st.theta, *us, rhs, s_.bc, s_.thermal),
            (OPS_PER_CELL[kp] + THERMAL_OPS[kp]) * cells)
        calls[f"{kc} thermal {k}"] = (
            lambda corr=corr, g_=g_, us=us, st=st, dts=dts, per_=per_, s_=s_:
            corr(g_, us, st.p, dts[2], per_, theta=st.theta,
                 scalar=s_.scalar, dt=dts[0], thermal=s_.thermal),
            lambda g_=g_, us=us, st=st, dts=dts, per_=per_, s_=s_:
            fused3d.correct_diag_thermal_plain(
                g_, us, st.p, float(dts[2]), per_, st.theta, s_.scalar,
                float(dts[0])),
            nbytes(*us, st.p, st.theta, *us, st.theta, s_.thermal) + 8,
            (OPS_PER_CELL[kc] + THERMAL_OPS[kc]) * cells)
        if g_.ndim == 2:
            graph.append((k, kp, kc, s_, st, us, dts, per_, kw))
    time_pairs(calls, times, bounds)
    for k, kp, kc, s_, st, us, dts, per_, kw in graph:
        g_, b_, pr_ = s_.grid, s_.bcs, s_.params
        name = f"{kp} thermal {k}"
        device_times(name, [
            lambda s=s, g_=g_, b_=b_, pr_=pr_, dts=dts, kw=kw:
            fused2d.predictor_rhs_2d(
                g_, b_, s[:2], dts[0], pr_.nu, pr_.upwind_gamma, pr_.rho,
                **{**kw, "theta": s[2]})
            for s in rotated((*st.u, st.theta),
                             nbytes(*st.u, st.theta, *us, st.p))],
            min(times[name][0], times[name][3]))
        name = f"{kc} thermal {k}"
        device_times(name, [
            lambda s=s, g_=g_, dts=dts, per_=per_, s_=s_:
            fused2d.correct_diag_2d(g_, s[:2], s[2], dts[2], per_,
                                    theta=s[3], scalar=s_.scalar, dt=dts[0],
                                    thermal=s_.thermal)
            for s in rotated((*us, st.p, st.theta),
                             nbytes(*us, st.p, st.theta, *us, st.theta))],
            min(times[name][0], times[name][3]))
    # no synchronizing call a step: the 2D cavity under rk2 at cfl 0.5
    hc = cases["heated_cavity"]
    sync = syncs_per_step(with_params(hc, integrator="rk2", cfl=0.5).sim,
                          hc.initial_state())
    if sync != 0:
        raise AssertionError(f"heated_cavity rk2 cfl 0.5: {sync} "
                             "synchronizing calls a step")
    line("phase4", heated_cavity_rk2_cfl_sync_calls_per_step=sync)
    thermal_oracles()
    return runs


def run_to(case, t_end):
    """``case`` from its initial state to ``t_end`` on the kernel route."""
    sim = case.sim
    n = int(round(t_end / sim.params.dt))
    st, d = sim.run_scan(case.initial_state(), n)
    return st, d, n


def thermal_oracles() -> None:
    """The JAX package's convection oracles (tests/test_scalar.py) on the
    kernel route: de Vahl Davis at Ra 1e3 (32^2, t = 12: the hot-wall
    Nusselt number within 2% of 1.118) and, reported, Ra 1e4 (64^2)
    against 2.243; Rayleigh-Benard criticality (48x24, t = 30: kinetic
    energy < 1e-5 at Ra 800, > 1 at Ra 5000); sum(theta) of a passive
    scalar conserved (rtol 1e-5) in the closed cavity (32^2, 400 steps)
    and in the periodic channel at 2048x512 (200 steps, a blob that
    crosses the wrap face); the 3D cavity at 16^3 (150 steps: theta in
    [-0.01, 1.01], max|u_2| > 1e-2)."""
    import numpy as np

    out = {}
    c = make_case("heated_cavity", shape=(32, 32), ra=1e3, device=DEV)
    st, d, n = run_to(c, 12.0)
    nu3 = hot_wall_nusselt(c.sim, st.theta)
    out["dvd_ra1e3"] = dict(nusselt=nu3, steps=n,
                            max_div=float(d.max_div[-1]),
                            max_u=float(st.u[0].abs().max()))
    if not (abs(nu3 - 1.118) / 1.118 < 0.02 and float(d.max_div[-1]) < 1e-5
            and float(st.u[0].abs().max()) > 0.05):
        raise AssertionError(f"de Vahl Davis Ra 1e3: {out['dvd_ra1e3']}")
    c = make_case("heated_cavity", shape=(64, 64), ra=1e4, device=DEV)
    st, d, n = run_to(c, 12.0)
    out["dvd_ra1e4_reported"] = dict(
        nusselt=hot_wall_nusselt(c.sim, st.theta), published=2.243, steps=n)
    kes = {}
    for ra in (800.0, 5000.0):
        c = make_case("rayleigh_benard", shape=(48, 24), ra=ra, device=DEV)
        st, d, n = run_to(c, 30.0)
        kes[ra] = sum(float((x * x).sum()) for x in st.u)
        if not float(d.max_div[-1]) < 1e-5:
            raise AssertionError(f"Rayleigh-Benard Ra {ra}: max_div "
                                 f"{float(d.max_div[-1])}")
    out["rb_kinetic_ra800_ra5000"] = [kes[800.0], kes[5000.0]]
    if not (kes[800.0] < 1e-5 and kes[5000.0] > 1.0):
        raise AssertionError(f"Rayleigh-Benard criticality: {kes}")
    # sum(theta) of a passive scalar (adiabatic walls, flux form)
    cav = make_case("cavity", shape=(32, 32), re=100.0, device=DEV)
    x = (np.arange(32) + 0.5) / 32
    blob = np.exp(-((x[:, None] - 0.3) ** 2 + (x[None, :] - 0.5) ** 2) / 0.02)
    adiabatic = {(a, s): ScalarBC.adiabatic() for a in range(2)
                 for s in (0, 1)}
    box = Simulation.build(cav.sim.grid, cav.sim.bcs, cav.sim.params, DEV,
                           scalar=ScalarConfig(bcs=adiabatic,
                                               diffusivity=1e-3,
                                               theta_init=blob))
    chp = make_case("channel_periodic", shape=PER_CHANNEL, device=DEV)
    g_c = chp.sim.grid
    xc = torch.as_tensor(g_c.cell_centers(0), device=DEV)
    yc = torch.as_tensor(g_c.cell_centers(1), device=DEV)
    ring = torch.exp(-((xc[:, None] - 0.05 * g_c.lengths[0]) ** 2
                       + (yc[None, :] - 0.5) ** 2) / 0.05)
    wrap_cfg = ScalarConfig(bcs={(0, 0): ScalarBC.periodic(),
                                 (0, 1): ScalarBC.periodic(),
                                 (1, 0): ScalarBC.adiabatic(),
                                 (1, 1): ScalarBC.adiabatic()},
                            diffusivity=1e-3, upwind_gamma=0.2,
                            theta_init=ring.cpu().numpy())
    chan = Simulation.build(g_c, chp.sim.bcs, chp.sim.params, DEV,
                            forcing=chp.sim.forcing, scalar=wrap_cfg)
    for what, sim, start, n in (
            ("closed_box_32x32", box, None, 400),
            ("periodic_channel_2048x512", chan, chp.initial_state(), 200)):
        st0 = sim.initial_state()
        if start is not None:
            st0 = dataclasses.replace(start, theta=st0.theta)
        fused2d.reset_launch_counts()
        st, d = sim.run_scan(st0, n)
        s0 = float(st0.theta.double().sum())
        s1 = float(st.theta.double().sum())
        moved = float((st.theta - st0.theta).abs().max())
        out[f"sum_theta_{what}"] = dict(
            before=s0, after=s1, rel_drift=abs(s1 - s0) / abs(s0),
            moved=moved, correct_diag_2d=fused2d.LAUNCHES["correct_diag_2d"])
        if not (abs(s1 - s0) <= 1e-5 * abs(s0) and moved > 1e-3
                and fused2d.LAUNCHES["correct_diag_2d"] == n):
            raise AssertionError(f"sum(theta) {what}: "
                                 f"{out[f'sum_theta_{what}']}")
    c = make_case("heated_cavity", shape=(16, 16, 16), ra=1e4, device=DEV)
    st, d = c.sim.run_scan(c.initial_state(), 150)
    th = st.theta
    out["cavity3d_16"] = dict(theta_min=float(th.min()),
                              theta_max=float(th.max()),
                              max_u2=float(st.u[2].abs().max()),
                              max_div=float(d.max_div[-1]))
    if not (-0.01 <= float(th.min()) and float(th.max()) <= 1.01
            and float(st.u[2].abs().max()) > 1e-2
            and float(d.max_div[-1]) < 1e-5):
        raise AssertionError(f"3D heated cavity: {out['cavity3d_16']}")
    line("phase4", convection_oracles=json.dumps(out))


def cli_thermal(tmp, reset_all) -> None:
    """Phase 5 of the convection slice: ``cli.main`` with ``--case
    heated_cavity --shape 2048,2048`` (Ra 1e8, Pr 0.71 from a config
    file): run A 100 steps with snapshots every 50 and a checkpoint, run B
    A resumed for 100 more, run C 200 unbroken; the snapshots carry theta
    (the checkpoint's at 100), kernels 4-5 once a step in their thermal
    mode, and B's final fields (theta included) equal C's bit for bit."""
    import os

    cfg = os.path.join(tmp, "convection.json")
    with open(cfg, "w") as f:
        json.dump({"ra": CONV_2D["ra"], "pr": CONV_2D["pr"]}, f)
    base = ["--config", cfg, "--case", "heated_cavity", "--shape",
            ",".join(map(str, CONV_2D["shape"])), "--chunk", "50"]
    d = {k: os.path.join(tmp, f"heated_{k}") for k in "abc"}
    reset_all()
    wall_a = run_cli(*base, "--steps", "100", "--out", d["a"],
                     "--checkpoint-every", "100", "--snapshot-every", "50")
    launches = dict(fused2d.LAUNCHES)
    if launches != {"predictor_rhs_2d": 100, "correct_diag_2d": 100}:
        raise AssertionError(f"thermal run A launched {launches}")
    ck = _ckpt_fields(os.path.join(d["a"], "ckpt.npz"))
    snap = _ckpt_fields(os.path.join(d["a"], "snap_00000100.npz"))
    import numpy as np

    if "theta" not in snap or not np.array_equal(snap["theta"], ck["theta"]):
        raise AssertionError("the snapshot's theta differs from the "
                             "checkpoint's")
    wall_b = run_cli(*base, "--steps", "100", "--out", d["b"],
                     "--resume", os.path.join(d["a"], "ckpt.npz"),
                     "--checkpoint-every", "100")
    wall_c = run_cli(*base, "--steps", "200", "--out", d["c"],
                     "--checkpoint-every", "200")
    b = _ckpt_fields(os.path.join(d["b"], "ckpt.npz"))
    c = _ckpt_fields(os.path.join(d["c"], "ckpt.npz"))
    for k in ("u0", "u1", "p", "theta"):
        if not np.array_equal(b[k], c[k]):
            raise AssertionError(f"resumed thermal run: {k} differs from the "
                                 "unbroken run's")
    line("phase5", case="heated_cavity", shape=_name(CONV_2D["shape"]),
         launches_run_a=json.dumps(launches),
         snapshot_theta_equals_checkpoint=True,
         resumed_equals_unbroken_bit_for_bit=True,
         theta_min_max=json.dumps([float(c["theta"].min()),
                                   float(c["theta"].max())]),
         wall_s_a_b_c=json.dumps([round(wall_a, 2), round(wall_b, 2),
                                  round(wall_c, 2)]))


# -- the forcing slice: body forces and the time-dependent drive -------------


def random_volumes(grid, per, gen, comps, scale=1.0):
    """Random forcing volumes (fused3d.force_shape) for the components in
    ``comps``, None for the others."""
    return tuple(
        scale * torch.randn(fused3d.force_shape(grid, per, a), generator=gen,
                            device=DEV) if a in comps else None
        for a in range(grid.ndim))


def check_wrap_faces(what, u, per) -> None:
    """Face n of a periodic axis bit-equal to face 0 in each component."""
    for a, c in enumerate(u):
        if per[a] and not torch.equal(c.select(a, 0), c.select(a, -1)):
            raise AssertionError(f"{what}[{a}]: face n differs from face 0 "
                                 "on a periodic axis")


def compare_forced_3d(grid, bcs, gamma, gen, errs, force=None, vols=None,
                      based=False) -> float:
    """Kernel 1 in its forced mode (``force``: the static force of the bc
    buffer; ``vols``: forcing volumes; ``based``: rk2's base form) against
    its plain version on random O(1) fields: compare_kernels'
    tolerances, face n of a periodic axis equal to face 0. Returns the
    largest error."""
    dt, nu, rho = 1e-3, 0.02, 1.3
    u = random_state(grid, bcs, gen)
    base = random_state(grid, bcs, gen) if based else None
    per = periodic_axes(grid, bcs)
    k_u, k_rhs = fused3d.predictor_rhs_3d(grid, bcs, u, dt, nu, gamma, rho,
                                          base=base, force=force,
                                          force_vol=vols)
    p_u, p_rhs = fused3d.predictor_rhs_plain(
        grid, bcs, u, dt, nu, gamma, rho,
        forcing=fused3d.plain_forcing(force, vols, 3), base=base)
    e = max(close(f"forced u*[{a}]", k_u[a], p_u[a], 1e-5, 1e-5)
            for a in range(3))
    e = max(e, close("forced rhs", k_rhs, p_rhs, 1e-4,
                     3e-7 * float(p_rhs.abs().max())))
    check_wrap_faces("forced u*", k_u, per)
    errs["predictor_rhs_3d"] = max(errs["predictor_rhs_3d"], e)
    return e


def compare_forced_unfused(grid, bcs, dt, nu, gamma, gen, errs, vols,
                           what, key="predictor_2d") -> float:
    """Kernel 8 with forcing volumes (or none) against its plain version on
    a random O(1) state that keeps face n of a periodic axis equal to face
    0: compare_predictor_2d's tolerance (2e-5, or 8 ulps of max|u*|), face
    n bit-equal to face 0 (its wrap modes); the error into errs[key]."""
    u = apply_velocity_bcs(grid, bcs, [
        torch.randn(grid.face_shape(a), generator=gen, device=DEV)
        for a in range(2)])
    k_u = predictor2d.predictor_2d(grid, bcs, u, dt, nu, gamma, forcing=vols)
    p_u = predictor2d.predictor_2d_plain(grid, bcs, u, dt, nu, gamma, vols)
    top = max(float(c.abs().max()) for c in p_u)
    atol = max(2e-5, 8 * 2.0 ** (math.floor(math.log2(top)) - 23))
    e = max(close(f"predictor_2d forced {what} u*[{a}]", k_u[a], p_u[a],
                  0.0, atol) for a in range(2))
    check_wrap_faces(f"predictor_2d {what}", k_u, periodic_axes(grid, bcs))
    errs[key] = max(errs.get(key, 0.0), e)
    return e


def check_forcing_modes(gen, errs) -> None:
    """Phase 2 of the forcing slice. Kernel 1: the static force FORCE3, the
    forcing volumes of all three components (Euler and rk2's base form)
    and a volume on one component with a number on another, on the ragged
    walls (37, 19, 45) with a lid, the ragged mixed periodic (38, 22, 46)
    (axes 0 and 2 periodic: the duct's PER 1 and more) and the 256^3
    periodic box (PER 7, Kolmogorov's), at gamma 0 and 0.8. Kernel 4: the
    forcing volumes of both components on a periodic box (PER 3), periodic
    rows and periodic lanes of FORCING_P2, Euler and base. Kernel 8: the
    volumes of both components, of v alone (buoyancy along y) on the
    enclosure's 2048^2 table and on the ragged (200, 136) with the
    cylinder's table. Each against its plain version; face n of a wrap
    axis bit-equal to face 0."""
    out = {}
    for shape, per in ((RAGGED_WALL, (False,) * 3),
                       (RAGGED_PER, (True, False, True)),
                       (SHAPE, (True,) * 3)):
        grid = GridSpec(shape, (1.0, 0.6, 1.8))
        bcs = no_slip_box(grid)
        bcs[(2, 1)] = BCSpec.wall((1.0, 0.3, 0.0))
        for a in range(3):
            if per[a]:
                bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
        e = {}
        for gamma in (0.0, 0.8):
            e[f"force g{gamma}"] = compare_forced_3d(grid, bcs, gamma, gen,
                                                     errs, force=FORCE3)
            vols = random_volumes(grid, per, gen, (0, 1, 2))
            e[f"vols g{gamma}"] = compare_forced_3d(grid, bcs, gamma, gen,
                                                    errs, vols=vols)
            e[f"vols base g{gamma}"] = compare_forced_3d(
                grid, bcs, gamma, gen, errs, vols=vols, based=True)
        mixed = random_volumes(grid, per, gen, (0,))
        e["vol0 force1"] = compare_forced_3d(grid, bcs, 0.3, gen, errs,
                                             force=(None, 0.5, None),
                                             vols=mixed, based=True)
        torch.cuda.synchronize()
        line("phase2", forced_3d=_name(shape), periodic=json.dumps(per),
             max_abs_err=json.dumps(e))
    for shape in FORCING_P2:
        grid = GridSpec(shape, (1e-3 * shape[0], 1e-3 * shape[1]))
        dt, nu = 1e-5, 0.01
        e = {}
        for topo, per in PER_TOPOLOGIES.items():
            bcs = periodic_2d_bcs(grid, per)
            vols = random_volumes(grid, per, gen, (0, 1), scale=100.0)
            for based in (False, True):
                e[f"{topo} {'base' if based else 'euler'}"] = \
                    compare_periodic_2d(grid, bcs, dt, nu, 0.3, gen, errs,
                                        based=based, force_vol=vols)
        torch.cuda.synchronize()
        line("phase2", forced_2d=_name(shape), dt=dt, nu=nu,
             max_abs_err_pred_corr=json.dumps(e))
    encl = make_case("heated_enclosure", device=DEV,
                     **FORCING_PATHS["heated_enclosure"][1]).sim
    rag = GridSpec(RAGGED2, (6.25, 4.25))
    e = {}
    for grid, bcs, dt, nu, what in (
            (encl.grid, encl.bcs, encl.params.dt, encl.params.nu,
             "enclosure"),
            (rag, cylinder_bcs(), 0.01, 0.005, "cylinder")):
        per = (False, False)
        for comps in ((0, 1), (1,)):
            vols = random_volumes(grid, per, gen, comps)
            for gamma in (0.0, 0.2):
                e[f"{what} {comps} g{gamma}"] = compare_forced_unfused(
                    grid, bcs, dt, nu, gamma, gen, errs, vols,
                    f"{what} {comps}")
    torch.cuda.synchronize()
    line("phase2", forced_predictor_2d=json.dumps(e))


def forcing_cases() -> tuple:
    """The forcing slice's paths at full width and their twins: the same
    simulation without its force (``forcing=None``), or with the lid held
    at its t = 0 value; the enclosure has none (:func:`forcing_runs`)."""
    cases = {k: make_case(name, device=DEV, **kw)
             for k, (name, kw) in FORCING_PATHS.items()}
    twins = {}
    for k, c in cases.items():
        s_ = c.sim
        if k.startswith("oscillating_lid"):
            nd = s_.grid.ndim
            bcs = {f: (BCSpec.wall(tuple(1.0 if i == 0 else 0.0
                                         for i in range(nd)))
                       if f == (nd - 1, 1) else spec)
                   for f, spec in s_.bcs.items()}
            table = fused2d.bc_table if nd == 2 else fused3d.bc_table
            sim = dataclasses.replace(s_, bcs=bcs,
                                      bc=table(s_.grid, bcs, DEV))
        elif k == "heated_enclosure":
            continue
        else:
            sim = dataclasses.replace(s_, forcing=None, force_vol=None)
        twins[k] = dataclasses.replace(c, name=f"{k} twin", sim=sim)
    return cases, twins


def forcing_steps_vs_plain(cases) -> None:
    """Phase 3 of the forcing slice: 5 Euler and 5 rk2 steps of each path
    against step_plain, and the time-dependent paths (pulsatile channel,
    oscillating lids) also at cfl 0.4 with a cap of 1.5x the case's dt; u
    and p with the 2D and 3D whole-step tolerances (p atol 2e-4 of max|p|,
    as the periodic cases; the CFL runs u rtol 5e-5 / atol 5e-6 and p rtol
    5e-4, as every route's CFL run above), the enclosure's u as the heated
    cylinder's, its p within 1e-2 of max|p| (mg
    stops at 2048^2 on its stagnation rule at the float32 floor, relative
    residuals of 5e-3 to 6.5e-2; u atol 5e-5, V-cycle counts within one
    or two a step), theta within 1e-5 of
    max|theta|; the final t of both runs equal."""
    for k, c in cases.items():
        modes = [("euler", dict(integrator="euler")),
                 ("rk2", dict(integrator="rk2"))]
        if c.sim.time_dependent:
            # a cap of 1.5x: the cases' dt are half their explicit
            # diffusive limit, so integrator_modes' 10x would run the 2D
            # lid unstable
            modes.append(("cfl", dict(cfl=0.4, dt=1.5 * c.sim.params.dt)))
        for mode, params in modes:
            cm = with_params(c, **params)
            u_tol, p_rel, slack, theta_rel = (2e-5, 2e-6), 2e-4, 0, None
            p_rtol = 2e-4
            if mode == "cfl":
                u_tol, p_rtol = (5e-5, 5e-6), 5e-4
            if k == "heated_enclosure":
                # mg at 2048^2 stops on its stagnation rule at the float32
                # floor, relative residuals of 5e-3 to 6.5e-2 (as the
                # channel's at 2048x512): p is determined to ~1e-2 of max|p|
                u_tol, p_rel, theta_rel = (2e-5, 5e-5), 1e-2, 1e-5
                slack = 2 if mode == "rk2" else 1
            steps_vs_plain(cm, f"{k} {mode}", u_tol, (p_rtol, None),
                           count_slack=slack, p_rel=p_rel,
                           theta_rel=theta_rel)


def forcing_runs(cases, twins, reset_all) -> None:
    """Phase 4 of the forcing slice: each path timed (FORCING_STEPS steps)
    beside its twin in turns path, twin, twin, path; launches a step and
    busy ms a step over 5 profiled steps after them, the device's idle
    share. The enclosure runs alone, ENCLOSURE_STEPS steps from 5 buoyant
    steps, its counters kernel 8's and the multigrid's level kernels (9
    and 10, on the levels of >= 128 cells a side): its mg steps are
    host-bound and their times spread more (294-411 ms a step) than its
    force could cost. Then the new modes' device times beside their plain
    versions and bounds; the synchronizing calls a step of each
    time-dependent path at cfl 0.5 against its twin's (no more); the JAX
    package's oracles on the kernel route (:func:`forcing_oracles`)."""
    def counts_for(k):
        if k == "heated_enclosure":
            return lambda: {**predictor2d.LAUNCHES, **{
                n: multigrid_kernels.LAUNCHES[n]
                for n in ("mg_pre_sweeps_residual", "mg_add_post_sweeps")}}
        if cases[k].sim.grid.ndim == 3:
            return lambda: dict(fused3d.LAUNCHES)
        return lambda: dict(fused2d.LAUNCHES)

    runs = {}
    c = cases["heated_enclosure"]
    start = c.sim.run_scan(c.initial_state(), 5)[0]
    r = timed_run(c, reset_all, counts_for("heated_enclosure"),
                  steps=ENCLOSURE_STEPS, state=start, warmup=1)
    runs["heated_enclosure"] = {"path": r}
    line("phase4", forcing="heated_enclosure", shape=_name(c.sim.grid.shape),
         integrator=c.sim.params.integrator,
         poisson=c.sim.params.poisson.method, fused=c.sim.fused,
         ms_per_step_path=round(r["ms"], 4),
         kernel_launches_path=json.dumps(r["launches"]))
    for k, c in cases.items():
        if k == "heated_enclosure":
            continue
        t0 = time.perf_counter()
        pair = {"path": [], "twin": []}
        for what in ("path", "twin", "twin", "path"):
            cc = c if what == "path" else twins[k]
            pair[what].append(timed_run(cc, reset_all, counts_for(k),
                                        steps=FORCING_STEPS))
        t, w = pair["path"][-1], pair["twin"][-1]
        for r, cc, key in ((t, c, "path"), (w, twins[k], "twin")):
            per_step, busy = profile_launches(cc.sim, r["state"], steps=5)
            ms = min(x["ms"] for x in pair[key])
            r.update(launches_per_step=per_step, busy_ms=busy,
                     idle_share=max(0.0, 1.0 - busy / ms))
        runs[k] = {"path": t, "twin": w}
        st = t["state"]
        line("phase4", forcing=k, shape=_name(c.sim.grid.shape),
             integrator=c.sim.params.integrator,
             poisson=c.sim.params.poisson.method, fused=c.sim.fused,
             time_dependent=c.sim.time_dependent,
             t_end=None if st.t is None else float(st.t),
             ms_per_step_path_twin_twin_path=json.dumps(
                 [round(pair[a][i]["ms"], 4)
                  for a, i in (("path", 0), ("twin", 0), ("twin", 1),
                               ("path", 1))]),
             busy_ms_per_step_path_twin=json.dumps(
                 [round(t["busy_ms"], 4), round(w["busy_ms"], 4)]),
             idle_share_path_twin=json.dumps(
                 [round(t["idle_share"], 4), round(w["idle_share"], 4)]),
             launches_per_step_path_twin=json.dumps(
                 [t["launches_per_step"], w["launches_per_step"]]),
             kernel_launches_path=json.dumps(t["launches"]),
             seconds=round(time.perf_counter() - t0, 1))
    # the new modes at full width, on the timed runs' states, each beside
    # its plain version and its unforced form on the same inputs
    times, bounds, calls = {}, {}, {}
    for k, kp in (("duct_periodic", "predictor_rhs_3d"),
                  ("kolmogorov3d", "predictor_rhs_3d"),
                  ("kolmogorov2d", "predictor_rhs_2d"),
                  ("pulsatile_channel", "predictor_rhs_2d")):
        s_ = cases[k].sim
        st = runs[k]["path"]["state"]
        g_, b_, pr_ = s_.grid, s_.bcs, s_.params
        dts = s_._dts(None)
        forcing = s_._drive(st.t, plain=True)[1]
        kw = dict(bc=s_.bc, dts=dts, force=s_._force_numbers(forcing),
                  force_vol=s_.force_vol)
        pred = (fused2d.predictor_rhs_2d if g_.ndim == 2
                else fused3d.predictor_rhs_3d)
        us, rhs = pred(g_, b_, st.u, dts[0], pr_.nu, pr_.upwind_gamma,
                       pr_.rho, **kw)
        vols = [v for v in (s_.force_vol or ()) if v is not None]
        for based in ((False, True) if k.startswith("kolmogorov")
                      else (False,)):
            base = tuple(c.clone() for c in st.u) if based else None
            name = f"{kp} {'force' if not vols else 'force_vol'}" \
                   f"{' base' if based else ''} {k}"
            plain_f = fused3d.plain_forcing(kw["force"], s_.force_vol,
                                            g_.ndim)
            calls[name] = (
                lambda pred=pred, g_=g_, b_=b_, st=st, pr_=pr_, dts=dts,
                kw=kw, base=base: pred(g_, b_, st.u, dts[0], pr_.nu,
                                       pr_.upwind_gamma, pr_.rho, base=base,
                                       **kw),
                lambda g_=g_, b_=b_, st=st, pr_=pr_, dts=dts, f=plain_f,
                base=base: fused3d.predictor_rhs_plain(
                    g_, b_, st.u, float(dts[0]), pr_.nu, pr_.upwind_gamma,
                    pr_.rho, f, base=base),
                nbytes(*st.u, *(base or ()), *us, rhs, s_.bc, *vols),
                (OPS_PER_CELL[kp] + FORCE_OPS[kp]) * math.prod(g_.shape))
            calls[f"{kp} unforced{' base' if based else ''} {k}"] = (
                lambda pred=pred, g_=g_, b_=b_, st=st, pr_=pr_, dts=dts,
                s_=s_, base=base: pred(g_, b_, st.u, dts[0], pr_.nu,
                                       pr_.upwind_gamma, pr_.rho, bc=s_.bc,
                                       dts=dts, base=base),
                lambda g_=g_, b_=b_, st=st, pr_=pr_, dts=dts, base=base:
                fused3d.predictor_rhs_plain(
                    g_, b_, st.u, float(dts[0]), pr_.nu, pr_.upwind_gamma,
                    pr_.rho, base=base),
                nbytes(*st.u, *(base or ()), *us, rhs, s_.bc),
                OPS_PER_CELL[kp] * math.prod(g_.shape))
    s_ = cases["heated_enclosure"].sim
    st = runs["heated_enclosure"]["path"]["state"]
    g_, pr_ = s_.grid, s_.params
    dts = s_._dts(None)
    vols = s_._unfused_forcing(None, st.theta, plain=False)
    us = predictor2d.predictor_2d(g_, s_.bcs, st.u, dts[0], pr_.nu,
                                  pr_.upwind_gamma, ghosts=s_.ghosts,
                                  forcing=vols)
    vv = [v for v in vols if v is not None]
    for name, f in (("predictor_2d force_vol heated_enclosure", vols),
                    ("predictor_2d unforced heated_enclosure", None)):
        calls[name] = (
            lambda f=f: predictor2d.predictor_2d(
                g_, s_.bcs, st.u, dts[0], pr_.nu, pr_.upwind_gamma,
                ghosts=s_.ghosts, forcing=f),
            lambda f=f: predictor2d.predictor_2d_plain(
                g_, s_.bcs, st.u, float(dts[0]), pr_.nu, pr_.upwind_gamma,
                f),
            nbytes(*st.u, *us, s_.ghosts, *(vv if f is not None else ())),
            (OPS_PER_CELL["predictor_2d"]
             + (FORCE_OPS["predictor_2d"] if f is not None else 0))
            * math.prod(g_.shape))
    t0 = time.perf_counter()
    time_pairs(calls, times, bounds)
    line("phase4", forcing_mode_times_seconds=round(time.perf_counter() - t0,
                                                    1))
    # kernel 8 by graph replay over rotated inputs, forced and not
    s_ = cases["heated_enclosure"].sim
    st = runs["heated_enclosure"]["path"]["state"]
    dts = s_._dts(None)
    for name, f in (("predictor_2d force_vol heated_enclosure", vols),
                    ("predictor_2d unforced heated_enclosure", None)):
        device_times(name, [
            lambda u=u, f=f: predictor2d.predictor_2d(
                s_.grid, s_.bcs, u, dts[0], s_.params.nu,
                s_.params.upwind_gamma, ghosts=s_.ghosts, forcing=f)
            for u in rotated(tuple(st.u), nbytes(*st.u, *st.u, *vv))],
            min(times[name][0], times[name][3]))
    # kernel 4 by graph replay over rotated inputs too
    for k in ("kolmogorov2d", "pulsatile_channel"):
        s_ = cases[k].sim
        st = runs[k]["path"]["state"]
        g_, b_, pr_ = s_.grid, s_.bcs, s_.params
        dts = s_._dts(None)
        forcing = s_._drive(st.t, plain=True)[1]
        kw = dict(bc=s_.bc, dts=dts, force=s_._force_numbers(forcing),
                  force_vol=s_.force_vol)
        name = [n for n in times if n.startswith("predictor_rhs_2d force")
                and n.endswith(k) and "base" not in n][0]
        device_times(name, [
            lambda u=u, g_=g_, b_=b_, pr_=pr_, dts=dts, kw=kw:
            fused2d.predictor_rhs_2d(g_, b_, u, dts[0], pr_.nu,
                                     pr_.upwind_gamma, pr_.rho, **kw)
            for u in rotated(tuple(st.u), nbytes(*st.u, *st.u, st.p))],
            min(times[name][0], times[name][3]))
    # the synchronizing calls a step at cfl 0.5, each time-dependent path
    # against its twin (the twin of the pulsatile channel: no force)
    syncs = {}
    for k in ("pulsatile_channel", "oscillating_lid3d", "oscillating_lid2d"):
        c, w = cases[k], twins[k]
        dt2 = 2 * c.sim.params.dt
        syncs[k] = (
            syncs_per_step(with_params(c, cfl=0.5, dt=dt2).sim,
                           c.initial_state()),
            syncs_per_step(with_params(w, cfl=0.5, dt=dt2).sim,
                           w.initial_state()))
        if syncs[k][0] > syncs[k][1]:
            raise AssertionError(f"{k} at cfl 0.5: {syncs[k][0]} "
                                 "synchronizing calls a step, its twin "
                                 f"{syncs[k][1]}")
    line("phase4", sync_calls_per_step_timedep_twin_cfl05=json.dumps(syncs))
    forcing_oracles()


def forcing_oracles() -> None:
    """The JAX package's oracles of the forcing slice at its tests' sizes,
    on the kernel route: the Womersley channel against the exact
    semi-discrete response (8x32, Wo 4, rk2, t = 0.8: rel err < 2e-3;
    tests/test_timedep.py), the oscillating lid against a static
    simulation rebuilt every step with the lid at the step's t (16^2, cg
    tol 1e-7, 25 steps: atol 2e-6), the 3D oscillating lid (16^3, cg)
    against step_plain (Euler, then rk2 at cfl 0.4), the duct's series
    profile after 400 steps (32x16x16: rel < 1%; tests/test_channel.py),
    the Kolmogorov laminar balance (32^2, Re 1, k_f 2: 2e-3 of the
    discrete amplitude, 2% of the continuum's) and 3D Kolmogorov against
    step_plain (16^3, Re 5, Euler, 5 steps: atol 5e-5;
    tests/test_fused_step.py), and the heated enclosure's energy balance
    (48^2, Ra 1e6, dt 4e-3; tests/test_scalar.py) in its conservative
    form: from a conduction-like theta, for 20 steps, the heat the fluid
    stores equals the body's flux minus the walls' within 16 sqrt(cells)
    ulps of 1 times h^2/dt, every step (JAX's run to the balance itself,
    ~1050 s here at the plain mg levels of 48^2, is held on the CPU by
    tests/test_torch_forcing.py). Besides JAX's oracles: a through-flow
    whose walls x = 0 and x = 1 carry the normal value g(t) = 1 + 10 t
    (16^2 and 16^3, Euler, cfl 0.4 under a cap of 0.05, cg tol 1e-4), 6
    kernel steps against step_plain: the stored faces are rewritten at
    each step's t and the first dt are 0.4 h / g(t_k), the CFL reduction
    of the rewritten field."""
    import numpy as np

    out = {}
    # Womersley
    c = make_case("pulsatile_channel", shape=(8, 32), womersley=4.0,
                  integrator="rk2", device=DEV)
    sim, ny = c.sim, 32
    n = int(0.8 / sim.params.dt)
    st, _ = sim.run_scan(c.initial_state(), n)
    t_end = float(st.t)
    h = sim.grid.spacing[1]
    lap = np.zeros((ny, ny))
    for j in range(ny):
        lap[j, j] = -2.0
        if j > 0:
            lap[j, j - 1] = 1.0
        if j < ny - 1:
            lap[j, j + 1] = 1.0
    lap[0, 0] -= 1.0
    lap[-1, -1] -= 1.0
    lap /= h * h
    lam, vec = np.linalg.eigh(lap)
    d = -sim.params.nu * lam
    om = 2.0 * np.pi
    coef = (vec.T @ np.ones(ny)) * ((d * np.cos(om * t_end)
                                     + om * np.sin(om * t_end)
                                     - d * np.exp(-d * t_end))
                                    / (d * d + om * om))
    u_exact = vec @ coef
    u = st.u[0][:sim.grid.shape[0]].cpu().numpy()
    err = float(np.abs(u[0] - u_exact).max() / np.abs(u_exact).max())
    out["womersley"] = dict(rel_err=err, t_end=t_end, steps=n,
                            x_spread=float(np.abs(u - u[:1]).max()))
    if not (err < 2e-3 and abs(t_end - n * sim.params.dt)
            <= 1e-5 * n * sim.params.dt and out["womersley"]["x_spread"]
            < 1e-6):
        raise AssertionError(f"Womersley: {out['womersley']}")
    # the oscillating lid against per-step static rebuilds
    g16 = GridSpec((16, 16), (1.0, 1.0))
    params = SimParams(dt=2e-3, nu=0.05, poisson=poisson.PoissonConfig(
        method="cg", tol=1e-7, max_iters=400))
    bcs_td = no_slip_box(g16)
    bcs_td[(1, 1)] = BCSpec.wall((lambda t: 0.5 + 0.5 * torch.sin(3.0 * t),
                                  0.0))
    sim_td = Simulation.build(g16, bcs_td, params, DEV)
    out_td, _ = sim_td.run_scan(sim_td.initial_state(), 25)
    st = None
    for k in range(25):
        bk = no_slip_box(g16)
        lid = float(0.5 + 0.5 * torch.sin(
            torch.tensor(3.0 * np.float32(k * params.dt))))
        bk[(1, 1)] = BCSpec.wall((lid, 0.0))
        sk = Simulation.build(g16, bk, params, DEV)
        st = sk.initial_state() if st is None else st
        st, _ = sk.step(st)
    e = max(float((a - b).abs().max()) for a, b in zip(out_td.u, st.u))
    out["lid_vs_rebuild"] = dict(max_abs_diff=e, t=float(out_td.t))
    if not e <= 2e-6:
        raise AssertionError(f"oscillating lid vs rebuild: {e}")
    # the 3D oscillating lid (the wall entry refilled) against step_plain
    g3 = GridSpec((16, 16, 16), (1.0, 1.0, 1.0))
    b3 = no_slip_box(g3)
    b3[(0, 1)] = BCSpec.wall((0.0, lambda t: torch.cos(2.0 * math.pi * t),
                              0.0))
    p3 = dataclasses.replace(params, dt=2e-3, nu=0.01,
                             poisson=dataclasses.replace(
                                 params.poisson, tol=1e-6, max_iters=500))
    lid3 = []
    for extra in (dict(), dict(integrator="rk2", cfl=0.4)):
        s3 = Simulation.build(g3, b3, dataclasses.replace(p3, **extra), DEV)
        st_k = st_p = s3.initial_state()
        for _ in range(10):
            st_k, _ = s3.step(st_k)
            st_p, _ = s3.step_plain(st_p)
        e = max(float((a - b).abs().max()) for a, b in zip(st_k.u, st_p.u))
        lid3.append(e)
        if not (e < 2e-5 and float(st_k.t) == float(st_p.t)):
            raise AssertionError(f"3D oscillating lid {extra}: {e}")
    out["lid3d_kernel_vs_plain_euler_rk2cfl"] = lid3
    # the duct's series profile
    from navierstokessolver_tpu_torch.cases.channel import duct_profile_exact
    from navierstokessolver_tpu_torch.grid import State

    c = make_case("duct_periodic", shape=(32, 16, 16), device=DEV)
    sim, g = c.sim, c.sim.grid
    fx = float(sim.forcing[0])
    exact = duct_profile_exact(16, 16, g.lengths[1], g.lengths[2],
                               fx / sim.params.nu)
    st0 = sim.initial_state()
    u0 = torch.as_tensor(exact, dtype=torch.float32,
                         device=DEV)[None].expand(g.face_shape(0))
    u = apply_velocity_bcs(g, sim.bcs, (u0.contiguous(), st0.u[1], st0.u[2]))
    st, d = sim.run_scan(State(u=u, p=st0.p), 400)
    uc = st.u[0][:-1].mean(dim=0).cpu().numpy()
    rel = float(np.abs(uc - exact).max() / exact.max())
    trans = max(float(st.u[1].abs().max()), float(st.u[2].abs().max()))
    out["duct"] = dict(rel=rel, transverse=trans,
                       max_div=float(d.max_div[-1]))
    if not (rel < 0.01 and trans < 1e-5 and float(d.max_div[-1]) < 1e-4):
        raise AssertionError(f"duct profile: {out['duct']}")
    # Kolmogorov: the laminar balance in 2D, 3D against step_plain
    c = make_case("kolmogorov", shape=(32, 32), re=1.0, k_forcing=2,
                  device=DEV)
    sim = c.sim
    nu = sim.params.nu
    n = int(8.0 / (nu * 4) / sim.params.dt)
    st, d = sim.run_scan(c.initial_state(), n)
    yc = sim.grid.cell_centers(1).astype(np.float64)
    h = sim.grid.spacing[1]
    u_disc = 1.0 / (nu * (2.0 - 2.0 * np.cos(2 * h)) / (h * h))
    u = st.u[0][:32].cpu().numpy()
    err = float(np.abs(u - u_disc * np.sin(2 * yc)[None]).max() / u_disc)
    u_lam = 1.0 / (nu * 4)
    err_c = float(np.abs(u - u_lam * np.sin(2 * yc)[None]).max() / u_lam)
    out["kolmogorov_2d"] = dict(err_discrete=err, err_continuum=err_c,
                                steps=n)
    if not (err < 2e-3 and err_c < 0.02):
        raise AssertionError(f"Kolmogorov 2D: {out['kolmogorov_2d']}")
    c = make_case("kolmogorov", shape=(16, 16, 16), re=5.0, k_forcing=2,
                  integrator="euler", device=DEV)
    st_k = st_p = c.initial_state()
    for _ in range(5):
        st_k, _ = c.sim.step(st_k)
        st_p, _ = c.sim.step_plain(st_p)
    e = max(float((a - b).abs().max()) for a, b in zip(st_k.u, st_p.u))
    out["kolmogorov_3d_kernel_vs_plain"] = e
    if not e < 5e-5:
        raise AssertionError(f"Kolmogorov 3D: {e}")
    # the heated enclosure's energy balance
    from navierstokessolver_tpu_torch.cases.convection import wall_heat_flux
    from navierstokessolver_tpu_torch.scalar import body_heat_flux

    t0 = time.perf_counter()
    c = make_case("heated_enclosure", shape=(48, 48), ra=1e6, dt=4e-3,
                  device=DEV)
    sim = c.sim
    g = sim.grid
    fluid = ~sim.scalar_solid
    vol = float(np.prod(g.spacing))
    xc = torch.as_tensor(g.cell_centers(0), device=DEV)[:, None]
    yc = torch.as_tensor(g.cell_centers(1), device=DEV)[None, :]
    ramp = torch.clamp((0.5 - torch.sqrt((xc - 0.5) ** 2 + (yc - 0.5) ** 2))
                       / 0.3, 0.0, 1.0)
    st = c.initial_state()
    st = dataclasses.replace(st, theta=torch.where(sim.scalar_solid,
                                                   st.theta, ramp))
    worst = 0.0
    for _ in range(20):
        th0 = st.theta
        q_body = float(body_heat_flux(g, sim.scalar, th0, sim.scalar_solid))
        q_wall = wall_heat_flux(sim, th0)
        st, d = sim.step(st)
        stored = float(((st.theta - th0).double() * fluid).sum()) * vol \
            / float(d.dt)
        bound = 16 * math.sqrt(float(fluid.sum())) * 2.0 ** -23 * vol \
            / float(d.dt)
        worst = max(worst, abs(stored - (q_body - q_wall)) / bound)
        if not (q_wall > 0.1 * q_body > 0.0
                and abs(stored - (q_body - q_wall)) <= bound):
            raise AssertionError(f"enclosure budget: stored {stored}, body "
                                 f"{q_body}, walls {q_wall}, bound {bound}")
    out["enclosure_budget"] = dict(steps=20, worst_over_bound=worst,
                                   q_body=q_body, q_wall=q_wall,
                                   seconds=round(time.perf_counter() - t0,
                                                 1))
    # a callable normal wall value: the refreshed faces and the CFL dt
    through = []
    for nd in (2, 3):
        gt = GridSpec((16,) * nd, (1.0,) * nd)
        bt = no_slip_box(gt)
        for side in (0, 1):
            bt[(0, side)] = BCSpec.wall(
                (lambda t: 1.0 + 10.0 * t,) + (0.0,) * (nd - 1))
        st_sim = Simulation.build(gt, bt, SimParams(
            dt=0.05, nu=0.01, cfl=0.4, poisson=poisson.PoissonConfig(
                method="cg", tol=1e-4, max_iters=500)), DEV)
        st_k = st_p = st_sim.initial_state()
        dts = []
        for _ in range(6):
            st_k, d_k = st_sim.step(st_k)
            st_p, d_p = st_sim.step_plain(st_p)
            dts.append((float(d_k.dt), float(d_p.dt)))
        e = max(float((a - b).abs().max()) for a, b in zip(st_k.u, st_p.u))
        t_k, faces = 0.0, []
        for dk_, _ in dts[:4]:
            faces.append(abs(dk_ * (1.0 + 10.0 * t_k) / 0.025 - 1.0))
            t_k += dk_
        through.append(dict(nd=nd, u_max_abs_diff=e, dt=[x for x, _ in dts],
                            dt_rel_from_faces=max(faces)))
        if not (e < 5e-5 and max(faces) < 1e-5
                and all(abs(a - b) <= 3e-5 * b for a, b in dts)
                and all(a < 0.05 for a, _ in dts)):
            raise AssertionError(f"normal wall value of t: {through[-1]}")
    out["through_flow_kernel_vs_plain"] = through
    line("phase4", forcing_oracles=json.dumps(out))


def cli_oscillating_lid(tmp, reset_all) -> None:
    """The 3D entry point, ``cli.main`` with ``--case oscillating_lid
    --shape 256,256,256``: run A 20 steps with a snapshot and a
    checkpoint, run B A resumed for 20 more, run C 40 unbroken; kernels
    1-2 once a step, the checkpoint carries t, and B's final fields and t
    equal C's bit for bit; the snapshot's derived fields against their
    plain versions of the checkpoint on the CPU (4 ulps of the field's
    max)."""
    import os

    import numpy as np

    from navierstokessolver_tpu_torch.ops.stencils import (
        q_criterion_3d, vorticity_magnitude_3d,
    )

    base = ["--case", "oscillating_lid", "--shape", "256,256,256",
            "--chunk", "20"]
    d = {k: os.path.join(tmp, f"lid_{k}") for k in "abc"}
    reset_all()
    wall_a = run_cli(*base, "--steps", "20", "--out", d["a"],
                     "--snapshot-every", "20", "--checkpoint-every", "20")
    launches = {k: fused3d.LAUNCHES[k] for k in ("predictor_rhs_3d",
                                                 "correct_diag_3d")}
    if launches != {"predictor_rhs_3d": 20, "correct_diag_3d": 20}:
        raise AssertionError(f"oscillating lid run A launched {launches}")
    run_cli(*base, "--steps", "20", "--out", d["b"], "--resume",
            os.path.join(d["a"], "ckpt.npz"), "--checkpoint-every", "20")
    run_cli(*base, "--steps", "40", "--out", d["c"], "--checkpoint-every",
            "40")
    a = _ckpt_fields(os.path.join(d["a"], "ckpt.npz"))
    b = _ckpt_fields(os.path.join(d["b"], "ckpt.npz"))
    c = _ckpt_fields(os.path.join(d["c"], "ckpt.npz"))
    if "t" not in a or "t" not in c:
        raise AssertionError("the oscillating lid's checkpoint has no t")
    for k in ("u0", "u1", "u2", "p", "t"):
        if not np.array_equal(b[k], c[k]):
            raise AssertionError(f"resumed oscillating lid: {k} differs from "
                                 "the unbroken run's")
    snap = _ckpt_fields(os.path.join(d["a"], "snap_00000020.npz"))
    grid = GridSpec(SHAPE, (1.0, 1.0, 1.0))
    u = tuple(torch.from_numpy(a[f"u{i}"]) for i in range(3))
    errs3 = {}
    for k, fn in (("vorticity_mag", vorticity_magnitude_3d),
                  ("q_criterion", q_criterion_3d)):
        ref = fn(grid, u).numpy()
        if snap[k].shape != ref.shape:
            raise AssertionError(f"{k} shape {snap[k].shape}")
        errs3[k] = float(np.abs(snap[k] - ref).max())
        if not errs3[k] <= 4 * np.finfo(np.float32).eps * np.abs(ref).max():
            raise AssertionError(f"snapshot {k} off by {errs3[k]}")
    line("phase5", case="oscillating_lid", shape=_name(SHAPE),
         launches_run_a=json.dumps(launches), t_a=float(a["t"]),
         t_c=float(c["t"]), resumed_equals_unbroken_bit_for_bit=True,
         wall_s_a_with_snapshot=round(wall_a, 2),
         snapshot_err=json.dumps(errs3))


# -- the sphere's slice: 3D open faces, obstacle masks, the 3D dctcg ----------


def open_faces_bcs():
    """A 3D table of every open kind (phase 2, no obstacle): an inflow with
    tangential components on (0, 0), outflows on (0, 1) and (1, 1), a slip
    wall on (1, 0), a resting and a moving wall on axis 2."""
    return {(0, 0): BCSpec.inflow((1.0, 0.1, -0.2)), (0, 1): BCSpec.outflow(),
            (1, 0): BCSpec.slip(), (1, 1): BCSpec.outflow(),
            (2, 0): BCSpec.wall((0.0, 0.0, 0.0)),
            (2, 1): BCSpec.wall((0.4, -0.3, 0.0))}


def blocks_solid(shape):
    """Solid blocks that touch the outflow face, a slip face and the high
    face of axis 2, an interior block and an isolated cell: every face
    kind beside a solid cell (the masks' boundary rules, the OUTFLOW copy
    of a blocked face)."""
    solid = torch.zeros(shape, dtype=torch.bool)
    n0, n1, n2 = shape
    solid[n0 - 3:, 2:6, 3:9] = True
    solid[n0 // 3:n0 // 3 + 4, :3, n2 // 2:n2 // 2 + 6] = True
    solid[n0 // 2:n0 // 2 + 5, n1 // 2:n1 // 2 + 4, n2 - 4:] = True
    solid[5:9, 6:10, 10:16] = True
    solid[12, n1 - 1, 1] = True
    return solid.numpy()


def compare_open_3d(grid, bcs, gamma, gen, errs, code=None, based=False,
                    dt=1e-3, key=None) -> float:
    """Kernels 1-2 on an open table (``code``: with an obstacle, the
    masked mode; ``based``: kernel 1 in rk2's base form) against their
    plain versions on random O(1) states that keep the step's invariant
    (boundary values and blocked faces set); kernel 2 on kernel 1's u*
    and a random p. compare_kernels' tolerances. Returns the largest
    error; ``key``: the errs entry (the masked mode's own)."""
    nu, rho = 0.02, 1.3
    fm = None if code is None else fused3d.masks_from_code(grid, code)[0]

    def state():
        return apply_velocity_bcs(grid, bcs, [
            torch.randn(grid.face_shape(a), generator=gen, device=DEV)
            for a in range(3)], fm)
    u = state()
    base = state() if based else None
    k_u, k_rhs = fused3d.predictor_rhs_3d(grid, bcs, u, dt, nu, gamma, rho,
                                          base=base, code=code)
    p_u, p_rhs = fused3d.predictor_rhs_plain(grid, bcs, u, dt, nu, gamma,
                                             rho, base=base, code=code)
    e = max(close(f"open u*[{a}]", k_u[a], p_u[a], 1e-5, 1e-5)
            for a in range(3))
    e = max(e, close("open rhs", k_rhs, p_rhs, 1e-4,
                     3e-7 * float(p_rhs.abs().max())))
    e1 = e
    p = torch.randn(grid.shape, generator=gen, device=DEV)
    per = (False,) * 3
    k_n, k_div, k_vel = fused3d.correct_diag_3d(grid, k_u, p, dt / rho, per,
                                                bcs=bcs, code=code)
    p_n, p_div, p_vel = fused3d.correct_diag_plain(grid, k_u, p, dt / rho,
                                                   per, bcs, code)
    e2 = max(close(f"open u_new[{a}]", k_n[a], p_n[a], 1e-5, 1e-5)
             for a in range(3))
    e2 = max(e2, close("open max_div", k_div, p_div, 1e-4, 0.0))
    e2 = max(e2, close("open max_vel", k_vel, p_vel, 1e-4, 0.0))
    kp, kc = ("predictor_rhs_3d", "correct_diag_3d") if key is None else key
    errs[kp] = max(errs.get(kp, 0.0), e1)
    errs[kc] = max(errs.get(kc, 0.0), e2)
    return max(e1, e2)


def check_sphere_modes(case_sph, gen, errs) -> None:
    """Phase 2 of the sphere's slice: kernels 1-2 with open faces and no
    obstacle (the ragged walls' shape with open_faces_bcs), in the masked
    mode on the same shape with the sphere's table and blocks_solid, and
    on the sphere at 256x128x128 (its table and stencil code), each at
    gamma 0 and 0.2, Euler and rk2's base form, against their plain
    versions; kernel 3 on the sphere's operator (its masked code)."""
    rag = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    sim = case_sph.sim
    code_rag = build_poisson_op(rag, sim.bcs, DEV,
                                blocks_solid(RAGGED_WALL)).code
    e = {}
    for what, grid, bcs, code in (
            ("open", rag, open_faces_bcs(), None),
            ("masked ragged", rag, sim.bcs, code_rag),
            ("sphere", sim.grid, sim.bcs, sim.op.code)):
        key = None if code is None else SPHERE_MODES
        for gamma in (0.0, 0.2):
            for based in (False, True):
                e[f"{what} g{gamma}{' base' if based else ''}"] = \
                    compare_open_3d(grid, bcs, gamma, gen, errs, code=code,
                                    based=based, key=key)
    p = torch.randn(sim.grid.shape, generator=gen, device=DEV)
    b = torch.randn(sim.grid.shape, generator=gen, device=DEV)
    k_r = fused3d.residual_3d(sim.op, p, b)
    p_r = fused3d.residual_plain(sim.op, p, b)
    e["residual sphere"] = close("sphere residual", k_r, p_r, 1e-5,
                                 1e-6 * float(p_r.abs().max()))
    errs["residual_3d"] = max(errs["residual_3d"], e["residual sphere"])
    torch.cuda.synchronize()
    line("phase2", sphere_modes=json.dumps(e))


def sphere_flux(sim, st) -> tuple:
    """The volume flux through the inflow and the outflow face (float64)."""
    h = sim.grid.spacing
    area = h[1] * h[2]
    return (float(st.u[0][0].double().sum()) * area,
            float(st.u[0][-1].double().sum()) * area)


def sphere_steps_vs_plain(case_sph) -> None:
    """Phase 3 of the sphere's slice: 5 Euler, 5 rk2 and 5 cfl 0.4 steps
    (a cap of 10x the case's dt) of the sphere at 256x128x128 from the
    impulsive start, kernels against step_plain: the 3D whole-step
    tolerances, p within 1e-4 of max|p| (the dctcg solve stops at a
    relative residual of 1e-5, as the cylinder's), Richardson sweep counts
    within one a step (the stopping test at the float32 floor)."""
    st0 = impulsive_start_state(case_sph.sim)
    for what, c in (("euler", case_sph),) + integrator_modes(case_sph):
        steps_vs_plain(c, f"sphere {what}", (2e-5, 2e-6), (2e-4, None),
                       state=st0, count_slack=1)


def sphere_runs(case_sph, reset_all) -> dict:
    """Phase 4 of the sphere's slice: SPHERE_STEPS timed Euler steps and
    SPHERE_STEPS rk2 steps from the impulsive start (after 10 warm-up
    steps; kernels 1-2 in the masked mode launched every step), their
    launches a step, busy ms a step and idle share over 5 profiled steps;
    the inflow flux equal to the outflow flux (within 1e-6 of it) and, on
    one more step, max|div u| at or below what the solve's residual leaves
    (dt/rho ||b - A p||_2, plus SPHERE_DIV_FLOOR for float32 roundoff);
    then the new modes' times on the run's state, by events beside their
    plain versions and bounds and by CUDA-graph replay over rotated inputs
    (their device time: a 256x128x128 call is shorter than the wrapper's
    host time): the masked predictor (Euler and base), the masked
    corrector, and both kernels with the sphere's open faces and no
    obstacle. Returns the runs with the modes' times and bounds."""
    sim = case_sph.sim
    counts = lambda: {k: fused3d.LAUNCHES[k]  # noqa: E731
                      for k in ("predictor_rhs_3d", "correct_diag_3d")}
    st0 = impulsive_start_state(sim)
    out = {}
    for what, c in (("euler", case_sph),
                    ("rk2", with_params(case_sph, integrator="rk2"))):
        r = timed_run(c, reset_all, counts, steps=SPHERE_STEPS, state=st0)
        per_step, busy = profile_launches(c.sim, r["state"], 5)
        q_in, q_out = sphere_flux(c.sim, r["state"])
        if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
            raise AssertionError(f"sphere {what}: inflow {q_in} against "
                                 f"outflow {q_out}")
        st1, d1 = c.sim.run_scan(r["state"], 1)
        div = check_iterative(c.sim, st1, d1)
        left = div["div_bound"] - 1e-3     # dt/rho ||b - A p||_2
        if not div["next_max_div"] <= left + SPHERE_DIV_FLOOR:
            raise AssertionError(f"sphere {what}: max_div "
                                 f"{div['next_max_div']} above dt/rho "
                                 f"||b - A p|| = {left}")
        line("phase4", sphere=what, ms_per_step=f"{r['ms']:.4f}",
             busy_ms_per_step=f"{busy:.4f}",
             idle_share=f"{max(0.0, 1.0 - busy / r['ms']):.4f}",
             launches_per_step=per_step,
             kernel_launches_per_step=json.dumps(
                 {k: v / SPHERE_STEPS for k, v in r["launches"].items()}),
             flux_in_out=json.dumps([q_in, q_out]),
             max_div_next=div["next_max_div"], dt_over_rho_res_l2=left,
             rel_res_next=div["next_res"])
        out[what] = r
    st = out["euler"]["state"]
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    code = sim.op.code
    dts = sim._dts(None)
    us, rhs = fused3d.predictor_rhs_3d(g, bcs, st.u, dts[0], pr.nu,
                                       pr.upwind_gamma, pr.rho, bc=sim.bc,
                                       dts=dts, code=code)
    cells = math.prod(g.shape)
    per = (False,) * 3

    def pred(base=None, code=code):
        return lambda: fused3d.predictor_rhs_3d(
            g, bcs, st.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho, bc=sim.bc,
            dts=dts, base=base, code=code)

    def pred_plain(base=None, code=code):
        return lambda: fused3d.predictor_rhs_plain(
            g, bcs, st.u, float(dts[0]), pr.nu, pr.upwind_gamma, pr.rho,
            base=base, code=code)

    def corr(code=code):
        return lambda: fused3d.correct_diag_3d(g, us, st.p, dts[2], per,
                                               bcs=bcs, code=code)

    def corr_plain(code=code):
        return lambda: fused3d.correct_diag_plain(g, us, st.p, float(dts[2]),
                                                  per, bcs, code)
    base = out["rk2"]["state"].u
    pred_bytes = nbytes(*st.u, *us, rhs, sim.bc)
    corr_bytes = nbytes(*us, st.p, *us) + 8
    times, bounds = {}, {}
    time_pairs({
        "predictor_rhs_3d masked": (
            pred(), pred_plain(), pred_bytes + nbytes(code),
            (OPS_PER_CELL["predictor_rhs_3d"] + MASK_OPS) * cells),
        "predictor_rhs_3d masked base": (
            pred(base), pred_plain(base),
            pred_bytes + nbytes(code, *base),
            (OPS_PER_CELL["predictor_rhs_3d"] + MASK_OPS) * cells),
        "correct_diag_3d masked": (
            corr(), corr_plain(), corr_bytes + nbytes(code),
            (OPS_PER_CELL["correct_diag_3d"] + MASK_OPS) * cells),
        "predictor_rhs_3d open": (
            pred(code=None), pred_plain(code=None), pred_bytes,
            OPS_PER_CELL["predictor_rhs_3d"] * cells),
        "correct_diag_3d open": (
            corr(code=None), corr_plain(code=None), corr_bytes,
            OPS_PER_CELL["correct_diag_3d"] * cells),
    }, times, bounds)
    # device time by graph replay over rotated input sets
    dev_ms = {}
    for k, fn_of, inputs, nb in (
            ("predictor_rhs_3d masked", lambda s_: lambda: (
                fused3d.predictor_rhs_3d(g, bcs, s_, dts[0], pr.nu,
                                         pr.upwind_gamma, pr.rho, bc=sim.bc,
                                         dts=dts, code=code)),
             tuple(st.u), pred_bytes),
            ("predictor_rhs_3d masked base", lambda s_: lambda: (
                fused3d.predictor_rhs_3d(g, bcs, s_[:3], dts[0], pr.nu,
                                         pr.upwind_gamma, pr.rho, bc=sim.bc,
                                         dts=dts, base=s_[3:], code=code)),
             (*st.u, *base), pred_bytes + nbytes(*base)),
            ("correct_diag_3d masked", lambda s_: lambda: (
                fused3d.correct_diag_3d(g, s_[:3], s_[3], dts[2], per,
                                        bcs=bcs, code=code)),
             (*us, st.p), corr_bytes),
            ("predictor_rhs_3d open", lambda s_: lambda: (
                fused3d.predictor_rhs_3d(g, bcs, s_, dts[0], pr.nu,
                                         pr.upwind_gamma, pr.rho, bc=sim.bc,
                                         dts=dts)),
             tuple(st.u), pred_bytes),
            ("correct_diag_3d open", lambda s_: lambda: (
                fused3d.correct_diag_3d(g, s_[:3], s_[3], dts[2], per,
                                        bcs=bcs)),
             (*us, st.p), corr_bytes)):
        fns = [fn_of(s_) for s_ in rotated(inputs, nb)]
        dev_ms[k] = time_graph_ms(fns)
        line("phase4", kernel=k, device_ms_graph=f"{dev_ms[k]:.4f}",
             event_ms=f"{min(times[k][0], times[k][3]):.4f}",
             host_us_per_call=f"{host_us(fns[0]):.1f}",
             bound_ms=f"{bounds[k][0]:.4f}",
             bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
             input_sets=len(fns))
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


# -- the LES slice: kernels 6-7's periodic and open modes, the LES route on
# periodic axes, open faces and the obstacle's masks -------------------------


def les_cases(case_tg, case_sph, case_conv) -> dict:
    """The slice's cases at full width with the Smagorinsky closure, added
    as both CLIs add it (``dataclasses.replace(sim, les=...)``):
    taylor_green3d 256^3 (Re 1600, every axis periodic) and the sphere at
    256x128x128 (Re 300, dctcg), its outlet an OUTFLOW face and (phases 2
    and 3 only) a CONVECTIVE one; each with its start state (the sphere's
    impulsive start)."""
    out = {}
    for what, c, start in (("taylor_green3d les", case_tg, None),
                           ("sphere les", case_sph, impulsive_start_state),
                           ("convective sphere les", case_conv,
                            impulsive_start_state)):
        c = dataclasses.replace(c, sim=dataclasses.replace(
            c.sim, les=LESConfig(cs=LES_CS)))
        out[what] = (c, start(c.sim) if start else c.initial_state())
    return out


def les_open_low_bcs():
    """A 3D open table whose OUTFLOW faces sit on the low sides of axes 1
    and 2 (the LES predictor's row of shared memory and its shuffle) and
    on axis 0's high side, with an inflow, a slip face and a moving
    wall."""
    return {(0, 0): BCSpec.inflow((1.0, 0.1, -0.2)), (0, 1): BCSpec.outflow(),
            (1, 0): BCSpec.outflow(), (1, 1): BCSpec.slip(),
            (2, 0): BCSpec.outflow(), (2, 1): BCSpec.wall((0.4, -0.3, 0.0))}


def compare_les_modes(grid, bcs, gamma, gen, errs, keys, code=None,
                      force=None, vols=None, theta=None,
                      scalar=None) -> float:
    """Kernels 6-7 in the table's mode against their plain versions on one
    random O(1) state that keeps the step's invariant (boundary values,
    blocked faces, face n of a periodic axis equal to face 0), with
    compare_les_kernels' tolerances (nu_t within 2e-6 of max nu_t, u* atol
    5e-5) and face n of a periodic axis bit-equal to face 0; ``keys``: the
    errs entries of the two kernels' modes. Kernel 6's forced mode: the
    static ``force``, the volumes ``vols``, the buoyancy of ``theta`` with
    ``scalar`` (its plain version's ``forcing + sgs``). Returns
    the larger error."""
    cfg = LESConfig(cs=0.2)
    fm = None if code is None else fused3d.masks_from_code(grid, code)[0]
    per = periodic_axes(grid, bcs)
    u = [torch.randn(grid.face_shape(a), generator=gen, device=DEV)
         for a in range(3)]
    for a in range(3):
        if per[a]:
            u[a].select(a, grid.shape[a]).copy_(u[a].select(a, 0))
    u = apply_velocity_bcs(grid, bcs, u, fm)
    k_nt = predictor3d.nu_t_3d(grid, bcs, u, cfg)
    p_nt = eddy_viscosity(grid, bcs, u, cfg)
    e_nt = close(f"{keys[0]} nu_t", k_nt, p_nt, 0.0, 2e-6 * float(p_nt.max()))
    k_u = predictor3d.predictor_3d(grid, bcs, u, 1e-3, 0.05, gamma,
                                   nu_t=p_nt, code=code, force=force,
                                   force_vol=vols, theta=theta,
                                   scalar=scalar)
    forcing = fused3d.plain_forcing(force, vols, 3)
    if theta is not None:
        forcing = combined_forcing(forcing, buoyancy_forcing(grid, scalar,
                                                             theta))
    p_u = predictor3d.predictor_3d_plain(grid, bcs, u, 1e-3, 0.05, gamma,
                                         nu_t=p_nt, code=code,
                                         forcing=forcing)
    e_u = max(close(f"{keys[1]} u*[{a}]", k_u[a], p_u[a], 0.0, 5e-5)
              for a in range(3))
    check_wrap_faces(keys[1], k_u, per)
    for k, e in zip(keys, (e_nt, e_u)):
        errs[k] = max(errs.get(k, 0.0), e)
    return max(e_nt, e_u)


def check_les_modes(cases, gen, errs) -> None:
    """Phase 2 of the LES slice: kernels 6-7 against their plain versions
    in every periodic mask 1-7 on RAGGED_PER (walls where an axis is
    bounded, one moving) and on the Taylor-Green box at 256^3; in the open
    mode on RAGGED_WALL with OUTFLOW faces on high sides (open_faces_bcs),
    on low ones (les_open_low_bcs) and with a CONVECTIVE face at (0, 1),
    without and with solid blocks beside every face kind (the masked
    predictor); and on the sphere at 256x128x128, its table without and
    with its stencil code; gamma 0 and 0.8 (the ragged tables), the case's
    gamma at full width."""
    e = {}
    rag_p = GridSpec(RAGGED_PER, (1.0, 0.6, 1.8))
    per_keys = ("nu_t_3d periodic", "predictor_3d periodic")
    for mask in range(1, 8):
        bcs = no_slip_box(rag_p)
        bcs[(1, 1) if mask != 2 else (0, 1)] = BCSpec.wall((0.7, 0.1, 0.2))
        for a in range(3):
            if (mask >> a) & 1:
                bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
        for gamma in (0.0, 0.8):
            e[f"mask{mask} g{gamma}"] = compare_les_modes(
                rag_p, bcs, gamma, gen, errs, per_keys)
    tg = cases["taylor_green3d les"][0].sim
    e["taylor_green3d"] = compare_les_modes(
        tg.grid, tg.bcs, tg.params.upwind_gamma, gen, errs, per_keys)
    rag = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    conv = open_faces_bcs()
    conv[(0, 1)] = BCSpec.convective(1.0)
    for what, bcs in (("open high", open_faces_bcs()),
                      ("open low", les_open_low_bcs()),
                      ("convective", conv)):
        code = build_poisson_op(rag, bcs, DEV, blocks_solid(RAGGED_WALL)).code
        for c, mode in ((None, "open"), (code, "masked")):
            for gamma in (0.0, 0.8):
                e[f"{what} {mode} g{gamma}"] = compare_les_modes(
                    rag, bcs, gamma, gen, errs,
                    ("nu_t_3d open", f"predictor_3d {mode}"), c)
    sph = cases["sphere les"][0].sim
    for c, mode in ((None, "open"), (sph.op.code, "masked")):
        e[f"sphere {mode}"] = compare_les_modes(
            sph.grid, sph.bcs, sph.params.upwind_gamma, gen, errs,
            ("nu_t_3d open", f"predictor_3d {mode}"), c)
    torch.cuda.synchronize()
    line("phase2", les_modes=json.dumps(e))


def les_steps_vs_plain(cases) -> None:
    """Phase 3 of the LES slice: 5 Euler, 5 rk2 and 5 cfl 0.4 steps (a cap
    of 10x the case's dt) of each LES case from its start (the convective
    sphere's outlet transported after each stage's predictor), kernels
    against step_plain: u atol 5e-5 (the LES step's kernel-vs-jnp
    tolerance, as the LES cavity's), p within 1e-4 of max|p|, the
    sphere's Richardson sweeps within one a step (a stopping test at
    float32's floor)."""
    for what, (c, st0) in cases.items():
        slack = 1 if c.sim.dctcg_solver is not None else 0
        for mode, cm in (("euler", c),) + integrator_modes(c):
            steps_vs_plain(cm, f"{what} {mode}", (0.0, 5e-5), (2e-4, None),
                           state=st0, count_slack=slack)


def kinetic_energy(grid, u) -> float:
    """0.5 sum over faces of u_a^2 times the cell volume (float64)."""
    vol = math.prod(grid.spacing)
    return 0.5 * vol * sum(float(c.double().square().sum()) for c in u)


def les_runs(cases, reset_all) -> dict:
    """Phase 4 of the LES slice: LES_STEPS timed Euler and rk2 steps of
    the box and of the sphere with its OUTFLOW outlet from their starts
    (after 10 warm-up steps; kernels 6-7 and 2 in
    the table's modes every stage), launches a step, busy ms a step, idle
    share and host syncs a step; the sphere's inflow flux equal to its
    outflow flux (within 1e-6 of it); the Taylor-Green box's kinetic
    energy after LES_STEPS steps from its start below that of its no-LES
    twin's; then the new modes' times on the Euler runs' states, by events
    beside their plain versions and bounds and by CUDA-graph replay over
    rotated inputs (their device time). Returns the runs with the modes'
    times and bounds."""
    out = {}
    for what, (c, st0) in cases.items():
        if what.startswith("convective"):
            continue
        keys = ("nu_t_3d", "predictor_3d", "correct_diag_3d") + (
            ("residual_3d",) if c.sim.dct_solver is not None else ())

        def counts(keys=keys):
            return {k: {**fused3d.LAUNCHES, **predictor3d.LAUNCHES}[k]
                    for k in keys}
        for mode, cm in (("euler", c),
                         ("rk2", with_params(c, integrator="rk2"))):
            r = timed_run(cm, reset_all, counts, steps=LES_STEPS, state=st0)
            per_step, busy = profile_launches(cm.sim, r["state"], 5)
            extra = {}
            if c.sim.face_masks is not None:
                q_in, q_out = sphere_flux(cm.sim, r["state"])
                if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
                    raise AssertionError(f"{what} {mode}: inflow {q_in} "
                                         f"against outflow {q_out}")
                extra["flux_in_out"] = json.dumps([q_in, q_out])
            line("phase4", case=json.dumps(what), integrator=mode,
                 ms_per_step=f"{r['ms']:.4f}", busy_ms_per_step=f"{busy:.4f}",
                 idle_share=f"{max(0.0, 1.0 - busy / r['ms']):.4f}",
                 launches_per_step=per_step,
                 kernel_launches_per_step=json.dumps(
                     {k: v / LES_STEPS for k, v in r["launches"].items()}),
                 **extra)
            out[f"{what} {mode}"] = r
    # the closure dissipates: the LES box keeps less kinetic energy than
    # its no-LES twin after LES_STEPS steps from the same start
    c, st0 = cases["taylor_green3d les"]
    twin = dataclasses.replace(c.sim, les=None)
    e_les = kinetic_energy(c.sim.grid, c.sim.run_scan(st0, LES_STEPS)[0].u)
    e_twin = kinetic_energy(c.sim.grid, twin.run_scan(st0, LES_STEPS)[0].u)
    e0 = kinetic_energy(c.sim.grid, st0.u)
    if not e_les < e_twin:
        raise AssertionError(f"taylor_green3d: kinetic energy with LES "
                             f"{e_les} not below the twin's {e_twin}")
    line("phase4", case="taylor_green3d", les_steps=LES_STEPS,
         kinetic_energy_start_les_twin=json.dumps([e0, e_les, e_twin]))
    times, bounds, dev_ms = {}, {}, {}
    for what, mode_nt, mode_p, code_of in (
            ("taylor_green3d les", "nu_t_3d periodic",
             "predictor_3d periodic", lambda sim: None),
            ("sphere les", "nu_t_3d open", "predictor_3d masked",
             lambda sim: sim.op.code)):
        c, _ = cases[what]
        sim = c.sim
        g, bcs, pr, cfg = sim.grid, sim.bcs, sim.params, sim.les
        st = out[f"{what} euler"]["state"]
        code = code_of(sim)
        dts = sim._dts(None)
        nu_t = predictor3d.nu_t_3d(g, bcs, st.u, cfg, bc=sim.bc)
        us = predictor3d.predictor_3d(g, bcs, st.u, dts[0], pr.nu,
                                      pr.upwind_gamma, nu_t=nu_t, bc=sim.bc,
                                      code=code)
        cells = math.prod(g.shape)
        nt_bytes = nbytes(*st.u, nu_t, sim.bc)
        p_bytes = nbytes(*st.u, nu_t, *us, sim.bc) + (
            0 if code is None else nbytes(code))
        p_ops = (OPS_PER_CELL["predictor_3d"]
                 + (0 if code is None else MASK_OPS)) * cells
        time_pairs({
            mode_nt: (
                lambda: predictor3d.nu_t_3d(g, bcs, st.u, cfg, bc=sim.bc),
                lambda: eddy_viscosity(g, bcs, st.u, cfg), nt_bytes,
                OPS_PER_CELL["nu_t_3d"] * cells),
            mode_p: (
                lambda: predictor3d.predictor_3d(
                    g, bcs, st.u, dts[0], pr.nu, pr.upwind_gamma, nu_t=nu_t,
                    bc=sim.bc, code=code),
                lambda: predictor3d.predictor_3d_plain(
                    g, bcs, st.u, float(dts[0]), pr.nu, pr.upwind_gamma,
                    nu_t=nu_t, code=code), p_bytes, p_ops),
        }, times, bounds)
        for k, fn_of, inputs, nb in (
                (mode_nt, lambda s_: lambda: predictor3d.nu_t_3d(
                    g, bcs, s_, cfg, bc=sim.bc), tuple(st.u), nt_bytes),
                (mode_p, lambda s_: lambda: predictor3d.predictor_3d(
                    g, bcs, s_[:3], dts[0], pr.nu, pr.upwind_gamma,
                    nu_t=s_[3], bc=sim.bc, code=code), (*st.u, nu_t),
                 p_bytes)):
            fns = [fn_of(s_) for s_ in rotated(inputs, nb)]
            dev_ms[k] = time_graph_ms(fns)
            line("phase4", kernel=k, case=json.dumps(what),
                 device_ms_graph=f"{dev_ms[k]:.4f}",
                 event_ms=f"{min(times[k][0], times[k][3]):.4f}",
                 host_us_per_call=f"{host_us(fns[0]):.1f}",
                 bound_ms=f"{bounds[k][0]:.4f}",
                 bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
                 input_sets=len(fns))
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


# -- the convective slice: the staircase cylinder on kernels 4-5, CONVECTIVE
# outlets in kernels 1, 2, 4, 5 and on the unfused 2D route -----------------


def open_tables_2d():
    """The 2D tables of kernels 4-5's open modes in phase 2: every face
    kind beside every face (INFLOW with a tangential value, SLIP, WALL
    with one, OUTFLOW at (0, 0), (0, 1) and on axis 1), a CONVECTIVE
    outlet at (0, 1), and walls (with an obstacle: the masked mode's walls
    table)."""
    return {
        "cylinder": {(0, 0): BCSpec.inflow((1.0, 0.0)),
                     (0, 1): BCSpec.outflow(), (1, 0): BCSpec.slip(),
                     (1, 1): BCSpec.slip()},
        "low_outflow": {(0, 0): BCSpec.outflow(),
                        (0, 1): BCSpec.inflow((-0.7, 0.3)),
                        (1, 0): BCSpec.wall((0.4, 0.0)),
                        (1, 1): BCSpec.outflow()},
        "lateral": {(0, 0): BCSpec.wall((0.0, -0.5)),
                    (0, 1): BCSpec.outflow(), (1, 0): BCSpec.outflow(),
                    (1, 1): BCSpec.inflow((0.2, -0.6))},
        "convective": {(0, 0): BCSpec.inflow((1.0, 0.0)),
                       (0, 1): BCSpec.convective(1.3),
                       (1, 0): BCSpec.slip(),
                       (1, 1): BCSpec.wall((0.3, 0.0))},
        "walls": {(0, 0): BCSpec.wall((0.0, 0.0)),
                  (0, 1): BCSpec.wall((0.0, 0.0)),
                  (1, 0): BCSpec.wall((0.0, 0.0)),
                  (1, 1): BCSpec.wall((1.0, 0.0))},
    }


def blocks_solid_2d(shape):
    """Solid blocks beside every face of a 2D grid: both sides of both
    axes, one cell from the outlet at (0, 1), and an interior block."""
    s = torch.zeros(shape, dtype=torch.bool)
    n0, n1 = shape
    s[10:14, 12:20] = True
    s[0:3, n1 // 2:n1 // 2 + 4] = True
    s[n0 - 2:, 5:9] = True
    s[n0 - 4:n0 - 3, n1 - 15:n1 - 12] = True
    s[n0 // 2:n0 // 2 + 3, 0:2] = True
    s[n0 // 3:n0 // 3 + 3, n1 - 3:] = True
    return s.numpy()


def open_mode_name(kernel, bcs, code, based=False) -> str:
    """The report's name of a mode of kernels 1, 2, 4 or 5: "open" (the
    faces' kinds) or "masked" (with an obstacle), "convective" with a
    CONVECTIVE face, "base" in rk2's base form."""
    name = f"{kernel} {'masked' if code is not None else 'open'}"
    if bcs[(0, 1)].kind is BCKind.CONVECTIVE:
        name += " convective"
    return name + (" base" if based else "")


def compare_open_2d(grid, bcs, gamma, gen, errs, code=None, based=False,
                    dt=2e-3) -> float:
    """Kernels 4-5 on an open table (``code``: with an obstacle, the
    masked mode; ``based``: kernel 4 in rk2's base form) against their
    plain versions on random O(1) states that keep the step's invariant
    (boundary values and blocked faces set); kernel 5 on kernel 4's u*
    and a random p: u* and u within 1e-5 or 8 ulps of their maximum, the
    RHS within 1e-4 or 3e-7 of its maximum, the maxima within 1e-4. The
    errors go to the mode's entry of ``errs``; returns the largest."""
    nu, rho = 0.02, 1.3
    fm = None if code is None else fused3d.masks_from_code(grid, code)[0]

    def state():
        return apply_velocity_bcs(grid, bcs, [
            torch.randn(grid.face_shape(a), generator=gen, device=DEV)
            for a in range(2)], fm)
    u = state()
    base = state() if based else None
    bc = fused2d.bc_table(grid, bcs, DEV, masked=code is not None)
    k_u, k_rhs = fused2d.predictor_rhs_2d(grid, bcs, u, dt, nu, gamma, rho,
                                          bc=bc, base=base, code=code)
    p_u, p_rhs = fused2d.predictor_rhs_2d_plain(grid, bcs, u, dt, nu, gamma,
                                                rho, base=base, code=code)

    def ulps(t):
        return max(1e-5, 8 * 1.2e-7 * float(t.abs().max()))
    e1 = max(close(f"open2d u*[{a}]", k_u[a], p_u[a], 1e-5, ulps(p_u[a]))
             for a in range(2))
    e1 = max(e1, close("open2d rhs", k_rhs, p_rhs, 1e-4,
                       3e-7 * float(p_rhs.abs().max())))
    p = torch.randn(grid.shape, generator=gen, device=DEV)
    per = (False, False)
    k_n, k_div, k_vel = fused2d.correct_diag_2d(grid, k_u, p, dt / rho, per,
                                                bcs=bcs, code=code)
    p_n, p_div, p_vel = fused2d.correct_diag_2d_plain(grid, k_u, p, dt / rho,
                                                      per, bcs, code)
    e2 = max(close(f"open2d u_new[{a}]", k_n[a], p_n[a], 1e-5, ulps(p_n[a]))
             for a in range(2))
    e2 = max(e2, close("open2d max_div", k_div, p_div, 1e-4, 0.0))
    e2 = max(e2, close("open2d max_vel", k_vel, p_vel, 1e-4, 0.0))
    kp = open_mode_name("predictor_rhs_2d", bcs, code, based)
    kc = open_mode_name("correct_diag_2d", bcs, code)
    errs[kp] = max(errs.get(kp, 0.0), e1)
    errs[kc] = max(errs.get(kc, 0.0), e2)
    return max(e1, e2)


def convective_cases() -> dict:
    """The convective slice's paths at full width: JAX's default
    make_case("cylinder") (the staircase, dctcg) at its published 512x256
    and at 2048x1024, where the IBM cylinder is timed; the convective
    cylinder at 2048x1024 (Euler: fused; rk2: the unfused route); the
    convective sphere at JAX's published 256x128x128 (Euler and rk2); the
    convective channel at 2048x512 (mg, the unfused route, kernel 8)."""
    out = {
        "staircase 512x256": make_case("cylinder", shape=CYL_BASE,
                                       device=DEV),
        "staircase": make_case("cylinder", shape=CYL_SHAPE, device=DEV),
        "convective cylinder": make_case("cylinder", shape=CYL_SHAPE,
                                         outlet="convective", device=DEV),
        "convective sphere": make_case("sphere", outlet="convective",
                                       device=DEV),
        "convective channel": make_case("channel", shape=CHANNEL_SHAPE,
                                        outlet="convective", device=DEV),
    }
    for name, c in out.items():
        if c.sim.fused == ("channel" in name):
            raise AssertionError(f"{name}: fused {c.sim.fused}")
    return out


def variants(name, case):
    """Phase 3's Euler, rk2 and cfl 0.4 variants of a path (rk2 and the
    CFL dt with a cap of 10x the case's dt, as integrator_modes, but the
    channel's 1.5x: its dt is the diffusive limit, which 10x would pass,
    as the forcing slice's 2D lid; built anew where the route depends on
    them: the convective cylinder under rk2 runs the unfused route)."""
    if "channel" in name:
        return (("euler", case), ("rk2", with_params(case, integrator="rk2")),
                ("cfl", with_params(case, cfl=0.4,
                                    dt=1.5 * case.sim.params.dt)))
    if name == "convective cylinder":
        kw = dict(shape=CYL_SHAPE, outlet="convective", device=DEV)
        dt = case.sim.params.dt
        rk2 = make_case("cylinder", integrator="rk2", **kw)
        if rk2.sim.fused:
            raise AssertionError("the convective cylinder fused under rk2")
        return (("euler", case), ("rk2", rk2),
                ("cfl", make_case("cylinder", cfl=0.4, dt=10 * dt, **kw)))
    return (("euler", case),) + integrator_modes(case)


def start_of(name, sim):
    """A path's start: the Poiseuille state of the channel, the impulsive
    start of the bluff bodies."""
    if "channel" in name:
        return poiseuille_state(sim)
    return impulsive_start_state(sim)


def check_convective_modes(cases, gen, errs) -> None:
    """Phase 2 of the convective slice: kernels 4-5's open modes on the
    shapes of OPEN_P2 (every table of open_tables_2d, with and without
    blocks_solid_2d) and on the staircase cylinder at 2048x1024 (its table
    and stencil code, and with a CONVECTIVE outlet), kernels 1-2's
    convective variants on RAGGED_WALL (the sphere's table with a
    CONVECTIVE outlet, with and without blocks_solid) and on the
    convective sphere at 256x128x128, each at gamma 0 and 0.2, Euler and
    rk2's base form (kernel 4's convective modes Euler only)."""
    e = {}
    runs = []
    for shape in OPEN_P2:
        g = GridSpec(shape, (2.0, 1.7))
        for name, bcs in open_tables_2d().items():
            for masked in (False, True):
                if name == "walls" and not masked:
                    continue
                code = (build_poisson_op(g, bcs, DEV,
                                         blocks_solid_2d(shape)).code
                        if masked else None)
                runs.append((f"{name} {_name(shape)}"
                             f"{' masked' if masked else ''}", g, bcs, code))
    st = cases["staircase"].sim
    conv = dict(st.bcs)
    conv[(0, 1)] = BCSpec.convective(1.0)
    runs += [("staircase", st.grid, st.bcs, st.op.code),
             ("staircase convective", st.grid, conv, st.op.code)]
    for what, g, bcs, code in runs:
        for gamma in (0.0, 0.2):
            for based in (False, True):
                if based and bcs[(0, 1)].kind is BCKind.CONVECTIVE:
                    continue
                e[f"{what} g{gamma}{' base' if based else ''}"] = \
                    compare_open_2d(g, bcs, gamma, gen, errs, code=code,
                                    based=based, dt=st.params.dt)
    rag = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    sph = cases["convective sphere"].sim
    code_rag = build_poisson_op(rag, sph.bcs, DEV,
                                blocks_solid(RAGGED_WALL)).code
    for what, grid, code in (("sphere conv ragged", rag, None),
                             ("sphere conv ragged masked", rag, code_rag),
                             ("convective sphere", sph.grid, sph.op.code)):
        for gamma in (0.0, 0.2):
            for based in (False, True):
                key = (open_mode_name("predictor_rhs_3d", sph.bcs, code,
                                      based),
                       open_mode_name("correct_diag_3d", sph.bcs, code))
                e[f"{what} g{gamma}{' base' if based else ''}"] = \
                    compare_open_3d(grid, sph.bcs, gamma, gen, errs,
                                    code=code, based=based, key=key)
    torch.cuda.synchronize()
    line("phase2", convective_slice_modes=json.dumps(e))


def convective_steps_vs_plain(cases) -> None:
    """Phase 3 of the convective slice: 5 Euler, 5 rk2 and 5 cfl 0.4 steps
    of each path, kernels against step_plain, from its start: u at the
    whole-step tolerances, p within 1e-4 of max|p| (the sphere's dctcg
    stops at a relative residual of 1e-5), the cylinders' within 2e-4
    (dctcg at 2048x1024: a sweep count one apart, which the counts' slack
    allows, moved p by 1.7e-4 of max|p| under cfl 0.4), the channel's
    within 3e-2 (mg at 2048x512 stops on its stagnation rule at the
    float32 floor, at relative residuals of 5e-3 to 6.5e-2 (PERF.md §6,
    row 8), each route at its own: 1.1e-2 of max|p| measured; u within the
    whole-step tolerances all the same), solve counts within one a step
    (the channel's within 2)."""
    for name, case in cases.items():
        st0 = start_of(name, case.sim)
        p_rel = (3e-2 if "channel" in name
                 else 2e-4 if case.sim.grid.ndim == 2 else 1e-4)
        for what, c in variants(name, case):
            steps_vs_plain(c, f"{name} {what}", (2e-5, 2e-6), (2e-4, None),
                           state=st0, p_rel=p_rel,
                           count_slack=2 if "channel" in name else 1)


def flux_2d(sim, st) -> tuple:
    """The volume flux through the inflow and the outlet face (float64)."""
    h = sim.grid.spacing[1]
    return (float(st.u[0][0].double().sum()) * h,
            float(st.u[0][-1].double().sum()) * h)


def convective_runs(cases, reset_all) -> dict:
    """Phase 4 of the convective slice: CONV_STEPS timed steps of each
    path (the staircase cylinder and the convective sphere also under
    rk2) from its start after 10 warm-up steps, their launches a step,
    busy ms a step and idle share over 5 profiled steps (the channel's
    1), the synchronizing calls a step; the gates: every counter of the
    path > 0, the inflow flux equal to the outflow flux within 1e-6 of it,
    and on one more step max|div u| at or below what the solve's residual
    leaves (dt/rho ||b - A p||_2, plus SPHERE_DIV_FLOOR for float32
    roundoff). Then the new
    modes' times on the runs' states: by events beside their plain
    versions and bounds, and by CUDA-graph replay over rotated inputs (the
    device time). Returns the runs with the modes' times and bounds."""
    def counts_of(sim):
        if sim.grid.ndim == 3:
            keys, mod = ("predictor_rhs_3d", "correct_diag_3d"), fused3d
        elif sim.fused:
            keys, mod = ("predictor_rhs_2d", "correct_diag_2d"), fused2d
        else:
            keys, mod = ("predictor_2d",), predictor2d
        return lambda: {k: mod.LAUNCHES[k] for k in keys}
    out = {}
    for name, case in cases.items():
        runs = [("euler", case)]
        if name in ("staircase", "convective sphere"):
            runs.append(("rk2", with_params(case, integrator="rk2")))
        for what, c in runs:
            sim = c.sim
            r = timed_run(c, reset_all, counts_of(sim), steps=CONV_STEPS,
                          state=start_of(name, sim))
            # the channel's mg makes ~9000 launches a step: one profiled
            # step and 5 counted (5 and 10 cost the profiler ~25 s there)
            few = "channel" in name
            per_step, busy = profile_launches(sim, r["state"],
                                              1 if few else 5)
            q_in, q_out = (sphere_flux(sim, r["state"]) if sim.grid.ndim == 3
                           else flux_2d(sim, r["state"]))
            if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
                raise AssertionError(f"{name} {what}: inflow {q_in} against "
                                     f"outflow {q_out}")
            st1, d1 = sim.run_scan(r["state"], 1)
            div = check_iterative(sim, st1, d1)
            left = div["div_bound"] - 1e-3     # dt/rho ||b - A p||_2
            if not div["next_max_div"] <= left + SPHERE_DIV_FLOOR:
                raise AssertionError(f"{name} {what}: max_div "
                                     f"{div['next_max_div']} above dt/rho "
                                     f"||b - A p|| = {left}")
            line("phase4", convective_slice=f"{name} {what}",
                 shape=_name(sim.grid.shape), fused=sim.fused,
                 ms_per_step=f"{r['ms']:.4f}",
                 busy_ms_per_step=f"{busy:.4f}",
                 idle_share=f"{max(0.0, 1.0 - busy / r['ms']):.4f}",
                 launches_per_step=per_step,
                 syncs_per_step=syncs_per_step(sim, r["state"],
                                               5 if few else 10),
                 kernel_launches_per_step=json.dumps(
                     {k: v / CONV_STEPS for k, v in r["launches"].items()}),
                 flux_in_out=json.dumps([q_in, q_out]),
                 max_div_next=div["next_max_div"],
                 dt_over_rho_res_l2=left, rel_res_next=div["next_res"])
            out[f"{name} {what}"] = r
    times, bounds, dev_ms = {}, {}, {}
    for name, key in (("staircase", "staircase"),
                      ("convective cylinder", "convective cylinder"),
                      ("convective sphere", "convective sphere")):
        time_open_modes(cases[name].sim, out[f"{key} euler"]["state"],
                        out.get(f"{key} rk2", {}).get("state"),
                        times, bounds, dev_ms)
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


def time_open_modes(sim, st, base_state, times, bounds, dev_ms) -> None:
    """The open and masked modes of a path's kernels on its state ``st``
    (and the base form on ``base_state``'s velocity where given): by
    events beside their plain versions and bounds (time_pairs), by graph
    replay over rotated inputs, and the host's microseconds a call. The
    masked modes, and the open ones (the same table without the
    obstacle's code)."""
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    nd = g.ndim
    pk = "predictor_rhs_2d" if nd == 2 else "predictor_rhs_3d"
    ck = "correct_diag_2d" if nd == 2 else "correct_diag_3d"
    dts = sim._dts(None)
    code = sim.op.code
    per = (False,) * nd
    cells = math.prod(g.shape)
    bc_open = (fused2d.bc_table(g, bcs, DEV) if nd == 2 else sim.bc)

    def pred(u, base=None, code=code):
        bc = sim.bc if code is not None else bc_open
        fn = fused2d.predictor_rhs_2d if nd == 2 else fused3d.predictor_rhs_3d
        return fn(g, bcs, u, dts[0], pr.nu, pr.upwind_gamma, pr.rho, bc=bc,
                  dts=dts, base=base, code=code)

    def pred_plain(base=None, code=code):
        fn = (fused2d.predictor_rhs_2d_plain if nd == 2
              else fused3d.predictor_rhs_plain)
        return lambda: fn(g, bcs, st.u, dts[0], pr.nu, pr.upwind_gamma,
                          pr.rho, base=base, code=code)

    def corr(us, p, code=code):
        fn = (fused2d.correct_diag_2d if nd == 2
              else fused3d.correct_diag_3d)
        return fn(g, us, p, dts[2], per, bcs=bcs, code=code)

    def corr_plain(us, code=code):
        fn = (fused2d.correct_diag_2d_plain if nd == 2
              else fused3d.correct_diag_plain)
        return lambda: fn(g, us, st.p, dts[2], per, bcs, code)
    us, rhs = pred(st.u)
    pred_bytes = nbytes(*st.u, *us, rhs, sim.bc)
    corr_bytes = nbytes(*us, st.p, *us) + 8
    mask_ops = MASK_OPS if nd == 3 else MASK_OPS_2D
    calls, graphs = {}, {}
    for code_ in (code, None):
        extra = 0 if code_ is None else mask_ops
        cb = 0 if code_ is None else nbytes(code)
        kp = open_mode_name(pk, bcs, code_)
        kc = open_mode_name(ck, bcs, code_)
        calls[kp] = (lambda c=code_: pred(st.u, code=c),
                     pred_plain(code=code_), pred_bytes + cb,
                     (OPS_PER_CELL[pk] + extra) * cells)
        graphs[kp] = (lambda s_, c=code_: lambda: pred(s_, code=c),
                      tuple(st.u), pred_bytes + cb)
        calls[kc] = (lambda c=code_: corr(us, st.p, code=c),
                     corr_plain(us, code=code_), corr_bytes + cb,
                     (OPS_PER_CELL[ck] + extra) * cells)
        graphs[kc] = (lambda s_, c=code_: lambda: corr(s_[:nd], s_[nd],
                                                       code=c),
                      (*us, st.p), corr_bytes + cb)
        conv = bcs[(0, 1)].kind is BCKind.CONVECTIVE
        if base_state is not None and not (conv and nd == 2):
            base = base_state.u
            kb = open_mode_name(pk, bcs, code_, based=True)
            calls[kb] = (lambda c=code_: pred(st.u, base, code=c),
                         pred_plain(base, code_),
                         pred_bytes + cb + nbytes(*base),
                         (OPS_PER_CELL[pk] + extra) * cells)
            graphs[kb] = (lambda s_, c=code_: lambda: pred(
                s_[:nd], s_[nd:], code=c), (*st.u, *base),
                pred_bytes + cb + nbytes(*base))
    time_pairs(calls, times, bounds)
    for k, (fn_of, inputs, nb) in graphs.items():
        fns = [fn_of(s_) for s_ in rotated(inputs, nb)]
        dev_ms[k] = time_graph_ms(fns)
        line("phase4", kernel=k, shape=_name(g.shape),
             device_ms_graph=f"{dev_ms[k]:.4f}",
             event_ms=f"{min(times[k][0], times[k][3]):.4f}",
             host_us_per_call=f"{host_us(fns[0]):.1f}",
             bound_ms=f"{bounds[k][0]:.4f}",
             bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
             input_sets=len(fns))


# -- the sharp-interface slice: the 3D IBM and the cut-cell pressure -----------


def sharp_cases() -> dict:
    """The slice's paths at full width: the sphere at 256x128x128 (JAX's
    published size, 16 cells a diameter) with the IBM (dctcg, the case's
    own), spinning at 0.5 (dctcg) and with the cut-cell pressure (mgcg),
    and the cut-cell cylinder at 2048x1024 (mg; BASELINE #3's topology, D
    = 128 cells). Each sphere runs kernels 1-2 (the corrector in its coded
    mode for the moving body and the cut band), the cylinder the unfused
    2D route with kernel 8."""
    t0 = time.perf_counter()
    cases = {
        "ibm sphere": make_case("sphere", ibm=True, device=DEV),
        "spin sphere": make_case("sphere", ibm=True, spin=0.5, device=DEV),
        "sharp sphere": make_case("sphere", ibm=True, sharp_pressure=True,
                                  poisson_method="mgcg", device=DEV),
        "sharp cylinder": make_case("cylinder", shape=CYL_SHAPE, ibm=True,
                                    sharp_pressure=True, poisson_method="mg",
                                    device=DEV),
    }
    for name, c in cases.items():
        sph = "sphere" in name
        if c.sim.fused != sph or (sph and not c.sim.ibm.fused_ok):
            raise AssertionError(f"{name}: route fused={c.sim.fused}")
    line("phase2", sharp_build_s=f"{time.perf_counter() - t0:.2f}",
         sharp_cut_box=json.dumps(cases["sharp sphere"].sim.cut_box),
         sharp_mg_levels=json.dumps(
             [list(o.diag.shape)
              for o in cases["sharp sphere"].sim.mg_solver.ops]))
    return cases


def compare_coded(sim, gen, errs, key) -> float:
    """Kernel 2 in its coded mode (``sim.corr_code``) against its plain
    version on a random O(1) u* that keeps the step's invariant (its
    boundary values, the masks, the IBM forcing: the body velocity on the
    wet faces) and a random p: compare_open_3d's tolerances; the wet faces
    equal to u*. Returns the largest error."""
    g, code = sim.grid, sim.corr_code
    fm = fused3d.masks_from_code(g, sim.op.code)[0]
    u = sim.ibm.apply(apply_velocity_bcs(g, sim.bcs, [
        torch.randn(g.face_shape(a), generator=gen, device=DEV)
        for a in range(3)], fm))
    p = torch.randn(g.shape, generator=gen, device=DEV)
    per = (False,) * 3
    k_n, k_div, k_vel = fused3d.correct_diag_3d(g, u, p, 0.01, per,
                                                bcs=sim.bcs, code=code)
    p_n, p_div, p_vel = fused3d.correct_diag_plain(g, u, p, 0.01, per,
                                                   sim.bcs, code)
    e = max(close(f"coded u_new[{a}]", k_n[a], p_n[a], 1e-5, 1e-5)
            for a in range(3))
    e = max(e, close("coded max_div", k_div, p_div, 1e-4, 0.0))
    e = max(e, close("coded max_vel", k_vel, p_vel, 1e-4, 0.0))
    for a, w in enumerate(fused3d.wet_from_code(g, code)):
        if not torch.equal(k_n[a][w], u[a][w]):
            raise AssertionError(f"coded: a wet face of u[{a}] not kept")
    errs[key] = max(errs.get(key, 0.0), e)
    return e


def check_sharp_modes(cases, gen, errs) -> None:
    """Phase 2 of the sharp-interface slice: kernel 2's coded mode on the
    spinning sphere (wet faces), the cut sphere (the band's cells out of
    max|div u|) and a spinning cut sphere on (37, 19, 45) (tiles and runs
    cut short on every axis; with a CONVECTIVE outlet, OPEN 6), and kernel
    1's masked mode on the cut operator's stencil code (Euler and base,
    gamma 0 and 0.2), against their plain versions."""
    ragged = dict(shape=(37, 19, 45), lengths=(8.0, 4.0, 4.0),
                  center=(2.0, 2.03, 1.97), diameter=1.6, device=DEV)
    e = {}
    for name, sim in (
            ("spin sphere", cases["spin sphere"].sim),
            ("sharp sphere", cases["sharp sphere"].sim),
            ("ragged spin cut", make_case(
                "sphere", ibm=True, spin=0.5, sharp_pressure=True,
                poisson_method="mg", **ragged).sim),
            ("ragged spin convective", make_case(
                "sphere", ibm=True, spin=0.5, outlet="convective",
                **ragged).sim)):
        key = ("correct_diag_3d coded" if "cut" not in name
               and "sharp" not in name else "correct_diag_3d coded cut")
        e[name] = compare_coded(sim, gen, errs, key)
    sim = cases["sharp sphere"].sim
    for gamma in (0.0, 0.2):
        for based in (False, True):
            e[f"cut code g{gamma}{' base' if based else ''}"] = \
                compare_open_3d(sim.grid, sim.bcs, gamma, gen, errs,
                                code=sim.op.code, based=based,
                                key=SPHERE_MODES)
    torch.cuda.synchronize()
    line("phase2", sharp_modes=json.dumps(e))


def sharp_steps_vs_plain(cases) -> None:
    """Phase 3 of the sharp-interface slice: 5 Euler, 5 rk2 and 5 cfl 0.4
    steps (a cap of 10x the case's dt) of each sphere from the impulsive
    start, kernels against step_plain: u (2e-5, 2e-6), p within 1e-4 of
    max|p|, solve counts within one a solve (two under rk2: two solves),
    max_div of both below 1e-3; the cut cylinder in
    :func:`cut_cylinder_vs_plain`."""
    for name, case in cases.items():
        if "cylinder" in name:
            cut_cylinder_vs_plain(name, case)
            continue
        st0 = impulsive_start_state(case.sim)
        for what, c in (("euler", case),) + integrator_modes(case):
            steps_vs_plain(c, f"{name} {what}", (2e-5, 2e-6), (2e-4, None),
                           state=st0, count_slack=2 if what == "rk2" else 1)


def cut_cylinder_vs_plain(name, case) -> None:
    """Phase 3 of the cut-cell cylinder at its timed 2048x1024:
    CUT_CYLINDER_STEPS Euler, rk2 and cfl 0.4 steps of the kernel run from
    the impulsive start, each beside step_plain from the same state. The
    two differ
    in kernel 8 alone (the cut V-cycle runs plain torch in both), and the
    V-cycle stops on its stagnation rule at float32's floor, above tol: a
    rounding-level change of u* moves the cycle counts and p's slowest
    mode. So the gates hold what does not go through the solve: the kernel
    step run on step_plain's solves (their outputs replayed in order, so p
    is shared) against step_plain, every solve's RHS within what kernel
    8's tolerance makes of it through the stencil, (rho/dt) sum_a 2/h_a
    (2e-6 + 2e-5 max|u|) (rk2: dt/2), u within (2e-5, 2e-6) and dt within
    rtol 3e-5; and every real step's max_div, kernel and plain, within
    dt/rho ||b - A p||_2 + 1e-3 (:func:`step_div_bound`). Each step's p
    gap and solve counts, kernel against plain on their own solves, are
    recorded beside the witness (the Euler run): step_plain from the state
    nudged up one float32 ulp, against step_plain."""
    for what, c in (("euler", case),) + integrator_modes(case):
        sim = c.sim
        g, rho = sim.grid, sim.params.rho
        tag = f"{name} {what}"
        st = impulsive_start_state(sim)
        shared = {"u": 0.0, "rhs": 0.0}
        rows = []
        for i in range(CUT_CYLINDER_STEPS[what]):
            st_p, d_p, bound_p, _, solves = step_div_bound(sim, st,
                                                           plain=True)
            st_r, d_r, _, _, replayed = step_div_bound(sim, st,
                                                       replay=solves)
            u_max = max(float(x.abs().max()) for x in st_p.u)
            dt_min = float(d_p.dt) / (2 if what == "rk2" else 1)
            rhs_atol = (rho / dt_min * sum(2 / h for h in g.spacing)
                        * (2e-6 + 2e-5 * u_max))
            for j, ((b_r, _), (b_p, _)) in enumerate(zip(replayed, solves)):
                shared["rhs"] = max(shared["rhs"], close(
                    f"{tag} step {i} solve {j} rhs", b_r, b_p, 0.0,
                    rhs_atol))
            close(f"{tag} step {i} dt", d_r.dt, d_p.dt, 3e-5, 0.0)
            shared["u"] = max(shared["u"], *(
                close(f"{tag} step {i} u[{a}] on shared solves", st_r.u[a],
                      st_p.u[a], 2e-5, 2e-6) for a in range(g.ndim)))
            st_k, d_k, bound_k, _, _ = step_div_bound(sim, st)
            for run, d, bound in (("kernel", d_k, bound_k),
                                  ("plain", d_p, bound_p)):
                if not float(d.max_div) <= bound:
                    raise AssertionError(
                        f"{tag} step {i} {run}: max_div {float(d.max_div)} "
                        f"above dt/rho ||b - A p|| + 1e-3 = {bound}")
            row = [int(d_k.poisson_iters), int(d_p.poisson_iters),
                   float((st_k.p - st_p.p).abs().max()),
                   max(float((st_k.u[a] - st_p.u[a]).abs().max())
                       for a in range(g.ndim)),
                   float(d_k.max_div), float(d_p.max_div), bound_k]
            if what == "euler":
                st_w, d_w = sim.step_plain(dataclasses.replace(st, u=tuple(
                    torch.nextafter(x, torch.full_like(x, math.inf))
                    for x in st.u)))
                row += [int(d_w.poisson_iters),
                        float((st_w.p - st_p.p).abs().max()),
                        max(float((st_w.u[a] - st_p.u[a]).abs().max())
                            for a in range(g.ndim))]
            rows.append(row)
            st = st_k
        line("phase3", case=json.dumps(tag), shape=_name(g.shape),
             integrator=sim.params.integrator, cfl=sim.params.cfl,
             steps=CUT_CYLINDER_STEPS[what],
             shared_solves_max_abs_err=json.dumps(shared),
             max_abs_p=float(st.p.abs().max()),
             per_step=json.dumps(rows), per_step_keys=json.dumps(
                 ["iters_kernel", "iters_plain", "p_gap", "u_gap",
                  "max_div_kernel", "max_div_plain", "bound_kernel"]
                 + (["iters_witness", "p_gap_witness", "u_gap_witness"]
                    if what == "euler" else [])))


def sharp_runs(cases, reset_all) -> dict:
    """Phase 4 of the sharp-interface slice: SHARP_STEPS Euler and rk2
    steps of each path from the impulsive start (after SHARP_WARMUP), ms a
    step, host syncs a step (timed_run's line) and, profiled on the IBM
    and the spinning spheres' Euler runs (3 steps), busy ms and idle
    share, launches a step and the device ms a step of the IBM forcing and
    the cut patches (step_profile's sharp_groups). The cut paths' plain
    V-cycles make ~4·10^4 launches a step on the sphere (the profiler took
    ~20 s to record one) and ~1.8·10^5 on the cylinder's first steps (~110
    s): their busy ms and idle share come from ``python -m
    navierstokessolver_tpu_torch.step_profile sphere 256 128 128 --ibm
    --sharp-pressure --poisson mgcg`` and ``... cylinder 2048 1024 --ibm
    --sharp-pressure --poisson mg``. Every path: the
    inflow flux equal to the outflow flux (within 1e-6 of it), a moving
    body's wet faces equal to ub_wet, and on one more step max|div u|
    (apertured on the cut paths) at or below dt/rho ||b - A p||_2 +
    SPHERE_DIV_FLOOR; then kernel 2's coded mode timed on the spinning
    and the cut sphere's states: events beside its plain version and
    bound, and by CUDA-graph replay over rotated inputs (its device
    time)."""
    counts = {"sphere": lambda: {k: fused3d.LAUNCHES[k] for k in (
                  "predictor_rhs_3d", "correct_diag_3d")},
              "cylinder": lambda: {"predictor_2d":
                                   predictor2d.LAUNCHES["predictor_2d"]}}
    out = {}
    for name, case in cases.items():
        dim = "cylinder" if "cylinder" in name else "sphere"
        st0 = impulsive_start_state(case.sim)
        for what, c in (("euler", case),
                        ("rk2", with_params(case, integrator="rk2"))):
            sim = c.sim
            r = timed_run(c, reset_all, counts[dim],
                          steps=SHARP_STEPS[name][what == "rk2"], state=st0,
                          warmup=SHARP_WARMUP)
            st = r["state"]
            prof = {}
            if what == "euler" and dim == "sphere" and \
                    name != "sharp sphere":
                n_prof = 3
                sharp = {}
                kernels, _, launches = device_profile(
                    lambda: sim.run_scan(st, n_prof), 1, sharp)
                busy = sum(kernels.values()) / n_prof
                prof = dict(busy_ms_per_step=f"{busy:.4f}",
                            idle_share=f"{max(0.0, 1.0 - busy / r['ms']):.4f}",
                            launches_per_step=launches / n_prof,
                            sharp_groups_ms_per_step=json.dumps(
                                {k: v / n_prof
                                 for k, v in sorted(sharp.items())}))
            q_in, q_out = (flux_2d if dim == "cylinder" else sphere_flux)(
                sim, st)
            if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
                raise AssertionError(f"{name} {what}: inflow {q_in} against "
                                     f"outflow {q_out}")
            st1, d1 = sim.run_scan(st, 1)
            if sim.ibm is not None and sim.ibm.wet is not None:
                for a, (w, ubw) in enumerate(zip(sim.ibm.wet,
                                                 sim.ibm.ub_wet)):
                    crop = st1.u[a]
                    for ax, (lo, size) in enumerate(zip(*sim.ibm.box[a])):
                        crop = crop.narrow(ax, lo, size)
                    if not torch.equal(crop[w > 0], ubw[w > 0]):
                        raise AssertionError(f"{name} {what}: wet faces of "
                                             f"u[{a}] differ from ub_wet")
            div = check_iterative(sim, st1, d1)
            left = div["div_bound"] - 1e-3     # dt/rho ||b - A p||_2
            if not div["next_max_div"] <= left + SPHERE_DIV_FLOOR:
                raise AssertionError(f"{name} {what}: max_div "
                                     f"{div['next_max_div']} above dt/rho "
                                     f"||b - A p|| = {left}")
            line("phase4", sharp=json.dumps(f"{name} {what}"),
                 ms_per_step=f"{r['ms']:.4f}", **prof,
                 kernel_launches_per_step=json.dumps(
                     {k: v / r["steps"] for k, v in r["launches"].items()}),
                 flux_in_out=json.dumps([q_in, q_out]),
                 max_div_next=div["next_max_div"], dt_over_rho_res_l2=left,
                 rel_res_next=div["next_res"])
            out[f"{name} {what}"] = r
    times, bounds, dev_ms = {}, {}, {}
    per = (False,) * 3
    for k, name in SHARP_MODES.items():
        sim = cases[name.rsplit(" ", 1)[0]].sim
        st = out[name]["state"]
        g, code = sim.grid, sim.corr_code
        us = sim.ibm.apply(st.u)
        scale = float(sim._dts(None)[2])
        cb = nbytes(*us, st.p, *us, code) + 8
        time_pairs({k: (
            lambda: fused3d.correct_diag_3d(g, us, st.p, scale, per,
                                            bcs=sim.bcs, code=code),
            lambda: fused3d.correct_diag_plain(g, us, st.p, scale, per,
                                               sim.bcs, code),
            cb, (OPS_PER_CELL["correct_diag_3d"] + MASK_OPS)
            * math.prod(g.shape))}, times, bounds)
        fns = [(lambda s_: lambda: fused3d.correct_diag_3d(
                    g, s_[:3], s_[3], scale, per, bcs=sim.bcs,
                    code=code))(s_)
               for s_ in rotated((*us, st.p), cb)]
        dev_ms[k] = time_graph_ms(fns)
        line("phase4", kernel=k, device_ms_graph=f"{dev_ms[k]:.4f}",
             event_ms=f"{min(times[k][0], times[k][3]):.4f}",
             host_us_per_call=f"{host_us(fns[0]):.1f}",
             bound_ms=f"{bounds[k][0]:.4f}",
             bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
             launches_per_step=out[name]["launches"]["correct_diag_3d"]
             / out[name]["steps"], input_sets=len(fns))
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


def cli_sharp(tmp, reset_all) -> None:
    """The slice's entry points through ``cli.main``: ``--case sphere
    --ibm --sharp-pressure --poisson mgcg`` at 128x64x64 (8 cells a
    diameter: each run builds the cut geometry and every level's operator
    anew, ~10 s at 256x128x128, which phases 2-4 run) and the cut cylinder
    ``--case cylinder --ibm --sharp-pressure --poisson mg`` (its default
    512x256): run A one window of 4 steps, run B 2 steps with a
    checkpoint, run C B resumed from it for 2 steps; C's final fields equal
    A's bit for bit; kernels 1-2 (the sphere) and kernel 8 (the cylinder)
    launched every step of A."""
    import os

    import numpy as np

    for name, flags, key, counter in (
            ("sphere", ["--case", "sphere", "--shape", "128,64,64", "--ibm",
                        "--sharp-pressure", "--poisson", "mgcg"],
             "correct_diag_3d",
             fused3d.LAUNCHES),
            ("cylinder", ["--case", "cylinder", "--ibm", "--sharp-pressure",
                          "--poisson", "mg"],
             "predictor_2d", predictor2d.LAUNCHES)):
        a, b = (os.path.join(tmp, f"sharp_{name}_{k}") for k in "ab")
        reset_all()
        wall = run_cli(*flags, "--steps", "4", "--chunk", "4",
                       "--checkpoint-every", "4", "--out", a)
        n = counter[key]
        if n != 4:
            raise AssertionError(f"CLI {name}: {key} launched {n} times in "
                                 "4 steps")
        run_cli(*flags, "--steps", "2", "--chunk", "2",
                "--checkpoint-every", "2", "--out", b)
        run_cli(*flags, "--steps", "2", "--chunk", "2",
                "--checkpoint-every", "2", "--out", b, "--resume",
                os.path.join(b, "ckpt.npz"))
        fa = _ckpt_fields(os.path.join(a, "ckpt.npz"))
        fc = _ckpt_fields(os.path.join(b, "ckpt.npz"))
        if int(fa["step"]) != 4 or int(fc["step"]) != 4:
            raise AssertionError(f"CLI {name}: steps {fa['step']}, "
                                 f"{fc['step']}")
        for k in fa:
            if k.startswith(("u", "p")) and not np.array_equal(fa[k], fc[k]):
                raise AssertionError(f"CLI {name}: resumed {k} differs")
        line("phase5", case=json.dumps(f"sharp {name}"), launches=n,
             resumed_equals_unbroken_bit_for_bit=True,
             wall_s_run_a=round(wall, 2))


# -- the heated-bodies slice: kernels 1-2's thermal and forced open modes -----

# the slice at full width: the heated sphere at JAX's published 256x128x128
# (Re 300, Pr 0.7, dctcg tol 1e-5, extrapolate 0.8: make_case("sphere",
# heated=True)) from the impulsive start with initial_state's theta, and
# heated_enclosure in 3D at 128^3 (JAX's defaults: Ra 1e4, Pr 0.71, mg,
# diameter 0.4; the sphere at ENCLOSURE_CENTER_3D); each timed run's
# steps (the enclosure's 3D V-cycles run plain levels: ~10^4 launches a
# step)
ENCLOSURE3D = dict(shape=(128, 128, 128), center=ENCLOSURE_CENTER_3D)
HEATED_STEPS = {"heated sphere": 20, "heated_enclosure": 3,
                "adiabatic sphere": 5, "open plume": 5}
# the new modes in the report with the run that launches them: kernel 2's
# thermal masked mode (the isothermal sphere; the same instantiation with
# the adiabatic body's flag), its thermal open mode and kernel 1's forced
# open and masked modes (the enclosure's buoyancy, the plume's)
HEATED_MODES = {
    "predictor_rhs_3d masked forced": "heated_enclosure euler",
    "predictor_rhs_3d masked forced base": "heated_enclosure rk2",
    "correct_diag_3d masked thermal": "heated sphere euler",
    "correct_diag_3d masked adiabatic": "adiabatic sphere euler",
    "predictor_rhs_3d open forced": "open plume euler",
    "predictor_rhs_3d open forced base": "open plume rk2",
    "correct_diag_3d open thermal": "open plume euler",
}
# LES with a body force, with a scalar and in 2D (ROADMAP item 5.5) at full
# width, the closure added as both CLIs add it (dataclasses.replace):
# decaying turbulence at 2048^2 (the case's defaults: rk2, fft with its
# circulant split; the static and the dynamic model) and 2D Kolmogorov
# flow at 2048^2 (the unfused route: kernel 8's wrap mode, the subgrid
# stress in its forcing volumes), the periodic duct at 512x128x128 (kernel
# 6's forced mode, the static force, axis 0 periodic), 3D Kolmogorov flow
# at 256^3 (a force volume, every axis periodic), the 3D heated cavity at
# 256^3, Ra 1e6 (buoyancy; kernel 2's thermal walls mode) and the heated
# sphere at 256x128x128 (a passive theta: kernels 7 open, 6 masked, 2
# masked-thermal); each with its start (the sphere's heated_start) and the
# integrators its timed runs take
LES_FORCED_PATHS = {
    "turbulence les": ("decaying_turbulence", dict(shape=SHAPE2),
                       dict(cs=LES_CS), ("rk2",)),
    "turbulence dynamic": ("decaying_turbulence", dict(shape=SHAPE2),
                           dict(model="dynamic"), ("rk2",)),
    "kolmogorov2d les": ("kolmogorov", dict(shape=SHAPE2, re=30.0,
                                            k_forcing=4), dict(cs=LES_CS),
                         ("rk2",)),
    "duct les": ("duct_periodic", dict(shape=(512, 128, 128),
                                       lengths=(4.0, 1.0, 1.0), re=100.0),
                 dict(cs=LES_CS), ("euler", "rk2")),
    "kolmogorov3d les": ("kolmogorov", dict(shape=SHAPE, re=30.0,
                                            k_forcing=4), dict(cs=LES_CS),
                         ("rk2",)),
    "heated_cavity3d les": ("heated_cavity", dict(shape=SHAPE, ra=1e6),
                            dict(cs=LES_CS), ("euler", "rk2")),
    "heated sphere les": ("sphere", dict(heated=True), dict(cs=LES_CS),
                          ("euler",)),
}
LES_FORCED_STEPS = 20          # each timed run of the slice
# the launch counters of the 2D LES step's path (the unfused route; its
# fft solve's residual is plain, as in JAX)
LES_PATH_2D = ("predictor_2d",)
# the new modes in the report with the run that launches them
LES_FORCED_MODES = {
    "predictor_3d forced": "duct les euler",
    "predictor_3d forced volume": "kolmogorov3d les rk2",
    "predictor_3d forced buoyancy": "heated_cavity3d les euler",
    "predictor_2d periodic": "turbulence les rk2",
}


def heated_start(sim):
    """The impulsive start with initial_state's theta (JAX's own heated
    sphere test's start)."""
    return dataclasses.replace(impulsive_start_state(sim),
                               theta=sim.initial_state().theta)


def heated_cases() -> dict:
    """The slice's paths: the heated sphere and the 3D enclosure at full
    width, and two variants that run the remaining new modes on the
    sphere's grid: the adiabatic sphere (the heated sphere with an
    insulated body, ``body_bc`` adiabatic, started from the heated
    sphere's state: its warm wake leaves, its body keeps its heat) and
    the open plume (the sphere's table and dctcg without the sphere, the
    scalar buoyant along axis 2, g beta 0.5: kernels 1-2's open modes with
    theta and the force)."""
    t0 = time.perf_counter()
    hs = make_case("sphere", heated=True, device=DEV)
    enc = make_case("heated_enclosure", device=DEV, **ENCLOSURE3D)
    sim = hs.sim
    insulated = dataclasses.replace(sim.scalar, body_bc=ScalarBC.adiabatic())
    adiabatic = dataclasses.replace(hs, sim=dataclasses.replace(
        sim, scalar=insulated, thermal=thermal_table(insulated, 3, DEV)))
    plume_cfg = dataclasses.replace(sim.scalar, buoyancy=(0.0, 0.0, 0.5),
                                    body_bc=None)
    plume = dataclasses.replace(hs, name="open plume", sim=Simulation.build(
        sim.grid, sim.bcs, sim.params, DEV, scalar=plume_cfg))
    cases = {"heated sphere": hs, "heated_enclosure": enc,
             "adiabatic sphere": adiabatic, "open plume": plume}
    for name, c in cases.items():
        if not c.sim.fused or c.sim.thermal is None:
            raise AssertionError(f"{name}: fused {c.sim.fused}")
    line("phase2", heated_build_s=f"{time.perf_counter() - t0:.2f}",
         enclosure_mg_levels=json.dumps(
             [list(o.diag.shape) for o in enc.sim.mg_solver.ops]))
    return cases


def compare_heated(grid, bcs, cfg, gen, errs, keys, code=None, based=False,
                   force=None, vols=None, dt=1e-3, frozen=True) -> tuple:
    """Kernel 1 (with theta's buoyancy where ``cfg`` is buoyant, ``force``
    and the forcing volumes ``vols``; ``based``: rk2's base form) and
    kernel 2 advancing theta with open faces (``code``: an obstacle, the
    masked mode) against their plain versions on random O(1) states that
    keep the step's invariant (boundary values and blocked faces set;
    theta uniform on [0, 1), an isothermal body's cells at its value, or
    left random where ``frozen`` is False: the kernel reads the body's
    value across a closed face whatever the solid cells hold):
    compare_kernels' tolerances, theta within THETA_ULPS ulps of
    max|theta|, the solid cells of theta exactly the body's value
    (isothermal) or their own (adiabatic). ``keys``: the errs entries of
    the two kernels' modes. Returns (predictor error, corrector error,
    theta error in ulps of max|theta|)."""
    nu, rho = 0.02, 1.3
    fm = None if code is None else fused3d.masks_from_code(grid, code)[0]

    def state():
        return apply_velocity_bcs(grid, bcs, [
            torch.randn(grid.face_shape(a), generator=gen, device=DEV)
            for a in range(3)], fm)
    u = state()
    base = state() if based else None
    theta = torch.rand(grid.shape, generator=gen, device=DEV)
    solid = None if code is None else ((code >> 6) & 1) == 0
    if solid is not None and frozen:
        theta = freeze_body(cfg, theta, solid)
    th_pred = theta if cfg.buoyant else None
    k_u, k_rhs = fused3d.predictor_rhs_3d(
        grid, bcs, u, dt, nu, cfg.upwind_gamma, rho, base=base, code=code,
        theta=th_pred, scalar=cfg, force=force, force_vol=vols)
    forcing = combined_forcing(
        fused3d.plain_forcing(force, vols, 3),
        buoyancy_forcing(grid, cfg, theta))
    p_u, p_rhs = fused3d.predictor_rhs_plain(
        grid, bcs, u, dt, nu, cfg.upwind_gamma, rho, forcing=forcing,
        base=base, code=code)
    e1 = max(close(f"heated u*[{a}]", k_u[a], p_u[a], 1e-5, 1e-5)
             for a in range(3))
    e1 = max(e1, close("heated rhs", k_rhs, p_rhs, 1e-4,
                       3e-7 * float(p_rhs.abs().max())))
    p = torch.randn(grid.shape, generator=gen, device=DEV)
    per = (False,) * 3
    k_n, k_div, k_vel, k_th = fused3d.correct_diag_3d(
        grid, k_u, p, dt / rho, per, theta=theta, scalar=cfg, dt=dt,
        bcs=bcs, code=code)
    p_n, p_div, p_vel, p_th = fused3d.correct_diag_thermal_plain(
        grid, k_u, p, dt / rho, per, theta, cfg, dt, bcs, code)
    e2 = max(close(f"heated u_new[{a}]", k_n[a], p_n[a], 1e-5, 1e-5)
             for a in range(3))
    e2 = max(e2, close("heated max_div", k_div, p_div, 1e-4, 0.0))
    e2 = max(e2, close("heated max_vel", k_vel, p_vel, 1e-4, 0.0))
    et = close("heated theta", k_th, p_th, 0.0, theta_atol(p_th))
    if solid is not None and bool(solid.any()):
        held = freeze_body(cfg, theta, solid)
        if not torch.equal(k_th[solid], held[solid]):
            raise AssertionError("heated theta: the solid cells moved")
    errs[keys[0]] = max(errs.get(keys[0], 0.0), e1)
    errs[keys[1]] = max(errs.get(keys[1], 0.0), max(e2, et))
    return e1, max(e2, et), et / (2.0 ** -23 * max(float(p_th.abs().max()),
                                                  1.0))


def check_heated_modes(cases, gen, errs) -> None:
    """Phase 2 of the heated-bodies slice: kernels 1-2's forced and
    thermal open modes against their plain versions. On the ragged walls'
    shape (RAGGED_WALL): open faces of every kind (open_faces_bcs, OUTFLOW
    at (0, 1) and (1, 1)) with a buoyant scalar (thermal_scalar's faces,
    buoyancy (0.3, 0, 1)), also with the static force and with forcing
    volumes, Euler and rk2's base; the sphere's table with blocks_solid's
    obstacle and an isothermal body (theta 1.3) and an adiabatic one, each
    at gamma 0 and 0.3, Euler and base, and the isothermal body once with
    random solid cells. At full width: the heated
    sphere's own table, code and scalar (kernel 2's thermal masked mode;
    its predictor the masked mode) and the enclosure's at 128^3 (kernel
    1's forced masked mode, Euler and base)."""
    rag = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    hs = cases["heated sphere"].sim
    enc = cases["heated_enclosure"].sim
    code_rag = build_poisson_op(rag, hs.bcs, DEV,
                                blocks_solid(RAGGED_WALL)).code
    dt, nu = 1e-3, 0.02
    alpha = 0.2 * min(rag.spacing) ** 2 / dt
    e = {}
    open_keys = ("predictor_rhs_3d open forced",
                 "correct_diag_3d open thermal")
    for gamma in (0.0, 0.3):
        cfg = thermal_scalar(3, (False,) * 3, (0.3, 0.0, 1.0), gamma, alpha)
        for based in (False, True):
            keys = (open_keys[0] + (" base" if based else ""), open_keys[1])
            e[f"open g{gamma}{' base' if based else ''}"] = compare_heated(
                rag, open_faces_bcs(), cfg, gen, errs, keys, based=based)
    vols = random_volumes(rag, (False,) * 3, gen, (0, 2))
    e["open force"] = compare_heated(rag, open_faces_bcs(), cfg, gen, errs,
                                     open_keys, force=FORCE3)
    e["open volumes base"] = compare_heated(
        rag, open_faces_bcs(), cfg, gen, errs,
        (open_keys[0] + " base", open_keys[1]), based=True, vols=vols)
    for body, kc in (
            (ScalarBC.dirichlet(1.3), "correct_diag_3d masked thermal"),
            (ScalarBC.adiabatic(), "correct_diag_3d masked adiabatic")):
        for gamma in (0.0, 0.3):
            cfg = dataclasses.replace(
                thermal_scalar(3, (False,) * 3, (0.3, 0.0, 1.0), gamma,
                               alpha), body_bc=body)
            for based in (False, True):
                kp = "predictor_rhs_3d masked forced" + (
                    " base" if based else "")
                e[f"{kc.split()[-1]} g{gamma}{' base' if based else ''}"] = \
                    compare_heated(rag, hs.bcs, cfg, gen, errs, (kp, kc),
                                   code=code_rag, based=based)
    # an isothermal body whose solid cells do not hold its value on entry
    cfg = dataclasses.replace(thermal_scalar(
        3, (False,) * 3, (0.3, 0.0, 1.0), 0.3, alpha),
        body_bc=ScalarBC.dirichlet(1.3))
    e["thermal unfrozen"] = compare_heated(
        rag, hs.bcs, cfg, gen, errs, ("predictor_rhs_3d masked forced",
                                      "correct_diag_3d masked thermal"),
        code=code_rag, frozen=False)
    # the paths' own tables, codes and scalars at full width (their dt)
    e["heated sphere"] = compare_heated(
        hs.grid, hs.bcs, hs.scalar, gen, errs,
        ("predictor_rhs_3d masked", "correct_diag_3d masked thermal"),
        code=hs.op.code, dt=hs.params.dt)
    for based in (False, True):
        e[f"enclosure{' base' if based else ''}"] = compare_heated(
            enc.grid, enc.bcs, enc.scalar, gen, errs,
            ("predictor_rhs_3d masked forced" + (" base" if based else ""),
             "correct_diag_3d masked thermal"), code=enc.op.code,
            based=based, dt=enc.params.dt)
    torch.cuda.synchronize()
    line("phase2", heated_modes_err_pred_corr_theta_ulps=json.dumps(e))


def heated_steps_vs_plain(cases) -> None:
    """Phase 3 of the heated-bodies slice: 5 Euler, 5 rk2 and 5 cfl 0.4
    steps of the heated sphere (from heated_start) and of the enclosure
    (from its initial state) against step_plain: the sphere's tolerances
    (u 2e-5 / 2e-6, p 1e-4 of max|p|, sweeps within one), the enclosure's
    p within 1e-2 of max|p| (mg stops at the float32 floor, as the 2D
    enclosure's does) and its CFL dt capped at 1.5x its dt (the diffusive
    limit's half), theta within THETA_ULPS ulps of max|theta|."""
    for name in ("heated sphere", "heated_enclosure"):
        case = cases[name]
        st0 = (heated_start(case.sim) if name == "heated sphere"
               else case.initial_state())
        p_rel = 1e-4 if name == "heated sphere" else 1e-2
        modes = integrator_modes(case)
        if name == "heated_enclosure":
            # its dt is the diffusive limit's half: a cap of 1.5x (10x
            # runs theta past it, as the time-dependent paths' cap does)
            modes = (modes[0], ("cfl", with_params(
                case, cfl=0.4, dt=1.5 * case.sim.params.dt)))
        for what, c in (("euler", case),) + modes:
            steps_vs_plain(c, f"{name} {what}", (2e-5, 2e-6), (2e-4, None),
                           state=st0, count_slack=1, p_rel=p_rel,
                           theta_rel=THETA_ULPS * 2.0 ** -23)


def heated_runs(cases, reset_all) -> dict:
    """Phase 4 of the heated-bodies slice: HEATED_STEPS timed Euler and
    rk2 steps of each path (the heated sphere from heated_start, the
    enclosure from its initial state, the adiabatic sphere and the open
    plume from the heated sphere's state after its Euler run; after 10
    warm-up steps, 1 for the enclosure), ms a step, host syncs a step and,
    over profiled steps (5; the enclosure's Euler run 1, its rk2 run
    none: its plain V-cycle levels make ~7·10^4 launches a rk2 step, which
    the profiler takes ~50 s to record; PERF.md §5 has its reading), busy
    ms, idle share and launches a step; the gates: every counter > 0,
    finite fields and theta, the isothermal body's cells exactly 1.0,
    theta downstream of the sphere above 1e-3 (JAX's own test's), w above the enclosure's body
    above 1e-5, an adiabatic body's cells where they were, the inflow flux
    equal to the outflow flux (the spheres) and, on one more step,
    max|div u| at or below what the solve's residual leaves (dt/rho ||b -
    A p||_2 + SPHERE_DIV_FLOOR); rk2 and the CFL dt make no more host
    syncs a pressure solve than Euler (rk2 solves twice a step). The
    sphere's body_heat_flux is printed as a Nusselt number (Q / (pi D
    alpha dT)), without a gate. Then the new modes' times on the runs'
    states: events beside their plain versions and bounds, and by
    CUDA-graph replay over rotated inputs (their device time). Returns the
    runs with the modes' times and bounds."""
    counts = lambda: {k: fused3d.LAUNCHES[k]  # noqa: E731
                      for k in ("predictor_rhs_3d", "correct_diag_3d")}
    out = {}
    for name in ("heated sphere", "heated_enclosure", "adiabatic sphere",
                 "open plume"):
        case = cases[name]
        sim = case.sim
        if name == "heated sphere":
            st0 = heated_start(sim)
        elif name == "heated_enclosure":
            st0 = case.initial_state()
        else:
            st0 = out["heated sphere euler"]["state"]
            if name == "open plume":   # the fluid's fields, no body
                st0 = dataclasses.replace(
                    heated_start(sim), theta=st0.theta)
        enc = name == "heated_enclosure"
        syncs = {}
        for what, c in (("euler", case),
                        ("rk2", with_params(case, integrator="rk2"))):
            sim = c.sim
            r = timed_run(c, reset_all, counts, steps=HEATED_STEPS[name],
                          state=st0, warmup=1 if enc else 10)
            st = r["state"]
            if st.theta is None or not bool(torch.isfinite(st.theta).all()):
                raise AssertionError(f"{name} {what}: theta not finite")
            # the enclosure's plain V-cycle levels make ~4·10^4 launches a
            # Euler step, ~7·10^4 a rk2 one (~20 s and ~50 s for the
            # profiler to record): its Euler step alone is profiled, to
            # keep the script within its run time
            per_step, busy = (None, None) if enc and what == "rk2" else \
                profile_launches(sim, st, 1 if enc else 5)
            gates = {}
            solid = sim.scalar_solid
            if name in ("heated sphere", "heated_enclosure"):
                if not bool((st.theta[solid] == 1.0).all()):
                    raise AssertionError(f"{name} {what}: the isothermal "
                                         "body's cells moved off 1.0")
            if name == "heated sphere":
                # the row through the sphere's centre (4, 4, 4) from the
                # first cell behind its back (x = 4.5)
                h = sim.grid.spacing
                down = st.theta[int(4.5 / h[0]) + 1:, int(4.0 / h[1]),
                                int(4.0 / h[2])]
                gates["theta_downstream_max"] = float(down.max())
                if not gates["theta_downstream_max"] > 1e-3:
                    raise AssertionError(f"{name} {what}: theta downstream "
                                         f"{gates['theta_downstream_max']}")
                q = float(body_heat_flux(sim.grid, sim.scalar, st.theta,
                                         solid))
                gates["nusselt"] = q / (math.pi * 1.0
                                        * sim.scalar.diffusivity * 1.0)
            if enc:
                n2 = sim.grid.shape[2]
                w = st.u[2][:, :, int(0.65 * n2) + 1:]   # above the body
                gates["w_above_body_max"] = float(w.abs().max())
                if not gates["w_above_body_max"] > 1e-5:
                    raise AssertionError(f"{name} {what}: w above the body "
                                         f"{gates['w_above_body_max']}")
            if name == "adiabatic sphere":
                if not torch.equal(st.theta[solid], st0.theta[solid]):
                    raise AssertionError(f"{name} {what}: the insulated "
                                         "body's cells moved")
            if not enc:
                q_in, q_out = sphere_flux(sim, st)
                if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
                    raise AssertionError(f"{name} {what}: inflow {q_in} "
                                         f"against outflow {q_out}")
                gates["flux_in_out"] = [q_in, q_out]
            st1, d1 = sim.run_scan(st, 1)
            div = check_iterative(sim, st1, d1)
            left = div["div_bound"] - 1e-3
            if not div["next_max_div"] <= left + SPHERE_DIV_FLOOR:
                raise AssertionError(f"{name} {what}: max_div "
                                     f"{div['next_max_div']} above dt/rho "
                                     f"||b - A p|| = {left}")
            syncs[what] = solve_syncs(sim, st, 1 if enc else 10)
            line("phase4", heated_slice=f"{name} {what}",
                 shape=_name(sim.grid.shape), ms_per_step=f"{r['ms']:.4f}",
                 busy_ms_per_step=("not measured" if busy is None
                                   else f"{busy:.4f}"),
                 idle_share=("not measured" if busy is None else
                             f"{max(0.0, 1.0 - busy / r['ms']):.4f}"),
                 launches_per_step=per_step,
                 syncs_per_step_solve_checks=json.dumps(syncs[what]),
                 kernel_launches_per_step=json.dumps(
                     {k: v / r["steps"] for k, v in r["launches"].items()}),
                 max_div_next=div["next_max_div"], dt_over_rho_res_l2=left,
                 rel_res_next=div["next_res"], **{
                     k: json.dumps(v) for k, v in gates.items()})
            out[f"{name} {what}"] = r
        if name in ("heated sphere", "heated_enclosure"):
            # rk2 and the CFL dt read the host nowhere but in the solves'
            # stopping tests, as Euler
            cfl = with_params(case, cfl=0.4, dt=case.sim.params.dt)
            syncs["cfl"] = solve_syncs(cfl.sim, st0, 1 if enc else 10)
            if any(n > checks for n, checks in syncs.values()):
                raise AssertionError(f"{name}: host syncs a step beyond the "
                                     f"solves' checks {syncs}")
            line("phase4", heated_slice=f"{name} syncs",
                 syncs_solve_checks_per_step_euler_rk2_cfl=json.dumps(syncs))
    times, bounds, dev_ms = {}, {}, {}
    for k, run in HEATED_MODES.items():
        time_heated_mode(k, cases[run.rsplit(" ", 1)[0]].sim,
                         out[run]["state"], out.get(
                             run.rsplit(" ", 1)[0] + " rk2")["state"],
                         times, bounds, dev_ms)
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


def time_heated_mode(k, sim, st, base_state, times, bounds, dev_ms) -> None:
    """Mode ``k`` of HEATED_MODES on its path's state ``st`` (the base form
    anchored at ``base_state``'s velocity): by events beside its plain
    version and bound (time_pairs), by graph replay over rotated inputs,
    and the host's microseconds a call. Bytes: each input read once, each
    output written once (the stencil code a byte a cell, theta read by
    kernel 1, read and written by kernel 2, the buffers)."""
    g, bcs, pr, cfg = sim.grid, sim.bcs, sim.params, sim.scalar
    code = sim._code
    dts = sim._dts(None)
    per = (False,) * 3
    cells = math.prod(g.shape)
    masked = code is not None
    code_bytes = nbytes(code) if masked else 0
    if k.startswith("predictor"):
        # the forced modes of these paths: theta's buoyancy
        based = k.endswith("base")
        base = tuple(base_state.u) if based else ()

        def kern(s_):
            return lambda: fused3d.predictor_rhs_3d(
                g, bcs, s_[:3], dts[0], pr.nu, pr.upwind_gamma, pr.rho,
                bc=sim.bc, dts=dts, base=s_[3:6] if based else None,
                theta=s_[-1], scalar=cfg, thermal=sim.thermal, code=code)
        forcing = buoyancy_forcing(g, cfg, st.theta)

        def plain():
            return fused3d.predictor_rhs_plain(
                g, bcs, st.u, float(dts[0]), pr.nu, pr.upwind_gamma, pr.rho,
                forcing=forcing, base=base or None, code=code)
        inputs = (*st.u, *base, st.theta)
        us, rhs = kern(inputs)()
        nb = nbytes(*inputs, *us, rhs, sim.bc, sim.thermal) + code_bytes
        ops = (OPS_PER_CELL["predictor_rhs_3d"]
               + FORCE_OPS["predictor_rhs_3d"]
               + THERMAL_OPS["predictor_rhs_3d"]
               + (MASK_OPS if masked else 0)) * cells
    else:
        us, _ = fused3d.predictor_rhs_3d(
            g, bcs, st.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho, bc=sim.bc,
            dts=dts, theta=st.theta if cfg.buoyant else None, scalar=cfg,
            thermal=sim.thermal, code=code)

        def kern(s_):
            return lambda: fused3d.correct_diag_3d(
                g, s_[:3], s_[3], dts[2], per, theta=s_[4], scalar=cfg,
                dt=dts[0], thermal=sim.thermal, bcs=bcs, code=code)

        def plain():
            return fused3d.correct_diag_thermal_plain(
                g, us, st.p, float(dts[2]), per, st.theta, cfg,
                float(dts[0]), bcs, code)
        inputs = (*us, st.p, st.theta)
        nb = (nbytes(*inputs, *us, st.theta, sim.thermal) + 8
              + code_bytes)
        ops = (OPS_PER_CELL["correct_diag_3d"]
               + THERMAL_OPS["correct_diag_3d"]
               + (MASK_OPS if masked else 0)) * cells
    time_pairs({k: (kern(inputs), plain, nb, ops)}, times, bounds)
    fns = [kern(s_) for s_ in rotated(inputs, nb)]
    dev_ms[k] = time_graph_ms(fns)
    line("phase4", kernel=k, device_ms_graph=f"{dev_ms[k]:.4f}",
         event_ms=f"{min(times[k][0], times[k][3]):.4f}",
         host_us_per_call=f"{host_us(fns[0]):.1f}",
         bound_ms=f"{bounds[k][0]:.4f}",
         bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
         input_sets=len(fns))


# -- LES with a body force, with a scalar and in 2D: kernel 6's forced mode,
# kernel 8's wrap modes ---------------------------------------------------------


def les_forced_cases(gen) -> dict:
    """The slice's paths at full width (LES_FORCED_PATHS), each with its
    start and its no-LES twin (the case as built, without ``les``; in 2D
    on the fused route, where ``dataclasses.replace`` with ``les`` moves
    the LES path off it): the 2D paths on the unfused route, the 3D ones
    on kernels 6-7. The starts: the heated sphere's heated_start, the
    case's own for the decaying turbulence and the heated cavity, and for
    the forced flows, whose laminar start from rest has no strain off the
    forced profile, the case's start plus O(0.05) seeded noise with the BC
    values (``perturbed``)."""
    t0 = time.perf_counter()
    out = {}
    for what, (name, kw, les, _) in LES_FORCED_PATHS.items():
        c = make_case(name, device=DEV, **kw)
        les_c = dataclasses.replace(c, sim=dataclasses.replace(
            c.sim, les=LESConfig(**les)))
        st0 = (heated_start(les_c.sim) if name == "sphere" else
               perturbed(c, gen) if c.sim.forcing is not None else
               c.initial_state())
        if les_c.sim.fused != (les_c.sim.grid.ndim == 3):
            raise AssertionError(f"{what}: route fused={les_c.sim.fused}")
        out[what] = (les_c, st0, c)
    line("phase2", les_forced_build_s=f"{time.perf_counter() - t0:.2f}")
    return out


def check_les_forced_modes(cases, gen, errs) -> None:
    """Phase 2 of the slice. Kernel 8's wrap modes (periodic rows, lanes,
    both; with and without forcing volumes; gamma 0 and 0.8) on PER_P2's
    ragged shapes and at 2048^2 with the decaying turbulence's two
    subgrid volumes (its own table, state and dt) and Kolmogorov's force
    plus subgrid volume. Kernel 6's forced mode in every periodic mask on
    RAGGED_PER (the static force and volumes; gamma 0 and 0.8), with
    buoyancy on the walls of RAGGED_WALL, and on the paths' own tables at
    full width (the duct's static force, 3D Kolmogorov's volume, the 3D
    heated cavity's buoyancy of a random theta)."""
    e = {}
    for shape in ((994, 1002), (37, 61), (20, 14)):
        # h = 1/32 on both axes: u* stays O(1) (the 2D kernels' checks)
        grid = GridSpec(shape, (shape[0] / 32, shape[1] / 32))
        for per in ((True, False), (False, True), (True, True)):
            bcs = periodic_2d_bcs(grid, per)
            for with_vols in (False, True):
                vols = (random_volumes(grid, per, gen, (0, 1))
                        if with_vols else None)
                for gamma in (0.0, 0.8):
                    what = f"{_name(shape)} {per} v{with_vols:d} g{gamma}"
                    e[f"k8 {what}"] = compare_forced_unfused(
                        grid, bcs, 0.01, 0.005, gamma, gen, errs, vols, what,
                        "predictor_2d periodic")
    for what in ("turbulence les", "kolmogorov2d les"):
        c, st0, _ = cases[what]
        sim = c.sim
        sgs = sgs_forcing(sim.grid, sim.bcs, st0.u, sim.les)
        f = sim.force_vol or (None, None)
        vols = tuple(s if v is None else v + s for v, s in zip(f, sgs))
        e[what] = compare_forced_unfused(
            sim.grid, sim.bcs, float(sim.params.dt), sim.params.nu,
            sim.params.upwind_gamma, gen, errs, vols, what,
            "predictor_2d periodic")
    rag_p = GridSpec(RAGGED_PER, (1.0, 0.6, 1.8))
    for mask in range(8):
        bcs = no_slip_box(rag_p)
        bcs[(1, 1) if mask != 2 else (0, 1)] = BCSpec.wall((0.7, 0.1, 0.2))
        per = tuple(bool((mask >> a) & 1) for a in range(3))
        for a in range(3):
            if per[a]:
                bcs[(a, 0)] = bcs[(a, 1)] = BCSpec.periodic()
        for gamma in (0.0, 0.8):
            e[f"k6 mask{mask} g{gamma}"] = compare_les_modes(
                rag_p, bcs, gamma, gen, errs,
                ("nu_t_3d", "predictor_3d forced"), force=FORCE3)
            e[f"k6 mask{mask} vols g{gamma}"] = compare_les_modes(
                rag_p, bcs, gamma, gen, errs,
                ("nu_t_3d", "predictor_3d forced volume"),
                vols=random_volumes(rag_p, per, gen, (0, 2)))
    rag = GridSpec(RAGGED_WALL, (1.0, 0.6, 1.8))
    for gamma in (0.0, 0.8):
        cfg = thermal_scalar(3, (False,) * 3, (0.3, 0.0, 1.0), gamma)
        theta = torch.rand(rag.shape, generator=gen, device=DEV)
        e[f"k6 buoyancy g{gamma}"] = compare_les_modes(
            rag, no_slip_box(rag), gamma, gen, errs,
            ("nu_t_3d", "predictor_3d forced buoyancy"), force=FORCE3,
            theta=theta, scalar=cfg)
    for what, key, kw in (
            ("duct les", "predictor_3d forced", "force"),
            ("kolmogorov3d les", "predictor_3d forced volume", "vols"),
            ("heated_cavity3d les", "predictor_3d forced buoyancy",
             "theta")):
        sim = cases[what][0].sim
        args = {"force": dict(force=sim._force_numbers(sim.forcing)),
                "vols": dict(vols=sim.force_vol),
                "theta": dict(theta=torch.rand(
                    sim.grid.shape, generator=gen, device=DEV),
                    scalar=sim.scalar)}[kw]
        e[what] = compare_les_modes(sim.grid, sim.bcs,
                                    sim.params.upwind_gamma, gen, errs,
                                    ("nu_t_3d", key), **args)
    torch.cuda.synchronize()
    line("phase2", les_forced_modes=json.dumps(e))


def les_forced_steps_vs_plain(cases) -> None:
    """Phase 3 of the slice: 5 Euler, 5 rk2 and 5 cfl 0.4 steps of each
    path from its start, kernels against step_plain: u atol 5e-5 (the LES
    steps' bound), p within 2e-4 of max|p| in 2D (the 2 pi box amplifies
    the divergence's roundoff, as on the periodic 2D paths) and 1e-4 in
    3D, or twice the p gap of step_plain from the start one ulp up where
    that is larger (the forced boxes' small-dt steps: rho/dt carries u's
    roundoff into a p of ~1e-3), theta within THETA_ULPS ulps of
    max|theta|, the sphere's sweeps within one a step; the CFL dt capped
    at 10x the case's dt for the decaying turbulence and the sphere, 1.5x
    for the forced and heated boxes (their dt a fraction of their
    diffusive limit)."""
    for what, (c, st0, _) in cases.items():
        sim = c.sim
        slack = 1 if sim.dctcg_solver is not None else 0
        heated = sim.scalar is not None
        # the forced and heated boxes' dt is a fraction of their diffusive
        # limit (0.3 of it for Kolmogorov): a cap of 1.5x, as the forcing
        # slice's time-dependent paths (10x ran 2D Kolmogorov past it,
        # max|div u| ~2e-3 in both kernel and plain steps)
        cap = 10.0 if what.startswith(("turbulence", "heated sphere")) \
            else 1.5
        modes = (("euler", with_params(c, integrator="euler")),
                 ("rk2", with_params(c, integrator="rk2")),
                 ("cfl", with_params(c, cfl=0.4, dt=cap * sim.params.dt)))
        for mode, cm in modes:
            steps_vs_plain(cm, f"{what} {mode}", (0.0, 5e-5), (2e-4, None),
                           state=st0, count_slack=slack,
                           p_rel=2e-4 if sim.grid.ndim == 2 else 1e-4,
                           theta_rel=THETA_ULPS * 2.0 ** -23 if heated
                           else None, p_witness=True)


def les_forced_runs(cases, reset_all) -> dict:
    """Phase 4 of the slice: LES_FORCED_STEPS timed steps of each path
    under the integrators LES_FORCED_PATHS gives it (after 10 warm-up
    steps), ms a step, busy ms a step over 5 profiled steps, the idle
    share, launches a step and synchronizing calls a step; the gates:
    every counter of the path > 0 (LES_PATH_2D in 2D, LES_PATH's in 3D),
    finite fields, the direct solve's max|div u| < 1e-3 (timed_run), the
    heated sphere's inflow flux equal to its outflow flux; and the
    kinetic energy of the decaying and the Kolmogorov boxes after
    LES_FORCED_STEPS steps from their starts below their no-LES twins'
    (JAX's tests/test_les.py oracle; the dynamic model at most the twin's
    times 1 + 1e-6: 2D turbulence's backscatter clips its coefficient to
    0). Then the new modes' times on their runs' states: events beside
    their plain versions and bounds, and by CUDA-graph replay over rotated
    inputs. Returns the runs with the modes' times and bounds."""
    out = {}
    for what, (c, st0, twin) in cases.items():
        sim = c.sim
        keys = LES_PATH_2D if sim.grid.ndim == 2 else tuple(
            k for k in LES_PATH
            if (k != "residual_3d" or sim.dct_solver is not None)
            and (k != "nu_t_3d" or sim.les.model == "smagorinsky"))

        def counts(keys=keys):
            return {k: {**fused3d.LAUNCHES, **predictor3d.LAUNCHES,
                        **predictor2d.LAUNCHES}[k] for k in keys}
        for mode in LES_FORCED_PATHS[what][3]:
            cm = with_params(c, integrator=mode)
            r = timed_run(cm, reset_all, counts, steps=LES_FORCED_STEPS,
                          state=st0)
            st = r["state"]
            if st.theta is not None and not bool(
                    torch.isfinite(st.theta).all()):
                raise AssertionError(f"{what} {mode}: theta not finite")
            per_step, busy = profile_launches(cm.sim, st, 5)
            syncs = syncs_per_step(cm.sim, st, 5)
            extra = {}
            if sim.face_masks is not None:
                q_in, q_out = sphere_flux(cm.sim, st)
                if not abs(q_out - q_in) <= 1e-6 * abs(q_in):
                    raise AssertionError(f"{what} {mode}: inflow {q_in} "
                                         f"against outflow {q_out}")
                extra["flux_in_out"] = json.dumps([q_in, q_out])
            line("phase4", les_forced=json.dumps(what), integrator=mode,
                 shape=_name(sim.grid.shape), ms_per_step=f"{r['ms']:.4f}",
                 busy_ms_per_step=f"{busy:.4f}",
                 idle_share=f"{max(0.0, 1.0 - busy / r['ms']):.4f}",
                 launches_per_step=per_step, syncs_per_step=syncs,
                 kernel_launches_per_step=json.dumps(
                     {k: v / LES_FORCED_STEPS
                      for k, v in r["launches"].items()}), **extra)
            out[f"{what} {mode}"] = r
    # the closure dissipates: the boxes keep less kinetic energy than their
    # no-LES twins after LES_FORCED_STEPS steps from the same start
    for what in ("turbulence les", "turbulence dynamic", "kolmogorov2d les",
                 "kolmogorov3d les"):
        c, st0, twin = cases[what]
        n = LES_FORCED_STEPS
        e_les = kinetic_energy(c.sim.grid, c.sim.run_scan(st0, n)[0].u)
        e_twin = kinetic_energy(c.sim.grid, twin.sim.run_scan(st0, n)[0].u)
        ok = (e_les <= e_twin * (1.0 + 1e-6) if what.endswith("dynamic")
              else e_les < e_twin)
        if not ok:
            raise AssertionError(f"{what}: kinetic energy with LES {e_les} "
                                 f"not below the twin's {e_twin}")
        line("phase4", les_forced=json.dumps(what), steps=n,
             kinetic_energy_start_les_twin=json.dumps(
                 [kinetic_energy(c.sim.grid, st0.u), e_les, e_twin]))
    times, bounds, dev_ms = {}, {}, {}
    for k, run in LES_FORCED_MODES.items():
        what = run.rsplit(" ", 1)[0]
        time_les_forced_mode(k, cases[what][0].sim, out[run]["state"], times,
                             bounds, dev_ms)
    out["times"], out["bounds"], out["device_ms"] = times, bounds, dev_ms
    return out


def time_les_forced_mode(k, sim, st, times, bounds, dev_ms) -> None:
    """Mode ``k`` of LES_FORCED_MODES on its path's state ``st``: by events
    beside its plain version and bound (time_pairs), by graph replay over
    rotated inputs, and the host's microseconds a call. Bytes: each input
    read once, each output written once (kernel 6: u, nu_t, the forcing
    volume or theta, u*, the buffers; kernel 8: u, the two subgrid
    volumes (the force's plus the stress), u*, the ghost table)."""
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    dts = sim._dts(None)
    cells = math.prod(g.shape)
    if k.startswith("predictor_3d"):
        nu_t = predictor3d.nu_t_3d(g, bcs, st.u, sim.les, bc=sim.bc)
        force = sim._force_numbers(sim.forcing)
        buoy = sim.scalar is not None and sim.scalar.buoyant
        extra = (st.theta,) if buoy else tuple(
            v for v in sim.force_vol or () if v is not None)

        def kern(s_):
            vols = None
            if sim.force_vol is not None:
                it = iter(s_[4:])
                vols = tuple(None if v is None else next(it)
                             for v in sim.force_vol)
            return lambda: predictor3d.predictor_3d(
                g, bcs, s_[:3], dts[0], pr.nu, pr.upwind_gamma, nu_t=s_[3],
                bc=sim.bc, force=force, force_vol=vols,
                theta=s_[4] if buoy else None, scalar=sim.scalar,
                thermal=sim.thermal)
        forcing = fused3d.plain_forcing(force, sim.force_vol, 3)
        if buoy:
            forcing = combined_forcing(forcing, buoyancy_forcing(
                g, sim.scalar, st.theta))

        def plain():
            return predictor3d.predictor_3d_plain(
                g, bcs, st.u, float(dts[0]), pr.nu, pr.upwind_gamma,
                nu_t=nu_t, forcing=forcing)
        inputs = (*st.u, nu_t, *extra)
        us = kern(inputs)()
        nb = nbytes(*inputs, *us, sim.bc) + (nbytes(sim.thermal) if buoy
                                              else 0)
        ops = (OPS_PER_CELL["predictor_3d"] + FORCE_OPS["predictor_3d"]
               + (THERMAL_OPS["predictor_rhs_3d"] if buoy else 0)) * cells
    else:
        sgs = sgs_forcing(g, bcs, st.u, sim.les)
        f = sim.force_vol or (None, None)
        vols = tuple(s if v is None else v + s for v, s in zip(f, sgs))

        def kern(s_):
            return lambda: predictor2d.predictor_2d(
                g, bcs, s_[:2], dts[0], pr.nu, pr.upwind_gamma,
                ghosts=sim.ghosts, forcing=s_[2:])

        def plain():
            return predictor2d.predictor_2d_plain(
                g, bcs, st.u, float(dts[0]), pr.nu, pr.upwind_gamma, vols)
        inputs = (*st.u, *vols)
        us = kern(inputs)()
        nb = nbytes(*inputs, *us, sim.ghosts)
        ops = (OPS_PER_CELL["predictor_2d"] + FORCE_OPS["predictor_2d"]) \
            * cells
    time_pairs({k: (kern(inputs), plain, nb, ops)}, times, bounds)
    fns = [kern(s_) for s_ in rotated(inputs, nb)]
    dev_ms[k] = time_graph_ms(fns)
    line("phase4", kernel=k, device_ms_graph=f"{dev_ms[k]:.4f}",
         event_ms=f"{min(times[k][0], times[k][3]):.4f}",
         host_us_per_call=f"{host_us(fns[0]):.1f}",
         bound_ms=f"{bounds[k][0]:.4f}",
         bound_share=f"{bounds[k][0] / dev_ms[k]:.3f}",
         input_sets=len(fns))


def solve_syncs(sim, state, steps) -> tuple:
    """(synchronizing calls a step of ``run_scan`` from ``state``, as
    syncs_per_step counts them; the pressure solves' own host checks a
    step in the same steps, ops/poisson.HOST_SYNCS: an iterative solve
    reads its stopping test on the host once an iteration)."""
    import warnings

    st, _ = sim.run_scan(state, 1)
    torch.cuda.synchronize()
    poisson.reset_host_syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run_scan(st, steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum("called a synchronizing" in str(w.message) for w in caught)
    return n / steps, poisson.HOST_SYNCS["poisson"] / steps


# -- the adjoint phase: gradients through run_scan (adjoint.py) ----------------

# (path, steps) of the adjoint phase: the flagship and mgcg at 2048^2, the
# cavity at 256^3 under Euler and rk2, the sphere at 256x128x128 (dctcg, tol
# 1e-5); each path's counters must move in its differentiable run
ADJOINT_STEPS = {"cavity 2048^2 fft": 4, "cavity3d 256^3 fft": 2,
                 "cavity3d 256^3 fft rk2": 1, "sphere dctcg": 2,
                 "cavity 2048^2 mgcg": 1, "cavity 512^2 cg": 1}
ADJOINT_KEYS = {
    "cavity 2048^2 fft": ("predictor_rhs_2d", "correct_diag_2d"),
    "cavity3d 256^3 fft": ("predictor_rhs_3d", "residual_3d",
                           "correct_diag_3d"),
    "cavity3d 256^3 fft rk2": ("predictor_rhs_3d", "residual_3d",
                               "correct_diag_3d"),
    "sphere dctcg": ("predictor_rhs_3d", "correct_diag_3d"),
    "cavity 2048^2 mgcg": ("predictor_rhs_2d", "correct_diag_2d",
                           "mg_pre_sweeps_residual", "mg_add_post_sweeps"),
    "cavity 512^2 cg": ("predictor_rhs_2d", "correct_diag_2d"),
}
# the cg cavity's size: hundreds of CG iterations a step, each on the
# unrolled tape, none on the IFT's
ADJOINT_CG = dict(shape=(512, 512), re=1e4, upwind_gamma=0.8,
                  poisson_method="cg")
ADJOINT_AMP = 0.05            # the seeded start perturbation's amplitude


def adjoint_counts() -> dict:
    return {**fused2d.LAUNCHES, **fused3d.LAUNCHES,
            **multigrid_kernels.LAUNCHES}


def adjoint_grad(sim, st0, du, n, stepper=None):
    """d (sum_a ||u_a||^2) / d du after ``n`` steps from the BC pass of
    ``st0.u + du``: ``run_scan`` of ``sim`` (``stepper``: that step
    function, one call a step). Returns ``(grads, forward_ms, backward_ms,
    peak_gib)``, the times a step by the host clock around synchronized
    work, ``peak_gib`` the allocator's peak above what was allocated at
    the forward's start (the run's own memory)."""
    leaves = [d.clone().requires_grad_(True) for d in du]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = dataclasses.replace(st0, u=apply_velocity_bcs(
        sim.grid, sim.bcs, tuple(a + b for a, b in zip(st0.u, leaves)),
        sim.face_masks))
    if stepper is None:
        st, _ = sim.run_scan(st, n)
    else:
        for _ in range(n):
            st, _ = stepper(st)
    loss = sum((c ** 2).sum() for c in st.u)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = [x.grad for x in leaves]
    for g in grads:
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite gradient")
    return (grads, (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n,
            (torch.cuda.max_memory_allocated() - held) / 2**30)


def gap_of(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def adjoint_path(what, case, integrator, reset_all, smi) -> dict:
    """Checks (a)-(d) of one path of the adjoint phase (see
    :func:`adjoint_phase`); one report line."""
    from navierstokessolver_tpu_torch import adjoint

    t_path = time.perf_counter()
    if integrator != case.sim.params.integrator:
        case = with_params(case, integrator=integrator)
    sim, n = case.sim, ADJOINT_STEPS[what]
    diff = adjoint.differentiable(sim)
    gen = torch.Generator(device=DEV).manual_seed(23)
    st0 = case.initial_state()
    du = [ADJOINT_AMP * torch.randn(c.shape, generator=gen, device=DEV)
          for c in st0.u]
    start = dataclasses.replace(st0, u=apply_velocity_bcs(
        sim.grid, sim.bcs, tuple(a + b for a, b in zip(st0.u, du)),
        sim.face_masks))
    # (a) the forward is run_scan's, bit for bit, on the path's kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_k, d_k = sim.run_scan(start, n)
    torch.cuda.synchronize()
    run_scan_ms = (time.perf_counter() - t0) * 1e3 / n
    reset_all()
    st_d, d_d = diff.run_scan(start, n)
    counts = {k: adjoint_counts()[k] for k in ADJOINT_KEYS[what]}
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"adjoint {what}: counters {counts}")
    for a, b in zip((*st_k.u, st_k.p, *d_k), (*st_d.u, st_d.p, *d_d)):
        if not torch.equal(a, b):
            raise AssertionError(f"adjoint {what}: forward differs from "
                                 "run_scan")
    del st_k, st_d, d_k
    # (b) the VJP of implicit_solve is the solve of the cotangent
    base = adjoint.base_of(diff)
    fluid = sim.op.fluid
    rhs = torch.randn(sim.grid.shape, generator=gen, device=DEV) * fluid
    g = torch.randn(sim.grid.shape, generator=gen, device=DEV) * fluid
    b = rhs.clone().requires_grad_(True)
    p, _, _ = adjoint.implicit_solve(base, b, torch.zeros_like(b))
    (cot,) = torch.autograd.grad(p, b, g)
    lam, _, _ = base._solve_pressure(g, torch.zeros_like(g))
    vjp_gap = float((cot - lam).abs().max())
    if not vjp_gap <= 1e-6 * float(lam.abs().max()):
        raise AssertionError(f"adjoint {what}: VJP gap {vjp_gap}")
    del p, cot, lam, b
    # (c) kernels forward against the plain step forward, both IFT; the
    # kernel run twice (the second timed warm; equal bit for bit), and the
    # witness: the plain-forward gradient from the start one ulp up
    g_k, fwd_cold, bwd_cold, _ = adjoint_grad(diff, st0, du, n)
    g_k2, fwd_ms, bwd_ms, peak = adjoint_grad(diff, st0, du, n)
    if gap_of(g_k, g_k2) != 0.0:
        raise AssertionError(f"adjoint {what}: the gradient is not "
                             "deterministic")
    del g_k2
    g_p, _, _, peak_ift = adjoint_grad(diff, st0, du, n, diff.step_plain)
    g_w = adjoint_grad(diff, st0, [d * (1 + 2.0 ** -23) for d in du], n,
                       diff.step_plain)[0]
    witness = gap_of(g_p, g_w)
    del g_w
    top = max(float(x.abs().max()) for x in g_p)
    bound = max(3e-5 * max(top, 1.0), 2 * witness)
    gap_c = gap_of(g_k, g_p)
    if not gap_c <= bound:
        raise AssertionError(f"adjoint {what}: kernel-forward gradient gap "
                             f"{gap_c} > {bound} (3e-5 * max(max|g| "
                             f"{top}, 1); witness {witness})")
    out = {"gap_kernel_vs_plain_forward": gap_c, "max_g": top,
           "witness_plain_forward_1ulp": witness, "bound_c": bound}
    # (d) the direct solve: the IFT gradient against autograd through the
    # plain step (the refined DCT solve differentiated as it is); the
    # iterative paths: the unrolled tape's peak beside the IFT's
    g_u, _, _, peak_unrolled = adjoint_grad(sim, st0, du, n, sim.step_plain)
    gap_d = gap_of(g_p, g_u)
    top_u = max(float(x.abs().max()) for x in g_u)
    if sim.params.poisson.method == "fft":
        if not gap_d <= 1e-5 * top_u:
            raise AssertionError(f"adjoint {what}: IFT gradient gap {gap_d} "
                                 f"> 1e-5 * {top_u}")
        out["gap_ift_vs_autograd"] = gap_d
        out["gap_kernel_forward_vs_autograd"] = gap_of(g_k, g_u)
    else:
        out["gap_ift_vs_unrolled"] = gap_d
        out["peak_gib_plain_forward_unrolled_vs_ift"] = [
            round(peak_unrolled, 3), round(peak_ift, 3)]
    line("adjoint", path=json.dumps(what), shape=_name(sim.grid.shape),
         poisson=sim.params.poisson.method, integrator=integrator,
         steps=n, card=json.dumps(smi), launches=json.dumps(counts),
         poisson_iters=json.dumps(d_d.poisson_iters.tolist()),
         forward_bit_identical=True, vjp_gap=vjp_gap,
         run_scan_ms_per_step=f"{run_scan_ms:.3f}",
         forward_ms_per_step=f"{fwd_ms:.3f}",
         backward_ms_per_step=f"{bwd_ms:.3f}",
         forward_backward_ms_per_step_cold=json.dumps(
             [round(fwd_cold, 3), round(bwd_cold, 3)]),
         peak_gib_gradient_run=f"{peak:.3f}",
         **{k: json.dumps(v) if isinstance(v, list) else v
            for k, v in out.items()},
         seconds=f"{time.perf_counter() - t_path:.1f}")
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "peak_gib": peak, **out}


def adjoint_phase(case2, case3, case_sph, case_mg, reset_all, smi) -> None:
    """Gradients through run_scan on the card (adjoint.py), at full width:
    the flagship (fft, 4 Euler steps), the 256^3 cavity (fft, 2 Euler and
    1 rk2), the sphere (dctcg tol 1e-5, 2 Euler) and the mgcg cavity at
    2048^2 (1 Euler), each from a seeded perturbation of its start through
    the BC pass; and the cg cavity at 512^2 (1 Euler step, ~10^3
    iterations: the unrolled tape's peak against the IFT's). Per path: (a) the differentiable run's forward equals
    ``run_scan`` bit for bit in u, p and every diagnostic, its kernels'
    counters above 0; (b) the VJP of ``implicit_solve`` is
    ``base._solve_pressure(g, 0)`` within 1e-6 max|lambda|; (c) the
    gradient with the kernels forward equals the one with the plain step
    forward (``step_plain`` of the differentiable simulation; both with
    the IFT backward) within 3e-5 max(max|g|, 1); (d) on the fft paths the
    IFT gradient equals autograd through the plain step within 1e-5
    max|g|, and on the iterative ones the unrolled tape's peak prints
    beside the IFT's. ``run_scan``'s ms a step, forward and backward ms a
    step (warm; the first run's beside them), the gradient run's peak
    memory (above what the process held before it) and the forward's
    iteration counts print beside the card."""
    t0 = time.perf_counter()
    for what, case, integrator in (
            ("cavity 2048^2 fft", case2, "euler"),
            ("cavity3d 256^3 fft", case3, "euler"),
            ("cavity3d 256^3 fft rk2", case3, "rk2"),
            ("sphere dctcg", case_sph, "euler"),
            ("cavity 2048^2 mgcg", case_mg, "euler"),
            ("cavity 512^2 cg", make_case("cavity", device=DEV,
                                           **ADJOINT_CG), "euler")):
        adjoint_path(what, case, integrator, reset_all, smi)
        torch.cuda.empty_cache()
    line("adjoint", seconds=f"{time.perf_counter() - t0:.1f}")


# -- phase 5: the entry point (cli.py) ------------------------------------------


def _ckpt_fields(path) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _windows(csv_path) -> list:
    """(step, ms/step, MLUPS) of each window a CLI run logged."""
    import csv

    with open(csv_path) as f:
        return [[int(r["step"]), float(r["wall_ms_per_step"]),
                 float(r["mlups"])] for r in csv.DictReader(f)]


def sync_sites(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result
    and the synchronizing calls it made, by the file and line of the Python
    code that made them."""
    import warnings

    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "called a synchronizing" in str(w.message):
            where = (f"{w.filename.split('navierstokessolver_tpu_torch/')[-1]}"
                     f":{w.lineno}")
            sites[where] = sites.get(where, 0) + 1
    return out, sites


def run_cli(*flags) -> float:
    """``cli.main(flags)`` in this process; its wall seconds."""
    from navierstokessolver_tpu_torch import cli

    t0 = time.perf_counter()
    if cli.main(list(flags)) != 0:
        raise AssertionError(f"cli.main{flags} returned non-zero")
    return time.perf_counter() - t0


def cli_flagship(tmp, reset_all) -> None:
    """The flagship through the CLI at 2048^2: run A (200 steps, snapshots
    at 100 and 200 with VTK, a checkpoint), run C (400 unbroken steps,
    none), then the turns of :func:`snapshot_turns`, each a run B (A
    resumed for 200 more): kernels 4 and 5 once a step; the snapshot at
    200 equal to the plain derived fields of the checkpoint at 200
    (vorticity and centred velocity exactly, the streamfunction within n1
    ulps of max|psi|); the host's rate of np.savez_compressed against
    np.savez on two of its fields."""
    import os

    import numpy as np

    from navierstokessolver_tpu_torch import io as tio
    from navierstokessolver_tpu_torch.ops.stencils import (
        streamfunction_2d, vorticity_2d,
    )

    base = ["--case", "cavity_hi_re", "--chunk", "100"]
    d = {k: os.path.join(tmp, k) for k in "ac"}
    # the pinned pool (4 sets of the snapshot's fields), page-locked by the
    # writer's constructor before the loop: the process's first pinned
    # allocation (the later writers reuse the cached blocks)
    grid = GridSpec(FLAGSHIP["shape"], (1.0, 1.0))
    t0 = time.perf_counter()
    tio.AsyncSnapshotWriter(d["a"], grid, DEV).close()
    line("phase5", pinned_pool_mb=round(4 * sum(
        math.prod(s) for s in tio.snapshot_shapes(grid).values()) * 4e-6, 1),
         pinned_pool_alloc_s=round(time.perf_counter() - t0, 3))
    reset_all()
    wall_a = run_cli(*base, "--steps", "200", "--out", d["a"],
                     "--checkpoint-every", "200", "--snapshot-every", "100",
                     "--vtk", "--csv", d["a"] + ".csv")
    launches = dict(fused2d.LAUNCHES)
    if launches != {"predictor_rhs_2d": 200, "correct_diag_2d": 200}:
        raise AssertionError(f"run A launched {launches} in 200 steps")
    files_a = sorted(os.listdir(d["a"]))
    if files_a != ["ckpt.npz", "snap_00000100.npz", "snap_00000100.vtk",
                   "snap_00000200.npz", "snap_00000200.vtk"]:
        raise AssertionError(f"run A wrote {files_a}")
    ck = _ckpt_fields(os.path.join(d["a"], "ckpt.npz"))
    snap = _ckpt_fields(os.path.join(d["a"], "snap_00000200.npz"))
    u = tuple(torch.from_numpy(ck[f"u{a}"]) for a in range(2))
    for k, ref in (("ux_face", ck["u0"]), ("uy_face", ck["u1"]),
                   ("p", ck["p"]),
                   ("ux", (0.5 * (u[0][:-1] + u[0][1:])).numpy()),
                   ("vorticity", vorticity_2d(grid, u).numpy())):
        if not np.array_equal(snap[k], ref):
            raise AssertionError(f"snapshot {k} differs from the plain "
                                 "field of the checkpoint")
    # why the snapshots are stored uncompressed: JAX's np.savez_compressed
    # against np.savez on two of the snapshot's fields, on this host
    from io import BytesIO

    two = {k: snap[k] for k in ("p", "ux_face")}
    mb = sum(v.nbytes for v in two.values()) / 1e6
    sizes, secs = [], []
    for save in (np.savez_compressed, np.savez):
        buf = BytesIO()
        t0 = time.perf_counter()
        save(buf, **two)
        secs.append(time.perf_counter() - t0)
        sizes.append(buf.getbuffer().nbytes)
    line("phase5", npz_mb=round(mb, 1),
         deflate_mb_per_s=round(mb / secs[0], 1),
         stored_mb_per_s=round(mb / secs[1], 1),
         deflated_over_stored=round(sizes[0] / sizes[1], 4))
    writer_stalls(snap, tmp)
    psi = streamfunction_2d(grid, u).numpy()
    psi_err = float(np.abs(snap["streamfunction"] - psi).max())
    psi_tol = grid.shape[1] * float(np.finfo(np.float32).eps) * float(
        np.abs(psi).max())
    if not psi_err <= psi_tol:
        raise AssertionError(f"streamfunction off by {psi_err} > {psi_tol}")
    wall_c = run_cli(*base, "--steps", "400", "--out", d["c"],
                     "--checkpoint-every", "400", "--csv", d["c"] + ".csv")
    c = _ckpt_fields(os.path.join(d["c"], "ckpt.npz"))
    if int(c["step"]) != 400:
        raise AssertionError(f"run C ended at step {c['step']}")
    line("phase5", case="cavity_hi_re", shape=_name(FLAGSHIP["shape"]),
         launches_run_a=json.dumps(launches),
         streamfunction_err=psi_err, streamfunction_tol=psi_tol,
         wall_s_a_c=json.dumps([round(wall_a, 2), round(wall_c, 2)]),
         windows_a_snap100=json.dumps(_windows(d["a"] + ".csv")),
         windows_c_none=json.dumps(_windows(d["c"] + ".csv")))
    snapshot_turns(tmp, os.path.join(d["a"], "ckpt.npz"), c)


def writer_stalls(snap, tmp, turns: int = 1) -> None:
    """The host time that writing one snapshot's npz on a thread takes from
    a main thread that holds the GIL as the host-bound step loop does: the
    main thread spins, taking the GIL each iteration, while the writer
    thread writes ``snap``; ``lost_ms`` sums its gaps over 0.2 ms. With
    np.savez (which copies each field through ``tobytes``), with the
    writer's ``io._savez``, and with a thread that sleeps 0.2 s (the
    probe's floor), in turns."""
    import os
    import threading

    import numpy as np

    from navierstokessolver_tpu_torch import io as tio

    writers = {"np_savez": lambda path, arrays: np.savez(path, **arrays),
               "io_savez": tio._savez,
               "sleep": lambda path, arrays: time.sleep(0.2)}
    out = {k: [] for k in writers}
    for name in [*writers, *reversed(writers)] * turns:
        path = os.path.join(tmp, f"stall_{name}.npz")
        th = threading.Thread(target=writers[name], args=(path, snap))
        lost = longest = 0.0
        t0 = last = time.perf_counter()
        th.start()
        while th.is_alive():
            now = time.perf_counter()
            if now - last > 2e-4:
                lost += now - last
            longest = max(longest, now - last)
            last = now
        th.join()
        out[name].append({"write_s": round(time.perf_counter() - t0, 4),
                          "lost_ms": round(lost * 1e3, 2),
                          "longest_ms": round(longest * 1e3, 2)})
        if os.path.exists(path):
            os.remove(path)
    line("phase5", snapshot_mb=round(sum(v.nbytes for v in snap.values())
                                     / 1e6, 1),
         writer_stalls=json.dumps(out))


def snapshot_turns(tmp, resume, c) -> None:
    """Run B in turns: ``cli.main`` resumes A's checkpoint for 200 steps
    (windows of 100, a checkpoint at 400), each run of one of four kinds,
    in the order none, written, enqueued, np_savez and back: ``none``
    without snapshots; with snapshots every 50 ``written`` as the CLI
    writes them, ``enqueued`` with the writer thread's file writing
    replaced by nothing (what is left: the enqueue, the side stream and
    the thread's wait), ``np_savez`` with the npz written by np.savez
    (which copies each field through ``tobytes`` under the GIL). Every
    run's checkpoint equals C's bit for bit (snapshot neutrality and
    resume at once); every run goes under the sync debug mode, and the
    runs with snapshots make the synchronizing calls of the run without.
    ms/step and MLUPS of each window, host clock."""
    import os
    import shutil
    import statistics

    import numpy as np

    from navierstokessolver_tpu_torch import io as tio

    write_files, savez = tio._write_files, tio._savez
    kinds = {
        "none": (False, write_files, savez),
        "written": (True, write_files, savez),
        "enqueued": (True, lambda *a, **k: None, savez),
        "np_savez": (True, write_files,
                     lambda path, arrays: np.savez(path, **arrays)),
    }
    windows = {k: [] for k in kinds}
    sites, walls = {}, {k: [] for k in kinds}
    for i, kind in enumerate([*kinds, *reversed(kinds)]):
        snaps, tio._write_files, tio._savez = kinds[kind]
        out = os.path.join(tmp, f"b{i}")
        flags = ["--case", "cavity_hi_re", "--chunk", "100", "--steps", "200",
                 "--resume", resume, "--out", out, "--checkpoint-every",
                 "200", "--csv", out + ".csv"]
        if snaps:
            flags += ["--snapshot-every", "50"]
        try:
            wall, sites[kind] = sync_sites(lambda: run_cli(*flags))
        finally:
            tio._write_files, tio._savez = write_files, savez
        walls[kind].append(round(wall, 2))
        windows[kind] += [w[1] for w in _windows(out + ".csv")]
        b = _ckpt_fields(os.path.join(out, "ckpt.npz"))
        if int(b["step"]) != 400 or not all(
                np.array_equal(b[k], c[k]) for k in ("u0", "u1", "p")):
            raise AssertionError(f"run B ({kind}) differs from the unbroken "
                                 "run C")
        n_snaps = sum(f.startswith("snap_") for f in os.listdir(out))
        if n_snaps != (4 if kind in ("written", "np_savez") else 0):
            raise AssertionError(f"run B ({kind}) wrote {n_snaps} snapshots")
        shutil.rmtree(out)
    for kind, s in sites.items():
        if s != sites["none"]:
            raise AssertionError(f"run B ({kind}) made synchronizing calls "
                                 f"{s} against {sites['none']} without "
                                 "snapshots")
    line("phase5", case="cavity_hi_re", resumed_equals_unbroken=True,
         sync_calls_each_run=json.dumps(sites["none"]),
         wall_s=json.dumps(walls),
         window_ms_per_step=json.dumps(windows),
         median_ms_per_step=json.dumps({k: round(statistics.median(v), 3)
                                        for k, v in windows.items()}))


def cli_plain_passes(case2) -> None:
    """At 2048^2: the CFL dt's segment split bit for bit; run_scan_stats
    over 20 steps against a float64 numpy two-pass over the same states
    (rtol 1e-5 of each field's max); run_scan_tracers with 65 536 tracers
    for 100 steps against a hand loop of step and advect_tracers, bit for
    bit, every tracer in the domain; the cost of both passes a step
    against run_scan (CUDA events over 50 steps, launches and busy ms from
    the profiler over 10)."""
    import numpy as np

    from navierstokessolver_tpu_torch import stats as stats_mod
    from navierstokessolver_tpu_torch import tracers as tracers_mod
    from navierstokessolver_tpu_torch.grid import interpolate_to_centers

    sim = case2.sim
    st0, _ = sim.run_scan(case2.initial_state(), 50)
    # the CFL dt: run_scan(10) then run_scan(10) against run_scan(20)
    cfl = with_params(case2, cfl=0.5, dt=2 * sim.params.dt).sim
    one, d1 = cfl.run_scan(st0, 20)
    two, da = cfl.run_scan(st0, 10)
    two, db = cfl.run_scan(two, 10)
    split_equal = (all(torch.equal(x, y) for x, y in
                       zip((*one.u, one.p), (*two.u, two.p)))
                   and torch.equal(d1.dt, torch.cat([da.dt, db.dt])))
    if not split_equal:
        raise AssertionError("the CFL dt: run_scan(10) twice differs from "
                             "run_scan(20)")
    # statistics against the two-pass
    st, _, acc = sim.run_scan_stats(st0, 20)
    samples, s = [], st0
    for _ in range(20):
        s, _ = sim.step(s)
        samples.append([c.double().cpu().numpy() for c in
                        (*interpolate_to_centers(sim.grid, s.u), s.p)])
    if not all(torch.equal(x, y) for x, y in zip((*st.u, st.p),
                                                 (*s.u, s.p))):
        raise AssertionError("run_scan_stats's steps differ from step's")
    x = [np.stack([smp[k] for smp in samples]) for k in range(3)]
    mean = [v.mean(0) for v in x]
    dev = [v - m for v, m in zip(x, mean)]
    out = stats_mod.finalize(acc)
    refs = {"u_mean_0": mean[0], "u_mean_1": mean[1], "p_mean": mean[2],
            "uu_00": (dev[0] ** 2).mean(0), "uu_11": (dev[1] ** 2).mean(0),
            "uu_01": (dev[0] * dev[1]).mean(0), "p_var": (dev[2] ** 2).mean(0)}
    stats_err = {k: float(np.abs(out[k] - r).max() / np.abs(r).max())
                 for k, r in refs.items()}
    if not all(e <= 1e-5 for e in stats_err.values()) or out["n"] != 20:
        raise AssertionError(f"statistics against the two-pass: {stats_err}")
    # tracers against the hand loop
    pos0 = tracers_mod.seed_tracers(sim.grid, 65536, 0, device=DEV)
    st_t, pos, _, traj = sim.run_scan_tracers(st0, pos0, 100)
    s, p = st0, pos0
    for _ in range(100):
        s, d = sim.step(s)
        p = tracers_mod.advect_tracers(sim.grid, sim.bcs, s.u, p, d.dt)
    inside = bool(((pos >= 0) & (pos <= 1.0)).all())
    if not (torch.equal(p, pos) and torch.equal(traj[-1], pos)
            and torch.equal(s.p, st_t.p) and inside):
        raise AssertionError("run_scan_tracers differs from the hand loop "
                             f"or left the domain (inside: {inside})")
    moved = float((pos - pos0).abs().max())
    # the passes' cost a step: CUDA events over 3 x 20 steps, in turns
    # (scan, stats, tracers, tracers, stats, scan); busy ms and launches
    # from the profiler over 10 steps
    runs = {
        "run_scan": lambda: sim.run_scan(st0, 20),
        "run_scan_stats": lambda: sim.run_scan_stats(st0, 20),
        "run_scan_tracers": lambda: sim.run_scan_tracers(st0, pos0, 20),
    }
    cost = {name: {"ms_per_step": []} for name in runs}
    for name in (*runs, *reversed(runs)):
        cost[name]["ms_per_step"].append(round(time_ms(runs[name], 3) / 20,
                                               4))
    for name, fn in runs.items():
        _, groups, launches = device_profile(fn, 1)
        busy = sum(t for _, t in groups.values())
        cost[name].update(busy_ms_per_step=round(busy / 20, 4),
                          launches_per_step=launches / 20)
    line("phase5", case="cavity_hi_re", cfl_split_equal=split_equal,
         stats_rel_err=json.dumps({k: f"{v:.2e}" for k, v in
                                   stats_err.items()}),
         tracers=65536, tracer_steps=100, tracers_equal_hand_loop=True,
         tracers_inside=inside, tracer_max_displacement=moved,
         pass_cost=json.dumps(cost))


def cli_subprocess(tmp) -> None:
    """``python -m navierstokessolver_tpu_torch`` once in a subprocess."""
    import os

    out = os.path.join(tmp, "sub")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "navierstokessolver_tpu_torch", "--case",
         "cavity", "--shape", "256,256", "--steps", "200", "--out", out,
         "--snapshot-every", "100", "--checkpoint-every", "200"],
        capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    if proc.returncode != 0 or files != ["ckpt.npz", "snap_00000100.npz",
                                         "snap_00000200.npz"]:
        raise AssertionError(f"python -m navierstokessolver_tpu_torch: exit "
                             f"{proc.returncode}, files {files}\n"
                             f"{proc.stderr[-2000:]}")
    line("phase5", subprocess_exit=proc.returncode,
         subprocess_s=round(sub_s, 2), subprocess_files=json.dumps(files))


def cli_phase(case2, reset_all) -> None:
    """Phase 5: the CLI in this process on the card, in a temporary
    directory that is removed afterwards."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    parts = {}
    try:
        for name, fn in (("flagship", lambda: cli_flagship(tmp, reset_all)),
                         ("thermal", lambda: cli_thermal(tmp, reset_all)),
                         ("oscillating_lid",
                          lambda: cli_oscillating_lid(tmp, reset_all)),
                         ("plain_passes", lambda: cli_plain_passes(case2)),
                         ("sharp", lambda: cli_sharp(tmp, reset_all)),
                         ("subprocess", lambda: cli_subprocess(tmp))):
            t1 = time.perf_counter()
            fn()
            parts[name] = round(time.perf_counter() - t1, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line("phase5", seconds=f"{time.perf_counter() - t0:.1f}",
         seconds_by_part=json.dumps(parts))


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
        # the redesigned kernels must not spill: kernels 1-2 (112
        # instantiations in all), 4 (76) and 5 (12), 6 (4), 7, 8 (2), 9-10
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
    # the thermal instantiations: kernel 1 <0, per, base, 1> (its forced
    # mode, which takes theta), kernel 2 <0, per, 1>, kernel 4 <upwind,
    # base, per, force, 1>, kernel 5 <per, 1>: their registers and spills
    thermal = {k: v for k, v in ptxas_all.items()
               if re.fullmatch(r"(predictor_rhs_kernel<0, \d, \d, 1, 0>|"
                               r"correct_diag_kernel<0, \d, 1, 0>|"
                               r"predictor_rhs_2d_kernel<.*, 1>|"
                               r"correct_diag_2d_kernel<\d, 1>)", k)}
    line("phase1", thermal_instantiations=len(thermal),
         thermal_registers_spills=json.dumps(
             {k: v.split("/")[:2] for k, v in sorted(thermal.items())}))
    # the forced instantiations of the forcing slice: kernel 1's FORCE (the
    # same as above), kernel 4's FORCE <upwind, base, per, 1, thermal>,
    # kernel 8's <upwind, 1>
    forced = {k: v for k, v in ptxas_all.items()
              if re.fullmatch(r"(predictor_rhs_kernel<0, \d, \d, 1, 0>|"
                              r"predictor_rhs_2d_kernel<\d, \d, \d, 1, 0>|"
                              r"predictor_2d_kernel<\d, 1>)", k)}
    line("phase1", forced_instantiations=len(forced),
         forced_registers_spills=json.dumps(
             {k: v.split("/")[:2] for k, v in sorted(forced.items())}))
    # the open instantiations of the sphere's slice (OPEN 1: open faces, 2:
    # and an obstacle's masks) and of the convective slice (3 and 4: with a
    # CONVECTIVE face): kernel 1 <0, 0, base, 0, open>, kernel 2 <0, 0, 0,
    # open>; kernels 4-5's own, predictor_rhs_2d_open_kernel <upwind,
    # base, open> (3 and 4 Euler only) and correct_diag_2d_open_kernel
    # <open>
    opened = {k: v for k, v in ptxas_all.items()
              if re.fullmatch(r"(predictor_rhs_kernel<0, 0, \d, 0, [1-4]>|"
                              r"correct_diag_kernel<0, 0, 0, [1-4]>)", k)}
    if _native.BUILD_INFO["fused3d"][0] > 0 and len(opened) != 12:
        raise AssertionError(f"open instantiations {sorted(opened)}")
    opened_2d = {k: v for k, v in ptxas_all.items()
                 if re.fullmatch(r"(predictor_rhs_2d_open_kernel<\d, \d, "
                                 r"[1-4]>|correct_diag_2d_open_kernel<"
                                 r"[1-4]>)", k)}
    if _native.BUILD_INFO["fused2d"][0] > 0 and len(opened_2d) != 16:
        raise AssertionError(f"2D open instantiations {sorted(opened_2d)}")
    opened.update(opened_2d)
    line("phase1", open_instantiations=len(opened),
         open_registers_spills_smem=json.dumps(dict(sorted(
             opened.items()))))
    # the LES slice's instantiations of kernels 6-7: the periodic masks
    # 1-7 (predictor_3d_kernel <per, 1, upwind>, nu_t_3d_kernel <per>) and
    # the open modes (predictor_3d_open_kernel <upwind, open>,
    # nu_t_3d_open_kernel)
    les_new = {k: v for k, v in ptxas_all.items()
               if re.fullmatch(r"(predictor_3d_kernel<[1-7], 1, \d>|"
                               r"nu_t_3d_kernel<[1-7]>|"
                               r"predictor_3d_open_kernel<\d, [12]>|"
                               r"nu_t_3d_open_kernel)", k)}
    if _native.BUILD_INFO["predictor3d"][0] > 0 and len(les_new) != 26:
        raise AssertionError(f"LES instantiations {sorted(les_new)}")
    line("phase1", les_instantiations=len(les_new),
         les_registers_spills_smem=json.dumps(dict(sorted(les_new.items()))))
    # the sharp-interface slice's instantiations of kernel 2: its coded
    # mode, correct_diag_kernel <0, 0, 0, open> with OPEN 5 (the 16-bit
    # corrector code) and 6 (with a CONVECTIVE face)
    coded = {k: v for k, v in ptxas_all.items()
             if re.fullmatch(r"correct_diag_kernel<0, 0, 0, [56]>", k)}
    if _native.BUILD_INFO["fused3d"][0] > 0 and len(coded) != 2:
        raise AssertionError(f"coded instantiations {sorted(coded)}")
    line("phase1", coded_instantiations=len(coded),
         coded_registers_spills_smem=json.dumps(dict(sorted(coded.items()))))
    # the heated-bodies slice's instantiations: kernel 1's forced open
    # modes <0, 0, base, 1, open> and kernel 2's thermal open modes <0, 0,
    # 1, open>, OPEN 1 (open faces) and 2 (an obstacle's masks)
    heated = {k: v for k, v in ptxas_all.items()
              if re.fullmatch(r"(predictor_rhs_kernel<0, 0, \d, 1, [12]>|"
                              r"correct_diag_kernel<0, 0, 1, [12]>)", k)}
    if _native.BUILD_INFO["fused3d"][0] > 0 and len(heated) != 6:
        raise AssertionError(f"heated instantiations {sorted(heated)}")
    line("phase1", heated_instantiations=len(heated),
         heated_registers_spills_smem=json.dumps(dict(sorted(
             heated.items()))))
    # LES with a force, a scalar and in 2D: kernel 6's forced mode,
    # predictor_3d_forced_kernel <per, upwind> (every periodic mask), and
    # kernel 8's wrap modes, predictor_2d_wrap_kernel <upwind, force, per>
    # (per 1 rows, 2 lanes, 3 both)
    les_forced = {k: v for k, v in ptxas_all.items()
                  if re.fullmatch(r"(predictor_3d_forced_kernel<\d, \d>|"
                                  r"predictor_2d_wrap_kernel<\d, \d, "
                                  r"[123]>)", k)}
    built = (_native.BUILD_INFO["predictor3d"][0] > 0
             and _native.BUILD_INFO["predictor2d"][0] > 0)
    if built and len(les_forced) != 28:
        raise AssertionError(f"forced LES and wrap instantiations "
                             f"{sorted(les_forced)}")
    line("phase1", les_forced_instantiations=len(les_forced),
         les_forced_registers_spills_smem=json.dumps(dict(sorted(
             les_forced.items()))))

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
    check_thermal_modes(gen, errs)
    conv_cases, conv_twins = thermal_cases()
    check_forcing_modes(gen, errs)
    forcing_paths, forcing_twins = forcing_cases()
    case_sph = make_case("sphere", device=DEV)
    check_sphere_modes(case_sph, gen, errs)
    convective_paths = convective_cases()
    check_convective_modes(convective_paths, gen, errs)
    les_paths = les_cases(case_tg, case_sph,
                          convective_paths["convective sphere"])
    check_les_modes(les_paths, gen, errs)
    sharp_paths = sharp_cases()
    check_sharp_modes(sharp_paths, gen, errs)
    heated_paths = heated_cases()
    check_heated_modes(heated_paths, gen, errs)
    les_forced_paths = les_forced_cases(gen)
    check_les_forced_modes(les_forced_paths, gen, errs)
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
    thermal_steps_vs_plain(conv_cases)
    forcing_steps_vs_plain(forcing_paths)
    sphere_steps_vs_plain(case_sph)
    convective_steps_vs_plain(convective_paths)
    les_steps_vs_plain(les_paths)
    sharp_steps_vs_plain(sharp_paths)
    heated_steps_vs_plain(heated_paths)
    les_forced_steps_vs_plain(les_forced_paths)

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
    thermal_runs(conv_cases, conv_twins, reset_all)
    forcing_runs(forcing_paths, forcing_twins, reset_all)
    run_sph = sphere_runs(case_sph, reset_all)
    run_conv = convective_runs(convective_paths, reset_all)
    run_les_bcs = les_runs(les_paths, reset_all)
    run_sharp = sharp_runs(sharp_paths, reset_all)
    run_heated = heated_runs(heated_paths, reset_all)
    run_les_forced = les_forced_runs(les_forced_paths, reset_all)

    # -- the adjoint phase: gradients through run_scan -----------------------
    adjoint_phase(case2, case, case_sph, case_mg, reset_all, smi)

    # -- phase 5: the entry point, python -m navierstokessolver_tpu_torch -----
    cli_phase(case2, reset_all)

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
    ] + [
        # the masked mode of kernels 1-2 (the sphere's path; ms: device
        # time by graph replay, a call being shorter than its host time)
        {"name": k, "route": "cuda",
         "source": "navierstokessolver_tpu_torch/csrc/fused3d.cu",
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_sph["euler"]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_sph["device_ms"][k],
         "plain_ms": min(run_sph["times"][k][1], run_sph["times"][k][2]),
         "bound_ms": run_sph["bounds"][k][0],
         "bound_by": run_sph["bounds"][k][1], "library_ms": None}
        for k in SPHERE_MODES
    ] + [
        # the modes of kernels 1, 2, 4, 5 on the convective slice's paths
        # (the staircase and the convective cylinder, the convective
        # sphere; ms: device time by graph replay; launches: the wrapper's
        # in the path's timed run, both stages of an rk2 one)
        {"name": k, "route": "cuda",
         "source": ("navierstokessolver_tpu_torch/csrc/"
                    f"{KERNELS[k.split()[0]][1]}.cu"),
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_conv[run]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_conv["device_ms"][k],
         "plain_ms": min(run_conv["times"][k][1], run_conv["times"][k][2]),
         "bound_ms": run_conv["bounds"][k][0],
         "bound_by": run_conv["bounds"][k][1], "library_ms": None}
        for k, run in CONV_MODES.items()
    ] + [
        # kernels 6-7's modes on the LES slice's paths (the Taylor-Green
        # box's periodic mode, the sphere's open nu_t and masked predictor;
        # ms: device time by graph replay)
        {"name": k, "route": "cuda",
         "source": "navierstokessolver_tpu_torch/csrc/predictor3d.cu",
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_les_bcs[run]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_les_bcs["device_ms"][k],
         "plain_ms": min(run_les_bcs["times"][k][1],
                         run_les_bcs["times"][k][2]),
         "bound_ms": run_les_bcs["bounds"][k][0],
         "bound_by": run_les_bcs["bounds"][k][1], "library_ms": None}
        for k, run in LES_MODES.items()
    ] + [
        # kernel 2's coded mode on the sharp-interface slice's paths (the
        # spinning sphere's wet faces, the cut sphere's band; ms: device
        # time by graph replay)
        {"name": k, "route": "cuda",
         "source": "navierstokessolver_tpu_torch/csrc/fused3d.cu",
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_sharp[run]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_sharp["device_ms"][k],
         "plain_ms": min(run_sharp["times"][k][1], run_sharp["times"][k][2]),
         "bound_ms": run_sharp["bounds"][k][0],
         "bound_by": run_sharp["bounds"][k][1], "library_ms": None}
        for k, run in SHARP_MODES.items()
    ] + [
        # kernels 1-2's forced and thermal open modes on the heated-bodies
        # slice's paths (the heated sphere, the 3D enclosure, the adiabatic
        # sphere, the open plume; ms: device time by graph replay)
        {"name": k, "route": "cuda",
         "source": "navierstokessolver_tpu_torch/csrc/fused3d.cu",
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_heated[run]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_heated["device_ms"][k],
         "plain_ms": min(run_heated["times"][k][1],
                         run_heated["times"][k][2]),
         "bound_ms": run_heated["bounds"][k][0],
         "bound_by": run_heated["bounds"][k][1], "library_ms": None}
        for k, run in HEATED_MODES.items()
    ] + [
        # kernel 6's forced mode and kernel 8's wrap mode on the paths of
        # LES with a force, a scalar and in 2D (the duct, 3D Kolmogorov, the
        # 3D heated cavity, decaying turbulence; ms: device time by graph
        # replay; launches: the wrapper's in the path's timed run)
        {"name": k, "route": "cuda",
         "source": ("navierstokessolver_tpu_torch/csrc/"
                    f"{KERNELS[k.split()[0]][1]}.cu"),
         "replaces": KERNELS[k.split()[0]][0],
         "launches": run_les_forced[run]["launches"][k.split()[0]],
         "max_abs_err": errs[k],
         "ms": run_les_forced["device_ms"][k],
         "plain_ms": min(run_les_forced["times"][k][1],
                         run_les_forced["times"][k][2]),
         "bound_ms": run_les_forced["bounds"][k][0],
         "bound_by": run_les_forced["bounds"][k][1], "library_ms": None}
        for k, run in LES_FORCED_MODES.items()
    ]}
    line("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    print(f"card: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
