"""Where a step's time goes on the card: device time by kernel, and the
host's enqueue time against the device time.

    python -m navierstokessolver_tpu_torch.step_profile cavity 2048 2048 \\
        --re 1e4 --upwind-gamma 0.8
    python -m navierstokessolver_tpu_torch.step_profile cavity3d 256 256 256 \\
        --les-cs 0.17
    python -m navierstokessolver_tpu_torch.step_profile cavity 2048 2048 \\
        --re 1e4 --upwind-gamma 0.8 --poisson mgcg --mg-route fused
    python -m navierstokessolver_tpu_torch.step_profile cylinder 2048 1024 \\
        --ibm --poisson dctcg
    python -m navierstokessolver_tpu_torch.step_profile channel 2048 512
    python -m navierstokessolver_tpu_torch.step_profile taylor_green3d \\
        256 256 256 --fuse-trailing
    python -m navierstokessolver_tpu_torch.step_profile cavity3d \\
        256 256 256 --shards 4
    python -m navierstokessolver_tpu_torch.step_profile taylor_green3d \\
        256 256 256 --integrator rk2 --cfl 0.5
    python -m navierstokessolver_tpu_torch.step_profile taylor_green 2048 2048
    python -m navierstokessolver_tpu_torch.step_profile \\
        decaying_turbulence 2048 2048 --cfl 0.5
    python -m navierstokessolver_tpu_torch.step_profile channel_periodic \\
        2048 512

``--les-cs`` and ``--les-model`` set the Smagorinsky closure as the JAX
package's CLI does (either one enables it; cs 0.17 and the static model
by default). ``--poisson`` picks the pressure method (the case's own by
default: fft for the cavities, dctcg for the cylinder);
``--mg-route`` the V-cycle's route for mg and mgcg: ``fused`` (the level
kernels mg_pre/mg_post, the default on the card), ``rb`` (the rb_sweeps
kernel) or ``plain`` (no kernel). ``--ibm`` turns on the cylinder's
sharp-interface immersed boundary; the cylinder starts from
``impulsive_start_state``, and takes its own defaults (Re 200, upwind
gamma 0.2, dctcg) unless the options name others; the channel (lengths
(4, 1), so 2048x512 has square cells; Re 100, mg) starts from rest with
its inflow profile on, a developing flow; ``taylor_green3d`` and
``taylor_green`` start from their vortices, ``decaying_turbulence`` from its
seeded field (rk2 unless ``--integrator`` names another) and
``channel_periodic`` from its parabola (the static body force on). ``--fuse-trailing`` puts a 3D direct solve on the fused
trailing-axes route (kernel 12, ops/trailing_dct.py).
``--shards N`` runs the slab-sharded step (parallel/fused_sharded.py) in N
slabs of axis 0, every slab on the card: its kernels 1 and 2 in halo mode,
the row-exchange kernel, and the joining and cutting of the RHS and p
(the "cat_copy" group, which also holds the unsharded steps' own copies).
``--integrator`` (euler or rk2, the JAX CLI's option) and ``--cfl`` (the
CFL-adaptive dt, the case's dt its cap) go to ``make_case`` as SimParams
fields.

Builds the case on CUDA device 0 (TF32 off, as chip_smoke.py runs it),
runs 10 warm-up steps, then measures

  * device ms/step: CUDA events around ``--steps`` steps;
  * host enqueue ms/step: the host clock around 3 steps enqueued behind
    the device's queue (no synchronize inside), i.e. what the Python side
    costs per step;
  * device time per kernel name over ``--steps`` steps under
    ``torch.profiler``, grouped into GEMMs (every kernel whose name holds
    "gemm"), the port's own kernels, and the other PyTorch kernels, with
    launches per step and the device's idle share of the step;
  * for the iterative methods, pressure iterations and host syncs (reads
    of a loop flag, ops/poisson.HOST_SYNCS) per step; for mg and mgcg also
    one V-cycle on its own: host enqueue against device time, and launches
    per V-cycle.

Prints one JSON object. Needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from .cases import make_case
from .les import LESConfig
from .ops import poisson

PORT_KERNELS = (
    "predictor_rhs_2d_kernel", "correct_diag_2d_kernel", "predictor_2d_kernel",
    "predictor_rhs_kernel", "correct_diag_kernel", "residual_kernel",
    "predictor_3d_kernel", "nu_t_3d_kernel", "trailing_dct_kernel",
    "exchange_rows_kernel",
)
# csrc/multigrid.cu's kernels: the level template by mode, and rb_sweeps
MG_KERNELS = {"level_kernel<1>": "mg_pre", "level_kernel<2>": "mg_post",
              "rb_sweeps_kernel": "rb_sweeps"}
# --mg-route -> (fused, use_pallas)
ROUTES = {"fused": (True, False), "rb": (False, True), "plain": (False, False)}


def _group(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    for k, g in MG_KERNELS.items():
        if k in name:
            return g
    if "gemm" in name.lower():
        return "gemm"
    # torch.cat and copy_ (the sharded step's RHS join and p cut; a copy
    # between contiguous views is a "Memcpy DtoD")
    if "Cat" in name or "copy" in name or "Memcpy" in name:
        return "cat_copy"
    return "other"


def device_profile(fn, reps: int):
    """Device time by kernel group of ``reps`` calls of ``fn`` under
    torch.profiler: (ms by kernel name, {group: (launches, ms)}, launches),
    each per call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, groups, launches = {}, {}, 0
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = row.self_device_time_total / 1e3 / reps
        kernels[row.key] = kernels.get(row.key, 0.0) + ms
        g = _group(row.key)
        n, t = groups.get(g, (0.0, 0.0))
        groups[g] = (n + row.count / reps, t + ms)
        launches += row.count
    return kernels, groups, launches / reps


def _vcycle(sim, st, reps: int = 10) -> dict:
    """One V-cycle of the solver on the pressure RHS of ``st``: device ms
    (CUDA events), host enqueue ms (host clock, no synchronize inside: the
    V-cycle makes no host read) and launches, per V-cycle."""
    from .solver import _kernels

    g, pr = sim.grid, sim.params
    if sim.fused:
        force = {"force": sim.forcing} if g.ndim == 2 else {}
        _, rhs = _kernels(g.ndim)[1](g, sim.bcs, st.u, pr.dt, pr.nu,
                                     pr.upwind_gamma, pr.rho, bc=sim.bc,
                                     **force)
    else:
        _, rhs = sim.star_rhs(st)
    mg = sim.mg_solver
    run = lambda: mg._v_cycle(0, torch.zeros_like(rhs), rhs)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    _, groups, launches = device_profile(run, reps)
    return {"levels": [list(o.diag.shape) for o in mg.ops],
            "device_ms": device_ms, "host_enqueue_ms": enqueue_ms,
            "launches": launches,
            "groups": {k: {"launches": n, "ms": t}
                       for k, (n, t) in sorted(groups.items())}}


def profile(case, steps: int, state=None) -> dict:
    """``state``: where the warm-up starts (the case's initial state when
    None)."""
    sim = case.sim
    st, _ = sim.run_scan(case.initial_state() if state is None else state,
                         10)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    poisson.reset_host_syncs()
    start.record()
    _, diag = sim.run_scan(st, steps)
    stop.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(stop) / steps
    syncs = poisson.HOST_SYNCS["poisson"] / steps
    iters = diag.poisson_iters.float()

    t0 = time.perf_counter()
    sim.run_scan(st, 3)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()

    kernels, groups, launches = device_profile(
        lambda: sim.run_scan(st, steps), 1)
    busy = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "shape": list(sim.grid.shape),
        "poisson": sim.params.poisson.method,
        "steps": steps,
        "device_ms_per_step": device_ms,
        "host_enqueue_ms_per_step": enqueue_ms,
        "kernel_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / device_ms),
        "launches_per_step": launches / steps,
        "host_syncs_per_step": syncs,
        "poisson_iters_mean_min_max": [float(iters.mean()),
                                       float(iters.min()),
                                       float(iters.max())],
        "groups": {g: {"launches_per_step": n / steps,
                       "ms_per_step": t / steps}
                   for g, (n, t) in sorted(groups.items())},
        "top_kernels_ms_per_step": {k: v / steps for k, v in top},
    }
    if sim.mg_solver is not None:
        out["mg_route"] = {"fused": sim.mg_solver.fused,
                           "use_pallas": sim.mg_solver.use_pallas}
        out["vcycle"] = _vcycle(sim, st)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case")
    ap.add_argument("shape", type=int, nargs="+")
    ap.add_argument("--re", type=float, default=None)
    ap.add_argument("--upwind-gamma", type=float, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--les-cs", type=float, default=None,
                    help="enable the Smagorinsky LES closure with this "
                         "constant (3D only)")
    ap.add_argument("--les-model", default=None,
                    choices=["smagorinsky", "dynamic"],
                    help="LES variant; enables LES by itself")
    ap.add_argument("--poisson", default=None, choices=poisson.METHODS,
                    help="pressure method (the case's default when unset)")
    ap.add_argument("--ibm", action="store_true",
                    help="the cylinder's sharp-interface immersed boundary")
    ap.add_argument("--mg-route", default="fused", choices=sorted(ROUTES),
                    help="the V-cycle's route for mg and mgcg")
    ap.add_argument("--fuse-trailing", action="store_true",
                    help="the 3D direct solve's fused trailing-axes route")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the slab-sharded step in this many slabs")
    ap.add_argument("--integrator", default=None, choices=["euler", "rk2"],
                    help="time integrator (the case's, euler, when unset)")
    ap.add_argument("--cfl", type=float, default=None,
                    help="CFL-adaptive dt with this CFL number")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("step_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(shape=tuple(args.shape), device=torch.device("cuda", 0))
    for name, value in (("re", args.re), ("upwind_gamma", args.upwind_gamma),
                        ("poisson_method", args.poisson),
                        ("integrator", args.integrator), ("cfl", args.cfl)):
        if value is not None:
            kw[name] = value
    if args.ibm:
        kw["ibm"] = True
    case = make_case(args.case, **kw)
    if args.les_cs or args.les_model:
        case = dataclasses.replace(case, sim=dataclasses.replace(
            case.sim, les=LESConfig(cs=args.les_cs or 0.17,
                                    model=args.les_model or "smagorinsky")))
    if args.fuse_trailing:
        case = dataclasses.replace(case, sim=dataclasses.replace(
            case.sim, dct_solver=dataclasses.replace(
                case.sim.dct_solver, fuse_trailing=True)))
    if case.sim.mg_solver is not None:
        fused, use_pallas = ROUTES[args.mg_route]
        case = dataclasses.replace(case, sim=dataclasses.replace(
            case.sim, mg_solver=dataclasses.replace(
                case.sim.mg_solver, fused=fused, use_pallas=use_pallas)))
    if args.shards:
        from .parallel import make_mesh, sharded_simulation

        mesh = make_mesh(args.shards, devices=[kw["device"]] * args.shards)
        case = dataclasses.replace(case, sim=sharded_simulation(
            case.sim, mesh, rdma=True))
    state = None
    if args.case == "cylinder":
        from .cases.cylinder import impulsive_start_state

        state = impulsive_start_state(case.sim)
    out = profile(case, args.steps, state)
    out["ibm"] = case.sim.ibm is not None
    if case.sim.dct_solver is not None:
        out["fuse_trailing"] = case.sim.dct_solver.fuse_trailing
    out["les"] = None if case.sim.les is None else dataclasses.asdict(
        case.sim.les)
    out["slabs"] = args.shards or None
    out["integrator"] = case.sim.params.integrator
    out["cfl"] = case.sim.params.cfl
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
