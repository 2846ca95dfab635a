"""ms/step of the PyTorch port's main paths, for comparing checkouts.

    python3 compare_steps.py [ROOT] [--label NAME] [--steps N]
        [--integrator {euler,rk2}] [--cfl X] [--convection] [--kernels]

Imports ``navierstokessolver_tpu_torch`` from the checkout at ROOT (this
one by default) and times, on the first CUDA card, ``run_scan`` of each 3D
path of the port at 256^3: cavity3d and taylor_green3d on the transform
chain and on the fused trailing-axes route, cavity3d with LES (cs 0.17),
cavity3d in 4 and in 16 slabs and taylor_green3d in 4 (every slab on the
card); the 2D flagship, cavity 2048^2 at Re 1e4 with upwind gamma 0.8
and the direct solve (bench.py's default configuration), and the IBM
cylinder at 2048x1024 from the impulsive start (dctcg, the per-component
predictor kernel), whose steps the host's enqueue bounds. Each path runs
10 warm-up steps, 10 steps timed on the host clock without a synchronize
(the host's enqueue time; 10 steps stay under the launch queue's depth),
then N steps (100) between CUDA events. Prints the card's name and power
limit, then one JSON line ``{"label": ..., "root": ..., "ms_per_step":
{path: ms}, "host_ms_per_step": {path: ms}}``. A kernel's device time
alone comes from chip_smoke.py (phase 4, graph replay), run from each
checkout. ``--integrator`` and ``--cfl`` go to every path's ``make_case``
as SimParams fields (rk2; the CFL-adaptive dt with the case's dt as its
cap); a checkout that does not port them raises. ``--convection`` adds
the convection paths: heated_cavity 2048^2 (Ra 1e8), rayleigh_benard
2048x1024 (Ra 1e8), heated_cavity 256^3 (Ra 1e6) and heated_cylinder
2048x1024 (dctcg, from rest). ``--kernels`` times kernels 1-2 alone
instead, in each mode that the 3D paths run them (by CUDA events, the
better of two 20-call means, as chip_smoke.py's phase 4): walls (cavity3d
256^3 after 10 steps), periodic and ``base`` (taylor_green3d 256^3), the
static force (duct_periodic 512x128x128), a forcing volume (kolmogorov
256^3) and thermal (heated_cavity 256^3, Ra 1e6), and prints the ptxas
report of the checkout's fused3d build (registers/spill bytes/shared
memory by instantiation) in the JSON line's ``ptxas``.

Two checkouts compare only on one card, run in turns back to back: unpack
the other one with ``git archive`` into a directory that .gitignore lists
and run, for example, ``parent``, ``.``, ``.``, ``parent``. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

SHAPE = (256, 256, 256)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--label", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--integrator", default=None, choices=["euler", "rk2"])
    ap.add_argument("--cfl", type=float, default=None)
    ap.add_argument("--convection", action="store_true",
                    help="add the convection cases' paths")
    ap.add_argument("--kernels", action="store_true",
                    help="time kernels 1-2 in their modes, not the paths")
    args = ap.parse_args(argv)
    params = {k: v for k, v in (("integrator", args.integrator),
                                ("cfl", args.cfl)) if v is not None}
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_steps.py: torch.cuda.is_available() is False")
    import navierstokessolver_tpu_torch as pkg
    from navierstokessolver_tpu_torch.cases import make_case
    from navierstokessolver_tpu_torch.cases.cylinder import (
        impulsive_start_state,
    )
    from navierstokessolver_tpu_torch.les import LESConfig
    from navierstokessolver_tpu_torch.parallel import (
        make_mesh, sharded_simulation,
    )

    if not pkg.__file__.startswith(root + os.sep):
        sys.exit(f"compare_steps.py: imported {pkg.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def ms_per_step(case) -> tuple[float, float]:
        st, _ = case.sim.run_scan(case.initial_state(), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = case.sim.run_scan(st, 10)
        host_ms = (time.perf_counter() - t0) * 100.0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        case.sim.run_scan(st, args.steps)
        stop.record()
        torch.cuda.synchronize()
        return (round(start.elapsed_time(stop) / args.steps, 4),
                round(host_ms, 4))

    if args.kernels:
        return kernel_modes(dev, args, root)

    def with_sim(case, **changes):
        return dataclasses.replace(
            case, sim=dataclasses.replace(case.sim, **changes))

    def fused(case):
        return with_sim(case, dct_solver=dataclasses.replace(
            case.sim.dct_solver, fuse_trailing=True))

    def sharded(case, n):
        mesh = make_mesh(n, devices=[dev] * n)
        return dataclasses.replace(
            case, sim=sharded_simulation(case.sim, mesh, rdma=True))

    cav = make_case("cavity3d", shape=SHAPE, device=dev, **params)
    tg = make_case("taylor_green3d", shape=SHAPE, device=dev, **params)
    paths = {
        "cavity3d": cav,
        "cavity3d_fused": fused(cav),
        "taylor_green3d": tg,
        "taylor_green3d_fused": fused(tg),
        "cavity3d_les": with_sim(cav, les=LESConfig(cs=0.17)),
        "cavity3d_4slabs": sharded(cav, 4),
        "cavity3d_16slabs": sharded(cav, 16),
        "taylor_green3d_4slabs": sharded(tg, 4),
        "cavity_2048": make_case("cavity", shape=(2048, 2048), re=1e4,
                                 upwind_gamma=0.8, device=dev, **params),
        "cylinder_2048x1024": dataclasses.replace(
            make_case("cylinder", shape=(2048, 1024), ibm=True, device=dev,
                      **params),
            init=impulsive_start_state),
    }
    if args.convection:
        paths.update({
            "heated_cavity_2048": make_case(
                "heated_cavity", shape=(2048, 2048), ra=1e8, device=dev,
                **params),
            "rayleigh_benard_2048x1024": make_case(
                "rayleigh_benard", shape=(2048, 1024), ra=1e8, device=dev,
                **params),
            "heated_cavity3d": make_case(
                "heated_cavity", shape=SHAPE, ra=1e6, device=dev, **params),
            "heated_cylinder_2048x1024": make_case(
                "heated_cylinder", shape=(2048, 1024), device=dev, **params),
        })
    out = {name: ms_per_step(case) for name, case in paths.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(json.dumps({
        "label": args.label or args.root, "root": args.root, **params,
        "ms_per_step": {k: v[0] for k, v in out.items()},
        "host_ms_per_step": {k: v[1] for k, v in out.items()}}), flush=True)


def kernel_ms(fn, reps: int = 20) -> float:
    """The better of two means over ``reps`` calls by CUDA events, after
    two warm-up calls."""
    import torch

    best = float("inf")
    for _ in range(2):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return round(best, 4)


def kernel_modes(dev, args, root) -> None:
    """``--kernels``: kernels 1-2 in each mode of the 3D paths."""
    import torch

    from chip_smoke import ptxas_summary
    from navierstokessolver_tpu_torch.bcs import periodic_axes
    from navierstokessolver_tpu_torch.cases import make_case
    from navierstokessolver_tpu_torch.ops import _native, fused3d

    _native.load_all(["fused3d"])
    out = {}

    def modes(name, case, state, **kw):
        sim = case.sim
        g, b, pr = sim.grid, sim.bcs, sim.params
        per = periodic_axes(g, b)
        dts = sim._dts(None)
        base = kw.pop("base", None)
        theta = kw.pop("theta", None)
        tkw = {} if theta is None else dict(theta=theta, scalar=sim.scalar,
                                           thermal=sim.thermal)

        def pred(b_=None):
            return fused3d.predictor_rhs_3d(
                g, b, state.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho,
                bc=sim.bc, dts=dts, base=b_, **kw,
                **{k: v for k, v in tkw.items()
                   if sim.scalar is not None and sim.scalar.buoyant})
        us, _ = pred()
        out[f"predictor {name}"] = kernel_ms(pred)
        if base is not None:
            out[f"predictor {name} base"] = kernel_ms(lambda: pred(base))
        if kw:
            return
        ckw = {} if theta is None else dict(theta=theta, scalar=sim.scalar,
                                           dt=dts[0], thermal=sim.thermal)
        out[f"corrector {name}"] = kernel_ms(lambda: fused3d.correct_diag_3d(
            g, us, state.p, dts[2], per, **ckw))

    cav = make_case("cavity3d", shape=SHAPE, device=dev)
    st, _ = cav.sim.run_scan(cav.initial_state(), 10)
    modes("walls", cav, st)
    tg = make_case("taylor_green3d", shape=SHAPE, device=dev)
    st = tg.initial_state()
    modes("periodic", tg, st, base=st.u)
    duct = make_case("duct_periodic", shape=(512, 128, 128),
                     lengths=(4.0, 1.0, 1.0), re=100.0, device=dev)
    modes("force", duct, duct.initial_state(),
          force=duct.sim._force_numbers(duct.sim.forcing))
    kol = make_case("kolmogorov", shape=SHAPE, re=30.0, k_forcing=4,
                    device=dev)
    modes("volume", kol, kol.initial_state(), force_vol=kol.sim.force_vol)
    hc = make_case("heated_cavity", shape=SHAPE, ra=1e6, device=dev)
    st = hc.initial_state()
    modes("thermal", hc, st, theta=st.theta)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(json.dumps({
        "label": args.label or args.root, "root": args.root,
        "kernel_ms": out,
        "ptxas": ptxas_summary(_native.BUILD_INFO["fused3d"][1])}),
        flush=True)


if __name__ == "__main__":
    main()
