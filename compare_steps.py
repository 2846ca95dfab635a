"""ms/step of the PyTorch port's main paths, for comparing checkouts.

    python3 compare_steps.py [ROOT] [--label NAME] [--steps N]
        [--integrator {euler,rk2}] [--cfl X] [--convection]

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
2048x1024 (dctcg, from rest).

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


if __name__ == "__main__":
    main()
