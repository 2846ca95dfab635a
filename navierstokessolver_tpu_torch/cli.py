"""The command line of the PyTorch port.

Counterpart of ``navierstokessolver_tpu/cli.py``, with its flags, defaults
and output files: runs a registered case in windows of ``--chunk`` steps,
one structured log line (and CSV row) a window, snapshots streamed off the
device by a writer thread, periodic checkpoints, ``--resume``, running
statistics (``--stats-start``), Lagrangian tracers (``--tracers``) and
control-volume force samples (``--forces-box``). It runs on the card
unless ``--platform cpu`` is given; without a card the default raises
"no CUDA device".

    python -m navierstokessolver_tpu_torch --case cavity --steps 2000
    python -m navierstokessolver_tpu_torch --case cavity_hi_re --steps 2000 \\
        --snapshot-every 500 --vtk --out out/flagship
    python -m navierstokessolver_tpu_torch --case cavity \\
        --resume out/cavity/ckpt.npz
    python -m navierstokessolver_tpu_torch --platform cpu --case cavity \\
        --shape 16,16 --steps 40
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def parse_shape(s):
    return tuple(int(x) for x in s.split(",")) if s else None


def load_config_file(path: str) -> dict:
    """Case overrides from a JSON (or YAML, if pyyaml is present) file: a
    flat mapping of case-builder keywords plus the reserved keys ``case``
    and ``steps``. Flags take precedence over the file."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # optional dependency
        except ImportError as e:
            raise RuntimeError(
                "YAML config requires pyyaml; use JSON instead"
            ) from e
        cfg = yaml.safe_load(text)
    else:
        cfg = json.loads(text)
    if not isinstance(cfg, dict):
        raise ValueError(f"config file {path} must hold a mapping")
    if "shape" in cfg:
        cfg["shape"] = tuple(cfg["shape"])
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="navierstokessolver_tpu_torch")
    ap.add_argument("--config", default=None,
                    help="JSON/YAML file of case-builder overrides "
                         "(reserved keys: case, steps); CLI flags win")
    ap.add_argument("--case", default=None, help="default: cavity")
    ap.add_argument("--shape", type=parse_shape, default=None,
                    help="grid cells per axis, e.g. 128,128")
    ap.add_argument("--re", type=float, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="default: the case's suggested step count")
    ap.add_argument("--poisson", default=None,
                    help="jacobi | gs | sor | cg | mg | mgcg | fft | dctcg")
    ap.add_argument("--poisson-tol", type=float, default=None)
    ap.add_argument("--upwind-gamma", type=float, default=None)
    ap.add_argument("--ibm", action="store_true",
                    help="sharp-interface immersed boundary for obstacle "
                         "cases (direct forcing; the cylinder)")
    ap.add_argument("--spin", type=float, default=0.0,
                    help="rotation rate alpha = omega R / U for the "
                         "cylinder (requires --ibm)")
    ap.add_argument("--sharp-pressure", action="store_true",
                    help="cut-cell apertured Poisson (not ported: raises)")
    ap.add_argument("--les-cs", type=float, default=None,
                    help="enable the Smagorinsky LES closure with this "
                         "constant (0.1-0.2 typical; 3D)")
    ap.add_argument("--les-model", default=None,
                    choices=["smagorinsky", "dynamic"],
                    help="LES variant: static-cs smagorinsky or the "
                         "Germano-Lilly dynamic model (--les-cs then "
                         "unused). Enables LES by itself.")
    ap.add_argument("--integrator", default=None, choices=["euler", "rk2"],
                    help="time integrator (default: euler)")
    ap.add_argument("--chunk", type=int, default=200,
                    help="steps per logging window")
    ap.add_argument("--out", default=None, help="output directory")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="steps between snapshots (0 = off)")
    ap.add_argument("--vtk", action="store_true",
                    help="also write legacy VTK files for ParaView")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint path")
    ap.add_argument("--csv", default=None, help="CSV metrics path")
    ap.add_argument("--forces-box", default=None,
                    help="2*ndim cell indices (i0,i1,j0,j1[,k0,k1]): sample "
                         "control-volume drag/lift terms each window into "
                         "forces.csv (see utils/forces.py)")
    ap.add_argument("--tracers", type=int, default=0,
                    help="advect N Lagrangian tracer particles after every "
                         "step and write their trajectories to tracers.npz")
    ap.add_argument("--tracer-seed", type=int, default=0)
    ap.add_argument("--stats-start", type=int, default=-1,
                    help="accumulate running statistics (time-mean fields + "
                         "Reynolds stresses) from this step on, written to "
                         "<out>/stats.npz (-1 = off; see stats.py)")
    ap.add_argument("--devices", type=int, default=0,
                    help="split axis 0 into N slabs (the slab-sharded 3D "
                         "step, every slab on the run's device; 0 = off)")
    ap.add_argument("--poisson-comm", default="gspmd",
                    choices=["gspmd", "halo"],
                    help="distributed pressure solve: the solve on the "
                         "joined field (gspmd) or the explicit-halo solvers "
                         "(halo; not ported: raises)")
    ap.add_argument("--rdma", action="store_true",
                    help="taken for parity with the JAX CLI: the slabs' "
                         "row exchanges run the exchange kernel either way")
    ap.add_argument("--platform", default=None,
                    help="torch device type: cuda (the default) or cpu")
    return ap


def resolve_device(platform) -> torch.device:
    """``--platform``: the card unless ``cpu`` is named."""
    if platform in (None, "cuda", "gpu"):
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform {platform!r}: the port runs on 'cuda' "
                     "(the default) or 'cpu'")


def _concat(diags):
    """One window's diagnostics from its segments'."""
    if len(diags) == 1:
        return diags[0]
    return type(diags[0])(*(torch.cat(f) for f in zip(*diags)))


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.platform)

    from . import io as io_mod
    from .cases import make_case
    from .parallel.sharding import HALO_TIER
    from .utils.metrics import StepLogger, WindowStats

    if args.sharp_pressure:
        raise NotImplementedError(
            "--sharp-pressure (cutcell.py, the cut-cell pressure): not "
            "ported yet (ROADMAP Queue A, 'Physics extensions')"
        )
    if args.poisson_comm == "halo":
        raise NotImplementedError(
            f"--poisson-comm halo (the explicit-halo solvers): not ported "
            f"yet ({HALO_TIER})"
        )

    file_cfg = load_config_file(args.config) if args.config else {}
    file_case = file_cfg.pop("case", None)  # a reserved key: always popped
    case_name = args.case or file_case or "cavity"  # --case wins over it
    file_steps = file_cfg.pop("steps", None)

    overrides = dict(file_cfg)
    if args.shape is not None:
        overrides["shape"] = args.shape
    if args.re is not None:
        overrides["re"] = args.re
    if args.dt is not None:
        overrides["dt"] = args.dt
    if args.poisson is not None:
        overrides["poisson_method"] = args.poisson
    if args.poisson_tol is not None:
        overrides["poisson_tol"] = args.poisson_tol
    if args.integrator is not None:
        overrides["integrator"] = args.integrator
    if args.upwind_gamma is not None:
        overrides["upwind_gamma"] = args.upwind_gamma
    if args.ibm:
        overrides["ibm"] = True
    if args.spin:
        overrides["spin"] = args.spin

    case = make_case(case_name, device=device, **overrides)
    sim = case.sim
    if args.les_cs or args.les_model:
        from .les import LESConfig

        sim = dataclasses.replace(sim, les=LESConfig(
            cs=args.les_cs or 0.17,
            model=args.les_model or "smagorinsky",
        ))
    n_steps = (args.steps if args.steps is not None else
               file_steps if file_steps is not None else
               case.suggested_steps)
    out_dir = args.out or os.path.join("out", case_name)
    os.makedirs(out_dir, exist_ok=True)

    if args.devices > 1:
        from .parallel import make_mesh, shard_state, sharded_simulation

        mesh = make_mesh(args.devices, devices=[sim.device] * args.devices)
        sim = sharded_simulation(sim, mesh, poisson_comm=args.poisson_comm,
                                 rdma=args.rdma)

    cfg_hash = io_mod.config_hash(sim.grid, sim.params, sim.scalar, sim.les,
                                  ibm=sim.ibm is not None)
    step0 = 0
    state = case.initial_state()
    if args.resume:
        state, step0 = io_mod.load_checkpoint(
            args.resume, sim.grid, cfg_hash,
            expect_scalar=sim.scalar is not None, device=sim.device)
        print(f"[cli] resumed from {args.resume} at step {step0}",
              file=sys.stderr)
        if sim.params.poisson.extrapolate and state.p_prev is None:
            # a checkpoint without the extrapolation carry: the first
            # resumed step warm-starts from p instead of 2p - p_prev
            state = dataclasses.replace(state, p_prev=state.p)
    if args.devices > 1:
        state = shard_state(state, mesh, sim.grid)

    logger = StepLogger(csv_path=args.csv)
    writer = None
    if args.snapshot_every > 0:
        writer = io_mod.AsyncSnapshotWriter(out_dir, sim.grid, vtk=args.vtk,
                                            device=sim.device,
                                            scalar=state.theta is not None)

    kind = (torch.cuda.get_device_name(sim.device)
            if sim.device.type == "cuda" else "cpu")
    print(
        f"[cli] case={case_name} grid={sim.grid.shape} dt={sim.params.dt:.3e} "
        f"nu={sim.params.nu:.3e} poisson={sim.params.poisson.method} "
        f"steps={n_steps} device={kind}",
        file=sys.stderr,
    )

    forces_box = None
    forces_rows = []
    if args.forces_box:
        forces_box = tuple(int(x) for x in args.forces_box.split(","))
        if len(forces_box) != 2 * sim.grid.ndim:
            print(f"[cli] --forces-box needs {2 * sim.grid.ndim} indices "
                  f"for a {sim.grid.ndim}D grid; ignoring", file=sys.stderr)
            forces_box = None

    step = step0
    next_snap = step + args.snapshot_every if args.snapshot_every else None
    stats_start = args.stats_start if args.stats_start >= 0 else None
    stats = None
    if args.resume:
        # statistics in the checkpoint resume whatever --stats-start says:
        # the accumulation was under way, and the next checkpoint would
        # otherwise overwrite them with none
        stats = io_mod.load_checkpoint_stats(args.resume, sim.grid.dtype,
                                             sim.device)
        if stats is not None:
            print(f"[cli] resumed statistics ({int(stats.n)} samples)",
                  file=sys.stderr)
            stats_start = (step0 if stats_start is None
                           else min(stats_start, step0))
    tracer_pos = None
    tracer_traj = []
    if args.tracers:
        if stats_start is not None:
            print("[cli] --tracers and --stats-start are mutually exclusive "
                  "(one carry each); ignoring --tracers", file=sys.stderr)
        else:
            from . import tracers as tracers_mod

            if args.resume:
                tracer_pos = io_mod.load_checkpoint_tracers(
                    args.resume, sim.grid.dtype, sim.device)
                if tracer_pos is not None:
                    print(f"[cli] resumed {tracer_pos.shape[0]} tracers",
                          file=sys.stderr)
            if tracer_pos is None:
                tracer_pos = tracers_mod.seed_tracers(
                    sim.grid, args.tracers, args.tracer_seed,
                    device=sim.device)
    try:
        while step < step0 + n_steps:
            chunk = min(args.chunk, step0 + n_steps - step)
            # The window is cut into segments that end on snapshot steps
            # (run_scan(a) then run_scan(b) is run_scan(a + b) bit for bit,
            # so snapshots leave the trajectory as it is) and on
            # --stats-start (segments from it on accumulate statistics).
            # An enqueue hands the state to the writer without waiting for
            # the device; the window's one host read is its diagnostics.
            t0 = time.perf_counter()
            diags = []
            done = 0
            while done < chunk:
                seg = chunk - done
                if next_snap is not None:
                    seg = min(seg, next_snap - step)
                if stats_start is not None and step < stats_start:
                    seg = min(seg, stats_start - step)
                if stats_start is not None and step >= stats_start:
                    state, diag, stats = sim.run_scan_stats(state, seg,
                                                            stats)
                elif tracer_pos is not None:
                    state, tracer_pos, diag, traj = sim.run_scan_tracers(
                        state, tracer_pos, seg)
                    tracer_traj.append(traj.cpu().numpy())
                else:
                    state, diag = sim.run_scan(state, seg)
                diags.append(diag)
                step += seg
                done += seg
                if writer is not None and step == next_snap:
                    writer.enqueue(state, step, step * sim.params.dt)
                if next_snap is not None and step >= next_snap:
                    next_snap += args.snapshot_every
            values = WindowStats.host_values(_concat(diags))
            wall = time.perf_counter() - t0
            logger.log(WindowStats.from_values(
                values, step=step, dt=sim.params.dt, wall_s=wall,
                n_cells=int(np.prod(sim.grid.shape)),
            ))
            if forces_box is not None:
                from .utils.forces import cv_terms_nd

                sf, mom = cv_terms_nd(sim.grid, state, sim.params.nu,
                                      forces_box)
                forces_rows.append((step, *(float(x) for x in sf),
                                    *(float(x) for x in mom)))
            if args.checkpoint_every and step % args.checkpoint_every < chunk:
                io_mod.save_checkpoint(
                    os.path.join(out_dir, "ckpt.npz"), state, step, cfg_hash,
                    stats=stats, tracers=tracer_pos,
                )
    finally:
        if writer is not None:
            writer.close()
    if args.checkpoint_every:
        io_mod.save_checkpoint(
            os.path.join(out_dir, "ckpt.npz"), state, step, cfg_hash,
            stats=stats, tracers=tracer_pos,
        )
    if stats is not None:
        from . import stats as stats_mod

        path = os.path.join(out_dir, "stats.npz")
        np.savez_compressed(path, **stats_mod.finalize(stats))
        print(f"[cli] wrote {path} ({int(stats.n)} samples)",
              file=sys.stderr)
    if tracer_traj:
        path = os.path.join(out_dir, "tracers.npz")
        np.savez_compressed(path, traj=np.concatenate(tracer_traj, axis=0),
                            final=tracer_pos.cpu().numpy())
        print(f"[cli] wrote {path} ({sum(t.shape[0] for t in tracer_traj)} "
              f"steps x {args.tracers} tracers)", file=sys.stderr)
    if forces_rows:
        path = os.path.join(out_dir, "forces.csv")
        axes = "xyz"[: sim.grid.ndim]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step"] + [f"sf_{a}" for a in axes]
                       + [f"mom_{a}" for a in axes])
            w.writerows(forces_rows)
        print(f"[cli] wrote {path} ({len(forces_rows)} samples); assemble "
              "Cd/Cl with utils.forces.drag_lift_series", file=sys.stderr)
    print(f"[cli] done at step {step}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
