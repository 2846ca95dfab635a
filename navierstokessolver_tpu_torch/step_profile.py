"""Where a step's time goes on the card: device time by kernel, and the
host's enqueue time against the device time.

    python -m navierstokessolver_tpu_torch.step_profile cavity 2048 2048 \\
        --re 1e4 --upwind-gamma 0.8
    python -m navierstokessolver_tpu_torch.step_profile cavity3d 256 256 256 \\
        --les-cs 0.17

``--les-cs`` and ``--les-model`` set the Smagorinsky closure as the JAX
package's CLI does (either one enables it; cs 0.17 and the static model
by default).

Builds the case on CUDA device 0 (TF32 off, as chip_smoke.py runs it),
runs 10 warm-up steps, then measures

  * device ms/step: CUDA events around ``--steps`` steps;
  * host enqueue ms/step: the host clock around 3 steps enqueued behind
    the device's queue (no synchronize inside), i.e. what the Python side
    costs per step;
  * device time per kernel name over ``--steps`` steps under
    ``torch.profiler``, grouped into GEMMs (every kernel whose name holds
    "gemm"), the port's own kernels, and the other PyTorch kernels, with
    launches per step and the device's idle share of the step.

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

PORT_KERNELS = (
    "predictor_rhs_2d_kernel", "correct_diag_2d_kernel",
    "predictor_rhs_kernel", "correct_diag_kernel", "residual_kernel",
    "predictor_3d_kernel", "nu_t_3d_kernel",
)


def _group(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    return "gemm" if "gemm" in name.lower() else "other"


def profile(case, steps: int) -> dict:
    sim = case.sim
    st, _ = sim.run_scan(case.initial_state(), 10)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.run_scan(st, steps)
    stop.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(stop) / steps

    t0 = time.perf_counter()
    sim.run_scan(st, 3)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sim.run_scan(st, steps)
        torch.cuda.synchronize()
    kernels, groups, launches = {}, {}, 0
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = row.self_device_time_total / 1e3 / steps
        kernels[row.key] = kernels.get(row.key, 0.0) + ms
        g = _group(row.key)
        n, t = groups.get(g, (0.0, 0.0))
        groups[g] = (n + row.count / steps, t + ms)
        launches += row.count
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "shape": list(sim.grid.shape),
        "steps": steps,
        "device_ms_per_step": device_ms,
        "host_enqueue_ms_per_step": enqueue_ms,
        "kernel_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / device_ms),
        "launches_per_step": launches / steps,
        "groups": {g: {"launches_per_step": n, "ms_per_step": t}
                   for g, (n, t) in sorted(groups.items())},
        "top_kernels_ms_per_step": dict(top),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case")
    ap.add_argument("shape", type=int, nargs="+")
    ap.add_argument("--re", type=float, default=None)
    ap.add_argument("--upwind-gamma", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--les-cs", type=float, default=None,
                    help="enable the Smagorinsky LES closure with this "
                         "constant (3D only)")
    ap.add_argument("--les-model", default=None,
                    choices=["smagorinsky", "dynamic"],
                    help="LES variant; enables LES by itself")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("step_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(shape=tuple(args.shape), upwind_gamma=args.upwind_gamma,
              device=torch.device("cuda", 0))
    if args.re is not None:
        kw["re"] = args.re
    case = make_case(args.case, **kw)
    if args.les_cs or args.les_model:
        case = dataclasses.replace(case, sim=dataclasses.replace(
            case.sim, les=LESConfig(cs=args.les_cs or 0.17,
                                    model=args.les_model or "smagorinsky")))
    out = profile(case, args.steps)
    out["les"] = None if case.sim.les is None else dataclasses.asdict(
        case.sim.les)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
