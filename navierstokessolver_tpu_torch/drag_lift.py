"""Cylinder drag, lift and Strouhal number on the card, by the
control-volume momentum balance (utils/forces.py).

    python -m navierstokessolver_tpu_torch.drag_lift

The counterpart of the JAX package's ``scripts/drag_lift.py``, fixed to
BASELINE config #3's check: the cylinder case at 512x256, Re 200, with
the sharp-interface immersed boundary and the case's own pressure solve
(dctcg), from ``impulsive_start_state`` to t = 150, the force terms
sampled after every step by ``Simulation.run_scan_forces`` over a box 1.5
diameters around the cylinder, in chunks of CHUNK steps (one host read a
chunk), then ``drag_lift_series`` and ``dominant_frequency`` over the
second half of the run. Oracle (BASELINE.md; public literature at Re
200): St ~ 0.19-0.20, mean Cd ~ 1.3-1.4, Cl amplitude ~ 0.7.

Prints the card's name and power limit, then one JSON line: ``cd_mean``,
``cl_amp``, ``cl_mean``, ``st_from_cl`` and the run's size, steps,
seconds and ms a step (CUDA events around the stepping). Needs a CUDA
device and exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from .cases import make_case
from .cases.cylinder import impulsive_start_state
from .utils.forces import dominant_frequency, drag_lift_series

SHAPE = (512, 256)
RE = 200.0
T_END = 150.0
CHUNK = 200       # steps a run_scan_forces call


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("drag_lift: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sim = make_case("cylinder", shape=SHAPE, re=RE, ibm=True,
                    device=torch.device("cuda", 0)).sim
    g, dt = sim.grid, sim.params.dt
    # the control volume: 1.5 diameters around the centre (4, 4.003), D = 1
    cx, cy = 4.0, g.lengths[1] / 2.0
    hx, hy = g.spacing
    box = (int((cx - 1.5) / hx), int((cx + 1.5) / hx),
           int((cy - 1.5) / hy), int((cy + 1.5) / hy))
    n_steps = int(T_END / dt) // CHUNK * CHUNK
    state = impulsive_start_state(sim)
    sfs, moms = [], []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_steps // CHUNK):
        state, _, sf, mom = sim.run_scan_forces(state, CHUNK, box)
        sfs.append(sf.cpu().numpy())
        moms.append(mom.cpu().numpy())
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sf, mom = np.concatenate(sfs), np.concatenate(moms)
    if not (np.isfinite(sf).all() and np.isfinite(mom).all()):
        sys.exit("drag_lift: non-finite force terms")
    cd, cl = drag_lift_series(g, sim.params.nu, box, sf[:, 0], sf[:, 1],
                              mom[:, 0], mom[:, 1], dt)
    half = len(cd) // 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(json.dumps({
        "cd_mean": float(np.mean(cd[half:])),
        "cl_amp": float((cl[half:].max() - cl[half:].min()) / 2),
        "cl_mean": float(np.mean(cl[half:])),
        "st_from_cl": dominant_frequency(cl[half:], dt),
        "re": RE, "shape": list(g.shape),
        "poisson": sim.params.poisson.method, "dt": dt, "steps": n_steps,
        "t_end": n_steps * dt, "box": list(box), "wall_s": wall,
        "ms_per_step": start.elapsed_time(stop) / n_steps,
        "card": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
