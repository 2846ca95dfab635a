"""Per-window metrics and logging of a run (PyTorch port).

Counterpart of ``navierstokessolver_tpu/utils/metrics.py``: one JSON line
per logging window with the same keys (step, sim time, CFL, Poisson
iterations, residual, max divergence, MLUPS, wall ms/step), and optionally
the same CSV columns. :meth:`WindowStats.host_values` reads a window's stacked
diagnostics on the host in one copy.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import sys
import time
from typing import Optional

import torch


@dataclasses.dataclass
class WindowStats:
    step: int
    sim_time: float
    dt: float
    steps: int
    wall_s: float
    n_cells: int
    poisson_iters_mean: float
    poisson_iters_max: int
    residual: float
    max_div: float
    max_cfl: float

    @property
    def mlups(self) -> float:
        return self.n_cells * self.steps / self.wall_s / 1e6

    @property
    def wall_ms_per_step(self) -> float:
        return self.wall_s / self.steps * 1e3

    @staticmethod
    def host_values(diag) -> list:
        """The window's reductions of its per-step diagnostics (a
        ``StepDiagnostics`` of 1-d tensors), computed where the tensors
        live and brought to the host in one copy: the mean and the max of
        the iterations, the last residual, the max divergence and CFL, and
        the step count. On the card this read waits for the window's
        steps."""
        iters = diag.poisson_iters
        vals = torch.stack([
            iters.double().mean(), iters.max().double(),
            diag.poisson_res[-1].double(), diag.max_div.max().double(),
            diag.max_cfl.max().double()]).cpu().tolist()
        return vals + [int(iters.shape[0])]

    @staticmethod
    def from_values(vals, *, step, dt, wall_s, n_cells) -> "WindowStats":
        """The window's numbers from :meth:`host_values`."""
        return WindowStats(
            step=int(step),
            sim_time=float(step * dt),
            dt=float(dt),
            steps=int(vals[5]),
            wall_s=float(wall_s),
            n_cells=int(n_cells),
            poisson_iters_mean=vals[0],
            poisson_iters_max=int(vals[1]),
            residual=vals[2],
            max_div=vals[3],
            max_cfl=vals[4],
        )

    @staticmethod
    def from_diag(diag, *, step, dt, wall_s, n_cells) -> "WindowStats":
        return WindowStats.from_values(WindowStats.host_values(diag),
                                       step=step, dt=dt, wall_s=wall_s,
                                       n_cells=n_cells)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mlups"] = round(self.mlups, 2)
        d["wall_ms_per_step"] = round(self.wall_ms_per_step, 3)
        return d


class StepLogger:
    """Logs one JSON line per window to a stream (stderr by default) and,
    with ``csv_path``, one CSV row."""

    def __init__(self, stream=None, csv_path: Optional[str] = None):
        self.stream = stream if stream is not None else sys.stderr
        self.csv_path = csv_path
        self._csv_header_written = False
        self.t0 = time.perf_counter()

    def log(self, stats: WindowStats) -> None:
        d = stats.as_dict()
        print(json.dumps(d), file=self.stream, flush=True)
        if self.csv_path:
            mode = "a" if self._csv_header_written else "w"
            with open(self.csv_path, mode, newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(d))
                if not self._csv_header_written:
                    w.writeheader()
                    self._csv_header_written = True
                w.writerow(d)
