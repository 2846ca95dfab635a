"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, runs the 3D lid-driven cavity at 256^3
(BASELINE config #5) through the library entry points with the kernels and
with the plain composition, then times a 200-step run and each kernel
against its plain version. Any failed check raises; nothing is caught.

Output: one line per phase; then, before the last line, a JSON object with
each kernel's launches in the timed run, its largest error against the
plain version, and both times; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    return torch


torch = _require_cuda()

from navierstokessolver_tpu_torch.bcs import (  # noqa: E402
    BCSpec, apply_velocity_bcs, no_slip_box,
)
from navierstokessolver_tpu_torch.cases import make_case  # noqa: E402
from navierstokessolver_tpu_torch.grid import GridSpec  # noqa: E402
from navierstokessolver_tpu_torch.ops import _native, fused3d  # noqa: E402
from navierstokessolver_tpu_torch.ops.poisson import (  # noqa: E402
    build_poisson_op,
)

DEV = torch.device("cuda", 0)
SHAPE = (256, 256, 256)
RAGGED = (40, 24, 72)
TIMED_STEPS = 200
KERNELS = {
    "predictor_rhs_3d": "navierstokessolver_tpu/ops/pallas_kernels.py:1766",
    "correct_diag_3d": "navierstokessolver_tpu/ops/pallas_kernels.py:2588",
    "residual_3d": "navierstokessolver_tpu/ops/pallas_kernels.py:3330",
}
SOURCE = "navierstokessolver_tpu_torch/csrc/fused3d.cu"


def line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def close(name, got, ref, rtol, atol) -> float:
    """Assert |got - ref| <= atol + rtol*|ref| elementwise; max abs error."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside rtol={rtol} "
            f"atol={atol:.3g}; max abs err {float(err.max()):.3g}"
        )
    return float(err.max())


def random_state(grid, bcs, gen):
    u = tuple(torch.randn(grid.face_shape(a), generator=gen, device=DEV)
              for a in range(3))
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
    k_n, k_div, k_vel = fused3d.correct_diag_3d(grid, k_u, p, scale)
    p_n, p_div, p_vel = fused3d.correct_diag_plain(grid, k_u, p, scale)
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
    line("phase2", shape="x".join(map(str, grid.shape)), gamma=gamma,
         max_abs_err=json.dumps({k: errs[k] for k in KERNELS}))


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


def main() -> None:
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
    build_s = fused3d.build()
    ptxas = [l.strip() for l in _native.BUILD_INFO["fused3d"][1].splitlines()
             if "registers" in l or "spill" in l]
    line("phase1", build_seconds=f"{build_s:.2f}", ptxas=json.dumps(ptxas))

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

    # -- phase 3: 5 steps, kernels vs plain composition, 256^3 ------------
    # Tolerances of tests/test_fused_step.py's 5-step comparison, except
    # max_div: its 5e-6 bound is for 16^3; float32 roundoff of the
    # divergence at h = 1/256 is ~3e-5, so both runs are held below 1e-3.
    case = make_case("cavity3d", shape=SHAPE, device=DEV)
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
    line("phase3", steps=5, max_div_kernel=divs[0], max_div_plain=divs[1],
         max_cfl=float(d_k.max_cfl), poisson_res=float(d_k.poisson_res))

    # -- phase 4: the timed main path --------------------------------------
    st = case.initial_state()
    st, _ = sim.run_scan(st, 10)                      # warm-up
    torch.cuda.synchronize()
    fused3d.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    st, diag = sim.run_scan(st, TIMED_STEPS)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused3d.LAUNCHES)
    ms = start.elapsed_time(stop) / TIMED_STEPS
    cells = math.prod(SHAPE)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} launched {n} times in the run")
    for name, t in (("u0", st.u[0]), ("u1", st.u[1]), ("u2", st.u[2]),
                    ("p", st.p)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name} after the timed run")
    for a in range(3):
        if tuple(st.u[a].shape) != big.face_shape(a):
            raise AssertionError(f"u[{a}] shape {tuple(st.u[a].shape)}")
    max_div = float(diag.max_div.max())
    if not max_div < 1e-3:
        raise AssertionError(f"max_div {max_div} not < 1e-3")
    line("phase4", steps=TIMED_STEPS, ms_per_step=f"{ms:.4f}",
         mlups=f"{cells * 1e-3 / ms:.1f}", wall_s=f"{wall:.3f}",
         max_div=max_div, max_cfl=float(diag.max_cfl[-1]),
         poisson_res=float(diag.poisson_res[-1]),
         launches=json.dumps(launches),
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # per-kernel times at 256^3, kernel vs plain, on the run's own state
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    u_star, rhs = fused3d.predictor_rhs_3d(g, bcs, st.u, pr.dt, pr.nu,
                                           pr.upwind_gamma, pr.rho, bc=sim.bc)
    scale = pr.dt / pr.rho
    calls = {
        "predictor_rhs_3d": (
            lambda: fused3d.predictor_rhs_3d(g, bcs, st.u, pr.dt, pr.nu,
                                             pr.upwind_gamma, pr.rho,
                                             bc=sim.bc),
            lambda: fused3d.predictor_rhs_plain(g, bcs, st.u, pr.dt, pr.nu,
                                                pr.upwind_gamma, pr.rho)),
        "correct_diag_3d": (
            lambda: fused3d.correct_diag_3d(g, u_star, st.p, scale),
            lambda: fused3d.correct_diag_plain(g, u_star, st.p, scale)),
        "residual_3d": (
            lambda: fused3d.residual_3d(sim.op, st.p, rhs),
            lambda: fused3d.residual_plain(sim.op, st.p, rhs)),
    }
    times = {}
    for k, (kern, plain) in calls.items():
        times[k] = (time_ms(kern, 20), time_ms(plain, 20),
                    time_ms(plain, 20), time_ms(kern, 20))
        line("phase4", kernel=k, ms_kernel_plain_plain_kernel=json.dumps(
            [round(x, 4) for x in times[k]]))
    solve_ms = time_ms(lambda: sim.dct_solver._direct(rhs), 10)
    line("phase4", dct_direct_ms=f"{solve_ms:.4f}")

    report = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[k], "launches": launches[k],
         "max_abs_err": errs[k],
         "ms": min(times[k][0], times[k][3]),
         "plain_ms": min(times[k][1], times[k][2])}
        for k in KERNELS
    ]}
    print(f"card: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
