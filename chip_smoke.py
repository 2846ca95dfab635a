"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source, all
started together), holds each against its plain PyTorch version on the
card, runs three main paths through the library entry points, with the
kernels and with the plain composition:

  * the 3D lid-driven cavity at 256^3 (BASELINE config #5),
  * the 2D flagship, ``make_case("cavity", shape=(2048, 2048), re=1e4,
    upwind_gamma=0.8)`` (bench.py's default configuration), whose pressure
    solve runs the split-level DCT, and
  * the 3D LES step: the 256^3 cavity with the Smagorinsky closure,
    ``dataclasses.replace(case.sim, les=LESConfig(cs=0.17))``, what the JAX
    package's ``cli --case cavity3d --les-cs 0.17`` runs,

then times a 200-step run of each (launch counts reset just before each
run and read just after), each kernel against its plain version, the
split direct solve against the dense one and the LES step against its
plain composition. Any failed check raises; nothing is caught.

Output: one line per phase; then, before the last line, a JSON object with
each kernel's launches in the timed run, its largest error against the
plain version, and both times; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
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
from navierstokessolver_tpu_torch.les import (  # noqa: E402
    LESConfig, eddy_viscosity,
)
from navierstokessolver_tpu_torch.ops import (  # noqa: E402
    _native, fft_poisson, fused2d, fused3d, predictor3d,
)
from navierstokessolver_tpu_torch.ops.poisson import (  # noqa: E402
    build_poisson_op,
)

DEV = torch.device("cuda", 0)
SHAPE = (256, 256, 256)
RAGGED = (40, 24, 72)
SHAPE2 = (2048, 2048)
FLAGSHIP = dict(shape=SHAPE2, re=1e4, upwind_gamma=0.8)
RAGGED2 = (200, 136)           # no axis a multiple of 32
TIMED_STEPS = 200
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
}
SOURCES = ("fused3d", "fused2d", "predictor3d")
# the launch counters of the LES step's path
LES_PATH = ("nu_t_3d", "predictor_3d", "residual_3d", "correct_diag_3d")


def line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _name(shape) -> str:
    return "x".join(map(str, shape))


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
    line("phase2", shape=_name(grid.shape), gamma=gamma,
         max_abs_err=json.dumps({k: errs[k] for k, (_, src) in KERNELS.items()
                                 if src == "fused3d"}))


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


def timed_run(case, reset, counts) -> dict:
    """10 warm-up steps, then TIMED_STEPS steps of ``case`` by CUDA events,
    the launch counts reset just before and read just after (``counts()``:
    the path's counters); checks the gates (every kernel launched, finite
    fields of the right shape, max_div < 1e-3). Returns the run's
    numbers."""
    sim = case.sim
    st, _ = sim.run_scan(case.initial_state(), 10)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    st, diag = sim.run_scan(st, TIMED_STEPS)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    ms = start.elapsed_time(stop) / TIMED_STEPS
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
    if not max_div < 1e-3:
        raise AssertionError(f"max_div {max_div} not < 1e-3")
    cells = math.prod(sim.grid.shape)
    line("phase4", shape=_name(sim.grid.shape),
         les=None if sim.les is None else sim.les.cs, steps=TIMED_STEPS,
         ms_per_step=f"{ms:.4f}",
         mlups=f"{cells * 1e-3 / ms:.1f}", wall_s=f"{wall:.3f}",
         max_div=max_div, max_cfl=float(diag.max_cfl[-1]),
         poisson_res=float(diag.poisson_res[-1]),
         launches=json.dumps(launches),
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    return {"state": st, "launches": launches}


def time_pairs(calls, times) -> None:
    """Each (kernel, plain) pair timed in the order kernel, plain, plain,
    kernel (20 calls each), into ``times``."""
    for k, (kern, plain) in calls.items():
        times[k] = (time_ms(kern, 20), time_ms(plain, 20),
                    time_ms(plain, 20), time_ms(kern, 20))
        line("phase4", kernel=k, ms_kernel_plain_plain_kernel=json.dumps(
            [round(x, 4) for x in times[k]]))


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
    t0 = time.perf_counter()
    _native.load_all(SOURCES)                 # one nvcc per source, together
    build_s = time.perf_counter() - t0
    for src in SOURCES:
        ptxas = [l.strip() for l in _native.BUILD_INFO[src][1].splitlines()
                 if "registers" in l or "spill" in l]
        line("phase1", source=src, build_seconds=f"{build_s:.2f}",
             nvcc_seconds=f"{_native.BUILD_INFO[src][0]:.2f}",
             ptxas=json.dumps(ptxas))

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
    case2 = make_case("cavity", device=DEV, **FLAGSHIP)
    sim2 = case2.sim
    rag2 = GridSpec(RAGGED2, (1.0, 0.68))
    rag2_bcs = no_slip_box(rag2)
    rag2_bcs[(1, 1)] = BCSpec.wall((1.0, 0.0))
    for grid, bcs, dt, nu in ((rag2, rag2_bcs, 1e-3, 0.01),
                              (sim2.grid, sim2.bcs, sim2.params.dt,
                               sim2.params.nu)):
        for gamma in (0.0, 0.8):
            compare_kernels_2d(grid, bcs, dt, nu, gamma, gen, errs)
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

    # -- phase 3: 5 steps, kernels vs plain composition --------------------
    # 256^3: tests/test_fused_step.py's tolerances, except max_div: its
    # 5e-6 bound is for 16^3; float32 roundoff of the divergence at h =
    # 1/256 is ~3e-5, so both runs are held below 1e-3.
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

    # -- phase 4: the timed main paths --------------------------------------
    def reset_all():
        fused3d.reset_launch_counts()
        fused2d.reset_launch_counts()
        predictor3d.reset_launch_counts()

    run3 = timed_run(case, reset_all, lambda: dict(fused3d.LAUNCHES))
    st = run3["state"]
    g, bcs, pr = sim.grid, sim.bcs, sim.params
    u_star, rhs = fused3d.predictor_rhs_3d(g, bcs, st.u, pr.dt, pr.nu,
                                           pr.upwind_gamma, pr.rho, bc=sim.bc)
    scale = pr.dt / pr.rho
    times = {}
    time_pairs({
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
    }, times)
    solve_ms = time_ms(lambda: sim.dct_solver._direct(rhs), 10)
    line("phase4", shape=_name(SHAPE), dct_direct_ms=f"{solve_ms:.4f}")

    run2 = timed_run(case2, reset_all, lambda: dict(fused2d.LAUNCHES))
    st2 = run2["state"]
    g2, bcs2, pr2 = sim2.grid, sim2.bcs, sim2.params
    u_star2, rhs2 = fused2d.predictor_rhs_2d(
        g2, bcs2, st2.u, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho,
        bc=sim2.bc)
    scale2 = pr2.dt / pr2.rho
    time_pairs({
        "predictor_rhs_2d": (
            lambda: fused2d.predictor_rhs_2d(g2, bcs2, st2.u, pr2.dt, pr2.nu,
                                             pr2.upwind_gamma, pr2.rho,
                                             bc=sim2.bc),
            lambda: fused2d.predictor_rhs_2d_plain(
                g2, bcs2, st2.u, pr2.dt, pr2.nu, pr2.upwind_gamma, pr2.rho)),
        "correct_diag_2d": (
            lambda: fused2d.correct_diag_2d(g2, u_star2, st2.p, scale2),
            lambda: fused2d.correct_diag_2d_plain(g2, u_star2, st2.p,
                                                  scale2)),
    }, times)
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
            lambda: eddy_viscosity(g, bcs, st3.u, cfg)),
        "predictor_3d": (
            lambda: predictor3d.predictor_3d(g, bcs, st3.u, pr.dt, pr.nu,
                                             pr.upwind_gamma, nu_t=nu_t,
                                             bc=sim.bc),
            lambda: predictor3d.predictor_3d_plain(g, bcs, st3.u, pr.dt,
                                                   pr.nu, pr.upwind_gamma,
                                                   nu_t=nu_t)),
    }, times)
    steps = (time_ms(lambda: sim_les.step(st3), 10),
             time_ms(lambda: sim_les.step_plain(st3), 10),
             time_ms(lambda: sim_les.step_plain(st3), 10),
             time_ms(lambda: sim_les.step(st3), 10))
    line("phase4", shape=_name(SHAPE), les_cs=cfg.cs,
         step_ms_kernel_plain_plain_kernel=json.dumps(
             [round(x, 4) for x in steps]))

    launches = {**run_les["launches"], **run3["launches"], **run2["launches"]}
    report = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"navierstokessolver_tpu_torch/csrc/{src}.cu",
         "replaces": tpu, "launches": launches[k],
         "max_abs_err": errs[k],
         "ms": min(times[k][0], times[k][3]),
         "plain_ms": min(times[k][1], times[k][2])}
        for k, (tpu, src) in KERNELS.items()
    ]}
    print(f"card: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
