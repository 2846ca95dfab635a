"""ms/step of the PyTorch port's main paths, for comparing checkouts.

    python3 compare_steps.py [ROOT] [--label NAME] [--steps N]
        [--integrator {euler,rk2}] [--cfl X] [--convection] [--kernels]
        [--cylinder]

Imports ``navierstokessolver_tpu_torch`` from the checkout at ROOT (this
one by default) and times, on the first CUDA card, ``run_scan`` of each 3D
path of the port at 256^3: cavity3d and taylor_green3d on the transform
chain and on the fused trailing-axes route, cavity3d with LES (cs 0.17),
cavity3d in 4 and in 16 slabs and taylor_green3d in 4 (every slab on the
card); the 2D flagship, cavity 2048^2 at Re 1e4 with upwind gamma 0.8
and the direct solve (bench.py's default configuration), and the IBM
cylinder at 2048x1024 from the impulsive start (dctcg, the per-component
predictor kernel), whose steps the host's enqueue bounds, and the
staircase cylinder at 2048x1024 (``make_case("cylinder")``, the JAX
package's default: fused kernels 4-5 in their masked mode since the
convective slice, kernel 8 and the plain BC and correction passes before
it). Each path runs
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
instead, in each mode that the 3D paths run them (device time: 20 calls
captured in a CUDA graph and replayed, the better of two means; a 2D or
256x128x128 call is shorter than its wrapper's host time, which events
would read): walls (cavity3d
256^3 after 10 steps), periodic and ``base`` (taylor_green3d 256^3), the
static force (duct_periodic 512x128x128), a forcing volume (kolmogorov
256^3) and thermal (heated_cavity 256^3, Ra 1e6), and prints the ptxas
report of the checkout's fused3d build (registers/spill bytes/shared
memory by instantiation) in the JSON line's ``ptxas``; kernels 4-5 in
theirs (walls: the flagship cavity 2048^2 after 10 steps; periodic and
``base``: taylor_green 2048^2; the static force: channel_periodic
2048x512; thermal: heated_cavity 2048^2, Ra 1e8) and the sphere's open
and masked modes of kernels 1-2 (256x128x128, the outlet an OUTFLOW face),
the modes every checkout since the sphere's slice has, and where the
checkout has them the heated bodies' (the heated sphere's thermal masked
corrector, the 3D enclosure's forced masked predictor with theta, Euler
and base, at 128^3; an older checkout skips them), with the fused2d
build's ptxas report; and kernels 6-7 on the LES cavity's walls (256^3
after 10 steps; the predictor at gamma 0 and 0.8, with and without nu_t),
with the predictor3d build's ptxas report; kernel 6 on the periodic box
and in its masked mode and kernel 8 on the cylinder's open table, and
where the checkout has them kernel 6's forced mode (the duct's static
force, Kolmogorov's volume, the heated cavity's buoyancy) and kernel 8's
wrap modes (decaying turbulence 2048^2, with and without its two subgrid
volumes), with the predictor2d build's report. ``--cylinder`` runs the staircase cylinder at
2048x1024 alone and adds its profile: busy ms a step and launches a step
(torch.profiler over 5 steps), the idle share 1 - busy / ms, and the
synchronizing calls a step (``torch.cuda.set_sync_debug_mode("warn")``
over 20 steps).

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
    ap.add_argument("--cylinder", action="store_true",
                    help="the staircase cylinder alone, with its profile")
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
    staircase = dataclasses.replace(
        make_case("cylinder", shape=(2048, 1024), device=dev, **params),
        init=impulsive_start_state)
    if args.cylinder:
        return cylinder_profile(args, params, staircase, ms_per_step)

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
        "staircase_cylinder_2048x1024": staircase,
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
    print(f"card: {card()}")
    print(json.dumps({
        "label": args.label or args.root, "root": args.root, **params,
        "ms_per_step": {k: v[0] for k, v in out.items()},
        "host_ms_per_step": {k: v[1] for k, v in out.items()}}), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cylinder_profile(args, params, case, ms_per_step) -> None:
    """``--cylinder``: the staircase cylinder's ms/step and host ms/step
    (as the paths'), busy ms and launches a step, the idle share and the
    synchronizing calls a step."""
    import warnings

    import torch

    from navierstokessolver_tpu_torch.step_profile import device_profile

    sim = case.sim
    ms, host_ms = ms_per_step(case)
    st, _ = sim.run_scan(case.initial_state(), 10)
    kernels, _, launches = device_profile(lambda: sim.run_scan(st, 5), 1)
    busy = sum(kernels.values()) / 5
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run_scan(st, 20)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing" in str(w.message)
                for w in caught) / 20
    print(f"card: {card()}")
    print(json.dumps({
        "label": args.label or args.root, "root": args.root, **params,
        "path": "staircase_cylinder_2048x1024", "fused": sim.fused,
        "ms_per_step": ms, "host_ms_per_step": host_ms,
        "busy_ms_per_step": round(busy, 4),
        "launches_per_step": launches / 5,
        "idle_share": round(max(0.0, 1.0 - busy / ms), 4),
        "syncs_per_step": syncs}), flush=True)


def kernel_ms(fn, reps: int = 20) -> float:
    """The device ms of a call: ``reps`` calls captured in one CUDA graph
    (after two eager warm-up calls), replayed 5 times between CUDA events,
    the better of two such means. The host's enqueue does not enter (a
    2048^2 or 256x128x128 call is shorter than a wrapper's host time); the
    calls' buffers (>= 84 MB) exceed the card's 50 MB L2."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    keep = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            keep.append(fn())
    graph.replay()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / (5 * reps))
    del keep, graph
    return round(best, 4)


def heated_modes(out, name, sim, state, base=None) -> None:
    """Kernels 1-2 with theta on ``sim``'s table and obstacle (the masked
    mode's stencil code), into ``out``: the predictor (with theta where
    the scalar is buoyant; ``base``: also rk2's base form) and the
    corrector advancing theta."""
    from navierstokessolver_tpu_torch.ops import fused3d

    g, b, pr, cfg = sim.grid, sim.bcs, sim.params, sim.scalar
    dts = sim._dts(None)
    code = sim._code
    buoy = state.theta if cfg.buoyant else None

    def pred(b_=None):
        return fused3d.predictor_rhs_3d(
            g, b, state.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho,
            bc=sim.bc, dts=dts, base=b_, theta=buoy, scalar=cfg,
            thermal=sim.thermal, code=code)
    us, _ = pred()
    out[f"predictor {name}"] = kernel_ms(pred)
    if base is not None:
        out[f"predictor {name} base"] = kernel_ms(lambda: pred(base))
    out[f"corrector {name}"] = kernel_ms(lambda: fused3d.correct_diag_3d(
        g, us, state.p, dts[2], (False,) * 3, theta=state.theta, scalar=cfg,
        dt=dts[0], thermal=sim.thermal, bcs=b, code=code))


def kernel_modes(dev, args, root) -> None:
    """``--kernels``: kernels 1-2 in each mode of the 3D paths, kernels 4-5
    in each mode of the 2D paths."""
    import torch

    from chip_smoke import ptxas_summary
    from navierstokessolver_tpu_torch.bcs import periodic_axes
    from navierstokessolver_tpu_torch.cases import make_case
    from navierstokessolver_tpu_torch.cases.cylinder import (
        impulsive_start_state,
    )
    from navierstokessolver_tpu_torch.ops import _native, fused2d, fused3d

    from navierstokessolver_tpu_torch.les import LESConfig
    from navierstokessolver_tpu_torch.ops import predictor3d

    _native.load_all(["fused3d", "fused2d", "predictor3d", "predictor2d"])
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
    # kernels 6-7 on walls (the LES cavity's instantiations), at gamma 0
    # (the case's) and 0.8, the predictor with and without nu_t
    les = dataclasses.replace(cav.sim, les=LESConfig(cs=0.17))
    g, b, pr = les.grid, les.bcs, les.params
    dts = les._dts(None)
    nu_t = predictor3d.nu_t_3d(g, b, st.u, les.les, bc=les.bc)
    out["nu_t walls"] = kernel_ms(lambda: predictor3d.nu_t_3d(
        g, b, st.u, les.les, bc=les.bc))
    for gamma in (0.0, 0.8):
        for nt in (nu_t, None):
            out[f"les predictor walls g{gamma} les={nt is not None}"] = \
                kernel_ms(lambda gamma=gamma, nt=nt: predictor3d.predictor_3d(
                    g, b, st.u, dts[0], pr.nu, gamma, nu_t=nt, bc=les.bc))
    tg = make_case("taylor_green3d", shape=SHAPE, device=dev)
    st = tg.initial_state()
    modes("periodic", tg, st, base=st.u)
    les_modes(out, dev, st)
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
    # the sphere's open and masked modes (both kernels take the table)
    sph = make_case("sphere", device=dev)
    st, _ = sph.sim.run_scan(impulsive_start_state(sph.sim), 5)
    for name, code in (("open", None), ("masked", sph.sim.op.code)):
        g, b, pr = sph.sim.grid, sph.sim.bcs, sph.sim.params
        dts = sph.sim._dts(None)
        us, _ = fused3d.predictor_rhs_3d(
            g, b, st.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho,
            bc=sph.sim.bc, dts=dts, code=code)
        out[f"predictor {name}"] = kernel_ms(
            lambda code=code: fused3d.predictor_rhs_3d(
                g, b, st.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho,
                bc=sph.sim.bc, dts=dts, code=code))
        out[f"corrector {name}"] = kernel_ms(
            lambda code=code, us=us: fused3d.correct_diag_3d(
                g, us, st.p, dts[2], (False,) * 3, bcs=b, code=code))
    # the heated bodies' modes, where the checkout has them: the heated
    # sphere (kernel 2's thermal masked mode) and the 3D enclosure at 128^3
    # (kernel 1's forced masked mode with theta's buoyancy, Euler and base)
    try:
        hs = make_case("sphere", heated=True, device=dev)
        from navierstokessolver_tpu_torch.cases.convection import (
            ENCLOSURE_CENTER_3D)

        enc = make_case("heated_enclosure", shape=(128, 128, 128),
                        center=ENCLOSURE_CENTER_3D, device=dev)
    except (ImportError, NotImplementedError):
        hs = enc = None
    if hs is not None:
        st = dataclasses.replace(impulsive_start_state(hs.sim),
                                 theta=hs.sim.initial_state().theta)
        st, _ = hs.sim.run_scan(st, 5)
        heated_modes(out, "heated sphere", hs.sim, st)
        st, _ = enc.sim.run_scan(enc.initial_state(), 2)
        heated_modes(out, "heated_enclosure", enc.sim, st, base=st.u)

    def modes_2d(name, case, state, base=None, theta=None):
        sim = case.sim
        g, b, pr = sim.grid, sim.bcs, sim.params
        per = periodic_axes(g, b)
        dts = sim._dts(None)
        force = sim._force_numbers(sim.forcing)
        buoy = theta if sim.scalar is not None and sim.scalar.buoyant \
            else None

        def pred(b_=None):
            return fused2d.predictor_rhs_2d(
                g, b, state.u, dts[0], pr.nu, pr.upwind_gamma, pr.rho,
                bc=sim.bc, dts=dts, base=b_, force=force, theta=buoy,
                scalar=sim.scalar, thermal=sim.thermal)
        us, _ = pred()
        out[f"predictor_2d {name}"] = kernel_ms(pred)
        if base is not None:
            out[f"predictor_2d {name} base"] = kernel_ms(lambda: pred(base))
        ckw = {} if theta is None else dict(theta=theta, scalar=sim.scalar,
                                           dt=dts[0], thermal=sim.thermal)
        out[f"corrector_2d {name}"] = kernel_ms(
            lambda: fused2d.correct_diag_2d(g, us, state.p, dts[2], per,
                                            **ckw))

    cav2 = make_case("cavity", shape=(2048, 2048), re=1e4, upwind_gamma=0.8,
                     device=dev)
    st, _ = cav2.sim.run_scan(cav2.initial_state(), 10)
    modes_2d("walls", cav2, st)
    tg2 = make_case("taylor_green", shape=(2048, 2048), device=dev)
    st = tg2.initial_state()
    modes_2d("periodic", tg2, st, base=st.u)
    chp = make_case("channel_periodic", shape=(2048, 512), device=dev)
    modes_2d("force", chp, chp.initial_state())
    hc2 = make_case("heated_cavity", shape=(2048, 2048), ra=1e8, device=dev)
    st = hc2.initial_state()
    modes_2d("thermal", hc2, st, theta=st.theta)
    print(f"card: {card()}")
    print(json.dumps({
        "label": args.label or args.root, "root": args.root,
        "kernel_ms": out,
        "ptxas": ptxas_summary(_native.BUILD_INFO["fused3d"][1]),
        "ptxas_2d": ptxas_summary(_native.BUILD_INFO["fused2d"][1]),
        "ptxas_les": ptxas_summary(_native.BUILD_INFO["predictor3d"][1]),
        "ptxas_predictor2d": ptxas_summary(
            _native.BUILD_INFO["predictor2d"][1])}),
        flush=True)


def les_modes(out, dev, tg_state) -> None:
    """Kernels 6 and 8 in each mode of the LES paths, into ``out``: kernel
    6 with nu_t on the periodic box (taylor_green3d 256^3, ``tg_state``)
    and in its masked mode (the sphere 256x128x128), kernel 8 on the
    cylinder's open table at 2048x1024 (with and without a forcing volume);
    and where the checkout has them, kernel 6's forced mode (the duct's
    static force at 512x128x128, Kolmogorov's volume at 256^3, the 3D
    heated cavity's buoyancy at 256^3) and kernel 8's wrap modes (decaying
    turbulence 2048^2 with and without two volumes; an older checkout
    skips them)."""
    import torch

    from navierstokessolver_tpu_torch import les as les_mod
    from navierstokessolver_tpu_torch.cases import make_case
    from navierstokessolver_tpu_torch.cases.cylinder import (
        impulsive_start_state,
    )
    from navierstokessolver_tpu_torch.ops import predictor2d, predictor3d

    cfg = les_mod.LESConfig(cs=0.17)

    def k6(name, sim, u, **kw):
        g, b, pr = sim.grid, sim.bcs, sim.params
        nu_t = predictor3d.nu_t_3d(g, b, u, cfg, bc=sim.bc)
        dt = sim._dts(None)[0]
        out[f"les predictor {name}"] = kernel_ms(
            lambda: predictor3d.predictor_3d(
                g, b, u, dt, pr.nu, pr.upwind_gamma, nu_t=nu_t, bc=sim.bc,
                **kw))

    def k8(name, sim, u, forcing=None):
        g, b, pr = sim.grid, sim.bcs, sim.params
        ghosts = predictor2d.ghost_table(g, b, u[0].device)
        dt = sim._dts(None)[0]
        out[f"predictor_component_2d {name}"] = kernel_ms(
            lambda: predictor2d.predictor_2d(g, b, u, dt, pr.nu,
                                             pr.upwind_gamma, ghosts=ghosts,
                                             forcing=forcing))

    tg = make_case("taylor_green3d", shape=SHAPE, device=dev)
    k6("periodic", tg.sim, tg_state.u)
    sph = make_case("sphere", device=dev)
    st, _ = sph.sim.run_scan(impulsive_start_state(sph.sim), 5)
    k6("masked", sph.sim, st.u, code=sph.sim.op.code)
    cyl = make_case("cylinder", shape=(2048, 1024), device=dev)
    st = impulsive_start_state(cyl.sim)
    k8("open", cyl.sim, st.u)
    g = cyl.sim.grid
    vol = torch.full((g.shape[0] - 1, g.shape[1]), 0.5, device=dev)
    k8("open volume", cyl.sim, st.u, (vol, None))
    try:
        duct = make_case("duct_periodic", shape=(512, 128, 128), device=dev)
        k6("force", duct.sim, duct.initial_state().u,
           force=duct.sim._force_numbers(duct.sim.forcing))
        kol = make_case("kolmogorov", shape=SHAPE, device=dev)
        k6("volume", kol.sim, tg_state.u, force_vol=kol.sim.force_vol)
        hc = make_case("heated_cavity", shape=SHAPE, ra=1e6, device=dev)
        st = hc.initial_state()
        k6("buoyancy", hc.sim, st.u, theta=st.theta, scalar=hc.sim.scalar,
           thermal=hc.sim.thermal)
        tu = make_case("decaying_turbulence", shape=(2048, 2048),
                       device=dev)
        st = tu.initial_state()
        k8("periodic", tu.sim, st.u)
        sgs = les_mod.sgs_forcing(tu.sim.grid, tu.sim.bcs, st.u, cfg)
        k8("periodic sgs", tu.sim, st.u, sgs)
    except (TypeError, NotImplementedError) as e:
        out["les_new_modes"] = f"not in this checkout: {e}"


if __name__ == "__main__":
    main()
