"""PyTorch port vs JAX package: heated and forced bodies in 3D on the CPU.

The heated sphere (``make_case("sphere", heated=True)``: a passive
temperature, theta 0 at the inflow, an isothermal body at 1), the 3D
``heated_enclosure`` (Boussinesq buoyancy from a hot sphere in a cold box),
isothermal and adiabatic blocks in a stirred box and a forced block run
kernels 1-2's forced and thermal open modes in the port, whose plain
versions run here; JAX's ``run_scan`` runs its jnp step on the CPU. Both
start from the same state. The cases and tolerances are the JAX package's
own (tests/test_fused_step.py ``test_fused3d_heated_obstacle_matches_
reference``, ``..._heated_sphere_outflow_...``, ``..._adiabatic_obstacle_
...``, ``..._buoyant_obstacle_...``): u and theta rtol 2e-5 / atol 2e-6,
the isothermal body's cells exactly its value. An adiabatic body's solid
cells are held at their values, as JAX's jnp step holds them (its fused
kernel lets them diffuse behind the closed faces; the fluid cells are the
same either way). The kernels' modules are held to JAX's Pallas kernels
in interpret mode (``predictor_rhs_3d_internal``,
``correct_diag_3d_internal``) on the fluid cells, at the same tolerances.
The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu import scalar as jsc
from navierstokessolver_tpu import solver as jsolver
from navierstokessolver_tpu.cases import make_case as jax_make_case
from navierstokessolver_tpu.cases.cylinder import (
    impulsive_start_state as jax_impulsive_start,
)
from navierstokessolver_tpu.ops import pallas_kernels as jpk
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import convert
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch import solver as tsolver
from navierstokessolver_tpu_torch.cases import make_case
from navierstokessolver_tpu_torch.cases.cylinder import impulsive_start_state
from navierstokessolver_tpu_torch.ops import fused3d

CPU = torch.device("cpu")
N = 16
STEPS = 6
# JAX's heated sphere test's sphere (16 cells over 8 diameters of 1.6)
SPHERE = dict(shape=(N, N, N), lengths=(8.0, 8.0, 8.0),
              center=(2.0, 4.1, 3.9), diameter=1.6, poisson_method="mg",
              re=50.0)
ENCLOSURE = dict(shape=(N, N, N), ra=1e4, diameter=0.35,
                 center=(0.5, 0.5, 0.45))


def _to_port(st):
    """A JAX state as the port's, on the CPU (theta and p_prev too)."""
    def opt(x):
        return None if x is None else np.asarray(x)
    return convert.state_from_numpy(
        [np.asarray(c) for c in st.u], np.asarray(st.p), CPU,
        p_prev=opt(st.p_prev), theta=opt(st.theta))


def _close(got, ref, what, rtol=2e-5, atol=2e-6, where=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    if where is not None:
        got, ref = got[where], ref[where]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _check_run(jr, tr):
    """u and theta of two run_scan results at JAX's tolerances, the
    pressure-solve counts within one a step (the V-cycles at tol 1e-6 stop
    at float32's floor: 5 against 4 in a step of the block)."""
    (js, jd), (ts, td) = jr, tr
    for a in range(3):
        _close(ts.u[a], js.u[a], f"u[{a}]")
    _close(ts.theta, js.theta, "theta")
    diff = np.abs(td.poisson_iters.numpy().astype(int)
                  - np.asarray(jd.poisson_iters).astype(int))
    assert diff.max() <= 1, (td.poisson_iters, jd.poisson_iters)


def _block_sims(body=None, scalar_bcs=None, forcing=None, gamma=0.3):
    """JAX's and the port's simulations of the block configuration of
    JAX's heated-obstacle tests: 16^3 unit box, no-slip walls with the
    (0, 1) face stirred at (0, 0.4, 0), a solid 4^3 block at [6, 10)^3, mg
    at tol 1e-6; with a scalar of ``scalar_bcs`` and ``body`` (a JAX
    ScalarBC) or without, with ``forcing``."""
    jg = jgrid.GridSpec((N, N, N), (1.0, 1.0, 1.0))
    tg = tgrid.GridSpec((N, N, N), (1.0, 1.0, 1.0))
    jb, tb = jbcs.no_slip_box(jg), tbcs.no_slip_box(tg)
    jb[(0, 1)] = jbcs.BCSpec.wall((0.0, 0.4, 0.0))
    tb[(0, 1)] = tbcs.BCSpec.wall((0.0, 0.4, 0.0))
    solid = np.zeros((N, N, N), bool)
    solid[6:10, 6:10, 6:10] = True
    jcfg = tcfg = None
    if scalar_bcs is not None:
        jcfg = jsc.ScalarConfig(bcs=scalar_bcs, diffusivity=2e-3,
                                upwind_gamma=gamma, body_bc=body)
        tcfg = convert.scalar_config_from_jax(jcfg)
    jp = jsolver.SimParams(dt=2e-3, nu=5e-3, upwind_gamma=gamma,
                           poisson=jsolver.PoissonConfig(
                               method="mg", tol=1e-6, max_iters=60))
    tp = tsolver.SimParams(dt=2e-3, nu=5e-3, upwind_gamma=gamma,
                           poisson=tsolver.PoissonConfig(
                               method="mg", tol=1e-6, max_iters=60))
    jsim = jsolver.Simulation.build(jg, jb, jp, solid=solid, scalar=jcfg,
                                    forcing=forcing)
    tsim = tsolver.Simulation.build(tg, tb, tp, CPU, solid=solid,
                                    scalar=tcfg, forcing=forcing)
    assert tsim.fused and tsim.face_masks is not None
    return jsim, tsim, solid


def test_isothermal_block_matches_jax():
    """JAX's test_fused3d_heated_obstacle_matches_reference: a passive
    scalar, theta 0 on the (1, 0) face, adiabatic elsewhere, an isothermal
    block at 1; the body stays at 1 and heat leaves it."""
    bcs = {(a, s): (jsc.ScalarBC.dirichlet(0.0) if (a, s) == (1, 0)
                    else jsc.ScalarBC.adiabatic())
           for a in range(3) for s in (0, 1)}
    jsim, tsim, solid = _block_sims(jsc.ScalarBC.dirichlet(1.0), bcs)
    st = jsim.initial_state()
    assert np.all(np.asarray(st.theta)[solid] == 1.0)
    tr = tsim.run_scan(_to_port(st), STEPS)
    _check_run(jsim.run_scan(st, STEPS), tr)
    th = tr[0].theta.numpy()
    assert np.all(th[solid] == 1.0)
    assert float(th[5, 8, 8]) > 1e-4


def test_adiabatic_block_matches_jax():
    """JAX's test_fused3d_adiabatic_obstacle_matches_reference (theta 1
    and 0 on the faces of axis 1, adiabatic elsewhere and on the body),
    from its linear seed with the solid cells seeded non-linearly: the jnp
    step holds them, so they keep the seed bit for bit (a diffusing solid
    would move a non-linear profile)."""
    bcs = {(a, s): (jsc.ScalarBC.dirichlet(1.0) if (a, s) == (1, 0)
                    else jsc.ScalarBC.dirichlet(0.0) if (a, s) == (1, 1)
                    else jsc.ScalarBC.adiabatic())
           for a in range(3) for s in (0, 1)}
    jsim, tsim, solid = _block_sims(jsc.ScalarBC.adiabatic(), bcs)
    y = np.linspace(1.0, 0.0, N)[None, :, None]
    th0 = np.array(np.broadcast_to(y, (N, N, N)), np.float32)
    x = np.arange(N, dtype=np.float32)
    bump = np.sin(0.7 * x)[:, None, None] * np.cos(0.4 * x)[None, :, None] \
        * (x[None, None, :] / N) ** 2
    th0[solid] = (th0 + bump.astype(np.float32))[solid]
    st = dataclasses.replace(jsim.initial_state(), theta=jnp.asarray(th0))
    tr = tsim.run_scan(_to_port(st), STEPS)
    _check_run(jsim.run_scan(st, STEPS), tr)
    np.testing.assert_array_equal(tr[0].theta.numpy()[solid], th0[solid])


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_heated_sphere_matches_jax(integrator):
    """JAX's test_fused3d_heated_sphere_outflow_matches_reference (Euler,
    and rk2 as its buoyant test runs both): the heated sphere with an
    OUTFLOW face at (0, 1) from the impulsive start with initial_state's
    theta; the body stays at 1, the thermal wake leaves downstream."""
    jc = jax_make_case("sphere", heated=True, integrator=integrator,
                       **SPHERE)
    tc = make_case("sphere", heated=True, integrator=integrator,
                   device="cpu", **SPHERE)
    sim = tc.sim
    assert sim.fused and sim.scalar_solid is not None and not any(
        sim.scalar.buoyancy)
    st = dataclasses.replace(jax_impulsive_start(jc.sim),
                             theta=jc.sim.initial_state().theta)
    tr = sim.run_scan(_to_port(st), STEPS)
    _check_run(jc.sim.run_scan(st, STEPS), tr)
    th = tr[0].theta.numpy()
    assert np.all(th[sim.scalar_solid.numpy()] == 1.0)
    assert th[8:, 8, 8].max() > 1e-3
    # the port's own start is JAX's
    own = dataclasses.replace(impulsive_start_state(sim),
                              theta=sim.initial_state().theta)
    for a in range(3):
        np.testing.assert_array_equal(own.u[a].numpy(), np.asarray(st.u[a]))
    np.testing.assert_array_equal(own.theta.numpy(), np.asarray(st.theta))


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_heated_enclosure_3d_matches_jax(integrator):
    """JAX's test_fused3d_buoyant_obstacle_matches_reference: the 3D
    heated_enclosure (theta's buoyancy through kernel 1's masked mode, the
    masked thermal corrector), Euler and rk2; w develops above the body."""
    jc = jax_make_case("heated_enclosure", integrator=integrator,
                       **ENCLOSURE)
    tc = make_case("heated_enclosure", integrator=integrator, device="cpu",
                   **ENCLOSURE)
    assert tc.sim.fused and any(tc.sim.scalar.buoyancy)
    st = jc.initial_state()
    tr = tc.sim.run_scan(_to_port(st), STEPS)
    _check_run(jc.sim.run_scan(st, STEPS), tr)
    assert float(tr[0].u[2].abs().max()) > 1e-5
    assert np.all(tr[0].theta.numpy()[tc.sim.scalar_solid.numpy()] == 1.0)


def test_forced_block_matches_jax():
    """A static body force with the block in the stirred box (kernel 1's
    forced masked mode): a shear force 0.5 sin(2 pi y) on u_0 (a forcing
    volume; a uniform force in a closed box is a gradient, which the
    pressure takes up) and -0.2 on u_2 (the buffer's number); u equals
    JAX's run_scan and moves off the unforced run's."""
    y = (np.arange(N, dtype=np.float32) + 0.5) / N
    shear = (0.5 * np.sin(2 * np.pi * y)).astype(np.float32)[None, :, None]
    jsim, tsim, _ = _block_sims(forcing=(shear, None, -0.2))
    assert tsim.force_vol[0] is not None
    st = jsim.initial_state()
    jr, tr = jsim.run_scan(st, STEPS), tsim.run_scan(_to_port(st), STEPS)
    for a in range(3):
        _close(tr[0].u[a], jr[0].u[a], f"u[{a}]")
    free, _, _ = _block_sims()
    assert float(jnp.max(jnp.abs(jr[0].u[0] - free.run_scan(st, STEPS)[0]
                                 .u[0]))) > 1e-4


def _interpret_pieces(jsim):
    """JAX's fused 3D kernels' tile, double-buffer flag and face codes of
    ``jsim``."""
    fs = dataclasses.replace(jsim, params=dataclasses.replace(
        jsim.params, use_pallas=True), pallas_interpret=True)
    assert fs._fused3d_ok()
    tile, db = fs._tile_db_3d()
    codes, fcode = fs._face_codes_3d()
    return tile, db, codes, fcode


def _kernel_case(jsim, tsim, seed, th_solid=None):
    """Kernels 1-2 (their plain versions) against JAX's Pallas kernels in
    interpret mode on one random state of ``jsim``'s table (u BC- and
    mask-consistent, theta uniform on [0, 1) with ``th_solid`` in the
    solid, a random p): u*, the RHS, u_new and theta on the fluid cells;
    the port's solid cells at the body's value (isothermal) or their own
    (adiabatic)."""
    jg, jb, cfg = jsim.grid, jsim.bcs, jsim.scalar
    tg, tb, tcfg = tsim.grid, tsim.bcs, tsim.scalar
    tile, db, codes, fcode = _interpret_pieces(jsim)
    rng = np.random.default_rng(seed)
    ju = jbcs.apply_velocity_bcs(jg, jb, tuple(
        jnp.asarray(rng.normal(size=jg.face_shape(a)).astype(np.float32))
        for a in range(3)), jsim.face_masks)
    theta = rng.random(jg.shape).astype(np.float32)
    solid = (np.zeros(jg.shape, bool) if tsim.scalar_solid is None
             else tsim.scalar_solid.numpy())
    if th_solid is not None:
        theta[solid] = th_solid
    p = rng.normal(size=jg.shape).astype(np.float32)
    dt, rho = jsim.params.dt, jsim.params.rho
    n0, n1, n2 = jg.shape
    buoy = cfg.buoyancy if any(b != 0.0 for b in cfg.buoyancy) else None
    force = jsim._static_forcing()
    (o0, o1, o2), j_rhs = jpk.predictor_rhs_3d_internal(
        jg, jb, jpk.to_internal_3d(jg, ju, tile), dt, jsim.params.nu,
        jsim.params.upwind_gamma, rho=rho, tile=tile, db=db, interpret=True,
        face_codes=codes, fluid_code=fcode, forcing=force,
        theta=jpk.pad_theta_3d(jg, jnp.asarray(theta), tile) if buoy
        else None, buoyancy=buoy, theta_ref=cfg.theta_ref)
    tu = tuple(torch.from_numpy(np.array(c)) for c in ju)
    code = tsim._code
    t_star, t_rhs = fused3d.predictor_rhs_3d(
        tg, tb, tu, dt, tsim.params.nu, tsim.params.upwind_gamma, rho,
        theta=torch.from_numpy(theta) if buoy else None, scalar=tcfg,
        force=tsim._force_numbers(tsim.forcing), code=code)
    _close(t_star[0], o0[:n0 + 1, :n1, :n2], "u*[0]", 1e-5, 1e-5)
    _close(t_star[1], o1[:n0, :n1 + 1, :n2], "u*[1]", 1e-5, 1e-5)
    _close(t_star[2][:, :, :n2], o2[:n0, :n1, :n2], "u*[2]", 1e-5, 1e-5)
    _close(t_rhs, j_rhs, "rhs", 1e-4, 3e-7 * float(jnp.max(jnp.abs(j_rhs))))
    # the corrector on JAX's u* (its exact faces), both sides
    ju_star = jpk.from_internal_3d(jg, jb, (o0, o1, o2))
    ju_star = (ju_star[0], ju_star[1],
               jnp.concatenate([ju_star[2], ju_star[3]], axis=2))
    neumann = cfg.body_bc is not None and \
        cfg.body_bc.kind is jsc.ScalarBCKind.NEUMANN
    iu_new, _, j_vel, j_th = jpk.correct_diag_3d_internal(
        jg, jb, jpk.to_internal_3d(jg, ju_star, tile), jnp.asarray(p),
        dt / rho, tile=tile, db=db, interpret=True, face_codes=codes,
        fluid_code=fcode, theta=jpk.pad_theta_3d(jg, jnp.asarray(theta),
                                                 tile),
        scalar_cfg=cfg, dt=dt, body_neumann=neumann)
    t_us = tuple(torch.from_numpy(np.array(c)) for c in ju_star)
    t_new, _, t_vel, t_th = fused3d.correct_diag_3d(
        tg, t_us, torch.from_numpy(p), dt / rho, (False,) * 3,
        theta=torch.from_numpy(theta), scalar=tcfg, dt=dt, bcs=tb, code=code)
    j_new = jpk.from_internal_3d(jg, jb, iu_new)
    _close(t_new[0], j_new[0], "u_new[0]", 1e-5, 1e-5)
    _close(t_new[1], j_new[1], "u_new[1]", 1e-5, 1e-5)
    _close(t_new[2][:, :, :n2], j_new[2], "u_new[2]", 1e-5, 1e-5)
    _close(t_vel, j_vel, "max_vel", 1e-4, 0.0)
    _close(t_th, j_th[:n0, :n1, :n2], "theta", where=~solid)
    if solid.any():
        held = (theta[solid] if neumann
                else np.float32(cfg.body_bc.value))
        np.testing.assert_array_equal(t_th.numpy()[solid], held)


def test_kernel_modules_match_pallas_interpret():
    """Kernels 1-2's new modes (their plain versions) against JAX's
    interpret-mode kernels: the masked modes with a buoyant scalar and a
    static force, an isothermal body and an adiabatic one
    (``body_neumann``), and the open modes on the heated sphere's table
    (theta's flux through the OUTFLOW face at (0, 1) from the corrected
    inner face's copy). Every case runs; the assertion names each that
    failed."""
    bcs = {(a, s): (jsc.ScalarBC.dirichlet(0.2) if (a, s) == (1, 0)
                    else jsc.ScalarBC.adiabatic())
           for a in range(3) for s in (0, 1)}
    failed = []

    def case(name, fn):
        try:
            fn()
        except AssertionError as e:
            failed.append(f"{name}: {str(e).splitlines()[0]}")

    for name, body, th_solid in (
            ("isothermal", jsc.ScalarBC.dirichlet(1.3), 1.3),
            ("adiabatic", jsc.ScalarBC.adiabatic(), None)):
        jsim, tsim, _ = _block_sims(body, bcs, forcing=(0.3, None, -0.2))
        jcfg = dataclasses.replace(jsim.scalar, buoyancy=(0.3, 0.0, 1.0),
                                   theta_ref=0.4)
        jsim = dataclasses.replace(jsim, scalar=jcfg)
        tsim = dataclasses.replace(
            tsim, scalar=convert.scalar_config_from_jax(jcfg))
        case(name, lambda: _kernel_case(jsim, tsim, 31, th_solid))
    jc = jax_make_case("sphere", heated=True, **SPHERE)
    jopen = jsolver.Simulation.build(jc.sim.grid, jc.sim.bcs, jc.sim.params,
                                     scalar=jc.sim.scalar)
    tc = make_case("sphere", heated=True, device="cpu", **SPHERE)
    topen = tsolver.Simulation.build(tc.sim.grid, tc.sim.bcs, tc.sim.params,
                                     CPU, scalar=tc.sim.scalar)
    assert fused3d.open_mask(topen.grid, topen.bcs) & 2
    case("open", lambda: _kernel_case(jopen, topen, 32))
    assert not failed, "\n".join(failed)


def test_heated_sphere_state_cli_and_raises(tmp_path):
    """The state with theta through convert.py both ways; the heated
    sphere through the command line (``--config`` with ``heated``), a
    resume equal to the unbroken run; a scalar with the IBM or a
    CONVECTIVE face raises 'Other BC kinds', a force with a CONVECTIVE
    face and a scalar with the cut-cell pressure 'Physics extensions'."""
    from navierstokessolver_tpu_torch.cli import main

    jc = jax_make_case("sphere", heated=True, **SPHERE)
    js = dataclasses.replace(jax_impulsive_start(jc.sim),
                             theta=jc.sim.initial_state().theta)
    ts = _to_port(js)
    u, p, theta = convert.state_to_numpy(ts, with_theta=True)
    np.testing.assert_array_equal(theta, np.asarray(js.theta))
    for a in range(3):
        np.testing.assert_array_equal(u[a], np.asarray(js.u[a]))
    cfg = tmp_path / "heated.json"
    cfg.write_text(json.dumps({"heated": True}))
    base = ["--platform", "cpu", "--case", "sphere", "--shape", "16,8,8",
            "--config", str(cfg), "--poisson", "mg"]
    a, b = tmp_path / "a", tmp_path / "b"
    main([*base, "--steps", "4", "--chunk", "4", "--checkpoint-every", "4",
          "--out", str(a)])
    main([*base, "--steps", "2", "--chunk", "2", "--checkpoint-every", "2",
          "--out", str(b)])
    main([*base, "--steps", "2", "--chunk", "2", "--checkpoint-every", "2",
          "--out", str(b), "--resume", str(b / "ckpt.npz")])
    fa, fb = np.load(a / "ckpt.npz"), np.load(b / "ckpt.npz")
    assert "theta" in fa.files
    for k in fa.files:
        if k.startswith(("u", "p", "theta")):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    kw = dict(shape=(32, 16, 16), lengths=(8.0, 4.0, 4.0),
              center=(2.0, 2.03, 1.97), re=100.0, device="cpu")
    for opts in (dict(ibm=True), dict(outlet="convective")):
        with pytest.raises(NotImplementedError, match="Other BC kinds"):
            make_case("sphere", heated=True, **kw, **opts)
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        make_case("sphere", heated=True, ibm=True, sharp_pressure=True,
                  poisson_method="mg", **kw)
    conv = make_case("sphere", outlet="convective", **kw).sim
    with pytest.raises(NotImplementedError, match="Physics extensions"):
        tsolver.Simulation.build(conv.grid, conv.bcs, conv.params, CPU,
                                 solid=conv.scalar_solid,
                                 forcing=(0.1, None, None))
