"""The slab-sharded fused 3D step, every shard on one card.

Counterpart of the slab tier of
``navierstokessolver_tpu/parallel/fused_sharded.py`` (``('sx',)`` mesh,
``make_sharded_fused_step`` on its ``rdma=True`` branches, and
``run_scan_sharded_fused``). The grid's axis 0 is cut into N slabs of b =
n0 / N rows. Each slab keeps its fields in buffers of its own, in the
layout of ``ops/fused3d.halo_shape``: its rows plus ghost rows on axis 0
(u0's row b+1 is the face shared with the next slab). One Euler step:

  1. velocity ghost refresh    one exchange launch, 3 volumes x 2 messages
                               (parallel/remote_dma.RowExchange, kernel 14)
  2. predictor + RHS           kernel 1 in halo mode on each slab
  3. shared face               one exchange launch: the next slab's face-0
                               u* into row b+1 (JAX keeps this message too;
                               the predictor could write the face itself)
  4. pressure solve            the slabs' RHS joined into one (n0, n1, n2)
                               tensor, the configured solver run on it as
                               unsharded, p cut back into the slabs' buffers
  5. pressure halo             one exchange launch, 2 messages
  6. corrector + diagnostics   kernel 2 in halo mode on each slab; the
                               diagnostics are the maximum over slabs

An rk2 step (JAX's ``run_scan_sharded_fused`` rk2 branch) runs steps 2-6
at 0.5*dt into the midpoint buffers, refreshes their ghost rows (one more
exchange launch), and runs steps 2-6 again with kernel 1 in halo and
``base`` mode: the midpoint field as the stencil source, u* anchored at
the step-start buffers, whose shared face the step's first refresh
brought; the second solve starts from the stage-1 pressure. Six exchange
launches a step, three under Euler. With ``cfl`` set, the step's dt comes
from the previous step's corrector maximum over the slabs (the entry
value from the unsharded state), on the device.

Step 4 is the one place where slab data meet outside the exchange kernel.
JAX runs that solve between its two ``shard_map`` regions on the GSPMD
path; with the slabs on several cards it is what ``parallel/halo.py``'s
explicit-halo solvers would replace (ROADMAP Queue A, 'parallel/: the
explicit-halo solvers and the pencil tier').

The kernels treat a slab side that is a domain wall (the first and last
slab of a bounded axis) as the unsharded kernels do, so no boundary rows
are staged into ghost slots as JAX does; the exchange leaves those slots
alone. Along a PERIODIC axis 0 the slabs form a ring: every side is a halo
side and the messages wrap around.

JAX's ``rdma`` flag picks kernel-initiated remote DMAs or ``ppermute`` for
the exchanges. With every slab on one card both are the same row copies,
so both run the exchange kernel. The buffers and the exchanges' message
tables are built once per run and reused every step, so a step copies
nothing from the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bcs import periodic_axes
from ..grid import GridSpec, State, slab_grid
from ..ops import fused3d
from .remote_dma import RowExchange
from .sharding import HALO_TIER, Mesh, canonical_device

AXIS = "sx"


def velocity_messages(b: int):
    """The velocity refresh of a slab of b rows (every component): its last
    data row to the next slab's low ghost row, its first two data rows to
    the previous slab's high ghost rows."""
    return ((b, 1, 0, "fwd"), (1, 2, b + 1, "bwd"))


def shared_face_messages(b: int):
    """u*'s face 0 of each slab to the previous slab's shared face."""
    return ((1, 1, b + 1, "bwd"),)


def pressure_messages(b: int):
    """p's last and first data rows to the neighbours' ghost rows."""
    return ((b, 1, 0, "fwd"), (1, 1, b + 1, "bwd"))


def fused_step3d_sharded_applicable(grid: GridSpec, bcs, mesh: Mesh) -> bool:
    """JAX's slab gate: a 1D ``('sx',)`` mesh of N >= 2 slabs that divide
    n0, each of b >= 8 rows, and a table the fused 3D kernels take."""
    if tuple(mesh.axis_names) != (AXIS,) or grid.ndim != 3:
        return False
    n_dev = mesh.size
    if n_dev < 2 or grid.shape[0] % n_dev:
        return False
    if grid.shape[0] // n_dev < 8:
        return False  # degenerate slabs: the ghost rows dominate
    return (fused3d.fused_step3d_applicable(grid, bcs)
            and fused3d.walls_and_periodic(grid, bcs))


def check_sharded(sim, mesh: Mesh) -> None:
    """Raise, naming the ROADMAP item, unless the slab tier takes ``sim``
    on ``mesh``: one device, a 3D fused table, no LES, no scalar, no
    force and no time-dependent value."""
    device = mesh.device
    if tuple(mesh.axis_names) != (AXIS,):
        raise NotImplementedError(
            f"a mesh over the axes {mesh.axis_names} (the pencil tier): not "
            f"ported yet ({HALO_TIER})"
        )
    if sim.grid.ndim != 3:
        raise NotImplementedError(
            f"a sharded 2D grid (JAX's GSPMD and explicit-halo routes): not "
            f"ported yet ({HALO_TIER})"
        )
    if sim.les is not None:
        raise NotImplementedError(
            f"sharded LES (parallel/pallas_sharded.py): not ported yet "
            f"({HALO_TIER})"
        )
    if sim.scalar is not None:
        raise NotImplementedError(
            f"thermal slabs (the halo mode of kernels 1-2 with theta): not "
            f"ported yet ({HALO_TIER})"
        )
    if sim.forcing is not None or sim.time_dependent:
        raise NotImplementedError(
            "a body force or time-dependent values in the slab tier (the "
            "halo mode of kernel 1 with forcing volumes, forcing_to_halo; "
            "per-step resolution in the sharded scan): not ported yet "
            f"({HALO_TIER})"
        )
    if not sim.fused:
        raise NotImplementedError(
            "a sharded table the fused 3D kernels do not take: not ported "
            "yet (ROADMAP Queue A, 'Other BC kinds')"
        )
    if sim.face_masks is not None or not fused3d.walls_and_periodic(
            sim.grid, sim.bcs):
        raise NotImplementedError(
            "an obstacle or INFLOW, OUTFLOW, SLIP or CONVECTIVE faces in "
            "the slab tier "
            "(the halo mode's face codes and edge flags, "
            f"build_face_codes_halo): not ported yet ({HALO_TIER})"
        )
    if not fused_step3d_sharded_applicable(sim.grid, sim.bcs, mesh):
        raise NotImplementedError(
            f"{mesh.size} slabs of a {sim.grid.shape[0]}-row axis 0 (the "
            f"slab tier takes N >= 2 slabs of b >= 8 rows that divide it; "
            f"JAX falls back to its GSPMD route): not ported yet "
            f"({HALO_TIER})"
        )
    if device != canonical_device(sim.device):
        raise ValueError(f"mesh on {device}, simulation on {sim.device}")


def to_internal_halo(grid: GridSpec, u: Sequence[torch.Tensor], n_dev: int,
                     out) -> None:
    """Cut the exact global velocity into the slabs' buffers ``out[k][a]``:
    their data rows, and u0's shared face (the last slab's: the boundary
    face n0, which its high wall side reads). Ghost rows are left to the
    exchange."""
    b = grid.shape[0] // n_dev
    for k in range(n_dev):
        for a in range(3):
            rows = b + (a == 0)
            out[k][a].narrow(0, 1, rows).copy_(u[a].narrow(0, k * b, rows))


def from_internal_halo(grid: GridSpec, bcs, iu) -> tuple[torch.Tensor, ...]:
    """Join the slabs' data rows into the exact global velocity, with u0's
    face n0 re-attached from the BC table (a copy of face 0 on a periodic
    axis 0, the wall value otherwise), as JAX does."""
    b = iu[0][0].shape[0] - 3
    u = [torch.cat([blk[a].narrow(0, 1, b) for blk in iu]) for a in range(3)]
    if periodic_axes(grid, bcs)[0]:
        face = u[0].narrow(0, 0, 1)
    else:
        face = torch.full((1,) + tuple(grid.shape[1:]),
                          float(bcs[(0, 1)].component(0, 3)),
                          dtype=u[0].dtype, device=u[0].device)
    u[0] = torch.cat([u[0], face])
    return tuple(u)


class SlabStep:
    """The sharded step of ``sim`` over ``mesh`` with its buffers and
    exchanges (JAX's ``make_sharded_fused_step`` and its ``step_fn``).
    :meth:`load` cuts a global velocity into the slabs, :meth:`step`
    advances one step, :meth:`unload` joins the slabs again."""

    def __init__(self, sim, mesh: Mesh):
        check_sharded(sim, mesh)
        self.sim = sim
        grid = sim.grid
        n = self.n_dev = mesh.size
        b = self.b = grid.shape[0] // n
        self.slab = slab_grid(grid, b)
        self.periodic = periodic_axes(grid, sim.bcs)
        ring = self.periodic[0]
        self.halo = [(ring or k > 0, ring or k < n - 1) for k in range(n)]

        def zeros(a):
            return torch.zeros(fused3d.halo_shape(self.slab, a),
                               dtype=torch.float32, device=sim.device)

        # the velocity, ping-ponged between steps (and rk2's midpoint
        # field); u*, p and the RHS
        self.rk2 = sim.params.integrator == "rk2"
        self.u = [[tuple(zeros(a) for a in range(3)) for _ in range(n)]
                  for _ in range(3 if self.rk2 else 2)]
        self.u_star = [tuple(zeros(a) for a in range(3)) for _ in range(n)]
        self.p = [zeros(3) for _ in range(n)]
        self.rhs = [torch.zeros(self.slab.shape, dtype=torch.float32,
                                device=sim.device) for _ in range(n)]
        self.maxes = torch.zeros((n, 2), dtype=torch.int32, device=sim.device)
        self.refresh = [
            RowExchange([[blk[a] for blk in u] for a in range(3)],
                        velocity_messages(b), ring)
            for u in self.u
        ]
        self.shared_face = RowExchange([[s[0] for s in self.u_star]],
                                       shared_face_messages(b), ring)
        self.p_halo = RowExchange([self.p], pressure_messages(b), ring)
        self.cur = 0

    def load(self, u: Sequence[torch.Tensor]) -> None:
        to_internal_halo(self.sim.grid, u, self.n_dev, self.u[self.cur])

    def unload(self) -> tuple[torch.Tensor, ...]:
        return from_internal_halo(self.sim.grid, self.sim.bcs,
                                  self.u[self.cur])

    def step(self, p: torch.Tensor, p_prev: Optional[torch.Tensor] = None,
             vel: Optional[torch.Tensor] = None):
        """One step from the loaded velocity and the global pressure ``p``
        (``p_prev``: the previous one, for the extrapolated warm start;
        ``vel``: the CFL reduction of the loaded velocity, with ``cfl``
        set). Returns the new global pressure, the step's diagnostics and
        the new velocity's max|u_a|/h_a (the next step's ``vel``)."""
        sim = self.sim
        dts = sim._dts(vel)
        u, u_next = self.u[self.cur], self.u[1 - self.cur]
        self.refresh[self.cur].run()
        p_start = sim._p_start(p, p_prev)
        it_half = None
        if self.rk2:
            half = sim._half_dts(dts)
            self._predict(u, half)
            p_half, it_half, _ = self._solve(p_start)
            self._correct(p_half, half, self.u[2])
            self.refresh[2].run()
            self._predict(self.u[2], dts, base=u)
            p_start = p_half
        else:
            self._predict(u, dts)
        p_new, iters, res = self._solve(p_start)
        if it_half is not None:
            iters = iters + it_half
        self._correct(p_new, dts, u_next)
        self.cur = 1 - self.cur
        max_div, max_vel = self.maxes.view(torch.float32).amax(0)
        return p_new, sim._diag(iters, res, max_div, max_vel, dts), max_vel

    def _predict(self, u, dts, base=None) -> None:
        """Kernel 1 in halo mode on every slab (``base``: rk2's stage 2),
        u* into ``u_star`` and the RHS into ``rhs``; then the shared
        face."""
        sim, pr = self.sim, self.sim.params
        for k in range(self.n_dev):
            fused3d.predictor_rhs_3d_halo(
                self.slab, sim.bcs, u[k], dts[0], pr.nu, pr.upwind_gamma,
                pr.rho, halo=self.halo[k], bc=sim.bc, out=self.u_star[k],
                rhs=self.rhs[k], base=None if base is None else base[k],
                dts=dts)
        self.shared_face.run()

    def _solve(self, p_start: torch.Tensor):
        """The pressure solve on the slabs' joined RHS; the pressure cut
        back into the slabs' buffers and their halos refreshed. Returns
        (p, iters, res)."""
        b = self.b
        p_new, iters, res = self.sim._solve_pressure(torch.cat(self.rhs),
                                                     p_start)
        for k in range(self.n_dev):
            self.p[k].narrow(0, 1, b).copy_(p_new.narrow(0, k * b, b))
        self.p_halo.run()
        return p_new, iters, res

    def _correct(self, p: torch.Tensor, dts, out) -> None:
        """Kernel 2 in halo mode on every slab into ``out``, its maxima
        into ``maxes``."""
        self.maxes.zero_()
        for k in range(self.n_dev):
            fused3d.correct_diag_3d_halo(
                self.slab, self.u_star[k], self.p[k], dts[2], self.maxes[k],
                periodic=self.periodic, halo=self.halo[k], out=out[k])


def run_scan_sharded_fused(sim, mesh: Mesh, state: State, n_steps: int):
    """Convert ``state`` into slabs once, run ``n_steps`` sharded steps,
    convert back once: the same exact-layout ``State`` and stacked
    ``StepDiagnostics`` as the unsharded ``run_scan``. With ``cfl`` set,
    the corrector's maximum over the slabs sets the next step's dt, as
    JAX's scan carries its ``pmax``; the entry value is one reduction over
    ``state.u``. JAX's ``rdma``
    keyword has no counterpart: see the module docstring. 0 steps return
    ``state`` as given, as JAX's length-0 scan does."""
    if n_steps < 0:
        raise ValueError("run_scan needs n_steps >= 0")
    if n_steps == 0:
        return state, sim.empty_diagnostics()
    step = SlabStep(sim, mesh)
    step.load(state.u)
    p, p_prev = state.p, state.p_prev
    vel = sim._vel_inv(state.u) if sim.params.cfl is not None else None
    diags = []
    for _ in range(n_steps):
        p_new, d, vel = step.step(p, p_prev, vel)
        p_prev = p if p_prev is not None else None
        p = p_new
        diags.append(d)
    return State(u=step.unload(), p=p, p_prev=p_prev), sim._stacked(diags)
