"""Domain decomposition over a mesh of shards (the slab tier on one card).

Counterpart of ``navierstokessolver_tpu/parallel/sharding.py``. The JAX
package annotates the grid axes with ``NamedSharding`` and lets XLA's SPMD
partitioner insert the halo exchanges; its slab tier runs the fused step
under ``shard_map`` with explicit row exchanges between the shards
(parallel/fused_sharded.py). This port has that slab tier only, and runs it
as one process holding every shard, as the JAX package's own tests run it
on a virtual mesh of CPU devices: each shard owns its buffers, and rows
cross between shards only through the exchange kernel
(parallel/remote_dma.py). A mesh may repeat one device, the explicit
counterpart of JAX's virtual mesh:

    mesh = make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    sim_sp = sharded_simulation(case.sim, mesh, rdma=True)
    st, d = sim_sp.run_scan(shard_state(case.initial_state(), mesh,
                                        case.sim.grid), 200)

Shards on several cards raise (ROADMAP Queue A, 'parallel/ across cards'),
as do the GSPMD tier, the explicit-halo solvers and the pencil mesh
('parallel/: the explicit-halo solvers and the pencil tier'). JAX's
``state_shardings`` and ``replicate_state`` describe GSPMD placements and
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..grid import GridSpec, State

SPATIAL_AXES = ("sx", "sy", "sz")
ACROSS_CARDS = "ROADMAP Queue A, 'parallel/ across cards'"
HALO_TIER = ("ROADMAP Queue A, 'parallel/: the explicit-halo solvers and the "
             "pencil tier'")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of shards: ``devices`` in row-major order over ``shape``, one
    named axis per grid axis it splits."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on; shards on several devices
        raise (not ported)."""
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over the devices {distinct}: not ported yet "
                f"({ACROSS_CARDS})"
            )
        return self.devices[0]


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(mesh_shape: Sequence[int] | int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A spatial mesh: ``mesh_shape`` shards per grid axis (or one int for
    the slabs of axis 0). Without ``devices`` it takes the CUDA devices
    and raises, as JAX does, when there are fewer than the mesh needs;
    ``devices`` may name one device several times (every shard on it)."""
    if isinstance(mesh_shape, int):
        mesh_shape = (mesh_shape,)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    ndev = 1
    for n in mesh_shape:
        ndev *= n
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices][:ndev]
    if len(devices) < ndev:
        raise ValueError(
            f"mesh {mesh_shape} needs {ndev} devices, have {len(devices)}"
        )
    return Mesh(tuple(devices), mesh_shape, SPATIAL_AXES[: len(mesh_shape)])


def shard_state(state: State, mesh: Mesh, grid: GridSpec) -> State:
    """The state placed on the mesh's device. It keeps the exact global
    layout: ``run_scan`` of a sharded simulation cuts it into slabs once
    and joins them once, as JAX's ``run_scan_sharded_fused`` converts to
    and from its halo layout."""
    device = mesh.device
    for a, c in enumerate(state.u):
        if tuple(c.shape) != grid.face_shape(a):
            raise ValueError(f"u[{a}] shape {tuple(c.shape)}, expected "
                             f"{grid.face_shape(a)}")
    if tuple(state.p.shape) != grid.shape:
        raise ValueError(f"p shape {tuple(state.p.shape)}, expected "
                         f"{grid.shape}")
    move = lambda t: None if t is None else t.to(device)
    return State(u=tuple(move(c) for c in state.u), p=move(state.p),
                 theta=move(state.theta), p_prev=move(state.p_prev),
                 t=move(state.t))


def sharded_simulation(sim, mesh: Mesh, poisson_comm: str = "gspmd",
                       rdma: bool = False):
    """A copy of ``sim`` whose ``run_scan`` runs the slab-sharded fused
    step over ``mesh`` (parallel/fused_sharded.py). What the slab tier
    does not take raises here, naming its ROADMAP item, rather than at
    step time.

    ``poisson_comm``: JAX's ``"gspmd"`` (the default) solves the pressure
    on the assembled field, as here; ``"halo"`` (the explicit-halo
    solvers) is not ported. ``rdma``: JAX's choice between kernel-
    initiated remote DMAs (True) and ``ppermute`` (False) for the row
    exchanges; with every shard on one card both are the same row
    copies, so both run the exchange kernel, and the flag is taken for
    parity with JAX and not stored."""
    if poisson_comm == "halo":
        raise NotImplementedError(
            f"poisson_comm='halo' (the explicit-halo solvers): not ported "
            f"yet ({HALO_TIER})"
        )
    if poisson_comm != "gspmd":
        raise ValueError(f"unknown poisson_comm {poisson_comm!r}")
    return dataclasses.replace(sim, mesh=mesh)
