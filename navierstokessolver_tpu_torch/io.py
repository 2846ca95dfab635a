"""Snapshots, checkpoints and snapshot streaming off the card (PyTorch).

Counterpart of ``navierstokessolver_tpu/io.py``, writing files the JAX
package reads and reading the files it writes:

  * snapshots: ``.npz`` with the JAX package's keys, shapes, dtypes and
    ``__meta__`` (cell-centred velocity ``ux``..., ``p``, the face
    velocities ``ux_face``..., in 2D ``vorticity`` and ``streamfunction``,
    in 3D ``vorticity_mag`` and ``q_criterion``), stored uncompressed:
    deflate saves about a tenth of a float32 field's bytes at 15-20 MB/s
    on one core (``chip_smoke.py`` phase 5), seconds a 2048^2 snapshot. With
    ``vtk``, a legacy binary VTK file beside it from the native codec
    (native.py), byte for byte the JAX package's for the same arrays.
  * checkpoints: ``.npz`` with the full state, ``step`` (int64) and the
    configuration hash (bytes), optionally the running statistics
    (``stats_*``) and the tracer positions (``tracer_pos``);
    :func:`config_hash` gives the JAX package's hex string for the same
    configuration, so a checkpoint resumes in either package.

:class:`AsyncSnapshotWriter` keeps the step loop off the disk. On the card
``enqueue`` copies the state's fields on the current stream into staging
tensors (a later step may then write the state in place), and a side
stream that waits for that copy computes the derived fields and copies
everything into a pinned host buffer set, taken from a pool of
``max_pending`` sets; nothing in ``enqueue`` waits for the device. A
writer thread waits for the side stream's event and serializes. Its
errors surface at the next ``enqueue`` or at ``close``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import threading
import zipfile
from typing import Optional

import numpy as np
from numpy.lib import format as npformat
import torch

from . import native
from .grid import GridSpec, State, interpolate_to_centers
from .ops.stencils import (
    q_criterion_3d, streamfunction_2d, vorticity_2d, vorticity_magnitude_3d,
)

AXES = "xyz"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch (or numpy) dtype."""
    return np.dtype(str(dtype).removeprefix("torch."))


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=_np_dtype(dtype))).to(device)


# -- snapshots -----------------------------------------------------------------


def snapshot_tensors(grid: GridSpec, state: State) -> dict[str, torch.Tensor]:
    """A snapshot's fields on the state's device, in the JAX package's key
    order: the cell-centred velocity, the pressure, the face velocities,
    theta, then the derived fields."""
    out: dict[str, torch.Tensor] = {}
    for a, c in enumerate(interpolate_to_centers(grid, state.u)):
        out[f"u{AXES[a]}"] = c
    out["p"] = state.p
    for a, c in enumerate(state.u):
        out[f"u{AXES[a]}_face"] = c
    if state.theta is not None:
        out["theta"] = state.theta
    if grid.ndim == 2:
        out["vorticity"] = vorticity_2d(grid, state.u)
        out["streamfunction"] = streamfunction_2d(grid, state.u)
    else:
        out["vorticity_mag"] = vorticity_magnitude_3d(grid, state.u)
        out["q_criterion"] = q_criterion_3d(grid, state.u)
    return out


def snapshot_shapes(grid: GridSpec,
                    theta: bool = False) -> dict[str, tuple[int, ...]]:
    """The shape of each field of :func:`snapshot_tensors` (with
    ``theta``: a state that carries the scalar)."""
    nd = grid.ndim
    out = {f"u{AXES[a]}": grid.shape for a in range(nd)}
    out["p"] = grid.shape
    out.update({f"u{AXES[a]}_face": grid.face_shape(a) for a in range(nd)})
    if theta:
        out["theta"] = grid.shape
    nodes = tuple(n - 1 for n in grid.shape)
    if nd == 2:
        out["vorticity"] = nodes
        out["streamfunction"] = tuple(n + 1 for n in grid.shape)
    else:
        out["vorticity_mag"] = nodes
        out["q_criterion"] = grid.shape
    return out


def snapshot_arrays(grid: GridSpec, state: State) -> dict[str, np.ndarray]:
    """The snapshot's fields as host numpy arrays."""
    return {k: _host(v) for k, v in snapshot_tensors(grid, state).items()}


def _meta(grid: GridSpec, step: int, time: float) -> dict:
    return dict(step=int(step), time=float(time), shape=list(grid.shape),
                lengths=list(grid.lengths))


def _savez(path: str, arrays: dict) -> None:
    """The file ``np.savez(path, **arrays)`` writes, each C-contiguous
    array's bytes handed to the zip member from the array's own memory:
    np.savez copies every array through ``tobytes`` in 16 MiB pieces,
    holding the GIL that the step loop needs, while zipfile's CRC and the
    file write release it."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, v in arrays.items():
            v = np.asanyarray(v)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                if v.ndim and v.flags.c_contiguous:
                    npformat.write_array_header_1_0(
                        f, npformat.header_data_from_array_1_0(v))
                    f.write(memoryview(v).cast("B"))
                else:
                    npformat.write_array(f, v)


def _write_files(path: str, grid: GridSpec, arrays: dict, meta: dict,
                 vtk: bool) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _savez(path, {"__meta__": json.dumps(meta), **arrays})
    if vtk:
        write_vtk(os.path.splitext(path)[0] + ".vtk", grid, arrays, meta)


def write_snapshot(path: str, grid: GridSpec, state: State, step: int,
                   time: float, vtk: bool = False) -> None:
    """Write the snapshot of ``state`` now (reading it on the host)."""
    _write_files(path, grid, snapshot_arrays(grid, state),
                 _meta(grid, step, time), vtk)


def _vtk_title(meta: dict) -> str:
    # the JAX package's header line, so the files compare byte for byte
    return f"navierstokessolver_tpu step={meta['step']} t={meta['time']}"


def _vtk_scalars(grid: GridSpec, arrays: dict) -> dict[str, np.ndarray]:
    """The point scalars: the pressure, and in 2D the node vorticity on
    the cells (its last row and column zero)."""
    scalars = {"pressure": arrays["p"]}
    if "vorticity" in arrays and grid.ndim == 2:
        w = arrays["vorticity"]
        wp = np.zeros(grid.shape, w.dtype)
        wp[:-1, :-1] = w
        scalars["vorticity"] = wp
    return scalars


def write_vtk(path: str, grid: GridSpec, arrays: dict, meta: dict) -> None:
    """Legacy binary VTK structured points, ParaView-ready, from the native
    codec (a failed build raises)."""
    native.write_vtk_binary(
        path, grid.shape, grid.spacing,
        [arrays[f"u{AXES[a]}"] for a in range(grid.ndim)],
        _vtk_scalars(grid, arrays), _vtk_title(meta))


def write_vtk_ascii(path: str, grid: GridSpec, arrays: dict,
                    meta: dict) -> None:
    """The codec's plain version: the same fields as legacy ASCII VTK."""
    nd = grid.ndim
    dims = list(grid.shape) + [1] * (3 - nd)
    sp = list(grid.spacing) + [1.0] * (3 - nd)
    n = int(np.prod(grid.shape))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(_vtk_title(meta) + "\n")
        f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write("ORIGIN 0 0 0\n")
        f.write(f"SPACING {sp[0]} {sp[1]} {sp[2]}\n")
        f.write(f"POINT_DATA {n}\n")
        f.write("VECTORS velocity float\n")
        flat = [arrays[f"u{AXES[a]}"].reshape(-1, order="F")
                for a in range(nd)]
        zeros = np.zeros_like(flat[0])
        while len(flat) < 3:
            flat.append(zeros)
        for row in zip(*flat):
            f.write(f"{row[0]:.6g} {row[1]:.6g} {row[2]:.6g}\n")
        for name, v in _vtk_scalars(grid, arrays).items():
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
            for x in v.reshape(-1, order="F"):
                f.write(f"{x:.6g}\n")


@dataclasses.dataclass
class _Item:
    """One queued snapshot: ``host`` (a pinned buffer set whose ``keys``
    hold this snapshot, filled once ``done`` has fired) on the card;
    ``state`` (a copy) on the CPU."""

    step: int
    time: float
    host: Optional[dict] = None
    keys: tuple[str, ...] = ()
    done: Optional[torch.cuda.Event] = None
    state: Optional[State] = None


class AsyncSnapshotWriter:
    """Snapshots written by a background thread while the steps go on.

    ``enqueue(state, step, time)`` never waits for the device: on the card
    it enqueues a copy of the fields (current stream), then on a side
    stream the derived fields and the copy into pinned host buffers; on the
    CPU it copies the fields. At most ``max_pending`` snapshots wait to be
    written; the next ``enqueue`` waits for the writer, as the JAX writer's
    bounded queue does. Files: ``<out_dir>/snap_<step:08d>.npz`` (and
    ``.vtk``).

    ``device`` is the states' device. On the card the constructor
    page-locks the pool of ``max_pending`` host buffer sets, before any
    step: that takes tens of ms a set, which a step loop should not wait
    for. ``scalar``: the states carry theta (a simulation with a
    transported scalar), and each set holds a buffer for it."""

    def __init__(self, out_dir: str, grid: GridSpec, device,
                 vtk: bool = False, max_pending: int = 4,
                 scalar: bool = False):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.out_dir = out_dir
        self.grid = grid
        self.vtk = vtk
        self.scalar = scalar
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._free: queue.Queue = queue.Queue()   # the pinned buffer sets
        self._side: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            for _ in range(max_pending):
                self._free.put({k: torch.empty(shape, dtype=grid.dtype,
                                               pin_memory=True)
                                for k, shape in snapshot_shapes(
                                    grid, scalar).items()})
            self._side = torch.cuda.Stream(self.device)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _raise_if_failed(self) -> None:
        if self._err is not None:
            raise RuntimeError("snapshot writer failed") from self._err

    def _take_set(self) -> dict:
        """A free buffer set, waiting for the writer when all are in
        flight."""
        while True:
            self._raise_if_failed()
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue

    def _put(self, item) -> None:
        """Queue ``item``, waiting while ``max_pending`` are queued, unless
        the writer has stopped."""
        while self._thread.is_alive():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def enqueue(self, state: State, step: int, time: float) -> None:
        self._raise_if_failed()
        if self._closed:
            raise RuntimeError("snapshot writer is closed")
        if state.p.device.type != self.device.type:
            raise ValueError(f"a state on {state.p.device} for a writer "
                             f"built for {self.device}")
        item = _Item(step=int(step), time=float(time))
        if self._side is not None:
            item.host, item.keys, item.done = self._stage_cuda(
                state, self._take_set())
        else:
            def copy(t):
                return None if t is None else t.clone()
            item.state = State(u=tuple(c.clone() for c in state.u),
                               p=state.p.clone(), theta=copy(state.theta))
        self._put(item)
        self._raise_if_failed()

    def _stage_cuda(self, state: State, host: dict):
        if (state.theta is not None) != self.scalar:
            raise ValueError(
                "a state with theta for a writer built without scalar=True"
                if state.theta is not None else
                "a state without theta for a writer built with scalar=True")
        side = self._side
        # the copy on the current stream: ordered after the steps that
        # wrote the state, and immune to any later write into it
        staged = State(u=tuple(c.clone() for c in state.u), p=state.p.clone(),
                       theta=(None if state.theta is None
                              else state.theta.clone()))
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        side.wait_event(copied)
        with torch.cuda.stream(side):
            fields = snapshot_tensors(self.grid, staged)
            for k, v in fields.items():
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        # the staging tensors came from the current stream's pool: keep
        # the allocator from handing them out before the side stream is
        # done with them
        for t in (*staged.u, staged.p, *(
                () if staged.theta is None else (staged.theta,))):
            t.record_stream(side)
        return host, tuple(fields), done

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if item.done is not None:
                    item.done.synchronize()
                    arrays = {k: item.host[k].numpy() for k in item.keys}
                else:
                    arrays = snapshot_arrays(self.grid, item.state)
                path = os.path.join(self.out_dir, f"snap_{item.step:08d}.npz")
                _write_files(path, self.grid, arrays,
                             _meta(self.grid, item.step, item.time), self.vtk)
            except Exception as e:  # surfaced on next enqueue / close
                self._err = e
                return
            finally:
                if item.host is not None:
                    self._free.put(item.host)

    def close(self) -> None:
        """Wait for every queued snapshot to be written; raise the writer's
        error if it had one."""
        if not self._closed:
            self._closed = True
            self._put(None)
        self._thread.join()
        self._raise_if_failed()


# -- checkpoints ---------------------------------------------------------------


def _scalar_blob(scalar) -> Optional[dict]:
    """JSON-able digest of a scalar-transport configuration (the fields
    that affect the physics; the JAX package's ``ScalarConfig`` layout)."""
    if scalar is None:
        return None

    def bcval(v):
        arr = np.asarray(v)
        if arr.ndim == 0:
            return float(arr)
        return hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]

    blob = dict(
        diffusivity=scalar.diffusivity,
        buoyancy=list(scalar.buoyancy),
        theta_ref=scalar.theta_ref,
        upwind_gamma=scalar.upwind_gamma,
        bcs={
            f"{a},{s}": [bc.kind.value, bcval(bc.value)]
            for (a, s), bc in sorted(scalar.bcs.items())
        },
    )
    # omitted, not None, when unset: the hashes of earlier checkpoints hold
    if getattr(scalar, "body_bc", None) is not None:
        blob["body_bc"] = [scalar.body_bc.kind.value,
                           bcval(scalar.body_bc.value)]
    return blob


def config_hash(grid: GridSpec, params, scalar=None, les=None, ibm=False,
                sharp_pressure=False) -> str:
    """The 16-hex-digit digest of what a checkpoint may resume into: the
    JAX package's ``config_hash`` of the same configuration."""
    d = dict(
        shape=list(grid.shape),
        lengths=list(grid.lengths),
        dtype=str(_np_dtype(grid.dtype)),
        dt=params.dt,
        nu=params.nu,
        rho=params.rho,
        upwind_gamma=params.upwind_gamma,
        integrator=params.integrator,
        poisson=dataclasses.asdict(params.poisson),
        scalar=_scalar_blob(scalar),
        les=None if les is None else dataclasses.asdict(les),
        ibm=bool(ibm),
    )
    # only when set, as in JAX, so the hashes of earlier checkpoints hold
    if sharp_pressure:
        d["sharp_pressure"] = True
    blob = json.dumps(d, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint(path: str, state: State, step: int, cfg_hash: str,
                    stats=None, tracers=None) -> None:
    """The state, ``step`` and ``cfg_hash`` (read on the host), with the
    running statistics (a :class:`~.stats.FlowStats`) under ``stats_*`` and
    the tracer positions ``(n, nd)`` under ``tracer_pos``; written to a
    temporary file, then renamed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"u{a}": _host(c) for a, c in enumerate(state.u)}
    arrays["p"] = _host(state.p)
    for k in ("theta", "p_prev", "t"):
        if getattr(state, k) is not None:
            arrays[k] = _host(getattr(state, k))
    if stats is not None:
        from . import stats as stats_mod

        arrays.update({f"stats_{k}": v
                       for k, v in stats_mod.to_arrays(stats).items()})
    if tracers is not None:
        arrays["tracer_pos"] = _host(tracers)
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.int64(step), cfg=np.bytes_(cfg_hash.encode()),
             **arrays)
    os.replace(tmp, path)


def load_checkpoint_tracers(path: str, dtype=torch.float32,
                            device="cuda") -> Optional[torch.Tensor]:
    """The tracer positions saved with a checkpoint, or None."""
    with np.load(path) as z:
        if "tracer_pos" not in z.files:
            return None
        return _tensor(z["tracer_pos"], dtype, device)


def load_checkpoint_stats(path: str, dtype=torch.float32, device="cuda"):
    """The running statistics saved with a checkpoint, or None."""
    from . import stats as stats_mod

    with np.load(path) as z:
        d = {k[len("stats_"):]: z[k] for k in z.files
             if k.startswith("stats_")}
    return stats_mod.from_arrays(d, dtype, device) if d else None


def load_checkpoint(path: str, grid: GridSpec,
                    cfg_hash: Optional[str] = None,
                    expect_scalar: bool = False,
                    device="cuda") -> tuple[State, int]:
    """``(state, step)`` from a checkpoint of either package, the state on
    ``device``. Raises on a configuration-hash mismatch (when ``cfg_hash``
    is given), and with ``expect_scalar`` on a checkpoint without theta."""
    with np.load(path) as z:
        saved = bytes(z["cfg"]).decode()
        if cfg_hash is not None and saved != cfg_hash:
            raise ValueError(
                f"checkpoint config hash {saved} != current {cfg_hash}; "
                "refusing to resume a different configuration"
            )
        if expect_scalar and "theta" not in z.files:
            raise ValueError(
                "simulation has a transported scalar configured but the "
                f"checkpoint {path!r} has no theta field; refusing to resume "
                "with silently-disabled scalar transport"
            )

        def opt(k):
            return (_tensor(z[k], grid.dtype, device) if k in z.files
                    else None)

        state = State(
            u=tuple(_tensor(z[f"u{a}"], grid.dtype, device)
                    for a in range(grid.ndim)),
            p=_tensor(z["p"], grid.dtype, device),
            theta=opt("theta"), p_prev=opt("p_prev"), t=opt("t"))
        step = int(z["step"])
    return state, step
