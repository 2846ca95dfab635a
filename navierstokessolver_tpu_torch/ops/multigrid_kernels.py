"""Multigrid level kernels: wrappers and their plain versions.

Counterpart of the three Pallas kernels of the JAX package's 2D multigrid
(``navierstokessolver_tpu/ops/pallas_kernels.py``):

  ======================  =================  ===============================
  wrapper                 replaces           plain version
  ======================  =================  ===============================
  mg_pre_sweeps_residual  _mg_pre_kernel     mg_pre_sweeps_residual_plain
  mg_add_post_sweeps      _mg_post_kernel    mg_add_post_sweeps_plain
  rb_sweeps               _rb_sweep_kernel   rb_sweeps_plain
  ======================  =================  ===============================

The kernels are CUDA C++ for sm_90a in ``csrc/multigrid.cu`` (built and
loaded by ops/_native.py); they read the exact ``(n0, n1)`` layout. Every
wrapper checks device, dtype, shape and contiguity; a tensor on the CPU goes
to the plain version, a CUDA tensor to the kernel, and nothing else. Each
kernel launch adds one to ``LAUNCHES[<wrapper name>]``.

The kernels follow the Pallas arithmetic (coefficients pre-divided by the
diagonal, ``gs = b/d - (cl0 up + ch0 dn + cl1 lf + ch1 rt)``, the omega
blend only when omega != 1, no fluid gate inside a sweep); the plain
versions follow the jnp code they replaced (``poisson._rb_sweep``,
``apply_A``). Both take the solver's invariant ``p = p * fluid``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _native
from .poisson import PoissonOp, _rb_sweep, apply_A

LAUNCHES = {"mg_pre_sweeps_residual": 0, "mg_add_post_sweeps": 0,
            "rb_sweeps": 0}

_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/multigrid.cu: pointers, the extents, n_sweeps, the
# float constants, the blend flag, (mg_pre, mg_post) the level's plan as
# seven ints, the stream
_CONSTS = [_I, _I, _I, _F, _F, _I, _F, _F]
_ARGTYPES = {
    "nss_rb_sweeps": [_P] * 5 + _CONSTS + [_P],
    "nss_mg_pre": [_P] * 6 + _CONSTS + [_I] * 7 + [_P],
    "nss_mg_post": [_P] * 7 + _CONSTS + [_I] * 7 + [_P],
}

# mg_pre's and mg_post's tile (rows, columns), by level size: the first
# entry whose least number of cells the level reaches. Tall, wide tiles on
# the large levels stage fewer halo cells a cell; short, narrow ones keep
# more SMs busy on the small levels (each level's times at these tiles and
# at 16 x 88: PERF.md section 6)
TILES = ((1024 * 1024, (32, 88)), (512 * 512, (8, 88)), (0, (8, 24)))
SMEM_LIMIT = 227 * 1024        # a block's dynamic shared memory on Hopper


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rb_sweeps_applicable(shape: tuple[int, ...], dtype) -> bool:
    """The JAX gate (``pallas_kernels.rb_sweeps_applicable``): 2D float32
    with at least 128 cells per side."""
    return len(shape) == 2 and dtype == torch.float32 and min(shape) >= 128


def mg_fused_applicable(op: PoissonOp) -> bool:
    """The JAX gate (``pallas_kernels.mg_fused_applicable`` and the
    solver's ``op.ap is None``): 2D float32, at least 128 per side, no
    periodic axis, no cut-cell apertures (the kernels decode A from the
    stencil code alone)."""
    return (op.diag.ndim == 2 and op.diag.dtype == torch.float32
            and min(op.diag.shape) >= 128 and not any(op.periodic)
            and op.ap is None)


def check_staircase(op: PoissonOp, what: str) -> None:
    """Raise unless ``op`` is a staircase operator: the level kernels
    decode A from the stencil code and would solve the staircase operator
    in place of an apertured one."""
    if op.ap is not None:
        raise ValueError(f"{what}: an apertured (cut-cell) operator; the "
                         "kernel decodes A from the stencil code alone "
                         "(its plain version takes it)")


# -- plain versions -------------------------------------------------------------


def rb_sweeps_plain(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
                    omega: float, n_sweeps: int) -> torch.Tensor:
    for _ in range(n_sweeps):
        p = _rb_sweep(op, p, b, omega)
    return p


def mg_pre_sweeps_residual_plain(op: PoissonOp, p: torch.Tensor,
                                 b: torch.Tensor, n_sweeps: int,
                                 omega: float):
    p = rb_sweeps_plain(op, p, b, omega, n_sweeps)
    return p, (b - apply_A(op, p)) * op.fluid


def mg_add_post_sweeps_plain(op: PoissonOp, p: torch.Tensor,
                             b: torch.Tensor, e: torch.Tensor,
                             n_sweeps: int, omega: float):
    p = rb_sweeps_plain(op, (p + e) * op.fluid, b, omega, n_sweeps)
    r = (b - apply_A(op, p)) * op.fluid
    return p, torch.sum(r * r)


# -- the level kernels' plan ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """How mg_pre and mg_post cut one level: each block writes a
    ``tile_rows x tile_cols`` tile and stages it with ``halo_rows`` and
    ``halo_cols`` cells on either side; ``grid_rows x grid_cols`` blocks;
    the dynamic shared memory of each mode (p, b, diag and, for mg_post, e
    as float32, the code as one byte, per staged cell)."""

    tile_rows: int
    tile_cols: int
    halo_rows: int
    halo_cols: int
    grid_rows: int
    grid_cols: int
    smem_pre: int
    smem_post: int

    @property
    def blocks(self) -> int:
        """Blocks a launch, and mg_post's partial sums."""
        return self.grid_rows * self.grid_cols

    def args(self, post: bool) -> tuple:
        """The seven ints the C entry points take."""
        return (self.tile_rows, self.tile_cols, self.halo_rows,
                self.halo_cols, self.grid_rows, self.grid_cols,
                self.smem_post if post else self.smem_pre)


@functools.lru_cache(maxsize=None)
def level_plan(shape: tuple[int, int], n_sweeps: int,
               tile: tuple[int, int] | None = None) -> LevelPlan:
    """The plan of a ``shape`` level at ``n_sweeps`` sweeps: pass s of the
    2n colour passes updates the cells within 2n - s of the tile, so the
    halo is 2n + 1 (the last pass's ring is the residual's neighbours);
    its columns are rounded up to 4, so that every staged row starts on a
    16-byte boundary where n1 % 4 == 0. ``tile`` (rows, columns; the
    columns a multiple of 4) None takes the rule of :data:`TILES`."""
    n0, n1 = shape
    if tile is None:
        tile = next(t for cells, t in TILES if n0 * n1 >= cells)
    rows, cols = tile
    if rows < 1 or cols < 4 or cols % 4:
        raise ValueError(f"level tile {tile}: the columns must be a "
                         "positive multiple of 4")
    h = 2 * n_sweeps + 1
    ha = -(-h // 4) * 4
    cells = (rows + 2 * h) * (cols + 2 * ha)
    plan = LevelPlan(rows, cols, h, ha, -(-n0 // rows), -(-n1 // cols),
                     13 * cells, 17 * cells)
    if plan.smem_post > SMEM_LIMIT:
        raise ValueError(f"level plan {plan}: {plan.smem_post} bytes of "
                         f"shared memory, above {SMEM_LIMIT}")
    return plan


# -- wrappers -------------------------------------------------------------------


def _check(what: str, op: PoissonOp, n_sweeps: int, **fields):
    """The device of the fields after the checks every kernel shares."""
    if not 1 <= n_sweeps <= 8:
        raise ValueError(f"{what}: n_sweeps must be in [1, 8], got {n_sweeps}")
    shape = tuple(op.diag.shape)
    if len(shape) != 2:
        raise ValueError(f"{what}: 2D operators only, got shape {shape}")
    if any(op.periodic):
        raise ValueError(f"{what}: periodic axes are not supported")
    check_staircase(op, what)
    device = op.diag.device
    _native.check(f"{what} diag", op.diag, shape, torch.float32, device)
    _native.check(f"{what} code", op.code, shape, torch.uint8, device)
    for name, t in fields.items():
        _native.check(f"{what} {name}", t, shape, torch.float32, device)
    return device


@functools.lru_cache(maxsize=256)
def _tail(shape: tuple, w: tuple, n_sweeps: int, omega: float) -> tuple:
    """Extents, sweeps and the float constants as the kernels take them:
    omega and 1 - omega (formed in double, rounded to float32, as JAX's
    weakly typed Python scalars), the blend flag (omega != 1, the Pallas
    ``if``), the couplings w0, w1 in float32; made once per level and
    omega, as each conversion costs the host a few microseconds a call."""
    f32 = _native.f32
    return (*shape, n_sweeps, f32(omega), f32(1.0 - omega),
            int(omega != 1.0), f32(w[0]), f32(w[1]))


def _launch(name: str, device: torch.device, *args) -> None:
    _native.launch("multigrid", name, _ARGTYPES[name], device, *args)


def rb_sweeps(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
              omega: float, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` (1-8) red-black sweeps in one pass over memory."""
    device = _check("rb_sweeps", op, n_sweeps, p=p, b=b)
    if device.type == "cpu":
        return rb_sweeps_plain(op, p, b, omega, n_sweeps)
    _native.cuda_or_raise(device, "rb_sweeps")
    out = torch.empty_like(p)
    _launch("nss_rb_sweeps", device,
            *(_native.ptr(t) for t in (p, b, op.diag, op.code, out)),
            *_tail(op.diag.shape, op.w, n_sweeps, omega))
    LAUNCHES["rb_sweeps"] += 1
    return out


def mg_pre_sweeps_residual(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
                           n_sweeps: int, omega: float, *,
                           tile: tuple[int, int] | None = None):
    """``n_sweeps`` red-black sweeps, then ``r = (b - A p') fluid``, one
    pass over memory; returns ``(p', r)``. ``tile`` overrides the plan's
    rule (:func:`level_plan`)."""
    device = _check("mg_pre_sweeps_residual", op, n_sweeps, p=p, b=b)
    if device.type == "cpu":
        return mg_pre_sweeps_residual_plain(op, p, b, n_sweeps, omega)
    _native.cuda_or_raise(device, "mg_pre_sweeps_residual")
    plan = level_plan(tuple(op.diag.shape), n_sweeps, tile)
    p_out = torch.empty_like(p)
    r_out = torch.empty_like(p)
    _launch("nss_mg_pre", device,
            *(_native.ptr(t) for t in (p, b, op.diag, op.code, p_out, r_out)),
            *_tail(op.diag.shape, op.w, n_sweeps, omega),
            *plan.args(post=False))
    LAUNCHES["mg_pre_sweeps_residual"] += 1
    return p_out, r_out


def mg_add_post_sweeps(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
                       e: torch.Tensor, n_sweeps: int, omega: float, *,
                       tile: tuple[int, int] | None = None):
    """``(p + e) fluid``, ``n_sweeps`` red-black sweeps, and the sum of
    squares of ``(b - A p') fluid``; returns ``(p', rsq)`` with ``rsq`` a
    0-d tensor. The kernel writes one partial sum per block of the plan;
    one ``torch.sum`` over them finishes the reduction (deterministic, as
    the Pallas wrapper's sum over per-stripe partials). ``tile`` as in
    :func:`mg_pre_sweeps_residual`."""
    device = _check("mg_add_post_sweeps", op, n_sweeps, p=p, b=b, e=e)
    if device.type == "cpu":
        return mg_add_post_sweeps_plain(op, p, b, e, n_sweeps, omega)
    _native.cuda_or_raise(device, "mg_add_post_sweeps")
    plan = level_plan(tuple(op.diag.shape), n_sweeps, tile)
    p_out = torch.empty_like(p)
    partials = torch.empty(plan.blocks, dtype=torch.float32, device=device)
    _launch("nss_mg_post", device,
            *(_native.ptr(t) for t in (p, b, op.diag, op.code, e, p_out,
                                       partials)),
            *_tail(op.diag.shape, op.w, n_sweeps, omega),
            *plan.args(post=True))
    LAUNCHES["mg_add_post_sweeps"] += 1
    return p_out, torch.sum(partials)
