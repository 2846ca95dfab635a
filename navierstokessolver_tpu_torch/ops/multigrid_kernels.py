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

import torch

from . import _native
from .poisson import PoissonOp, _rb_sweep, apply_A

LAUNCHES = {"mg_pre_sweeps_residual": 0, "mg_add_post_sweeps": 0,
            "rb_sweeps": 0}

_F, _I, _P = _native.F, _native.I, _native.P
# C signatures in csrc/multigrid.cu: pointers, the extents, n_sweeps, the
# float constants, the blend flag, the stream
_TAIL = [_I, _I, _I, _F, _F, _I, _F, _F, _P]
_ARGTYPES = {
    "nss_rb_sweeps": [_P] * 5 + _TAIL,
    "nss_mg_pre": [_P] * 6 + _TAIL,
    "nss_mg_post": [_P] * 7 + _TAIL,
    "nss_mg_blocks": [_I, _I],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rb_sweeps_applicable(shape: tuple[int, ...], dtype) -> bool:
    """The JAX gate (``pallas_kernels.rb_sweeps_applicable``): 2D float32
    with at least 128 cells per side."""
    return len(shape) == 2 and dtype == torch.float32 and min(shape) >= 128


def mg_fused_applicable(op: PoissonOp) -> bool:
    """The JAX gate (``pallas_kernels.mg_fused_applicable``): 2D float32,
    at least 128 per side, no periodic axis."""
    return (op.diag.ndim == 2 and op.diag.dtype == torch.float32
            and min(op.diag.shape) >= 128 and not any(op.periodic))


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
    device = op.diag.device
    _native.check(f"{what} diag", op.diag, shape, torch.float32, device)
    _native.check(f"{what} code", op.code, shape, torch.uint8, device)
    for name, t in fields.items():
        _native.check(f"{what} {name}", t, shape, torch.float32, device)
    return device


def _tail(op: PoissonOp, n_sweeps: int, omega: float) -> tuple:
    """Extents, sweeps and the float constants as the kernels take them:
    omega and 1 - omega (formed in double, rounded to float32, as JAX's
    weakly typed Python scalars), the blend flag (omega != 1, the Pallas
    ``if``), the couplings w0, w1 in float32."""
    f32 = _native.f32
    return (*op.diag.shape, n_sweeps, f32(omega), f32(1.0 - omega),
            int(omega != 1.0), f32(op.w[0]), f32(op.w[1]))


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
            *_tail(op, n_sweeps, omega))
    LAUNCHES["rb_sweeps"] += 1
    return out


def mg_pre_sweeps_residual(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
                           n_sweeps: int, omega: float):
    """``n_sweeps`` red-black sweeps, then ``r = (b - A p') fluid``, one
    pass over memory; returns ``(p', r)``."""
    device = _check("mg_pre_sweeps_residual", op, n_sweeps, p=p, b=b)
    if device.type == "cpu":
        return mg_pre_sweeps_residual_plain(op, p, b, n_sweeps, omega)
    _native.cuda_or_raise(device, "mg_pre_sweeps_residual")
    p_out = torch.empty_like(p)
    r_out = torch.empty_like(p)
    _launch("nss_mg_pre", device,
            *(_native.ptr(t) for t in (p, b, op.diag, op.code, p_out, r_out)),
            *_tail(op, n_sweeps, omega))
    LAUNCHES["mg_pre_sweeps_residual"] += 1
    return p_out, r_out


def mg_add_post_sweeps(op: PoissonOp, p: torch.Tensor, b: torch.Tensor,
                       e: torch.Tensor, n_sweeps: int, omega: float):
    """``(p + e) fluid``, ``n_sweeps`` red-black sweeps, and the sum of
    squares of ``(b - A p') fluid``; returns ``(p', rsq)`` with ``rsq`` a
    0-d tensor. The kernel writes one partial sum per block; one
    ``torch.sum`` over them finishes the reduction (deterministic, as the
    Pallas wrapper's sum over per-stripe partials)."""
    device = _check("mg_add_post_sweeps", op, n_sweeps, p=p, b=b, e=e)
    if device.type == "cpu":
        return mg_add_post_sweeps_plain(op, p, b, e, n_sweeps, omega)
    _native.cuda_or_raise(device, "mg_add_post_sweeps")
    n0, n1 = op.diag.shape
    blocks = _native.call("multigrid", "nss_mg_blocks",
                          _ARGTYPES["nss_mg_blocks"], n0, n1)
    p_out = torch.empty_like(p)
    partials = torch.empty(blocks, dtype=torch.float32, device=device)
    _launch("nss_mg_post", device,
            *(_native.ptr(t) for t in (p, b, op.diag, op.code, e, p_out,
                                       partials)),
            *_tail(op, n_sweeps, omega))
    LAUNCHES["mg_add_post_sweeps"] += 1
    return p_out, torch.sum(partials)
