"""The multigrid level kernels' plan, on the CPU.

``ops/multigrid_kernels.level_plan`` cuts a level into the tiles that
mg_pre and mg_post (``csrc/multigrid.cu`` ``level_kernel``) stage with a
halo and sweep in shared memory. The kernels run only on the card; here
the plan is checked for what the kernels rely on (each cell in exactly one
tile, a halo of at least 2n + 1, rows that start on 16-byte boundaries,
shared memory within a block's 227 KB, one partial sum a block), and its
tiling is run in plain torch as the kernels run it: each tile's region
cropped with zeros beyond the domain, the 2n colour passes each shrunk to
the cells within 2n - s of the tile, the residual on the tile, the tiles
stitched. That is held to the plain versions with the tolerances of
tests/test_torch_cuda.py (p atol 3e-5; r against the residual of the tiled
iterate, atol 1e-6 w max|p|; the sum of squares rtol 1e-3), and a halo one
row short must fail the residual's check at n = 1 and 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid
from navierstokessolver_tpu_torch.ops import multigrid_kernels as mk
from navierstokessolver_tpu_torch.ops import poisson as tpois

# the 2048^2 mgcg hierarchy's levels (2048^2 ... 16^2) and two ragged
# operators, n1 % 4 == 0 and not
SHAPES = [(2048 >> k, 2048 >> k) for k in range(8)] + [(200, 136), (131, 45)]


def _name(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_plan_covers_each_cell_once(shape, n):
    plan = mk.level_plan(shape, n)
    count = np.zeros(shape, np.int32)
    for by in range(plan.grid_rows):
        for bx in range(plan.grid_cols):
            count[by * plan.tile_rows:(by + 1) * plan.tile_rows,
                  bx * plan.tile_cols:(bx + 1) * plan.tile_cols] += 1
    assert (count == 1).all()
    # every block's tile starts inside the level
    assert (plan.grid_rows - 1) * plan.tile_rows < shape[0]
    assert (plan.grid_cols - 1) * plan.tile_cols < shape[1]
    assert plan.halo_rows >= 2 * n + 1 and plan.halo_cols >= 2 * n + 1
    # staged rows start on 16-byte boundaries where n1 % 4 == 0
    assert plan.tile_cols % 4 == 0 and plan.halo_cols % 4 == 0
    cells = ((plan.tile_rows + 2 * plan.halo_rows)
             * (plan.tile_cols + 2 * plan.halo_cols))
    assert plan.smem_pre == 13 * cells and plan.smem_post == 17 * cells
    assert max(plan.smem_pre, plan.smem_post) <= 227 * 1024
    # mg_post writes one partial sum a block
    assert plan.blocks == plan.grid_rows * plan.grid_cols
    assert plan.args(post=True) == (
        plan.tile_rows, plan.tile_cols, plan.halo_rows, plan.halo_cols,
        plan.grid_rows, plan.grid_cols, plan.smem_post)
    assert plan.args(post=False)[-1] == plan.smem_pre


def test_plan_rule_by_level_size():
    """Tiles no smaller on larger levels, each level's the first entry of
    the table it reaches, and an explicit tile overrides the rule."""
    areas = [mk.level_plan((2048 >> k, 2048 >> k), 2).tile_rows
             * mk.level_plan((2048 >> k, 2048 >> k), 2).tile_cols
             for k in range(8)]
    assert areas == sorted(areas, reverse=True)
    for shape in SHAPES:
        want = next(t for cells, t in mk.TILES
                    if shape[0] * shape[1] >= cells)
        plan = mk.level_plan(shape, 2)
        assert (plan.tile_rows, plan.tile_cols) == want
        plan = mk.level_plan(shape, 2, (8, 16))
        assert (plan.tile_rows, plan.tile_cols) == (8, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        mk.level_plan((128, 128), 2, (8, 18))


def _region(x, plan, by, bx):
    """Tile (by, bx)'s staged region of ``x``: zeros beyond the domain."""
    n0, n1 = x.shape
    hr, hc = plan.halo_rows, plan.halo_cols
    gi0, gj0 = by * plan.tile_rows - hr, bx * plan.tile_cols - hc
    rows, cols = plan.tile_rows + 2 * hr, plan.tile_cols + 2 * hc
    out = torch.zeros((rows, cols), dtype=x.dtype)
    i0, i1 = max(gi0, 0), min(gi0 + rows, n0)
    j0, j1 = max(gj0, 0), min(gj0 + cols, n1)
    out[i0 - gi0:i1 - gi0, j0 - gj0:j1 - gj0] = x[i0:i1, j0:j1]
    return out


def _shifts(x):
    """(up, down, left, right) neighbours of ``x``; beyond it, zero."""
    z = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return z[:-2, 1:-1], z[2:, 1:-1], z[1:-1, :-2], z[1:-1, 2:]


def tiled_level(op, p, b, e, n, omega, plan):
    """mg_pre's (p', r) and mg_post's (p', partial sums) over the plan's
    tiles, each tile swept on its own region as the kernels sweep it."""
    n0, n1 = op.diag.shape
    w0, w1 = (mk._native.f32(w) for w in op.w)
    om, om1 = mk._native.f32(omega), mk._native.f32(1.0 - omega)
    tr, tc = plan.tile_rows, plan.tile_cols
    hr, hc = plan.halo_rows, plan.halo_cols
    outs = {"pre": (torch.empty_like(p), torch.empty_like(p), []),
            "post": (torch.empty_like(p), None, [])}
    for by in range(plan.grid_rows):
        for bx in range(plan.grid_cols):
            ti0, tj0 = by * tr, bx * tc
            ii = (ti0 - hr + torch.arange(tr + 2 * hr))[:, None]
            jj = (tj0 - hc + torch.arange(tc + 2 * hc))[None, :]
            inside = (ii >= 0) & (ii < n0) & (jj >= 0) & (jj < n1)
            # each staged cell's distance from the tile (0 on it)
            di = torch.maximum(ti0 - ii, ii - (ti0 + tr - 1))
            dj = torch.maximum(tj0 - jj, jj - (tj0 + tc - 1))
            dist = torch.clamp(torch.maximum(di, dj), min=0)
            sb, sd = _region(b, plan, by, bx), _region(op.diag, plan, by, bx)
            code = _region(op.code.to(torch.int32), plan, by, bx)
            fluid = ((code & 64) > 0).float()
            bits = [((code & k) > 0) for k in (1, 2, 4, 8)]
            l0, h0, l1, h1 = (torch.where(m, w, 0.0).float()
                              for m, w in zip(bits, (w0, w0, w1, w1)))
            inv_d = 1.0 / sd
            cl0, ch0, cl1, ch1 = (c * inv_d for c in (l0, h0, l1, h1))
            for mode in ("pre", "post"):
                sp = _region(p, plan, by, bx)
                if mode == "post":
                    sp = (sp + _region(e, plan, by, bx)) * fluid
                for s in range(2 * n):
                    upd = (inside & (dist <= 2 * n - s)
                           & ((ii + jj) % 2 == s % 2))
                    up, dn, lf, rt = _shifts(sp)
                    gs = sb * inv_d - (((cl0 * up + ch0 * dn) + cl1 * lf)
                                       + ch1 * rt)
                    if omega != 1.0:
                        gs = om1 * sp + om * gs
                    sp = torch.where(upd, gs, sp)
                up, dn, lf, rt = _shifts(sp)
                r = (sb - ((((sd * sp + l0 * up) + h0 * dn) + l1 * lf)
                           + h1 * rt)) * fluid
                p_out, r_out, partials = outs[mode]
                i1, j1 = min(ti0 + tr, n0), min(tj0 + tc, n1)
                tile = (slice(hr, hr + i1 - ti0), slice(hc, hc + j1 - tj0))
                p_out[ti0:i1, tj0:j1] = sp[tile]
                if mode == "pre":
                    r_out[ti0:i1, tj0:j1] = r[tile]
                else:
                    partials.append(torch.sum(r[tile] * r[tile]))
    p_pre, r_pre, _ = outs["pre"]
    p_post, _, partials = outs["post"]
    return (p_pre, r_pre), (p_post, torch.stack(partials))


def _operator(what):
    if what == "mgcg-128":
        # the 128^2 level of the 2048^2 mgcg hierarchy: the unit cavity
        # coarsened four times keeps its lengths
        g = tgrid.GridSpec((128, 128), (1.0, 1.0))
        return tpois.build_poisson_op(g, tbcs.no_slip_box(g), "cpu")
    shape, lengths = {"200x136": ((200, 136), (1.0, 0.68)),
                      "131x45": ((131, 45), (1.0, 0.4))}[what]
    g = tgrid.GridSpec(shape, lengths)
    bcs = tbcs.no_slip_box(g)
    solid = None
    if what == "200x136":
        bcs[(0, 1)] = tbcs.BCSpec(tbcs.BCKind.OUTFLOW)
        solid = np.zeros(shape, bool)
        solid[60:100, 30:70] = True
    return tpois.build_poisson_op(g, bcs, "cpu", solid)


def _fields(op, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=op.diag.shape)
                                  .astype(np.float32)) * op.fluid
                 for _ in range(3))


def _hold(op, p, b, e, n, omega, plan):
    """The tiled level against the plain versions."""
    (pp, rp), (pq, partials) = tiled_level(op, p, b, e, n, omega, plan)
    ref_pre, _ = mk.mg_pre_sweeps_residual_plain(op, p, b, n, omega)
    torch.testing.assert_close(pp, ref_pre, rtol=0.0, atol=3e-5)
    own = (b - tpois.apply_A(op, pp)) * op.fluid
    torch.testing.assert_close(
        rp, own, rtol=0.0, atol=1e-6 * max(op.w) * float(pp.abs().max()))
    ref_post, _ = mk.mg_add_post_sweeps_plain(op, p, b, e, n, omega)
    torch.testing.assert_close(pq, ref_post, rtol=0.0, atol=3e-5)
    assert partials.numel() == plan.blocks
    torch.testing.assert_close(torch.sqrt(torch.sum(partials)),
                               tpois.residual_norm(op, pq, b),
                               rtol=1e-3, atol=0.0)
    assert float((pq * (1.0 - op.fluid)).abs().max()) == 0.0


@pytest.mark.parametrize("tile", [t for _, t in mk.TILES], ids=_name)
@pytest.mark.parametrize("omega,n", [(1.0, 1), (1.0, 2), (1.45, 8)])
@pytest.mark.parametrize("what", ["200x136", "131x45", "mgcg-128"])
def test_plan_tiling_matches_plain(what, omega, n, tile):
    op = _operator(what)
    p, b, e = _fields(op)
    _hold(op, p, b, e, n, omega, mk.level_plan(tuple(op.diag.shape), n, tile))


@pytest.mark.parametrize("n", [1, 2])
def test_short_halo_fails(n):
    """With 2n halo rows the first pass reads beyond the region (zero
    here), and the error reaches the ring the residual reads. It shrinks
    about fourfold a pass on its way (each update weighs a neighbour by
    w/d ~ 1/4), so at n = 8 its 16 passes leave it far below the
    tolerance: n = 1 and the solver's n = 2 show it."""
    op = _operator("200x136")
    p, b, e = _fields(op)
    plan = mk.level_plan(tuple(op.diag.shape), n)
    short = dataclasses.replace(plan, halo_rows=plan.halo_rows - 1)
    with pytest.raises(AssertionError, match="Tensor-likes are not close"):
        _hold(op, p, b, e, n, 1.0, short)
