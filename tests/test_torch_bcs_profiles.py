"""PyTorch port vs JAX package: BC values that are profiles (arrays).

The port's ``apply_velocity_bcs`` and ``pad_transverse`` take the JAX
package's profile shapes (navierstokessolver_tpu/bcs.py ``_set_face`` and
``pad_transverse``): a normal component with or without the face's own
axis, a tangential one that broadcasts to the reflected edge slab, as a
numpy array or a tensor. Both packages' results agree bit for bit, and a
shape or rank JAX rejects raises ValueError in both (JAX at its broadcast,
the port at the same place and in ``validate_bcs``). Profiles in 3D and
time-dependent values (callables of t) validate, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokessolver_tpu import bcs as jbcs
from navierstokessolver_tpu import grid as jgrid
from navierstokessolver_tpu_torch import bcs as tbcs
from navierstokessolver_tpu_torch import grid as tgrid

SHAPE = (14, 9)


def _profiles(seed):
    n0, n1 = SHAPE
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("u_in", (n1,)), ("v_in", (n1 + 1,)), ("u_in_2d", (1, n1)),
        ("u_wall", (n0 + 1, 1)), ("v_wall", (n0,)), ("v_wall_2d", (n0, 1)))}


def _table(m, p, wrap, variant):
    """The same table in a package ``m``; ``wrap`` turns a numpy profile
    into the package's array type. ``variant`` picks the normal profiles'
    rank (1: without the face's axis, 2: with it)."""
    u_in = p["u_in"] if variant == 1 else p["u_in_2d"]
    v_wall = p["v_wall"] if variant == 1 else p["v_wall_2d"]
    return {(0, 0): m.BCSpec.inflow((wrap(u_in), wrap(p["v_in"]))),
            (0, 1): m.BCSpec.outflow(),
            (1, 0): m.BCSpec.wall((wrap(p["u_wall"]), wrap(v_wall))),
            (1, 1): m.BCSpec.wall((0.25, -0.5))}


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_profiles_match_jax(variant, kind):
    jg = jgrid.GridSpec(shape=SHAPE, lengths=(1.4, 0.9))
    tg = tgrid.GridSpec(SHAPE, (1.4, 0.9))
    p = _profiles(variant)
    jb = _table(jbcs, p, jnp.asarray, variant)
    wrap = torch.from_numpy if kind == "tensor" else (lambda x: x)
    tb = _table(tbcs, p, wrap, variant)
    tbcs.validate_bcs(tg, tb)
    rng = np.random.default_rng(3)
    u = [rng.standard_normal(tg.face_shape(a)).astype(np.float32)
         for a in range(2)]

    @jax.jit
    def ref(uu, vv):
        ub = jbcs.apply_velocity_bcs(jg, jb, (uu, vv))
        return ub, [jbcs.pad_transverse(jg, jb, a, (uu, vv)[a])
                    for a in range(2)]

    jub, jpad = ref(*(jnp.asarray(c) for c in u))
    tu = tuple(torch.from_numpy(c) for c in u)
    for table in (tb, tbcs.bcs_on_device(tb, "cpu")):
        tub = tbcs.apply_velocity_bcs(tg, table, tu)
        for a in range(2):
            np.testing.assert_array_equal(tub[a].numpy(), np.asarray(jub[a]))
            np.testing.assert_array_equal(
                tbcs.pad_transverse(tg, table, a, tu[a]).numpy(),
                np.asarray(jpad[a]))
    # the inputs are left as they were
    for a in range(2):
        np.testing.assert_array_equal(tu[a].numpy(), u[a])
    moved = tbcs.bcs_on_device(tb, "cpu")[(0, 0)].velocity
    assert isinstance(moved[0], torch.Tensor) and moved[0].dtype == torch.float32


@pytest.mark.parametrize("face,value,comp", [
    ((0, 0), "u_short", 0),     # normal u on an axis-0 face: n1 values
    ((0, 0), "v_short", 1),     # tangential v across it: n1 + 1
    ((1, 0), "u_flat", 0),      # tangential u across an axis-1 face: (n0+1, 1)
    ((1, 0), "v_long", 1),      # normal v on it: n0 values
])
def test_profile_shape_errors_match_jax(face, value, comp):
    """A profile of a shape JAX rejects: ValueError from both packages'
    BC passes, and from the port's validate_bcs."""
    n0, n1 = SHAPE
    shapes = {"u_short": (n1 - 1,), "v_short": (n1,), "u_flat": (n0 + 1,),
              "v_long": (n0 + 1,)}
    bad = np.ones(shapes[value], np.float32)
    jg = jgrid.GridSpec(shape=SHAPE, lengths=(1.0, 1.0))
    tg = tgrid.GridSpec(SHAPE, (1.0, 1.0))

    def table(m):
        t = {(a, s): m.BCSpec.wall((0.0, 0.0)) for a in range(2)
             for s in (0, 1)}
        vel = [0.0, 0.0]
        vel[comp] = bad
        t[face] = m.BCSpec.wall(tuple(vel))
        return t

    u = [np.zeros(tg.face_shape(a), np.float32) for a in range(2)]
    normal = comp == face[0]
    with pytest.raises(ValueError):
        ju = tuple(jnp.asarray(c) for c in u)
        if normal:
            jbcs.apply_velocity_bcs(jg, table(jbcs), ju)
        else:
            jbcs.pad_transverse(jg, table(jbcs), comp, ju[comp])
    tu = tuple(torch.from_numpy(c) for c in u)
    with pytest.raises(ValueError, match="profile of shape"):
        if normal:
            tbcs.apply_velocity_bcs(tg, table(tbcs), tu)
        else:
            tbcs.pad_transverse(tg, table(tbcs), comp, tu[comp])
    with pytest.raises(ValueError, match="profile of shape"):
        tbcs.validate_bcs(tg, table(tbcs))


def test_profile_rank_errors_match_jax():
    """A velocity tuple of the wrong rank: ValueError in both packages
    (``BCSpec.component``); profiles in 3D raise NotImplementedError with
    their ROADMAP title; a callable of t validates (a time-dependent
    value, tests/test_torch_timedep.py)."""
    prof = np.ones(SHAPE[1], np.float32)
    for m in (jbcs, tbcs):
        with pytest.raises(ValueError, match="wrong rank"):
            m.BCSpec.inflow((prof,)).component(0, 2)
    tg = tgrid.GridSpec(SHAPE, (1.0, 1.0))
    t = tbcs.no_slip_box(tg)
    t[(0, 0)] = tbcs.BCSpec.inflow((prof, 0.0, 0.0))
    with pytest.raises(ValueError, match="wrong rank"):
        tbcs.validate_bcs(tg, t)
    t[(0, 0)] = tbcs.BCSpec.inflow((lambda t: 1.0, 0.0))
    tbcs.validate_bcs(tg, t)
    assert tbcs.bcs_time_dependent(t)
    g3 = tgrid.GridSpec((6, 6, 6), (1.0, 1.0, 1.0))
    t3 = tbcs.no_slip_box(g3)
    t3[(2, 1)] = tbcs.BCSpec.wall((np.ones((6, 6), np.float32), 0.0, 0.0))
    with pytest.raises(NotImplementedError, match="Other BC kinds"):
        tbcs.validate_bcs(g3, t3)
