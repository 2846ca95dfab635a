"""Domain decomposition: the slab-sharded fused 3D step on one card.

Counterpart of ``navierstokessolver_tpu/parallel/``: ``make_mesh``,
``shard_state`` and ``sharded_simulation`` (sharding.py), the slab tier of
the fused sharded step (fused_sharded.py) and its row-exchange kernels
(remote_dma.py). JAX's GSPMD placements (``state_shardings``,
``replicate_state``), the explicit-halo solvers (halo.py) and the sharded
LES predictor (pallas_sharded.py) are not ported.
"""

from .sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_state,
    sharded_simulation,
)
