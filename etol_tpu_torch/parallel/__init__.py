"""Meshes and sharded solves.

Counterpart of ``etol_tpu/parallel``, with the JAX package's two axes:

* **batch** — many problems data-parallel over devices or ranks (lanes
  never communicate; :mod:`.mesh`, :mod:`.distributed`);
* **horizon** — one problem's collocation nodes split into slabs: the
  defect coupling at slab boundaries through a one-node halo, reductions
  by ``psum``, and the KKT solve as a SPIKE partitioned elimination
  (:mod:`.horizon`, :mod:`.kkt`, :mod:`.solve_sharded`).

The collectives are written out on tensors (:mod:`.axis`): slabs stacked
on one device in one process, or one slab a rank of ``torch.distributed``.
"""

# the submodule solve_sharded is loaded first: loading it binds its name
# on this package, and the function of the same name must win
from . import solve_sharded as _solve_sharded_module  # noqa: F401
from .mesh import make_mesh, shard_batch, solve_sharded
from .horizon import sharded_defects, sharded_al_pieces

__all__ = [
    "make_mesh",
    "shard_batch",
    "solve_sharded",
    "sharded_defects",
    "sharded_al_pieces",
]
