"""Horizon-sharded AL-SQP: one long-horizon problem over a mesh axis.

Counterpart of ``etol_tpu/parallel/solve_sharded.py``. The batch axis
scales throughput; this axis splits one problem's node axis. The one
sequential piece of an iteration, the block-tridiagonal KKT solve, runs
as the SPIKE partitioned elimination of :mod:`.kkt` (a slab-local
factor, one small separator system, one halo); the node-local
evaluations are the solver's own.

On a device mesh the slabs are stacked on the data's device; on a
process mesh every rank holds the whole replicated solver state and the
KKT solve is the only collective. The loop's lane mask is reduced over
the ranks, so no rank leaves the iteration loop while another still
calls the collective solve.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.problem import VGPData, tree_map
from ..solve import al_sqp
from ..transcribe.nlp import NLP
from . import kkt
from .axis import GroupAxis


def solve_horizon_sharded(
    nlp: NLP,
    cfg: al_sqp.SolverConfig,
    data: VGPData,
    mesh,
    axis: str = "horizon",
    z0: Optional[torch.Tensor] = None,
    lam0=None,
    rho0: Optional[torch.Tensor] = None,
) -> al_sqp.SolveResult:
    """Solve ONE problem (``data`` without a lane axis) with its node axis
    split over ``mesh[axis]``: the result of :func:`al_sqp.solve`, K =
    nodes a multiple of the axis size with >= 2 nodes a shard. The KKT
    route is ``cfg.kkt_solver``'s: "kernel" solves the slabs and the
    separators with ``bt_cuda.solve``, "scan" and "cr" with the plain
    block Cholesky."""
    d = nlp.dims
    n = mesh.shape[axis]
    if d.nodes % n or d.nodes // n < 2:
        raise ValueError(
            f"nodes ({d.nodes}) must divide the {axis} axis ({n}) with "
            ">= 2 nodes per shard"
        )
    if z0 is None:
        z0 = nlp.initial_guess(data)
    lanes = tree_map(lambda a: a[None], data)
    lam0 = (al_sqp.init_multipliers(nlp, lanes) if lam0 is None
            else tuple(a[None] for a in lam0))
    rho = None if rho0 is None else torch.as_tensor(rho0).reshape(1)
    route = "scan" if cfg.kkt_solver == "cr" else cfg.kkt_solver
    kkt_solve = kkt.make_solver(mesh, axis, route)
    ax = mesh.axis(axis)
    agree = None
    if isinstance(ax, GroupAxis):
        def agree(active):
            return ax.psum(active.to(torch.int32)) > 0
    res = al_sqp._solve_batch(nlp, cfg, lanes, z0[None], lam0, rho,
                              kkt_solve=kkt_solve, agree=agree)
    return tree_map(lambda a: a[0], res)
