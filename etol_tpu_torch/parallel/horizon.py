"""Horizon (time-axis) sharded evaluators.

Counterpart of ``etol_tpu/parallel/horizon.py``: the collocation-node
axis split over a mesh axis, each shard a contiguous block of nodes. The
defect that couples a shard's last node to the next shard's first is
computed after a one-node halo from the right neighbour, and the scalar
reductions (cost, squared defects) finish with a ``psum``.

These are standalone building blocks (the multichip dry-run drives
them); the full horizon-sharded solve is
:func:`etol_tpu_torch.parallel.solve_sharded.solve_horizon_sharded`,
which pairs the solver with the SPIKE KKT solve of :mod:`.kkt`.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..core.problem import VGPData
from ..transcribe.nlp import NLP


def _halo_from_next(Z_local, axis):
    """Each slab's view of the NEXT slab's first row ([s, 1, w]; the last
    slab gets the first slab's row, its trailing defect is masked)."""
    return axis.from_right(Z_local[:, :1], 0)


def _slabs(nlp: NLP, mesh, axis: str, Z):
    """(axis, Z's slabs of this process [s, kb, w], their node indices
    [s, kb])."""
    ax = mesh.axis(axis)
    K, n = nlp.dims.nodes, ax.size
    if K % n:
        raise ValueError(f"nodes ({K}) must divide the {axis} axis ({n})")
    kb = K // n
    idx = ax.index(Z.device)
    Z_local = Z.reshape(n, kb, -1).index_select(0, idx)
    ks = idx[:, None] * kb + torch.arange(kb, device=Z.device)
    return ax, Z_local, ks


def _defects_local(nlp: NLP, data: VGPData, ax, Z_local, ks):
    """[s, kb, nx]: the defect of each slab's steps, zero where the node
    is the global last one (it opens no step)."""
    nsteps = nlp.dims.nsteps
    halo = _halo_from_next(Z_local, ax)
    Z_ext = torch.cat([Z_local, halo], dim=1)          # [s, kb+1, w]
    w = Z_local.shape[-1]
    s, kb = ks.shape
    defs = vmap(lambda a, b, k: nlp.step_defect(a, b, k, data))(
        Z_ext[:, :-1].reshape(-1, w), Z_ext[:, 1:].reshape(-1, w),
        ks.clamp(max=nsteps - 1).reshape(-1),
    ).reshape(s, kb, -1)
    valid = (ks < nsteps)[..., None]
    return torch.where(valid, defs, torch.zeros_like(defs))


def sharded_defects(
    nlp: NLP, data: VGPData, mesh, axis: str = "horizon"
):
    """A defect evaluator over the horizon axis: ``f(Z[, data]) ->
    defects`` with Z [K, w] (K = nodes, K % n_shards == 0) and the result
    [K, nx], row k the defect of step k (the rows of the global last node
    zero), on every process."""

    def f(Z, data_: VGPData = data):
        ax, Z_local, ks = _slabs(nlp, mesh, axis, Z)
        defs = _defects_local(nlp, data_, ax, Z_local, ks)
        return ax.gather(defs, 0).reshape(nlp.dims.nodes, -1)

    return f


def sharded_al_pieces(
    nlp: NLP, data: VGPData, mesh, axis: str = "horizon"
):
    """A (cost, squared-defect sum) evaluator over the horizon axis:
    ``f(Z[, data]) -> (cost, viol)``, per-shard partial sums finished
    with ``psum``."""

    def f(Z, data_: VGPData = data):
        ax, Z_local, ks = _slabs(nlp, mesh, axis, Z)
        w = Z_local.shape[-1]
        cost = vmap(lambda zn, k: nlp.node_cost(zn, k, data_))(
            Z_local.reshape(-1, w), ks.reshape(-1)).reshape(ks.shape)
        defs = _defects_local(nlp, data_, ax, Z_local, ks)
        cost = ax.psum(cost.sum(dim=1), 0)
        viol = ax.psum((defs ** 2).sum(dim=(1, 2)), 0)
        return cost[0], viol[0]

    return f
