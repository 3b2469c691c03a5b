"""Trajectory utilities: track-center interpolation.

Counterpart of ``linear_interpolation`` in ``etol_tpu/core/trajectory.py``.
"""
from __future__ import annotations

import torch


def linear_interpolation(tval, tvec, ref):
    """Piecewise-linear interpolation with end-extrapolation.

    Parity with the template ``linear_interpolation``
    (TrajectoryOptimizer.hpp:239-257): outside [tvec[0], tvec[-1]] the
    first or last segment is extrapolated. ``tval`` is a tensor of any
    shape; ``tvec`` [K] must be ascending; ``ref`` is [K] or [K, d].

    The segment is found by counting the knots at or below ``tval``
    (``searchsorted(..., side="right")`` on an ascending vector) and
    picked out with a one-hot weight, so the function has no gather and
    maps under ``torch.func.vmap``.
    """
    k = tvec.shape[0]
    j = (tvec <= tval[..., None]).sum(-1) - 1
    j = torch.clamp(j, 0, k - 2)
    idx = torch.arange(k, device=tvec.device)
    sel0 = (idx == j[..., None]).to(tvec.dtype)          # [..., K]
    sel1 = (idx == (j + 1)[..., None]).to(tvec.dtype)
    t0 = (sel0 * tvec).sum(-1)
    t1 = (sel1 * tvec).sum(-1)
    if ref.dim() > 1:
        r0 = (sel0[..., None] * ref).sum(-2)
        r1 = (sel1[..., None] * ref).sum(-2)
    else:
        r0 = (sel0 * ref).sum(-1)
        r1 = (sel1 * ref).sum(-1)
    denom = t1 - t0
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    w = torch.where(denom == 0, torch.zeros_like(denom), (tval - t0) / safe)
    if ref.dim() > 1:
        w = w[..., None]
    return r0 + w * (r1 - r0)
