"""Obstacle constraint values at one point.

Counterpart of ``etol_tpu/transcribe/obstacles.py``. Every function is
written for one point (and one problem) on plain tensors and is mapped
over nodes and lanes with ``torch.func.vmap``. Sign convention: a
constraint value ``g`` is **feasible when g <= 0**; masked-out (padding)
entries always report feasible.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..core.problem import ObstacleData, TrackData
from ..core.trajectory import linear_interpolation


def ellipse_values(p, obs: ObstacleData):
    """Per-edge-ellipse exclusion values at a 2D point ``p``, [E]:
    g_e > 0 means the point is inside edge-ellipse e, normalised by
    asq*bsq (etol_psopt_example1.cpp:159-187)."""
    e = obs.ellipses
    dx = p[0] - e[:, 0]
    dy = p[1] - e[:, 1]
    c, s = e[:, 2], e[:, 3]
    delx = c * dx - s * dy
    dely = s * dx + c * dy
    asq, bsq = e[:, 4], e[:, 5]
    g = asq * bsq - (bsq * delx**2 + asq * dely**2)
    g = g / torch.clamp(asq * bsq, min=1e-12)
    return torch.where(obs.ellipse_mask > 0, g, -torch.ones_like(g))


def _pad_dims(p, D):
    """The first D dims of ``p``, zero-padded when p has fewer."""
    pd = p[:D]
    if pd.shape[0] < D:
        pd = torch.cat([pd, pd.new_zeros((D - pd.shape[0],))])
    return pd


def track_values(p, t, tracks: TrackData):
    """Moving-obstacle ball values at point ``p``, time ``t``, [T]:
    g = (r^2 - |p - c(t)|^2) / r^2 over each track's real dims, with the
    center interpolated along the track's waypoint schedule."""
    T, _, D = tracks.xy.shape
    pd = _pad_dims(p, D)
    rows = []
    for i in range(T):
        c = linear_interpolation(t, tracks.times[i], tracks.xy[i])
        d2 = torch.sum(tracks.dim_mask[i] * (pd - c) ** 2)
        rsq = tracks.radius[i] * tracks.radius[i]
        rows.append((rsq - d2) / torch.clamp(rsq, min=1e-12))
    g = torch.stack(rows)
    return torch.where(tracks.mask > 0, g, -torch.ones_like(g))


def track_centers(ts, tracks: TrackData):
    """Interpolated track centers at the node times ``ts`` [K] ->
    [K, T, D]; a function of time only, built once per problem."""
    def at_t(t):
        return vmap(
            lambda times, xy: linear_interpolation(t, times, xy)
        )(tracks.times, tracks.xy)

    return vmap(at_t)(ts)


def track_values_cached(p, centers_k, tracks: TrackData):
    """:func:`track_values` from a precomputed center row ``centers_k``
    [T, D] (one row of :func:`track_centers`)."""
    T, D = centers_k.shape
    pd = _pad_dims(p, D)
    d2 = torch.sum(tracks.dim_mask * (pd[None, :] - centers_k) ** 2, dim=-1)
    rsq = tracks.radius * tracks.radius
    g = (rsq - d2) / torch.clamp(rsq, min=1e-12)
    return torch.where(tracks.mask > 0, g, -torch.ones_like(g))


def halfspace_margins(p, obs: ObstacleData):
    """Signed containment margin per convex piece, [P]: for piece j with
    outward halfspaces n.x <= b, m_j = min over real rows of (b - n.p);
    m_j > 0 iff p is strictly inside piece j. Masked pieces report
    -1e6."""
    hs = obs.halfspaces  # [P, H, 3]
    margin = hs[..., 2] - (hs[..., 0] * p[0] + hs[..., 1] * p[1])
    big = torch.full_like(margin, 1e6)
    margin = torch.where(obs.hs_mask > 0, margin, big)
    m = torch.amin(margin, dim=-1)
    return torch.where(obs.piece_mask > 0, m, -big[..., 0])


def piece_values(p, obs: ObstacleData, tau: float = 0.05):
    """Smooth conservative containment value per convex piece, [P]:
    ``g_j = softmin_tau(margins) + tau*log(H)``, an overestimate of the
    true min margin, so ``g_j <= 0`` certifies the point is outside
    piece j."""
    hs = obs.halfspaces  # [P, H, 3]
    margin = hs[..., 2] - (hs[..., 0] * p[0] + hs[..., 1] * p[1])
    big = torch.full_like(margin, 1e3)
    margin = torch.where(obs.hs_mask > 0, margin, big)
    softmin = -tau * torch.logsumexp(-margin / tau, dim=-1)
    n_rows = torch.clamp(torch.sum(obs.hs_mask, dim=-1), min=1.0)
    g = softmin + tau * torch.log(n_rows)
    return torch.where(obs.piece_mask > 0, g, -big[..., 0])


def collision_values(
    p, t, obs: ObstacleData, tracks: TrackData, form: str = "both"
):
    """All obstacle constraint values stacked, feasible <= 0: "ellipses"
    ([E+T]), "pieces" ([P+T]) or "both" ([E+P+T])."""
    parts = []
    if form in ("ellipses", "both"):
        parts.append(ellipse_values(p, obs))
    if form in ("pieces", "both"):
        parts.append(piece_values(p, obs))
    parts.append(track_values(p, t, tracks))
    return torch.cat(parts)


def collision_values_cached(
    p, centers_k, obs: ObstacleData, tracks: TrackData, form: str = "both"
):
    """:func:`collision_values` with precomputed track centers
    ``centers_k`` [T, D] — identical values and ordering."""
    parts = []
    if form in ("ellipses", "both"):
        parts.append(ellipse_values(p, obs))
    if form in ("pieces", "both"):
        parts.append(piece_values(p, obs))
    parts.append(track_values_cached(p, centers_k, tracks))
    return torch.cat(parts)
