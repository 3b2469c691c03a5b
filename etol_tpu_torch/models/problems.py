"""Canonical VGP builders as ``(VGP, NLP)`` factories.

Counterpart of ``uas_2d`` in ``etol_tpu/models/problems.py``; call
``vgp.to_device(device=...)`` and hand both to
:func:`etol_tpu_torch.solve.al_sqp.solve_batched_staged`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.problem import VGP
from ..transcribe.nlp import NLP
from . import dynamics


def _box_obstacles(
    centers: Sequence[Sequence[float]], half: float
) -> list:
    out = []
    for cx, cy in centers:
        out.append(
            [
                [cx - half, cy - half],
                [cx + half, cy - half],
                [cx + half, cy + half],
                [cx - half, cy + half],
            ]
        )
    return out


def uas_2d(
    nsteps: int = 50,
    dt: float = 0.2,
    x0=(0.0, 0.0, 0.0),
    xf=(8.0, 6.0, 0.0),
    v_max: float = 2.0,
    turn_max: float = 1.5,
    obstacle_centers: Sequence[Sequence[float]] = (
        (3.0, 2.0),
        (5.0, 4.5),
        (2.0, 4.0),
    ),
    obstacle_half: float = 0.7,
):
    """BASELINE config 2: 2D UAS (unicycle) with bounded speed/turn rate,
    multiple static obstacles, N=50."""
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = list(x0)
    vgp.xf = list(xf)
    vgp.xtol = [0.05, 0.05, 10.0]  # heading free at the goal
    vgp.xlower = [-20.0, -20.0, -12.0]
    vgp.xupper = [20.0, 20.0, 12.0]
    vgp.ulower = [0.0, -turn_max]
    vgp.uupper = [v_max, turn_max]
    for poly in _box_obstacles(obstacle_centers, obstacle_half):
        vgp.add_exclusion_zone(poly)
    dims = vgp.dims()

    def guess(data):
        # dynamically-consistent guess: fly straight at the goal bearing
        # with constant speed — a near-feasible unicycle rollout
        K = dims.nodes
        w = torch.linspace(0.0, 1.0, K, dtype=data.x0.dtype,
                           device=data.x0.device)[:, None]
        p0, pf = data.x0[:2], data.xf[:2]
        P = (1.0 - w) * p0 + w * pf
        d = pf - p0
        heading = torch.arctan2(d[1], d[0])
        dist = torch.sqrt(torch.sum(d * d))
        v = torch.minimum(
            torch.maximum(dist / (dims.nsteps * data.dt), data.u_lb[0]),
            data.u_ub[0],
        )
        ones = torch.ones((K, 1), dtype=data.x0.dtype, device=data.x0.device)
        X = torch.cat([P, ones * heading], dim=-1)
        U = torch.cat([ones * v, ones * 0.0], dim=-1)
        return torch.cat([X, U], dim=-1).reshape(-1)

    nlp = NLP(
        dims=dims,
        dynamics=dynamics.unicycle,
        # track fuel + smoothness: v^2 + turn^2
        running_cost=lambda x, u, t, d: u[0] ** 2 + 0.5 * u[1] ** 2,
        scheme="hermite_simpson",
        guess=guess,
    )
    return vgp, nlp
