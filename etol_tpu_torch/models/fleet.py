"""Multi-vehicle VGPs with inter-vehicle deconfliction.

Counterpart of ``etol_tpu/models/fleet.py`` (BASELINE.json config 5:
fleet MPC with deconfliction). A fleet of V point-mass vehicles becomes
ONE VGP with stacked states/controls (nx = 2V, nu = 2V) plus pairwise
minimum-separation path inequalities g = d_min^2 - |p_i - p_j|^2 <= 0 —
the deconfliction constraint the reference has no analog for (it solves
one vehicle per process).

A node is 4V wide: two vehicles (w = 8) fit the KKT kernel, three (w =
12) take cyclic reduction. Scenario batching rides the lane axis on top:
thousands of fleets, each a deconflicted joint solve.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import VGP
from ..transcribe.nlp import NLP


def fleet_2d(
    n_vehicles: int = 3,
    nsteps: int = 24,
    dt: float = 0.25,
    d_min: float = 0.5,
    starts: Optional[Sequence[Tuple[float, float]]] = None,
    goals: Optional[Sequence[Tuple[float, float]]] = None,
    v_max: float = 1.5,
) -> Tuple[VGP, NLP]:
    """V single-integrator vehicles crossing paths, joint solve with
    pairwise separation. Default scenario: vehicles start on a circle
    and swap to antipodal goals (max conflict)."""
    V = n_vehicles
    if starts is None:
        ang = np.linspace(0.0, 2 * np.pi, V, endpoint=False)
        starts = np.stack([3 + 2.5 * np.cos(ang), 3 + 2.5 * np.sin(ang)],
                          axis=-1)
        goals = np.stack(
            [3 + 2.5 * np.cos(ang + np.pi), 3 + 2.5 * np.sin(ang + np.pi)],
            axis=-1,
        )
    starts = np.asarray(starts, dtype=float)
    goals = np.asarray(goals, dtype=float)

    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = starts.reshape(-1).tolist()
    vgp.xf = goals.reshape(-1).tolist()
    vgp.xtol = [0.05] * (2 * V)
    vgp.xlower = [-10.0] * (2 * V)
    vgp.xupper = [10.0] * (2 * V)
    vgp.ulower = [-v_max] * (2 * V)
    vgp.uupper = [v_max] * (2 * V)

    pairs = list(itertools.combinations(range(V), 2))
    d2 = d_min * d_min

    def dynamics(x, u, t, data):
        return u

    def separation(x, u, t, data):
        # d_min^2 - |p_i - p_j|^2 <= 0 for every pair, normalized
        vals = []
        for i, j in pairs:
            pi = x[2 * i : 2 * i + 2]
            pj = x[2 * j : 2 * j + 2]
            dist2 = torch.sum((pi - pj) ** 2)
            vals.append((d2 - dist2) / d2)
        return torch.stack(vals)

    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics,
        running_cost=lambda x, u, t, d: torch.sum(u * u),
        path_ineq=(separation,),
        scheme="trapezoidal",
        use_obstacles=False,
    )
    return vgp, nlp


def min_pairwise_distance(X: torch.Tensor, n_vehicles: int) -> torch.Tensor:
    """Min over time and pairs of inter-vehicle distance; X is [K, 2V]."""
    V = n_vehicles
    P = X.reshape(X.shape[0], V, 2)
    dmin = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    for i, j in itertools.combinations(range(V), 2):
        d = torch.sqrt(torch.sum((P[:, i] - P[:, j]) ** 2, dim=-1))
        dmin = torch.minimum(dmin, torch.min(d))
    return dmin
