"""Named sampling-based planners: the registry and the default one.

Counterpart of ``etol_tpu/solve/planners.py``, of which this holds what
the facade's ``plan()`` needs by default: the planner names (eOMPL's
{RRT, SST, EST, KPIECE, PDST}, eOMPL.cpp:121-159, plus the extra CEM and
SHOOTING), the mapping of a wall-clock solve budget onto a sample count,
and the ``"SHOOTING"`` planner (:func:`..solve.shooting.plan`, batched
random shooting). The tree planners and CEM are not ported yet (ROADMAP
Queue 1, item 14): asking for one raises ``NotImplementedError``.

``plan`` returns ``(X [K, nx], U_nodes [K, nu], info)`` for ONE problem
(``data`` without a lane axis).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.problem import VGPData, tree_map
from . import shooting

PLANNERS = ("RRT", "SST", "EST", "KPIECE", "PDST")
EXTRA_PLANNERS = ("CEM", "SHOOTING")

# extensions-per-second rate that maps the reference's wall-clock solve
# budget onto a sample capacity (see budget_samples): the JAX package's
# figure, kept so that one budget means one sample count in both
EXT_RATE = 2048.0


def budget_samples(
    solve_time: float, ext_rate: float = EXT_RATE,
    lo: int = 64, hi: int = 65536,
) -> int:
    """Map a wall-clock solve budget (seconds) to a sample capacity.

    The reference budgets its planner by wall-clock — ``solveTime_ =
    nSteps * dt`` seconds (eOMPL.cpp:241) consumed by
    ``ss_->solve(solveTime_)`` (eOMPL.cpp:164). Here the budget maps
    DETERMINISTICALLY onto the number of extensions the planner is
    allowed (``solve_time * ext_rate``, clamped): the same dial with
    reproducible results."""
    return int(np.clip(round(solve_time * ext_rate), lo, hi))


def plan(
    name: str,
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    n_samples: Optional[int] = 1024,
    generator: Optional[torch.Generator] = None,
    solve_time: Optional[float] = None,
    ext_rate: float = EXT_RATE,
    **kw,
):
    """Dispatch by planner name (case-insensitive), eOMPL setPlanner
    parity (eOMPL.cpp:121-159). ``solve_time`` (seconds) is the
    reference's solve-budget dial (eOMPL.cpp:161-173,241): when given it
    overrides ``n_samples`` via :func:`budget_samples`."""
    name = name.strip().upper()
    if solve_time is not None:
        n_samples = budget_samples(solve_time, ext_rate)
    elif n_samples is None:
        n_samples = 1024
    if name == "SHOOTING":
        X, U, info = shooting.plan(
            dynamics, nsteps, tree_map(lambda a: a[None], data), n_samples,
            generator, **kw)
        return X[0], U[0], {k: v[0] for k, v in info.items()}
    if name in PLANNERS + ("CEM",):
        raise NotImplementedError(
            f"planner {name!r} is not ported to etol_tpu_torch yet "
            "(ROADMAP Queue 1, item 14: the tree planners and CEM); "
            "'SHOOTING' is"
        )
    raise ValueError(
        f"unknown planner {name!r}; choose from "
        f"{PLANNERS + EXTRA_PLANNERS}"
    )
