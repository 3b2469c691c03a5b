"""Measured per-model solver configurations (the ``uas_2d`` entries).

Counterpart of ``etol_tpu/models/tuned.py``. The numbers are the JAX
package's registry, swept there against its batched iteration CDF; the
solver's iteration counts carry over only as far as the port's
iterations match the reference's, which the CPU parity tests check on
converged outcomes. Two keys of the JAX entry are left out:
``ls_backtracks`` sizes only the sequential line search of
``newton_step``, which the port does not have, and ``lm_rule="ratio"``
is the port's only Levenberg rule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..solve.al_sqp import SolverConfig

# name -> (SolverConfig overrides, compaction stages as (divisor,
# budget) pairs: capacity = B // divisor)
_TUNED = {
    "uas_2d": (
        dict(max_outer=64, max_inner=100, rho0=3160.0,
             rho_growth=5.6, round_viol_patience=4,
             max_total=33, ls_grid=16),
        ((2, 16), (8, 32), (32, 96)),
    ),
}

# warm fleet-MPC re-solve phase for uas_2d
WARM_UAS_2D = (dict(max_total=7), ((8, 24), (32, 96)))

# model-level transcription/seed choices that pair with the configs
_MODEL_EXTRAS = {
    "uas_2d": dict(obstacle_form="pieces", seed_walks=256,
                   seed_pulled=16),
}


def tuned_extras(model: str) -> dict:
    """Model-level transcription/seed choices measured with the
    registry configs (empty when a model has none)."""
    return dict(_MODEL_EXTRAS.get(model, {}))


def _resolve(stages, batch):
    if batch is None:
        return stages
    return tuple((max(batch // dv, 1), bd) for dv, bd in stages)


def tuned_config(
    model: str,
    batch: Optional[int] = None,
    kkt_solver: str = "kernel",
) -> Tuple[SolverConfig, tuple]:
    """Benchmarked (SolverConfig, stages) for a model family.

    ``batch`` resolves the stage divisors into absolute lane counts
    (None keeps the raw (divisor, budget) pairs). ``kkt_solver`` is
    "kernel" (the CUDA kernel on a card, its plain version on the CPU)
    or "scan" (the plain torch block Cholesky everywhere)."""
    if model not in _TUNED:
        raise KeyError(
            f"no tuned config for {model!r}; known: {sorted(_TUNED)}"
        )
    overrides, stages = _TUNED[model]
    cfg = SolverConfig(kkt_solver=kkt_solver, **overrides)
    return cfg, _resolve(stages, batch)


def warm_config(
    base: SolverConfig, batch: Optional[int] = None
) -> Tuple[SolverConfig, tuple]:
    """Benchmarked warm fleet-MPC re-solve phase (uas_2d-class)."""
    overrides, stages = WARM_UAS_2D
    return dataclasses.replace(base, **overrides), _resolve(stages, batch)
