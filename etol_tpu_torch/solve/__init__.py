"""The native batched solver: the AL-SQP over the collocation NLP, its
seeds, planners, branch-and-bound and refinement.

Counterpart of ``etol_tpu/solve``, with the same public names.
"""

from .al_sqp import (
    SolverConfig,
    SolveResult,
    solve,
    solve_batched,
    solve_batched_rescue,
    solve_batched_staged,
    solve_multistart,
)
from . import al_sqp, btridiag, planners, shooting, side_branch
from .branch_bound import MIPResult, integer_mask, solve_milp
from .options import nlp_config
from .planners import PLANNERS
from .refine import solve_refined

__all__ = [
    "SolverConfig",
    "SolveResult",
    "MIPResult",
    "solve",
    "solve_batched",
    "solve_batched_rescue",
    "solve_batched_staged",
    "solve_multistart",
    "solve_refined",
    "solve_milp",
    "integer_mask",
    "nlp_config",
    "al_sqp",
    "btridiag",
    "planners",
    "PLANNERS",
    "shooting",
    "side_branch",
]
