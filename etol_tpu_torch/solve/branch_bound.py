"""Exact integer support: vartype masks + the MIP result type.

Counterpart of ``etol_tpu/solve/branch_bound.py``. The reference's MILP
backends (eGLPK/eGurobi/eSCIP) get exact integer variables from their
solvers' branch-and-cut (``glp_intopt``, eGLPK.cpp:66;
``GRBModel::optimize``, eGurobi.cpp:115). The port's smooth solver
relaxes integrality; exactness is restored by the unified
branch-and-bound of :mod:`.side_branch`, which branches on integer boxes
AND obstacle escape sides in ONE tree, as the reference's single model
holds both binary families (etol_glpk_example1.cpp:160-276).
:func:`solve_milp` is the integer-entry wrapper around that engine.

A relaxation value bounds the optimum only when the relaxation is
solved to global optimality. For the reference's MILP class (linear
dynamics, convex cost, box and linear constraints) every relaxation is
convex and the search is exact; with nonconvex user path constraints it
is a systematic search over integer assignments with bound pruning off
and the gap reported as unknown.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.problem import VGP, VGPData
from ..core.types import VarType
from ..transcribe.nlp import NLP
from .al_sqp import SolverConfig


def integer_mask(vgp: VGP) -> np.ndarray:
    """[node_width] bool: which node-variable columns are INTEGER/BINARY.

    The reference applies a variable's vartype at every timestep (eGLPK
    createVars, eGLPK.cpp:103-124); so here a masked column is integral
    at every node. Param columns (in sorted-name order, as
    ``VGP.to_device`` lays them out) carry their own vartype: the
    reference's per-window binaries (eGLPK.cpp:275-332) land here."""
    vts = list(vgp.xvartype) + [VarType.CONTINUOUS] * (
        vgp.nx - len(vgp.xvartype)
    )
    vtu = list(vgp.uvartype) + [VarType.CONTINUOUS] * (
        vgp.nu - len(vgp.uvartype)
    )
    vtp = [vgp.params[name].var_type for name in sorted(vgp.params)]
    return np.array(
        [vt != VarType.CONTINUOUS for vt in vts + vtu + vtp], dtype=bool
    )


@dataclasses.dataclass
class MIPResult:
    """Host-side result of a branch-and-bound run (numpy and Python
    numbers, whatever device the relaxations ran on)."""

    z: np.ndarray            # [nz] best integral solution (zeros if none)
    obj: float               # its objective (user sign convention)
    status: int              # Status.SOLVED if an integral incumbent was
                             # found and the tree closed with every prune
                             # certified; MAX_ITER if the node budget ran
                             # out (or a prune was uncertified);
                             # INFEASIBLE only for an exhausted tree with
                             # no incumbent and every prune certified
    best_bound: float        # global relaxation bound at termination
    gap: float               # |obj - best_bound| / max(1, |obj|)
    nodes_solved: int
    waves: int
    incumbent_found: bool
    certified: bool = True   # False if any node was dropped without a
                             # convergence/infeasibility certificate
                             # (status is downgraded to MAX_ITER then)
    trips: int = 0           # sum over waves of the slowest lane's Newton
                             # iterations: the search's KKT solves


def solve_milp(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    int_cols: np.ndarray,
    *,
    wave: int = 8,
    max_nodes: int = 256,
    int_tol: float = 1e-3,
    gap_tol: float = 1e-4,
    convex_relaxation: Optional[bool] = None,
    verbose: bool = False,
) -> MIPResult:
    """Exact integer solve: the unified branch-and-bound engine, with
    integer columns required.

    ``int_cols`` is the [node_width] bool column mask from
    :func:`integer_mask`; ``data`` one problem without a lane axis.
    ``convex_relaxation`` gates bound pruning; ``None`` auto-detects:
    user path-inequality callbacks turn the convexity presumption off
    (pass ``True`` for linear rows, the reference MILP class). Obstacles
    do not turn it off: the engine replaces the smooth obstacle stack
    with per-node LINEAR escape-side rows and branches on them."""
    int_cols = np.asarray(int_cols, dtype=bool)
    if not int_cols.any():
        raise ValueError("no INTEGER/BINARY columns; use al_sqp.solve")
    if convex_relaxation is None:
        convex_relaxation = not nlp.path_ineq
    from .side_branch import solve_exact

    return solve_exact(
        nlp, cfg, data,
        int_cols=int_cols,
        wave=wave,
        max_nodes=max_nodes,
        gap_tol=gap_tol,
        int_tol=int_tol,
        convex_relaxation=convex_relaxation,
        verbose=verbose,
    )
