"""Mesh refinement over a ladder of fixed meshes.

Counterpart of ``etol_tpu/solve/refine.py``. The reference's NLP
backends refine their collocation meshes adaptively inside the solve
(PSOPT auto mesh refinement, ePSOPT.cpp:69-71; Dymos
``refine_iteration_limit``, eDymos.cpp:351-358). Here refinement runs
over a small ladder of FIXED meshes: solve at N nodes, densify by an
integer factor (same horizon, smaller dt), interpolate the solution onto
the finer grid as a warm start, re-solve; warm starts make the fine
rungs cheap.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..core.problem import VGP
from ..core.trajectory import linear_interpolation
from ..core.types import Dims
from ..transcribe.nlp import NLP
from .al_sqp import SolveResult, SolverConfig, solve


def interp_solution(z_coarse, dims_c: Dims, dims_f: Dims, dt_c, dt_f):
    """Interpolate a coarse decision vector onto a finer node grid
    (states and controls, piecewise linear — the same guess transform
    the reference's setGuess interpolation performs, eDymos.cpp:537-565).
    """
    w = dims_c.nx + dims_c.nu
    Zc = z_coarse.reshape(dims_c.nodes, w)

    def grid(nodes, dt):
        return torch.arange(nodes, device=Zc.device).to(Zc.dtype) * dt

    Zf = linear_interpolation(
        grid(dims_f.nodes, dt_f), grid(dims_c.nodes, dt_c), Zc)
    return Zf.reshape(-1)


def solve_refined(
    make_problem: Callable[[int], Tuple[VGP, NLP]],
    cfg: Optional[SolverConfig] = None,
    nsteps0: int = 16,
    levels: int = 3,
    factor: int = 2,
    dtype=torch.float32,
    device=None,
) -> List[Tuple[int, SolveResult]]:
    """Solve on a ladder of meshes: nsteps0, nsteps0*factor, ...

    ``make_problem(nsteps)`` builds the (VGP, NLP) at a given mesh (the
    model factories satisfy this with functools.partial). Returns
    [(nsteps, result), ...] coarse-to-fine; the last entry is the
    converged fine-mesh solution. Runs on ``device`` (the card when none
    is given).
    """
    cfg = cfg or SolverConfig()
    out: List[Tuple[int, SolveResult]] = []
    z_prev = None
    prev = None  # (dims, dt)
    for lvl in range(levels):
        nsteps = nsteps0 * factor**lvl
        vgp, nlp = make_problem(nsteps)
        data, dims = vgp.to_device(dtype=dtype, device=device)
        z0 = None
        if z_prev is not None:
            dims_c, dt_c = prev
            z0 = interp_solution(z_prev, dims_c, dims, dt_c, vgp.dt)
        res = solve(nlp, cfg, data, z0)
        out.append((nsteps, res))
        z_prev = res.z
        prev = (dims, vgp.dt)
    return out
