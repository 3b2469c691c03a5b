"""I/O: solver-state checkpointing and the LP file utilities (plus CSV
and XML in :mod:`etol_tpu_torch.core`).

Counterpart of ``etol_tpu/io``. The reference has no checkpoint/resume
(SURVEY.md §5); here the solver state (iterates, multipliers, penalties)
is a tree of tensors, so long batched runs checkpoint and resume
exactly. The LP dump, reader, solver and solution writer are the
reference's eGLPK file functions (eGLPK.cpp:253-272).
"""

from .checkpoint import load_checkpoint, save_checkpoint
from .lp_export import write_lp
from .lp_io import LPModel, LPSolution, read_lp, solve_lp, write_sol

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "write_lp",
    "LPModel",
    "LPSolution",
    "read_lp",
    "solve_lp",
    "write_sol",
]
