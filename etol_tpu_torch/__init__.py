"""etol-tpu-torch: the PyTorch and CUDA port of ``etol_tpu``.

The JAX package ``etol_tpu`` stays the reference; this package runs the
library's entry point, the :class:`TrajectoryOptimizer` facade over the
shipped XML problems (solve, multistart, the fleet call with its rescue
phase, the MPC step, the certified branch-and-bound of ``solve_exact``),
and the bench's main path (batched ``uas_2d``
problems: shooting seeds, the staged AL-SQP solve, the obstacle audit
and the warm fleet re-solve) on an NVIDIA H100, with the
block-tridiagonal KKT solve as a hand-written CUDA kernel
(``csrc/bt_solve.cu``). Module and function names follow the JAX package
so that each part has an obvious counterpart.

The package imports torch and numpy and never jax.
"""

from .core.problem import VGP, VGPData, Track, batch_tile, stack
from .core.types import Dims, ParamConfig, Status, VarType
from .core.xml_io import load_configs, save_configs
from .transcribe.nlp import NLP

__all__ = [
    "VGP",
    "VGPData",
    "Track",
    "Dims",
    "ParamConfig",
    "Status",
    "VarType",
    "NLP",
    "load_configs",
    "save_configs",
    "stack",
    "batch_tile",
    "TrajectoryOptimizer",
]


def __getattr__(name):
    # Lazy: the facade pulls in the solver stack; keep bare core imports fast.
    if name == "TrajectoryOptimizer":
        from .optimizer import TrajectoryOptimizer

        return TrajectoryOptimizer
    raise AttributeError(
        f"module 'etol_tpu_torch' has no attribute {name!r}")
