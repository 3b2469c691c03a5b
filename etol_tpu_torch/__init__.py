"""etol-tpu-torch: the PyTorch and CUDA port of ``etol_tpu``.

The JAX package ``etol_tpu`` stays the reference; this package runs its
main path (batched ``uas_2d`` problems: shooting seeds, the staged
AL-SQP solve, the obstacle audit and the warm fleet re-solve) on an
NVIDIA H100, with the block-tridiagonal KKT solve as a hand-written CUDA
kernel (``csrc/bt_solve.cu``). Module and function names follow the JAX
package so that each part has an obvious counterpart.

The package imports torch and numpy and never jax.
"""

from .core.problem import VGP, VGPData, batch_tile, stack
from .core.types import Dims, Status

__all__ = ["VGP", "VGPData", "Dims", "Status", "batch_tile", "stack"]
