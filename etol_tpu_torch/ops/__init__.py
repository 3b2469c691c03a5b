"""The KKT solve's routes: the hand-written CUDA kernel and its wrapper
(:mod:`.bt_cuda`), and block cyclic reduction in plain torch ops
(:mod:`.cyclic_reduction`); the Hermite–Simpson step coupling's kernel
(:mod:`.hs_coupling`); the line search's candidate pass of the separable
schemes (:mod:`.ls_candidates`); the solver loop's while node
(:mod:`.graph_loop`); the kernels' launch counts (:mod:`.tally`).
Nothing is built when this package is imported: a kernel is compiled at
its first launch."""

from .cyclic_reduction import solve as cr_solve

__all__ = ["cr_solve"]
