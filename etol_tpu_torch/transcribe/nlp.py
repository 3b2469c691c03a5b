"""VGP -> NLP assembly: the node-separable surface the solver uses.

Counterpart of ``NLP`` in ``etol_tpu/transcribe/nlp.py``. A user
problem is a set of plain functions ``f(x, u, t, data)`` on tensors; the
methods here are written for ONE node (or one step) of ONE problem, and
the solver maps them over nodes and lanes with ``torch.func.vmap`` and
differentiates them with ``torch.func``.

Decision vector layout is node-major: ``z.reshape(K, nx+nu)`` with states
first — the block structure the block-tridiagonal KKT solve needs.

Not ported yet: delayed dynamics (``x_delay``/``u_delay`` > 0) and
param columns (``dims.n_params`` > 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.func import vmap

from ..core.problem import VGPData
from ..core.types import Dims
from . import collocation, obstacles


@dataclasses.dataclass(frozen=True)
class NLP:
    """Static description of a transcribed VGP family."""

    dims: Dims
    dynamics: Callable                    # f(x, u, t, data) -> xdot [nx]
    running_cost: Callable                # ell(x, u, t, data) -> scalar
    terminal_cost: Optional[Callable] = None   # phi(xN, data) -> scalar
    path_ineq: Tuple[Callable, ...] = ()  # g(x, u, t, data) -> <= 0
    path_eq: Tuple[Callable, ...] = ()    # h(x, u, t, data) -> == 0
    scheme: str = "trapezoidal"
    cost_form: str = "integral"           # "integral" | "sum"
    use_obstacles: bool = True
    obstacle_form: str = "both"           # "ellipses" | "pieces" | "both"
    obstacle_margin: float = 0.0          # inflate: require g <= -margin
    maximize: bool = False
    guess: Optional[Callable] = None      # guess(data) -> z (model-aware)
    x_delay: int = 0
    u_delay: int = 0

    def __post_init__(self):
        if self.x_delay > 0 or self.u_delay > 0:
            raise NotImplementedError(
                "delayed dynamics (x_delay/u_delay > 0) are not ported yet"
            )
        if self.dims.n_params:
            raise NotImplementedError("param columns are not ported yet")

    # ---- layout -------------------------------------------------------
    def unpack(self, z):
        d = self.dims
        ZU = z.reshape(d.nodes, d.node_width)
        return ZU[:, : d.nx], ZU[:, d.nx : d.nx + d.nu]

    def pack(self, X, U):
        return torch.cat([X, U], dim=-1).reshape(-1)

    def _split(self, z_node):
        """One node's slot -> (x, u)."""
        d = self.dims
        return z_node[: d.nx], z_node[d.nx : d.nx + d.nu]

    # ---- node-separable pieces ----------------------------------------
    def node_cost(self, z_node, k, data: VGPData):
        """Cost contribution of node k; sums to :meth:`objective`."""
        d = self.dims
        x, u = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        lv = self.running_cost(x, u, t, data)
        if self.cost_form == "sum":
            J = lv
        else:  # trapezoid weights on the node grid
            half = (k == 0) | (k == d.nsteps)
            w = torch.where(half, 0.5, 1.0).to(z_node.dtype)
            J = data.dt * w * lv
        if self.terminal_cost is not None:
            J = J + torch.where(
                k == d.nsteps, self.terminal_cost(x, data),
                torch.zeros_like(J),
            )
        return -J if self.maximize else J

    def step_defect(self, z_k, z_k1, k, data: VGPData):
        """Collocation defect of step k (nodes k -> k+1), shape [nx]."""
        x0, u0 = self._split(z_k)
        x1, u1 = self._split(z_k1)
        t0 = k.to(z_k.dtype) * data.dt
        return collocation.step_defect(
            self.dynamics, x0, u0, x1, u1, t0, data.dt, data, self.scheme
        )

    @staticmethod
    def _rows(fns, x, u, t, data, like):
        parts = [
            torch.atleast_1d(f(x, u, t, data)).reshape(-1) for f in fns
        ]
        if not parts:
            return like.new_zeros((0,))
        return torch.cat(parts)

    def node_eq(self, z_node, k, data: VGPData):
        """User path equalities at node k, stacked flat (possibly
        0-size)."""
        x, u = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        return self._rows(self.path_eq, x, u, t, data, z_node)

    def node_ineq(self, z_node, k, data: VGPData):
        """All inequality values at node k (obstacles + user), <= 0
        feasible."""
        x, u = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        parts = []
        if self.use_obstacles:
            gv = obstacles.collision_values(
                x, t, data.obstacles, data.tracks, self.obstacle_form
            )
            parts.append(gv + self.obstacle_margin)
        parts.append(self._rows(self.path_ineq, x, u, t, data, z_node))
        return torch.cat(parts)

    def node_ineq_cached(self, z_node, k, tc_k, data: VGPData):
        """:meth:`node_ineq` with a precomputed track-center row ``tc_k``
        [T, D] — identical values and stacking order."""
        x, u = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        return torch.cat([
            self.node_ineq_obs(x, k, tc_k, data),
            self._rows(self.path_ineq, x, u, t, data, z_node),
        ])

    def pos_dims(self, data: VGPData) -> int:
        """State dims the obstacle constraints read: 2-D polygons plus
        up-to-D-dim track balls."""
        return min(max(2, int(data.tracks.xy.shape[-1])), self.dims.nx)

    def node_ineq_obs(self, x, k, tc_k, data: VGPData):
        """Obstacle rows of :meth:`node_ineq_cached` only (a function of
        the state's position dims). 0-size when ``use_obstacles`` is
        off."""
        if not self.use_obstacles:
            return x.new_zeros((0,))
        gv = obstacles.collision_values_cached(
            x, tc_k, data.obstacles, data.tracks, self.obstacle_form
        )
        return gv + self.obstacle_margin

    def node_ineq_user(self, z_node, k, data: VGPData):
        """User path-inequality rows of :meth:`node_ineq_cached` only."""
        x, u = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        return self._rows(self.path_ineq, x, u, t, data, z_node)

    def track_center_table(self, data: VGPData):
        """Moving-obstacle centers at every node time, [K, T, D]."""
        ts = (
            torch.arange(self.dims.nodes, device=data.x0.device)
            .to(data.x0.dtype) * data.dt
        )
        return obstacles.track_centers(ts, data.tracks)

    # ---- scaling hooks (solver-facing) ---------------------------------
    @staticmethod
    def _var_scale(lo, hi):
        half = 0.5 * (hi - lo)
        ok = torch.isfinite(half) & (half > 1e-9)
        return torch.where(ok, torch.clamp(half, 1e-2, 1e4),
                           torch.ones_like(half))

    def variable_scales(self, data: VGPData):
        """Per-variable scale of one node's [x, u] slot, [nx+nu], from
        the declared bounds."""
        return torch.cat([
            self._var_scale(data.x_lb, data.x_ub),
            self._var_scale(data.u_lb, data.u_ub),
        ])

    def defect_scales(self, data: VGPData):
        """Per-row scale of one step defect, [nx]."""
        return torch.clamp(self._var_scale(data.x_lb, data.x_ub), min=1.0)

    # ---- aggregate views ----------------------------------------------
    def objective(self, z, data: VGPData):
        Z = z.reshape(self.dims.nodes, -1)
        ks = torch.arange(self.dims.nodes, device=z.device)
        return torch.sum(
            vmap(lambda zn, k: self.node_cost(zn, k, data))(Z, ks)
        )

    def bounds(self, data: VGPData):
        """Box bounds on z: variable bounds everywhere; nodes k <
        rhorizon pinned to x0; terminal node confined to the goal
        tolerance band intersected with the variable bounds."""
        d = self.dims
        K = d.nodes
        kk = torch.arange(K, device=data.x0.device)[:, None]
        r = max(d.rhorizon, 1)
        x_lb = torch.where(kk < r, data.x0, data.x_lb)
        x_ub = torch.where(kk < r, data.x0, data.x_ub)
        x_lb = torch.where(
            kk == K - 1, torch.maximum(data.xf - data.xtol, data.x_lb), x_lb
        )
        x_ub = torch.where(
            kk == K - 1, torch.minimum(data.xf + data.xtol, data.x_ub), x_ub
        )
        u_lb = data.u_lb.expand(K, d.nu)
        u_ub = data.u_ub.expand(K, d.nu)
        lb = torch.cat([x_lb, u_lb], dim=-1).reshape(-1)
        ub = torch.cat([x_ub, u_ub], dim=-1).reshape(-1)
        return lb, ub

    # ---- initial guess ------------------------------------------------
    def initial_guess(self, data: VGPData):
        """Model-aware guess when the NLP carries one, else straight-line
        state interpolation x0 -> xf with zero controls."""
        if self.guess is not None:
            return self.guess(data)
        d = self.dims
        K = d.nodes
        w = torch.linspace(0.0, 1.0, K, dtype=data.x0.dtype,
                           device=data.x0.device)[:, None]
        X = (1.0 - w) * data.x0 + w * data.xf
        U = X.new_zeros((K, d.nu))
        return self.pack(X, U)

    def score(self, z, data: VGPData):
        """User-facing objective value (undo the maximize sign flip)."""
        J = self.objective(z, data)
        return -J if self.maximize else J
