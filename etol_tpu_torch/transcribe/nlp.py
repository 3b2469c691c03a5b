"""VGP -> NLP assembly: the node-separable surface the solver uses.

Counterpart of ``NLP`` in ``etol_tpu/transcribe/nlp.py``. A user
problem is a set of plain functions ``f(x, u, t, data)`` on tensors; the
methods here are written for ONE node (or one step) of ONE problem, and
the solver maps them over nodes and lanes with ``torch.func.vmap`` and
differentiates them with ``torch.func``.

Decision vector layout is node-major: ``z.reshape(K, nx+nu+n_params)``
with states first — the block structure the block-tridiagonal KKT solve
needs.
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
    dynamics: Callable                    # f(x, u, t, data) -> xdot [nx];
                                          # with x_delay/u_delay > 0:
                                          # f(Xw, Uw, t, data) where
                                          # Xw [x_delay+1, nx] and
                                          # Uw [u_delay+1, nu] end at the
                                          # current node (row -1 = now)
    running_cost: Callable                # ell(x, u, t, data) -> scalar;
                                          # with n_params > 0 an extra
                                          # trailing arg p [n_params]
    terminal_cost: Optional[Callable] = None   # phi(xN, data) -> scalar
    path_ineq: Tuple[Callable, ...] = ()  # g(x, u, t, data[, p]) -> <= 0
    path_eq: Tuple[Callable, ...] = ()    # h(x, u, t, data[, p]) -> == 0
    scheme: str = "trapezoidal"
    cost_form: str = "integral"           # "integral" | "sum"
    use_obstacles: bool = True
    obstacle_form: str = "both"           # "ellipses" | "pieces" | "both"
    obstacle_margin: float = 0.0          # inflate: require g <= -margin
    maximize: bool = False
    guess: Optional[Callable] = None      # guess(data) -> z (model-aware)
    x_delay: int = 0                      # state history steps visible to
                                          # the dynamics
    u_delay: int = 0                      # control history steps

    # ---- layout -------------------------------------------------------
    @property
    def nz(self) -> int:
        return self.dims.nz

    @property
    def delay(self) -> int:
        """History window depth: 0 = memoryless (standard) dynamics."""
        return max(self.x_delay, self.u_delay)

    def unpack(self, z):
        d = self.dims
        ZU = z.reshape(d.nodes, d.node_width)
        return ZU[:, : d.nx], ZU[:, d.nx : d.nx + d.nu]

    def pack(self, X, U, P=None):
        parts = [X, U]
        if self.dims.n_params:
            if P is None:
                P = X.new_zeros((X.shape[0], self.dims.n_params))
            parts.append(P)
        return torch.cat(parts, dim=-1).reshape(-1)

    def _split(self, z_node):
        """One node's slot -> (x, u, p)."""
        d = self.dims
        return (
            z_node[: d.nx],
            z_node[d.nx : d.nx + d.nu],
            z_node[d.nx + d.nu :],
        )

    def _user(self, f, x, u, t, data: VGPData, p):
        """Invoke a user callback: params (when declared) ride as a
        trailing argument, so problems without them keep the plain
        ``f(x, u, t, data)`` signature."""
        if self.dims.n_params:
            return f(x, u, t, data, p)
        return f(x, u, t, data)

    # ---- node-separable pieces ----------------------------------------
    def node_cost(self, z_node, k, data: VGPData):
        """Cost contribution of node k; sums to :meth:`objective`."""
        d = self.dims
        x, u, p = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        lv = self._user(self.running_cost, x, u, t, data, p)
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
        """Collocation defect of step k (nodes k -> k+1), shape [nx].
        Only valid for memoryless dynamics; delayed problems go through
        :meth:`pair_defect`."""
        x0, u0, _ = self._split(z_k)
        x1, u1, _ = self._split(z_k1)
        t0 = k.to(z_k.dtype) * data.dt
        return collocation.step_defect(
            self.dynamics, x0, u0, x1, u1, t0, data.dt, data, self.scheme
        )

    # ---- delayed dynamics (rhorizon as a true history window) ----------
    #
    # A delayed problem declares x_delay/u_delay and its dynamics sees
    # fixed-shape history slices; pre-horizon history clamps to node 0
    # (which the bounds pin to x0). The defect of step k then involves
    # nodes k-delay..k+1; the solver keeps its Hessian block-tridiagonal
    # by differentiating only the two newest nodes (exact gradients,
    # structured curvature).

    def step_windows(self, Z):
        """[nsteps, delay+2, w] sliding windows over the node axis: row j
        of window k is node k - delay + j (clamped at node 0). Built
        from stacked slices (no gather), so it maps under
        ``torch.func.vmap`` and differentiates in both modes."""
        r, n = self.delay, self.dims.nsteps
        Zp = torch.cat([Z[:1].expand((r,) + tuple(Z.shape[1:])), Z], dim=0)
        return torch.stack([Zp[j : j + n] for j in range(r + 2)], dim=1)

    def _hist(self, W, row: int):
        """Dynamics arguments at window row ``row`` (node-local [x, u],
        or history slices when delayed). ``row`` is a Python int."""
        d = self.dims
        X = W[:, : d.nx]
        U = W[:, d.nx : d.nx + d.nu]
        if self.delay == 0:
            return X[row], U[row]
        xw = X[row - self.x_delay : row + 1]
        uw = U[row - self.u_delay : row + 1]
        return xw, uw

    def pair_defect(self, W, k, data: VGPData):
        """Collocation defect of step k from its window W
        [delay+2, node_width] (rows = nodes k-delay .. k+1), shape [nx].

        Equals :meth:`step_defect` when ``delay == 0``. Delayed schemes:
        ``euler`` and ``trapezoidal`` (Hermite-Simpson midpoints are
        ill-defined under a discrete-node delay)."""
        r = self.delay
        if r == 0:
            return self.step_defect(W[0], W[1], k, data)
        d = self.dims
        t0 = k.to(W.dtype) * data.dt
        t1 = t0 + data.dt
        x0 = W[r, : d.nx]
        x1 = W[r + 1, : d.nx]
        xw1, uw1 = self._hist(W, r + 1)
        f1 = self.dynamics(xw1, uw1, t1, data)
        if self.scheme == "euler":
            return x1 - x0 - data.dt * f1
        if self.scheme == "trapezoidal":
            xw0, uw0 = self._hist(W, r)
            f0 = self.dynamics(xw0, uw0, t0, data)
            return x1 - x0 - (data.dt / 2.0) * (f0 + f1)
        raise ValueError(
            f"scheme {self.scheme!r} does not support delayed dynamics; "
            "use 'euler' or 'trapezoidal'"
        )

    def _rows(self, fns, z_node, k, data):
        """The callbacks ``fns`` at one node, stacked flat (possibly
        0-size)."""
        x, u, p = self._split(z_node)
        t = k.to(z_node.dtype) * data.dt
        parts = [
            torch.atleast_1d(self._user(f, x, u, t, data, p)).reshape(-1)
            for f in fns
        ]
        if not parts:
            return z_node.new_zeros((0,))
        return torch.cat(parts)

    def node_eq(self, z_node, k, data: VGPData):
        """User path equalities at node k, stacked flat (possibly
        0-size)."""
        return self._rows(self.path_eq, z_node, k, data)

    def node_ineq(self, z_node, k, data: VGPData):
        """All inequality values at node k (obstacles + user), <= 0
        feasible."""
        x = z_node[: self.dims.nx]
        t = k.to(z_node.dtype) * data.dt
        parts = []
        if self.use_obstacles:
            gv = obstacles.collision_values(
                x, t, data.obstacles, data.tracks, self.obstacle_form
            )
            parts.append(gv + self.obstacle_margin)
        parts.append(self._rows(self.path_ineq, z_node, k, data))
        return torch.cat(parts)

    def node_ineq_cached(self, z_node, k, tc_k, data: VGPData):
        """:meth:`node_ineq` with a precomputed track-center row ``tc_k``
        [T, D] — identical values and stacking order."""
        return torch.cat([
            self.node_ineq_obs(z_node[: self.dims.nx], k, tc_k, data),
            self._rows(self.path_ineq, z_node, k, data),
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
        return self._rows(self.path_ineq, z_node, k, data)

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
        """Per-variable scale of one node's [x, u, p] slot, [node_width],
        from the declared bounds."""
        parts = [
            self._var_scale(data.x_lb, data.x_ub),
            self._var_scale(data.u_lb, data.u_ub),
        ]
        if self.dims.n_params:
            parts.append(self._var_scale(data.p_lb, data.p_ub))
        return torch.cat(parts)

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

    def _nodes(self, z):
        return (z.reshape(self.dims.nodes, -1),
                torch.arange(self.dims.nodes, device=z.device))

    def step_defects(self, z, data: VGPData):
        """All collocation defects, [nsteps, nx]."""
        Z, ks = self._nodes(z)
        ks = ks[:-1]
        if self.delay:
            return vmap(lambda W, k: self.pair_defect(W, k, data))(
                self.step_windows(Z), ks)
        return vmap(
            lambda zk, zk1, k: self.step_defect(zk, zk1, k, data)
        )(Z[:-1], Z[1:], ks)

    def node_eqs(self, z, data: VGPData):
        """User path equalities at all nodes, [K, m_eq_node]."""
        Z, ks = self._nodes(z)
        return vmap(lambda zn, k: self.node_eq(zn, k, data))(Z, ks)

    def node_ineqs(self, z, data: VGPData):
        """All inequality values at all nodes, [K, m_in_node]."""
        Z, ks = self._nodes(z)
        return vmap(lambda zn, k: self.node_ineq(zn, k, data))(Z, ks)

    def eq_residuals(self, z, data: VGPData):
        parts = [self.step_defects(z, data).reshape(-1)]
        if self.path_eq:
            parts.append(self.node_eqs(z, data).reshape(-1))
        return torch.cat(parts)

    def ineq_residuals(self, z, data: VGPData):
        return self.node_ineqs(z, data).reshape(-1)

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
        lbs, ubs = [x_lb, u_lb], [x_ub, u_ub]
        if d.n_params:
            # masked dense columns: a param variable exists only inside
            # its [t_start, t_stop] activation window; outside, the
            # column pins to 0
            ts = kk.to(data.p_lb.dtype) * data.dt
            active = (ts >= data.p_window[None, :, 0] - 1e-9) & (
                ts <= data.p_window[None, :, 1] + 1e-9
            )
            zero = torch.zeros_like(data.p_lb)
            lbs.append(torch.where(active, data.p_lb, zero))
            ubs.append(torch.where(active, data.p_ub, zero))
        lb = torch.cat(lbs, dim=-1).reshape(-1)
        ub = torch.cat(ubs, dim=-1).reshape(-1)
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
        return self.pack(X, U)  # pack zero-fills param columns

    def score(self, z, data: VGPData):
        """User-facing objective value (undo the maximize sign flip)."""
        J = self.objective(z, data)
        return -J if self.maximize else J
