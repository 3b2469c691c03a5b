"""Batched augmented-Lagrangian Gauss-Newton SQP (PyTorch).

Counterpart of ``etol_tpu/solve/al_sqp.py``: the same flattened AL-SQP
(one stream of damped projected-Newton iterations, with the PHR
multiplier and penalty update folded in per lane), the same staged
compaction, and the same numbers in :class:`SolverConfig`.

Layout. The JAX package writes the solver for one problem and ``vmap``s
it over a batch. Here the state is batch-native: every tensor carries
the lane axis first ([B, ...]). The per-lane math (AL value, gradient,
Hessian blocks) is written for one problem and mapped over lanes with
``torch.func.vmap``; the KKT solve takes the whole batch at once.

The loop. It runs while any lane's own loop condition holds, and every
state tensor is updated as ``torch.where(active, new, old)``, so a lane
stops changing exactly where its own JAX ``while_loop`` would stop
(``inner_iters`` and the stage trip counts depend on this). One trip is
a full Newton step and then ``cfg.chord_steps`` reuse steps against the
stored KKT blocks; the freeze wraps the whole trip. On a card the trip
is captured once as a CUDA graph and the loop is one graph launch, a
while node around the trip whose stop test runs on the card, the
counterpart of the JAX package's one traced ``while_loop``
(:mod:`.trip_graph`). Each solve the JAX package jits (``solve``,
``solve_batched``, ``solve_multistart``, ``solve_batched_rescue``,
``solve_batched_staged``) is written once as steps around its loops and
runs on a card as one program, one graph launch a call, its draws made
before it. On the CPU a Python ``while`` tests ``active.any()`` once per
trip.

The KKT solve. ``kkt_solver="kernel"`` launches the CUDA kernel
(:mod:`..ops.bt_cuda`) for float32 problems with node widths up to 9,
from every entry point: the unbatched :func:`solve` is a batch of one
and launches it too (on an H100 one launch at K=51, w=5 takes under
0.1 ms of host time against tens of milliseconds for the log-depth
sweep of small torch ops; the JAX package's unbatched route is cyclic
reduction, a choice made for the TPU). Nodes wider than 9 and float64
problems take cyclic reduction (:mod:`..ops.cyclic_reduction`). The
route is chosen from the width and the dtype before anything is
launched: a kernel that fails to build or launch raises. ``"scan"``
and ``"cr"`` name one path for every shape and dtype. A KKT solver
handed to ``_solve_batch`` (``kkt_solve``: the horizon-sharded SPIKE
solve of ``parallel/solve_sharded.py``) takes every solve instead, with
one refinement pass.

The step coupling. The Gauss-Newton blocks and the defect's curvature
of a Hermite-Simpson step (``_pair_coupling``: two ``jacfwd`` and one
``hessian`` of the step defect under ``vmap``, ~660 small kernels a
trip) are one launch of the CUDA kernel of :mod:`..ops.hs_coupling` for
float32 memoryless problems whose dynamics that kernel holds, on a card;
the route is chosen from the input when the building blocks are made
(``_ALFuncs.coupling``), and everything else keeps ``_pair_coupling`` or
its scheme's own path.

The line search. The candidate pass of a memoryless euler or trapezoidal
problem whose dynamics are ``xdot = u[:nx]`` and which has no user path
rows (``ocp_2d_ex1`` through the facade, the 3-D point mass) is one
launch of the CUDA kernel of :mod:`..ops.ls_candidates` for float32 on a
card: every candidate's point, AL value less the cost and decrease, the
user's running cost added in PyTorch; a second launch gives the chosen
step's point, defects and rows. The route is chosen from the input when
the building blocks are made (``_ALFuncs.line_search``); everything else
keeps the candidates' residuals under ``vmap``.

Precision. Float32 by default, with reduced-precision matmul modes off:
the reference pins ``Precision.HIGHEST`` because reduced-precision
products corrupt the Gauss-Newton blocks once rho is large.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as tnf
from torch.func import grad, hessian, jacfwd, vmap

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from ..core.problem import VGPData, map_lanes, tree_map
from ..core.types import Status
from ..ops import bt_cuda, cyclic_reduction, hs_coupling, ls_candidates
from ..transcribe.nlp import NLP
from ..utils import profiling
from . import btridiag, shooting

# step-size grid of the parallel line search: alphas = 0.5**j
_LS_EXPONENTS = tuple(range(24))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs: the JAX package's fields, in its order, with its
    defaults and meanings (see ``etol_tpu.solve.al_sqp.SolverConfig`` for
    the measurements behind each). The one default that differs is
    ``kkt_solver``: its values name the port's routes ("kernel" for the
    CUDA kernel, where the JAX package's TPU route is "pallas")."""

    max_outer: int = 20
    max_inner: int = 50
    tol_stat: float = 5e-4      # projected-gradient inf-norm
    stat_eps: float = 3e-6      # rho-scaled stationarity floor
    tol_cons: float = 1e-4      # constraint violation inf-norm
    rho0: float = 10.0          # initial AL penalty
    rho_growth: float = 2.0
    rho_max: float = 1e5
    viol_decrease: float = 0.5  # required viol reduction else rho grows
    reg: float = 1e-6           # base diagonal regularization
    hessian: str = "defect"     # constraint curvature: "defect" adds
                                # the exact dynamics curvature
                                # (λ+ρc)·∇²c to the Gauss-Newton blocks
                                # (zero on linear dynamics, decisive on
                                # nonlinear ones); "gn" = Gauss-Newton
                                # only; "full" also adds the curvature
                                # of the inequalities and of the user
                                # equalities (can turn blocks indefinite
                                # near obstacles; the damping absorbs it)
    lm0: float = 1e-3           # initial Levenberg damping (relative)
    lm_min: float = 1e-6
    lm_max: float = 30.0
    ls_backtracks: int = 24     # halvings of the sequential Armijo search
                                # of _ALFuncs.newton_step
    ls_c1: float = 1e-4
    ls_grid: int = 24           # line-search candidates 0.5**j, j < ls_grid
    max_total: int = 0          # global Newton budget; 0 = outer * inner
    inner_tol0: float = 1e-2    # LANCELOT: inner tol tightens with rho
    stall_tol: float = 1e-7     # relative AL-decrease floor
    kkt_solver: str = "kernel"  # "kernel": ops.bt_cuda (the CUDA kernel
                                # on a card, its plain version on the
                                # CPU) for float32 nodes up to the
                                # kernel's width 9, in the batched
                                # solves and in the unbatched solve()
                                # alike; cyclic reduction for wider
                                # nodes and for float64;
                                # "scan": the plain torch block Cholesky
                                # everywhere; "cr": cyclic reduction
                                # everywhere
    ls_eta: float = 0.0         # Zhang-Hager nonmonotone line search:
                                # accept against the decaying average C
                                # of past AL values (eta = its memory;
                                # 0 = monotone Armijo against the last
                                # value)
    round_viol_patience: int = 8
    round_viol_factor: float = 0.9
    dual_relax: float = 1.0     # over-relaxed multiplier update:
                                # lambda += dual_relax * rho * c
    ls_exponents: tuple = ()    # explicit line-search grid, alphas =
                                # 0.5**e; () = 0..ls_grid-1
    ls_deep_round: int = 0      # an accepted step at exponent >= this
                                # counts as no progress (0 = off)
    ls_rule: str = "first"      # "first": the largest passing alpha;
                                # "best": the lowest AL value among the
                                # passing candidates
    sep_assembly: bool = True   # euler/trapezoidal: one dynamics
                                # Jacobian and one w-dim curvature
                                # Hessian per NODE serve both adjacent
                                # steps (the cross-node quadrant is
                                # exactly zero); False = the generic
                                # node-pair path, the same math
    chord_steps: int = 0        # after each full Newton step, this many
                                # reuse steps that re-solve the stored
                                # KKT blocks with a fresh gradient (no
                                # assembly); each counts as an iteration
    lm_rule: str = "ratio"      # Levenberg signal: "ratio" (actual over
                                # predicted decrease) or "count" (the
                                # accepted step's backtrack depth)

    def __post_init__(self):
        for name, allowed in (("kkt_solver", ("kernel", "scan", "cr")),
                              ("hessian", ("defect", "gn", "full")),
                              ("ls_rule", ("first", "best")),
                              ("lm_rule", ("ratio", "count"))):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got {value!r}")
        if self.chord_steps < 0:
            raise ValueError(
                f"chord_steps must be >= 0, got {self.chord_steps}")


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Per-lane results, lane axis first."""

    z: torch.Tensor            # [B, nz] primal solution
    obj: torch.Tensor          # [B] objective (user sign convention)
    status: torch.Tensor       # [B] int32, values of core.types.Status
    outer_iters: torch.Tensor  # [B]
    inner_iters: torch.Tensor  # [B] Newton iterations run
    viol_eq: torch.Tensor      # [B] max |c_eq|
    viol_in: torch.Tensor      # [B] max relu(g)
    grad_norm: torch.Tensor    # [B] final projected-gradient inf-norm
    lam_def: torch.Tensor      # [B, N, nx] defect multipliers
    lam_eq: torch.Tensor       # [B, K, m_eq] user-equality multipliers
    mu: torch.Tensor           # [B, K, m_in] inequality multipliers
    rho: torch.Tensor          # [B] final penalty


def _result_sizes(nlp: NLP, data: VGPData):
    """Multiplier row counts (m_eq, m_in) per node, from one evaluation
    on lane 0."""
    lane = tree_map(lambda a: a[0], data)
    zn = lane.x0.new_zeros((nlp.dims.node_width,))
    k = torch.zeros((), dtype=torch.long, device=zn.device)
    return (nlp.node_eq(zn, k, lane).shape[0],
            nlp.node_ineq(zn, k, lane).shape[0])


def _amax0(a):
    """Per-lane max over the trailing two dims, with 0 as the floor (and
    the answer for an empty tensor) — ``jnp.max(..., initial=0.0)``."""
    if a.shape[-1] == 0 or a.shape[-2] == 0:
        return a.new_zeros(a.shape[:-2])
    return torch.clamp(torch.amax(a, dim=(-2, -1)), min=0.0)


def _jacfwd(fn):
    """``torch.func.jacfwd`` with the Jacobian in its argument's dtype.
    Forward mode promotes a Python scalar times a 0-dim element of the
    argument (``10.0 * x[3]``, the style dynamics are written in) to
    float64; the solver's blocks stay float32, as the JAX package's
    do."""
    return lambda x: jacfwd(fn)(x).to(x.dtype)


def _sel(mask, new, old):
    """torch.where with a [B] lane mask over [B, ...] tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


class _ALFuncs:
    """The solver's building blocks for one batch of problems.

    Every public method takes and returns tensors with the lane axis
    first; the per-lane math (``_*_lane``) is written for one problem and
    mapped over lanes with ``torch.func.vmap``."""

    #: ``stamp(phase)`` at a trip's phase boundaries (:data:`PHASES`), set
    #: on a traced trip's copy by :mod:`.trip_graph`; None stamps nothing
    stamp = None
    #: ``ls_stamp(phase)`` at the line search's start (-1) and end (0),
    #: set on a device loop's trip by :mod:`.trip_graph`; None stamps
    #: nothing
    ls_stamp = None

    def __init__(self, nlp: NLP, cfg: SolverConfig, data: VGPData,
                 box=None, kkt_solve=None):
        # an optional KKT override f(D, O, rhs) -> direction, e.g. the
        # horizon-sharded SPIKE solve (parallel/kkt.py) over a mesh
        self.kkt_solve = kkt_solve
        self.nlp, self.cfg, self.data = nlp, cfg, data
        d = nlp.dims
        self.K, self.w = d.nodes, d.node_width
        self.dtype = data.x0.dtype
        # the KKT route, from the config, the node width and the dtype
        # alone: the kernel takes float32 nodes up to MAX_W wide; wider
        # nodes (as in the JAX package's vmap rule) and float64 problems
        # go to cyclic reduction
        self.kkt = cfg.kkt_solver
        if self.kkt == "kernel" and (
                self.w > bt_cuda.MAX_W or self.dtype != torch.float32):
            self.kkt = "cr"
        dev = data.x0.device
        # the step coupling's route, from the input alone: the kernel
        # for float32 Hermite-Simpson problems whose dynamics it holds,
        # on a card; _pair_coupling (or the scheme's own path) elsewhere
        self.coupling = ("kernel" if hs_coupling.takes(nlp, self.dtype, dev)
                         else "plain")
        # the line search's candidate pass, from the input alone: the
        # kernel for float32 separable problems whose dynamics it holds,
        # without user rows, on a card; the candidates' residuals under
        # vmap elsewhere
        self.line_search = (
            "kernel" if ls_candidates.takes(nlp, self.dtype, dev)
            else "plain")
        self.ks_step = torch.arange(d.nsteps, device=dev)
        self.ks_node = torch.arange(self.K, device=dev)
        lb, ub = self._lanes(nlp.bounds)
        B = lb.shape[0]
        self.lb = lb.reshape(B, self.K, self.w)
        self.ub = ub.reshape(B, self.K, self.w)
        if box is not None:
            # an extra per-entry box (a branch-and-bound node's integer
            # branching), intersected with the NLP bounds
            blo, bhi = box
            self.lb = torch.maximum(self.lb, blo.reshape(B, self.K, self.w))
            self.ub = torch.minimum(self.ub, bhi.reshape(B, self.K, self.w))
        self.pinned = (self.ub - self.lb) <= 1e-12
        self.scale = self._lanes(nlp.variable_scales)[:, None, :].expand(
            B, self.K, self.w
        )
        self.cscale = self._lanes(nlp.defect_scales)          # [B, nx]
        self.track_ctrs = self._lanes(nlp.track_center_table)  # [B,K,T,D]

    def _lanes(self, fn, *args):
        """fn(data_of_lane, *args_of_lane) over lanes."""
        return map_lanes(fn, self.data, *args)

    # ---- per-lane math ------------------------------------------------
    def _residuals_lane(self, data, cscale, tc, Z):
        nlp = self.nlp
        if nlp.delay:
            c_def = vmap(lambda W, k: nlp.pair_defect(W, k, data))(
                nlp.step_windows(Z), self.ks_step
            ) / cscale
        else:
            c_def = vmap(lambda a, b, k: nlp.step_defect(a, b, k, data))(
                Z[:-1], Z[1:], self.ks_step
            ) / cscale
        c_eq = vmap(lambda zn, k: nlp.node_eq(zn, k, data))(Z, self.ks_node)
        g = vmap(
            lambda zn, k, tck: nlp.node_ineq_cached(zn, k, tck, data)
        )(Z, self.ks_node, tc)
        return c_def, c_eq, g

    def _cost_lane(self, data, Z):
        return torch.sum(
            vmap(lambda zn, k: self.nlp.node_cost(zn, k, data))(
                Z, self.ks_node
            )
        )

    def _al_value_lane(self, data, cscale, tc, Z, lam_def, lam_eq, mu, rho):
        c_def, c_eq, g = self._residuals_lane(data, cscale, tc, Z)
        return self.al_from_parts(
            self._cost_lane(data, Z), c_def, c_eq, g, lam_def, lam_eq, mu,
            rho,
        )

    # ---- batched surface ------------------------------------------------
    def residuals(self, Z):
        """(c_def [B,N,nx], c_eq [B,K,m_eq], g [B,K,m_in]) at Z [B,K,w]."""
        return self._lanes(
            self._residuals_lane, self.cscale, self.track_ctrs, Z
        )

    def cost(self, Z):
        return self._lanes(self._cost_lane, Z)

    def candidate_residuals(self, Zc):
        """Residuals and cost of Zc [B, n, K, w]: n candidates per lane."""
        def lane(data, cscale, tc, Zs):
            res = vmap(
                lambda Z: self._residuals_lane(data, cscale, tc, Z)
            )(Zs)
            return res, vmap(lambda Z: self._cost_lane(data, Z))(Zs)

        return self._lanes(lane, self.cscale, self.track_ctrs, Zc)

    def candidate_cost(self, Zc):
        """Cost of Zc [B, n, K, w], n candidates per lane, [B, n]."""
        return self._lanes(
            lambda data, Zs: vmap(lambda Z: self._cost_lane(data, Z))(Zs),
            Zc)

    def ls_kernel(self, Z, p, grad_, alphas, lam_def, mu, rho, sel=None):
        """The line search's candidate pass on the kernel route
        (:mod:`..ops.ls_candidates`): every candidate's (Zc [B, n, K, w],
        AL value less the cost [B, n], decrease [B, n]); with ``sel`` [B],
        the chosen candidates' (Z [B, K, w], c_def, g)."""
        lanes = ls_candidates.Lanes.of(self.lb, self.ub, self.cscale,
                                       self.track_ctrs, self.data)
        args = (self.nlp, lanes) + tuple(t.contiguous() for t in (
            Z, p, grad_, alphas, lam_def, mu, rho))
        if sel is None:
            return ls_candidates.candidates(*args)
        return ls_candidates.chosen(*args, sel.contiguous())

    @staticmethod
    def al_from_parts(J, c_def, c_eq, g, lam_def, lam_eq, mu, rho):
        """AL value from already-computed residual parts. Each part's two
        trailing (node, row) dims are summed, so leading lane or
        candidate dims broadcast."""
        def s2(a):
            return a.sum(dim=(-2, -1))

        J = J + s2(lam_def * c_def) + 0.5 * rho * s2(c_def**2)
        J = J + s2(lam_eq * c_eq) + 0.5 * rho * s2(c_eq**2)
        s = torch.clamp(mu + rho[..., None, None] * g, min=0.0)
        return J + (0.5 / rho) * s2(s * s - mu * mu)

    def al_value(self, Z, lam_def, lam_eq, mu, rho):
        return self._lanes(
            self._al_value_lane, self.cscale, self.track_ctrs,
            Z, lam_def, lam_eq, mu, rho,
        )

    def al_grad(self, Z, lam_def, lam_eq, mu, rho):
        """d AL / d Z per lane, [B, K, w] (``torch.func.grad``)."""
        def lane(data, cscale, tc, Z, lam_def, lam_eq, mu, rho):
            return grad(
                lambda v: self._al_value_lane(
                    data, cscale, tc, v, lam_def, lam_eq, mu, rho
                )
            )(Z)

        return self._lanes(
            lane, self.cscale, self.track_ctrs, Z, lam_def, lam_eq, mu, rho
        )

    def gn_blocks(self, Z, lam_def, lam_eq, mu, rho, free, lm, g):
        """AL Hessian blocks (D [B,K,w,w], O [B,K-1,w,w]) in scaled
        coordinates: Gauss-Newton + the constraint curvature that
        ``cfg.hessian`` names (the defect's per node for memoryless
        euler/trapezoidal under ``cfg.sep_assembly``, else on the
        generic node-pair path; a delayed problem differentiates only
        the two newest nodes of each window, which keeps the blocks
        tridiagonal), active-set masking and Levenberg damping. ``g``
        carries the inequality residuals at Z. On the kernel route
        (``self.coupling``) the step coupling is one launch over the
        batch (:mod:`..ops.hs_coupling`)."""
        coupled = ()
        if self.coupling == "kernel":
            coupled = hs_coupling.coupling(
                self.nlp.dynamics, Z.contiguous(), lam_def.contiguous(),
                rho.contiguous(), self.cscale.contiguous(),
                self.data.dt.contiguous(), exact=self.cfg.hessian != "gn")
        return self._lanes(
            self._gn_blocks_lane, self.scale, self.cscale, self.track_ctrs,
            Z, lam_def, lam_eq, mu, rho, free, lm, g, *coupled,
        )

    def _gn_blocks_lane(self, data, scale, cscale, tc, Z, lam_def, lam_eq,
                        mu, rho, free, lm, g, *coupled):
        nlp, cfg, w = self.nlp, self.cfg, self.w
        d = nlp.dims
        dtype = Z.dtype
        pd = nlp.pos_dims(data)
        eye = torch.eye(w, dtype=dtype, device=Z.device)
        m_obs = nlp.node_ineq_obs(Z[0, : d.nx], self.ks_node[0], tc[0],
                                  data).shape[0]

        def node_blocks(zn, k, mu_k, lam_eq_k, tc_k, g_k):
            H = hessian(lambda v: nlp.node_cost(v, k, data))(zn)
            De = torch.zeros_like(H)
            if nlp.path_eq:
                Ge = _jacfwd(lambda v: nlp.node_eq(v, k, data))(zn)
                De = De + Ge.T @ Ge
            act = (mu_k + rho * g_k > 0).to(dtype)
            if m_obs:
                x = zn[: d.nx]
                Go = _jacfwd(
                    lambda v: nlp.node_ineq_obs(
                        torch.cat([v, x[pd:]]), k, tc_k, data
                    )
                )(x[:pd])  # [m_obs, pd]
                Goa = Go * act[:m_obs, None]
                De = De + tnf.pad(Goa.T @ Go, (0, w - pd, 0, w - pd))
            if nlp.path_ineq:
                Gu = _jacfwd(lambda v: nlp.node_ineq_user(v, k, data))(zn)
                De = De + (Gu * act[m_obs:, None]).T @ Gu
            H = H + rho * De
            if cfg.hessian == "full":
                # Σ s·∇²g with s = max(0, μ+ρg), and (λ+ρh)·∇²h; the
                # weights are constants of the differentiation
                sg = torch.clamp(mu_k + rho * g_k, min=0.0)
                if m_obs:
                    Hoo = hessian(
                        lambda v: torch.sum(
                            sg[:m_obs] * nlp.node_ineq_obs(
                                torch.cat([v, x[pd:]]), k, tc_k, data)
                        )
                    )(x[:pd])
                    H = H + tnf.pad(Hoo, (0, w - pd, 0, w - pd))
                if nlp.path_ineq:
                    H = H + hessian(
                        lambda v: torch.sum(
                            sg[m_obs:] * nlp.node_ineq_user(v, k, data))
                    )(zn)
                if nlp.path_eq:
                    se = lam_eq_k + rho * nlp.node_eq(zn, k, data)
                    H = H + hessian(
                        lambda v: torch.sum(se * nlp.node_eq(v, k, data))
                    )(zn)
            return H

        D = vmap(node_blocks)(Z, self.ks_node, mu, lam_eq, tc, g)

        if coupled:
            Dc, O = coupled
        elif nlp.delay:
            Dc, O = self._window_coupling(data, cscale, Z, lam_def, rho)
        elif cfg.sep_assembly and nlp.scheme in ("euler", "trapezoidal"):
            Dc, O = self._sep_coupling(data, cscale, Z, lam_def, rho)
        else:
            Dc, O = self._pair_coupling(data, cscale, Z, lam_def, rho)
        D = D + Dc

        # relative-variable coordinates: H~ = S H S
        D = D * (scale[:, :, None] * scale[:, None, :])
        O = O * (scale[:-1][:, :, None] * scale[1:][:, None, :])
        # active-set masking: fixed rows/cols become identity
        m = free.to(dtype)
        D = D * (m[:, :, None] * m[:, None, :])
        D = D + eye * (1.0 - m)[:, None, :]
        O = O * (m[:-1][:, :, None] * m[1:][:, None, :])
        # damping keeps the factor SPD (f32) and globalizes Newton
        D = D + ((cfg.reg + lm) * (1.0 + rho)) * eye
        return D, O

    def _pair_coupling(self, data, cscale, Z, lam_def, rho):
        """Step coupling on the generic node-pair path: what the steps
        add to the diagonal blocks [K, w, w], and the off-diagonal
        blocks O [K-1, w, w]."""
        nlp, w = self.nlp, self.w

        # defect Jacobians A_k = dc/dz_k, B_k = dc/dz_{k+1}
        def step_jacs(a, b, k):
            cs = cscale[:, None]
            A = _jacfwd(lambda v: nlp.step_defect(v, b, k, data))(a) / cs
            Bk = _jacfwd(lambda v: nlp.step_defect(a, v, k, data))(b) / cs
            return A, Bk

        A, Bj = vmap(step_jacs)(Z[:-1], Z[1:], self.ks_step)
        if self.cfg.hessian == "gn":
            return self._gn_coupling(A, Bj, rho)

        # exact defect curvature: hessian over the node pair of
        # (λ+ρc)·c, split into its four w×w quadrants
        def pair_curv(a, b, k, lam_k):
            sdef = lam_k + rho * nlp.step_defect(a, b, k, data) / cscale
            Hp = hessian(
                lambda v: torch.sum(
                    sdef * nlp.step_defect(v[:w], v[w:], k, data) / cscale
                )
            )(torch.cat([a, b]))
            return Hp[:w, :w], Hp[w:, w:], Hp[:w, w:]

        Haa, Hbb, Hab = vmap(pair_curv)(Z[:-1], Z[1:], self.ks_step, lam_def)
        return self._gn_coupling(A, Bj, rho, Haa, Hbb, Hab)

    def _window_coupling(self, data, cscale, Z, lam_def, rho):
        """Step coupling of a delayed problem: Jacobians and curvature of
        each step's defect in the two newest nodes of its window only
        (older-node coupling stays out of the blocks; the gradient stays
        exact, so this is an inexact-Newton preconditioner, not an
        approximation of the problem). Same returns as
        :meth:`_pair_coupling`."""
        nlp, w = self.nlp, self.w

        def defect(Wk, a, b, k):
            """Step k's scaled defect with the window's two newest rows
            replaced by a, b."""
            return nlp.pair_defect(
                torch.cat([Wk[:-2], a[None], b[None]]), k, data) / cscale

        def step_jacs(Wk, k):
            A = _jacfwd(lambda v: defect(Wk, v, Wk[-1], k))(Wk[-2])
            Bk = _jacfwd(lambda v: defect(Wk, Wk[-2], v, k))(Wk[-1])
            return A, Bk

        Wn = nlp.step_windows(Z)
        A, Bj = vmap(step_jacs)(Wn, self.ks_step)
        if self.cfg.hessian == "gn":
            return self._gn_coupling(A, Bj, rho)

        def pair_curv(Wk, k, lam_k):
            sdef = lam_k + rho * defect(Wk, Wk[-2], Wk[-1], k)
            Hp = hessian(
                lambda v: torch.sum(sdef * defect(Wk, v[:w], v[w:], k))
            )(torch.cat([Wk[-2], Wk[-1]]))
            return Hp[:w, :w], Hp[w:, w:], Hp[:w, w:]

        Haa, Hbb, Hab = vmap(pair_curv)(Wn, self.ks_step, lam_def)
        return self._gn_coupling(A, Bj, rho, Haa, Hbb, Hab)

    @staticmethod
    def _gn_coupling(A, Bj, rho, Haa=0.0, Hbb=0.0, Hab=0.0):
        """rho AᵀA (+Haa) lands on D_k, rho BᵀB (+Hbb) on D_{k+1},
        rho AᵀB (+Hab) is O_k."""
        first = rho * torch.einsum("kij,kil->kjl", A, A) + Haa
        second = rho * torch.einsum("kij,kil->kjl", Bj, Bj) + Hbb
        Dc = (tnf.pad(first, (0, 0, 0, 0, 0, 1))
              + tnf.pad(second, (0, 0, 0, 0, 1, 0)))
        return Dc, rho * torch.einsum("kij,kil->kjl", A, Bj) + Hab

    def _sep_coupling(self, data, cscale, Z, lam_def, rho):
        """Step coupling for the separable schemes (euler, trapezoidal):
        the defect of step k reads f(z_k) and f(z_{k+1}) separately, so
        one dynamics Jacobian per node serves both adjacent steps, and
        the curvature of (λ+ρc)·c is one w-dim Hessian per node, weighted
        by both adjacent steps, with a zero cross-node quadrant. Same
        returns as :meth:`_pair_coupling`."""
        nlp, w = self.nlp, self.w
        nx = nlp.dims.nx
        dt, cs = data.dt, cscale

        def fnode(zn, k):
            x, u, _ = nlp._split(zn)
            return nlp.dynamics(x, u, k.to(zn.dtype) * dt, data)

        fvals = vmap(fnode)(Z, self.ks_node)
        Jn = vmap(lambda zn, k: _jacfwd(lambda v: fnode(v, k))(zn))(
            Z, self.ks_node)                              # [K, nx, w]
        Js = Jn / cs[None, :, None]
        Ecs = tnf.pad(torch.eye(nx, dtype=Z.dtype, device=Z.device),
                      (0, w - nx)) / cs[:, None]
        X0 = Z[:, :nx]
        if nlp.scheme == "euler":
            # c = x1 - x0 - dt f(z1): A constant, curvature b-only
            A = (-Ecs).expand(self.K - 1, nx, w)
            Bj = Ecs - dt * Js[1:]
            cdef = X0[1:] - X0[:-1] - dt * fvals[1:]
            coef = -dt
        else:  # trapezoidal: c = x1 - x0 - dt/2 (f(z0) + f(z1))
            A = -Ecs - (0.5 * dt) * Js[:-1]
            Bj = Ecs - (0.5 * dt) * Js[1:]
            cdef = X0[1:] - X0[:-1] - (0.5 * dt) * (fvals[:-1] + fvals[1:])
            coef = -0.5 * dt
        Dc, O = self._gn_coupling(A, Bj, rho)
        if self.cfg.hessian == "gn":
            return Dc, O
        s_eff = (lam_def + rho * (cdef / cs)) / cs         # [K-1, nx]
        wn = tnf.pad(s_eff, (0, 0, 1, 0))
        if nlp.scheme == "trapezoidal":
            wn = wn + tnf.pad(s_eff, (0, 0, 0, 1))
        Hn = coef * vmap(
            lambda zn, k, wk: hessian(
                lambda v: torch.sum(wk * fnode(v, k)))(zn)
        )(Z, self.ks_node, wn)                            # [K, w, w]
        return Dc + Hn, O

    def proj_grad_norm(self, Z, grad_):
        """Scaled projected-gradient inf-norm per lane."""
        s = self.scale
        pg = (Z - torch.clamp(Z - s * grad_, self.lb, self.ub)) / s
        return torch.amax(torch.abs(pg), dim=(1, 2))

    def direction(self, Z, grad_, lam_def, lam_eq, mu, rho, lm, g):
        """Damped projected-Newton direction from a precomputed AL
        gradient; returns (p [B,K,w], bad [B])."""
        p, bad, _, _, _ = self.direction_ext(
            Z, grad_, lam_def, lam_eq, mu, rho, lm, g
        )
        return p, bad

    def direction_ext(self, Z, grad_, lam_def, lam_eq, mu, rho, lm, g):
        """:meth:`direction` + the assembled (D, O) blocks and the free
        mask."""
        at_lb = Z <= self.lb + 1e-9
        at_ub = Z >= self.ub - 1e-9
        free = ~(
            self.pinned | (at_lb & (grad_ > 0.0)) | (at_ub & (grad_ < 0.0))
        )
        D, O = self.gn_blocks(Z, lam_def, lam_eq, mu, rho, free, lm, g)
        _stamp(self, 1)
        p, bad = self.direction_from_blocks(D, O, free, grad_, rho, lm)
        return p, bad, D, O, free

    def direction_from_blocks(self, D, O, free, grad_, rho, lm):
        """Solve the KKT system against assembled blocks: H~ p~ = -S g,
        p = S p~; a lane whose factor failed (NaN) or whose direction is
        uphill takes a damped scaled-gradient step instead."""
        s = self.scale
        rhs = torch.where(free, -(s * grad_), torch.zeros_like(grad_))
        D, O, rhs = D.contiguous(), O.contiguous(), rhs.contiguous()
        if self.kkt_solve is not None:
            # a supplied solver (the horizon-sharded SPIKE solve), with
            # one refinement pass, as the other routes have
            pt = self.kkt_solve(D, O, rhs)
            pt = pt + self.kkt_solve(D, O, rhs - btridiag.matvec(D, O, pt))
        elif self.kkt == "kernel":
            pt = bt_cuda.solve(D, O, rhs)
        elif self.kkt == "cr":
            pt = cyclic_reduction.solve_refined(D, O, rhs)
        else:
            pt = btridiag.solve_refined(D, O, rhs)
        p = torch.where(free, s * pt, torch.zeros_like(pt))
        bad = ~torch.isfinite(p).all(dim=(1, 2)) | (
            torch.sum(p * grad_, dim=(1, 2)) >= 0.0
        )
        step = s * rhs / ((1.0 + rho) * (1.0 + lm))[:, None, None]
        p = _sel(bad, step, p)
        _stamp(self, 2)
        return p, bad

    def chord_direction(self, Dst, Ost, free_st, dmp_st, grad_, rho, lm):
        """Direction from STORED blocks with the damping diagonal
        re-centred on the current (rho, lm): D_eff = Dst + (dmp_now -
        dmp_st) I, exact for the damping term; what else is stale (moved
        Z, updated multipliers, grown rho inside the blocks) the Armijo
        line search absorbs."""
        dmp_now = (self.cfg.reg + lm) * (1.0 + rho)
        eye = torch.eye(self.w, dtype=self.dtype, device=Dst.device)
        D_eff = Dst + (dmp_now - dmp_st)[:, None, None, None] * eye
        return self.direction_from_blocks(
            D_eff, Ost, free_st, grad_, rho, lm)

    def newton_step(self, Z, lam_def, lam_eq, mu, rho, lm=None):
        """One damped projected-Newton iteration per lane, eagerly, with
        the JAX package's sequential projected Armijo backtracking (up to
        ``cfg.ls_backtracks`` halvings) and its count-rule Levenberg
        update; returns (Znew, lm_next, diagnostics), lane axis first.

        A lane stops backtracking at its first passing step and keeps it,
        as each lane of the JAX package's vmapped ``while_loop`` does; the
        loop runs while any lane still searches. The direction is
        :meth:`direction`, so under ``kkt_solver="kernel"`` a CUDA batch
        launches the kernel once."""
        cfg = self.cfg
        B = Z.shape[0]
        if lm is None:
            lm = Z.new_full((B,), cfg.lm0)
        grad_ = self.al_grad(Z, lam_def, lam_eq, mu, rho)
        g = self.residuals(Z)[2]
        p, bad = self.direction(Z, grad_, lam_def, lam_eq, mu, rho, lm, g)
        at_lb = Z <= self.lb + 1e-9
        at_ub = Z >= self.ub - 1e-9
        free = ~(
            self.pinned | (at_lb & (grad_ > 0.0)) | (at_ub & (grad_ < 0.0))
        )

        val0 = self.al_value(Z, lam_def, lam_eq, mu, rho)
        tries = torch.zeros_like(val0)
        ls_ok = torch.zeros_like(bad)
        Zc, val_new = Z, val0
        for j in range(cfg.ls_backtracks):
            searching = ~ls_ok
            if not bool(searching.any()):
                break
            Zj = torch.clamp(Z + 0.5**j * p, self.lb, self.ub)
            val = self.al_value(Zj, lam_def, lam_eq, mu, rho)
            dec = torch.sum(grad_ * (Zj - Z), dim=(1, 2))
            ok = ((val <= val0 + cfg.ls_c1 * dec) & torch.isfinite(val)
                  & (dec < 0.0))
            Zc = _sel(searching, Zj, Zc)
            val_new = torch.where(searching, val, val_new)
            tries = torch.where(searching, tries + 1.0, tries)
            ls_ok = ls_ok | (searching & ok)
        Znew = _sel(ls_ok, Zc, Z)
        lm_next = _lm_update(cfg, lm, ~ls_ok | bad, tries <= 1.0,
                             tries > 3.0, cap_growth=False)
        diag = dict(
            grad=grad_, free=free, p=p, bad=bad, ls_ok=ls_ok,
            ls_steps=tries, val0=val0, val_new=val_new, lm=lm,
        )
        return Znew, lm_next, diag


_STATE = (
    "Z", "cd", "ce", "g", "cost", "lam_def", "lam_eq", "mu", "rho",
    "omega", "lm", "viol_prev", "C", "Q", "viol_ref", "noprog", "in_it",
    "o_it", "tot", "done", "pgn",
)
# the stored KKT blocks of the chord steps (state only when
# cfg.chord_steps > 0): D, O, the free mask and the damping they hold
_CHORD_STATE = ("Dst", "Ost", "free_st", "dmp_st")
#: a trip's phases, in order, as a traced capture stamps them on the card:
#: the AL gradient and value with the stop tests, the Hessian blocks
#: (``gn_blocks``; none in a chord step), the KKT solve and the
#: direction, the line search's candidates and pick, the updates (the
#: multipliers, the penalty, the freeze of inactive lanes, the flag)
PHASES = ("gradient", "assembly", "kkt", "line_search", "update")


def _stamp(F: "_ALFuncs", phase: int) -> None:
    """Close ``phase`` (an index of :data:`PHASES`; -1 opens a trip) on
    a traced trip's card clock; nothing elsewhere."""
    if F.stamp is not None:
        F.stamp(phase)


def _ls_stamp(F: "_ALFuncs", phase: int) -> None:
    """Open (-1) or close (0) the line search on a device loop's card
    clock; nothing elsewhere."""
    if F.ls_stamp is not None:
        F.ls_stamp(phase)


def _body(F: _ALFuncs, cfg: SolverConfig, st: dict, exps,
          reuse: bool = False) -> dict:
    """One flattened AL-SQP iteration for every lane (the JAX package's
    ``body_diag``). ``exps`` [n] are the line search's exponents.
    ``reuse`` makes it a chord step: the direction comes from the stored
    blocks in ``st`` with a fresh gradient, and nothing is assembled; the
    line search and its variants are the same."""
    Z, cd, ce, g, cost = st["Z"], st["cd"], st["ce"], st["g"], st["cost"]
    lam_def, lam_eq, mu, rho = (st["lam_def"], st["lam_eq"], st["mu"],
                                st["rho"])
    omega, lm, viol_prev, viol_ref = (st["omega"], st["lm"],
                                      st["viol_prev"], st["viol_ref"])
    C, Q = st["C"], st["Q"]
    noprog, in_it, o_it, done = (st["noprog"], st["in_it"], st["o_it"],
                                 st["done"])
    B = Z.shape[0]
    lanes = torch.arange(B, device=Z.device)

    # ---- gradient/value at the current (Z, multiplier) pair
    grad_ = F.al_grad(Z, lam_def, lam_eq, mu, rho)
    val = F.al_from_parts(cost, cd, ce, g, lam_def, lam_eq, mu, rho)
    # the nonmonotone reference value (Zhang-Hager); an inf C is
    # re-initialised from the current value (a round has just started)
    if cfg.ls_eta > 0.0:
        C = torch.where(torch.isfinite(C), C, val)
        ref = C
    else:
        ref = val
    pgn = F.proj_grad_norm(Z, grad_)
    stat_floor = torch.clamp(cfg.stat_eps * rho, min=cfg.tol_stat)
    tol_inner = torch.maximum(stat_floor, omega)
    stalled = noprog >= 2
    inner_done = (pgn <= tol_inner) | stalled | (in_it >= cfg.max_inner)

    viol = torch.maximum(_amax0(torch.abs(cd)), _amax0(torch.abs(ce)))
    viol = torch.maximum(viol, _amax0(torch.clamp(g, min=0.0)))
    # violation-stagnation round exit
    if cfg.round_viol_patience > 0:
        pat = cfg.round_viol_patience
        check = (in_it >= pat) & (in_it % pat == 0)
        inner_done = inner_done | (
            check & (viol > cfg.round_viol_factor * viol_ref)
        )
        viol_ref = torch.where(check, viol, viol_ref)
    # KKT test at the current multipliers
    done_now = inner_done & (viol <= cfg.tol_cons) & (
        (pgn <= stat_floor) | (stalled & (pgn <= 100.0 * stat_floor))
    )
    done_prev = done
    done = done | done_now
    _stamp(F, 0)

    # ---- Newton step for lanes still inside an inner round
    chord = {k: st[k] for k in _CHORD_STATE if k in st}
    if reuse:
        p, bad_dir = F.chord_direction(
            st["Dst"], st["Ost"], st["free_st"], st["dmp_st"], grad_, rho,
            lm)
    elif cfg.chord_steps:
        p, bad_dir, Dst, Ost, free_st = F.direction_ext(
            Z, grad_, lam_def, lam_eq, mu, rho, lm, g)
        chord = dict(Dst=Dst, Ost=Ost, free_st=free_st,
                     dmp_st=(cfg.reg + lm) * (1.0 + rho))
    else:
        p, bad_dir = F.direction(Z, grad_, lam_def, lam_eq, mu, rho, lm, g)

    # parallel Armijo line search over the alpha grid, one batched
    # residual pass for all candidates
    _ls_stamp(F, -1)
    alphas = 0.5**exps
    if F.line_search == "kernel":
        # one launch for every candidate of every lane; the user's cost
        # over the candidates it writes
        Zc, partc, decc = F.ls_kernel(Z, p, grad_, alphas, lam_def, mu,
                                      rho)
        costc = F.candidate_cost(Zc)
        valc = costc + partc
    else:
        Zc = torch.clamp(
            Z[:, None] + alphas[None, :, None, None] * p[:, None],
            F.lb[:, None], F.ub[:, None],
        )                                                 # [B, n, K, w]
        (cdc, cec, gc), costc = F.candidate_residuals(Zc)
        valc = F.al_from_parts(
            costc, cdc, cec, gc, lam_def[:, None], lam_eq[:, None],
            mu[:, None], rho[:, None],
        )
        decc = torch.sum(grad_[:, None] * (Zc - Z[:, None]), dim=(2, 3))
    okc = (
        (valc <= ref[:, None] + cfg.ls_c1 * decc)
        & torch.isfinite(valc)
        & (decc < 0.0)
    )
    if cfg.ls_rule == "best":
        # the lowest AL value among the passing candidates (the first of
        # equal ones; candidate 0 when none passes)
        sel = torch.argmin(
            torch.where(okc, valc, torch.full_like(valc, float("inf"))),
            dim=1)
    else:
        sel = torch.argmax(okc.to(torch.int32), dim=1)  # first passing
    ls_ok = okc.any(dim=1)
    # the equivalent sequential-backtrack count (the count rule's signal)
    exp_sel = exps[sel]
    nsteps_ls = exp_sel + 1.0

    move = (~inner_done) & (~done) & ls_ok
    if F.line_search == "kernel":
        # the chosen step's point, defects and rows from a second launch;
        # no user equality rows on this route
        Zs, cd_s, g_s = F.ls_kernel(Z, p, grad_, alphas, lam_def, mu, rho,
                                    sel)
        Znew = _sel(move, Zs, Z)
        cd_n = _sel(move, cd_s, cd)
        ce_n = ce
        g_n = _sel(move, g_s, g)
    else:
        Znew = _sel(move, Zc[lanes, sel], Z)
        cd_n = _sel(move, cdc[lanes, sel], cd)
        ce_n = _sel(move, cec[lanes, sel], ce)
        g_n = _sel(move, gc[lanes, sel], g)
    cost_n = torch.where(move, costc[lanes, sel], cost)
    val_new = torch.where(move, valc[lanes, sel], val)
    _ls_stamp(F, 0)
    _stamp(F, 3)

    # Levenberg adaptation: full steps trust the model more, backtracked
    # or failed steps damp harder
    stepping = (~inner_done) & (~done)
    fail = ~ls_ok | bad_dir
    if cfg.lm_rule == "ratio":
        # trust-region style: actual vs predicted decrease along the step
        # (the first-order term decc stands in)
        pred = torch.clamp(-0.5 * decc[lanes, sel], min=1e-12)
        ratio = (val - val_new) / pred
        lm_step = _lm_update(cfg, lm, fail, ratio > 0.75, ratio < 0.25,
                             cap_growth=True)
    else:
        lm_step = _lm_update(cfg, lm, fail, nsteps_ls <= 1.0,
                             nsteps_ls > 3.0, cap_growth=False)
    lm = torch.where(stepping, lm_step, lm)
    # the nonmonotone reference update (Zhang-Hager averaging)
    if cfg.ls_eta > 0.0:
        Qn = cfg.ls_eta * Q + 1.0
        Cn = (cfg.ls_eta * Q * C + val_new) / Qn
        C = torch.where(stepping, Cn, C)
        Q = torch.where(stepping, Qn, Q)
    improved = (ref - val_new) > cfg.stall_tol * (1.0 + torch.abs(ref))
    if cfg.ls_deep_round > 0:
        # a deep accepted step reads as stall evidence
        improved = improved & (exp_sel < cfg.ls_deep_round)
    noprog = torch.where(
        stepping,
        torch.where(improved, torch.zeros_like(noprog), noprog + 1),
        noprog,
    )
    in_it = torch.where(stepping, in_it + 1, in_it)

    # ---- outer (AL round) transition on inner_done lanes
    u = inner_done & (~done_prev)
    drho = (cfg.dual_relax * rho)[:, None, None]
    lam_def = _sel(u, lam_def + drho * cd, lam_def)
    lam_eq = _sel(u, lam_eq + drho * ce, lam_eq)
    mu = _sel(u, torch.clamp(mu + drho * g, min=0.0), mu)
    # grow the penalty only while actually infeasible
    grow = u & (viol > cfg.viol_decrease * viol_prev) & (viol > cfg.tol_cons)
    rho_new = torch.where(
        grow, torch.clamp(rho * cfg.rho_growth, max=cfg.rho_max), rho
    )
    # LANCELOT omega-schedule
    omega = torch.where(
        u,
        torch.where(grow, cfg.inner_tol0 / rho_new,
                    torch.clamp(omega * 0.2, min=cfg.tol_stat)),
        omega,
    )
    rho = rho_new
    lm = torch.where(u, torch.clamp(lm * 0.1, min=cfg.lm0), lm)
    viol_prev = torch.where(u, viol, viol_prev)
    o_it = o_it + u.to(o_it.dtype)
    in_it = torch.where(u, torch.zeros_like(in_it), in_it)
    noprog = torch.where(u, torch.zeros_like(noprog), noprog)
    # a new round: the multiplier update moved the AL surface, so the
    # nonmonotone reference starts again
    C = torch.where(u, torch.full_like(C, float("inf")), C)
    Q = torch.where(u, torch.ones_like(Q), Q)
    viol_ref = torch.where(u, viol, viol_ref)
    _stamp(F, 4)

    return dict(
        Z=Znew, cd=cd_n, ce=ce_n, g=g_n, cost=cost_n, lam_def=lam_def,
        lam_eq=lam_eq, mu=mu, rho=rho, omega=omega, lm=lm,
        viol_prev=viol_prev, C=C, Q=Q, viol_ref=viol_ref, noprog=noprog,
        in_it=in_it, o_it=o_it, tot=st["tot"] + 1, done=done, pgn=pgn,
        **chord,
    )


def _lm_update(cfg: SolverConfig, lm, fail, good, poor, cap_growth):
    """The Levenberg damping after a step: x10 (capped at lm_max) where
    the line search or the direction failed, x0.33 (floored at lm_min) on
    a ``good`` step, x3 on a ``poor`` one. The ratio rule caps the x3
    (``cap_growth``) and the count rule does not, as in the JAX
    package."""
    grow = lm * 3.0
    if cap_growth:
        grow = torch.clamp(grow, max=cfg.lm_max)
    return torch.where(
        fail, torch.clamp(lm * 10.0, max=cfg.lm_max),
        torch.where(good, torch.clamp(lm * 0.33, min=cfg.lm_min),
                    torch.where(poor, grow, lm)))


def _exponents(cfg: SolverConfig, dtype, device):
    """The line search's exponents: an explicit grid, or the first
    ls_grid. Made from Python data, so a captured program makes them
    once, outside its graph, as a buffer of its key."""
    return torch.tensor(
        tuple(cfg.ls_exponents) or _LS_EXPONENTS[
            : max(min(cfg.ls_grid, len(_LS_EXPONENTS)), 1)],
        dtype=dtype, device=device)


def _start(F: _ALFuncs, cfg: SolverConfig, z0, lam0, rho_init=None):
    """The loop's first state (a dict of [B, ...] tensors, the keys of
    ``_STATE``, and of ``_CHORD_STATE`` under ``cfg.chord_steps``) for
    the batch ``F`` holds. It reads nothing on the host."""
    B = F.lb.shape[0]
    dtype, dev = F.dtype, F.lb.device
    lam_def0, lam_eq0, mu0 = lam0
    Z0 = torch.clamp(z0.reshape(B, F.K, F.w), F.lb, F.ub)

    cd0, ce0, g0 = F.residuals(Z0)

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    rho0 = (full(cfg.rho0) if rho_init is None
            else torch.as_tensor(rho_init, dtype=dtype, device=dev)
            .expand(B).clone())
    inf = float("inf")
    st = dict(
        Z=Z0, cd=cd0, ce=ce0, g=g0, cost=F.cost(Z0), lam_def=lam_def0,
        lam_eq=lam_eq0, mu=mu0, rho=rho0, omega=full(cfg.inner_tol0),
        lm=full(cfg.lm0), viol_prev=full(inf), C=full(inf), Q=full(1.0),
        viol_ref=full(inf),
        noprog=full(0, torch.int32), in_it=full(0, torch.int32),
        o_it=full(0, torch.int32), tot=full(0, torch.int32),
        done=full(False, torch.bool), pgn=full(inf),
    )
    if cfg.chord_steps:
        st.update(
            Dst=Z0.new_zeros((B, F.K, F.w, F.w)),
            Ost=Z0.new_zeros((B, F.K - 1, F.w, F.w)),
            free_st=torch.zeros((B, F.K, F.w), dtype=torch.bool,
                                device=dev),
            dmp_st=full(0.0),
        )
    return st


def _active(cfg: SolverConfig, st: dict, max_total, agree=None):
    """The [B] mask of lanes whose own loop condition holds; ``max_total``
    an int or a 0-dim tensor. ``agree`` maps it to the mask every process
    of a group runs."""
    active = ((~st["done"]) & (st["o_it"] < cfg.max_outer)
              & (st["tot"] < max_total))
    return active if agree is None else agree(active)


def _trip(F: _ALFuncs, cfg: SolverConfig, st: dict, exps, active) -> dict:
    """One trip of the loop: the composite iteration, a full step and
    then the chord steps, with the lanes outside ``active`` frozen. A
    lane's condition is tested once per trip, as the JAX while_loop tests
    it, so the freeze wraps the composite: a lane runs its chord steps
    even where ``tot`` passes ``max_total`` inside one, and each sub-step
    counts in ``tot``."""
    new = _body(F, cfg, st, exps)
    for _ in range(cfg.chord_steps):
        new = _body(F, cfg, new, exps, reuse=True)
    return {k: _sel(active, new[k], st[k]) for k in st}


def _finish(nlp: NLP, data: VGPData, st: dict) -> SolveResult:
    """The result of a finished loop state."""
    cd, ce, g, Z = st["cd"], st["ce"], st["g"], st["Z"]
    B = Z.shape[0]
    viol_eq = torch.maximum(_amax0(torch.abs(cd)), _amax0(torch.abs(ce)))
    viol_in = _amax0(torch.clamp(g, min=0.0))
    z = Z.reshape(B, -1)
    nan = ~torch.isfinite(z).all(dim=1)
    status = torch.where(
        nan, int(Status.DIVERGED),
        torch.where(st["done"], int(Status.SOLVED), int(Status.MAX_ITER)),
    ).to(torch.int32)
    obj = map_lanes(lambda dat, zz: nlp.score(zz, dat), data, z)
    return SolveResult(
        z=z, obj=obj, status=status, outer_iters=st["o_it"],
        inner_iters=st["tot"], viol_eq=viol_eq, viol_in=viol_in,
        grad_norm=st["pgn"], lam_def=st["lam_def"], lam_eq=st["lam_eq"],
        mu=st["mu"], rho=st["rho"],
    )


def _batch_steps(nlp: NLP, cfg: SolverConfig, data: VGPData, z0, lam0,
                 rho_init=None, box=None, kkt_solve=None, max_total=None):
    """The batched solve as steps around its loop: a generator that
    yields ``(F, cfg, st, max_total)`` once, where the loop runs from
    the state ``st``, is sent the loop's final state, and returns the
    :class:`SolveResult`. ``z0`` and ``lam0`` None start cold;
    ``max_total`` (an int or a 0-dim tensor) defaults to the config's
    budget. Between the yields it reads nothing on the host, so a card
    captures each side of the loop (:mod:`.trip_graph`)."""
    if z0 is None:
        z0 = map_lanes(nlp.initial_guess, data)
    if lam0 is None:
        lam0 = init_multipliers(nlp, data)
    if max_total is None:
        max_total = cfg.max_total or cfg.max_outer * cfg.max_inner
    F = _ALFuncs(nlp, cfg, data, box, kkt_solve)
    st = _start(F, cfg, z0, lam0, rho_init)
    st = yield F, cfg, st, max_total
    return _finish(nlp, data, st)


def _single_steps(nlp: NLP, cfg: SolverConfig, data: VGPData, z0, lam0,
                  rho0, max_total):
    """:func:`solve` as steps: ONE problem (``data``, ``z0``, ``lam0``
    and the 0-dim ``rho0`` without a lane axis) run as a batch of one,
    the lane axis added before the loop and taken off after it."""
    def lane(a):
        return a[None]

    res = yield from _batch_steps(
        nlp, cfg, tree_map(lane, data), None if z0 is None else lane(z0),
        None if lam0 is None else tuple(lane(a) for a in lam0),
        None if rho0 is None else rho0.reshape(1), max_total=max_total)
    return tree_map(lambda a: a[0], res)


def _run_steps(steps, at_loop):
    """Drive a generator of steps (:func:`_batch_steps`,
    :func:`_staged_steps`): ``at_loop(F, cfg, st, max_total)`` runs each
    loop it yields and returns the loop's final state. Returns what the
    generator returns."""
    sent = None
    try:
        while True:
            sent = at_loop(*steps.send(sent))
    except StopIteration as stop:
        return stop.value


def _budget(cfg: SolverConfig, device):
    """``cfg`` without its ``max_total`` and the budget as a 0-dim tensor
    on ``device``: a program's buffer, so configs that differ only in
    their budget share its key (:mod:`.trip_graph`)."""
    return (dataclasses.replace(cfg, max_total=0),
            torch.full((), cfg.max_total or cfg.max_outer * cfg.max_inner,
                       dtype=torch.int64, device=device))


def _on_device(a, data: VGPData):
    """``a`` (None, a Python number or a tensor) as a tensor on the data's
    device and in its dtype, made before a program, outside its graph."""
    if a is None:
        return None
    return torch.as_tensor(a, dtype=data.x0.dtype, device=data.x0.device)


def _solve_batch(nlp: NLP, cfg: SolverConfig, data: VGPData, z0, lam0,
                 rho_init=None, box=None, kkt_solve=None,
                 agree=None) -> SolveResult:
    """The flattened AL-SQP over a batch; ``z0`` [B, nz], ``lam0`` a
    (lam_def, lam_eq, mu) triple with lane axes (each None for a cold
    start), ``rho_init`` [B],
    ``box`` an optional (lo, hi) pair of [B, K, w] bounds intersected with
    the NLP's (``z0`` is clamped into the intersection), ``kkt_solve`` a
    KKT solver ``f(D [B,K,w,w], O [B,K-1,w,w], r [B,K,w]) -> x`` in place
    of the configured route, and ``agree`` a map of the [B] mask of lanes
    still running to the mask every process of a group runs (where the
    KKT solve is a collective, all of them must take the same trips).

    On a card the whole solve is one :func:`.trip_graph.program` (the
    prologue, the loop's while node with its stop test on the card, the
    result), as the JAX package jits its ``solve_batched`` whole; on the
    CPU, and for a collective ``agree``, the steps run eagerly around the
    eager loop with one host sync a trip."""
    from . import trip_graph

    cfg, budget = _budget(cfg, data.x0.device)
    return trip_graph.run(_batch_steps, (nlp, cfg), data, z0, lam0,
                          _on_device(rho_init, data), box, kkt_solve, budget,
                          agree=agree)


def init_multipliers(nlp: NLP, data: VGPData):
    """Zero multipliers of the right shapes for a batch (cold start)."""
    d = nlp.dims
    m_eq, m_in = _result_sizes(nlp, data)
    B = data.x0.shape[0]
    z = data.x0.new_zeros
    return (z((B, d.nsteps, d.nx)), z((B, d.nodes, m_eq)),
            z((B, d.nodes, m_in)))


def solve(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    z0: Optional[torch.Tensor] = None,
    lam0=None,
    rho0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve ONE problem: ``data`` without a lane axis, the result
    without one. ``z0`` [nz], ``lam0`` and ``rho0`` (a scalar) warm-start
    it (the MPC re-solve: pass the previous result's z, multipliers and
    penalty).

    Inside, it is a batch of one, on the same KKT route as a batch:
    under ``kkt_solver="kernel"`` every Newton iteration is one launch
    of the kernel at B=1 (float32, node width up to 9; else cyclic
    reduction), and ``"cr"`` selects cyclic reduction, the JAX package's
    route for its unbatched solve, by name.

    On a card the solve is one :func:`.trip_graph.program`, the lane axis
    added and taken off inside it: an MPC tick is one copy in, one graph
    launch and one copy out. ``rho0`` (a number or a tensor) is brought
    to the data's device first, outside the program."""
    from . import trip_graph

    cfg, budget = _budget(cfg, data.x0.device)
    return trip_graph.run(_single_steps, (nlp, cfg), data, z0,
                          None if lam0 is None else tuple(lam0),
                          _on_device(rho0, data), budget)


def solve_batched(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    z0: Optional[torch.Tensor] = None,
    lam0=None,
    rho0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve a batch: every tensor of ``data`` has a leading lane axis.
    ``z0`` [B, nz], ``lam0`` (each [B, ...]) and ``rho0`` [B] warm-start
    the whole fleet. On a card one graph launch a call
    (:func:`_solve_batch`)."""
    return _solve_batch(nlp, cfg, data, z0, lam0, rho0)


def draw_deltas(n_starts: int, nx: int, spread: float,
                generator: torch.Generator, device, dtype,
                lanes: Optional[int] = None):
    """The random part of :func:`solve_multistart`: state bumps uniform
    in ±``spread`` as fractions of the state range, [n_starts, nx] (with
    ``lanes``: [lanes, n_starts, nx], draws of its own for each lane).
    Drawn on the generator's own device and handed to ``device``. The
    draws do not reproduce ``jax.random``'s."""
    shape = (n_starts, nx) if lanes is None else (lanes, n_starts, nx)
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype).to(device)
    return spread * (2.0 * u - 1.0)


def multistart_guesses(nlp: NLP, data: VGPData, deltas, z_shoot=None):
    """The deterministic part: the guesses [n_starts, nz] of ONE problem
    from ``deltas`` [n_starts, nx] (fractions of the state range). Start
    0 is the nominal guess; the others add a smooth half-sine state bump
    that is zero at both ends, so x0 and xf are respected; ``z_shoot``
    [nz] (a shooting seed) takes index ``1 % n_starts``."""
    d = nlp.dims
    K = d.nodes
    n = deltas.shape[0]
    base = nlp.initial_guess(data).reshape(K, d.node_width)
    window = torch.sin(
        torch.pi * torch.arange(K, device=base.device).to(base.dtype)
        / (K - 1))
    first = torch.arange(n, device=base.device) == 0
    deltas = torch.where(first[:, None], torch.zeros_like(deltas),
                         deltas * (data.x_ub - data.x_lb))
    bump = window[None, :, None] * deltas[:, None, :]        # [n, K, nx]
    z0s = (base[None] + tnf.pad(bump, (0, d.node_width - d.nx))).reshape(
        n, -1)
    if z_shoot is not None:
        at = torch.arange(n, device=base.device) == 1 % n
        z0s = torch.where(at[:, None], z_shoot, z0s)
    return z0s


def select_best(res: SolveResult, cfg: SolverConfig, maximize: bool):
    """Index of the best start along the LAST axis of ``res``'s scalar
    fields: the lowest ``sign·obj`` among the feasible ones (violations
    within 10 tol_cons); infeasible starts rank 1e9 behind, a non-finite
    objective last; ties go to the first."""
    feas = (res.viol_eq <= 10.0 * cfg.tol_cons) & (
        res.viol_in <= 10.0 * cfg.tol_cons)
    sign = -1.0 if maximize else 1.0
    score = torch.where(torch.isfinite(res.obj), sign * res.obj,
                        torch.full_like(res.obj, float("inf")))
    score = score + torch.where(feas, 0.0, 1e9).to(score.dtype)
    return torch.argmin(score, dim=-1)


def _multistart_steps(nlp: NLP, cfg: SolverConfig, data: VGPData, deltas,
                      units, per_lane: bool, max_total):
    """:func:`solve_multistart` for M problems at once, as steps
    (:func:`_run_steps`): ``data`` with a lane axis, ``deltas`` [M, n,
    nx], ``units`` the shooting seeds' unit draws
    (:func:`.shooting.draw_units`; ``per_lane``: each lane's own) or None
    for no seed. The M·n starts are ONE flat batch, and every lane keeps
    its best start."""
    M, n = deltas.shape[:2]
    if units is None:
        z0s = map_lanes(
            lambda d, dl: multistart_guesses(nlp, d, dl), data, deltas)
    else:
        z_shoot = shooting.guess_from_units(nlp, data, units, per_lane)
        z0s = map_lanes(
            lambda d, dl, zs: multistart_guesses(nlp, d, dl, zs),
            data, deltas, z_shoot)

    def flat(a):  # lane-major: starts of one lane are neighbours
        return a[:, None].expand((M, n) + tuple(a.shape[1:])).reshape(
            (M * n,) + tuple(a.shape[1:]))

    res = yield from _batch_steps(nlp, cfg, tree_map(flat, data),
                                  z0s.reshape(M * n, -1), None,
                                  max_total=max_total)
    res = tree_map(lambda a: a.reshape((M, n) + tuple(a.shape[1:])), res)
    best = select_best(res, cfg, nlp.maximize)
    lanes = torch.arange(M, device=best.device)
    return tree_map(lambda a: a[lanes, best], res)


def solve_multistart(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    n_starts: int = 8,
    generator: Optional[torch.Generator] = None,
    spread: float = 0.4,
    shooting_samples: int = 0,
    deltas: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve ONE problem (``data`` without a lane axis) from ``n_starts``
    initial guesses at once and keep the best feasible result.

    The batch axis is the global search that stands in for the MILP
    backends' branch-and-bound: nonconvex obstacle fields have several
    basins (pass above or below), and AL from an infeasible guess is
    knife-edge sensitive to which basin it drains into. Guesses: the
    nominal one, smooth half-sine state bumps, and (``shooting_samples >
    0``) the best collision-free randomized rollout
    (:mod:`.shooting`). The starts are one flat batch.

    The bumps come from ``generator`` through :func:`draw_deltas`, then
    the shooting units (:func:`.shooting.draw_units`), both drawn before
    the solve. With no generator the draws are made on the host from seed
    0, so the starts are the same on every device. Which starts converge
    is luck of the draw on a field like ``mip_2d_ex1.xml`` (about one
    start in five does). ``deltas`` [n_starts, nx] hands the bumps in
    instead (a test gives both packages the same ones).

    On a card the rest is one :func:`.trip_graph.program`, as the JAX
    package jits ``solve_multistart`` whole: the guesses, the seed's
    rollouts, the flat batch's solve and the pick of the best start."""
    from . import trip_graph

    dev, dtype = data.x0.device, data.x0.dtype
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with profiling.span("solve.draws", device=str(generator.device)) as sp:
        if deltas is None:
            deltas = draw_deltas(n_starts, nlp.dims.nx, spread, generator,
                                 dev, dtype)
        units = None
        if shooting_samples > 0:
            units = shooting.draw_units(shooting_samples, nlp.dims.nsteps,
                                        data.u_lb.shape[-1], 0, 8,
                                        generator, dev, dtype)
        sp.set(**profiling.sizes(deltas, units))
    cfg, budget = _budget(cfg, dev)
    res = trip_graph.run(_multistart_steps, (nlp, cfg),
                         tree_map(lambda a: a[None], data),
                         deltas.to(dev)[None], units, False, budget)
    return tree_map(lambda a: a[0], res)


def rescue_merge(res1: SolveResult, res2: SolveResult, idx) -> SolveResult:
    """Scatter the rescue results ``res2`` (of lanes ``idx`` of ``res1``)
    back where they are strictly better: solved where phase 1 was not,
    or, both unsolved, a lower violation."""
    ok1 = (res1.status == int(Status.SOLVED))[idx]
    ok2 = res2.status == int(Status.SOLVED)
    v1 = torch.maximum(res1.viol_eq[idx], res1.viol_in[idx])
    v2 = torch.maximum(res2.viol_eq, res2.viol_in)
    better = (ok2 & ~ok1) | (~ok2 & ~ok1 & (v2 < v1))
    return tree_map(
        lambda a, b: a.index_copy(0, idx, _sel(better, b, a[idx])),
        res1, res2)


def _rescue_steps(nlp: NLP, cfg: SolverConfig, rescue_cfg: SolverConfig,
                  data: VGPData, z0, lam0, rho0, deltas, units, max_total,
                  rescue_total):
    """:func:`solve_batched_rescue` as steps: phase 1 over the batch
    under ``max_total``, then the M = ``deltas.shape[0]`` worst lanes
    (unconverged first, stable order) gathered and solved cold from
    ``deltas`` [M, n, nx] and the per-lane seeds of ``units`` under
    ``rescue_cfg`` and ``rescue_total``, one flat batch, and merged back
    where better. It reads nothing on the host: M is static, and phase 2
    runs whatever phase 1 left, as in the JAX package's one jit."""
    res1 = yield from _batch_steps(nlp, cfg, data, z0, lam0, rho0,
                                   max_total=max_total)
    ok = res1.status == int(Status.SOLVED)
    idx = torch.argsort(ok.to(torch.int32), stable=True)[:deltas.shape[0]]
    res2 = yield from _multistart_steps(
        nlp, rescue_cfg, tree_map(lambda a: a[idx], data), deltas, units,
        True, rescue_total)
    return rescue_merge(res1, res2, idx)


def solve_batched_rescue(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    generator: Optional[torch.Generator] = None,
    rescue_lanes: int = 0,
    n_rescue_starts: int = 4,
    rescue_cfg: Optional[SolverConfig] = None,
    z0: Optional[torch.Tensor] = None,
    shooting_samples: int = 256,
    lam0=None,
    rho0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Two-phase batched solve: main phase + compacted rescue.

    Phase 1 runs the whole batch under ``cfg`` (use a tight
    ``cfg.max_total``); the ``rescue_lanes`` (default B // 8) worst
    lanes, unconverged first in stable order, are gathered into a small
    batch and re-solved cold with ``n_rescue_starts``-way multistart and
    shooting seeds under ``rescue_cfg``: ONE flat batch of
    ``rescue_lanes · n_rescue_starts`` lanes. Improved results scatter
    back (:func:`rescue_merge`); lanes beyond ``rescue_lanes`` that also
    failed keep their phase-1 status (an honest MAX_ITER). Use
    :func:`solve_batched_staged` when failures are budget problems, this
    when they are basin problems.

    Phase 2 always runs, as in the JAX package: when every lane of phase
    1 is SOLVED no rescue result is adopted, so the result is phase 1's.

    Draws, in order, from ``generator`` (made on the host from seed 0
    when none is given), before the solve and on every call, also when
    phase 1 solves every lane: the bumps [M, n_rescue_starts, nx], then
    the shooting units with a lane axis (every rescued lane has draws of
    its own). On a card the rest is one :func:`.trip_graph.program`, as
    the JAX package jits the rescue whole: phase 1, the gather, the
    guesses and seeds, the flat batch's solve, the pick and the merge."""
    from . import trip_graph

    B = data.x0.shape[0]
    M = min(rescue_lanes or max(1, B // 8), B)
    dev, dtype = data.x0.device, data.x0.dtype
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with profiling.span("solve.draws", device=str(generator.device)) as sp:
        deltas = draw_deltas(n_rescue_starts, nlp.dims.nx, 0.4, generator,
                             dev, dtype, lanes=M)
        units = None
        if shooting_samples > 0:
            units = shooting.draw_units(shooting_samples, nlp.dims.nsteps,
                                        data.u_lb.shape[-1], 0, 8,
                                        generator, dev, dtype, lanes=M)
        sp.set(**profiling.sizes(deltas, units))
    rescue_cfg, rescue_total = _budget(rescue_cfg or cfg, dev)
    cfg, budget = _budget(cfg, dev)
    return trip_graph.run(_rescue_steps, (nlp, cfg, rescue_cfg), data, z0,
                          lam0, _on_device(rho0, data), deltas, units,
                          budget, rescue_total)


def _staged_steps(nlp: NLP, cfg: SolverConfig, data: VGPData, z0, stages,
                  lam0, rho0, max_total):
    """The staged solve as steps around its loops (:func:`_run_steps`):
    phase 1 over the whole batch under ``max_total`` (an int or a 0-dim
    tensor), then for each ``(count, budget)`` stage the M = min(count,
    B) worst lanes gathered and continued warm for ``budget``
    iterations, and merged back. Returns the result and the trip counts
    of phase 1 and of each stage (the most iterations any lane ran) as
    0-dim tensors. Between the loops it reads nothing on the host: M is
    static and the gathers and merges are tensor ops, as in the JAX
    package's one jit."""
    res = yield from _batch_steps(nlp, cfg, data, z0, lam0, rho0,
                                  max_total=max_total)
    stage_trips = [res.inner_iters.max()]
    for count, budget in stages:
        B = res.status.shape[0]
        M = min(count, B)
        ok = res.status == int(Status.SOLVED)
        order = torch.argsort(ok.to(torch.int32), stable=True)
        idx = order[:M]
        sub = tree_map(lambda a: a[idx], data)
        cfg_i = dataclasses.replace(cfg, max_total=budget)
        lam_i = (res.lam_def[idx], res.lam_eq[idx], res.mu[idx])
        res_i = yield from _batch_steps(nlp, cfg_i, sub, res.z[idx], lam_i,
                                        res.rho[idx])
        stage_trips.append(res_i.inner_iters.max())
        v_old = torch.maximum(res.viol_eq[idx], res.viol_in[idx])
        v_new = torch.maximum(res_i.viol_eq, res_i.viol_in)
        ok_old = ok[idx]
        ok_new = res_i.status == int(Status.SOLVED)
        better = (ok_new & ~ok_old) | (~ok_old & (v_new < v_old))

        def merge(a, b):
            return a.index_copy(0, idx, _sel(better, b, a[idx]))

        res = tree_map(merge, res, res_i)
    return res, stage_trips


def solve_batched_staged(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    z0: Optional[torch.Tensor] = None,
    stages=((256, 1024), (64, 2048)),
    lam0=None,
    rho0: Optional[torch.Tensor] = None,
    return_stage_trips: bool = False,
):
    """Compacted multi-phase batched solve.

    Phase 1 runs the full batch under ``cfg``; then each ``(count,
    budget)`` stage gathers the ``count`` worst lanes (unconverged first,
    stable order) and CONTINUES them warm (carried z, multipliers and
    penalty) for ``budget`` more iterations. Improved results scatter
    back; lanes that still fail keep an honest MAX_ITER.

    On a card the whole solve is one :func:`.trip_graph.program`, as the
    JAX package's is one jit: one graph launch runs phase 1's
    loop, each stage's gather, loop and merge, with every stop test on
    the card. On the CPU it runs eagerly.

    ``return_stage_trips=True`` additionally returns the tuple of trip
    counts (the most Newton iterations any lane ran) of phase 1 and of
    each stage, read from the device once, at the end.
    """
    from . import trip_graph

    cfg, budget = _budget(cfg, data.x0.device)
    res, stage_trips = trip_graph.run(
        _staged_steps, (nlp, cfg), data, z0,
        tuple(tuple(s) for s in stages), lam0, _on_device(rho0, data),
        budget)
    if return_stage_trips:
        return res, tuple(torch.stack(stage_trips).tolist())
    return res
