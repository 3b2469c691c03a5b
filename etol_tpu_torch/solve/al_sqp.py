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

The loop. A Python ``while`` runs while any lane's own loop condition
holds, and every state tensor is updated as ``torch.where(active, new,
old)``, so a lane stops changing exactly where its own JAX
``while_loop`` would stop (``inner_iters`` and the stage trip counts
depend on this). Testing ``active.any()`` syncs the host once per
iteration.

Precision. Float32 throughout, with reduced-precision matmul modes off:
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
from ..ops import bt_cuda
from ..transcribe.nlp import NLP
from . import btridiag

# step-size grid of the parallel line search: alphas = 0.5**j
_LS_EXPONENTS = tuple(range(24))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs; the defaults and meanings are the JAX package's
    (see ``etol_tpu.solve.al_sqp.SolverConfig`` for the measurements
    behind each). Its knobs that no main-path caller sets to anything
    but the one value ported here are not fields: the Hessian is
    ``hessian="defect"`` (exact dynamics curvature (λ+ρc)·∇²c), the
    Levenberg rule is ``lm_rule="ratio"``, and ``sep_assembly``,
    ``chord_steps``, ``ls_eta``, ``ls_rule``, ``dual_relax``,
    ``ls_deep_round``, ``ls_exponents`` and ``ls_backtracks`` do not
    exist (asking for them is a TypeError)."""

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
    lm0: float = 1e-3           # initial Levenberg damping (relative)
    lm_min: float = 1e-6
    lm_max: float = 30.0
    ls_c1: float = 1e-4
    ls_grid: int = 24           # line-search candidates 0.5**j, j < ls_grid
    max_total: int = 0          # global Newton budget; 0 = outer * inner
    inner_tol0: float = 1e-2    # LANCELOT: inner tol tightens with rho
    stall_tol: float = 1e-7     # relative AL-decrease floor
    kkt_solver: str = "kernel"  # "kernel": ops.bt_cuda (the CUDA kernel
                                # on a card, its plain version on the
                                # CPU); "scan": the plain torch block
                                # Cholesky everywhere
    round_viol_patience: int = 8
    round_viol_factor: float = 0.9

    def __post_init__(self):
        if self.kkt_solver not in ("kernel", "scan"):
            raise ValueError(
                f"kkt_solver must be 'kernel' or 'scan', got "
                f"{self.kkt_solver!r}"
            )


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


def _sel(mask, new, old):
    """torch.where with a [B] lane mask over [B, ...] tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


class _ALFuncs:
    """The solver's building blocks for one batch of problems.

    Every public method takes and returns tensors with the lane axis
    first; the per-lane math (``_*_lane``) is written for one problem and
    mapped over lanes with ``torch.func.vmap``."""

    def __init__(self, nlp: NLP, cfg: SolverConfig, data: VGPData):
        self.nlp, self.cfg, self.data = nlp, cfg, data
        d = nlp.dims
        self.K, self.w = d.nodes, d.node_width
        self.dtype = data.x0.dtype
        dev = data.x0.device
        self.ks_step = torch.arange(d.nsteps, device=dev)
        self.ks_node = torch.arange(self.K, device=dev)
        lb, ub = self._lanes(nlp.bounds)
        B = lb.shape[0]
        self.lb = lb.reshape(B, self.K, self.w)
        self.ub = ub.reshape(B, self.K, self.w)
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
        coordinates: Gauss-Newton + the exact defect curvature (the
        generic node-pair path), active-set masking and Levenberg
        damping. ``g`` carries the inequality residuals at Z."""
        return self._lanes(
            self._gn_blocks_lane, self.scale, self.cscale, self.track_ctrs,
            Z, lam_def, lam_eq, mu, rho, free, lm, g,
        )

    def _gn_blocks_lane(self, data, scale, cscale, tc, Z, lam_def, lam_eq,
                        mu, rho, free, lm, g):
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
                Ge = jacfwd(lambda v: nlp.node_eq(v, k, data))(zn)
                De = De + Ge.T @ Ge
            act = (mu_k + rho * g_k > 0).to(dtype)
            if m_obs:
                x = zn[: d.nx]
                Go = jacfwd(
                    lambda v: nlp.node_ineq_obs(
                        torch.cat([v, x[pd:]]), k, tc_k, data
                    )
                )(x[:pd])  # [m_obs, pd]
                Goa = Go * act[:m_obs, None]
                De = De + tnf.pad(Goa.T @ Go, (0, w - pd, 0, w - pd))
            if nlp.path_ineq:
                Gu = jacfwd(lambda v: nlp.node_ineq_user(v, k, data))(zn)
                De = De + (Gu * act[m_obs:, None]).T @ Gu
            return H + rho * De

        D = vmap(node_blocks)(Z, self.ks_node, mu, lam_eq, tc, g)

        # step coupling: defect Jacobians A_k = dc/dz_k, B_k = dc/dz_{k+1}
        def step_jacs(a, b, k):
            cs = cscale[:, None]
            A = jacfwd(lambda v: nlp.step_defect(v, b, k, data))(a) / cs
            Bk = jacfwd(lambda v: nlp.step_defect(a, v, k, data))(b) / cs
            return A, Bk

        A, Bj = vmap(step_jacs)(Z[:-1], Z[1:], self.ks_step)
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
        first = rho * torch.einsum("kij,kil->kjl", A, A) + Haa
        second = rho * torch.einsum("kij,kil->kjl", Bj, Bj) + Hbb
        D = (D + tnf.pad(first, (0, 0, 0, 0, 0, 1))
             + tnf.pad(second, (0, 0, 0, 0, 1, 0)))
        O = rho * torch.einsum("kij,kil->kjl", A, Bj) + Hab

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
        p, bad = self.direction_from_blocks(D, O, free, grad_, rho, lm)
        return p, bad, D, O, free

    def direction_from_blocks(self, D, O, free, grad_, rho, lm):
        """Solve the KKT system against assembled blocks: H~ p~ = -S g,
        p = S p~; a lane whose factor failed (NaN) or whose direction is
        uphill takes a damped scaled-gradient step instead."""
        s = self.scale
        rhs = torch.where(free, -(s * grad_), torch.zeros_like(grad_))
        D, O, rhs = D.contiguous(), O.contiguous(), rhs.contiguous()
        if self.cfg.kkt_solver == "kernel":
            pt = bt_cuda.solve(D, O, rhs)
        else:
            pt = btridiag.solve_refined(D, O, rhs)
        p = torch.where(free, s * pt, torch.zeros_like(pt))
        bad = ~torch.isfinite(p).all(dim=(1, 2)) | (
            torch.sum(p * grad_, dim=(1, 2)) >= 0.0
        )
        step = s * rhs / ((1.0 + rho) * (1.0 + lm))[:, None, None]
        return _sel(bad, step, p), bad


_STATE = (
    "Z", "cd", "ce", "g", "cost", "lam_def", "lam_eq", "mu", "rho",
    "omega", "lm", "viol_prev", "viol_ref", "noprog", "in_it", "o_it",
    "tot", "done", "pgn",
)


def _body(F: _ALFuncs, cfg: SolverConfig, st: dict, exps) -> dict:
    """One flattened AL-SQP iteration for every lane (the JAX package's
    ``body_diag`` with the main-path options)."""
    Z, cd, ce, g, cost = st["Z"], st["cd"], st["ce"], st["g"], st["cost"]
    lam_def, lam_eq, mu, rho = (st["lam_def"], st["lam_eq"], st["mu"],
                                st["rho"])
    omega, lm, viol_prev, viol_ref = (st["omega"], st["lm"],
                                      st["viol_prev"], st["viol_ref"])
    noprog, in_it, o_it, done = (st["noprog"], st["in_it"], st["o_it"],
                                 st["done"])
    B = Z.shape[0]
    lanes = torch.arange(B, device=Z.device)

    # ---- gradient/value at the current (Z, multiplier) pair
    grad_ = F.al_grad(Z, lam_def, lam_eq, mu, rho)
    val = F.al_from_parts(cost, cd, ce, g, lam_def, lam_eq, mu, rho)
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

    # ---- Newton step for lanes still inside an inner round
    p, bad_dir = F.direction(Z, grad_, lam_def, lam_eq, mu, rho, lm, g)

    # parallel Armijo line search over the alpha grid, one batched
    # residual pass for all candidates
    alphas = 0.5**exps
    Zc = torch.clamp(
        Z[:, None] + alphas[None, :, None, None] * p[:, None],
        F.lb[:, None], F.ub[:, None],
    )                                                     # [B, n, K, w]
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
    sel = torch.argmax(okc.to(torch.int32), dim=1)  # first passing alpha
    ls_ok = okc.any(dim=1)

    move = (~inner_done) & (~done) & ls_ok
    Znew = _sel(move, Zc[lanes, sel], Z)
    cd_n = _sel(move, cdc[lanes, sel], cd)
    ce_n = _sel(move, cec[lanes, sel], ce)
    g_n = _sel(move, gc[lanes, sel], g)
    cost_n = torch.where(move, costc[lanes, sel], cost)
    val_new = torch.where(move, valc[lanes, sel], val)

    # Levenberg adaptation, trust-region style: actual vs predicted
    # decrease along the step (the first-order term decc stands in)
    stepping = (~inner_done) & (~done)
    pred = torch.clamp(-0.5 * decc[lanes, sel], min=1e-12)
    ratio = (val - val_new) / pred
    lm_step = torch.where(
        ~ls_ok | bad_dir, torch.clamp(lm * 10.0, max=cfg.lm_max),
        torch.where(
            ratio > 0.75, torch.clamp(lm * 0.33, min=cfg.lm_min),
            torch.where(ratio < 0.25,
                        torch.clamp(lm * 3.0, max=cfg.lm_max), lm),
        ),
    )
    lm = torch.where(stepping, lm_step, lm)
    improved = (ref - val_new) > cfg.stall_tol * (1.0 + torch.abs(ref))
    noprog = torch.where(
        stepping,
        torch.where(improved, torch.zeros_like(noprog), noprog + 1),
        noprog,
    )
    in_it = torch.where(stepping, in_it + 1, in_it)

    # ---- outer (AL round) transition on inner_done lanes
    u = inner_done & (~done_prev)
    lam_def = _sel(u, lam_def + rho[:, None, None] * cd, lam_def)
    lam_eq = _sel(u, lam_eq + rho[:, None, None] * ce, lam_eq)
    mu = _sel(u, torch.clamp(mu + rho[:, None, None] * g, min=0.0), mu)
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
    viol_ref = torch.where(u, viol, viol_ref)

    return dict(
        Z=Znew, cd=cd_n, ce=ce_n, g=g_n, cost=cost_n, lam_def=lam_def,
        lam_eq=lam_eq, mu=mu, rho=rho, omega=omega, lm=lm,
        viol_prev=viol_prev, viol_ref=viol_ref, noprog=noprog, in_it=in_it,
        o_it=o_it, tot=st["tot"] + 1, done=done, pgn=pgn,
    )


def _solve_batch(nlp: NLP, cfg: SolverConfig, data: VGPData, z0, lam0,
                 rho_init=None) -> SolveResult:
    """The flattened AL-SQP over a batch; ``z0`` [B, nz], ``lam0`` a
    (lam_def, lam_eq, mu) triple with lane axes, ``rho_init`` [B]."""
    F = _ALFuncs(nlp, cfg, data)
    B = F.lb.shape[0]
    dtype, dev = F.dtype, F.lb.device
    lam_def0, lam_eq0, mu0 = lam0
    Z0 = torch.clamp(z0.reshape(B, F.K, F.w), F.lb, F.ub)
    max_total = cfg.max_total or cfg.max_outer * cfg.max_inner
    nls = max(min(cfg.ls_grid, len(_LS_EXPONENTS)), 1)
    exps = torch.tensor(_LS_EXPONENTS[:nls], dtype=dtype, device=dev)

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
        lm=full(cfg.lm0), viol_prev=full(inf), viol_ref=full(inf),
        noprog=full(0, torch.int32), in_it=full(0, torch.int32),
        o_it=full(0, torch.int32), tot=full(0, torch.int32),
        done=full(False, torch.bool), pgn=full(inf),
    )

    def cond(s):
        return ((~s["done"]) & (s["o_it"] < cfg.max_outer)
                & (s["tot"] < max_total))

    active = cond(st)
    while bool(active.any()):  # one host sync per iteration
        new = _body(F, cfg, st, exps)
        st = {k: _sel(active, new[k], st[k]) for k in _STATE}
        active = cond(st)

    cd, ce, g, Z = st["cd"], st["ce"], st["g"], st["Z"]
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


def init_multipliers(nlp: NLP, data: VGPData):
    """Zero multipliers of the right shapes for a batch (cold start)."""
    d = nlp.dims
    m_eq, m_in = _result_sizes(nlp, data)
    B = data.x0.shape[0]
    z = data.x0.new_zeros
    return (z((B, d.nsteps, d.nx)), z((B, d.nodes, m_eq)),
            z((B, d.nodes, m_in)))


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
    the whole fleet."""
    if z0 is None:
        z0 = map_lanes(nlp.initial_guess, data)
    if lam0 is None:
        lam0 = init_multipliers(nlp, data)
    return _solve_batch(nlp, cfg, data, z0, lam0, rho0)


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

    ``return_stage_trips=True`` additionally returns the tuple of trip
    counts (the most Newton iterations any lane ran) of phase 1 and of
    each stage.
    """
    res = solve_batched(nlp, cfg, data, z0, lam0, rho0)
    stage_trips = [int(res.inner_iters.max())]
    for count, budget in stages:
        B = res.status.shape[0]
        M = min(count, B)
        ok = res.status == int(Status.SOLVED)
        order = torch.argsort(ok.to(torch.int32), stable=True)
        idx = order[:M]
        sub = tree_map(lambda a: a[idx], data)
        cfg_i = dataclasses.replace(cfg, max_total=budget)
        lam_i = (res.lam_def[idx], res.lam_eq[idx], res.mu[idx])
        res_i = solve_batched(nlp, cfg_i, sub, res.z[idx], lam_i,
                              res.rho[idx])
        stage_trips.append(int(res_i.inner_iters.max()))
        v_old = torch.maximum(res.viol_eq[idx], res.viol_in[idx])
        v_new = torch.maximum(res_i.viol_eq, res_i.viol_in)
        ok_old = ok[idx]
        ok_new = res_i.status == int(Status.SOLVED)
        better = (ok_new & ~ok_old) | (~ok_old & (v_new < v_old))

        def merge(a, b):
            return a.index_copy(0, idx, _sel(better, b, a[idx]))

        res = tree_map(merge, res, res_i)
    if return_stage_trips:
        return res, tuple(stage_trips)
    return res
