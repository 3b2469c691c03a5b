"""Batched randomized shooting seeds for the AL-SQP.

Counterpart of ``etol_tpu/solve/shooting.py``: sample control
sequences, roll the dynamics forward, mask out rollouts that enter an
exclusion zone, and keep the best by goal distance + control effort.

The random draws are kept apart from the deterministic math. The draws
come from a ``torch.Generator`` on the data's device, as unit uniforms
and normals that the deterministic functions (:func:`_walk_controls`,
:func:`_pulled_controls`, :func:`rollout`, :func:`_collision_free`,
:func:`_score_rollouts`) scale and use, so a test can hand both packages
the same controls. The draws do not reproduce ``jax.random``'s.

:func:`plan` and :func:`plan_guess` take a batch of problems (lane axis
first) and draw ONE set of unit draws that every lane scales by its own
bounds — as the JAX bench's per-lane ``plan_guess(..., key=None)`` uses
one key for every lane (``tests/test_torch_shooting.py`` hands
:func:`plan_from_units` the reference's own draws and gets its seeds).

:func:`plan` makes the draws eagerly and runs :func:`plan_from_units`
as a program of :mod:`.trip_graph`: on a card captured once per key as a
CUDA graph and replayed, as the JAX package jits its ``plan``; on the
CPU eagerly. The multistart and rescue solves, programs of their own,
draw with :func:`draw_units` first and call :func:`guess_from_units`
inside.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from ..core.problem import VGPData, map_lanes
from ..transcribe import obstacles as obs_mod
from ..transcribe.nlp import NLP
from ..utils import profiling


def rollout(dynamics: Callable, x0, U, dt, data, method: str = "rk2"):
    """Integrate ``xdot = f(x, u, t)`` under piecewise-constant controls
    for one problem. U is [N, nu]; returns X [N+1, nx]. ``rk2``
    (midpoint) or ``euler``."""
    x = x0
    t = x0.new_zeros(())
    xs = [x0]
    for n in range(U.shape[0]):
        u = U[n]
        if method == "euler":
            x = x + dt * dynamics(x, u, t + dt, data)
        else:
            k1 = dynamics(x, u, t, data)
            k2 = dynamics(x + 0.5 * dt * k1, u, t + 0.5 * dt, data)
            x = x + dt * k2
        t = t + dt
        xs.append(x)
    return torch.stack(xs)


def _collision_free(X, dt, data: VGPData):
    """True when no node of X (first two states) violates an obstacle
    (one problem)."""
    K = X.shape[0]
    ts = torch.arange(K, device=X.device).to(X.dtype) * dt

    def node_ok(x, t):
        g = obs_mod.collision_values(x[:2], t, data.obstacles, data.tracks)
        return torch.all(g <= 0.0)

    return torch.all(vmap(node_ok)(X, ts))


def _walk_controls(data: VGPData, base_u, step_u):
    """Smooth random walks in control space for one problem, from unit
    uniforms ``base_u`` [S, 1, nu] and ``step_u`` [S, N, nu]:
    U = clip(base + cumsum(steps)) with base uniform in the control box
    and steps uniform in ±0.3 of its span. Returns U [S, N, nu]."""
    span = data.u_ub - data.u_lb
    base = data.u_lb + span * base_u
    steps = -0.3 * span + 0.6 * span * step_u
    return torch.clamp(
        base + torch.cumsum(steps, dim=1), data.u_lb, data.u_ub
    )


def _pulled_controls(dynamics: Callable, data: VGPData, cand_u, jitter):
    """Goal-pulled rollout family for one problem: at every step each
    rollout takes, among its candidate controls, the one minimizing the
    xtol-weighted distance to the goal plus an obstacle/box penalty,
    after a relative score jitter of 15%. ``cand_u`` [S, N, C, nu] are
    unit uniforms (candidate controls in the box), ``jitter`` [S, N, C]
    standard normals. Returns U [S, N, nu]. (The JAX package's
    ``margin`` and ``greedy_effort`` knobs are left at their 0 default,
    the only value its callers use.)"""
    dt = data.dt
    S, N, C, _ = cand_u.shape
    wgt = 1.0 / (data.xtol + 0.1) ** 2
    uspan = data.u_ub - data.u_lb

    def eval_c(x, t, u):
        k1 = dynamics(x, u, t, data)
        k2 = dynamics(x + 0.5 * dt * k1, u, t + 0.5 * dt, data)
        xn = x + dt * k2
        g = obs_mod.collision_values(
            xn[:2], t + dt, data.obstacles, data.tracks
        )
        pen = torch.where(torch.any(g > 0.0), 1e6, 0.0).to(x.dtype)
        pen = pen + 10.0 * torch.sum(torch.clamp(g, min=0.0))
        in_box = torch.all((xn >= data.x_lb) & (xn <= data.x_ub))
        pen = pen + torch.where(in_box, 0.0, 1e6).to(x.dtype)
        return torch.sum(wgt * (xn - data.xf) ** 2) + pen, xn

    # candidates of every rollout at once: [S, C]
    eval_all = vmap(vmap(eval_c, in_dims=(None, None, 0)),
                    in_dims=(0, None, 0))
    x = data.x0.expand(S, data.x0.shape[0])
    t = data.x0.new_zeros(())
    picked = []
    for n in range(N):
        cand = data.u_lb + uspan * cand_u[:, n]          # [S, C, nu]
        scores, xns = eval_all(x, t, cand)
        scores = scores * (1.0 + 0.15 * jitter[:, n])
        i = torch.argmin(scores, dim=1)
        rows = torch.arange(S, device=x.device)
        x = xns[rows, i]
        picked.append(cand[rows, i])
        t = t + dt
    return torch.stack(picked, dim=1)


def _score_rollouts(dynamics: Callable, data: VGPData, U,
                    goal_weight: float = 10.0, effort_weight: float = 0.1):
    """Score every control sequence U [S, N, nu] of one problem:
    goal_weight·|x_N - xf|² + effort_weight·mean(u²), plus 1e6 when the
    rollout collides or leaves the state box. Returns (scores [S],
    X [S, N+1, nx])."""
    def eval_one(Uk):
        X = rollout(dynamics, data.x0, Uk, data.dt, data)
        ok = _collision_free(X, data.dt, data)
        in_box = torch.all((X >= data.x_lb) & (X <= data.x_ub))
        goal = torch.sum((X[-1] - data.xf) ** 2)
        effort = torch.mean(Uk**2)
        pen = torch.where(ok & in_box, 0.0, 1e6).to(X.dtype)
        return goal_weight * goal + effort_weight * effort + pen, X

    return vmap(eval_one)(U)


def draw_units(n_samples: int, nsteps: int, nu: int, pulled: int,
               n_cand: int, generator: torch.Generator, device, dtype,
               lanes: Optional[int] = None):
    """The unit draws of one :func:`plan` call, shared by every lane:
    (base_u [S, 1, nu], step_u [S, N, nu], cand_u [P, N, C, nu] or None,
    jitter [P, N, C] or None) — uniforms in [0, 1) and, for the jitter,
    standard normals. With ``lanes`` every tensor gets that leading axis:
    draws of its own for each lane (``per_lane`` of
    :func:`plan_from_units`). The draws are made on the generator's own
    device and handed to ``device``: a CPU generator gives one seed the
    same draws whatever device the problem lies on."""
    lead = () if lanes is None else (lanes,)

    def draw(*shape, normal=False):
        f = torch.randn if normal else torch.rand
        return f(lead + shape, generator=generator,
                 device=generator.device, dtype=dtype).to(device)

    base_u = draw(n_samples, 1, nu)
    step_u = draw(n_samples, nsteps, nu)
    if not pulled:
        return base_u, step_u, None, None
    cand_u = draw(pulled, nsteps, n_cand, nu)
    jitter = draw(pulled, nsteps, n_cand, normal=True)
    return base_u, step_u, cand_u, jitter


def plan_from_units(dynamics: Callable, data: VGPData, base_u, step_u,
                    cand_u=None, jitter=None, goal_weight: float = 10.0,
                    effort_weight: float = 0.1, per_lane: bool = False):
    """The deterministic part of :func:`plan`: every lane of ``data``
    scales the same unit draws by its own bounds (``per_lane``: its own
    draws, the tensors then carry the lane axis first), rolls them out
    and keeps its best. Returns (X [B, K, nx], U_nodes [B, K, nu],
    info)."""
    if not per_lane:  # shared draws: a view with the lane axis
        B = data.x0.shape[0]
        base_u, step_u, cand_u, jitter = (
            None if u is None else u.expand((B,) + tuple(u.shape))
            for u in (base_u, step_u, cand_u, jitter))
    U = map_lanes(_walk_controls, data, base_u, step_u)
    if cand_u is not None:
        Up = map_lanes(
            lambda d, c, j: _pulled_controls(dynamics, d, c, j),
            data, cand_u, jitter)
        U = torch.cat([U, Up], dim=1)                      # [B, S, N, nu]
    scores, Xs = map_lanes(
        lambda d, Ul: _score_rollouts(dynamics, d, Ul, goal_weight,
                                      effort_weight),
        data, U,
    )
    best = torch.argmin(scores, dim=1)
    lanes = torch.arange(U.shape[0], device=U.device)
    Xb, Ub = Xs[lanes, best], U[lanes, best]
    U_nodes = torch.cat([Ub[:, :1], Ub], dim=1)            # [B, K, nu]
    info = dict(
        scores=scores,
        best=best,
        valid_fraction=torch.mean((scores < 1e6).to(U.dtype), dim=1),
    )
    return Xb, U_nodes, info


def plan(
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    n_samples: int = 4096,
    generator: Optional[torch.Generator] = None,
    goal_weight: float = 10.0,
    pulled: int = 0,
    n_cand: int = 8,
    effort_weight: float = 0.1,
    per_lane: bool = False,
):
    """Best rollout per lane among ``n_samples`` random walks plus
    ``pulled`` goal-pulled greedy rollouts. ``data`` is a batch (lane
    axis first); ``per_lane`` gives every lane draws of its own instead
    of one shared set. Returns (X [B, K, nx], U_nodes [B, K, nu], info):
    U_nodes repeats the step controls onto nodes so the result packs
    into a collocation decision vector."""
    dev, dtype = data.x0.device, data.x0.dtype
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with profiling.span("solve.draws", device=str(generator.device)) as sp:
        units = draw_units(n_samples, nsteps, data.u_lb.shape[-1], pulled,
                           n_cand, generator, dev, dtype,
                           lanes=data.x0.shape[0] if per_lane else None)
        sp.set(**profiling.sizes(units))
    from . import trip_graph

    return trip_graph.program(plan_from_units, dynamics, data, *units,
                              goal_weight=goal_weight,
                              effort_weight=effort_weight, per_lane=per_lane)


def _packed(nlp: NLP, X, U):
    """Rollouts X [B, K, nx] and U_nodes [B, K, nu] packed as decision
    vectors z [B, nz] (param columns zero)."""
    parts = [X, U]
    if nlp.dims.n_params:
        parts.append(X.new_zeros(X.shape[:2] + (nlp.dims.n_params,)))
    return torch.cat(parts, dim=-1).reshape(X.shape[0], -1)


def guess_from_units(nlp: NLP, data: VGPData, units, per_lane: bool = False):
    """The deterministic part of :func:`plan_guess`: the best rollout per
    lane from the unit draws ``units`` (:func:`draw_units`) through
    :func:`plan_from_units`, packed as z [B, nz]. What the multistart and
    rescue bodies call inside their own program."""
    X, U, _ = plan_from_units(nlp.dynamics, data, *units, per_lane=per_lane)
    return _packed(nlp, X, U)


def plan_guess(nlp: NLP, data: VGPData, n_samples: int = 4096,
               generator: Optional[torch.Generator] = None,
               pulled: int = 0, n_cand: int = 8, per_lane: bool = False):
    """Shooting-based initial guess per lane: the best collision-free
    rollout packed as a decision vector, z [B, nz] (param columns
    zero)."""
    X, U, _ = plan(nlp.dynamics, nlp.dims.nsteps, data, n_samples,
                   generator, pulled=pulled, n_cand=n_cand,
                   per_lane=per_lane)
    return _packed(nlp, X, U)
