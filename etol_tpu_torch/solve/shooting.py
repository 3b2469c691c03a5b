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
one key for every lane.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from ..core.problem import VGPData, map_lanes
from ..transcribe import obstacles as obs_mod
from ..transcribe.nlp import NLP


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
):
    """Best rollout per lane among ``n_samples`` random walks plus
    ``pulled`` goal-pulled greedy rollouts. ``data`` is a batch (lane
    axis first). Returns (X [B, K, nx], U_nodes [B, K, nu], info):
    U_nodes repeats the step controls onto nodes so the result packs
    into a collocation decision vector."""
    dev, dtype = data.x0.device, data.x0.dtype
    nu = data.u_lb.shape[-1]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, normal=False):
        f = torch.randn if normal else torch.rand
        return f(shape, generator=generator, device=dev, dtype=dtype)

    base_u = draw(n_samples, 1, nu)
    step_u = draw(n_samples, nsteps, nu)
    U = map_lanes(lambda d: _walk_controls(d, base_u, step_u), data)
    if pulled:
        cand_u = draw(pulled, nsteps, n_cand, nu)
        jitter = draw(pulled, nsteps, n_cand, normal=True)
        Up = map_lanes(
            lambda d: _pulled_controls(dynamics, d, cand_u, jitter), data
        )
        U = torch.cat([U, Up], dim=1)                      # [B, S, N, nu]
    scores, Xs = map_lanes(
        lambda d, Ul: _score_rollouts(dynamics, d, Ul, goal_weight,
                                      effort_weight),
        data, U,
    )
    best = torch.argmin(scores, dim=1)
    lanes = torch.arange(U.shape[0], device=dev)
    Xb, Ub = Xs[lanes, best], U[lanes, best]
    U_nodes = torch.cat([Ub[:, :1], Ub], dim=1)            # [B, K, nu]
    info = dict(
        scores=scores,
        best=best,
        valid_fraction=torch.mean((scores < 1e6).to(dtype), dim=1),
    )
    return Xb, U_nodes, info


def plan_guess(nlp: NLP, data: VGPData, n_samples: int = 4096,
               generator: Optional[torch.Generator] = None,
               pulled: int = 0, n_cand: int = 8):
    """Shooting-based initial guess per lane: the best collision-free
    rollout packed as a decision vector, z [B, nz]."""
    X, U, _ = plan(nlp.dynamics, nlp.dims.nsteps, data, n_samples,
                   generator, pulled=pulled, n_cand=n_cand)
    return torch.cat([X, U], dim=-1).reshape(X.shape[0], -1)
