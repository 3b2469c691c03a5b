"""Named sampling-based planners — eOMPL's planner registry, batched.

Counterpart of ``etol_tpu/solve/planners.py``. The reference's eOMPL
backend selects a kinodynamic planner by name {RRT, SST, EST, KPIECE,
PDST} (eOMPL.cpp:121-159) and grows ONE tree, one propagation at a time.
Here each planner keeps its defining mechanism on ONE fixed-shape tree
grown ``batch`` extensions a trip:

========  =============================================================
name      selection / pruning mechanism (all on the same tree)
========  =============================================================
RRT       Voronoi bias: parent = nearest node to a random target state
EST       low-density bias: parent ~ 1 / (1 + #neighbors in a ball)
KPIECE    coverage bias: parent ~ 1 / (1 + its (x, y)-cell count)
SST       BestNear selection (cheapest cost-from-root node within a
          radius of the random target) + witness pruning: each coverage
          cell keeps only its locally-cheapest node; dominated nodes are
          deactivated and never extended
PDST      deterministic subdivision priorities: each trip extends from
          the lowest-priority nonempty cells and doubles their priority
========  =============================================================

Two extra names outside the OMPL registry: ``CEM`` (cross-entropy
refinement over whole control sequences) and ``SHOOTING``
(:func:`..solve.shooting.plan`, batched random shooting).

Every planner returns ``(X [K, nx], U_nodes [K, nu], info)`` for ONE
problem (``data`` without a lane axis), so any of them can seed the AL-SQP
(:func:`plan_guess`) or stand alone as the eOMPL-parity coarse solver.

The random draws are kept apart from the deterministic bodies, as in
:mod:`.shooting`: :func:`plan_cem_from_normals` takes the per-round
normals and :func:`plan_tree_from_draws` takes each trip's draws (target
states, goal-bias uniforms, the Gumbel noise of a categorical choice,
controls, extension lengths), so a test can hand them the JAX package's
draws. :func:`cem_normals` and :func:`tree_draws` make them from a
``torch.Generator``, scaled as ``jax.random.uniform(minval, maxval)``
scales its floats; they do not reproduce ``jax.random``'s bits.

The JAX package's ``lax.scan`` over rounds and trips is one jitted
program; here the bodies run as programs of :mod:`.trip_graph`: on a
card each captured once per key as a CUDA graph, every round or trip
unrolled into it, and replayed; on the CPU eagerly, a host loop that
reads nothing back from the device. The draws stay outside the graph:
a tree's are staged whole before it (:func:`run_tree`).
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.func import vmap

from ..core.problem import VGPData, tree_map
from ..transcribe import obstacles as obs_mod
from . import shooting

PLANNERS = ("RRT", "SST", "EST", "KPIECE", "PDST")
EXTRA_PLANNERS = ("CEM", "SHOOTING")

# extensions-per-second rate that maps the reference's wall-clock solve
# budget onto a sample capacity (see budget_samples): the JAX package's
# figure, kept so that one budget means one sample count in both
EXT_RATE = 2048.0

# elements of one [rows, n] block of EST's pairwise distances (128 MiB of
# float32): the JAX package's [M, M, nx] difference tensor, which XLA
# fuses away, would be 12.9 GB at M = 32768 on every trip
_EST_BLOCK = 2 ** 25


def budget_samples(
    solve_time: float, ext_rate: float = EXT_RATE,
    lo: int = 64, hi: int = 65536,
) -> int:
    """Map a wall-clock solve budget (seconds) to a sample capacity.

    The reference budgets its planner by wall-clock — ``solveTime_ =
    nSteps * dt`` seconds (eOMPL.cpp:241) consumed by
    ``ss_->solve(solveTime_)`` (eOMPL.cpp:164). Here the budget maps
    DETERMINISTICALLY onto the number of extensions the planner is
    allowed (``solve_time * ext_rate``, clamped): the same dial with
    reproducible results."""
    return int(np.clip(round(solve_time * ext_rate), lo, hi))


def plan(
    name: str,
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    n_samples: Optional[int] = 1024,
    generator: Optional[torch.Generator] = None,
    solve_time: Optional[float] = None,
    ext_rate: float = EXT_RATE,
    **kw,
):
    """Dispatch by planner name (case-insensitive), eOMPL setPlanner
    parity (eOMPL.cpp:121-159). ``solve_time`` (seconds) is the
    reference's solve-budget dial (eOMPL.cpp:161-173,241): when given it
    overrides ``n_samples`` via :func:`budget_samples`. The draws come
    from ``generator`` (seed 0 on the data's device when none is
    given)."""
    name = name.strip().upper()
    if solve_time is not None:
        n_samples = budget_samples(solve_time, ext_rate)
    elif n_samples is None:
        n_samples = 1024
    if name not in PLANNERS + EXTRA_PLANNERS:
        raise ValueError(
            f"unknown planner {name!r}; choose from "
            f"{PLANNERS + EXTRA_PLANNERS}"
        )
    if generator is None:
        generator = torch.Generator(device=data.x0.device).manual_seed(0)
    if name == "SHOOTING":
        X, U, info = shooting.plan(
            dynamics, nsteps, tree_map(lambda a: a[None], data), n_samples,
            generator, **kw)
        return X[0], U[0], {k: v[0] for k, v in info.items()}
    if name == "CEM":
        return _plan_cem(dynamics, nsteps, data, n_samples, generator, **kw)
    return _plan_tree(dynamics, nsteps, data, n_samples, generator,
                      select=name, **kw)


def plan_guess(
    nlp,
    data: VGPData,
    n_samples: int = 1024,
    generator: Optional[torch.Generator] = None,
    planner: str = "PDST",
    **kw,
):
    """Planner-seeded initial guess packed as a decision vector z."""
    X, U, _ = plan(
        planner, nlp.dynamics, nlp.dims.nsteps, data, n_samples, generator,
        **kw
    )
    return torch.cat([X, U], dim=-1).reshape(-1)


def _draw(generator: torch.Generator, shape, data: VGPData):
    """Unit uniforms in [0, 1) of the data's dtype, made on the
    generator's device and handed to the data's."""
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=data.x0.dtype).to(data.x0.device)


def _scaled(u, lo, hi):
    """Unit floats to [lo, hi) as ``jax.random.uniform(minval, maxval)``
    scales them."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def _d2(a, b):
    """Squared distances over the last axis, summed dimension by dimension
    in order (the reduction XLA makes of ``jnp.sum(d ** 2, axis=-1)``);
    ``a`` and ``b`` broadcast."""
    out = (a[..., 0] - b[..., 0]) ** 2
    for k in range(1, a.shape[-1]):
        out = out + (a[..., k] - b[..., k]) ** 2
    return out


# ---------------------------------------------------------------------------
# CEM: cross-entropy refinement over control sequences (extra planner)
# ---------------------------------------------------------------------------


def cem_normals(n_samples: int, nsteps: int, n_rounds: int,
                generator: torch.Generator, data: VGPData):
    """The standard normals of every CEM round, eps [n_rounds, S, N,
    nu]."""
    nu = data.u_lb.shape[0]
    return torch.randn((n_rounds, n_samples, nsteps, nu),
                       generator=generator, device=generator.device,
                       dtype=data.x0.dtype).to(data.x0.device)


def plan_cem_from_normals(
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    eps,
    n_elite: int = 64,
    goal_weight: float = 10.0,
    effort_weight: float = 0.1,
):
    """Cross-entropy method: each round scores ``mu + sig * eps[r]``
    (clipped to the control box) and refits a per-step Gaussian to the
    ``n_elite`` best sequences. Not an OMPL planner — kept under its own
    name because it is often the strongest NLP seed."""
    span = data.u_ub - data.u_lb
    mid = 0.5 * (data.u_lb + data.u_ub)
    nu = span.shape[0]
    mu = mid.expand(nsteps, nu)
    sig = (0.5 * span).expand(nsteps, nu)
    best_score = torch.full((), float("inf"), dtype=mu.dtype,
                            device=mu.device)
    best_U = mu.new_zeros((nsteps, nu))
    round_best = []
    for eps_r in eps:
        U = torch.clamp(mu + sig * eps_r, data.u_lb, data.u_ub)
        scores, _ = shooting._score_rollouts(dynamics, data, U, goal_weight,
                                             effort_weight)
        # stable: lanes that collide all score the 1e6 penalty and tie
        elite_idx = torch.argsort(scores, stable=True)[:n_elite]
        elite = U[elite_idx]
        mu = torch.mean(elite, dim=0)
        # floor keeps late rounds exploring
        sig = torch.std(elite, dim=0, correction=0) + 0.02 * span
        # the round's best by a one-element index: a 0-dim one is read
        # on the host
        i0 = elite_idx[:1]
        s0 = scores[i0][0]
        better = s0 < best_score
        best_score = torch.where(better, s0, best_score)
        best_U = torch.where(better, U[i0][0], best_U)
        round_best.append(s0)
    X = shooting.rollout(dynamics, data.x0, best_U, data.dt, data)
    U_nodes = torch.cat([best_U[:1], best_U], dim=0)
    info = dict(
        best_score=best_score,
        round_best=torch.stack(round_best),
        valid=best_score < 1e6,
    )
    return X, U_nodes, info


def _plan_cem(
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    n_samples: int,
    generator: torch.Generator,
    n_rounds: int = 8,
    n_elite: int = 64,
    goal_weight: float = 10.0,
    effort_weight: float = 0.1,
):
    eps = cem_normals(n_samples, nsteps, n_rounds, generator, data)
    from . import trip_graph

    return trip_graph.program(plan_cem_from_normals, dynamics, nsteps, data,
                              eps, n_elite, goal_weight, effort_weight)


# ---------------------------------------------------------------------------
# batched kinodynamic tree (RRT / EST / KPIECE / SST / PDST policies)
# ---------------------------------------------------------------------------


def tree_shape(n_samples: int, batch: int = 64):
    """(capacity M, extensions a trip, trips) of a tree of ``n_samples``
    nodes."""
    M = n_samples
    batch = min(batch, max(M // 2, 1))
    return M, batch, max((M - 1) // batch, 1)


def tree_draws(
    select: str,
    n_samples: int,
    data: VGPData,
    generator: torch.Generator,
    batch: int = 64,
    ext_max: int = 4,
) -> Iterator[dict]:
    """Each trip's draws of a tree of ``n_samples`` nodes, one dict a trip,
    made as the trip asks for them: ``tgt`` [batch, nx] random target
    states in the state box (RRT, SST) or ``gumbel`` [batch, M] Gumbel
    noise of the categorical parent choice (EST, KPIECE, PDST);
    ``goal_u`` [batch] uniforms of the goal bias; ``u`` [batch, nu]
    controls in the control box; ``elen`` [batch] extension lengths in
    1..ext_max."""
    M, batch, n_iters = tree_shape(n_samples, batch)
    nx, nu = data.x0.shape[0], data.u_lb.shape[0]
    tiny = torch.finfo(data.x0.dtype).tiny
    for _ in range(n_iters):
        d = {}
        if select in ("RRT", "SST"):
            d["tgt"] = _scaled(_draw(generator, (batch, nx), data),
                               data.x_lb, data.x_ub)
        else:
            u = _draw(generator, (batch, M), data).clamp_min(tiny)
            d["gumbel"] = -torch.log(-torch.log(u))
        d["goal_u"] = _draw(generator, (batch,), data)
        d["u"] = _scaled(_draw(generator, (batch, nu), data),
                         data.u_lb, data.u_ub)
        d["elen"] = torch.randint(
            1, ext_max + 1, (batch,), generator=generator,
            device=generator.device).to(data.x0.device)
        yield d


def _plan_tree(
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    n_samples: int,
    generator: torch.Generator,
    select: str = "RRT",
    batch: int = 64,
    ext_max: int = 4,
    **kw,
):
    draws = tree_draws(select, n_samples, data, generator, batch, ext_max)
    return run_tree(dynamics, nsteps, data, draws, n_samples, select=select,
                    batch=batch, ext_max=ext_max, **kw)


def run_tree(dynamics: Callable, nsteps: int, data: VGPData,
             draws: Iterable[dict], n_samples: int, **kw):
    """:func:`plan_tree_from_draws` on :mod:`.trip_graph`'s route: eagerly
    on the CPU, taking each trip's draws as the trip asks for them; on a
    card every trip's draws staged first, [trips, ...] a name (EST's,
    KPIECE's and PDST's Gumbel noise is [batch, M] a trip: 1.67 GB at
    uas_2d's budget of 20480 samples), and the whole tree one program."""
    from . import trip_graph

    if trip_graph.route_of(data.x0.device) == "eager":
        return plan_tree_from_draws(dynamics, nsteps, data, draws,
                                    n_samples, **kw)
    trips = list(draws)
    staged = {name: torch.stack([d[name] for d in trips])
              for name in trips[0]}
    del trips
    return trip_graph.program(_tree_from_staged, dynamics, nsteps, data,
                              staged, n_samples, **kw)


def _tree_from_staged(dynamics, nsteps, data, staged, n_samples, **kw):
    """:func:`plan_tree_from_draws` of the draws :func:`run_tree` staged:
    the body its program captures."""
    trips = ({name: a[i] for name, a in staged.items()}
             for i in range(staged["u"].shape[0]))
    return plan_tree_from_draws(dynamics, nsteps, data, trips, n_samples,
                                **kw)


def _propagator(dynamics: Callable, data: VGPData):
    """One midpoint step of every extension lane, with its validity:
    (x [L, nx], u [L, nu], t [L]) -> (x_next, ok [L]); ok says the next
    state is inside the state box and outside every obstacle at the
    child's clock time ``t + dt`` (tracks move; eOMPL's checker ignores
    them, eOMPL.cpp:95-111)."""
    dt = data.dt

    def one(x, u, t):
        k1 = dynamics(x, u, t, data)
        k2 = dynamics(x + 0.5 * dt * k1, u, t + 0.5 * dt, data)
        xn = x + dt * k2
        g = obs_mod.collision_values(xn[:2], t + dt, data.obstacles,
                                     data.tracks)
        ok = torch.all(g <= 0.0) & torch.all(
            (xn >= data.x_lb) & (xn <= data.x_ub))
        return xn, ok

    return vmap(one)


def _neighbour_counts(S, grow, r2):
    """EST's density: for each node of S [n, nx], the growable nodes
    within sqrt(r2), counted over row blocks of at most ``_EST_BLOCK``
    distances."""
    n = S.shape[0]
    rows = max(1, _EST_BLOCK // n)
    return torch.cat([
        ((_d2(S[None, :, :], S[a:a + rows, None, :]) <= r2)
         & grow[None, :]).sum(dim=1)
        for a in range(0, n, rows)
    ])


def _drop_set(a, idx, vals):
    """``a.at[idx].set(vals, mode="drop")`` for indices in [0, len(a)],
    where len(a) is the dropped sentinel: the write goes through a copy
    with one spare slot."""
    ext = torch.cat([a, a[:1]])
    ext[idx] = vals
    return ext[:-1]


def plan_tree_from_draws(
    dynamics: Callable,
    nsteps: int,
    data: VGPData,
    draws: Iterable[dict],
    n_samples: int,
    select: str = "RRT",
    batch: int = 64,
    ext_max: int = 4,
    grid: int = 16,
    goal_bias: float = 0.15,
    goal_weight: float = 10.0,
    effort_weight: float = 0.1,
):
    """Fixed-shape kinodynamic tree: capacity ``n_samples`` nodes, grown
    ``batch`` extensions a trip from each trip's ``draws`` (see
    :func:`tree_draws`), each extension a short constant-control
    propagation (eOMPL's ODEBasicSolver analog). ``select`` picks the
    planner's selection/pruning mechanism (the module table).

    Every node stores its control *prefix* (zero-padded), so the best
    node replays as a full-horizon rollout; incomplete branches are
    scored by that padded replay. Returns (X [K, nx], U_nodes [K, nu],
    info)."""
    nx = data.x0.shape[0]
    nu = data.u_lb.shape[0]
    dt = data.dt
    dtype, dev = data.x0.dtype, data.x0.device
    M, batch, n_iters = tree_shape(n_samples, batch)
    G2 = grid * grid
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    states = torch.zeros((M, nx), dtype=dtype, device=dev)
    states[0] = data.x0
    depth = torch.zeros((M,), dtype=torch.int64, device=dev)
    ctrl = torch.zeros((M, nsteps, nu), dtype=dtype, device=dev)
    alive = torch.arange(M, device=dev) == 0
    cost = torch.zeros((M,), dtype=dtype, device=dev)
    # SST witness grid: per-cell cheapest cost and its node ("champion")
    wit_cost = torch.full((G2,), float("inf"), dtype=dtype, device=dev)
    wit_node = torch.full((G2,), -1, dtype=torch.int64, device=dev)
    # PDST subdivision priorities (deterministic, init 1)
    prio = torch.ones((G2,), dtype=dtype, device=dev)
    pruned = torch.zeros((), dtype=torch.int64, device=dev)

    span = data.x_ub - data.x_lb
    # density/coverage radius ~ a couple of grid cells; SST's BestNear
    # selection radius (the witness radius is the grid cell by
    # quantization)
    r_nbr2 = (0.1 * torch.sqrt(torch.sum(span * span))) ** 2
    r_bn2 = (0.15 * torch.sqrt(torch.sum(span * span))) ** 2
    lanes = torch.arange(batch, device=dev)
    idx = torch.arange(nsteps, device=dev)
    step = _propagator(dynamics, data)

    def cell_of(x):
        f = torch.clamp((x[:, :2] - data.x_lb[:2]) / span[:2], 0.0,
                        1.0 - 1e-6)
        ij = (f * grid).to(torch.int64)
        return ij[:, 0] * grid + ij[:, 1]

    def nearest_goal(S, grow):
        return torch.argmin(torch.where(grow, _d2(S, data.xf), inf))

    # every node lies in the written prefix [0, n_written): the selection
    # rules read only that prefix, where nodes beyond it are dead in the
    # JAX package's full-capacity arrays and never chosen
    n_written = 1
    trips = 0
    for dr in draws:
        trips += 1
        n = n_written
        S = states[:n]
        can_grow = alive[:n] & (depth[:n] < nsteps)
        use_goal = dr["goal_u"] < goal_bias

        # --- parent choice, one per extension lane ----------------------
        if select in ("RRT", "SST"):
            tgt = torch.where(use_goal[:, None], data.xf, dr["tgt"])
            d2 = torch.where(can_grow[None, :],
                             _d2(S[None, :, :], tgt[:, None, :]), inf)
            parents = torch.argmin(d2, dim=1)
            if select == "SST":
                # BestNear: cheapest node within delta_BN of the target;
                # the nearest node when the ball is empty
                near = d2 <= r_bn2
                cnear = torch.where(near, cost[None, :n], inf)
                parents = torch.where(torch.any(near, dim=1),
                                      torch.argmin(cnear, dim=1), parents)
        elif select == "PDST":
            # deterministic: the `batch` lowest-priority nonempty cells,
            # ties to the lower index (lax.top_k's order), empty cells last
            cells = cell_of(S)
            counts = torch.zeros((G2,), dtype=torch.int64, device=dev)
            counts.index_add_(0, cells, can_grow.to(torch.int64))
            prio_eff = torch.where(counts > 0, prio, inf)
            cell_pick = torch.argsort(prio_eff, stable=True)[:batch]
            lane_ok = torch.isfinite(prio_eff[cell_pick])
            # parent = uniform random growable node inside the lane's cell
            in_cell = can_grow[None, :] & (cells[None, :]
                                           == cell_pick[:, None])
            cat = torch.argmax(
                torch.where(in_cell, 0.0, -inf) + dr["gumbel"][:, :n], dim=1)
            parents = torch.where(use_goal | ~lane_ok,
                                  nearest_goal(S, can_grow), cat)
            # the PDST schedule: selected cells cost double next time
            twice = _drop_set(torch.ones_like(prio),
                              torch.where(lane_ok & ~use_goal, cell_pick, G2),
                              torch.full_like(prio[:1], 2.0))
            prio = prio * twice
        else:
            if select == "EST":
                nbrs = _neighbour_counts(S, can_grow, r_nbr2)
            else:  # KPIECE
                cells = cell_of(S)
                counts = torch.zeros((G2,), dtype=torch.int64, device=dev)
                counts.index_add_(0, cells, can_grow.to(torch.int64))
                nbrs = counts[cells]
            logw = torch.where(can_grow,
                               torch.log(1.0 / (1.0 + nbrs.to(dtype))), -inf)
            parents = torch.argmax(logw[None, :] + dr["gumbel"][:, :n],
                                   dim=1)
            # goal bias (OMPL's EST/KPIECE carry one too): some lanes
            # extend from the node closest to the goal
            parents = torch.where(use_goal, nearest_goal(S, can_grow),
                                  parents)

        # --- constant-control propagation of <= ext_max steps -----------
        u = dr["u"]
        px = states[parents]
        pd = depth[parents]
        # never extend past the horizon
        elen = torch.minimum(dr["elen"].to(torch.int64), nsteps - pd)
        x = px
        ok = torch.ones((batch,), dtype=torch.bool, device=dev)
        for i in range(ext_max):
            live = i < elen
            xn, ok_i = step(x, u, (pd + i).to(dtype) * dt)
            x = torch.where(live[:, None], xn, x)
            ok = ok & (ok_i | ~live)
        child_x = x
        ok = ok & (elen > 0) & can_grow[parents]
        child_d = pd + elen
        # cost-from-root: time + control effort of the new segment
        seg = elen.to(dtype) * dt * (
            1.0 + effort_weight * torch.sum(u * u, dim=-1))
        child_c = cost[parents] + seg
        # child control prefix = parent prefix with [pd, pd+e) := u
        m = (idx[None, :] >= pd[:, None]) & (idx[None, :]
                                             < (pd + elen)[:, None])
        cctrl = torch.where(m[:, :, None], u[:, None, :], ctrl[parents])

        # --- append (block write at the monotone write cursor; NOT at the
        # live count — pruning shrinks the live count, and writing there
        # would overwrite live nodes' slots) ------------------------------
        start = min(n_written, M - batch)
        n_written = min(n_written + batch, M)
        child_idx = start + lanes

        if select == "SST":
            # witness pruning: a child survives only if it is the cheapest
            # its cell has ever seen; the cell's previous champion is
            # deactivated (kept in storage for paths, never extended)
            ccell = cell_of(child_x)
            c_eff = torch.where(ok, child_c, inf)
            old_best = wit_cost[ccell]
            wit_cost = wit_cost.scatter_reduce(0, ccell, c_eff, "amin",
                                               include_self=True)
            accepted = ok & (c_eff <= wit_cost[ccell]) & (c_eff < old_best)
            old_champ = wit_node[ccell]
            deact = torch.where(accepted & (old_champ >= 0), old_champ, M)
            pruned = pruned + torch.sum(
                (deact < M) & alive[torch.clamp(deact, max=M - 1)])
            alive = _drop_set(alive, deact, torch.zeros_like(ok))
            wit_node = _drop_set(wit_node,
                                 torch.where(accepted, ccell, G2), child_idx)
            ok = accepted

        states[start:start + batch] = child_x
        depth[start:start + batch] = child_d
        ctrl[start:start + batch] = cctrl
        cost[start:start + batch] = child_c
        alive[start:start + batch] = ok
    if trips != n_iters:
        raise ValueError(f"{trips} trips of draws for a tree of {n_iters}")

    # --- pick the best node by full padded replay ------------------------
    scores, Xs = shooting._score_rollouts(dynamics, data, ctrl, goal_weight,
                                          effort_weight)
    # prefer deep, valid nodes; dead slots out (SST: witness champions
    # remain selectable — dominated nodes were deactivated)
    scores = torch.where(alive, scores, inf)
    scores = scores + 0.1 * (nsteps - depth).to(dtype)
    best = torch.argmin(scores)
    at = best[None]  # a one-element index: a 0-dim one is read on the host
    Ub = ctrl[at][0]
    U_nodes = torch.cat([Ub[:1], Ub], dim=0)
    info = dict(
        scores=scores,
        best=best,
        n_nodes=torch.sum(alive),
        depth=depth,
        best_depth=depth[at][0],
        cost=cost,
        n_pruned=pruned,
        cell_priority=prio,
        witness_cost=wit_cost,
    )
    return Xs[at][0], U_nodes, info
