"""Exact disjunctions + integers: one unified branch-and-bound.

Counterpart of ``etol_tpu/solve/side_branch.py``, with the same search,
the same certificates and the same results. The reference's MILP
backends encode both binary families in one model: "stay out of each
convex obstacle piece" big-M rows (one binary per piece side,
addObstacleSides/addObstacleSum, eGLPK.cpp:190-246; the NSIDES=4 squares
around moving circles, etol_glpk_example1.cpp:196-276) and per-window
integer/binary decision variables (param vartypes, eGLPK.cpp:275-332);
``glp_intopt`` resolves the single model exactly. That is why the
reference finds the optimum 12 on ``mip_2d_ex1`` where the smooth
conservative reformulation lands near 14.

A node of the one search is a pair of overrides on the relaxation:

* a per-(timestep, piece/track) **side assignment**: ``-1`` drops the
  disjunction for that pair (a valid relaxation), ``m >= 0`` enforces
  halfspace row ``m`` of the piece (or square side ``m`` of the track)
  as one LINEAR row;
* a per-(timestep, column) **box override**: the ``<= floor`` /
  ``>= ceil`` split on INTEGER/BINARY columns.

A node is discarded only with a certificate: SOLVED (its value prunes by
bound), converged infeasible, or stagnation (two consecutive warm
full-budget retries that failed to halve a violation well clear of the
feasibility band, convex case only). Budget exhaustion re-queues the
node warm; a node dropped without a certificate sets
``certified=False`` and downgrades the status to MAX_ITER. INFEASIBLE
is reported only for an exhausted tree.

The host keeps the heap; the relaxations run on the data's device. A
frontier wave of up to ``wave`` nodes is ONE batched solve
(:func:`..solve.al_sqp._solve_batch`), padded to ``wave`` lanes with
copies of its first node, so every Newton trip of every wave is one KKT
solve at (K, w, wave): one launch of the kernel under
``kkt_solver="kernel"`` for float32 nodes up to width 9. Each node
carries its warm z, multipliers, penalty and box into the wave; the
results come back to the host once a wave.

Moving obstacles use the reference's 4-sided square approximation: the
axis-aligned square of half-width r contains the protected disk.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

import numpy as np
import torch

from ..core.problem import VGPData, tree_map
from ..core.trajectory import linear_interpolation, to_host
from ..core.types import Status
from ..transcribe.nlp import NLP
from ..transcribe.obstacles import track_centers
from .al_sqp import SolverConfig, _solve_batch, init_multipliers
from .branch_bound import MIPResult


@dataclasses.dataclass(frozen=True)
class SideData:
    """A :class:`VGPData` plus per-(node, piece/track) side assignments.

    Attribute reads forward to ``base``, so the NLP machinery (bounds,
    costs, dynamics) reads it like a plain VGPData; the tree helpers of
    :mod:`..core.problem` see its three fields."""

    base: VGPData
    sel_piece: torch.Tensor   # [K, P] int32: -1 drop, m = halfspace row
    sel_track: torch.Tensor   # [K, T] int32: -1 drop, m = square side

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "base"), name)


# square-side normals for the moving-obstacle approximation (the
# reference's NSIDES=4, etol_glpk_example1.cpp:28-29): +x, -x, +y, -y
_TRACK_SIDES = 4


def _take_row(table, k):
    """``table[k]`` for a 0-dim long ``k`` that may be batched under
    ``torch.func.vmap``."""
    return torch.index_select(table, 0, k.reshape(1))[0]


def _take_along(values, sel):
    """``values[i, sel[i]]`` per row: ``take_along_axis`` on the last
    axis."""
    return torch.gather(values, 1, sel[:, None])[:, 0]


def _side_constraints(x, u, t, data, _p=None):
    """Side-assigned linear avoidance rows, <= 0 feasible.

    ``_p`` (unused) keeps the param-problem callback signature: with
    params declared every user callback receives the trailing param
    slice. For each piece with an assigned side m: n_m . pos >= b_m
    (outside through side m); for each track: the chosen axis distance
    >= r. Dropped pairs report -1 (feasible). The node index is
    recovered from the time as ``round(t / dt)``."""
    k = torch.round(t / data.dt).to(torch.long)
    pos = x[:2]
    parts = []
    obs = data.obstacles
    if obs.halfspaces.shape[0] > 0:
        hs = obs.halfspaces  # [P, H, 3]
        # pos[-1]: a 1-D state reads its one coordinate twice, as JAX's
        # clamped pos[1] does (its pieces are padding, masked below)
        margins = hs[..., 2] - (hs[..., 0] * pos[0] + hs[..., 1] * pos[-1])
        selp = _take_row(data.sel_piece, k).to(torch.long)  # [P]
        chosen = _take_along(margins, torch.clamp(selp, 0, hs.shape[1] - 1))
        parts.append(torch.where((selp >= 0) & (obs.piece_mask > 0), chosen,
                                 -torch.ones_like(chosen)))

    trk = data.tracks
    T = trk.xy.shape[0]
    if T > 0:
        cs = torch.stack([
            linear_interpolation(t, trk.times[i], trk.xy[i])
            for i in range(T)
        ])  # [T, D]
        d = pos[None, :] - cs[:, :2]
        sides = torch.stack([d[:, 0], -d[:, 0], d[:, 1], -d[:, 1]], dim=1)
        selt = _take_row(data.sel_track, k).to(torch.long)  # [T]
        chosen_t = _take_along(sides,
                               torch.clamp(selt, 0, _TRACK_SIDES - 1))
        row = trk.radius - chosen_t
        parts.append(torch.where((selt >= 0) & (trk.mask > 0), row,
                                 -torch.ones_like(row)))
    if not parts:
        return x.new_zeros((0,))
    return torch.cat(parts)


def branch_nlp(nlp: NLP) -> NLP:
    """The relaxation NLP: obstacles off, side rows on."""
    return dataclasses.replace(
        nlp,
        use_obstacles=False,
        path_ineq=nlp.path_ineq + (_side_constraints,),
    )


def _violations(Z2, hs, hs_mask, piece_mask, centers, radius, tmask,
                selp, selt, eps):
    """Host-side: deepest disjunction violation per lane.

    Returns (kind, k, j, depth): kind 0 = none, 1 = piece, 2 = track.
    A pair already carrying a side assignment is enforced by the solver,
    so only ``sel == -1`` pairs can violate."""
    if hs.shape[0] > 0:
        # piece containment depth: min over real halfspace margins (>0
        # deep inside); [K, P]
        marg = hs[None, :, :, 2] - (
            hs[None, :, :, 0] * Z2[:, None, None, 0]
            + hs[None, :, :, 1] * Z2[:, None, None, 1]
        )
        marg = np.where(hs_mask[None] > 0, marg, np.inf)
        depth_p = marg.min(axis=2)  # [K, P]
        depth_p = np.where(
            (piece_mask[None] > 0) & (selp < 0), depth_p, -np.inf
        )
        bp = np.unravel_index(np.argmax(depth_p), depth_p.shape)
        vp = depth_p[bp]
    else:
        bp, vp = (0, 0), -np.inf
    if centers.shape[1] > 0:
        # track square containment depth: r - max(|dx|,|dy|) (>0 inside)
        d = np.abs(Z2[:, None, :2] - centers[:, :, :2])  # [K, T, 2]
        depth_t = radius[None, :] - d.max(axis=2)
        depth_t = np.where(
            (tmask[None] > 0) & (selt < 0), depth_t, -np.inf
        )
        bt = np.unravel_index(np.argmax(depth_t), depth_t.shape)
        vt = depth_t[bt]
    else:
        bt, vt = (0, 0), -np.inf
    if max(vp, vt) <= eps:
        return (0, 0, 0, 0.0)
    if vp >= vt:
        return (1, int(bp[0]), int(bp[1]), float(vp))
    return (2, int(bt[0]), int(bt[1]), float(vt))


@dataclasses.dataclass
class _Node:
    """One open node: relaxation overrides + warm-start payload (host
    numpy)."""

    bound: float            # valid lower bound inherited/certified
    selp: np.ndarray        # [K, P] int8
    selt: np.ndarray        # [K, T] int8
    lo: np.ndarray          # [K, w] box override (integer branching)
    hi: np.ndarray
    z0: np.ndarray          # [nz] warm start
    lam: tuple              # (lam_def, lam_eq, mu) warm multipliers
    rho: Optional[float]    # warm penalty (None = cfg.rho0)
    retries: int = 0
    prev_viol: float = np.inf
    stagn: int = 0          # consecutive warm retries that failed to
    #                         halve the violation (certificate evidence)


def _next_stagn(stagn: int, stagnant_now: bool) -> int:
    """Consecutive-stagnation counter for the infeasibility certificate:
    a retry that fails to halve the violation extends the run; one that
    improves RESETS it (the certificate's two non-halving retries must be
    consecutive)."""
    return (stagn + 1) if stagnant_now else 0


def solve_exact(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    *,
    int_cols: Optional[np.ndarray] = None,
    wave: int = 8,
    max_nodes: int = 512,
    gap_tol: float = 1e-3,
    int_tol: float = 1e-3,
    inside_eps: float = 1e-3,
    convex_relaxation: Optional[bool] = None,
    max_retries: int = 3,
    node_budget: int = 0,
    verbose: bool = False,
) -> MIPResult:
    """Unified branch-and-bound over escape sides AND integer boxes.

    ``nlp`` is the problem's ordinary NLP (its smooth obstacle stack is
    replaced by the side rows); ``data`` one problem without a lane axis,
    on the device the relaxations run on; ``int_cols`` the optional
    [node_width] bool mask from :func:`.branch_bound.integer_mask`.
    ``convex_relaxation=True`` (valid for linear dynamics, convex cost
    and linear user rows) turns on bound pruning and a true optimality
    gap; the default ``None`` auto-detects as
    :func:`.branch_bound.solve_milp` does: convex iff there are no user
    path inequalities. ``node_budget`` caps the Newton iterations of one
    node attempt (0 = the config's budget); hard nodes earn more through
    warm re-queues, up to ``max_retries``.

    The result's ``trips`` is the sum over waves of the slowest lane's
    Newton iterations: the number of KKT solves of the search (kernel
    launches under ``kkt_solver="kernel"``)."""
    if convex_relaxation is None:
        # bound pruning is only sound when every relaxation is convex
        convex_relaxation = not nlp.path_ineq
    d = nlp.dims
    K, w = d.nodes, d.node_width
    bnlp = branch_nlp(nlp)
    if node_budget:
        cfg = dataclasses.replace(cfg, max_total=node_budget)
    dev = data.x0.device
    P = data.obstacles.halfspaces.shape[0]
    T = data.tracks.xy.shape[0]
    root_sd = SideData(
        data,
        torch.full((K, P), -1, dtype=torch.int32, device=dev),
        torch.full((K, T), -1, dtype=torch.int32, device=dev),
    )
    lam_cold = tuple(to_host(a[0]) for a in init_multipliers(
        bnlp, tree_map(lambda a: a[None], root_sd)))
    hs = to_host(data.obstacles.halfspaces)
    hs_mask = to_host(data.obstacles.hs_mask)
    piece_mask = to_host(data.obstacles.piece_mask)
    tmask = to_host(data.tracks.mask)
    radius = to_host(data.tracks.radius)
    n_sides = hs_mask.sum(axis=1).astype(int)  # real rows per piece
    # track centers at the node times (for violation detection), [K, T, D]
    ts = torch.tensor(np.arange(K) * float(data.dt),
                      dtype=data.tracks.times.dtype, device=dev)
    centers = (to_host(track_centers(ts, data.tracks)) if T
               else np.zeros((K, 0, 2)))

    tdtype = data.x0.dtype
    dtype = np.float32 if tdtype == torch.float32 else np.float64
    BIG = np.asarray(np.finfo(dtype).max / 4, dtype)
    root_lo = np.full((K, w), -BIG, dtype)
    root_hi = np.full((K, w), +BIG, dtype)
    if int_cols is not None:
        int_cols = np.asarray(int_cols, dtype=bool)
        cols = np.where(int_cols)[0]
    else:
        cols = np.zeros((0,), int)
    # integrality is only decidable for entries the box can still move;
    # entries pinned by the NLP bounds (x0 clamp, window pins) are exempt
    lbN, ubN = (to_host(a).reshape(K, w) for a in bnlp.bounds(root_sd))
    pinned = (ubN - lbN) <= 1e-12

    sign = -1.0 if nlp.maximize else 1.0
    z_guess = to_host(nlp.initial_guess(data))
    feas_tol = 10.0 * cfg.tol_cons

    def frac_parts(Z):
        """[K, w] distance to nearest integer on integer columns."""
        if cols.size == 0:
            return np.zeros_like(Z)
        fr = np.abs(Z - np.round(Z))
        out = np.zeros_like(Z)
        out[:, cols] = fr[:, cols]
        out[pinned] = 0.0
        return out

    def solve_wave(batch):
        """One batched solve of the wave's nodes, padded to ``wave``
        lanes with copies of the first; its results on the host."""
        pad = wave - len(batch)

        def stk(get, dt=None):
            a = np.stack([get(n) for n in batch] + [get(batch[0])] * pad)
            return torch.as_tensor(a, dtype=dt, device=dev)

        sdata = SideData(
            tree_map(lambda a: a.expand((wave,) + tuple(a.shape)), data),
            stk(lambda n: n.selp, torch.int32),
            stk(lambda n: n.selt, torch.int32),
        )
        lams = tuple(stk(lambda n, i=i: n.lam[i], tdtype) for i in range(3))
        rhos = torch.as_tensor(
            [n.rho if n.rho is not None else cfg.rho0 for n in batch]
            + [cfg.rho0] * pad, dtype=tdtype, device=dev)
        box = (stk(lambda n: n.lo, tdtype), stk(lambda n: n.hi, tdtype))
        res = _solve_batch(bnlp, cfg, sdata, stk(lambda n: n.z0, tdtype),
                           lams, rhos, box)
        return {f: to_host(getattr(res, f)) for f in (
            "z", "obj", "status", "viol_eq", "viol_in", "inner_iters",
            "lam_def", "lam_eq", "mu", "rho")}

    tie = itertools.count()
    root = _Node(
        bound=-np.inf,
        selp=np.full((K, P), -1, np.int8),
        selt=np.full((K, T), -1, np.int8),
        lo=root_lo, hi=root_hi,
        z0=z_guess, lam=lam_cold, rho=None,
    )
    heap = [(-np.inf, next(tie), root)]

    def key_of(n):
        return (n.selp.tobytes() + n.selt.tobytes()
                + n.lo.tobytes() + n.hi.tobytes())

    seen = {key_of(root)}
    incumbent_z = None
    incumbent_obj = np.inf
    nodes_solved = 0
    waves = 0
    trips = 0
    certified = True

    def requeue(node, **updates):
        nn = dataclasses.replace(node, **updates)
        heapq.heappush(heap, (nn.bound, next(tie), nn))

    while heap and nodes_solved < max_nodes:
        batch = []
        while heap and len(batch) < wave:
            bound, _, node = heapq.heappop(heap)
            if convex_relaxation and bound >= incumbent_obj - gap_tol:
                continue
            batch.append(node)
        if not batch:
            break
        res = solve_wave(batch)
        zs, objs, stat = res["z"], res["obj"], res["status"]
        viol = np.maximum(res["viol_eq"], res["viol_in"])
        waves += 1
        trips += int(res["inner_iters"].max())
        nodes_solved += len(batch)

        for i, node in enumerate(batch):
            st, v = int(stat[i]), float(viol[i])
            lam_i = (res["lam_def"][i], res["lam_eq"][i], res["mu"][i])
            rho_i = float(res["rho"][i])
            if st == int(Status.DIVERGED) or not np.isfinite(objs[i]):
                if node.retries < max_retries:
                    # cold restart: divergence poisons the warm state
                    requeue(node, z0=z_guess, lam=lam_cold, rho=None,
                            retries=node.retries + 1,
                            prev_viol=np.inf, stagn=0)
                else:
                    certified = False
                continue
            solved = st == int(Status.SOLVED)
            if not solved:
                # MAX_ITER: budget exhaustion is NOT a certificate.
                stagnant_now = v >= 0.5 * node.prev_viol
                if node.retries < max_retries:
                    requeue(
                        node, z0=zs[i].copy(), lam=lam_i, rho=rho_i,
                        retries=node.retries + 1, prev_viol=v,
                        # an improving retry resets the count (else a
                        # converging node whose early retries stagnated
                        # could be pruned as certified-infeasible)
                        stagn=_next_stagn(node.stagn, stagnant_now),
                    )
                    continue
                if v > feas_tol:
                    # stagnation certificate: AL with growing rho drives
                    # the violation of any feasible convex relaxation
                    # down, so infeasibility is certified only when the
                    # violation is well clear of the feasibility band AND
                    # at least two consecutive warm full-budget retries
                    # failed to halve it; otherwise the node is dropped
                    # WITHOUT a certificate
                    if (
                        convex_relaxation and stagnant_now
                        and node.stagn >= 1 and v > 10.0 * feas_tol
                    ):
                        continue
                    certified = False
                    continue
                # feasible but unconverged: its value bounds nothing;
                # branch on with the INHERITED bound (and if nothing is
                # left to branch, the incumbent path below flips
                # certified=False)
            elif v > feas_tol:
                continue  # converged infeasible: certified prune
            relax_obj = sign * float(objs[i])
            child_bound = relax_obj if solved else node.bound
            if (
                convex_relaxation and solved
                and relax_obj >= incumbent_obj - gap_tol
            ):
                continue
            Z = zs[i].reshape(K, w)
            kind, k, j, depth = _violations(
                Z[:, :2], hs, hs_mask, piece_mask, centers, radius,
                tmask, node.selp, node.selt, inside_eps,
            )
            fr = frac_parts(Z)
            if kind == 0 and fr.max() <= int_tol:
                # feasible against the EXACT disjunctions + integral: a
                # valid incumbent; only a CONVERGED node certifies its
                # region's optimum (an unconverged leaf truncates the
                # tree there)
                if relax_obj < incumbent_obj:
                    incumbent_obj = relax_obj
                    incumbent_z = zs[i].copy()
                    if verbose:
                        print(
                            f"[side-bb] incumbent "
                            f"{sign * incumbent_obj:.6g} after "
                            f"{nodes_solved} nodes"
                        )
                if not solved:
                    certified = False
                continue
            children = []
            if kind != 0:
                n_children = n_sides[j] if kind == 1 else _TRACK_SIDES
                for m in range(n_children):
                    cp, ct = node.selp.copy(), node.selt.copy()
                    if kind == 1:
                        cp[k, j] = m
                    else:
                        ct[k, j] = m
                    children.append(dict(selp=cp, selt=ct))
            else:
                # integer branch on the most fractional entry
                t_i, j_i = np.unravel_index(np.argmax(fr), fr.shape)
                val = Z[t_i, j_i]
                for which in ("floor", "ceil"):
                    clo, chi = node.lo.copy(), node.hi.copy()
                    if which == "floor":
                        chi[t_i, j_i] = min(chi[t_i, j_i], np.floor(val))
                    else:
                        clo[t_i, j_i] = max(clo[t_i, j_i], np.ceil(val))
                    if (
                        max(clo[t_i, j_i], lbN[t_i, j_i])
                        > min(chi[t_i, j_i], ubN[t_i, j_i]) + 1e-9
                    ):
                        continue  # empty child
                    children.append(dict(lo=clo, hi=chi))
                if incumbent_z is None and cols.size:
                    # dive child: round-and-fix EVERY movable integer
                    # entry of this node's relaxation to hunt an early
                    # incumbent
                    r = np.round(
                        np.clip(Z, np.maximum(node.lo, lbN),
                                np.minimum(node.hi, ubN))
                    )
                    dlo, dhi = node.lo.copy(), node.hi.copy()
                    free = ~pinned
                    fc = np.zeros_like(free)
                    fc[:, cols] = True
                    sel = free & fc
                    dlo[sel] = np.maximum(dlo[sel], r[sel])
                    dhi[sel] = np.minimum(dhi[sel], r[sel])
                    if np.all(dlo[sel] <= dhi[sel] + 1e-9):
                        children.append(dict(lo=dlo, hi=dhi))
            for ch in children:
                nn = dataclasses.replace(
                    node, bound=child_bound, z0=zs[i].copy(),
                    lam=lam_i, rho=rho_i,
                    retries=0, prev_viol=np.inf, stagn=0, **ch,
                )
                key = key_of(nn)
                if key in seen:
                    continue
                seen.add(key)
                heapq.heappush(heap, (child_bound, next(tie), nn))

    best_bound = min(
        [b for b, *_ in heap] + [incumbent_obj]
    ) if heap else incumbent_obj
    if incumbent_z is None:
        # INFEASIBLE claims certified infeasibility: the tree fully
        # exhausted (no open nodes left by the max_nodes budget) AND every
        # prune certified; a budget-truncated search reports MAX_ITER
        exhausted = (not heap) and certified
        return MIPResult(
            z=np.zeros(d.nz, dtype),
            obj=np.nan,
            status=int(Status.INFEASIBLE) if exhausted
            else int(Status.MAX_ITER),
            best_bound=sign * best_bound
            if np.isfinite(best_bound) else np.nan,
            gap=np.inf,
            nodes_solved=nodes_solved,
            waves=waves,
            incumbent_found=False,
            certified=certified and not heap,
            trips=trips,
        )
    if convex_relaxation:
        gap = abs(incumbent_obj - best_bound) / max(
            1.0, abs(incumbent_obj)
        )
        closed = ((not heap) or gap <= gap_tol) and certified
    else:
        gap = 0.0 if (not heap and certified) else float("nan")
        closed = (not heap) and certified
    return MIPResult(
        z=incumbent_z,
        obj=sign * incumbent_obj,
        status=int(Status.SOLVED) if closed else int(Status.MAX_ITER),
        best_bound=sign * best_bound,
        gap=float(gap),
        nodes_solved=nodes_solved,
        waves=waves,
        incumbent_found=True,
        certified=certified,
        trips=trips,
    )
