"""The output check: every number it compares, worked out again in float64
plain PyTorch from the problem (``problem.py``), the inputs the harness
handed the program and the program's returned trajectories, statuses and
objectives.

Per lane, each a number whose limit the configuration's file states:

* ``defect``: the largest collocation defect of the scheme, over the
  half-range of the state's bounds (at least 1), the solver's own scaling,
  so it reads against the solver's constraint tolerance;
* ``bound``: the largest excess over a state or control bound, node 0
  pinned to the start handed in and the last node held to the goal's
  tolerance band;
* ``zone_depth``: the deepest node inside a static exclusion polygon, as
  the distance to its nearest edge (0 outside);
* ``track_depth``: the deepest node inside a moving circular zone, as
  (r^2 - d^2) / r^2 (0 outside), the centre at the node's time on the
  zone's schedule advanced by the lane's clock shift;
* ``obj_gap``: |returned objective - the trapezoid-rule running cost of
  the returned trajectory| / max(1, |that cost|).

The dynamics and the scheme are the files the configuration names:
``dynamics/<name>.py`` and ``schemes/<name>.py`` beside this one.

Over the run, one more number:

* ``stationarity``: the median over the run's SOLVED lanes of each lane's
  first-order optimality residual (:func:`stationarity`): the inf-norm of
  the Lagrangian's gradient at the returned trajectory and multipliers,
  projected on the box as the solver projects it. A median, since the
  solver itself accepts a lane that stalls at up to 100 times its
  tolerance; a solver that stops short, or optimises another cost, moves
  the bulk of its lanes.

A lane is judged only where the program reports it SOLVED: a lane it
reports otherwise is honest and is counted as unsolved. A non-finite output
in a lane the program does not report DIVERGED is a fault wherever it is.
Nothing here imports the program.
"""
from __future__ import annotations

import functools
import importlib.util
import os

import numpy as np
import torch

from .problem import Problem

SOLVED = 1
DIVERGED = 4
NUMBERS = ("defect", "bound", "zone_depth", "track_depth", "obj_gap")
#: the quantile of the lanes' residuals that ``stationarity`` compares
STAT_QUANTILE = 0.5


@functools.lru_cache(maxsize=None)
def _model(kind: str, name: str, reference_dir: str):
    """The module of ``<reference_dir>/<kind>/<name>.py``, loaded once."""
    path = os.path.join(reference_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise ValueError(f"no reference {kind} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.reference.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dynamics(prob: Problem, x, u):
    return _model("dynamics", prob.dynamics, prob.reference_dir).f(
        x, u, prob.params)


def _defects(prob: Problem, X, U):
    """[n, N, nx] collocation defects of the scheme."""
    return _model("schemes", prob.scheme, prob.reference_dir).defects(
        lambda x, u: _dynamics(prob, x, u), X, U, prob.dt)


def _defect_scale(prob: Problem, like):
    return _var_scale(like.new_tensor(prob.x_lower),
                      like.new_tensor(prob.x_upper)).clamp(min=1.0)


def _state_box(prob: Problem, X, x0, xf):
    """The states' box [n, K, nx] each side: node 0 pinned to x0, the last
    node inside the goal's band."""
    xlo = X.new_tensor(prob.x_lower).expand_as(X).clone()
    xhi = X.new_tensor(prob.x_upper).expand_as(X).clone()
    tol = X.new_tensor(prob.xtol)
    xlo[:, 0], xhi[:, 0] = x0, x0
    xlo[:, -1] = torch.maximum(xf - tol, xlo[:, -1])
    xhi[:, -1] = torch.minimum(xf + tol, xhi[:, -1])
    return xlo, xhi


def _bound_excess(prob: Problem, X, U, x0, xf):
    """[n] the largest excess over the box."""
    xlo, xhi = _state_box(prob, X, x0, xf)
    ulo, uhi = U.new_tensor(prob.u_lower), U.new_tensor(prob.u_upper)
    over = torch.cat([(xlo - X).flatten(1), (X - xhi).flatten(1),
                      (ulo - U).flatten(1), (U - uhi).flatten(1)], dim=1)
    return over.clamp(min=0.0).amax(dim=1)


def _var_scale(lo, hi):
    """The solver's scale of a variable: half its range, in [1e-2, 1e4],
    1 where the range is empty or unbounded."""
    half = 0.5 * (hi - lo)
    ok = torch.isfinite(half) & (half > 1e-9)
    return torch.where(ok, half.clamp(1e-2, 1e4), torch.ones_like(half))


def _cost(prob: Problem, U):
    """[n] the trapezoid-rule running cost sum_i w_i u_i^2."""
    w = torch.ones(prob.nodes, dtype=U.dtype, device=U.device)
    w[0] = w[-1] = 0.5
    cw = U.new_tensor(prob.cost_weights)
    return prob.dt * ((U ** 2 * cw).sum(-1) * w).sum(-1)


def stationarity(prob: Problem, x0, xf, Z, lam_def, mu):
    """[n] each lane's first-order optimality residual at its returned
    nodes ``Z`` [n, K, nx + nu] and multipliers: ``lam_def`` [n, N, nx] of
    the scaled defects, ``mu`` [n, K, m] of the node's zone rows. The
    gradient of L = cost + lam_def . defect / scale (autograd, float64),
    projected on the box (Z - clamp(Z - s g, lo, hi)) / s with the solver's
    variable scales s, as an inf-norm over the lane. A zone row's gradient
    is the program's own smooth form, which the reference does not copy: at
    a node where some ``mu`` is positive, the position's components (the
    first ``pos_dims`` states) are left out; everywhere else ``mu`` is 0
    and L is the whole Lagrangian."""
    nx, nu = prob.nx, prob.nu
    Zg = Z.detach().clone().requires_grad_(True)
    X, U = Zg[..., :nx], Zg[..., nx:nx + nu]
    C = _defects(prob, X, U) / _defect_scale(prob, X)
    L = _cost(prob, U).sum() + (lam_def * C).sum()
    (g,) = torch.autograd.grad(L, Zg)
    xlo, xhi = _state_box(prob, Z[..., :nx], x0, xf)
    lo = torch.cat([xlo, Z.new_tensor(prob.u_lower).expand_as(U)], -1)
    hi = torch.cat([xhi, Z.new_tensor(prob.u_upper).expand_as(U)], -1)
    s = torch.cat([_var_scale(Z.new_tensor(prob.x_lower),
                              Z.new_tensor(prob.x_upper)),
                   _var_scale(Z.new_tensor(prob.u_lower),
                              Z.new_tensor(prob.u_upper))])
    pg = ((Z - torch.minimum(torch.maximum(Z - s * g, lo), hi)) / s).abs()
    if mu.shape[-1]:
        held = (mu > 0).any(-1)                                # [n, K]
        d = prob.pos_dims
        pg[..., :d] = torch.where(held[..., None],
                                  torch.zeros_like(pg[..., :d]), pg[..., :d])
    return pg.flatten(1).amax(1)


def polygon_depth(P, corners):
    """Depth of points P [..., 2] inside a simple polygon (even-odd rule):
    the distance to its nearest edge inside, 0 outside."""
    C = P.new_tensor(corners)
    a, b = C, torch.roll(C, -1, dims=0)                  # edges a -> b
    p = P[..., None, :]
    ax, ay, bx, by = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    px, py = p[..., 0], p[..., 1]
    straddle = (ay > py) != (by > py)
    dy = torch.where(by == ay, torch.ones_like(by), by - ay)
    cross_x = (bx - ax) * (py - ay) / dy + ax
    inside = ((straddle & (px < cross_x)).sum(-1) % 2) == 1
    ab = b - a
    t = (((p - a) * ab).sum(-1) / (ab * ab).sum(-1)).clamp(0.0, 1.0)
    dist = (p - (a + t[..., None] * ab)).norm(dim=-1).amin(-1)
    return torch.where(inside, dist, torch.zeros_like(dist))


def track_centre(track, tau):
    """The zone's centre at times tau [...] -> [..., D]: the waypoint
    schedule interpolated, its end segments extrapolated."""
    times = tau.new_tensor(track.times)
    pts = tau.new_tensor(track.points)
    j = ((times <= tau[..., None]).sum(-1) - 1).clamp(0, len(track.times) - 2)
    t0, t1 = times[j], times[j + 1]
    w = ((tau - t0) / (t1 - t0))[..., None]
    return pts[j] + w * (pts[j + 1] - pts[j])


def lane_numbers(prob: Problem, x0, xf, z, obj, shift):
    """Each of NUMBERS per lane, [n] float64, and ``finite`` [n]: the
    lane's returned z and objective are finite. ``x0``, ``xf`` [n, nx] are
    the inputs handed in, ``z`` [n, K * (nx + nu)] and ``obj`` [n] what
    came back, ``shift`` [n] the clock shift (seconds) of the lane's moving
    zones."""
    dd = torch.float64
    K, nx, nu = prob.nodes, prob.nx, prob.nu
    Z = z.to(dd).reshape(z.shape[0], K, -1)
    X, U = Z[..., :nx], Z[..., nx:nx + nu]
    x0, xf, obj = x0.to(dd), xf.to(dd), obj.to(dd)
    finite = torch.isfinite(Z).flatten(1).all(1) & torch.isfinite(obj)
    out = {"defect": (_defects(prob, X, U).abs()
                      / _defect_scale(prob, X)).flatten(1).amax(1),
           "bound": _bound_excess(prob, X, U, x0, xf)}
    pos = X[..., :2]
    depth = torch.zeros_like(obj)
    for poly in prob.polygons:
        depth = torch.maximum(depth, polygon_depth(pos, poly).amax(1))
    out["zone_depth"] = depth
    tdepth = torch.zeros_like(obj)
    tk = torch.arange(K, dtype=dd, device=Z.device) * prob.dt
    for tr in prob.tracks:
        c = track_centre(tr, tk[None, :] + shift.to(dd)[:, None])
        D = c.shape[-1]
        d2 = ((X[..., :D] - c) ** 2).sum(-1)
        g = (tr.radius ** 2 - d2) / tr.radius ** 2
        tdepth = torch.maximum(tdepth, g.clamp(min=0.0).amax(1))
    out["track_depth"] = tdepth
    J = _cost(prob, U)
    out["obj_gap"] = (obj - J).abs() / J.abs().clamp(min=1.0)
    out = {k: torch.nan_to_num(v, nan=float("inf")) for k, v in out.items()}
    return out, finite


class Tally:
    """The check's totals over the blocks of lanes handed to :meth:`add`."""

    def __init__(self, prob: Problem, limits: dict):
        self.prob = prob
        # a problem without static or moving zones has no depth to judge
        names = [k for k in NUMBERS
                 if (k != "zone_depth" or prob.polygons)
                 and (k != "track_depth" or prob.tracks)]
        self.limits = {k: float(limits[k]) for k in names}
        self.worst = {k: 0.0 for k in names}
        self.limits["stationarity"] = float(limits["stationarity"])
        self.residuals = []
        self.lanes = self.solved = self.rejected = self.nonfinite = 0
        self.failed = 0

    def add(self, x0, xf, z, obj, status, shift, lam_def, mu):
        """One block of lanes: the inputs ``x0``, ``xf`` [n, nx], what came
        back (``z`` [n, nz], ``obj``, ``status`` [n], the multipliers
        ``lam_def`` [n, N * nx] and ``mu`` [n, K * m]) and the zones' clock
        shift [n]."""
        nums, finite = lane_numbers(self.prob, x0, xf, z, obj, shift)
        status = status.to(nums["defect"].device)
        solved = status == SOLVED
        bad = torch.zeros_like(solved)
        for k in self.worst:
            v = nums[k]
            v = torch.where(solved, v, torch.zeros_like(v))
            self.worst[k] = max(self.worst[k], float(v.max()))
            bad |= v > self.limits[k]
        unflagged = ~finite & (status != DIVERGED)
        self.lanes += int(status.numel())
        self.solved += int(solved.sum())
        self.rejected += int((bad & solved).sum())
        self.nonfinite += int(unflagged.sum())
        # lanes the program got wrong, each once
        self.failed += int(((bad & solved) | unflagged).sum())
        if solved.any():
            p, dd, n = self.prob, torch.float64, int(solved.sum())
            Z = z[solved].to(dd).reshape(n, p.nodes, -1)
            r = stationarity(p, x0[solved].to(dd), xf[solved].to(dd), Z,
                             lam_def[solved].to(dd).reshape(n, p.nsteps, -1),
                             mu[solved].to(dd).reshape(n, p.nodes, -1))
            self.residuals.append(
                torch.nan_to_num(r, nan=float("inf")).cpu())

    def residual_quantiles(self, qs=(0.5, 0.9, 0.99, 1.0)) -> dict:
        """The solved lanes' stationarity residuals at quantiles ``qs``."""
        if not self.residuals:
            return {}
        r = torch.cat(self.residuals).numpy()
        return {q: float(np.quantile(r, q)) for q in qs}

    def compared(self) -> dict:
        """Each number compared beside its limit, the non-finite count
        (limit 0) last."""
        out = {k: {"value": self.worst[k], "limit": self.limits[k]}
               for k in self.worst}
        stat = self.residual_quantiles((STAT_QUANTILE,))
        out["stationarity"] = {"value": stat.get(STAT_QUANTILE, 0.0),
                               "limit": self.limits["stationarity"]}
        out["nonfinite"] = {"value": self.nonfinite, "limit": 0}
        return out

    def passed(self) -> bool:
        return (self.nonfinite == 0 and self.lanes > 0
                and all(c["value"] <= c["limit"]
                        for c in self.compared().values()))
