"""The output check on planted faults: a SOLVED lane with a node inside a
zone, a non-finite lane, a defect, a bound, multipliers that do not make
the answer stationary; an honest unsolved lane is no fault."""
import math

import pytest
import torch

from perfbench.reference import check
from perfbench.reference.problem import Problem, Track, load_config, problem_of

LIMITS = {"defect": 2e-4, "bound": 1e-5, "zone_depth": 2e-4,
          "track_depth": 2e-4, "obj_gap": 1e-5, "stationarity": 1e-6}


def _problem(**kw):
    base = dict(nsteps=10, dt=0.5, x0=(0.0, 0.0), xf=(5.0, 0.0),
                xtol=(0.0, 0.0), x_lower=(-1.0, -3.0), x_upper=(7.0, 3.0),
                u_lower=(-2.0, -2.0), u_upper=(2.0, 2.0),
                dynamics="single_integrator", scheme="trapezoidal",
                cost_weights=(1.0, 1.0),
                polygons=(((2.0, 1.0), (3.0, 1.0), (3.0, 2.0), (2.0, 2.0)),),
                tracks=(Track(0.5, (0.0, 10.0), ((2.5, -2.0), (2.5, -1.0))),))
    base.update(kw)
    return Problem(**base)


def _straight(prob, n=4):
    """n lanes flying straight from x0 to xf at constant speed: every
    number 0 (the line passes below the box and above the moving zone; it
    is the single integrator's optimum, its defects' multipliers
    2 u s, with s the defects' scale)."""
    K = prob.nodes
    s = torch.linspace(0, 1, K, dtype=torch.float64)[:, None]
    x0, xf = torch.tensor(prob.x0, dtype=torch.float64), torch.tensor(
        prob.xf, dtype=torch.float64)
    X = x0 + s * (xf - x0)
    U = ((xf - x0) / (prob.nsteps * prob.dt)).expand(K, -1)
    z = torch.cat([X, U], -1).reshape(1, -1).repeat(n, 1)
    J = float(((U ** 2).sum(-1) * torch.tensor(
        [0.5] + [1.0] * (K - 2) + [0.5], dtype=torch.float64)).sum()
              * prob.dt)
    ins = (x0.repeat(n, 1), xf.repeat(n, 1))
    return ins, z, torch.full((n,), J, dtype=torch.float64)


def _multipliers(prob, z, weights=(1.0, 1.0)):
    """The straight lanes' multipliers: lam_def [n, N * nx] of the line's
    optimum under the cost ``weights``, mu [n, K] 0 (a zone row a node)."""
    n, K = z.shape[0], prob.nodes
    U = z.view(n, K, -1)[:, :-1, prob.nx:]
    s = check._defect_scale(prob, z)
    lam = 2.0 * U * z.new_tensor(weights) * s
    return lam.reshape(n, -1), z.new_zeros((n, K))


def _tally(prob, z, obj, status, ins, mult=None):
    t = check.Tally(prob, LIMITS)
    t.add(*ins, z, obj, status, torch.zeros(z.shape[0], dtype=torch.float64),
          *(mult or _multipliers(prob, z)))
    return t


def test_sound_lanes_pass():
    prob = _problem()
    ins, z, obj = _straight(prob)
    t = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins)
    assert t.passed() and t.failed == 0 and t.solved == 4
    assert all(v["value"] <= 1e-12 for v in t.compared().values())


def _node(prob, z, lane, k):
    w = prob.nx + prob.nu
    return z[lane].view(prob.nodes, w)[k]


def test_solved_lane_with_a_node_inside_a_zone_fails():
    prob = _problem()
    ins, z, obj = _straight(prob)
    _node(prob, z, 2, 5)[:2] = torch.tensor([2.5, 1.5], dtype=z.dtype)
    t = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins)
    assert not t.passed() and t.failed == 1
    assert t.compared()["zone_depth"]["value"] == pytest.approx(0.5)


def test_node_inside_a_moving_zone_fails_at_its_time():
    prob = _problem()
    ins, z, obj = _straight(prob)
    # node 4 (t = 2 s): the zone's centre is at (2.5, -1.8)
    _node(prob, z, 0, 4)[:2] = torch.tensor([2.5, -1.8], dtype=z.dtype)
    t = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins)
    assert t.compared()["track_depth"]["value"] == pytest.approx(1.0)
    assert not t.passed() and t.failed == 1
    # shifted 4 s along its clock, the zone has moved on: only the defects
    # of the moved node remain
    t2 = check.Tally(prob, LIMITS)
    t2.add(*ins, z, obj, torch.ones(4, dtype=torch.int32),
           torch.full((4,), 4.0, dtype=torch.float64),
           *_multipliers(prob, z))
    assert t2.compared()["track_depth"]["value"] < 0.5


def test_non_finite_lane_fails_unless_flagged_diverged():
    prob = _problem()
    ins, z, obj = _straight(prob)
    z[1, 3] = math.nan
    t = _tally(prob, z, obj, torch.tensor([1, 2, 1, 1], dtype=torch.int32),
               ins)
    assert t.nonfinite == 1 and t.failed == 1 and not t.passed()
    t = _tally(prob, z, obj, torch.tensor([1, 4, 1, 1], dtype=torch.int32),
               ins)
    assert t.nonfinite == 0 and t.failed == 0 and t.passed()


def test_unsolved_lane_is_not_judged_and_defects_and_bounds_are():
    prob = _problem()
    ins, z, obj = _straight(prob)
    _node(prob, z, 0, 5)[1] += 0.3          # a defect, unsolved: honest
    t = _tally(prob, z, obj, torch.tensor([2, 1, 1, 1], dtype=torch.int32),
               ins)
    assert t.passed() and t.solved == 3
    t = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins)
    assert t.compared()["defect"]["value"] == pytest.approx(0.3 / 3.0)
    assert not t.passed()
    ins2, z2, obj2 = _straight(prob)
    z2[3, 0] += 1e-3                         # node 0 off the start
    t = _tally(prob, z2, obj2, torch.ones(4, dtype=torch.int32), ins2)
    assert t.compared()["bound"]["value"] == pytest.approx(1e-3)
    assert not t.passed()
    obj2[0] += 1.0                           # a wrong objective
    t = _tally(prob, z2, obj2, torch.ones(4, dtype=torch.int32), ins2)
    assert t.rejected == 2 and t.compared()["obj_gap"]["value"] > 0.1


def test_answer_optimal_for_another_cost_is_not_stationary():
    """The multipliers of the line under another cost leave the gradient of
    the configuration's Lagrangian; the median lane decides."""
    prob = _problem()
    ins, z, obj = _straight(prob)
    sound = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins)
    assert sound.compared()["stationarity"]["value"] < 1e-12
    lam, mu = _multipliers(prob, z, weights=(4.0, 1.0))
    lam[:1] = _multipliers(prob, z)[0][:1]      # one lane sound
    t = _tally(prob, z, obj, torch.ones(4, dtype=torch.int32), ins,
               (lam, mu))
    # d L / d u0 at an inner node: 2 dt u0 - dt (4 * 2 u0) = -6 dt u0,
    # projected: u0 = 1 may rise to its bound 2 alone, (2 - 1) / s, s = 2
    u0 = float(z.view(4, prob.nodes, -1)[0, 1, prob.nx])
    assert u0 == pytest.approx(1.0) and 6 * prob.dt * u0 > 0.5
    assert t.compared()["stationarity"]["value"] == pytest.approx(0.5)
    assert not t.passed() and t.failed == 0


def test_a_held_zone_row_frees_its_nodes_position():
    """Where a zone row's multiplier is positive, the position's gradient is
    the zone's to balance: it is left out, the controls' is not."""
    prob = _problem()
    ins, z, obj = _straight(prob)
    lam, mu = _multipliers(prob, z)
    d = 0.4
    lam.view(4, prob.nsteps, -1)[1, 5, 0] += d  # step 5's first defect
    cs = float(check._defect_scale(prob, z)[0])

    def residual():
        return check.stationarity(
            prob, ins[0], ins[1], z.view(4, prob.nodes, -1),
            lam.view(4, prob.nsteps, -1), mu.view(4, prob.nodes, 1))

    # nodes 5 and 6's position: -+ d / cs; u_5 and u_6: dt / 2 of it
    assert residual()[1] == pytest.approx(d / cs)
    mu[1, 5:7] = 1.0
    r = residual()
    assert r[1] == pytest.approx(prob.dt / 2 * d / cs) and r[0] < 1e-12


def test_hermite_simpson_unicycle_defect_of_an_exact_arc_is_small():
    """A constant-speed, constant-turn arc is the unicycle's exact motion:
    its Hermite-Simpson defects are the scheme's truncation error alone."""
    prob = problem_of(load_config("uas2d_n50"))
    K, dt, v, om = prob.nodes, prob.dt, 1.0, 0.1
    t = torch.arange(K, dtype=torch.float64) * dt
    X = torch.stack([v / om * torch.sin(om * t),
                     v / om * (1 - torch.cos(om * t)), om * t], -1)
    U = torch.tensor([v, om], dtype=torch.float64).expand(K, 2)
    d = check._defects(prob, X[None], U[None])
    assert d.abs().max() < 1e-6


def test_configurations_read_the_problems_they_name():
    uas = problem_of(load_config("uas2d_n50"))
    assert (uas.nodes, uas.nx, uas.nu, len(uas.polygons)) == (51, 3, 2, 3)
    ocp = problem_of(load_config("ocp2d_ex1"))
    assert (ocp.nodes, ocp.nx, ocp.nu, ocp.dt) == (33, 2, 2, 0.5)
    assert [len(p) for p in ocp.polygons] == [5, 4]
    assert [tr.radius for tr in ocp.tracks] == [0.5, 0.5]
