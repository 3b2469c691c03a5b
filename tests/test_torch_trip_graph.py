"""The solver loop captured as a CUDA graph (``solve/trip_graph.py``), on
the CPU.

A card captures the trip that ``trip_graph._Entry.step`` runs on its
static buffers and runs the loop as one graph launch, its stop test on
the card (or, on the replay route, replays the trip and reads the flag
on the host); here the same static path runs the step itself, without a
capture (``trip_graph.override("static")``, and ``"replay"``). Held:

* the static route's loop (the host's ``while`` on the trip's flag here)
  gives bitwise the per-trip loop's z, statuses, iterations, multipliers
  and penalties in exactly its trips, with no idle trip, and the replay
  route's stop test read ``lag`` trips late gives the same with exactly
  ``lag`` frozen trips past the stop, on uas_2d, the canonical OCP,
  chord steps, a Levenberg and a line-search variant, a side-branch box
  over ``SideData`` and the horizon-sharded SPIKE solve;
* one trip reads nothing on the host: no ``.item()`` or ``bool()`` of a
  tensor, no ``nonzero`` (a boolean mask), no tensor made from Python
  data, no copy to the CPU, under either KKT route;
* two MPC ticks with new x0 copied into one key's buffers equal the eager
  loop and agree with the JAX package's ``solve_batched`` on status,
  objective and violation at ``tests/test_torch_solver.py``'s
  tolerances (the cold solve and the ticks two programs holding that
  key's loop);
* the launch counters' per-graph tally, through a fake capture record.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu.models.tuned import _TUNED as J_TUNED
from etol_tpu.solve import al_sqp as jal
from _torch_parity import HostReads
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.models import tuned as ttuned
from etol_tpu_torch.ops import bt_cuda, cyclic_reduction, tally
from etol_tpu_torch.parallel import make_mesh
from etol_tpu_torch.parallel.solve_sharded import solve_horizon_sharded
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import side_branch, trip_graph

torch.set_num_threads(1)

KW = dict(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))
FIELDS = ("z", "obj", "status", "inner_iters", "outer_iters", "viol_eq",
          "viol_in", "grad_norm", "lam_def", "lam_eq", "mu", "rho")


def _uas(B=4, nsteps=12, seed=0):
    _, nlp = tproblems.uas_2d(**dict(KW, nsteps=nsteps))
    nlp = dataclasses.replace(nlp, obstacle_form="pieces")
    data, _ = tproblems.uas_2d(**dict(KW, nsteps=nsteps))[0].to_device(
        device="cpu")
    rng = np.random.default_rng(seed)
    lanes = tal.tree_map(lambda a: a[None].expand(
        (B,) + tuple(a.shape)).clone(), data)
    off = np.zeros((B, 3), np.float32)
    off[:, :2] = rng.uniform(-0.5, 0.5, size=(B, 2))
    return nlp, data, dataclasses.replace(
        lanes, x0=lanes.x0 + torch.from_numpy(off))


def _uas_case(**knobs):
    nlp, _, data = _uas()
    cfg = dataclasses.replace(ttuned.tuned_config("uas_2d", batch=4)[0],
                              **knobs)
    return lambda: tal.solve_batched(nlp, cfg, data)


def _ocp_case():
    vgp, nlp = tproblems.canonical_ocp_2d()
    data, _ = vgp.to_device(device="cpu")
    lanes = tal.tree_map(lambda a: a[None].expand(
        (2,) + tuple(a.shape)).clone(), data)
    lanes = dataclasses.replace(lanes, x0=lanes.x0 + torch.tensor(
        [[0.0, 0.0], [0.05, -0.05]]))
    cfg = tal.SolverConfig(max_total=10)
    return lambda: tal.solve_batched(nlp, cfg, lanes)


def _box_case():
    """One wave of the exact search's side-branch solve: ``SideData`` over
    expanded problem data, a side per (node, piece) on some lanes, and an
    integer box that tightens one control on another."""
    vgp, nlp = tproblems.canonical_mip_2d()
    data, _ = vgp.to_device(device="cpu")
    bnlp = side_branch.branch_nlp(nlp)
    d = nlp.dims
    K, w, B = d.nodes, d.node_width, 4
    P = data.obstacles.halfspaces.shape[0]
    T = data.tracks.xy.shape[0]
    selp = torch.full((B, K, P), -1, dtype=torch.int32)
    selp[1, K // 2, 0] = 0
    selp[2, K // 3:, 0] = 1
    sdata = side_branch.SideData(
        tal.tree_map(lambda a: a.expand((B,) + tuple(a.shape)), data),
        selp, torch.full((B, K, T), -1, dtype=torch.int32))
    big = float(np.finfo(np.float32).max / 4)
    lo = torch.full((B, K, w), -big)
    hi = torch.full((B, K, w), big)
    hi[3, :, d.nx] = 0.0
    z0 = nlp.initial_guess(data)[None].expand(B, -1).clone()
    lam0 = tal.init_multipliers(bnlp, sdata)
    cfg = tal.SolverConfig(max_total=12)
    return lambda: tal._solve_batch(bnlp, cfg, sdata, z0, lam0,
                                    torch.full((B,), cfg.rho0), (lo, hi))


def _spike_case():
    """The horizon-sharded SPIKE solve over 4 slabs of one device."""
    nlp, data, _ = _uas(nsteps=15)
    cfg = tal.SolverConfig(max_total=20)
    mesh = make_mesh(["cpu"] * 4, axis_names=("horizon",))
    return lambda: solve_horizon_sharded(nlp, cfg, data, mesh)


CASES = {
    "uas": lambda: _uas_case(),
    "uas_cr": lambda: _uas_case(kkt_solver="cr"),
    "ocp": _ocp_case,
    "chord": lambda: _uas_case(chord_steps=2),
    "levenberg": lambda: _uas_case(lm_rule="count", round_viol_patience=0),
    "line_search": lambda: _uas_case(ls_eta=0.85, ls_rule="best"),
    "box": _box_case,
    "spike": _spike_case,
}


@functools.lru_cache(maxsize=None)
def _eager(case):
    """The per-trip loop's result of ``case`` and its trips."""
    run = CASES[case]()
    before = trip_graph.COUNTS["eager_trips"]
    with trip_graph.override("eager"):
        res = run()
    return run, res, trip_graph.COUNTS["eager_trips"] - before


@pytest.mark.parametrize("case,lag", [
    ("uas", 0), ("uas", 1), ("uas", 3), ("ocp", 1), ("chord", 1),
    ("levenberg", 1), ("line_search", 1), ("box", 1), ("spike", 2)])
def test_lagged_stop_is_the_per_trip_loop(case, lag):
    run, ref, trips = _eager(case)
    assert trips > 0
    before = dict(trip_graph.COUNTS)
    with trip_graph.override("replay", lag):
        res = run()
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    # exactly lag frozen trips past the stop
    assert trip_graph.COUNTS["idle_trips"] - before["idle_trips"] == lag
    assert trip_graph.COUNTS["trips"] - before["trips"] == trips + lag
    assert trip_graph.COUNTS["eager_trips"] == before["eager_trips"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_is_the_per_trip_loop(case):
    run, ref, trips = _eager(case)
    before = dict(trip_graph.COUNTS)
    with trip_graph.override("static"):
        res = run()
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert trip_graph.COUNTS["trips"] - before["trips"] == trips
    assert trip_graph.COUNTS["idle_trips"] == before["idle_trips"]
    assert trip_graph.COUNTS["eager_trips"] == before["eager_trips"]


class _OneTrip(Exception):
    pass


@pytest.mark.parametrize("case", sorted(CASES))
def test_trip_reads_nothing_on_the_host(case, monkeypatch):
    """The first trip of the static path, as the graph captures it, under
    a dispatch mode that records host reads and transfers: none."""
    step = trip_graph._Entry.step
    seen = []

    def recorded(self):
        with HostReads() as mode:
            step(self)
        seen.append(mode.seen)
        raise _OneTrip

    monkeypatch.setattr(trip_graph._Entry, "step", recorded)
    run = CASES[case]()
    with trip_graph.override("static"), pytest.raises(_OneTrip):
        run()
    assert seen == [[]]


def test_mpc_ticks_on_static_buffers_match_eager_and_the_reference():
    """A cold solve and two MPC ticks with a new x0 each, through
    ``al_sqp.solve``: on the static path one key serves all three (the
    data copied in between), the results are bitwise the eager loop's,
    and they agree with the JAX package's ``solve_batched`` on status,
    objective (1e-3 relative) and violation."""
    jv, jnlp = jproblems.uas_2d(**KW)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    _, tnlp = tproblems.uas_2d(**KW)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    jdata, _ = jv.to_device()
    tdata = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu")
    overrides, _ = J_TUNED["uas_2d"]
    jcfg = jal.SolverConfig(kkt_solver="scan", **dict(overrides,
                                                      max_total=0))
    tcfg = dataclasses.replace(ttuned.tuned_config("uas_2d")[0],
                               max_total=0)

    def ticks(solve, data, shift):
        out = [solve(data, None)]
        for i in (1, 2):
            out.append(solve(shift(data, 0.01 * i), out[0]))
        return out

    def tsolve(data, prev):
        if prev is None:
            return tal.solve(tnlp, tcfg, data)
        return tal.solve(tnlp, tcfg, data, prev.z,
                         (prev.lam_def, prev.lam_eq, prev.mu), prev.rho)

    def tshift(data, dx):
        return dataclasses.replace(data, x0=data.x0 + dx)

    with trip_graph.override("eager"):
        eager = ticks(tsolve, tdata, tshift)
    trip_graph._CACHE.clear()
    with trip_graph.override("static"):
        static = ticks(tsolve, tdata, tshift)
    # one loop key for all three; the cold solve and the ticks are two
    # programs (a z0 or none), each holding that one loop
    entries = list(trip_graph._CACHE.values())
    (entry,) = [e for e in entries if isinstance(e, trip_graph._Entry)]
    programs = [e for e in entries if isinstance(e, trip_graph._Program)]
    assert len(programs) == 2 and all(p.parts == (entry,)
                                      for p in programs)
    for a, b in zip(eager, static):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f

    def jsolve(data, prev):
        lanes = jproblem.batch_tile(data, 1)
        if prev is None:
            return jal.solve_batched(jnlp, jcfg, lanes)
        return jal.solve_batched(jnlp, jcfg, lanes, prev.z,
                                 (prev.lam_def, prev.lam_eq, prev.mu),
                                 prev.rho)

    ref = ticks(jsolve, jdata,
                lambda d, dx: dataclasses.replace(d, x0=d.x0 + dx))
    for t, j in zip(static, ref):
        assert int(t.status) == int(j.status[0]) == 1
        np.testing.assert_allclose(float(t.obj), float(j.obj[0]), rtol=1e-3)
        for f in ("viol_eq", "viol_in"):
            assert float(getattr(t, f)) <= 1e-4
            assert float(getattr(j, f)[0]) <= 1e-4
    assert int(static[1].inner_iters) < int(static[0].inner_iters)


def test_loop_routes_from_its_arguments():
    """The CPU and a collective lane mask take the eager loop; a forced
    static route refuses a collective; the key leaves max_total out."""
    nlp, _, data = _uas()
    cfg = ttuned.tuned_config("uas_2d", batch=4)[0]
    F = tal._ALFuncs(nlp, cfg, data)
    z0 = tal.map_lanes(nlp.initial_guess, data)
    st = tal._start(F, cfg, z0, tal.init_multipliers(nlp, data))
    before = dict(trip_graph.COUNTS)
    out = trip_graph.loop(F, cfg, st, 3, agree=lambda a: a)
    assert trip_graph.COUNTS["eager_trips"] - before["eager_trips"] == 3
    assert trip_graph.COUNTS["trips"] == before["trips"]
    assert int(out["tot"].max()) == 3
    with trip_graph.override("static"), pytest.raises(ValueError):
        trip_graph.loop(F, cfg, st, 3, agree=lambda a: a)
    assert trip_graph._key(F, cfg) == trip_graph._key(
        F, dataclasses.replace(cfg, max_total=7))
    assert trip_graph._key(F, cfg) != trip_graph._key(
        F, dataclasses.replace(cfg, chord_steps=1))


def test_launch_tallies_of_a_captured_graph():
    """What a capture records stays out of the counters and is added at
    each replay, by (variant, K, w, batch) for the kernel and by (K, w,
    batch) for cyclic reduction's solves; records nest, the innermost
    taking the launches; ``tally.recording`` opens one on every tally."""
    bt_cuda.TALLY.clear()
    with bt_cuda.TALLY.recording() as outer:
        bt_cuda.TALLY.add(("smem", 51, 5, 8))
        with bt_cuda.TALLY.recording() as inner:
            bt_cuda.TALLY.add(("stream", 2048, 5, 1))
        bt_cuda.TALLY.add(("smem", 51, 5, 8))
    assert bt_cuda.TALLY.count == 0 and not bt_cuda.TALLY.by
    assert outer == {("smem", 51, 5, 8): 2}
    assert inner == {("stream", 2048, 5, 1): 1}
    bt_cuda.TALLY.replayed(outer, 3)
    bt_cuda.TALLY.replayed(inner)
    bt_cuda.TALLY.add(("smem", 51, 5, 8))
    assert bt_cuda.TALLY.count == 8
    assert bt_cuda.TALLY.by == {("smem", 51, 5, 8): 7,
                                ("stream", 2048, 5, 1): 1}
    assert bt_cuda.LAUNCHES_BY is bt_cuda.TALLY.by  # the harness's name

    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, 5, 3, 3)).astype(np.float32)
    D = torch.from_numpy(A @ A.transpose(0, 1, 3, 2) + 4 * np.eye(3))
    O = torch.from_numpy(0.2 * rng.normal(size=(2, 4, 3, 3))).float()
    r = torch.from_numpy(rng.normal(size=(2, 5, 3))).float()
    cyclic_reduction.TALLY.clear()
    with cyclic_reduction.TALLY.recording() as record:
        cyclic_reduction.solve_refined(D.float(), O, r)
    assert cyclic_reduction.TALLY.count == 0 and record == {(5, 3, 2): 1}
    cyclic_reduction.TALLY.replayed(record, 4)
    assert cyclic_reduction.TALLY.count == 4

    bt_cuda.TALLY.clear()
    cyclic_reduction.TALLY.clear()
    with tally.recording() as records:
        bt_cuda.TALLY.add(("smem", 33, 4, 1))
        cyclic_reduction.solve_refined(D.float(), O, r)
    assert {t for t, _ in records} == set(tally.ALL)
    assert {t: rec for t, rec in records if rec} == {
        bt_cuda.TALLY: {("smem", 33, 4, 1): 1},
        cyclic_reduction.TALLY: {(5, 3, 2): 1}}
    assert not bt_cuda.TALLY.by and not cyclic_reduction.TALLY.by
    tally.replayed(records, 3)
    assert bt_cuda.TALLY.by == {("smem", 33, 4, 1): 3}
    assert cyclic_reduction.TALLY.by == {(5, 3, 2): 3}
