"""The port's span recorder (``utils/profiling.py``), its spans at the
layers' boundaries and the loops' stamps, on the CPU:

* spans nest, each with its parent's and its root's id, and a span's own
  time is its time less its children's;
* off, ``span`` is the shared no-op and nothing is recorded;
* ``phase_report`` sums the same records by name;
* a static-route MPC tick and a rescued batch of 8 through the facade open
  the spans of their layers, with their parents and byte counts, and give
  bitwise the results they give with the recorder off;
* ``settle`` reads each insertion's stamp slot and a traced trip's phases
  once, into ``LAST_READ``;
* the benchmark's readers of the spans and stamps on a hand-made context,
  and the traced run's split of the card's idle gaps, whose labels sum to
  the gaps.
"""
import dataclasses
import time
import types

import pytest
import torch

from etol_tpu_torch import TrajectoryOptimizer
from etol_tpu_torch.models import dynamics, problems
from etol_tpu_torch.ops import graph_loop
from etol_tpu_torch.solve import al_sqp, trip_graph
from etol_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    profiling.clear()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.clear()


def test_spans_nest_with_parents_roots_and_self_time(recorder):
    with profiling.span("a", lanes=4) as a:
        with profiling.span("b") as b:
            with profiling.span("c", bytes=12) as c:
                time.sleep(0.002)
        with profiling.span("d") as d:
            d.set(elements=3)
    with profiling.span("e") as e:
        pass
    recs = {r.name: r for r in profiling.records()}
    assert [r.name for r in profiling.records()] == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id,
                                                         a.id)
    assert {r.root for r in (a, b, c, d)} == {a.id} and e.root == e.id
    assert recs["a"].attrs == {"lanes": 4} and recs["c"].attrs == {
        "bytes": 12} and recs["d"].attrs == {"elements": 3}
    own = profiling.self_ns(profiling.records())
    assert own[a.id] == a.ns - b.ns - d.ns and own[c.id] == c.ns
    assert own[b.id] == b.ns - c.ns and c.ns >= 2_000_000
    s = profiling.summary(profiling.records())
    assert s["a"]["calls"] == 1 and s["a"]["self_s"] == own[a.id] / 1e9
    assert profiling.records(since=e.start_ns) == [e]
    profiling.clear()
    assert not profiling.records()


def test_off_is_the_shared_noop_and_records_nothing():
    profiling.disable()
    profiling.clear()
    sp = profiling.span("x", card="cpu", lanes=1)
    assert sp is profiling._OFF and profiling.span("y") is sp
    with sp as inner:
        inner.set(bytes=1)
    assert profiling.sizes(torch.ones(3)) == {}
    assert not profiling.records() and not profiling.enabled()


def test_phase_report_sums_the_spans():
    profiling.clear()
    with profiling.phase_timer("work", result={"a": torch.ones(2)}):
        time.sleep(0.002)
    profiling.enable()
    try:
        with profiling.span("outer"):
            with profiling.phase_timer("work"):
                pass
    finally:
        profiling.disable()
    rep = profiling.phase_report()
    assert set(rep) == {"work", "outer"}
    assert rep["work"]["calls"] == 2 and rep["work"]["total_s"] >= 0.002
    assert rep["work"]["mean_ms"] == 1e3 * rep["work"]["total_s"] / 2
    assert profiling.phase_report() == {}


def _facade():
    topt = TrajectoryOptimizer(al_sqp.SolverConfig(max_total=8),
                               device="cpu")
    topt.load_configs("etol_tpu_torch/configs/ocp_2d_ex1.xml")
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    return topt


def _tick_and_rescue(topt):
    """A cold solve, one MPC tick and a rescued batch of 8 (2 lanes x 2
    starts rescued)."""
    with trip_graph.override("static"):
        cold = topt.solve()
        tick = topt.mpc_step(cold.z.reshape(topt.dims.nodes, -1)[1, :2])
        x0 = topt.data.x0[None] + torch.linspace(-0.1, 0.0, 8)[:, None]
        batch = topt.solve_batch(x0=x0, rescue_lanes=2)
    return cold, tick, batch


def _bits(res):
    return [t.numpy().tobytes() for t in dataclasses.astuple(res)]


def test_facade_spans_and_results_unchanged(recorder):
    profiling.disable()
    plain = _tick_and_rescue(_facade())
    profiling.enable()
    traced = _tick_and_rescue(_facade())
    profiling.disable()
    for a, b in zip(plain, traced):
        assert _bits(a) == _bits(b)

    recs = profiling.records()
    by_id = {r.id: r for r in recs}

    def parent(r):
        return by_id[r.parent].name if r.parent else None

    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["facade.solve", "facade.mpc_step",
                                       "facade.solve_batch"]
    for root in roots:
        kids = [r for r in recs if r.root == root.id]
        names = [r.name for r in kids]
        assert names.count("program") == 1 and "facade.sync" in names
        prog = next(r for r in kids if r.name == "program")
        parts = [r for r in kids if r.parent == prog.id]
        assert [r.name for r in parts] == [
            "program.key", "program.copy_in", "program.launch",
            "program.clone_out"]
        assert all(parent(r) == root.name
                   for r in kids if r.name in ("program", "facade.sync",
                                               "facade.prepare"))
        assert parts[1].attrs["bytes"] > 0 and parts[3].attrs["bytes"] > 0
    mpc, batch = roots[1], roots[2]
    assert by_id[mpc.id + 1].name == "facade.prepare"
    prog = {r.root: r for r in recs if r.name == "program"}
    assert prog[mpc.id].attrs["body"] == "_single_steps"
    assert prog[batch.id].attrs["body"] == "_rescue_steps"
    (draws,) = [r for r in recs if r.name == "solve.draws"]
    # the bumps [2, 4, 2] and the shooting units [2, 256, 1, 2] and
    # [2, 256, 32, 2] of the 2 rescued lanes (4 starts, 32 steps),
    # float32, drawn on the host
    assert parent(draws) == "facade.solve_batch"
    n = 2 * 4 * 2 + 2 * 256 * 2 + 2 * 256 * 32 * 2
    assert draws.attrs == {"device": "cpu", "elements": n, "bytes": 4 * n}
    copy_in = [r for r in recs if r.name == "program.copy_in"
               and r.root == batch.id][0]
    assert copy_in.attrs["bytes"] >= 4 * n


def test_settle_reads_slots_once():
    """A program's stamp slots, set by hand as the card sets them, each
    gain read once by settle into LAST_READ."""
    prog = trip_graph._Program(lambda a: a, ((torch.ones(2),), {}))
    lanes = types.SimpleNamespace(F=types.SimpleNamespace(
        lb=torch.zeros(64, 3, 2)))
    prog.loops = (lanes, lanes)
    prog.slots = torch.zeros((2, graph_loop.SLOT), dtype=torch.int64)
    saved = dict(trip_graph.COUNTS)
    try:
        # two runs: position 0 ran 5 trips in 700 ns, 420 of them in its
        # line searches, position 1 none
        prog.slots[0] = torch.tensor([99, 700, 5, 2, 420])
        prog.slots[1] = torch.tensor([99, 40, 0, 2, 0])
        trip_graph._UNREAD[prog] = None
        trip_graph.settle()
        loops = trip_graph.LAST_READ["loops"]
        assert [(r["position"], r["lanes"], r["runs"], r["trips"], r["ns"],
                 r["ls_ns"]) for r in loops] == [(0, 64, 2, 5, 700, 420),
                                                 (1, 64, 2, 0, 40, 0)]
        assert loops[0]["body"] == "<lambda>"
        prog.slots[0] = torch.tensor([120, 1000, 8, 3, 600])
        trip_graph._UNREAD[prog] = None
        trip_graph.settle()
        assert [(r["position"], r["runs"], r["trips"], r["ns"], r["ls_ns"])
                for r in trip_graph.LAST_READ["loops"]] == [
                    (0, 1, 3, 300, 180)]
        trip_graph.settle()  # nothing unread: the last read stays
        assert len(trip_graph.LAST_READ["loops"]) == 1
    finally:
        trip_graph.COUNTS.update(saved)


def test_settle_reads_an_entrys_phases(monkeypatch):
    tv, tn = problems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    bd = al_sqp.tree_map(lambda a: a[None].expand((2,) + a.shape), td)
    cfg = al_sqp.SolverConfig(max_total=2)
    F = al_sqp._ALFuncs(tn, cfg, bd)
    st = al_sqp._start(F, cfg, al_sqp.map_lanes(tn.initial_guess, bd),
                       al_sqp.init_multipliers(tn, bd))
    entry = trip_graph._Entry(F, cfg, st)
    assert entry.phases is None and entry.F.stamp is None  # not traced
    assert entry.ls is None and entry.F.ls_stamp is None  # not on a card
    entry.phases = torch.zeros(1 + len(al_sqp.PHASES), dtype=torch.int64)
    saved = (dict(trip_graph.COUNTS), graph_loop.LAUNCHES, graph_loop.TRIPS)
    monkeypatch.setattr(entry, "_replayed", lambda n: None)
    try:
        entry.counts.copy_(torch.tensor([4, 3]))
        entry.slot.copy_(torch.tensor([7, 900, 3, 1, 310]))
        entry.phases.copy_(torch.tensor([5, 100, 200, 50, 300, 150]))
        trip_graph._UNREAD[entry] = None
        trip_graph.settle()
        (loop,) = trip_graph.LAST_READ["loops"]
        assert (loop["body"], loop["position"], loop["lanes"],
                loop["trips"], loop["ns"], loop["ls_ns"]) == (
                    "loop", 0, 2, 3, 900, 310)
        (ph,) = trip_graph.LAST_READ["phases"]
        assert ph == dict(lanes=2, trips=3, ns=dict(
            gradient=100, assembly=200, kkt=50, line_search=300,
            update=150))
    finally:
        trip_graph.COUNTS.update(saved[0])
        graph_loop.LAUNCHES, graph_loop.TRIPS = saved[1:]


@pytest.mark.parametrize("chord_steps", [0, 1])
def test_line_search_stamps_bracket_each_line_search(chord_steps):
    """A trip's line-search stamps (-1 at its start, 0 at its end) sit
    between the kkt's close and the line search's close of the phase
    stamps, once for the full step and once for each chord step, and
    change nothing the trip computes."""
    tv, tn = problems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    bd = al_sqp.tree_map(lambda a: a[None].expand((2,) + a.shape), td)
    cfg = al_sqp.SolverConfig(max_total=4, chord_steps=chord_steps)
    F = al_sqp._ALFuncs(tn, cfg, bd)
    st = al_sqp._start(F, cfg, al_sqp.map_lanes(tn.initial_guess, bd),
                       al_sqp.init_multipliers(tn, bd))
    plain, stamped = (trip_graph._Entry(F, cfg, st) for _ in range(2))
    calls = []
    stamped.F.stamp = lambda ph: calls.append(("phase", ph))
    stamped.F.ls_stamp = lambda ph: calls.append(("ls", ph))
    plain.step()
    stamped.step()
    for k, v in plain.st.items():
        assert torch.equal(v, stamped.st[k]), k
    ls = [i for i, c in enumerate(calls) if c[0] == "ls"]
    assert [calls[i] for i in ls] == [("ls", -1), ("ls", 0)] * (
        1 + chord_steps)
    for a, b in zip(ls[::2], ls[1::2]):
        assert b == a + 1 and calls[b + 1] == ("phase", 3)
    assert calls[ls[0] - 1] == ("phase", 2)


def _ctx(fleet=True, trips=8, ops=2, seconds=1.0, solve_ms=(5.0, 7.0)):
    return types.SimpleNamespace(
        fleet=fleet, traced=True, trips=trips,
        window=types.SimpleNamespace(ops=[0] * ops, seconds=seconds),
        span_ms=lambda name: list(solve_ms) if name == "perfbench.solve"
        else [])


def test_stamp_readers_on_a_hand_made_context(monkeypatch):
    from perfbench import harness

    read = dict(loops=[
        dict(body="_staged_steps", position=0, lanes=2048, runs=2, trips=6,
             ns=6_000_000),
        dict(body="_staged_steps", position=1, lanes=256, runs=2, trips=2,
             ns=2_000_000)],
        phases=[dict(lanes=2048, trips=6, ns=dict(
            gradient=1, assembly=4, kkt=1, line_search=3, update=1))])
    monkeypatch.setattr(trip_graph, "LAST_READ", read)
    ctx = _ctx()
    # (5 + 7 ms of launches - 8 ms of loops) / 2 batches
    assert harness.read_metric("glue_card_ms.fleet", ctx) == \
        pytest.approx(2.0)
    assert harness.read_metric("later_loops_pct.fleet", ctx) == \
        pytest.approx(25.0)
    assert harness.read_metric("trip_assembly_pct.fleet", ctx) == \
        pytest.approx(40.0)
    assert harness.read_metric("trip_linesearch_pct.fleet", ctx) == \
        pytest.approx(30.0)
    # trips that are not the window's, or a tick cell: nothing to read
    for c in (_ctx(trips=9), _ctx(fleet=False)):
        for name in ("glue_card_ms.fleet", "later_loops_pct.fleet",
                     "trip_assembly_pct.fleet"):
            assert harness.read_metric(name, c) is None
    monkeypatch.setattr(trip_graph, "LAST_READ", dict(
        loops=read["loops"], phases=[]))
    assert harness.read_metric("trip_assembly_pct.fleet", ctx) is None


def test_span_readers_on_a_hand_made_context(recorder):
    from perfbench import harness

    profiling.mark()
    for _ in range(3):
        with profiling.span("facade.mpc_step"):
            with profiling.span("facade.prepare"):
                time.sleep(0.001)
            with profiling.span("program"):
                with profiling.span("program.key"):
                    time.sleep(0.001)
                with profiling.span("program.launch"):
                    time.sleep(0.003)
            with profiling.span("facade.sync"):
                time.sleep(0.002)
    with profiling.span("facade.solve_batch"):
        with profiling.span("solve.draws"):
            time.sleep(0.002)
    with profiling.span("solve.draws"):  # a seeds' draws: not the rescue's
        time.sleep(0.02)
    recs = profiling.records()
    ticks = [r for r in recs if r.name == "facade.mpc_step"]
    by = {n: [r for r in recs if r.name == n] for n in
          ("program", "program.launch", "facade.sync")}
    host = sorted((p.ns - ln.ns) / 1e6
                  for p, ln in zip(by["program"], by["program.launch"]))
    own = sorted((t.ns - p.ns - s.ns) / 1e6 for t, p, s in zip(
        ticks, by["program"], by["facade.sync"]))
    mpc = _ctx(fleet=False, seconds=10.0)
    assert harness.read_metric("program_host_ms.mpc", mpc) == \
        pytest.approx(host[1])
    assert harness.read_metric("facade_host_ms.mpc", mpc) == \
        pytest.approx(own[1])
    draws = [r for r in recs if r.name == "solve.draws"][0]
    assert harness.read_metric("rescue_draws_ms", _ctx(seconds=10.0)) == \
        pytest.approx(draws.ns / 1e6)
    assert harness.read_metric("rescue_draws_ms", mpc) is None
    profiling.mark()  # a later window: nothing of it recorded yet
    assert harness.read_metric("program_host_ms.mpc", mpc) is None


def test_idle_split_keeps_each_gaps_sum():
    from perfbench.trace import busy_and_gaps
    from perfbench.traced import idle_split

    def rec(i, parent, name, a, b):
        return types.SimpleNamespace(id=i, parent=parent, name=name,
                                     start_ns=int(a * 1e6),
                                     end_ns=int(b * 1e6))

    origin = 1_000_000_000
    recs = [rec(1, None, "perfbench.tick", 1001, 1009),
            rec(2, 1, "program.key", 1002, 1003),
            rec(3, 1, "program.launch", 1003, 1006),
            rec(4, None, "settle", 1014, 1015)]
    intervals = [("perfbench.tick", 0, 3.5, 5.5),
                 ("perfbench.episode", 1, 12.0, 13.0),
                 ("perfbench.tick", 2, 12.5, 16.0)]
    split = idle_split(intervals, recs, 20e6, origin)
    _, gaps = busy_and_gaps(intervals, 20.0)
    for label, ms in gaps.items():
        assert sum(s for k, s in split.items()
                   if k.startswith(label + ":")) == pytest.approx(ms / 1e3)
    assert split == pytest.approx({
        "before perfbench.tick: outside any span": 0.001,
        "before perfbench.tick: perfbench.tick": 0.001,
        "before perfbench.tick: program.key": 0.001,
        "before perfbench.tick: program.launch": 0.0005,
        "before perfbench.episode: program.launch": 0.0005,
        "before perfbench.episode: perfbench.tick": 0.003,
        "before perfbench.episode: outside any span": 0.003,
        "after the last launch: outside any span": 0.004})
    assert sum(split.values()) == pytest.approx(0.014)
