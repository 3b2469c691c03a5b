"""The solver loop as a device-side while and the staged solve as one
program (``solve/trip_graph.py``, ``ops/graph_loop.py``), on the CPU.

A card runs each loop as one graph launch (a while node around the
captured trip, its stop test a kernel) and the whole staged solve as one
captured program, its loops added to the capture between the glue.
Here ``trip_graph.override("static")`` runs the same program in the same
order without capturing it: the glue eagerly on the program's buffers,
each loop on its own entry as the host's ``while`` on the entry's flag.
Held:

* on uas_2d N=50 at B=8 with stages ((4, 40), (2, 80)) the static
  program gives bitwise the eager staged solve's result and stage trips,
  and agrees with the JAX package's ``solve_batched_staged`` on status,
  objective and violation at ``tests/test_torch_solver.py``'s
  tolerances;
* every glue segment (the prologue, each stage's gather and start, the
  last merge) reads nothing on the host;
* the loops the program holds for the bench's stages at B=2048;
* a second call of a key copies its new arguments in (the budget too),
  and the key's fields make new programs;
* the graph-loop library refuses to build without ``nvcc``, to take a
  flag off the card and to add a loop outside a capture, and nothing
  falls back;
* the device loops' counters are read when a count is asked for, each
  gain once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu.models.tuned import _TUNED as J_TUNED
from etol_tpu.solve import al_sqp as jal
from _torch_parity import HostReads, uas_batch
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.models import tuned as ttuned
from etol_tpu_torch.ops import bt_cuda, graph_loop, hs_coupling, tally
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import trip_graph

torch.set_num_threads(1)

B = 8
STAGES = ((4, 40), (2, 80))
# phase 1's budget: under the registry's 33 every lane of this batch
# solves in phase 1, and the stages would continue solved lanes only
PHASE1_BUDGET = 16
FIELDS = [f.name for f in dataclasses.fields(tal.SolveResult)]


@pytest.fixture(scope="module")
def bench_batch():
    """Both packages' bench problem (uas_2d N=50, pieces containment) on
    B problems whose starts and goals are scattered by a seeded numpy
    draw, the JAX package's straight-line z0, and the registry config
    with phase 1's budget cut to PHASE1_BUDGET in both."""
    jv, jnlp = jproblems.uas_2d(nsteps=50)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    _, tnlp = tproblems.uas_2d(nsteps=50)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    jd, _ = jv.to_device()
    rng = np.random.default_rng(0)
    off = np.zeros((2, B, 3), np.float32)
    off[:, :, :2] = rng.uniform(-0.5, 0.5, size=(2, B, 2))
    jb = jproblem.batch_tile(jd, B)
    jb = dataclasses.replace(jb, x0=jnp.asarray(off[0]),
                             xf=jb.xf + jnp.asarray(off[1]))
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu")
    overrides, _ = J_TUNED["uas_2d"]
    jcfg = jal.SolverConfig(kkt_solver="scan", **dict(
        overrides, max_total=PHASE1_BUDGET))
    tcfg = dataclasses.replace(ttuned.tuned_config("uas_2d", batch=B)[0],
                               max_total=PHASE1_BUDGET)
    z0 = np.array(jax.vmap(jnlp.initial_guess)(jb))
    return jnlp, jb, jcfg, tnlp, tb, tcfg, z0


def _staged(tnlp, tcfg, tb, z0, route, stages=STAGES):
    with trip_graph.override(route):
        return tal.solve_batched_staged(tnlp, tcfg, tb, torch.from_numpy(z0),
                                        stages, return_stage_trips=True)


def test_static_program_is_the_eager_staged_solve_and_the_reference(
        bench_batch):
    jnlp, jb, jcfg, tnlp, tb, tcfg, z0 = bench_batch
    eager, eager_trips = _staged(tnlp, tcfg, tb, z0, "eager")
    trip_graph._CACHE.clear()
    before = dict(trip_graph.COUNTS)
    res, trips = _staged(tnlp, tcfg, tb, z0, "static")
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(eager, f)), f
    assert trips == eager_trips and len(trips) == 1 + len(STAGES)
    # the stages ran: phase 1 left lanes unsolved
    assert trips[0] == PHASE1_BUDGET and trips[1] > 0
    # one program holding an entry a loop, at the planned batch sizes; no
    # eager trip and no idle one, and every trip of the loops counted
    (program,) = _programs()
    assert [e.F.lb.shape[0] for e in program.parts] == [B, 4, 2]
    assert set(program.parts) <= set(trip_graph._CACHE.values())
    c = {k: trip_graph.COUNTS[k] - before[k] for k in before}
    assert (c["programs"], c["eager_trips"], c["idle_trips"]) == (1, 0, 0)
    assert c["trips"] >= sum(trips)

    jres, jtrips = jal.solve_batched_staged(
        jnlp, jcfg, jb, jnp.asarray(z0), STAGES, return_stage_trips=True)
    jok = np.asarray(jres.status) == 1
    tok = res.status.numpy() == 1
    assert tok.sum() >= B // 2, res.status
    # the same lanes SOLVED, with at most one lane of difference
    assert (jok != tok).sum() <= 1, (jres.status, res.status)
    both = jok & tok
    np.testing.assert_allclose(res.obj.numpy()[both],
                               np.asarray(jres.obj)[both], rtol=1e-2)
    assert len(jtrips) == len(trips)
    for f in ("viol_eq", "viol_in"):
        assert float(getattr(res, f)[torch.from_numpy(tok)].max()) <= 1e-4
        assert float(np.asarray(getattr(jres, f))[jok].max()) <= 1e-4


def _programs():
    return [e for e in trip_graph._CACHE.values()
            if isinstance(e, trip_graph._Program)]


def _small(B=4, budget=4):
    """uas_2d at 12 steps, B lanes, a few trips a loop."""
    _, _, tnlp, tb = uas_batch(B=B)
    tcfg = dataclasses.replace(ttuned.tuned_config("uas_2d", batch=B)[0],
                               max_total=budget)
    z0 = tal.map_lanes(tnlp.initial_guess, tb).numpy()
    return tnlp, tcfg, tb, z0


def test_glue_reads_nothing_on_the_host(monkeypatch):
    """A key's second call on the static route, as the card captures it:
    the glue before each loop, between the loops and after the last,
    each under a dispatch mode that records host reads and transfers
    (the loops themselves are the host's ``while`` here, and the trip is
    held to the same in ``test_torch_trip_graph.py``): none."""
    tnlp, tcfg, tb, z0 = _small()
    stages = ((2, 3), (1, 3))
    _staged(tnlp, tcfg, tb, z0, "static", stages)  # makes the entries
    modes = []
    step = trip_graph._Program.step
    loop = trip_graph._Entry.loop

    def begin():
        modes.append(HostReads())
        modes[-1].__enter__()

    def recorded(self):
        begin()
        try:
            return step(self)
        finally:
            modes[-1].__exit__(None, None, None)

    def paused(self):
        modes[-1].__exit__(None, None, None)
        loop(self)
        begin()

    monkeypatch.setattr(trip_graph._Program, "step", recorded)
    monkeypatch.setattr(trip_graph._Entry, "loop", paused)
    _staged(tnlp, tcfg, tb, z0, "static", stages)
    assert len(modes) == 4  # the prologue, two stages' glue, the merge
    assert [m.seen for m in modes] == [[], [], [], []]


def test_plan_of_the_bench_stages(monkeypatch):
    """At B=2048 the bench's stages give a program whose loops, in the
    order the capture adds them, run over 2048 lanes and then each
    stage's M = min(count, B), with the glue before, between and after
    them; a count above B takes the whole batch, on phase 1's entry. (The
    loops run no trip here: only the program's shape is held.)"""
    _, stages = ttuned.tuned_config("uas_2d", batch=2048)
    assert stages == ((1024, 16), (256, 32), (64, 96))
    ran = []
    monkeypatch.setattr(trip_graph._Entry, "loop",
                        lambda self: ran.append(self.F.lb.shape[0]))
    for B, stages, want in ((2048, stages, [2048, 1024, 256, 64]),
                            (8, ((16, 5), (2, 5)), [8, 8, 2])):
        tnlp, tcfg, tb, z0 = _small(B=B)
        trip_graph._CACHE.clear()
        ran.clear()
        _staged(tnlp, tcfg, tb, z0, "static", stages)
        (program,) = _programs()
        assert ran == want
        # a stage over the whole batch is phase 1's key: one entry
        assert [e.F.lb.shape[0] for e in program.parts] == sorted(
            set(want), reverse=True)


def test_a_key_takes_new_arguments_and_its_fields_make_new_programs(
        monkeypatch):
    """Two calls of one key (new starts, a new phase-1 budget: max_total
    is a buffer, not a field of the key) are each bitwise the eager staged
    solve; other stages, a cold start without z0 and another config field
    are other keys."""
    tnlp, tcfg, tb, z0 = _small()
    stages = ((2, 3),)
    trip_graph._CACHE.clear()
    monkeypatch.setattr(trip_graph, "MAX_ENTRIES", 32)  # room for every key
    moved = dataclasses.replace(tb, x0=tb.x0 + 0.05)
    for data, budget in ((tb, 4), (moved, 6)):
        cfg = dataclasses.replace(tcfg, max_total=budget)
        with trip_graph.override("eager"):
            ref, ref_trips = tal.solve_batched_staged(
                tnlp, cfg, data, torch.from_numpy(z0), stages,
                return_stage_trips=True)
        res, trips = _staged(tnlp, cfg, data, z0, "static", stages)
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(ref, f)), f
        assert trips == ref_trips and trips[0] == budget
    assert len(_programs()) == 1
    _staged(tnlp, tcfg, tb, z0, "static", ((2, 3), (1, 2)))
    with trip_graph.override("static"):
        tal.solve_batched_staged(tnlp, tcfg, tb, None, stages)
        tal.solve_batched_staged(
            tnlp, dataclasses.replace(tcfg, ls_grid=8), tb,
            torch.from_numpy(z0), stages)
    assert len(_programs()) == 4


def test_graph_loop_refuses_without_nvcc_and_off_the_card(monkeypatch,
                                                          tmp_path):
    """No nvcc: the build raises, and no library is loaded to fall back
    on; a loop's flag and counters must lie on the card, and a loop is
    added only to a capture."""
    monkeypatch.setattr(graph_loop, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(bt_cuda, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        graph_loop.build()
    assert graph_loop._LIB is None and graph_loop.VERSIONS is None
    with pytest.raises(ValueError, match="flag"):
        graph_loop.insert(0, torch.zeros((), dtype=torch.bool),
                          torch.zeros(2, dtype=torch.int64))
    # the plain version: the host's while, tested before the first step
    flag = torch.tensor(False)
    assert graph_loop.plain(lambda: None, flag) == 0
    left = [3]

    def step():
        left[0] -= 1
        flag.fill_(left[0] > 0)

    flag.fill_(True)
    assert graph_loop.plain(step, flag) == 3


def test_override_routes():
    """The three routes; a lag only with the replay route."""
    for route in ("eager", "static", "replay"):
        with trip_graph.override(route):
            assert trip_graph.route_of(torch.device("cpu")) == route
    with trip_graph.override("replay", 2):
        assert trip_graph._OVERRIDE["lag"] == 2
    with pytest.raises(ValueError):
        with trip_graph.override("static", 1):
            pass
    with pytest.raises(ValueError):
        with trip_graph.override("graph"):
            pass
    assert trip_graph.route_of(torch.device("cpu")) == "eager"


def test_settle_reads_each_loops_counters_once():
    """A loop's device counters (here on the CPU, set by hand as the
    condition kernel sets them) are read only by ``settle``: each gain
    goes once into the trips, the launch tallies and graph_loop's counts,
    and a second read adds nothing."""
    tnlp, tcfg, tb, z0 = _small()
    F = tal._ALFuncs(tnlp, tcfg, tb)
    st = tal._start(F, tcfg, torch.from_numpy(z0),
                    tal.init_multipliers(tnlp, tb))
    entry = trip_graph._Entry(F, tcfg, st)
    # a uas_2d trip's launches: a KKT solve and a step coupling
    entry.records = [(bt_cuda.TALLY, {("smem", 12, 5, 4): 1}),
                     (hs_coupling.TALLY, {(12, 5, 4): 1})]
    saved = (dict(trip_graph.COUNTS), graph_loop.LAUNCHES,
             graph_loop.TRIPS)
    saved_by = {t: dict(t.by) for t in tally.ALL}
    try:
        entry.counts.copy_(torch.tensor([7, 5]))
        trip_graph._UNREAD[entry] = None
        trip_graph.settle()
        entry.counts.copy_(torch.tensor([10, 7]))
        trip_graph._UNREAD[entry] = None
        trip_graph.settle()
        trip_graph.settle()
        assert trip_graph.COUNTS["trips"] - saved[0]["trips"] == 7
        gained = {t: t.count - sum(saved_by[t].values()) for t in tally.ALL}
        assert gained[bt_cuda.TALLY] == gained[hs_coupling.TALLY] == 7
        assert sum(gained.values()) == 14  # no other kernel's tally
        assert (graph_loop.LAUNCHES - saved[1],
                graph_loop.TRIPS - saved[2]) == (10, 7)
        assert entry.read == (10, 7) and not trip_graph._UNREAD
    finally:
        trip_graph.COUNTS.update(saved[0])
        graph_loop.LAUNCHES, graph_loop.TRIPS = saved[1:]
        for t, by in saved_by.items():
            t.clear()
            t.by.update(by)
