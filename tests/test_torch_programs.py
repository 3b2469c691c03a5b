"""The reference's remaining jitted solves as one program each
(``solve/trip_graph.py``'s :func:`run`), on the CPU.

A card runs ``solve`` (the MPC tick), ``solve_batched`` (and every wave
of the exact search, a ``_solve_batch`` with a box), ``solve_multistart``
and ``solve_batched_rescue`` each as one captured program: the prologue,
each loop's while node, the glue and the result in one graph launch,
the draws made before it. Here ``trip_graph.override("static")`` runs the
same program without capturing it. Held, on ``canonical_ocp_2d`` at a
few trips a loop:

* each body's static route is bitwise its eager route, on a key's first
  call and on a second call with other data copied in;
* each body reads nothing on the host between its first copy in and its
  result (the loops, the host's ``while`` here, paused);
* the fields of a key that must make a new program do, and a budget
  (``max_total``) or another KKT solver made the same way do not;
* a program called inside another's body raises;
* two programs (a cold solve and its warm ticks) hold one loop's entry:
  the cache drops that entry only after them, and its counters are read
  once;
* the rescue always runs its phase 2, as the JAX package's does, and on a
  batch that phase 1 solves whole gives the JAX package's statuses,
  objectives and violations.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import HostReads, carry_data
from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.core.types import Status
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.ops import (bt_cuda, graph_loop, hs_coupling,
                                ls_candidates, tally)
from etol_tpu_torch.parallel import make_mesh
from etol_tpu_torch.parallel.kkt import make_solver
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import side_branch, trip_graph

torch.set_num_threads(1)

# a few trips a loop: the routes are compared, not the optimum
CFG = tal.SolverConfig(max_total=6)
B = 4
OFF = torch.tensor([[0.0, 0.0], [-0.05, -0.05], [-0.1, 0.1],
                    [-0.02, 0.03]])


@functools.lru_cache(maxsize=None)
def _ocp():
    """The problem, made once: a key holds its NLP by value."""
    tv, tn = tproblems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    return tn, td


def _moved(td, shift):
    return dataclasses.replace(td, x0=td.x0 + shift)


def _lanes(td, n=B):
    bd = tal.tree_map(lambda a: a[None].expand((n,) + tuple(a.shape)), td)
    return dataclasses.replace(bd, x0=bd.x0 + OFF[:n])


def _solve_cold(shift):
    tn, td = _ocp()
    return tal.solve(tn, CFG, _moved(td, shift))


@functools.lru_cache(maxsize=None)
def _cold():
    tn, td = _ocp()
    with trip_graph.override("eager"):
        return tal.solve(tn, CFG, td)


def _solve_warm(shift):
    """An MPC tick: a warm start from a cold solve's result, its penalty
    handed in as a Python float (brought to the device outside the
    program)."""
    tn, td = _ocp()
    prev = _cold()
    return tal.solve(tn, CFG, _moved(td, 0.01 + shift), prev.z,
                     (prev.lam_def, prev.lam_eq, prev.mu), float(prev.rho))


def _wave(shift):
    """One wave of the exact search: ``SideData`` over the expanded
    problem (a piece's side on one lane, the track's on another),
    multipliers and penalties handed in, and a box that pins one control
    on a lane."""
    tn, td = _ocp()
    bnlp = side_branch.branch_nlp(tn)
    d = tn.dims
    K, w = d.nodes, d.node_width
    P = td.obstacles.halfspaces.shape[0]
    T = td.tracks.xy.shape[0]
    selp = torch.full((B, K, P), -1, dtype=torch.int32)
    selp[1, K // 2, 0] = 0
    selt = torch.full((B, K, T), -1, dtype=torch.int32)
    selt[2, : K // 3, 0] = 2
    sdata = side_branch.SideData(
        tal.tree_map(lambda a: a.expand((B,) + tuple(a.shape)),
                     _moved(td, shift)), selp, selt)
    big = float(np.finfo(np.float32).max / 4)
    lo = torch.full((B, K, w), -big)
    hi = torch.full((B, K, w), big)
    hi[3, :, d.nx] = 0.0
    z0 = tn.initial_guess(td)[None].expand(B, -1).clone()
    lam0 = tal.init_multipliers(bnlp, sdata)
    return tal._solve_batch(bnlp, CFG, sdata, z0, lam0,
                            torch.full((B,), CFG.rho0), (lo, hi))


def _multistart(shift):
    tn, td = _ocp()
    return tal.solve_multistart(tn, CFG, _moved(td, shift), 3,
                                torch.Generator().manual_seed(0),
                                shooting_samples=16)


def _rescue(shift):
    tn, td = _ocp()
    return tal.solve_batched_rescue(
        tn, CFG, _lanes(_moved(td, shift)), torch.Generator().manual_seed(0),
        rescue_lanes=2, n_rescue_starts=2,
        rescue_cfg=dataclasses.replace(CFG, max_total=8),
        shooting_samples=16)


CASES = {"solve_cold": _solve_cold, "solve_warm": _solve_warm,
         "wave": _wave, "multistart": _multistart, "rescue": _rescue}


def _equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def _programs():
    return [e for e in trip_graph._CACHE.values()
            if isinstance(e, trip_graph._Program)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_route_is_the_eager_route(case):
    run = CASES[case]
    with trip_graph.override("eager"):
        eager = [run(0.0), run(0.03)]
    assert not torch.equal(eager[0].z, eager[1].z)
    trip_graph._CACHE.clear()
    before = dict(trip_graph.COUNTS)
    with trip_graph.override("static"):
        static = [run(0.0), run(0.03)]
    for a, b in zip(eager, static):
        assert _equal(a, b)
    # one program for both calls, its loops on static buffers
    (program,) = _programs()
    assert program.parts
    assert trip_graph.COUNTS["programs"] - before["programs"] == 2
    assert trip_graph.COUNTS["eager_trips"] == before["eager_trips"]


class _Recorder(HostReads):
    """:class:`HostReads` that also records the tensor methods that copy
    to the host without a dispatched op on the CPU."""

    METHODS = ("tolist", "numpy", "item", "cpu", "__bool__")

    def __enter__(self):
        self.saved = {m: getattr(torch.Tensor, m) for m in self.METHODS}
        for m, f in self.saved.items():
            def rec(t, *a, _m=m, _f=f, **kw):
                self.seen.append(f"Tensor.{_m}")
                return _f(t, *a, **kw)
            setattr(torch.Tensor, m, rec)
        return super().__enter__()

    def __exit__(self, *exc):
        for m, f in self.saved.items():
            setattr(torch.Tensor, m, f)
        return super().__exit__(*exc)


def _reads_of_a_second_call(run, monkeypatch):
    """What each segment of a key's second static call records, the body
    from its first copy in to its result, split at the loops (paused: the
    host's ``while`` here; the trip is held to the same in
    ``test_torch_trip_graph.py``)."""
    with trip_graph.override("static"):
        run()  # makes the keys
    modes = []
    step = trip_graph._Program.step
    loop = trip_graph._Entry.loop

    def begin():
        modes.append(_Recorder())
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
    with trip_graph.override("static"):
        run()
    return [m.seen for m in modes]


@pytest.mark.parametrize("case", sorted(CASES))
def test_body_reads_nothing_on_the_host(case, monkeypatch):
    """A key's second call on the static route, as a card captures it:
    no segment between its loops reads the host."""
    loops = 2 if case == "rescue" else 1
    seen = _reads_of_a_second_call(lambda: CASES[case](0.0), monkeypatch)
    assert seen == [[]] * (loops + 1)


def _model(name):
    """(nlp, data) of a model the card solves, at a small size."""
    from etol_tpu_torch.models import fleet
    from etol_tpu_torch.parallel import dryrun

    if name == "horizon":
        nlp, data, _ = dryrun.horizon_problem(15, device="cpu")
        return nlp, data
    vgp, nlp = {
        "uas_2d": lambda: tproblems.uas_2d(nsteps=12, dt=0.4,
                                           xf=(4.0, 3.0, 0.0)),
        "mip_2d": tproblems.canonical_mip_2d,
        "double_integrator_2d": lambda: tproblems.double_integrator_2d(8),
        "point_mass_3d": lambda: tproblems.point_mass_3d(8),
        "fixed_wing_3dof": lambda: tproblems.fixed_wing_3dof(8),
        "composed_exact_demo": tproblems.composed_exact_demo,
        "fleet_2d": lambda: fleet.fleet_2d(2, nsteps=8),
    }[name]()
    if name == "uas_2d":
        nlp = dataclasses.replace(nlp, obstacle_form="pieces")
    data, _ = vgp.to_device(device="cpu")
    return nlp, data


@pytest.mark.parametrize("name", [
    "uas_2d", "mip_2d", "double_integrator_2d", "point_mass_3d",
    "fixed_wing_3dof", "composed_exact_demo", "fleet_2d", "horizon"])
def test_every_models_solve_reads_nothing_on_the_host(name, monkeypatch):
    """The prologue and the result of ``solve`` (bounds, scales, track
    centres, the guess, the multipliers' sizes, the score) for each model
    the card solves, which the program captures with the loop: no host
    read."""
    nlp, data = _model(name)
    cfg = tal.SolverConfig(max_total=1)
    seen = _reads_of_a_second_call(lambda: tal.solve(nlp, cfg, data),
                                   monkeypatch)
    assert seen == [[], []]


def test_key_fields_make_new_programs(monkeypatch):
    """A cold solve and a warm one, another config field, other sizes, a
    box, more starts, a shooting seed or not and more rescued lanes each
    make a program of their own; a budget (max_total: a buffer) and a new
    SPIKE solver made the same way (its graph_key) do not."""
    monkeypatch.setattr(trip_graph, "MAX_ENTRIES", 64)
    tn, td = _ocp()
    bd = _lanes(td, 2)
    gen = torch.Generator
    trip_graph._CACHE.clear()
    calls = [
        (lambda: tal.solve(tn, CFG, td), 1),
        (lambda: tal.solve(tn, dataclasses.replace(CFG, max_total=4), td),
         1),
        (lambda: tal.solve(tn, CFG, td, tn.initial_guess(td)), 2),
        (lambda: tal.solve(tn, dataclasses.replace(CFG, ls_grid=8), td), 3),
        (lambda: tal.solve_batched(tn, CFG, bd), 4),
        (lambda: tal.solve_batched(tn, CFG, _lanes(td, 3)), 5),
        (lambda: tal._solve_batch(
            tn, CFG, bd, None, None,
            box=(bd.x0.new_full((2, tn.dims.nodes, tn.dims.node_width), -9.),
                 bd.x0.new_full((2, tn.dims.nodes, tn.dims.node_width), 9.))),
         6),
        (lambda: tal.solve_multistart(tn, CFG, td, 2, gen().manual_seed(0)),
         7),
        (lambda: tal.solve_multistart(tn, CFG, td, 2, gen().manual_seed(1)),
         7),
        (lambda: tal.solve_multistart(tn, CFG, td, 3, gen().manual_seed(0)),
         8),
        (lambda: tal.solve_multistart(tn, CFG, td, 2, gen().manual_seed(0),
                                      shooting_samples=8), 9),
        (lambda: tal.solve_batched_rescue(tn, CFG, bd, rescue_lanes=1,
                                          n_rescue_starts=2,
                                          shooting_samples=8), 10),
        (lambda: tal.solve_batched_rescue(tn, CFG, bd, rescue_lanes=2,
                                          n_rescue_starts=2,
                                          shooting_samples=8), 11),
    ]
    with trip_graph.override("static"):
        for i, (call, programs) in enumerate(calls):
            call()
            assert len(_programs()) == programs, i
    # a KKT solver is keyed by what it computes
    hv, hn = tproblems.uas_2d(nsteps=15, dt=0.4, xf=(4.0, 3.0, 0.0))
    hd, _ = hv.to_device(device="cpu")
    mesh = make_mesh(["cpu"] * 4, axis_names=("horizon",))
    lanes = tal.tree_map(lambda a: a[None], hd)
    with trip_graph.override("static"):
        for _ in range(2):
            tal._solve_batch(hn, CFG, lanes, None, None,
                             kkt_solve=make_solver(mesh, "horizon", "scan"))
    assert len(_programs()) == 12


def test_program_inside_a_body_raises():
    """A body calls the steps directly: a program called from inside one
    raises, on its first run and on later ones, and opens nothing."""
    tn, td = _ocp()

    def body(x):
        return trip_graph.program(lambda y: y + 1.0, x)

    trip_graph._CACHE.clear()
    with trip_graph.override("static"):
        for _ in range(2):
            with pytest.raises(RuntimeError, match="inside another"):
                trip_graph.program(body, td.x0)
    assert trip_graph._PARTS is None
    assert len(trip_graph._CACHE) == 1  # the outer key alone
    # eagerly, nothing nests
    assert torch.equal(trip_graph.program(body, td.x0), td.x0 + 1.0)


def test_two_programs_hold_one_loop(monkeypatch):
    """The MPC's cold-solve key and its tick key hold one loop's entry.
    On a card a replay touches its program's key only, so the entry ages
    behind both: the cache drops the programs first and the entry after
    them, never a loop a cached program runs; the entry's counters,
    marked unread by both programs' launches, are read once."""
    tn, td = _ocp()
    trip_graph._CACHE.clear()
    with trip_graph.override("static"):
        cold = tal.solve(tn, CFG, td)
        tal.solve(tn, CFG, td, cold.z, (cold.lam_def, cold.lam_eq, cold.mu),
                  cold.rho)
    programs = _programs()
    (entry,) = [e for e in trip_graph._CACHE.values()
                if isinstance(e, trip_graph._Entry)]
    assert len(programs) == 2 and all(p.parts == (entry,) for p in programs)
    for key in [k for k, e in trip_graph._CACHE.items() if e in programs]:
        trip_graph._CACHE.move_to_end(key)  # replayed: the entry is oldest
    assert next(iter(trip_graph._CACHE.values())) is entry

    # the OCP is trapezoidal: its trips launch no step coupling kernel,
    # and on a card the line search's two candidate kernels
    entry.records = [(bt_cuda.TALLY, {("smem", 33, 4, 1): 1}),
                     (ls_candidates.TALLY, {(33, 4, 24, 1): 2})]
    saved = (dict(trip_graph.COUNTS), graph_loop.LAUNCHES, graph_loop.TRIPS)
    saved_by = {t: dict(t.by) for t in tally.ALL}
    try:
        entry.counts.copy_(torch.tensor([entry.read[0] + 6,
                                         entry.read[1] + 5]))
        for p in programs:  # what each program's replay marks
            trip_graph._UNREAD.update(dict.fromkeys(p.parts))
        trip_graph.settle()
        trip_graph.settle()
        assert trip_graph.COUNTS["trips"] - saved[0]["trips"] == 5
        gained = {t: t.count - sum(saved_by[t].values()) for t in tally.ALL}
        assert gained[bt_cuda.TALLY] == 5
        assert gained[hs_coupling.TALLY] == 0
        assert gained[ls_candidates.TALLY] == 10
        assert ls_candidates.TALLY.by[(33, 4, 24, 1)] - saved_by[
            ls_candidates.TALLY].get((33, 4, 24, 1), 0) == 10
        assert sum(gained.values()) == 15  # no other kernel's tally
        assert (graph_loop.LAUNCHES - saved[1],
                graph_loop.TRIPS - saved[2]) == (6, 5)
    finally:
        trip_graph.COUNTS.update(saved[0])
        graph_loop.LAUNCHES, graph_loop.TRIPS = saved[1:]
        for t, by in saved_by.items():
            t.clear()
            t.by.update(by)

    monkeypatch.setattr(trip_graph, "MAX_ENTRIES", 2)
    trip_graph._evict(td.x0.device)
    left = list(trip_graph._CACHE.values())
    assert len(left) == 2 and entry in left
    for p in left:
        assert set(p.parts) <= set(left)
    trip_graph._CACHE.clear()


def test_rescue_of_a_solved_batch_is_the_references():
    """Two lanes that phase 1 solves whole: the port's rescue (phase 2
    run, nothing adopted) and the JAX package's give the same statuses,
    and objectives and violations within 1e-4."""
    jv, jn = jproblems.canonical_ocp_2d()
    tv, tn = tproblems.canonical_ocp_2d()
    jd, td = carry_data(jv, tv)
    # (-0.05, -0.05), both packages SOLVED, stops 3.0e-4 apart in phase 1
    # alone (within tests/test_torch_multistart.py's 1e-3 relative): a
    # stopping point at tol_stat, not the rescue; these two lanes agree to
    # 3e-6 there
    off = np.array([[0.0, 0.0], [-0.1, 0.1]], np.float32)
    jb = jproblem.batch_tile(jd, 2)
    jb = dataclasses.replace(jb, x0=jb.x0 + off)
    tb = tal.tree_map(lambda a: a[None].expand((2,) + tuple(a.shape)), td)
    tb = dataclasses.replace(tb, x0=tb.x0 + torch.from_numpy(off))
    kw = dict(n_rescue_starts=2, shooting_samples=16)
    jres = jal.solve_batched_rescue(jn, jal.SolverConfig(), jb, **kw)
    with trip_graph.override("static"):
        tres = tal.solve_batched_rescue(tn, tal.SolverConfig(), tb, **kw)
    assert tres.status.tolist() == np.asarray(jres.status).tolist() == [
        int(Status.SOLVED)] * 2
    for f in ("obj", "viol_eq", "viol_in"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)), atol=1e-4,
                                   err_msg=f)
    # phase 1 alone gives the same: the rescue adopted nothing
    with trip_graph.override("eager"):
        res1 = tal.solve_batched(tn, tal.SolverConfig(), tb)
    assert _equal(res1, tres)
