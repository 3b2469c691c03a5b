"""The benchmark's ``pm3d_n40`` configuration (the scaling ladder's 3-D
moving-obstacle rung, ``perfbench/configs/pm3d_n40.json`` and its ETOL XML)
and its cell ``pm3d_fleet_cold``, on the CPU:

* the XML read by the port is bitwise ``problems.point_mass_3d(nsteps=40)``,
  and the entry (``perfbench/entries/ladder.py``) builds that problem, its
  cost and the registry's solver; the output check's own reading of the
  files gives the same numbers;
* on seeded random nodes in float64 the port's defects, running cost and
  sphere rows agree with the check's;
* a fleet of 8 lanes solved through the entry passes the check under the
  configuration's limits, and its bfloat16 control and a lane moved into
  a sphere do not;
* the cell's metric readers give their base readers' values, and the
  line-search share reads nothing where no loop stamped its line search.
"""
import dataclasses
import types

import pytest
import torch

from etol_tpu_torch.core.problem import tree_flatten_with_paths
from etol_tpu_torch.core.xml_io import load_configs
from etol_tpu_torch.models import problems, tuned
from etol_tpu_torch.solve import trip_graph
from perfbench import draws, entries, harness
from perfbench.reference import check
from perfbench.reference.problem import load_config, problem_of
from perfbench.trace import Spans

torch.set_num_threads(2)

CELL = "pm3d_fleet_cold"
SEED = 2 ** 31 + 2222
CONFIG = load_config("pm3d_n40")


def _xml():
    return harness.bench_path(harness.ROOT, "configs",
                              CONFIG["problem"]["xml"])


def _entry(batch=8):
    t = draws.load_traffic("fleet_cold_pm3d")
    t["batch"] = batch
    return entries.load(CONFIG["entry"])(
        CONFIG, t, torch.device("cpu"), None,
        harness.bench_path(harness.ROOT, "configs"))


def _assert_same_data(a, b):
    fa, fb = tree_flatten_with_paths(a), tree_flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_the_xml_is_the_ladders_rung_and_the_checks():
    ref_vgp, ref_nlp = problems.point_mass_3d(nsteps=40)
    vgp = load_configs(_xml())
    assert vgp.dims() == ref_vgp.dims()
    want, _ = ref_vgp.to_device(device="cpu")
    _assert_same_data(vgp.to_device(device="cpu")[0], want)
    e = _entry()
    _assert_same_data(e.single, want)
    # the entry's problem: the rung's dynamics, scheme and cost, op for op
    assert e.nlp.dynamics is ref_nlp.dynamics
    assert (e.nlp.scheme, e.nlp.obstacle_form, e.nlp.dims) == (
        ref_nlp.scheme, ref_nlp.obstacle_form, ref_nlp.dims)
    u = torch.randn((5, 3), generator=torch.Generator().manual_seed(SEED))
    for row in u:
        assert torch.equal(e.nlp.running_cost(None, row, 0.0, None),
                           ref_nlp.running_cost(None, row, 0.0, None))
    # the registry's solver and its stages at the cell's batch
    cfg, stages = tuned.tuned_config("point_mass_3d", batch=1024)
    big = _entry(batch=1024)
    assert (big.cfg, big.stages) == (cfg, stages)
    assert stages == ((512, 16), (128, 32), (32, 96))
    # the check reads the same numbers from the same files
    prob = problem_of(CONFIG)
    assert (prob.nsteps, prob.dt, prob.pos_dims) == (40, 0.25, 3)
    assert (list(prob.x0), list(prob.xf), list(prob.xtol)) == (
        ref_vgp.x0, ref_vgp.xf, ref_vgp.xtol)
    assert (list(prob.x_lower), list(prob.x_upper), list(prob.u_lower),
            list(prob.u_upper)) == (ref_vgp.xlower, ref_vgp.xupper,
                                    ref_vgp.ulower, ref_vgp.uupper)
    assert prob.polygons == () and len(prob.tracks) == len(ref_vgp.tracks)
    for tr, rt in zip(prob.tracks, ref_vgp.tracks):
        assert (tr.radius, list(tr.times)) == (rt.radius, rt.times)
        assert [list(p) for p in tr.points] == rt.points


def test_port_and_check_agree_on_random_nodes():
    """float64 on both sides; the tolerances are a few ulps of the
    numbers compared, since each side sums the same terms in its own
    order (the defects' 0.5 dt (f0 + f1), the objective's node sums over
    vmap against the check's weighted sum, the squared distances)."""
    e = _entry()
    nlp, prob = e.nlp, problem_of(CONFIG)
    data, _ = load_configs(_xml()).to_device(dtype=torch.float64,
                                             device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    n, K = 6, prob.nodes
    X = torch.rand((n, K, 3), generator=gen, dtype=torch.float64) * \
        torch.tensor([6.0, 5.0, 2.5], dtype=torch.float64)
    U = torch.randn((n, K, 3), generator=gen, dtype=torch.float64)
    z = torch.cat([X, U], -1).reshape(n, -1)
    port_def = torch.stack([nlp.step_defects(zz, data) for zz in z])
    assert torch.allclose(port_def, check._defects(prob, X, U), rtol=0,
                          atol=1e-14)
    port_cost = torch.stack([nlp.objective(zz, data) for zz in z])
    assert torch.allclose(port_cost, check._cost(prob, U), rtol=1e-14,
                          atol=0)
    # the sphere rows: the port's centres and ball values (its last T
    # inequality rows) against the check's centres and depth
    tk = torch.arange(K, dtype=torch.float64) * prob.dt
    centres = nlp.track_center_table(data)                  # [K, T, 3]
    for i, tr in enumerate(prob.tracks):
        assert torch.allclose(centres[:, i], check.track_centre(tr, tk),
                              rtol=0, atol=1e-14)
    T = len(prob.tracks)
    # nodes placed near the spheres' centres, so that the depths are not 0
    Xin = torch.stack([check.track_centre(tr, tk) for tr in prob.tracks]
                      )[torch.arange(K) % T, torch.arange(K)]
    Xin = Xin + 0.3 * (X / X.norm(dim=-1, keepdim=True))
    zin = torch.cat([Xin, U], -1).reshape(n, -1)
    for zz, xx in ((z, X), (zin, Xin)):
        rows = torch.stack([nlp.node_ineqs(r, data)[:, -T:] for r in zz])
        port_depth = rows.clamp(min=0.0).flatten(1).amax(1)
        nums, finite = check.lane_numbers(
            prob, xx[:, 0], xx[:, -1], zz, check._cost(prob, U),
            torch.zeros(n, dtype=torch.float64))
        assert finite.all()
        assert torch.allclose(port_depth, nums["track_depth"], rtol=0,
                              atol=1e-13)
    assert (nums["track_depth"] > 0.1).all()


@pytest.fixture(scope="module")
def fleet():
    """One cold batch of 8 lanes of the cell, solved through its entry on
    the CPU: (the cell, its window)."""
    t = draws.load_traffic("fleet_cold_pm3d")
    t["batch"] = 8
    cell = harness.Cell(CELL, "cpu", traffic=t)
    cell.build()
    op, _ = cell.fleet_cold(SEED, "batch", 0, Spans(False))
    return cell, harness.Window(ops=[op], lanes=8, seconds=1.0)


def test_a_solved_fleet_passes_and_its_faults_do_not(fleet):
    cell, w = fleet
    tally, _ = cell.check(w)
    assert tally.solved == 8 and tally.failed == 0 and tally.passed()
    control, _ = cell.check(w, control=True)
    assert not control.passed()
    assert any(c["value"] > c["limit"]
               for c in control.compared().values())
    # lane 3 moved whole (so its defects stay) onto the sphere it comes
    # nearest: its node there at the sphere's centre
    op = w.ops[0]
    prob = cell.problem
    Z = op.z.reshape(8, prob.nodes, -1).clone()
    tk = torch.arange(prob.nodes, dtype=torch.float64) * prob.dt
    c = torch.stack([check.track_centre(tr, tk) for tr in prob.tracks])
    d = (Z[3, :, :3].double()[None] - c).norm(dim=-1)       # [T, K]
    i, k = divmod(int(d.argmin()), prob.nodes)
    Z[3, :, :3] += (c[i, k] - Z[3, k, :3].double()).float()
    moved = harness.Window(ops=[dataclasses.replace(
        op, z=Z.reshape(8, -1))], lanes=8)
    bad, _ = cell.check(moved)
    cmp = bad.compared()
    assert not bad.passed() and bad.failed == 1
    assert cmp["track_depth"]["value"] > cmp["track_depth"]["limit"]
    assert cmp["defect"]["value"] <= cmp["defect"]["limit"]


def _ctx(monkeypatch, loops):
    read = dict(loops=loops, phases=[])
    monkeypatch.setattr(trip_graph, "LAST_READ", read)
    tally = types.SimpleNamespace(lanes=1024, solved=1000, rejected=2)
    ctx = types.SimpleNamespace(
        fleet=True, traced=True, trips=sum(r["trips"] for r in loops),
        tally=tally, launches={("smem", 41, 6, 1024): 42},
        window=types.SimpleNamespace(ops=[0] * 4, seconds=2.0),
        span_ms=lambda name: [30.0, 34.0] if name == "perfbench.solve"
        else [])
    ctx.metric = lambda name: harness.read_metric(name, ctx)
    return ctx


def test_the_cell_reports_the_fleets_rate_and_its_own_layers():
    bench = harness.load_benchmark()
    untraced = [m["name"] for m in
                harness.cell_metrics(bench, "pm3d_fleet_cold", False)]
    traced = [m["name"] for m in
              harness.cell_metrics(bench, "pm3d_fleet_cold", True)]
    assert untraced == ["solved_solves_per_s", "setup_s"]
    assert traced == ["trips_per_batch.pm3d", "trip_ms.pm3d",
                      "unsolved_pct.pm3d", "kkt_roofline.pm3d",
                      "linesearch_pct.pm3d"]


@pytest.mark.parametrize("name,base", [
    ("trips_per_batch.pm3d", "trips_per_batch"),
    ("trip_ms.pm3d", "trip_ms.fleet"),
    ("unsolved_pct.pm3d", "unsolved_pct.fleet"),
    ("kkt_roofline.pm3d", "kkt_roofline"),
])
def test_the_cells_readers_are_their_bases(name, base, monkeypatch):
    from perfbench import roofline

    monkeypatch.setattr(roofline, "kernel_ms", lambda K, w, B: 0.05)
    ctx = _ctx(monkeypatch, [dict(body="_staged_steps", position=0,
                                  lanes=1024, runs=4, trips=40,
                                  ns=40_000_000, ls_ns=24_000_000)])
    want = harness.read_metric(base, ctx)
    assert want is not None and harness.read_metric(name, ctx) == want


def test_the_line_search_share(fleet, monkeypatch):
    loops = [dict(body="_staged_steps", position=0, lanes=1024, runs=2,
                  trips=80, ns=80_000_000, ls_ns=50_000_000),
             dict(body="_staged_steps", position=1, lanes=512, runs=2,
                  trips=30, ns=20_000_000, ls_ns=10_000_000)]
    ctx = _ctx(monkeypatch, loops)
    assert harness.read_metric("linesearch_pct.pm3d", ctx) == \
        pytest.approx(60.0)
    # a program that stamps no line search (its loops have no ls_ns)
    ctx = _ctx(monkeypatch, [{k: v for k, v in r.items() if k != "ls_ns"}
                             for r in loops])
    assert harness.read_metric("linesearch_pct.pm3d", ctx) is None
    # the CPU's run: its loops are the host's, with no stamp to read
    monkeypatch.undo()
    cell, w = fleet
    tally, _ = cell.check(w)
    cpu = harness.Context(cell=cell, window=w, setup_s=0.0, trips=0,
                          launches={}, intervals=[],
                          reserved_window_bytes=0, traced=True,
                          tally=tally)
    assert cpu.metric("linesearch_pct.pm3d") is None
    assert cpu.metric("solved_solves_per_s") == 8.0
    assert cpu.metric("unsolved_pct.pm3d") == 0.0
