"""A traced run of one cell with the program's span recorder on.

    python3 perfbench/traced.py --workload <cell> --seed <n> --seconds <s> \\
        [--chrome <path>] [--same <ops>]

``perfbench/run.py --trace 1`` times the program from outside: CUDA events
around each launch of a captured program. This run switches the program's
own recorder on first (``etol_tpu_torch.utils.profiling.enable()``), so
set-up captures traced trips and programs (their phases stamped on the
card), marks the recorder's clock at the window's start and opens a
recorder span for each of the harness's spans; then it runs the same
window as ``run.py --trace 1``. Its last stdout line is that run's result
line, the cell's per-layer metrics joined by the recorder's (``SPANS``,
which the benchmark's own runs cannot read: they never switch the
recorder on). Before it, on stderr, a ``traced:`` JSON line: the window's
spans by name, the loops' card time by body, position and lanes, the
trips' phases, each idle gap of the card split by the innermost span open
over it, and the consistency checks of the recorder against the harness's
events. The Chrome trace of the window (host spans, the program's card
intervals, the harness's) is written to ``--chrome`` (default
``build/perfbench/<cell>.<seed>.trace.json``).

``--same N`` runs the cell's first N ops of the window untraced and then
traced (set-up's first uses included) in one process, and prints whether
the statuses, the solutions and the trips of each op are bitwise the same.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import run as _run  # noqa: E402,F401  (the caches' paths)

#: the per-layer metrics that read the recorder's spans and the traced
#: trips' phases: a run with the recorder on reports them
SPANS = [
    dict(name="program_host_ms.mpc", unit="ms", better="lower",
         source="program_span", layer="solver loop",
         moves="mpc_tick_p50_ms", workloads=["ocp2d_mpc_tick"]),
    dict(name="facade_host_ms.mpc", unit="ms", better="lower",
         source="program_span", layer="facade", moves="mpc_tick_p50_ms",
         workloads=["ocp2d_mpc_tick"]),
    dict(name="rescue_draws_ms", unit="ms", better="lower",
         source="program_span", layer="facade",
         moves="solved_solves_per_s", workloads=["ocp2d_fleet_rescue"]),
    dict(name="trip_assembly_pct.fleet", unit="%", better="lower",
         source="device_trace", layer="solver loop",
         moves="solved_solves_per_s",
         workloads=["uas2d_fleet_cold", "ocp2d_fleet_rescue",
                    "uas2d_fleet_warm"]),
    dict(name="trip_linesearch_pct.fleet", unit="%", better="lower",
         source="device_trace", layer="solver loop",
         moves="solved_solves_per_s",
         workloads=["uas2d_fleet_cold", "ocp2d_fleet_rescue",
                    "uas2d_fleet_warm"]),
]
#: the parts of a tick that account for its wall time
TICK_PARTS = ("facade.prepare", "program.key", "program.copy_in",
              "program.launch", "program.clone_out", "facade.sync")


def _spans_class(base, profiling):
    """The harness's Spans, marking the recorder's clock at the window's
    start and opening a recorder span for each of its own."""

    class Spans(base):
        last = None

        def __init__(self, on):
            super().__init__(on)
            if on:
                Spans.last = self

        def start(self):
            if self.on:
                profiling.mark()
            super().start()

        @contextlib.contextmanager
        def __call__(self, name, op):
            with profiling.span(name, op=op), base.__call__(self, name, op):
                yield

    return Spans


def idle_split(intervals, recs, window_ns, origin_ns):
    """Each idle gap of the card between the harness's intervals ((span,
    op, start ms, end ms) from the window's origin), split by the innermost
    recorder span open over it: {"before <span>: <name>" or "...: outside
    any span": s}. The labels of one gap sum to the gap."""
    gaps, end = [], 0.0
    for span, _, a, b in sorted(intervals, key=lambda r: r[2]):
        if a > end:
            gaps.append((f"before {span}", end, a))
        end = max(end, b)
    if window_ns / 1e6 > end:
        gaps.append(("after the last launch", end, window_ns / 1e6))
    starts, ends, names = _innermost(recs)
    out = {}
    for label, a, b in gaps:
        lo, hi = origin_ns + a * 1e6, origin_ns + b * 1e6
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(starts) and starts[i] < hi:
            u, v = max(lo, starts[i]), min(hi, ends[i])
            if v > u:
                key = f"{label}: {names[i]}"
                out[key] = out.get(key, 0.0) + (v - u) / 1e9
            i += 1
    return out


def _innermost(recs):
    """The host's time cut where a span opens or closes: the pieces'
    starts, ends and the innermost span open over each (the spans nest),
    from the first span's start to the last one's end and beyond."""
    events = sorted([(r.start_ns, 1, r.id, r.name) for r in recs]
                    + [(r.end_ns, 0, r.id, r.name) for r in recs])
    starts, ends, names, stack = [float("-inf")], [], ["outside any span"], []
    for t, opens, rid, name in events:
        ends.append(t)
        if opens:
            stack.append((rid, name))
        else:
            stack.remove(next(e for e in reversed(stack) if e[0] == rid))
        starts.append(t)
        names.append(stack[-1][1] if stack else "outside any span")
    ends.append(float("inf"))
    return starts, ends, names


def report(recs, intervals, loops, phases, window_s, origin_ns):
    """The traced run's split and its consistency checks."""
    from etol_tpu_torch.utils import profiling
    from perfbench import recorder

    by_id = {r.id: r for r in recs}
    names = profiling.summary(recs)
    launches = [r for r in recs if r.name == "program.launch" and r.card]
    card_ns = sum(r.card[1] for r in launches)
    harness_ns = sum((b - a) * 1e6 for _, _, a, b in intervals)
    body_ns = {}
    for r in launches:
        body = by_id[r.parent].attrs.get("body") if r.parent in by_id \
            else None
        body_ns[body] = body_ns.get(body, 0) + r.card[1]
    loop_ns = {}
    by_loop = {}
    for r in loops or ():
        loop_ns[r["body"]] = loop_ns.get(r["body"], 0) + r["ns"]
        k = f'{r["body"]}[{r["position"]}] {r["lanes"]} lanes'
        d = by_loop.setdefault(k, dict(runs=0, trips=0, ns=0))
        for f in d:
            d[f] += r[f]
    idle = idle_split(intervals, recs, window_s * 1e9, origin_ns)
    idle_s = sum(idle.values())
    named = sum(s for k, s in idle.items()
                if not k.endswith("outside any span"))
    ticks = []
    for tid, kids in recorder.under(recs, "perfbench.tick").items():
        parts = sum(r.ns for r in kids if r.name in TICK_PARTS)
        ticks.append(parts / by_id[tid].ns)
    checks = dict(
        launch_card_over_harness=card_ns / harness_ns if harness_ns else None,
        loops_over_launch_by_body={
            b: loop_ns[b] / body_ns[b] for b in loop_ns if body_ns.get(b)},
        phases_over_loops=(sum(phases.values()) / sum(loop_ns.values())
                           if phases and loop_ns else None),
        tick_parts_over_wall_p50=statistics.median(ticks) if ticks else None,
        idle_named_share=named / idle_s if idle_s else None)
    return dict(
        spans={n: dict(calls=s["calls"], mean_ms=s["mean_ms"],
                       self_ms=1e3 * s["self_s"] / s["calls"])
               for n, s in names.items()},
        loops={k: dict(d, ms_a_run=d["ns"] / 1e6 / d["runs"])
               for k, d in by_loop.items()},
        phases_pct=({p: 100.0 * ns / sum(phases.values())
                     for p, ns in phases.items()} if phases else None),
        idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])[:16]),
        checks=checks)


def traced(cell_name, seed, seconds, chrome=None):
    """One traced window with the recorder on; returns the result line."""
    from etol_tpu_torch.solve import trip_graph
    from etol_tpu_torch.utils import profiling
    from perfbench import harness, trace

    harness.Spans = Spans = _spans_class(trace.Spans, profiling)
    bench = copy.deepcopy(harness.load_benchmark())
    known = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [m for m in SPANS if m["name"] not in known]
    profiling.enable()
    line = harness.run(cell_name, seed, seconds, True, device="cuda:0",
                       t_start=T_START, bench=bench)
    profiling.disable()
    if line is None:  # a forbidden module loaded: no result
        return None
    spans = Spans.last
    window_s = line["device"]["window_s"]
    mark_ns, mark_event = profiling.clock(0)
    # the harness's origin on the host's clock: the mark's pairing and the
    # card's time from the mark's event to the origin's
    origin_ns = mark_ns + round(mark_event.elapsed_time(spans.origin) * 1e6)
    intervals = spans.intervals()
    since = profiling.last_mark()
    recs = [r for r in profiling.records(since)
            if r.start_ns <= since + window_s * 1e9]
    loops = trip_graph.LAST_READ["loops"]
    phases = {}
    for r in trip_graph.LAST_READ["phases"]:
        for p, ns in r["ns"].items():
            phases[p] = phases.get(p, 0) + ns
    out = report(recs, intervals, loops, phases, window_s, origin_ns)
    out["cell"], out["seed"] = cell_name, seed
    harness.log("traced: " + json.dumps(out))
    chrome = chrome or os.path.join(ROOT, "build", "perfbench",
                                    f"{cell_name}.{seed}.trace.json")
    profiling.export_chrome(chrome, recs, [
        (s, origin_ns + round(a * 1e6), round((b - a) * 1e6))
        for s, _, a, b in intervals])
    harness.log(f"chrome trace: {chrome}")
    return line


def same(cell_name, seed, n):
    """The first ``n`` ops of the window untraced, then traced: per op the
    statuses' digest, the solution's digest and the trips."""
    import torch

    from etol_tpu_torch.solve import trip_graph
    from etol_tpu_torch.utils import profiling
    from perfbench import harness, trace

    cell = harness.Cell(cell_name, "cuda:0")
    cell.build()
    off = trace.Spans(False)

    def digest(t):
        return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:8]

    def ops():
        rows = []
        base = cell.setup(seed, lambda *a: None)
        trip_graph.settle()
        t, prev, res = cell.traffic, None, None
        for k in range(n):
            c0 = trip_graph.COUNTS["trips"]
            if t["loop"] == "fleet" and base is None:
                _, res = cell.fleet_cold(seed, "batch", k, off)
            elif t["loop"] == "fleet":
                j = k % t["chain"] + 1
                b = base[k // t["chain"] % len(base)]
                prev = b[1] if j == 1 else prev
                prev, _ = cell.fleet_warm(b[0], prev, j, k, off)
                res = prev
            elif k == 0:
                res = cell.entry.episode(cell._episode_start(seed, "episode",
                                                             0))
            else:
                res = cell.entry.tick(cell._node1(res))
            torch.cuda.synchronize()
            trip_graph.settle()
            rows.append([k, digest(res.status), digest(res.z),
                         trip_graph.COUNTS["trips"] - c0,
                         int(res.inner_iters.sum())])
        return rows

    plain = ops()
    profiling.enable()
    stamped = ops()
    profiling.disable()
    out = dict(cell=cell_name, seed=seed, ops=n, same=plain == stamped,
               untraced=plain, traced=stamped)
    harness.log("same: " + json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--chrome", default=None)
    ap.add_argument("--same", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    if args.same:
        return 0 if same(args.workload, args.seed, args.same)["same"] else 1
    line = traced(args.workload, args.seed, args.seconds, args.chrome)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
