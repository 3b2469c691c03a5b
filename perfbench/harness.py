"""One run of one cell: set-up, the measured window, the output check and the
metrics, driven by the files the cell's names lead to:

* ``BENCHMARK.json`` (the checkout's root): the cell, and which metrics it
  reports;
* ``configs/<config>.json``: the problem, the program's entry and the
  check's limits (``reference/problem.py`` reads the same file);
* ``entries/<entry>.py``: the program under test (the contract is in
  ``entries/__init__.py``);
* ``reference/dynamics/<dynamics>.py``, ``reference/schemes/<scheme>.py``:
  the check's model of the configuration's problem;
* ``traffic/<traffic>.json``: the mix, read by ``draws.py``;
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number or None (nothing to read: the metric is left out of the line).

Each lies under ``perfbench/`` of one root, the checkout's by default.
A cell of n > 1 cards runs as n ranks (``ranks.py``): every rank runs the
same set-up and window on its own card, and rank 0 alone checks, reads
the metrics and returns the line.

The window is a closed loop. A fleet dispatches batch k+1 while batch k
runs on the card (at most two in flight) and stops dispatching once
``seconds`` have passed; the window ends when the last batch has finished.
An episode mix runs one client: a cold solve, then re-solves ("ticks"),
each from the node-1 state of the plan before, each timed from the call to
its synced result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from . import draws, entries
from .reference.check import Tally
from .reference.problem import load_config, problem_of
from .trace import Spans, busy_and_gaps

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METRIC_DIR = os.path.join(HERE, "metrics")
#: put before every line this process logs (a rank's number on n ranks)
LOG_PREFIX = ""
#: lanes a block of the output check
CHECK_BLOCK = 8192


def log(*a):
    print(LOG_PREFIX + " ".join(map(str, a)), file=sys.stderr, flush=True)


def bench_path(root: str, *parts) -> str:
    """A path under the benchmark's directory of the checkout ``root``."""
    return os.path.join(root, "perfbench", *parts)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end ones untraced,
    its per-layer ones traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx, metric_dir: str = METRIC_DIR):
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", os.path.join(metric_dir, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


@dataclasses.dataclass
class Op:
    """One op of the window, what the check needs: the inputs handed in
    and what came back (lane axis first: the nodes, the objective, the
    statuses and the multipliers of the defects and of the zone rows), and
    the zones' clock shift."""

    x0: torch.Tensor
    xf: torch.Tensor
    z: torch.Tensor
    obj: torch.Tensor
    status: torch.Tensor
    lam_def: torch.Tensor
    mu: torch.Tensor
    shift: float = 0.0
    index: int = 0


#: the fields of an Op that the check concatenates, in Tally.add's order
CHECKED = ("x0", "xf", "z", "obj", "status")
MULTIPLIERS = ("lam_def", "mu")


def _op(x0, xf, res, shift=0.0, index=0) -> Op:
    n = x0.shape[0] if x0.dim() > 1 else 1
    return Op(x0.reshape(n, -1), xf.reshape(n, -1), res.z.reshape(n, -1),
              res.obj.reshape(n), res.status.reshape(n),
              res.lam_def.reshape(n, -1), res.mu.reshape(n, -1), shift,
              index)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    ops: list = dataclasses.field(default_factory=list)
    lanes: int = 0
    raised: int = 0          # lanes of ops that raised
    tick_ms: list = dataclasses.field(default_factory=list)
    tick_ops: list = dataclasses.field(default_factory=list)
    inner_iters: list = dataclasses.field(default_factory=list)
    ends: list = dataclasses.field(default_factory=list)  # s an op ended


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """A cell's files under ``root``, loaded, and its program entry built on
    ``device``; ``ranks``: this rank's place among the cell's ranks (None
    on one card)."""

    def __init__(self, name: str, device, bench: dict = None,
                 traffic: dict = None, root: str = ROOT, ranks=None):
        self.bench = bench if bench is not None else load_benchmark(root)
        self.spec = next(w for w in self.bench["workloads"]
                         if w["name"] == name)
        self.name = name
        self.config_dir = bench_path(root, "configs")
        self.metric_dir = bench_path(root, "metrics")
        self.entry_dir = bench_path(root, "entries")
        self.config = load_config(self.spec["config"], self.config_dir)
        self.traffic = traffic or draws.load_traffic(
            self.spec["traffic"], bench_path(root, "traffic"))
        self.problem = problem_of(self.config, self.config_dir,
                                  bench_path(root, "reference"))
        self.device = torch.device(device)
        self.ranks = ranks
        self.entry = None

    def build(self):
        group = self.ranks.group if self.ranks is not None else None
        self.entry = entries.load(self.config["entry"], self.entry_dir)(
            self.config, self.traffic, self.device, group, self.config_dir)

    # ---- ops ------------------------------------------------------------
    def fleet_cold(self, seed, stream, k, spans):
        """One cold batch: starts and goals drawn, then the entry's batch
        (its other draws, as the staged entry's seeds, from the window's
        own stream, or from the starts' generator in set-up). Returns (Op,
        the batch's result)."""
        e, t = self.entry, self.traffic
        gen = draws.generator(seed, stream, k, self.device)
        x0, xf = draws.starts_goals(t, e.x0, e.xf, t["batch"], gen)

        def seeds():
            return (draws.generator(seed, "seeds", k, self.device)
                    if stream == "batch" else gen)

        res = e.batch(x0, xf, seeds, spans, k)
        return _op(x0, xf, res, index=k), res

    def fleet_warm(self, base: Op, prev, j, k, spans):
        """Re-solve j of a warm chain (j = 1..chain): base's starts moved
        by drift * j, warm-started from ``prev``."""
        x0 = base.x0 + self.traffic["drift"] * j
        with spans("perfbench.solve", k):
            res = self.entry.warm(x0, base.xf, prev)
        return res, _op(x0, base.xf, res, index=k)

    # ---- windows --------------------------------------------------------
    def setup(self, seed, log_phase):
        """Warm this cell's own keys: each op kind twice (its first use runs
        eagerly and captures, the second replays). Returns the warm mix's
        bases, [(Op, result)] of its set-up cold batches, or None."""
        from etol_tpu_torch.solve import trip_graph

        t, spans = self.traffic, Spans(False)
        base = None

        def timed(what, fn):
            c0, t0 = trip_graph.COUNTS["capture_s"], time.perf_counter()
            out = fn()
            _sync(self.device)
            log_phase(what, time.perf_counter() - t0,
                      trip_graph.COUNTS["capture_s"] - c0)
            return out

        if t["loop"] == "fleet" and t["start"] == "warm":
            base = [timed(f"cold base {m}", lambda: self.fleet_cold(
                t["pool_seed"], "setup", m, spans))
                for m in range(t["bases"])]
            prev = base[0][1]
            for j in (1, 2):
                prev, _ = timed(f"warm re-solve {j}", lambda: self.fleet_warm(
                    base[0][0], prev, j, 0, spans))
        elif t["loop"] == "fleet":
            for i in (0, 1):
                timed(f"cold batch {i}", lambda: self.fleet_cold(
                    seed, "warmup", i, spans))
        else:
            x0 = self._episode_start(seed, "warmup", 0)
            res = timed("episode solve", lambda: self.entry.episode(x0))
            for j in (1, 2):
                res = timed(f"tick {j}", lambda: self.entry.tick(
                    self._node1(res)))
        return base

    def _episode_start(self, seed, stream, e):
        gen = draws.generator(seed, stream, e, "cpu")
        x0, _ = draws.starts_goals(self.traffic, self.entry.x0.cpu(),
                                   self.entry.xf.cpu(), 1, gen)
        return x0[0].tolist()

    def _node1(self, res):
        nx = self.problem.nx
        return res.z.reshape(self.problem.nodes, -1)[1, :nx].tolist()

    def window(self, seed, seconds, spans, base=None) -> Window:
        if self.traffic["loop"] == "fleet":
            return self._fleet_window(seed, seconds, spans, base)
        return self._episode_window(seed, seconds, spans)

    def _decide(self, expired: bool, raised: bool):
        """(stop, faulted) once an op has been dispatched: on one card this
        process's clock and fault; on n ranks rank 0's clock, and a fault
        on any rank, which stops every rank."""
        if self.ranks is None:
            return expired, raised
        return self.ranks.decide(expired, raised)

    def _fleet_window(self, seed, seconds, spans, base) -> Window:
        t = self.traffic
        w = Window()
        cuda = self.device.type == "cuda"
        done = []
        # an entry that is not synced returns at once, and batch k+1 is
        # queued while batch k runs
        synced = self.entry.synced
        prev = None
        k = 0
        spans.start()
        t0 = time.perf_counter()
        while True:
            op = None
            try:
                if base is None:
                    op, _ = self.fleet_cold(seed, "batch", k, spans)
                else:
                    j = k % t["chain"] + 1
                    b = base[draws.pool_index(seed, len(base),
                                              k // t["chain"])]
                    if j == 1:
                        prev = b[1]
                    prev, op = self.fleet_warm(b[0], prev, j, k, spans)
            except Exception:  # a fault of the program: counted, window ends
                log(traceback.format_exc())
            if op is not None:
                w.ops.append(op)
                w.lanes += op.status.numel()
                k += 1
                if cuda and not synced:
                    ev = torch.cuda.Event()
                    ev.record()
                    done.append(ev)
                    if len(done) > 1:  # batch k-1 has ended
                        done[-2].synchronize()
                        w.ends.append(time.perf_counter() - t0)
                elif synced:  # the entry returns once the batch has ended
                    w.ends.append(time.perf_counter() - t0)
            stop, faulted = self._decide(
                time.perf_counter() - t0 >= seconds, op is None)
            if faulted:  # here or on another rank: the op is a fault
                if op is not None:
                    w.ops.pop()
                    w.lanes -= op.status.numel()
                w.raised += t["batch"]
                w.lanes += t["batch"]
                break
            if stop:
                break
        _sync(self.device)
        w.seconds = time.perf_counter() - t0
        if not synced:
            w.ends.append(w.seconds)
        return w

    def _episode_window(self, seed, seconds, spans) -> Window:
        ticks, dt = self.traffic["ticks"], self.problem.dt
        w = Window()
        e = 0
        spans.start()
        t0 = time.perf_counter()
        while True:
            x0 = self._episode_start(self.traffic["pool_seed"], "episode",
                                     draws.pool_index(
                                         seed, self.traffic["pool"], e))
            raised = False
            try:
                with spans("perfbench.episode", len(w.ops)):
                    res = self.entry.episode(x0)
                self._keep(w, x0, res, 0.0, e)
                for j in range(1, ticks + 1):
                    x0 = self._node1(res)
                    op = len(w.ops)
                    with spans("perfbench.tick", op):
                        ta = time.perf_counter()
                        res = self.entry.tick(x0)
                        w.tick_ms.append((time.perf_counter() - ta) * 1e3)
                    w.tick_ops.append(op)
                    w.inner_iters.append(res.inner_iters)
                    self._keep(w, x0, res, j * dt, e)
            except Exception:  # a fault of the program: counted, window ends
                log(traceback.format_exc())
                raised = True
            stop, faulted = self._decide(
                time.perf_counter() - t0 >= seconds, raised)
            if faulted:  # here or on another rank: the episode is a fault
                w.raised += 1
                w.lanes += 1
                break
            e += 1
            if stop:
                break
        _sync(self.device)
        w.seconds = time.perf_counter() - t0
        return w

    def _keep(self, w, x0, res, shift, e):
        xf = self.entry.xf
        w.ops.append(_op(torch.tensor(x0, dtype=xf.dtype), xf, res, shift,
                         e))
        w.lanes += 1

    # ---- the check ------------------------------------------------------
    def check(self, w: Window, control: bool = False):
        """The output check over every op of the window (``control``: on
        the outputs rounded to bfloat16). Returns (Tally, per-op rows
        [index, lanes, unsolved, failed, status digest] for fleets)."""
        tally = Tally(self.problem, self.config["limits"])
        rows = []

        def add(ops):
            dev = ops[0].z.device
            cat = {f: torch.cat([getattr(o, f).to(dev) for o in ops])
                   for f in CHECKED + MULTIPLIERS}
            if control:
                for f in ("z", "obj") + MULTIPLIERS:
                    cat[f] = cat[f].to(torch.bfloat16).float()
            shift = torch.cat([torch.full((o.status.numel(),), o.shift,
                                          dtype=torch.float64,
                                          device=o.z.device) for o in ops])
            tally.add(*(cat[f] for f in CHECKED), shift,
                      *(cat[f] for f in MULTIPLIERS))

        if self.traffic["loop"] == "fleet":
            for o in w.ops:
                before = tally.failed
                add([o])
                st = o.status.cpu()
                rows.append([o.index, int(st.numel()), int((st != 1).sum()),
                             tally.failed - before,
                             hashlib.sha1(st.numpy().tobytes()).hexdigest()[:8]])
        else:
            n = max(1, CHECK_BLOCK // max(1, w.ops[0].z.shape[0])) \
                if w.ops else 1
            for i in range(0, len(w.ops), n):
                add(w.ops[i:i + n])
        return tally, rows


def device_line(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


FORBIDDEN = ("jax", "jaxlib", "flax", "etol_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float = None, control: bool = False,
        bench: dict = None, traffic: dict = None, cell: "Cell" = None,
        root: str = ROOT, ranks=None):
    """One run; returns the result line's object, or None where the run
    may print none (a forbidden module loaded, or a rank other than 0).
    ``cell``: one already built, which a test hands several runs; ``root``:
    the checkout whose files the cell is read from; ``ranks``: this rank
    of a cell of n > 1 cards (``ranks.py``), None on one card."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    from etol_tpu_torch.ops import bt_cuda, graph_loop
    from etol_tpu_torch.solve import trip_graph

    t_import = time.perf_counter()
    phases = [("import", t_import - t_start)]
    if cuda:
        bt_cuda.build()
        graph_loop.build()
    phases.append(("extensions", time.perf_counter() - t_import))
    t_data = time.perf_counter()
    if cell is None:
        cell = Cell(cell_name, device, bench, traffic, root, ranks)
        cell.build()
    ranks = cell.ranks
    rank0 = ranks is None or ranks.rank == 0
    _sync(cell.device)
    phases.append(("data", time.perf_counter() - t_data))
    first_use = []
    base = cell.setup(seed, lambda what, s, cap: first_use.append(
        (what, s, cap)))
    trip_graph.settle()
    counts0 = dict(trip_graph.COUNTS)
    launches0 = dict(bt_cuda.LAUNCHES_BY)
    peak_setup = 0
    if cuda:
        peak_setup = torch.cuda.max_memory_allocated(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    log("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in phases)
        + "; first use: " + ", ".join(
            f"{n} {s:.3f} s (capture {c:.3f} s)" for n, s, c in first_use))
    spans = Spans(trace and cuda and rank0)
    if ranks is not None:  # the window starts once every rank is set up
        ranks.barrier()
        ranks.watch(seconds)
    setup_s = time.perf_counter() - t_start
    with spans:
        w = cell.window(seed, seconds, spans, base)
    trip_graph.settle()
    peak_window = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    peak = max(peak_setup, peak_window)
    if ranks is not None:
        every = ranks.gather(dict(ops=len(w.ops), digest=hashlib.sha1(
            json.dumps([o.index for o in w.ops]).encode()).hexdigest()[:8],
            raised=w.raised, peak=peak))
        ranks.close()
        if not rank0:
            return None
        log("ranks [ops, their indices' digest, lanes raised, peak bytes]: "
            + json.dumps([[r["ops"], r["digest"], r["raised"], r["peak"]]
                          for r in every]))
        peak = max(r["peak"] for r in every)
    if cuda:
        log("device: " + device_line(cell.device))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return None
    reserved_window = (torch.cuda.max_memory_reserved(cell.device)
                       if cuda else 0)
    launches = {k: v - launches0.get(k, 0)
                for k, v in bt_cuda.LAUNCHES_BY.items()
                if v - launches0.get(k, 0) > 0}
    intervals = spans.intervals()
    ctx = Context(cell=cell, window=w, setup_s=setup_s,
                  trips=trip_graph.COUNTS["trips"] - counts0["trips"],
                  launches=launches, intervals=intervals,
                  reserved_window_bytes=reserved_window, traced=spans.on)
    # the check runs once the window has closed and the peak is read
    tally, rows = cell.check(w)
    log(f"window: {w.seconds:.3f} s, {len(w.ops)} ops, {w.lanes} lanes, "
        f"{tally.solved} solved, {w.raised} lanes in ops that raised")
    if rows:
        log("ops [index, lanes, unsolved, failed, status digest]: "
            + json.dumps(rows))
    log("stationarity of the solved lanes at p50/p90/p99/max: " + " / ".join(
        f"{v:.4g}" for v in tally.residual_quantiles().values()))
    if w.tick_ms:
        q = np.percentile(w.tick_ms, [50, 90, 95, 99, 100])
        log(f"ticks: {len(w.tick_ms)}, ms at p50/p90/p95/p99/max "
            + " / ".join(f"{v:.2f}" for v in q) + ", share over 40 ms "
            f"{float(np.mean(np.array(w.tick_ms) > 40)):.4f}")
    if w.ends:
        log("ops' seconds (host, between ends): " + json.dumps(
            [round(b - a, 4) for a, b in zip([0.0] + w.ends, w.ends)]))
    log("in the window: " + json.dumps(
        {k: v - counts0[k] for k, v in trip_graph.COUNTS.items()}))
    if control:
        ctl, _ = cell.check(w, control=True)
        log("control (outputs in bfloat16): " + json.dumps(ctl.compared()))
    ctx.tally = tally
    metrics = {}
    for m in cell_metrics(cell.bench, cell_name, trace):
        v = ctx.metric(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": tally.passed() and w.raised == 0,
            "attempted": w.lanes,
            "failed": tally.failed + w.raised,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(cell.device)
                                if cuda else "cpu"),
                       "count": 1 if ranks is None else ranks.size,
                       "memory_peak_bytes": peak}}
    if trace and cuda:
        busy_ms, gaps = busy_and_gaps(intervals, w.seconds * 1e3)
        line["device"]["busy_s"] = busy_ms / 1e3
        line["device"]["window_s"] = w.seconds
        line["breakdown"] = breakdown(intervals, gaps)
    line["compared"] = tally.compared()
    return line


def breakdown(intervals, gaps) -> dict:
    """The card's time by span (CUDA events around the program launches;
    the profiler sees nothing inside the solves' while bodies) and its idle
    gaps by what the host did next."""
    by_span = {}
    for span, _, a, b in intervals:
        by_span[span] = by_span.get(span, 0.0) + (b - a) / 1e3
    ops = sorted(by_span.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, ms / 1e3] for n, ms in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    window: Window
    setup_s: float
    trips: int
    launches: dict
    intervals: list
    reserved_window_bytes: int
    traced: bool
    tally: Tally = None

    def metric(self, name):
        """Metric ``name`` as its reader, beside the cell's others, reads
        it: a reader may build on another's."""
        return read_metric(name, self, self.cell.metric_dir)

    def span_ms(self, name):
        """The card's ms of each launch filed under span ``name``."""
        return [b - a for s, _, a, b in self.intervals if s == name]

    @property
    def fleet(self) -> bool:
        return self.cell.traffic["loop"] == "fleet"

    def busy_ms(self):
        return busy_and_gaps(self.intervals, self.window.seconds * 1e3)[0]

