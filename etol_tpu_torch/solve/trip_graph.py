"""The solver loop and the seeds and planners, each captured as a CUDA
graph and replayed.

Counterpart of how the JAX package runs its solve
(``etol_tpu/solve/al_sqp.py``: "Whole solve is one traced program:
fixed-shape ``lax.while_loop``s ... so one ``jit`` serves every problem
instance of the same Dims", and a warm MPC re-solve "re-invokes with
zero retrace"). Here the traced program is one trip of the loop
(:func:`.al_sqp._trip`: the full step, the chord steps and the freeze,
then the loop condition), captured once per key as a
``torch.cuda.CUDAGraph``. A replay dispatches the whole trip, the KKT
kernel's launch included, with one host call; the host only decides when
to stop.

Routes, decided by :func:`loop` from its arguments before anything
launches:

* a batch on a CUDA device: static buffers and the captured trip;
* a batch on the CPU: the eager loop, the plain version (the same
  ``_trip``), which reads ``active.any()`` on the host once a trip;
* a collective ``agree`` (the horizon-sharded solve over a
  :class:`..parallel.axis.GroupAxis`, whose lane mask is a
  ``torch.distributed`` reduction, staged through the host under gloo):
  the eager loop, on a card too.

Static buffers. An entry holds, each in a buffer of its own, the loop's
state dict, the problem data (the leaves of ``VGPData``, or of a
``SideData``), the tensors ``_ALFuncs`` derives from them (the bounds,
with a box where one is given, the scales, the track centres), the line
search's exponents, ``max_total`` as a 0-dim tensor, the lane mask and a
0-dim flag (any lane active). A trip reads them and overwrites the
state, the mask and the flag in place. A call copies its data, its first
state and its budget in and its result out, so the calls of one key
replay one graph: a cold solve's, its warm re-solve's, every stage of
the staged compaction at that batch size, every MPC tick's.

The key: the NLP, the config with ``max_total`` taken out (it is a
buffer), the batch size, dtype and device, the KKT route, the
``kkt_solve`` (its ``graph_key`` where it has one, as the SPIKE solver of
``parallel/kkt.py`` does, else the object), and the data's tree with its
leaves' shapes and dtypes. A box adds nothing: it enters only the
bounds, [B, K, w] with or without one, and they are copied in.

First use of a key: the trip runs eagerly once on a side stream (that
builds the kernel and sets its shared-memory attribute, is torch's
warm-up before a capture, and is a real trip of the solve), then one
trip is captured. A capture or a replay that fails raises: nothing falls
back to the eager loop.

The stop test. After each replay the flag is copied into pinned host
memory without blocking and an event is recorded; the host then waits
for the event of the replay ``LAG`` trips back and reads that flag. The
next trip is always queued while the host waits, so the device never
waits for the host's decision, and ``LAG`` trips past the last one run
with every lane frozen: they change no leaf, so every result is bitwise
the eager loop's. The launches they make are counted (``bt_cuda``'s and
``cyclic_reduction``'s counters add a graph's recorded launches at each
replay), and ``COUNTS["idle_trips"]`` says how many there were. Why
``LAG`` is 1: ``chip_smoke.py``'s graph phase times lag 1 against lag 0
(a wait on each trip before the next is queued) in one call. On an H100
(700 W), uas_2d N=50 at B=2048: 7.83 against 8.60 ms a trip, and 8.12
against 8.29 in a second call, the card's own trip 7.39 ms; the wait
leaves the card idle while the host wakes and queues the next replay.
At B=1 (the MPC re-solve) the two tie (p50 32.37 against 32.36 ms): the
idle trip costs what the waits save. A fixed block of trips between
reads would run up to a block of idle trips at every stop, where lag 1
runs one.

Programs. The JAX package jits its seeds and planners too
(``etol_tpu/solve/shooting.py`` ``plan``, ``planners.py`` ``_plan_cem``
and ``_plan_tree``, each a ``lax.scan`` in one traced program).
:func:`program` runs such a deterministic body (the draws are made
before it, outside the graph) the same way: on a CUDA device the whole
body is captured once per key, every rollout step, CEM round and tree
trip of it unrolled (a tree trip's shapes grow with its written prefix,
but the prefix is a Python int fixed by the trip's index), and each call
copies its tensors into the entry's static buffers, replays the graph
once and clones the outputs out. The key is the body and the call's
tree of arguments, each tensor by its shape and dtype and every other
leaf (the dynamics, sizes, names, Python floats) by its value, with the
device. On the CPU the body runs eagerly on the caller's tensors.

The cache, the trips' keys and the programs' together, holds at most
MAX_ENTRIES keys and drops the least recently used first, also while
the entries' memory passes POOL_SHARE of the device's. An entry's memory
is its static buffers (state and data of B lanes, a program's
arguments) and its graph's private pool, which keeps every tensor the
captured work makes reserved for the replays: for a trip the line
search's B·|grid| candidates and their residuals, the assembly's
intermediates, the Hessian blocks, the KKT solve's scratch.
``chip_smoke.py`` prints the pool bytes of each phase's keys.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import time

import torch

from ..core.problem import (tree_flatten, tree_flatten_with_paths,
                            tree_map, tree_unflatten)
from ..ops import bt_cuda, cyclic_reduction
from .al_sqp import SolverConfig, _active, _ALFuncs, _trip

#: replays between a trip and the host's read of its flag
LAG = 1
#: keys the cache holds at most
MAX_ENTRIES = 8
#: share of a device's memory the cached entries may hold
POOL_SHARE = 0.25
#: what runs have done in this process, for a run to read: graphs
#: captured and the seconds that took, trips run on static buffers (the
#: first, eager trip of a new key included) and of them the frozen ones
#: past the stop, trips of the eager loop, and calls of a program on
#: static buffers
COUNTS = dict(captures=0, capture_s=0.0, trips=0, idle_trips=0,
              eager_trips=0, programs=0)

_CACHE: "collections.OrderedDict[tuple, _Captured]" = (
    collections.OrderedDict())
_OVERRIDE = {}


@contextlib.contextmanager
def override(route: str | None = None, lag: int | None = None):
    """Force, for the solves and programs inside, the route ("eager" or
    "static") and the loop's stop-test lag: for the card's comparison of
    the graph with the eager route, and for the CPU tests of the static
    path, which runs the trip or the body the graph captures without
    capturing it."""
    if route not in (None, "eager", "static"):
        raise ValueError(f"route must be 'eager' or 'static', got {route!r}")
    if lag is not None and lag < 0:
        raise ValueError(f"lag must be >= 0, got {lag}")
    saved = dict(_OVERRIDE)
    _OVERRIDE.update(route=route, lag=lag)
    try:
        yield
    finally:
        _OVERRIDE.clear()
        _OVERRIDE.update(saved)


def pool_bytes() -> int:
    """Bytes the cached graphs' pools reserved when they were captured."""
    return sum(e.pool_bytes for e in _CACHE.values())


def static_bytes() -> int:
    """Bytes of the cached entries' static buffers."""
    return sum(e.static_bytes for e in _CACHE.values())


def loop(F: _ALFuncs, cfg: SolverConfig, st: dict, exps, max_total: int,
         agree=None) -> dict:
    """Run the loop from the state ``st`` to its end and return the final
    state: on static buffers, with the trip captured on a CUDA device,
    unless the batch is on the CPU, ``agree`` is a collective or the
    batch has no lanes (it runs no trip)."""
    route = route_of(F.lb.device, agree is None and F.lb.shape[0] > 0)
    if route == "eager":
        return _eager(F, cfg, st, exps, max_total, agree)
    if agree is not None:
        raise ValueError("a collective lane mask (agree) runs on the eager "
                         "loop; it cannot be captured")
    lag = _OVERRIDE.get("lag")
    return _static(F, cfg, st, exps, max_total, LAG if lag is None else lag)


def route_of(device, capturable: bool = True) -> str:
    """The route of work on ``device``: the overridden one, else
    "static" (static buffers and a graph) on a CUDA device where the work
    can be captured, else "eager"."""
    route = _OVERRIDE.get("route")
    if route is None:
        route = ("static" if device.type == "cuda" and capturable
                 else "eager")
    return route


def program(body, *args, **kwargs):
    """``body(*args, **kwargs)``: on a CUDA device (or under
    ``override("static")``) on the static buffers of the call's key, the
    body captured on the key's first use and replayed; on the CPU
    eagerly. ``args`` and ``kwargs`` are trees of tensors and other
    leaves; the body must read nothing on the host, and the result is a
    tree of tensors, cloned out of the buffers."""
    tree = (args, kwargs)
    leaves = tree_flatten_with_paths(tree)
    device = next(a.device for _, a in leaves if isinstance(a, torch.Tensor))
    if route_of(device) == "eager":
        return body(*args, **kwargs)
    key = (body, str(device), tuple(
        (path, tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
        else (path, type(a), a) for path, a in leaves))
    entry = _lookup(key, lambda: _Program(body, tree))
    out = entry.run(tree)
    _evict(device)
    return out


def _eager(F, cfg, st, exps, max_total, agree):
    active = _active(cfg, st, max_total, agree)
    while bool(active.any()):  # one host sync per trip
        st = _trip(F, cfg, st, exps, active)
        active = _active(cfg, st, max_total, agree)
        COUNTS["eager_trips"] += 1
    return st


def _key(F: _ALFuncs, cfg: SolverConfig) -> tuple:
    ks = F.kkt_solve
    return (
        F.nlp, dataclasses.replace(cfg, max_total=0), F.kkt,
        getattr(ks, "graph_key", ks), F.dtype, F.lb.shape[0],
        str(F.lb.device), type(F.data),
        tuple((path, tuple(a.shape), a.dtype)
              for path, a in tree_flatten_with_paths(F.data)),
    )


def _static(F, cfg, st, exps, max_total, lag):
    entry = _lookup(_key(F, cfg), lambda: _Entry(F, cfg, st, exps))
    entry.load(F, st, max_total)
    entry.run(lag)
    _evict(F.lb.device)
    return {k: v.clone() for k, v in entry.st.items()}


def _lookup(key, make):
    """The cached entry of ``key`` (made by ``make()`` on its first use),
    now the most recently used."""
    entry = _CACHE.pop(key, None)
    if entry is None:
        entry = make()
    _CACHE[key] = entry
    return entry


def _evict(device) -> None:
    limit = (POOL_SHARE * torch.cuda.get_device_properties(device)
             .total_memory if device.type == "cuda" else float("inf"))
    while len(_CACHE) > MAX_ENTRIES or (
            len(_CACHE) > 1 and pool_bytes() + static_bytes() > limit):
        _CACHE.popitem(last=False)


def _buffer(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _Captured:
    """Static buffers and, on a CUDA device, a graph captured from
    :meth:`step`: what a trip's entry and a program's share."""

    graph = None
    tally = cr_tally = None
    pool_bytes = 0
    static_bytes = 0

    def _warm(self) -> None:
        """One eager :meth:`step` on a side stream: it builds what the
        step launches (the KKT kernel, its shared-memory attribute), and
        is torch's warm-up before a capture."""
        here = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.step()
        here.wait_stream(side)

    def _capture(self):
        """Capture one :meth:`step` and return what it returned, the
        graph's output tensors."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with bt_cuda.recording() as tally, \
                cyclic_reduction.recording() as cr_tally:
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved()
                out = self.step()
                self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph, self.tally, self.cr_tally = graph, tally, cr_tally
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += time.perf_counter() - t0
        return out

    def _replayed(self, n: int) -> None:
        """Count the launches of ``n`` replays."""
        bt_cuda.replayed(self.tally, n)
        cyclic_reduction.replayed(self.cr_tally, n)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Program(_Captured):
    """One program key's argument buffers and, on a CUDA device, the
    graph of its body and the graph's outputs."""

    def __init__(self, body, tree):
        self.body = body
        leaves = tree_flatten(tree)
        self.buffers = [_buffer(a) for a in leaves
                        if isinstance(a, torch.Tensor)]
        it = iter(self.buffers)
        self.args, self.kwargs = tree_unflatten(tree, [
            next(it) if isinstance(a, torch.Tensor) else a for a in leaves])
        self.out = None
        self.static_bytes = _nbytes(self.buffers)

    def step(self):
        """The body on the buffers: what the graph captures."""
        return self.body(*self.args, **self.kwargs)

    def run(self, tree):
        """Copy a call's tensors in, run the body (on a CUDA device the
        graph, captured on the first use) and return its result cloned
        out of the buffers."""
        for b, a in zip(self.buffers, (a for a in tree_flatten(tree)
                                       if isinstance(a, torch.Tensor))):
            b.copy_(a)
        COUNTS["programs"] += 1
        dev = self.buffers[0].device
        if dev.type != "cuda":
            out = self.step()
        else:
            with torch.cuda.device(dev):
                if self.graph is None:
                    self._warm()
                    self.out = self._capture()
                self.graph.replay()
            self._replayed(1)
            out = self.out
        return tree_unflatten(out, [t.clone() for t in tree_flatten(out)])


class _Entry(_Captured):
    """One loop key's static buffers and, on a CUDA device, its graph."""

    def __init__(self, F: _ALFuncs, cfg: SolverConfig, st: dict, exps):
        self.cfg = cfg
        # F's other fields (the NLP, the route, kkt_solve, the sizes) are
        # the key's; its tensors and its data become buffers
        self.F = copy.copy(F)
        self.F.data = tree_map(_buffer, F.data)
        for name, t in vars(F).items():
            if isinstance(t, torch.Tensor):
                setattr(self.F, name, _buffer(t))
        self.st = {k: _buffer(v) for k, v in st.items()}
        self.exps = _buffer(exps)
        dev = exps.device
        self.max_total = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((F.lb.shape[0],), dtype=torch.bool,
                                  device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.static_bytes = _nbytes(self._tensors())

    def _tensors(self):
        yield from tree_flatten(self.F.data)
        yield from (t for t in vars(self.F).values()
                    if isinstance(t, torch.Tensor))
        yield from self.st.values()
        yield from (self.exps, self.max_total, self.active, self.flag)

    def load(self, F: _ALFuncs, st: dict, max_total: int) -> None:
        """Copy a call's data, derived tensors, first state and budget
        in."""
        for b, a in zip(tree_flatten(self.F.data), tree_flatten(F.data)):
            b.copy_(a)
        for name, b in vars(self.F).items():
            if isinstance(b, torch.Tensor):
                b.copy_(getattr(F, name))
        for k, b in self.st.items():
            b.copy_(st[k])
        self.max_total.fill_(max_total)
        self._mark()

    def _mark(self) -> None:
        act = _active(self.cfg, self.st, self.max_total)
        self.active.copy_(act)
        self.flag.copy_(act.any())

    def step(self) -> None:
        """One trip in place: what the graph captures. It reads nothing
        on the host."""
        new = _trip(self.F, self.cfg, self.st, self.exps, self.active)
        for k, b in self.st.items():
            b.copy_(new[k])
        self._mark()

    def run(self, lag: int) -> None:
        """Trips until the flag read ``lag`` trips late is False; on a
        CUDA device the first use captures the trip and every later trip
        is a replay."""
        dev = self.flag.device
        if dev.type != "cuda":
            self._drive(self.step, lag)
            return
        with torch.cuda.device(dev):
            if self.graph is None:
                # the first trip, eager: a real trip of the solve
                self._warm()
                COUNTS["trips"] += 1
                self._capture()
                if not bool(self.flag):  # one read, on a key's first use
                    return
            n = self._drive(self.graph.replay, lag)
        self._replayed(n)

    def _drive(self, step, lag: int) -> int:
        """Run ``step`` until the flag of the trip ``lag`` trips back
        reads False; returns the trips run."""
        cuda = self.flag.device.type == "cuda"
        slots = torch.zeros((lag + 1,), dtype=torch.bool, pin_memory=cuda)
        events = [torch.cuda.Event() for _ in range(lag + 1)] if cuda \
            else None
        i = 0
        while True:
            step()
            slots[i % (lag + 1)].copy_(self.flag, non_blocking=cuda)
            if cuda:
                events[i % (lag + 1)].record()
            if i >= lag:
                back = (i + 1) % (lag + 1)  # the slot of trip i - lag
                if cuda:
                    events[back].synchronize()
                if not bool(slots[back]):
                    COUNTS["trips"] += i + 1
                    COUNTS["idle_trips"] += lag
                    return i + 1
            i += 1
