"""The solver loop, the solves, and the seeds and planners, each run on
a CUDA card as captured graphs with no host decision inside.

Counterpart of how the JAX package runs its solve
(``etol_tpu/solve/al_sqp.py``: "Whole solve is one traced program:
fixed-shape ``lax.while_loop``s ... so one ``jit`` serves every problem
instance of the same Dims", and a warm MPC re-solve "re-invokes with
zero retrace"). One trip of the loop (:func:`.al_sqp._trip`: the full
step, the chord steps and the freeze, then the loop condition) is
captured once per key as a ``torch.cuda.CUDAGraph``, and the loop runs
as one graph launch: a while node (``ops/graph_loop.py``, built from
``csrc/graph_loop.cu``) whose body is the captured trip followed by a
one-thread condition kernel that reads the trip's flag on the card, as
``lax.while_loop`` runs its cond on the device. The host reads nothing
while the loop runs and no trip runs past the stop.

Routes, decided by :func:`loop` from its arguments before anything
launches:

* a batch on a CUDA device: static buffers and the device loop;
* a batch on the CPU: the eager loop, the plain version (the same
  ``_trip``), which reads ``active.any()`` on the host once a trip;
* a collective ``agree`` (the horizon-sharded solve over a
  :class:`..parallel.axis.GroupAxis`, whose lane mask is a
  ``torch.distributed`` reduction, staged through the host under gloo):
  the eager loop, on a card too.

:func:`override` forces one of the routes "eager", "static" and
"replay". The last is the host-driven loop of static buffers that came
before the device loop, kept so that a run can time the two side by
side: each trip is a replay of the captured graph, and the host reads
the stop flag ``lag`` trips late (``LAG`` = 1 by default) from pinned
memory, so ``lag`` frozen trips run past the stop
(``COUNTS["idle_trips"]``; they change no leaf, so the results are
bitwise the eager loop's); there, as on "eager", a solve's steps run
eagerly around its loops. On the CPU, "static" runs the same work in
the same order without capturing it, the loop as the host's ``while``
on the same flag: what the CPU tests run.

Static buffers. An entry holds, each in a buffer of its own, the loop's
state dict, the problem data (the leaves of ``VGPData``, or of a
``SideData``), the tensors ``_ALFuncs`` derives from them (the bounds,
with a box where one is given, the scales, the track centres), the line
search's exponents, ``max_total`` as a 0-dim tensor, the lane mask, a
0-dim flag (any lane active) and the loop's two device counters (the
condition kernel's launches and the trips). A trip reads them and
overwrites the state, the mask and the flag in place. A call copies its
data, its first state and its budget in and its result out, so the calls
of one key run one graph: a cold solve's, its warm re-solve's, every MPC
tick's.

The key: the NLP, the config with ``max_total`` taken out (it is a
buffer), the batch size, dtype and device, the KKT route, the
``kkt_solve`` (its ``graph_key`` where it has one, as the SPIKE solver of
``parallel/kkt.py`` does, else the object), and the data's tree with its
leaves' shapes and dtypes. A box adds nothing: it enters only the
bounds, [B, K, w] with or without one, and they are copied in.

First use of a key: the trip runs eagerly once on a side stream (that
builds the kernel and sets its shared-memory attribute, is torch's
warm-up before a capture, and is a real trip of the solve), then one
trip is captured and the loop's graph is built. A capture, a build or a
launch that fails raises: nothing falls back to another route.

Counts. The trips of a device loop are known on the card, in the loop's
two device counters. A solve never waits on them: :func:`settle` reads
the counters of every loop launched since the last read (one read for
all) and adds what they gained to ``COUNTS["trips"]``, to the launch
tallies (``ops.tally``: a graph's recorded launches of each kernel, for
each trip) and to ``graph_loop``'s counts. Call it before reading a count;
the cache calls it before it drops an entry.

Card time. Every insertion of a loop has a stamp slot of its own (a
program's loops one slot each by their position in its body, a loop
alone its entry's), where the condition kernel stamps the loop's card
time, runs and trips (``graph_loop.SLOT_FIELDS``); :func:`settle` reads
the slots in the same read and keeps what they gained as ``LAST_READ``.
Every trip of a device loop also stamps its line search's start and end
(``al_sqp._ls_stamp``: two one-thread kernels into the entry's
line-search buffer), and the condition kernel moves the trip's
line-search time into the slot, so each insertion has its line search's
card time beside its own; nothing is added on the host a trip.
While the span recorder (``utils/profiling.py``) is on, the trips
captured (and the programs holding them) are traced ones, of keys of
their own: a one-thread stamp
kernel closes each phase of a trip (``al_sqp.PHASES``) on the card, into
a buffer of the trip's entry that :func:`settle` reads too; and
:func:`program` opens spans (``program`` with ``program.key``,
``program.first_use``, ``program.copy_in``, ``program.launch`` with its
CUDA event pair, ``program.clone_out``), a loop launched alone one
(``loop``), and :func:`settle` one (``settle``). Off, the captured graphs
are exactly the untraced ones.

The solves. The JAX package jits each of its solves whole: ``solve``,
``solve_batched``, ``solve_multistart``, ``solve_batched_rescue`` and
``solve_batched_staged`` are each one program with no host decision
inside (phase 1, the gathers, the stages or the rescue's multistart, the
merges). :func:`run` runs each so on the static route, as a
:func:`program` whose body (:class:`_Solve`) is the solve's steps
(:mod:`.al_sqp`'s step generators) with each loop through :func:`loop`.
Inside a capture :func:`loop` captures the copy into its entry's buffers
and then adds the entry's device loop to the graph being captured
(``graph_loop.insert``), so the captured program is one graph: the
prologue (``_ALFuncs``, ``_start``), each loop, the glue between loops
and the result (``_finish``, the pick of the best start, the merges).
An MPC tick is then one copy in, one launch and one copy out. The draws
(the rescue's and multistart's bumps and shooting units) are made
before the program. The configs' ``max_total`` is a 0-dim argument, not
a field of the key; a cold solve (no ``z0``) and its warm re-solves are
two keys, which share their loop's entry. A program holds the entries of
its loops, so the cache never frees a trip that its graph runs and drops
such an entry only after its program; while a program is built, the
cache drops nothing. The staged solve's stage trips come back as 0-dim
tensors.

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

A program's first use runs the body eagerly on its buffers (its result
is the call's; a solve's loops run there on their entries' device
loops, each entry's first use included), then captures it; later calls
copy in, replay and clone out. A body calls the work below it directly
(the steps, ``plan_from_units``): :func:`program` called inside a body
or a capture raises.

The cache, the loops' and the programs' keys together, holds at most
MAX_ENTRIES keys and drops the least recently used first, also while the
entries' memory passes POOL_SHARE of the device's. An entry's memory is
its static buffers (state and data of B lanes, a program's arguments)
and its graphs' private pools, which keep every tensor the captured work
makes reserved for the launches: for a trip the line search's B·|grid|
candidates and their residuals, the assembly's intermediates, the
Hessian blocks, the KKT solve's scratch; a program's memory counts the
loops it holds. ``chip_smoke.py`` prints the pool bytes of each phase's
keys.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import time

import torch

from ..core.problem import (tree_flatten, tree_flatten_with_paths,
                            tree_map, tree_unflatten)
from ..ops import graph_loop, tally
from ..utils import profiling
from .al_sqp import (PHASES, SolverConfig, _active, _ALFuncs, _exponents,
                     _run_steps, _stamp, _trip)

#: the routes :func:`override` forces
ROUTES = ("eager", "static", "replay")
#: on the replay route, replays between a trip and the host's read of
#: its flag
LAG = 1
#: keys the cache holds at most
MAX_ENTRIES = 16
#: share of a device's memory the cached entries may hold
POOL_SHARE = 0.25
#: what runs have done in this process, for a run to read: graphs
#: captured and the seconds that took, trips run on static buffers (the
#: first, eager trip of a new key included) and of them the frozen ones
#: past the stop on the replay route, trips of the eager loop, calls of
#: a program on static buffers, and launches of graphs that hold a device
#: loop (a solve's loop, a staged solve's program)
COUNTS = dict(captures=0, capture_s=0.0, trips=0, idle_trips=0,
              eager_trips=0, programs=0, loop_graphs=0)
#: what the latest :func:`settle` that found loops to read gained:
#: ``loops``, one dict an insertion that ran (``body``: the program's
#: body, or "loop" for a loop alone; ``position``: its index among the
#: body's loops; ``lanes``; ``runs``, ``trips``, card ``ns`` and its
#: trips' line searches' card ``ls_ns``), and
#: ``phases``, one dict a traced trip's entry (``lanes``, ``trips`` and
#: card ``ns`` by phase of ``al_sqp.PHASES``)
LAST_READ = dict(loops=[], phases=[])

_CACHE: "collections.OrderedDict[tuple, _Captured]" = (
    collections.OrderedDict())
_OVERRIDE = {}
# the entries and programs whose device loops ran since their counters
# and stamps were last read
_UNREAD: "dict[_Captured, None]" = {}
# while a program runs its body for the first time or is captured: the
# entries of the loops it reaches, one a loop call
_PARTS = None
# while a program is captured: its loops' stamp slots, by position
_SLOTS = None


@contextlib.contextmanager
def override(route: str | None = None, lag: int | None = None):
    """Force, for the solves and programs inside, the route: "eager",
    "static" or "replay" (with its stop-test ``lag``); see the module's
    docstring. For the card's comparison of the routes and for the CPU
    tests of the static path."""
    if route not in (None,) + ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if lag is not None and (route != "replay" or lag < 0):
        raise ValueError(f"a lag (>= 0) is the replay route's, got {lag} "
                         f"on {route!r}")
    saved = dict(_OVERRIDE)
    _OVERRIDE.update(route=route, lag=lag)
    try:
        yield
    finally:
        _OVERRIDE.clear()
        _OVERRIDE.update(saved)


def settle() -> None:
    """Read, in one read a device, the device counters and stamps of the
    loops launched since the last read; add what the counters gained to
    COUNTS["trips"], the launch tallies and ``graph_loop``'s counts, and
    keep what the stamps gained as LAST_READ: before a count is read."""
    global _UNREAD, LAST_READ
    unread, _UNREAD = list(_UNREAD), {}
    if not unread:
        return
    with profiling.span("settle"):
        by_device = {}
        for c in unread:
            by_device.setdefault(c.device, []).append(c)
        values = {}
        for group in by_device.values():
            flat = torch.cat([t.reshape(-1) for c in group
                              for t in c.stamps()]).tolist()
            for c in group:
                n = sum(t.numel() for t in c.stamps())
                values[c], flat = flat[:n], flat[n:]
        read = dict(loops=[], phases=[])
        for c in unread:
            c._settle(values[c], read)
        LAST_READ = read


def _held() -> dict:
    """The cached entries and the loops' entries their programs hold,
    each once."""
    return dict.fromkeys(p for e in _CACHE.values() for p in (e, *e.parts))


def pool_bytes() -> int:
    """Bytes the cached graphs' pools reserved when they were captured."""
    return sum(e.pool_bytes for e in _held())


def static_bytes() -> int:
    """Bytes of the cached entries' static buffers."""
    return sum(e.static_bytes for e in _held())


def loop(F: _ALFuncs, cfg: SolverConfig, st: dict, max_total,
         agree=None) -> dict:
    """Run the loop from the state ``st`` under ``max_total`` (an int or
    a 0-dim tensor) to its end and return the final state: on static
    buffers, on a CUDA device as the device loop, unless the batch is on
    the CPU, ``agree`` is a collective or the batch has no lanes (it
    runs no trip)."""
    route = route_of(F.lb.device, agree is None and F.lb.shape[0] > 0)
    if route == "eager":
        return _eager(F, cfg, st, max_total, agree)
    if agree is not None:
        raise ValueError("a collective lane mask (agree) runs on the eager "
                         "loop; it cannot be captured")
    entry = _lookup(_key(F, cfg), lambda: _Entry(F, cfg, st))
    if _PARTS is not None:
        _PARTS.append(entry)
    entry.load(F, st, max_total)
    if route == "replay":
        lag = _OVERRIDE.get("lag")
        entry.run(LAG if lag is None else lag)
    else:
        entry.loop()
    out = {k: v.clone() for k, v in entry.st.items()}
    _evict(F.lb.device)
    return out


def run(steps, static: tuple, *args, agree=None):
    """``steps(*static, *args)`` to its end: ``steps`` is one of
    :mod:`.al_sqp`'s step generators (:func:`.al_sqp._batch_steps`,
    ``_single_steps``, ``_staged_steps``, ``_multistart_steps``,
    ``_rescue_steps``), ``static`` its leading arguments that are no
    tensors (the NLP, the configs with ``max_total`` taken out) and
    ``args`` the rest, the problem data first. On the static route one
    :func:`program` whose body is the steps with every loop captured into
    it (``static`` the body's key, with the tree of ``args``); on the
    others, and for a collective ``agree``, the steps with each loop
    through :func:`loop`."""
    data = args[0]
    if agree is None and route_of(data.x0.device,
                                  data.x0.numel() > 0) == "static":
        return program(_Solve(steps, static), *args)
    return _run_steps(steps(*static, *args),
                      functools.partial(loop, agree=agree))


@dataclasses.dataclass(frozen=True)
class _Solve:
    """A solve's body for :func:`program`: a step generator and its
    static arguments, both of the key."""

    steps: object
    static: tuple

    @property
    def __name__(self) -> str:
        return self.steps.__name__

    def __call__(self, *args):
        return _run_steps(self.steps(*self.static, *args), loop)


def route_of(device, capturable: bool = True) -> str:
    """The route of work on ``device``: the overridden one, else
    "static" (static buffers and graphs) on a CUDA device where the work
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
    tree of tensors, cloned out of the buffers. A body calls the work
    below it directly: a program called while another runs its body (or
    inside any capture) raises."""
    tree = (args, kwargs)
    device = next(a.device for a in tree_flatten(tree)
                  if isinstance(a, torch.Tensor))
    if _PARTS is not None or (device.type == "cuda"
                              and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"program({getattr(body, '__name__', body)!r}) inside another "
            "program's body or a capture: a body calls the steps and "
            "plan_from_units directly")
    if route_of(device) == "eager":
        return body(*args, **kwargs)
    with profiling.span("program", body=_name(body)):
        with profiling.span("program.key"):
            key = (body, str(device), _spec(tree), profiling.enabled())
            entry = _lookup(key, lambda: _Program(body, tree))
        out = entry.run(tree)
        _evict(device)
    return out


def _name(body) -> str:
    return getattr(body, "__name__", type(body).__name__)


def _spec(tree) -> tuple:
    """A tree's part of a key: each tensor leaf by its shape and dtype,
    every other leaf by its value (a KKT solver by its ``graph_key``,
    where it has one)."""
    return tuple(
        (path, tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
        else (path, type(a), getattr(a, "graph_key", a))
        for path, a in tree_flatten_with_paths(tree))


def _eager(F, cfg, st, max_total, agree):
    exps = _exponents(cfg, F.dtype, F.lb.device)
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
        profiling.enabled(),
    )


def _lookup(key, make):
    """The cached entry of ``key`` (made by ``make()`` on its first use),
    now the most recently used."""
    entry = _CACHE.pop(key, None)
    if entry is None:
        entry = make()
    _CACHE[key] = entry
    return entry


def _evict(device) -> None:
    if _PARTS is not None:  # a program is being built: its loops stay
        return
    limit = (POOL_SHARE * torch.cuda.get_device_properties(device)
             .total_memory if device.type == "cuda" else float("inf"))
    while len(_CACHE) > MAX_ENTRIES or (
            len(_CACHE) > 1 and pool_bytes() + static_bytes() > limit):
        settle()
        # the least recently used key that no cached program holds (a
        # program's loops go with it, though their keys are not used
        # while it replays)
        held = {p for e in _CACHE.values() for p in e.parts}
        del _CACHE[next(k for k, e in _CACHE.items() if e not in held)]


def _buffer(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _Captured:
    """Static buffers and, on a CUDA device, a graph captured from
    :meth:`step`: what a trip's entry and a program's share."""

    graph = None
    #: the launches the capture recorded: (tally, record) pairs
    records = ()
    pool_bytes = 0
    static_bytes = 0
    #: the entries of the loops a program's graph runs
    parts = ()
    #: the stamp slots of the loops inserted into its graph, [n, SLOT]
    slots = None
    #: the values of :meth:`stamps` at the last read
    stamps_read = None

    def _capture(self, keep_graph: bool = False):
        """Capture one :meth:`step` and return what it returned, the
        graph's output tensors; ``keep_graph`` keeps the graph itself,
        for a loop's while node to clone."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with tally.recording() as records:
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved()
                out = self.step()
                self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph, self.records = graph, records
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += time.perf_counter() - t0
        return out

    def _replayed(self, n: int) -> None:
        """Count the launches of ``n`` replays."""
        tally.replayed(self.records, n)

    def stamps(self) -> list:
        """The device tensors :func:`settle` reads: the loops' slots."""
        return [] if self.slots is None else [self.slots]

    def _gained(self, values: list) -> list:
        """What ``values`` (the flat read of :meth:`stamps`) gained since
        the last read; remembers them."""
        old = self.stamps_read or [0] * len(values)
        self.stamps_read = values
        return [v - o for v, o in zip(values, old)]

    def _loops(self, gained: list, body: str, lanes: list, read) -> None:
        """Add the loops' records of ``gained`` slots to ``read``."""
        S = graph_loop.SLOT
        for i, B in enumerate(lanes):
            slot = dict(zip(graph_loop.SLOT_FIELDS, gained[S * i:S * i + S]))
            if slot["runs"] > 0:
                read["loops"].append(dict(
                    body=body, position=i, lanes=B, runs=slot["runs"],
                    trips=slot["trips"], ns=slot["ns"],
                    ls_ns=slot["ls_ns"]))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Program(_Captured):
    """One program key's argument buffers and, on a CUDA device, the
    graph of its body and the graph's outputs."""

    #: the entry of each loop call of the body, in order (its position)
    loops = ()
    out_bytes = 0

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
        self.device = self.buffers[0].device

    def _settle(self, values: list, read) -> None:
        self._loops(self._gained(values), _name(self.body),
                    [e.F.lb.shape[0] for e in self.loops], read)

    def step(self):
        """The body on the buffers: what the graph captures."""
        return self.body(*self.args, **self.kwargs)

    def _collect(self, run):
        """``run()``, keeping the entries of the loops it reaches as
        ``parts`` (the cache drops nothing meanwhile)."""
        global _PARTS
        saved, _PARTS = _PARTS, []
        try:
            out = run()
            self.loops = tuple(_PARTS)
            self.parts = tuple(dict.fromkeys(_PARTS))
        finally:
            _PARTS = saved
        return out

    def _capture_loops(self):
        """Capture the body, each loop inserted with its own stamp slot."""
        global _SLOTS
        self.slots = torch.zeros((len(self.loops), graph_loop.SLOT),
                                 dtype=torch.int64, device=self.device)
        saved, _SLOTS = _SLOTS, self.slots
        try:
            return self._capture()
        finally:
            _SLOTS = saved

    def run(self, tree):
        """Copy a call's tensors in, run the body (on a CUDA device the
        graph, captured after the key's first, eager run) and return its
        result cloned out of the buffers."""
        with profiling.span("program.copy_in", bytes=self.static_bytes):
            for b, a in zip(self.buffers, (a for a in tree_flatten(tree)
                                           if isinstance(a, torch.Tensor))):
                b.copy_(a)
        COUNTS["programs"] += 1
        dev = self.device
        if dev.type != "cuda":  # the body itself, every call
            with profiling.span("program.launch"):
                out = self._collect(self.step)
            self.out_bytes = self.out_bytes or _nbytes(tree_flatten(out))
        elif self.graph is None:
            with profiling.span("program.first_use"), torch.cuda.device(dev):
                out = self._collect(self.step)
                self.out = self._collect(self._capture_loops)
                self.out_bytes = _nbytes(tree_flatten(self.out))
        else:
            with profiling.span("program.launch", card=dev), \
                    torch.cuda.device(dev):
                self.graph.replay()
            self._replayed(1)
            if self.parts:
                COUNTS["loop_graphs"] += 1
                _UNREAD.update(dict.fromkeys(self.parts))
                _UNREAD[self] = None
            out = self.out
        with profiling.span("program.clone_out", bytes=self.out_bytes):
            return tree_unflatten(out, [t.clone() for t in tree_flatten(out)])


class _Entry(_Captured):
    """One loop key's static buffers and, on a CUDA device, its trip's
    graph and the loop's graph around it."""

    looped = None

    def __init__(self, F: _ALFuncs, cfg: SolverConfig, st: dict):
        self.cfg = cfg
        # F's other fields (the NLP, the route, kkt_solve, the sizes) are
        # the key's; its tensors and its data become buffers
        self.F = copy.copy(F)
        self.F.data = tree_map(_buffer, F.data)
        for name, t in vars(F).items():
            if isinstance(t, torch.Tensor):
                setattr(self.F, name, _buffer(t))
        self.st = {k: _buffer(v) for k, v in st.items()}
        dev = F.lb.device
        self.exps = _exponents(cfg, F.dtype, dev)
        self.max_total = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((F.lb.shape[0],), dtype=torch.bool,
                                  device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        # the device loop's counters (the condition kernel's launches,
        # the trips) and their values at the last read
        self.counts = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.read = (0, 0)
        # the stamp slot of the loop alone (or inserted outside a
        # program); on a card the trip's line-search buffer, which its
        # two line-search stamps write and the condition kernel empties
        # into the slot; a traced trip's phase buffer (the last stamp,
        # then the ns of each phase), which its stamps write
        self.device = dev
        self.slot = torch.zeros((graph_loop.SLOT,), dtype=torch.int64,
                                device=dev)
        self.ls = None
        if dev.type == "cuda":
            self.ls = torch.zeros((graph_loop.LS,), dtype=torch.int64,
                                  device=dev)
            self.F.ls_stamp = functools.partial(graph_loop.stamp, self.ls)
        self.phases = None
        if profiling.enabled() and dev.type == "cuda":
            self.phases = torch.zeros((1 + len(PHASES),), dtype=torch.int64,
                                      device=dev)
            self.F.stamp = functools.partial(graph_loop.stamp, self.phases)
        self.static_bytes = _nbytes(self._tensors())

    def _tensors(self):
        yield from tree_flatten(self.F.data)
        yield from (t for t in vars(self.F).values()
                    if isinstance(t, torch.Tensor))
        yield from self.st.values()
        yield from (self.exps, self.max_total, self.active, self.flag)
        yield from self.stamps()
        if self.ls is not None:
            yield self.ls

    def stamps(self) -> list:
        """The device tensors :func:`settle` reads: the counters, the
        slot and a traced trip's phases."""
        return [self.counts, self.slot] + (
            [] if self.phases is None else [self.phases])

    def _settle(self, values: list, read) -> None:
        launches, trips = values[:2]
        gained = launches - self.read[0], trips - self.read[1]
        self.read = (launches, trips)
        COUNTS["trips"] += gained[1]
        self._replayed(gained[1])
        graph_loop.counted(*gained)
        rest, S = self._gained(values[2:]), graph_loop.SLOT
        B = self.F.lb.shape[0]
        self._loops(rest[:S], "loop", [B], read)
        if self.phases is not None and any(rest[S + 1:]):
            read["phases"].append(dict(lanes=B, trips=gained[1],
                                       ns=dict(zip(PHASES, rest[S + 1:]))))

    def load(self, F: _ALFuncs, st: dict, max_total) -> None:
        """Copy a call's data, derived tensors, first state and budget
        (an int or a 0-dim tensor) in. It reads nothing on the host, so
        a staged solve's glue captures it."""
        for b, a in zip(tree_flatten(self.F.data), tree_flatten(F.data)):
            b.copy_(a)
        for name, b in vars(self.F).items():
            if isinstance(b, torch.Tensor):
                b.copy_(getattr(F, name))
        for k, b in self.st.items():
            b.copy_(st[k])
        if isinstance(max_total, torch.Tensor):
            self.max_total.copy_(max_total)
        else:
            self.max_total.fill_(max_total)
        self._mark()

    def _mark(self) -> None:
        act = _active(self.cfg, self.st, self.max_total)
        self.active.copy_(act)
        self.flag.copy_(act.any())

    def step(self) -> None:
        """One trip in place: what the graph captures. It reads nothing
        on the host. A traced trip stamps its phases."""
        _stamp(self.F, -1)
        new = _trip(self.F, self.cfg, self.st, self.exps, self.active)
        for k, b in self.st.items():
            b.copy_(new[k])
        self._mark()
        _stamp(self.F, len(PHASES) - 1)

    def _warm(self) -> None:
        """One eager trip on a side stream: it builds what the trip
        launches (the KKT kernel, its shared-memory attribute), and is
        torch's warm-up before a capture."""
        here = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.step()
        here.wait_stream(side)

    def _first_use(self) -> None:
        """The first trip, eager (a real trip of the solve), then its
        capture."""
        self._warm()
        COUNTS["trips"] += 1
        self._capture(keep_graph=True)

    def loop(self) -> None:
        """Trips while the flag is set, tested before the first: on a
        CUDA device one launch of the loop's graph (its counters are read
        by :func:`settle`), or inside a capture the loop added to it; on
        the CPU the host's ``while``."""
        dev = self.flag.device
        if dev.type != "cuda":
            COUNTS["trips"] += graph_loop.plain(self.step, self.flag)
            return
        with torch.cuda.device(dev):
            if torch.cuda.is_current_stream_capturing():
                if self.graph is None:
                    raise RuntimeError("a loop's first use runs before a "
                                       "capture that holds it")
                # a program's slot of this loop's position, else its own
                slot = (self.slot if _SLOTS is None
                        else _SLOTS[len(_PARTS) - 1])
                graph_loop.insert(self.graph.raw_cuda_graph(), self.flag,
                                  self.counts, slot, self.ls)
                return
            with profiling.span("loop", card=dev, lanes=self.F.lb.shape[0]):
                if self.graph is None:
                    self._first_use()
                if self.looped is None:
                    self.looped = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.looped):
                        graph_loop.insert(self.graph.raw_cuda_graph(),
                                          self.flag, self.counts, self.slot,
                                          self.ls)
                self.looped.replay()
        COUNTS["loop_graphs"] += 1
        _UNREAD[self] = None

    def run(self, lag: int) -> None:
        """The replay route: trips until the flag read ``lag`` trips late
        is False; on a CUDA device every trip after a key's first is a
        replay of its graph."""
        dev = self.flag.device
        if dev.type != "cuda":
            self._drive(self.step, lag)
            return
        with torch.cuda.device(dev):
            if self.graph is None:
                self._first_use()
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
