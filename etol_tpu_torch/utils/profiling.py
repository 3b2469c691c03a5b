"""Spans, phase timing and traces.

Counterpart of ``etol_tpu/utils/profiling.py``. The reference has no
profiling of any kind (SURVEY.md §5 — only eOMPL wraps one wall-clock
around solve). Here: one span recorder on the host's clock, which the
port's layers open where their work happens, with the card's intervals
of its launches on the same clock; ``phase_timer`` / ``phase_report``
on the same records; and ``torch.profiler`` traces for kernel-level
inspection.

The recorder is off until :func:`enable`. While off, :func:`span` tests
one module global and returns a shared no-op context: nothing is
recorded, no event is made and nothing waits. While on, every span is a
:class:`Span` record (an id, its parent's and its root's ids — the root
is the outermost span of a call, shared by every span under it — the
name, the host's start and end from ``time.perf_counter_ns()`` and small
attributes); a span opened with ``card=device`` on a CUDA device also
records a CUDA event pair around its body on the current stream, read
later as the card's interval. :func:`enable` and :func:`mark` pair a
host time with a CUDA event at one synchronised instant, so a card
interval maps to host nanoseconds. Records stay in memory until
:func:`clear` or :func:`phase_report` drops them; :func:`export_chrome` writes host spans
and card intervals as one Chrome trace. One thread records at a time.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from ..core.problem import tree_flatten

_ON = False
# finished records, in the order they closed, and the open ones
_RECORDS: List["Span"] = []
_STACK: List["Span"] = []
_IDS = itertools.count(1)
# the latest pairing of the host's clock with the card's: (host ns, a
# CUDA event recorded at that instant) per device index
_CLOCKS: Dict[int, tuple] = {}
# host ns of the latest mark()
_MARK = 0


class Span:
    """One span: a context manager whose record is kept on exit."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns",
                 "attrs", "card", "_events")

    def __init__(self, name: str, attrs: dict, card=None):
        self.id = next(_IDS)
        self.name = name
        self.attrs = attrs
        self.parent = self.root = None
        self.start_ns = self.end_ns = 0
        #: the card's interval, (start ns on the host's clock, ns), once
        #: read by records()
        self.card = None
        self._events = None
        if card is not None and torch.device(card).type == "cuda":
            index = torch.device(card).index
            index = torch.cuda.current_device() if index is None else index
            if index not in _CLOCKS:
                _pair(index)
            # the clock paired before the span opens, and the events
            self._events = (index, _CLOCKS[index], None, None)

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if _STACK:
            self.parent, self.root = _STACK[-1].id, _STACK[-1].root
        else:
            self.root = self.id
        _STACK.append(self)
        self.start_ns = time.perf_counter_ns()
        if self._events is not None:
            a = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(self._events[0]))
            self._events = self._events[:2] + (a, None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            b = torch.cuda.Event(enable_timing=True)
            b.record(torch.cuda.current_stream(self._events[0]))
            self._events = self._events[:3] + (b,)
        self.end_ns = time.perf_counter_ns()
        _STACK.pop()
        _RECORDS.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def _read_card(self) -> None:
        """The card's interval from the event pair (waits for the second
        event), on the clock paired before the span opened."""
        if self._events is None or self.card is not None:
            return
        _, (host_ns, origin), a, b = self._events
        b.synchronize()
        self.card = (host_ns + round(origin.elapsed_time(a) * 1e6),
                     round(a.elapsed_time(b) * 1e6))


class _Off:
    """The shared context :func:`span` returns while the recorder is
    off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, card=None, **attrs):
    """A span named ``name`` with attributes ``attrs``; with ``card`` (a
    CUDA device) also the card's interval of the work queued inside it
    on the current stream. The shared no-op while the recorder is off."""
    if not _ON:
        return _OFF
    return Span(name, attrs, card)


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Switch the recorder on and pair the clocks (:func:`mark`)."""
    global _ON
    _ON = True
    mark()


def disable() -> None:
    """Switch the recorder off; what it recorded stays."""
    global _ON
    _ON = False


def mark() -> int:
    """Pair ``time.perf_counter_ns()`` with a CUDA event on every
    initialised card at one synchronised instant, and return that host
    time: a harness calls it at its window's start, and :func:`records`
    with ``since=`` the returned time reads the window's spans."""
    global _MARK
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for index in range(torch.cuda.device_count()):
            _pair(index)
    _MARK = time.perf_counter_ns()
    return _MARK


def _pair(index: int) -> None:
    with torch.cuda.device(index):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        _CLOCKS[index] = (time.perf_counter_ns(), ev)


def last_mark() -> int:
    """Host ns of the latest :func:`mark` (0 before the first)."""
    return _MARK


def clock(index: int = 0) -> Optional[tuple]:
    """(host ns, CUDA event) of card ``index``'s latest pairing."""
    return _CLOCKS.get(index)


def records(since: int = 0) -> List[Span]:
    """The finished spans that started at or after host ns ``since``,
    their card intervals read (this waits for the card)."""
    out = [r for r in _RECORDS if r.start_ns >= since]
    for r in out:
        r._read_card()
    return out


def clear() -> None:
    """Drop every finished record."""
    _RECORDS.clear()


def self_ns(recs: List[Span]) -> Dict[int, int]:
    """Each record's own host ns: its time less its children's (among
    ``recs``), by id."""
    own = {r.id: r.ns for r in recs}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= r.ns
    return own


def summary(recs: List[Span]) -> Dict[str, dict]:
    """Calls, total seconds, mean milliseconds and self seconds of the
    records, by name."""
    own = self_ns(recs)
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, dict(calls=0, total_s=0.0, self_s=0.0))
        s["calls"] += 1
        s["total_s"] += r.ns / 1e9
        s["self_s"] += own[r.id] / 1e9
    for s in out.values():
        s["mean_ms"] = 1e3 * s["total_s"] / s["calls"]
    return out


def sizes(*draws) -> dict:
    """``elements`` and ``bytes`` of the tensors in ``draws`` (tensors,
    tuples of tensors and Nones), for a span's attributes: {} while the
    recorder is off."""
    if not _ON:
        return {}
    ts = [t for d in draws for t in (d if isinstance(d, tuple) else (d,))
          if t is not None]
    return dict(elements=sum(t.numel() for t in ts),
                bytes=sum(t.numel() * t.element_size() for t in ts))


def sync(tree) -> None:
    """Wait for the device work behind ``tree``'s tensors: a CUDA
    synchronize when one of them lies on a CUDA device (CPU tensors are
    done when they are returned)."""
    devices = {a.device for a in tree_flatten(tree) if a.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, result=None) -> Iterator[None]:
    """Time a phase as a span named ``name``, recorded whether or not
    the recorder is on (an explicit request); ``result`` (a tree of
    tensors the phase fills in place, or that exists before it) is
    synced before the span closes, so the time covers its device work.
    Without ``result`` nothing waits: the time is the host's."""
    with Span(name, {}):
        try:
            yield
        finally:
            if result is not None:
                sync(result)


def phase_report(reset: bool = True) -> Dict[str, dict]:
    """Calls, total seconds and mean milliseconds of the recorded spans
    by name (:func:`summary`); ``reset`` drops the records."""
    out = {n: {k: s[k] for k in ("calls", "total_s", "mean_ms")}
           for n, s in summary(records()).items()}
    if reset:
        clear()
    return out


def export_chrome(path: str, recs: Optional[List[Span]] = None,
                  card_intervals=()) -> str:
    """Write ``recs`` (default: every finished record; records() has read
    their card intervals) as a Chrome trace
    at ``path``: host spans on the host's track, their card intervals and
    ``card_intervals`` (``(name, start ns, ns)`` on the host's clock, a
    harness's own) on the card's, in microseconds from the earliest.
    View it in Perfetto or ``chrome://tracing``."""
    recs = records() if recs is None else recs
    starts = [r.start_ns for r in recs] + [s for _, s, _ in card_intervals]
    t0 = min(starts) if starts else 0
    events = [dict(ph="M", pid=0, tid=t, name="thread_name",
                   args=dict(name=n)) for t, n in ((0, "host"), (1, "card"),
                                                   (2, "card (harness)"))]
    for r in recs:
        args = dict(r.attrs, id=r.id, parent=r.parent, root=r.root)
        events.append(dict(ph="X", pid=0, tid=0, name=r.name,
                           ts=(r.start_ns - t0) / 1e3, dur=r.ns / 1e3,
                           args={k: str(v) for k, v in args.items()}))
        if r.card is not None:
            events.append(dict(ph="X", pid=0, tid=1, name=r.name,
                               ts=(r.card[0] - t0) / 1e3,
                               dur=r.card[1] / 1e3, args=dict(id=r.id)))
    for name, start, ns in card_intervals:
        events.append(dict(ph="X", pid=0, tid=2, name=name,
                           ts=(start - t0) / 1e3, dur=ns / 1e3))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(dict(traceEvents=events), fh)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of a region (host ops, and the card's
    kernels where CUDA is available), written to
    ``<logdir>/trace.json`` as a Chrome trace on exit; view it in
    Perfetto or ``chrome://tracing``. Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
