"""Card time from CUDA events: in a traced run every launch of a captured
program (a ``torch.cuda.CUDAGraph`` replay, which is how every solve and the
seeds run on the card) is bracketed by two timing events and filed under the
benchmark's span that made it (``perfbench.seeds``, ``perfbench.solve``,
``perfbench.episode``, ``perfbench.tick``).

The profiler is blind inside a graph's conditional (while) bodies, so these
events, not the profiler, are the card's time.
"""
from __future__ import annotations

import contextlib

import torch


class Spans:
    """The traced program launches of a window: (span, op, start event, end
    event), and the window's origin event."""

    def __init__(self, on: bool):
        self.on = on
        self.span = None
        self.op = -1
        self.records = []
        self.origin = None
        self._orig = None

    def __enter__(self):
        if self.on:
            self._orig = orig = torch.cuda.CUDAGraph.replay
            spans = self

            def replay(graph):
                if spans.span is None:
                    return orig(graph)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = orig(graph)
                b.record()
                spans.records.append((spans.span, spans.op, a, b))
                return out

            torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            torch.cuda.CUDAGraph.replay = self._orig
            self._orig = None

    def start(self):
        """Mark the window's start on the card's clock."""
        if self.on:
            self.origin = torch.cuda.Event(enable_timing=True)
            self.origin.record()

    @contextlib.contextmanager
    def __call__(self, name: str, op: int):
        saved = self.span, self.op
        self.span, self.op = name, op
        try:
            yield
        finally:
            self.span, self.op = saved

    def intervals(self):
        """[(span, op, start ms, end ms)] on the window's clock, in launch
        order; call after the card has finished."""
        if not self.on or self.origin is None:
            return []
        return [(s, op, self.origin.elapsed_time(a), self.origin.elapsed_time(b))
                for s, op, a, b in self.records]


def busy_and_gaps(intervals, window_ms: float):
    """(busy ms: the union of the launches' intervals, idle gaps
    [(label, ms)] summed by label: "before <span>" for the card's wait
    before a launch, "after the last launch" to the window's end)."""
    busy, end = 0.0, 0.0
    gaps = {}
    for span, _, a, b in sorted(intervals, key=lambda r: r[2]):
        if a > end:
            gaps[f"before {span}"] = gaps.get(f"before {span}", 0.0) + a - end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if window_ms > end:
        gaps["after the last launch"] = window_ms - end
    return busy, gaps

