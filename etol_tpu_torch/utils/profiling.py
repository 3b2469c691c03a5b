"""Tracing and phase timing.

Counterpart of ``etol_tpu/utils/profiling.py``. The reference has no
profiling of any kind (SURVEY.md §5 — only eOMPL wraps one wall-clock
around solve). Here: ``torch.profiler`` traces for kernel-level
inspection plus lightweight host-side phase timers.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

from ..core.problem import tree_flatten

_PHASES: Dict[str, list] = defaultdict(list)


def sync(tree) -> None:
    """Wait for the device work behind ``tree``'s tensors: a CUDA
    synchronize when one of them lies on a CUDA device (CPU tensors are
    done when they are returned)."""
    devices = {a.device for a in tree_flatten(tree) if a.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, result=None) -> Iterator[None]:
    """Wall-time a phase; ``result`` (a tree of tensors the phase fills
    in place, or that exists before it) is synced on exit before the time
    is recorded."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result is not None:
            sync(result)
        _PHASES[name].append(time.perf_counter() - t0)


def phase_report(reset: bool = True) -> Dict[str, dict]:
    """Calls, total seconds and mean milliseconds of every timed phase."""
    out = {}
    for name, times in _PHASES.items():
        out[name] = {
            "calls": len(times),
            "total_s": sum(times),
            "mean_ms": 1e3 * sum(times) / max(len(times), 1),
        }
    if reset:
        _PHASES.clear()
    return out


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
