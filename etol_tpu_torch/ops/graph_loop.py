"""The solver loop as a while node of a CUDA graph around a captured
trip, its stop test on the card.

Counterpart of the JAX package's ``lax.while_loop`` around its solver
trip (``etol_tpu/solve/al_sqp.py``, ``_solve_single``), whose cond XLA
runs on the device. The source is ``etol_tpu_torch/csrc/graph_loop.cu``:
a one-thread condition kernel that sets a conditional node's handle from
the trip's 0-dim flag and counts its launches and the trips, and a host
function that adds such a loop to the graph torch is capturing (CUDA
12.4 or later, for conditional nodes whose body holds memsets and
memcopies). It is compiled by ``nvcc`` for ``sm_90a`` into
``build/etol_tpu_torch/`` at first use, as ``bt_cuda`` builds its kernel,
and loaded with ctypes.

:func:`insert` adds a loop to the current stream's capture: a solve's
loop is a torch graph that holds only it, the staged solve's loops sit
between the captured work before and after them, and each graph is
launched as torch launches any (``CUDAGraph.replay``). A build or an
insert that fails raises, as do a missing ``nvcc`` and a CUDA runtime or
CUDA driver without conditional nodes: nothing falls back to the
host-driven loop. :func:`plain` is the plain version, the host's
``while`` on the flag, which the CPU runs.

Counts: ``LAUNCHES`` (the condition kernel's) and ``TRIPS`` (the trips
run under it) are read from the loops' device counters by their owner
(``solve/trip_graph.py``) and added with :func:`counted`.

Card time: a loop inserted with a stamp slot (``SLOT`` int64 on the card)
gains its own time, stamped from ``%globaltimer`` by the condition
kernel when the loop starts and when its flag ends it, with its runs
and trips (``SLOT_FIELDS``); no launch and no node is added. Inserted
with the trip's line-search buffer too (``LS`` int64 on the card, which
two :func:`stamp` launches in the trip fill), the slot gains the trip's
line-search time, moved in by the condition kernel after each trip.
:func:`stamp` launches a one-thread kernel that adds the time since a
buffer's last stamp to one of its phases (a traced trip's phases, every
trip's line search, ``solve/trip_graph.py``).
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import bt_cuda

#: launches of the condition kernel, read from the device
LAUNCHES = 0
#: trips run under the condition kernel, read from the device
TRIPS = 0
#: the CUDA runtime and CUDA driver versions (1000 major + 10 minor) the
#: loaded library reports, once built
VERSIONS = None
#: what the build printed and how long it took (None: built already)
BUILD_LOG = ""
BUILD_SECONDS = None
#: conditional nodes whose body may hold memsets and memcopies
MIN_VERSION = 12040
#: a loop's stamp slot: the start of its latest run (%globaltimer ns), its
#: card ns, trips and runs summed over its runs, and the card ns of its
#: trips' line searches
SLOT_FIELDS = ("start", "ns", "trips", "runs", "ls_ns")
SLOT = len(SLOT_FIELDS)
#: a trip's line-search buffer: the latest line search's start
#: (%globaltimer ns) and the line searches' ns since the loop last read it
LS = 2

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "csrc", "graph_loop.cu"
)
_LIB = None


def build() -> ctypes.CDLL:
    """Compile (when not built yet) and load the library and its kernel;
    raise where the CUDA runtime or the CUDA driver has no conditional
    nodes."""
    global _LIB, VERSIONS, BUILD_LOG, BUILD_SECONDS
    if _LIB is None:
        path, BUILD_LOG, BUILD_SECONDS = bt_cuda.compile_source(_SOURCE)
        lib = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        for name, args in (
                ("etol_graph_loop_insert", [vp, vp, vp, vp, vp, vp]),
                ("etol_phase_stamp", [vp, vp, ctypes.c_int]),
                ("etol_graph_loop_load", []),
                ("etol_graph_loop_versions", [ctypes.POINTER(ctypes.c_int)]
                 * 2)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        runtime, cuda_driver = ctypes.c_int(), ctypes.c_int()
        _check(lib.etol_graph_loop_versions(ctypes.byref(runtime),
                                            ctypes.byref(cuda_driver)),
               "cudaDriverGetVersion")
        VERSIONS = dict(runtime=runtime.value, cuda_driver=cuda_driver.value)
        if min(VERSIONS.values()) < MIN_VERSION:
            raise RuntimeError(
                f"graph_loop: CUDA runtime {runtime.value} / CUDA driver "
                f"{cuda_driver.value} has no conditional graph nodes with "
                f"memsets and memcopies in their body (needs {MIN_VERSION})")
        _check(lib.etol_graph_loop_load(), "loading the condition kernel")
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"graph_loop: {what} failed: cudaError {rc}")


def insert(trip: int, flag: torch.Tensor, counts: torch.Tensor,
           stamp: torch.Tensor = None, ls: torch.Tensor = None) -> None:
    """Add to the current stream's capture, after the work captured so
    far, a loop: while ``flag`` (a 0-dim bool on the card, written by the
    trip) is true, the captured graph ``trip`` (a ``cudaGraph_t``,
    ``torch.cuda.CUDAGraph(keep_graph=True)``'s ``raw_cuda_graph()``,
    cloned in; the caller keeps its pool alive). The flag is tested
    before the first trip. ``counts`` (two int64 on the card) gains the
    condition kernel's launches and the trips; ``stamp`` (``SLOT`` int64
    on the card, or None) this insertion's card time, runs and trips,
    and with ``ls`` (the trip's ``LS`` int64 line-search buffer on the
    card, or None) its trips' line-search time. The flag, the counts,
    the slot and the buffer must outlive the captured graph."""
    if flag.dtype != torch.bool or flag.dim() != 0 or \
            flag.device.type != "cuda":
        raise ValueError("the loop's flag must be a 0-dim bool on a card")
    if counts.dtype != torch.int64 or tuple(counts.shape) != (2,) or \
            counts.device != flag.device or not counts.is_contiguous():
        raise ValueError("the loop's counts must be two int64 beside the "
                         "flag")
    if stamp is not None and (
            stamp.dtype != torch.int64 or tuple(stamp.shape) != (SLOT,)
            or stamp.device != flag.device or not stamp.is_contiguous()):
        raise ValueError(f"a loop's stamp slot must be {SLOT} int64 beside "
                         "the flag")
    if ls is not None and (
            stamp is None or ls.dtype != torch.int64
            or tuple(ls.shape) != (LS,) or ls.device != flag.device
            or not ls.is_contiguous()):
        raise ValueError(f"a trip's line-search buffer must be {LS} int64 "
                         "beside the flag, with a stamp slot")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("graph_loop: a loop is added to a capture; the "
                           "current stream is not capturing")
    stream = torch.cuda.current_stream().cuda_stream
    _check(build().etol_graph_loop_insert(
        stream, trip, flag.data_ptr(), counts.data_ptr(),
        None if stamp is None else stamp.data_ptr(),
        None if ls is None else ls.data_ptr()),
        "adding the loop to the capture")


def stamp(buf: torch.Tensor, phase: int) -> None:
    """On the current stream (captured where it captures): ``buf`` (an
    int64 vector on the card, its first entry the last stamp) gains the
    %globaltimer ns since its last stamp in ``buf[1 + phase]``, and is
    stamped; ``phase`` -1 only stamps."""
    if buf.dtype != torch.int64 or buf.device.type != "cuda" or \
            not buf.is_contiguous() or not -1 <= phase < buf.numel() - 1:
        raise ValueError(f"a phase stamp needs an int64 vector on a card "
                         f"with a slot for phase {phase}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    _check(build().etol_phase_stamp(stream, buf.data_ptr(), phase),
           "launching the phase stamp")


def counted(launches: int, trips: int) -> None:
    """Add the condition kernel's launches and the trips that a loop's
    device counters gained."""
    global LAUNCHES, TRIPS
    LAUNCHES += launches
    TRIPS += trips


def plain(step, flag: torch.Tensor) -> int:
    """The plain version of a loop: ``step()`` while ``flag`` reads true
    on the host, tested before the first step; returns the trips."""
    trips = 0
    while bool(flag):
        step()
        trips += 1
    return trips
