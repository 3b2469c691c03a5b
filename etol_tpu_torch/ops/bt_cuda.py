"""Batched block-tridiagonal KKT solve: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``etol_tpu/ops/pallas_bt.py::_bt_kernel``
(reached there through ``solve_lanes``/``solve_auto``). The kernel source
is ``etol_tpu_torch/csrc/bt_solve.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into ``build/etol_tpu_torch/`` at first use, under a file
name keyed by a hash of the source and flags, and loaded with ctypes.

:func:`solve` takes D [B, K, w, w], O [B, K-1, w, w], r [B, K, w] and
returns x [B, K, w] with H x = r, after one refinement pass against the
stored factor. On a CPU tensor it computes the plain version
(:func:`etol_tpu_torch.solve.btridiag.solve_refined`); on a CUDA tensor
it launches the kernel or raises — there is no fallback. Node widths
above 9 are an error here; the solver routes them to cyclic reduction
from the width alone (``solve/al_sqp.py``), before any launch.

The source holds two kernels, and :func:`plan` chooses between them
from (K, w) alone: the shared-memory kernel (a lane split across w
threads of a warp, the factor in shared memory, the native layout)
wherever one lane's factor fits a block's shared memory, and the stream
kernel (the same lane split and node step, the factor in a device-memory
scratch array, read back a chunk of nodes at a time through two buffers
in shared memory) for longer horizons.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..solve import btridiag
from .tally import Tally

#: kernel launches made by :func:`solve` in this process, by (variant, K,
#: w, batch size), those a CUDA graph captured counted at each replay; a
#: run reads it to show that its KKT solves went through the kernel
TALLY = Tally()
#: ``TALLY.by``, under the name the benchmark's harness reads
LAUNCHES_BY = TALLY.by

MAX_W = 9
WARP = 32
#: dynamic shared memory one block may ask for on an H100
SMEM_LIMIT = 232_448
_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "csrc", "bt_solve.cu"
)
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "etol_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
#: what the last build printed (``-Xptxas -v``: registers, spills) and how
#: long it took, for the run's log
BUILD_LOG = ""
BUILD_SECONDS = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernel "
        f"{_SOURCE} cannot be built"
    )


def library_path(source: str = _SOURCE) -> str:
    """Where the library built from ``source`` lives: named after the
    source's file and keyed by its text and the flags."""
    with open(source, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def compile_source(source: str = _SOURCE) -> tuple[str, str, float | None]:
    """Compile ``source`` with NVCC_FLAGS when it is not built yet;
    returns (library path, what nvcc printed, seconds it took; None when
    it was built already)."""
    path = library_path(source)
    if os.path.exists(path):
        return path, "", None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:"
                           f"\n{log}")
    os.replace(tmp, path)
    return path, log, time.time() - t0


def load(path: str) -> ctypes.CDLL:
    """A built library with its entry points' signatures set (those it
    exports: a library built from an earlier source may lack one)."""
    lib = ctypes.CDLL(path)
    sigs = {
        "etol_bt_solve_smem_f32":
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        "etol_bt_solve_stream_f32":
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    }
    for name, args in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (when not built yet) and load the kernel library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is None:
        path, BUILD_LOG, BUILD_SECONDS = compile_source()
        _LIB = load(path)
    return _LIB


@dataclasses.dataclass(frozen=True)
class Plan:
    """How :func:`solve` launches one (K, w, B): ``variant`` "smem" or
    "stream", ``group`` threads a lane, ``lanes_per_block``, ``blocks``,
    ``threads`` a block, the lane stride in floats of the lane's scratch
    (shared memory for "smem", device memory for "stream"), the dynamic
    shared memory in bytes (the lanes' scratch for "smem", their chunk
    buffers for "stream"), and the device-memory scratch in bytes."""

    variant: str
    group: int
    lanes_per_block: int
    blocks: int
    threads: int
    lane_stride: int
    smem_bytes: int
    scratch_bytes: int


VARIANTS = ("smem", "stream")
#: nodes a chunk of the stream kernel's read-back (``StreamLane::kChunk``
#: in the source, which checks the buffers' bytes it is given)
STREAM_CHUNK = 16


def _p4(n: int) -> int:
    return -(-n // 4) * 4


def lane_floats(K: int, w: int) -> int:
    """Floats of one lane's scratch: K runs of a node's packed factor and
    Lsub, each padded to 16 bytes, then y and c,
    (p4(w(w+1)/2) + p4(w^2) + 2w) K."""
    return (_p4(w * (w + 1) // 2) + _p4(w * w) + 2 * w) * K


@functools.lru_cache(maxsize=256)
def plan(K: int, w: int, B: int, variant: str | None = None) -> Plan:
    """The launch of a (K, w, B) solve, from the shape alone.

    Both lane-split kernels keep per lane the packed factor, Lsub, y and
    c in the layout of :func:`lane_floats`: a node's factor and its Lsub
    are one run on 16 bytes, read four floats a load. The shared-memory
    kernel keeps it in shared memory at a lane stride that is an odd
    multiple of 4 floats, which puts the lanes of a block on different
    banks; a block is one warp of 32 // w lanes, fewer where shared
    memory holds fewer. Where not even one lane fits (w = 4 from K =
    1615, w = 5 from 1077, w = 6 from 808, w = 8 from 501, w = 9 from
    388), the stream kernel runs: 32 // w lanes a warp-sized block, the
    scratch in device memory at a lane stride of p4(lane_floats) (B of
    them, one ``torch.empty``), and two buffers a lane in shared memory,
    each a chunk of STREAM_CHUNK nodes' factor and Lsub and their entries
    of y or c. The switch stays where one lane no longer fits, also where
    a block holds fewer lanes than 32 // w: the stream kernel is slower at
    every shape the shared-memory kernel takes (``chip_smoke.py`` phase 3
    on an H100: 0.334 against 0.223 ms at (255, 5, 88), 4 lanes a block;
    1.69 against 1.06 ms at (1614, 4, 8), 0.76 against 0.59 ms at (387,
    9, 8), one lane a block). ``variant`` forces one of the two, for
    measurements."""
    per_lane = lane_floats(K, w)
    stride = _p4(per_lane)
    odd = stride + 4 * (stride // 4 % 2 == 0)
    lanes = min(WARP // w, SMEM_LIMIT // (4 * odd))
    if variant is None:
        variant = "smem" if lanes >= 1 else "stream"
    if variant == "smem":
        if lanes < 1:
            raise ValueError(
                f"one lane's factor at K={K}, w={w} needs "
                f"{4 * odd} bytes of shared memory, a block "
                f"has {SMEM_LIMIT}"
            )
        return Plan("smem", w, lanes, -(-B // lanes), WARP, odd,
                    4 * lanes * odd, 0)
    if variant != "stream":
        raise ValueError(f"unknown variant {variant!r}")
    lanes = WARP // w
    # each lane's two barriers (16 bytes), then its two chunk buffers:
    # STREAM_CHUNK nodes' factor and Lsub, and two runs of y or c
    node = _p4(w * (w + 1) // 2) + _p4(w * w)
    ring = 4 + 2 * (STREAM_CHUNK * node + 2 * (STREAM_CHUNK * w + 4))
    return Plan("stream", w, lanes, -(-B // lanes), WARP, stride,
                4 * lanes * ring, 4 * B * stride)


def _check(D, O, r):
    for name, t in (("D", D), ("O", O), ("r", r)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"D must be [B, K, w, w], got {tuple(D.shape)}")
    B, K, w, _ = D.shape
    if tuple(O.shape) != (B, K - 1, w, w):
        raise ValueError(
            f"O must be [B, K-1, w, w] = {(B, K - 1, w, w)}, "
            f"got {tuple(O.shape)}"
        )
    if tuple(r.shape) != (B, K, w):
        raise ValueError(f"r must be [B, K, w] = {(B, K, w)}, "
                         f"got {tuple(r.shape)}")
    if not 1 <= w <= MAX_W:
        raise ValueError(
            f"node width w={w} is outside the kernel's 1..{MAX_W}; wider "
            "nodes are solved by cyclic reduction (ops.cyclic_reduction), "
            "which the solver picks from the width before it gets here"
        )
    if K < 1:
        raise ValueError("K must be at least 1")


def solve(D, O, r, variant: str | None = None):
    """x [B, K, w] with H x = r after one refinement pass. CPU tensors:
    the plain version; CUDA tensors: the kernel :func:`plan` names, or an
    error. ``variant`` forces one of the two kernels, for
    measurements."""
    _check(D, O, r)
    if D.device.type == "cpu":
        return btridiag.solve_refined(D, O, r)
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    B, K, w, _ = D.shape
    if B == 0:
        return torch.empty_like(r)
    pl = plan(K, w, B, variant)
    x = torch.empty_like(r)
    rc = launch(build(), pl, D, O, r, x)
    if rc != 0:
        raise RuntimeError(f"bt_solve kernel launch failed: cudaError {rc}")
    TALLY.add((pl.variant, K, w, B))
    return x


def launch(lib, pl: Plan, D, O, r, x) -> int:
    """One launch of the kernel ``pl`` names from the library ``lib`` on
    the current stream of D's device; returns its cudaError."""
    B, K, w, _ = D.shape
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        if pl.variant == "smem":
            return lib.etol_bt_solve_smem_f32(
                D.data_ptr(), O.data_ptr(), r.data_ptr(), x.data_ptr(),
                K, w, B, pl.lanes_per_block, pl.lane_stride, pl.smem_bytes,
                stream,
            )
        # under a CUDA graph's capture this comes from the graph's own
        # memory pool and stays reserved for its replays, as every other
        # tensor a captured trip makes does
        scratch = torch.empty(pl.scratch_bytes // 4, dtype=D.dtype,
                              device=D.device)
        return lib.etol_bt_solve_stream_f32(
            D.data_ptr(), O.data_ptr(), r.data_ptr(), x.data_ptr(),
            scratch.data_ptr(), K, w, B, pl.lane_stride, pl.smem_bytes,
            stream,
        )
