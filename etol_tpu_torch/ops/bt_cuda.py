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
it launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..solve import btridiag

#: kernel launches made by :func:`solve` in this process; a run reads it
#: to show that its KKT solves went through the kernel
LAUNCHES = 0

MAX_W = 9
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


def library_path() -> str:
    """Where the built library lives: keyed by the source and flags."""
    with open(_SOURCE, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libbt_solve_{h.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Compile (when not built yet) and load the kernel library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        t0 = time.time()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
            capture_output=True, text=True,
        )
        BUILD_SECONDS = time.time() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n{BUILD_LOG}"
            )
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    fn = lib.etol_bt_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    _LIB = lib
    return _LIB


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
            f"node width w={w} is outside the kernel's 1..{MAX_W}; the JAX "
            "package solves wider nodes by cyclic reduction, which is not "
            "ported yet"
        )
    if K < 1:
        raise ValueError("K must be at least 1")


def solve(D, O, r):
    """x [B, K, w] with H x = r after one refinement pass. CPU tensors:
    the plain version; CUDA tensors: the kernel, or an error."""
    global LAUNCHES
    _check(D, O, r)
    if D.device.type == "cpu":
        return btridiag.solve_refined(D, O, r)
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    B, K, w, _ = D.shape
    if B == 0:
        return torch.empty_like(r)
    lib = build()
    # lane-minor layout [K, n, B]: neighbouring threads (lanes) read
    # neighbouring addresses
    Dt = D.reshape(B, K, w * w).permute(1, 2, 0).contiguous()
    Ot = O.reshape(B, K - 1, w * w).permute(1, 2, 0).contiguous()
    rt = r.permute(1, 2, 0).contiguous()
    x = torch.empty_like(rt)
    lfac = torch.empty((K, w * (w + 1) // 2, B), dtype=D.dtype,
                       device=D.device)
    lsub = torch.empty((max(K - 1, 0), w * w, B), dtype=D.dtype,
                       device=D.device)
    y = torch.empty_like(rt)
    c = torch.empty_like(rt)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        rc = lib.etol_bt_solve_f32(
            Dt.data_ptr(), Ot.data_ptr(), rt.data_ptr(), x.data_ptr(),
            lfac.data_ptr(), lsub.data_ptr(), y.data_ptr(), c.data_ptr(),
            K, w, B, stream,
        )
    if rc != 0:
        raise RuntimeError(f"bt_solve kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return x.permute(2, 0, 1).contiguous()
