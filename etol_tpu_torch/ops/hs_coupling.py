"""The Hermite–Simpson step coupling of the AL Hessian blocks: the CUDA
kernel and its wrapper.

Replaces no TPU kernel: the JAX package leaves this part of the block
assembly (``_ALFuncs._pair_coupling``) to XLA. In the port the same
function under ``torch.func`` launches ~660 small kernels a trip, about
two fifths of a uas_2d trip's; this kernel computes it in one launch. The
source is ``etol_tpu_torch/csrc/hs_coupling.cu`` (what bounds the kernel,
and what its design does about it, is noted there); it is compiled by
``nvcc`` for ``sm_90a`` into ``build/etol_tpu_torch/`` at first use, under
a file name keyed by a hash of the source and flags
(``bt_cuda.compile_source``), and loaded with ctypes.

:func:`coupling` takes Z [B, K, w], the defect multipliers [B, K-1, nx],
rho [B], the defect scales [B, nx] and dt [B] and returns what
``_ALFuncs._pair_coupling`` returns over the lanes: Dc [B, K, w, w] (the
steps' Gauss-Newton blocks and curvature on the diagonal) and O [B, K-1,
w, w]. It takes CUDA tensors only and launches the kernel or raises;
there is no fallback. Its plain version is ``_pair_coupling`` itself,
which the solver runs wherever :func:`takes` says no: the CPU, float64,
the other schemes, delayed dynamics, parameter columns and any dynamics
outside :func:`models`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from . import bt_cuda
from .tally import Tally

#: kernel launches made by :func:`coupling` in this process, by (K, w,
#: batch size), those a CUDA graph captured counted at each replay
TALLY = Tally()

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "csrc", "hs_coupling.cu"
)
_LIB = None
#: what the last build printed (``-Xptxas -v``) and how long it took
#: (None: built already)
BUILD_LOG = ""
BUILD_SECONDS = None


@dataclasses.dataclass(frozen=True)
class Model:
    """A dynamics function the kernel holds: its id in the source's
    ``etol_hs_coupling_f32`` and its state and control counts."""

    id: int
    nx: int
    nu: int


@functools.cache
def models() -> dict:
    """The dynamics the kernel holds, by function (imported at the first
    call: the models' package imports the solver, which imports this
    module)."""
    from ..models import dynamics

    return {dynamics.unicycle: Model(0, 3, 2)}


def takes(nlp, dtype, device) -> bool:
    """Whether a problem's step coupling goes to the kernel: memoryless
    Hermite–Simpson dynamics of :func:`models` at their own sizes, no
    parameter columns, float32, on a CUDA device. From the input alone;
    everything else takes ``_pair_coupling`` (or the scheme's own
    path)."""
    d = nlp.dims
    model = models().get(nlp.dynamics)
    return (nlp.scheme == "hermite_simpson" and not nlp.delay
            and d.n_params == 0 and model is not None
            and (d.nx, d.nu) == (model.nx, model.nu)
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def build() -> ctypes.CDLL:
    """Compile (when not built yet) and load the kernel library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is None:
        path, BUILD_LOG, BUILD_SECONDS = bt_cuda.compile_source(_SOURCE)
        lib = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        lib.etol_hs_coupling_f32.argtypes = (
            [ctypes.c_int] + [vp] * 7 + [ctypes.c_int] * 3 + [vp])
        lib.etol_hs_coupling_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(model, Z, lam, rho, cs, dt):
    named = (("Z", Z), ("lam", lam), ("rho", rho), ("cs", cs), ("dt", dt))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w = model.nx + model.nu
    if Z.dim() != 3 or Z.shape[-1] != w:
        raise ValueError(f"Z must be [B, K, {w}], got {tuple(Z.shape)}")
    B, K, _ = Z.shape
    if K < 1:
        raise ValueError("K must be at least 1")
    for name, t, shape in (("lam", lam, (B, K - 1, model.nx)),
                           ("rho", rho, (B,)), ("cs", cs, (B, model.nx)),
                           ("dt", dt, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if Z.device.type != "cuda":
        raise ValueError(
            f"the kernel takes CUDA tensors, got {Z.device}; the solver "
            "runs _ALFuncs._pair_coupling elsewhere (takes())")


def coupling(dynamics_fn, Z, lam, rho, cs, dt, exact: bool = True):
    """(Dc [B, K, w, w], O [B, K-1, w, w]) of the model ``dynamics_fn``
    (a key of :func:`models`) at Z [B, K, w] with the defect multipliers
    lam [B, K-1, nx], rho [B], the defect scales cs [B, nx] and the step
    dt [B]; ``exact`` adds the defect's curvature (the solver's hessian
    "defect" and "full"; False for "gn"). CUDA tensors only: one launch
    on the current stream, or an error."""
    model = models().get(dynamics_fn)
    if model is None:
        raise ValueError(f"{dynamics_fn!r} has no device code; the models "
                         f"are {[f.__name__ for f in models()]}")
    _check(model, Z, lam, rho, cs, dt)
    B, K, w = Z.shape
    Dc = torch.empty((B, K, w, w), dtype=Z.dtype, device=Z.device)
    O = torch.empty((B, K - 1, w, w), dtype=Z.dtype, device=Z.device)
    if B == 0:
        return Dc, O
    lib = build()
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = lib.etol_hs_coupling_f32(
            model.id, Z.data_ptr(), lam.data_ptr(), rho.data_ptr(),
            cs.data_ptr(), dt.data_ptr(), Dc.data_ptr(), O.data_ptr(), K, B,
            int(exact), stream)
    if rc != 0:
        raise RuntimeError(
            f"hs_coupling kernel launch failed: cudaError {rc}")
    TALLY.add((K, w, B))
    return Dc, O


def cost(K: int, w: int, nx: int, B: int) -> tuple[int, int]:
    """(flops, bytes) of one launch in the exact mode, for its bound: Z,
    the multipliers, rho, the scales and dt read once, Dc and O written
    once; the chain rule and products of ``step_coupling`` a step (the
    model's own jets not counted)."""
    tw = w * (w + 1) // 2
    steps = B * (K - 1)
    per_step = (
        2 * 2 * nx * w * w + 4 * nx * w          # A and B through M
        + 2 * 2 * nx * tw + 2 * nx * w * w       # rho AᵀA, BᵀB, AᵀB
        + 2 * nx * tw + 2 * nx * nx              # Σ w_i ∇²f_i(zm), g
        + 2 * 2 * w * w * w                      # Hw Ma, Hw Mb
        + 2 * w * w * w + 2 * 2 * tw * w         # the three quadrants
        + 2 * 2 * nx * tw)                       # the end weights' Hessians
    nbytes = 4 * (B * K * w + B * (K - 1) * nx + B * (2 + nx)
                  + B * K * w * w + B * (K - 1) * w * w)
    return steps * per_step, nbytes
