"""The line search's candidate pass for the separable schemes: the CUDA
kernel and its wrapper.

Replaces no TPU kernel: the JAX package leaves this pass (the candidate
block of ``body_diag``) to XLA. In the port the same pass under
``torch.func`` (``_ALFuncs.candidate_residuals``, ``al_from_parts`` and the
decrease in ``al_sqp._body``) writes every intermediate at [B, n, K, rows]
and launches some 150 small kernels a trip; this kernel computes what the
Armijo test reads in one launch, and one more launch gives the chosen
step's point, defects and rows. The source is
``etol_tpu_torch/csrc/ls_candidates.cu`` (what bounds the kernel, and what
its design does about it, is noted there); it is compiled by ``nvcc`` for
``sm_90a`` into ``build/etol_tpu_torch/`` at first use
(``bt_cuda.compile_source``) and loaded with ctypes.

:func:`candidates` returns every candidate's point Zc [B, n, K, w] (the
user's running cost, a callback, reads it in PyTorch), its AL value less
the cost [B, n] and its decrease grad . (Zc - Z) [B, n]; :func:`chosen`
returns, at each lane's chosen candidate, the point [B, K, w], the scaled
defects [B, K-1, nx] and the inequality rows [B, K, m]. Each takes CUDA
tensors only and launches the kernel or raises; there is no fallback.
Its plain version is the solver's own candidate pass
(``_ALFuncs.candidate_residuals``, ``al_from_parts`` and the decrease),
which runs wherever :func:`takes` says no: the CPU, float64, the other
schemes, delayed dynamics, parameter columns, user path rows and any
dynamics outside :func:`models`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import NamedTuple

import torch

from . import bt_cuda
from .tally import Tally

#: kernel launches made by :func:`candidates` and :func:`chosen` in this
#: process, by (K, w, candidates n, batch size), those a CUDA graph
#: captured counted at each replay
TALLY = Tally()

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "csrc", "ls_candidates.cu"
)
_LIB = None
#: what the last build printed (``-Xptxas -v``) and how long it took
#: (None: built already)
BUILD_LOG = ""
BUILD_SECONDS = None


@dataclasses.dataclass(frozen=True)
class Model:
    """Dynamics xdot = u[:nx] the kernel holds: its id in the source's
    ``etol_ls_candidates_f32`` and its state and control counts."""

    id: int
    nx: int
    nu: int


@functools.cache
def models() -> dict:
    """The dynamics the kernel holds, by function (imported at the first
    call: the models' package imports the solver, which imports this
    module)."""
    from ..models import dynamics

    return {dynamics.single_integrator: Model(0, 2, 2),
            dynamics.point_mass_3d: Model(1, 3, 3)}


def takes(nlp, dtype, device) -> bool:
    """Whether a problem's line search goes to the kernel: memoryless
    euler or trapezoidal dynamics of :func:`models` at their own sizes, no
    parameter columns, no user path rows (any obstacle form, or none),
    float32, on a CUDA device. From the input alone; everything else
    takes the solver's own candidate pass."""
    d = nlp.dims
    model = models().get(nlp.dynamics)
    return (nlp.scheme in ("euler", "trapezoidal") and not nlp.delay
            and d.n_params == 0 and not nlp.path_eq and not nlp.path_ineq
            and model is not None and (d.nx, d.nu) == (model.nx, model.nu)
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


class Lanes(NamedTuple):
    """A batch's constants of the pass, lane axis first: the bounds
    [B, K, w], the defect scales [B, nx], dt [B], the obstacles' arrays,
    the zones' centres at the node times [B, K, T, D] and the zones'
    arrays (``core.problem.ObstacleData`` and ``TrackData``)."""

    lb: torch.Tensor
    ub: torch.Tensor
    cs: torch.Tensor
    dt: torch.Tensor
    ellipses: torch.Tensor
    ellipse_mask: torch.Tensor
    halfspaces: torch.Tensor
    hs_mask: torch.Tensor
    piece_mask: torch.Tensor
    centers: torch.Tensor
    dim_mask: torch.Tensor
    radius: torch.Tensor
    track_mask: torch.Tensor

    @classmethod
    def of(cls, lb, ub, cs, centers, data) -> "Lanes":
        """From the solver's bounds, scales and centre table and the
        batch's ``VGPData``, each contiguous."""
        o, t = data.obstacles, data.tracks
        return cls(*(a.contiguous() for a in (
            lb, ub, cs, data.dt, o.ellipses, o.ellipse_mask, o.halfspaces,
            o.hs_mask, o.piece_mask, centers, t.dim_mask, t.radius,
            t.mask)))


class _Args(ctypes.Structure):
    """``etol_ls::Args`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "Z", "p", "lb", "ub", "grad", "alpha", "sel", "lam", "mu", "rho",
        "cs", "dt", "ell", "ell_mask", "hs", "hs_mask", "piece_mask",
        "centers", "dim_mask", "radius", "track_mask", "Zc", "val", "dec",
        "cd", "g")] + [(name, ctypes.c_int) for name in (
            "B", "K", "n", "E", "P", "H", "T", "D", "ellipses", "pieces",
            "tracks", "trapezoidal")] + [("margin", ctypes.c_float)]


def build() -> ctypes.CDLL:
    """Compile (when not built yet) and load the kernel library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is None:
        path, BUILD_LOG, BUILD_SECONDS = bt_cuda.compile_source(_SOURCE)
        lib = ctypes.CDLL(path)
        lib.etol_ls_candidates_f32.argtypes = [
            ctypes.c_int, ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.etol_ls_candidates_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _forms(nlp) -> tuple[bool, bool, bool]:
    """Which obstacle rows the NLP stacks: ellipses, pieces, zones."""
    on = nlp.use_obstacles
    form = nlp.obstacle_form
    return (on and form in ("ellipses", "both"),
            on and form in ("pieces", "both"), on)


def _rows(nlp, lanes: Lanes) -> int:
    ell, pcs, trk = _forms(nlp)
    return (ell * lanes.ellipses.shape[1] + pcs * lanes.piece_mask.shape[1]
            + trk * lanes.radius.shape[1])


def _check(nlp, lanes, Z, p, grad, alpha, lam, mu, rho, sel):
    model = models().get(nlp.dynamics)
    if model is None or not takes(nlp, torch.float32, "cuda"):
        raise ValueError(
            f"the kernel takes memoryless euler or trapezoidal problems "
            f"without user rows whose dynamics are "
            f"{[f.__name__ for f in models()]} at their sizes")
    w = model.nx + model.nu
    if not isinstance(Z, torch.Tensor) or Z.dim() != 3 or Z.shape[-1] != w:
        raise ValueError(f"Z must be a [B, K, {w}] tensor, got "
                         f"{getattr(Z, 'shape', type(Z))}")
    B, K, _ = Z.shape
    if K < 2:
        raise ValueError("K must be at least 2")
    if not isinstance(alpha, torch.Tensor) or alpha.dim() != 1 \
            or alpha.shape[0] < 1:
        raise ValueError("alpha must be a tensor of n >= 1 step sizes")
    E, P = lanes.ellipses.shape[1], lanes.piece_mask.shape[1]
    H = lanes.halfspaces.shape[2] if lanes.halfspaces.dim() == 4 else -1
    T, D = lanes.centers.shape[2:] if lanes.centers.dim() == 4 else (-1, -1)
    m = _rows(nlp, lanes)
    shapes = dict(
        Z=(Z, (B, K, w)), p=(p, (B, K, w)), grad=(grad, (B, K, w)),
        alpha=(alpha, tuple(alpha.shape)), lam=(lam, (B, K - 1, model.nx)),
        mu=(mu, (B, K, m)), rho=(rho, (B,)), lb=(lanes.lb, (B, K, w)),
        ub=(lanes.ub, (B, K, w)), cs=(lanes.cs, (B, model.nx)),
        dt=(lanes.dt, (B,)), ellipses=(lanes.ellipses, (B, E, 6)),
        ellipse_mask=(lanes.ellipse_mask, (B, E)),
        halfspaces=(lanes.halfspaces, (B, P, H, 3)),
        hs_mask=(lanes.hs_mask, (B, P, H)),
        piece_mask=(lanes.piece_mask, (B, P)),
        centers=(lanes.centers, (B, K, T, D)),
        dim_mask=(lanes.dim_mask, (B, T, D)), radius=(lanes.radius, (B, T)),
        track_mask=(lanes.track_mask, (B, T)))
    if sel is not None:
        if not isinstance(sel, torch.Tensor) or sel.dtype != torch.int64:
            raise TypeError("sel must be an int64 tensor")
        if tuple(sel.shape) != (B,) or sel.device != Z.device:
            raise ValueError(f"sel must be [{B}] on {Z.device}")
        if not sel.is_contiguous():
            raise ValueError("sel must be contiguous")
    for name, (t, shape) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the kernel takes CUDA tensors, got {Z.device}")
    return model, m


def _pack(nlp, model, m, lanes, Z, p, grad, alpha, lam, mu, rho, sel):
    """A launch's outputs, allocated, and its ``_Args`` over them and the
    inputs (the CPU tests hand the same to the source's host build)."""
    B, K, w = Z.shape
    n = alpha.shape[0]
    kw = dict(dtype=Z.dtype, device=Z.device)
    if sel is None:
        out = dict(Zc=torch.empty((B, n, K, w), **kw),
                   val=torch.empty((B, n), **kw),
                   dec=torch.empty((B, n), **kw))
    else:
        out = dict(Zc=torch.empty((B, K, w), **kw),
                   cd=torch.empty((B, K - 1, model.nx), **kw),
                   g=torch.empty((B, K, m), **kw))
    ell, pcs, trk = _forms(nlp)
    ptr = {name: t.data_ptr() for name, t in dict(
        Z=Z, p=p, lb=lanes.lb, ub=lanes.ub, grad=grad, alpha=alpha, lam=lam,
        mu=mu, rho=rho, cs=lanes.cs, dt=lanes.dt, ell=lanes.ellipses,
        ell_mask=lanes.ellipse_mask, hs=lanes.halfspaces,
        hs_mask=lanes.hs_mask, piece_mask=lanes.piece_mask,
        centers=lanes.centers, dim_mask=lanes.dim_mask,
        radius=lanes.radius, track_mask=lanes.track_mask, **out).items()}
    ptr["sel"] = None if sel is None else sel.data_ptr()
    T, D = lanes.centers.shape[2:]
    args = _Args(**ptr, B=B, K=K, n=n, E=lanes.ellipses.shape[1],
                 P=lanes.piece_mask.shape[1], H=lanes.halfspaces.shape[2],
                 T=T, D=D, ellipses=ell, pieces=pcs, tracks=trk,
                 trapezoidal=nlp.scheme == "trapezoidal",
                 margin=nlp.obstacle_margin)
    return tuple(out.values()), args


def _launch(nlp, model, m, lanes, Z, p, grad, alpha, lam, mu, rho, sel):
    """One launch over checked inputs on the current stream; CUDA tensors
    only (the CPU tests put the source's host build in its place)."""
    if Z.device.type != "cuda":
        raise ValueError(
            f"the kernel takes CUDA tensors, got {Z.device}; the solver "
            "runs its own candidate pass elsewhere (takes())")
    out, args = _pack(nlp, model, m, lanes, Z, p, grad, alpha, lam, mu, rho,
                      sel)
    B, K, w = Z.shape
    if B == 0:
        return out
    lib = build()
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = lib.etol_ls_candidates_f32(model.id, ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(
            f"ls_candidates kernel launch failed: cudaError {rc}")
    TALLY.add((K, w, alpha.shape[0], B))
    return out


def _run(nlp, lanes, Z, p, grad, alpha, lam, mu, rho, sel):
    model, m = _check(nlp, lanes, Z, p, grad, alpha, lam, mu, rho, sel)
    return _launch(nlp, model, m, lanes, Z, p, grad, alpha, lam, mu, rho,
                   sel)


def candidates(nlp, lanes: Lanes, Z, p, grad, alpha, lam, mu, rho):
    """Every candidate of every lane: (Zc [B, n, K, w], the AL value less
    the cost [B, n], the decrease grad . (Zc - Z) [B, n]) at Zc =
    clamp(Z + alpha_j p, lb, ub), alpha [n], with the defect multipliers
    lam [B, K-1, nx], mu [B, K, m] and rho [B]. One launch on the current
    stream, or an error."""
    return _run(nlp, lanes, Z, p, grad, alpha, lam, mu, rho, None)


def chosen(nlp, lanes: Lanes, Z, p, grad, alpha, lam, mu, rho, sel):
    """Each lane's chosen candidate ``alpha[sel]`` (sel [B], int64): (its
    point [B, K, w], scaled defects [B, K-1, nx], inequality rows [B, K,
    m]), the arithmetic of :func:`candidates`. Launched as it is."""
    return _run(nlp, lanes, Z, p, grad, alpha, lam, mu, rho, sel)


def cost(K: int, nx: int, nu: int, n: int, B: int, E: int = 0, P: int = 0,
         H: int = 0, T: int = 0, D: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one candidate launch, for its bound, with E
    ellipse rows, P piece rows of H halfspaces and T zone rows of D dims
    a node (0 for a part the obstacle form leaves out): the lanes' points,
    directions, bounds, gradient, multipliers, scales, dt and obstacle
    arrays and the n step sizes read once, Zc, val and dec written once;
    an exp or a log counted as one operation."""
    w = nx + nu
    m = E + P + T
    node = (5 * w                      # the step, the clamp, the decrease
            + E * 18                   # an ellipse row
            + P * (7 * H + 5)          # a piece: margins, exp, sum, log
            + T * (3 * D + 3)          # a zone's ball
            + m * 6)                   # the AL term of a row
    step = nx * (7 + 4)                # a defect row and its AL terms
    flops = B * n * (K * node + (K - 1) * step)
    floats = (5 * B * K * w + n + B * (K - 1) * nx + B * K * m + B * (2 + nx)
              + B * E * 7 + B * P * (H * 4 + 1) + B * K * T * D
              + B * T * (D + 2)
              + B * n * K * w + 2 * B * n)
    return flops, 4 * floats
