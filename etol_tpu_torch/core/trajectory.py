"""Trajectory utilities.

Counterpart of ``etol_tpu/core/trajectory.py``: a trajectory is a pair of
tensors ``times [K]`` and ``values [K, d]`` (batched: ``[B, K, d]``). The
reference's header-only helpers (TrajectoryOptimizer.hpp:239-324) as
tensor functions, plus the CSV export with the no-overwrite
auto-increment filename behavior (TrajectoryOptimizer.cpp:626-674).
:func:`save` takes tensors on any device and writes from the host.
"""
from __future__ import annotations

import os
import re
from typing import Sequence, Tuple

import numpy as np
import torch

Traj = Tuple[torch.Tensor, torch.Tensor]  # (times [K], values [K, d])


def linear_interpolation(tval, tvec, ref):
    """Piecewise-linear interpolation with end-extrapolation.

    Parity with the template ``linear_interpolation``
    (TrajectoryOptimizer.hpp:239-257): outside [tvec[0], tvec[-1]] the
    first or last segment is extrapolated. ``tval`` is a tensor of any
    shape; ``tvec`` [K] must be ascending; ``ref`` is [K] or [K, d].

    The segment is found by counting the knots at or below ``tval``
    (``searchsorted(..., side="right")`` on an ascending vector) and
    picked out with a one-hot weight, so the function has no gather and
    maps under ``torch.func.vmap``.
    """
    k = tvec.shape[0]
    j = (tvec <= tval[..., None]).sum(-1) - 1
    j = torch.clamp(j, 0, k - 2)
    idx = torch.arange(k, device=tvec.device)
    sel0 = (idx == j[..., None]).to(tvec.dtype)          # [..., K]
    sel1 = (idx == (j + 1)[..., None]).to(tvec.dtype)
    t0 = (sel0 * tvec).sum(-1)
    t1 = (sel1 * tvec).sum(-1)
    if ref.dim() > 1:
        r0 = (sel0[..., None] * ref).sum(-2)
        r1 = (sel1[..., None] * ref).sum(-2)
    else:
        r0 = (sel0 * ref).sum(-1)
        r1 = (sel1 * ref).sum(-1)
    denom = t1 - t0
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    w = torch.where(denom == 0, torch.zeros_like(denom), (tval - t0) / safe)
    if ref.dim() > 1:
        w = w[..., None]
    return r0 + w * (r1 - r0)


def extract(traj: Traj, idxs: Sequence[int]) -> Traj:
    """extractTraj parity (TrajectoryOptimizer.hpp:267-282): index 0 selects
    the time column, i selects value column i-1."""
    times, values = traj
    cols = []
    for i in idxs:
        if i == 0:
            cols.append(times[..., None].to(values.dtype))
        else:
            cols.append(values[..., i - 1 : i])
    return times, torch.cat(cols, dim=-1)


def _columns(values, entries: Sequence[float], fill: float):
    """``entries`` laid over the first columns of ``values``, ``fill``
    for the rest, as a tensor beside ``values``."""
    d = values.shape[-1]
    v = np.full((d,), fill)
    v[: len(entries)] = np.asarray(entries)[:d]
    return torch.as_tensor(v, dtype=values.dtype, device=values.device)


def scale(traj: Traj, scalers: Sequence[float]) -> Traj:
    """scaleTraj parity (TrajectoryOptimizer.hpp:291-303); columns beyond
    ``len(scalers)`` are untouched."""
    times, values = traj
    return times, values * _columns(values, scalers, 1.0)


def offset(traj: Traj, offsets: Sequence[float]) -> Traj:
    """offsetTraj parity (TrajectoryOptimizer.hpp:312-324)."""
    times, values = traj
    return times, values + _columns(values, offsets, 0.0)


def _increment_path(fp: str) -> str:
    """No-overwrite filename policy (TrajectoryOptimizer.cpp:630-640):
    trailing digits of the stem are incremented until the path is free."""
    while os.path.exists(fp):
        dot = fp.find(".")
        stem, ext = (fp, "") if dot < 0 else (fp[:dot], fp[dot:])
        m = re.search(r"(\d+)$", stem)
        if m:
            idx = int(m.group(1)) + 1
            stem = stem[: m.start()] + str(idx)
        else:
            stem = stem + "1"
        fp = stem + ext
    return fp


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save(traj: Traj, fp: str) -> str:
    """CSV export parity (TrajectoryOptimizer.cpp:626-674): header
    ``time,traj0,...``; returns the (possibly incremented) path written."""
    times, values = to_host(traj[0]), to_host(traj[1])
    if times.size == 0:
        print("No Data to Save!!!")
        return fp
    fp = _increment_path(fp)
    d = values.shape[-1]
    header = "time" + "".join(f",traj{i}" for i in range(d))
    with open(fp, "w") as fh:
        fh.write(header + "\n")
        rows = []
        for t, row in zip(times, values):
            rows.append(
                f"{float(t):.6f}" + "".join(f",{float(v):.6f}" for v in row)
            )
        fh.write("\n".join(rows))
    return fp


def load_csv(fp: str) -> Traj:
    """Read back a CSV written by :func:`save`, as float64 tensors on the
    CPU."""
    data = np.atleast_2d(np.loadtxt(fp, delimiter=",", skiprows=1))
    return torch.from_numpy(data[:, 0].copy()), torch.from_numpy(
        data[:, 1:].copy())
