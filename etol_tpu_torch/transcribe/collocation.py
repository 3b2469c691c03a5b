"""Direct-collocation defects and running costs.

Counterpart of ``etol_tpu/transcribe/collocation.py``. :func:`step_defect`
is the single copy of the scheme math, written for one step on plain
tensors so that ``torch.func`` maps and differentiates it;
:func:`defects` maps it over a trajectory, and :func:`integral_cost` /
:func:`sum_cost` integrate a running cost in the transcription's order.

Schemes:
* ``euler``        x_{k+1} = x_k + dt f(x_{k+1}, u_{k+1}, t_{k+1})
* ``trapezoidal``  standard trapezoid rule.
* ``hermite_simpson``  compressed Hermite–Simpson (3rd order), midpoint
                   controls interpolated.
* ``radau``        compressed Radau IIA, 2 stages / 3rd order: the
                   quadratic through (x_k, x_{k+1}, dt·f_{k+1}) is
                   collocated at c = 1/3; eliminating the interior stage
                   recovers the Radau IIA tableau with one defect per
                   step and no extra decision variables.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

SCHEMES = ("euler", "trapezoidal", "hermite_simpson", "radau")


def node_times(nsteps: int, dt, dtype=None, device=None):
    """The node times k * dt, k = 0..nsteps, in ``dtype`` (dt's own, or
    float32 for a Python number), on ``device`` (dt's own, or the
    CPU for a Python number)."""
    if isinstance(dt, torch.Tensor):
        dtype = dtype or dt.dtype
        device = device or dt.device
    k = torch.arange(nsteps + 1, dtype=dtype or torch.float32,
                     device=device)
    return k * dt


def step_defect(
    f: Callable,
    x0, u0, x1, u1,   # node k and node k+1 states/controls
    t0, dt,
    data,
    scheme: str = "trapezoidal",
):
    """Collocation defect of ONE step (nodes k -> k+1), shape [nx]."""
    t1 = t0 + dt
    if scheme == "euler":
        return x1 - x0 - dt * f(x1, u1, t1, data)
    f0 = f(x0, u0, t0, data)
    f1 = f(x1, u1, t1, data)
    if scheme == "trapezoidal":
        return x1 - x0 - (dt / 2.0) * (f0 + f1)
    if scheme == "hermite_simpson":
        xm = 0.5 * (x0 + x1) + (dt / 8.0) * (f0 - f1)
        um = 0.5 * (u0 + u1)
        fm = f(xm, um, 0.5 * (t0 + t1), data)
        return x1 - x0 - (dt / 6.0) * (f0 + 4.0 * fm + f1)
    if scheme == "radau":
        # interior stage at c = 1/3; the defect is the b-row (3/4, 1/4).
        # f0 is unused: the scheme is stiffly accurate, only stage
        # derivatives enter.
        xs = x0 + (5.0 * (x1 - x0) - 2.0 * dt * f1) / 9.0
        us = (2.0 * u0 + u1) / 3.0
        fs = f(xs, us, t0 + dt / 3.0, data)
        return x1 - x0 - dt * (0.75 * fs + 0.25 * f1)
    raise ValueError(f"unknown scheme {scheme!r}; pick from {SCHEMES}")


def defects(f: Callable, X, U, dt, data, scheme: str = "trapezoidal"):
    """All collocation defects of a trajectory X [K, nx], U [K, nu],
    shape [K-1, nx]; zero iff dynamically feasible."""
    ts = node_times(X.shape[0] - 1, dt, X.dtype, X.device)
    return vmap(
        lambda x0, u0, x1, u1, t0: step_defect(
            f, x0, u0, x1, u1, t0, dt, data, scheme)
    )(X[:-1], U[:-1], X[1:], U[1:], ts[:-1])


def _node_values(ell: Callable, X, U, dt, data):
    ts = node_times(X.shape[0] - 1, dt, X.dtype, X.device)
    return vmap(lambda x, u, t: ell(x, u, t, data))(X, U, ts)  # [K]


def integral_cost(ell: Callable, X, U, dt, data,
                  scheme: str = "trapezoidal"):
    """The running cost ``ell(x, u, t, data)`` integrated in the
    transcription's order: the right-Riemann sum for ``euler``, the
    trapezoid rule otherwise (the NLP's Lagrange term,
    ePSOPT.cpp:186-216)."""
    lv = _node_values(ell, X, U, dt, data)
    if scheme == "euler":
        return dt * torch.sum(lv[1:])
    w = torch.ones_like(lv)
    w[0] = 0.5
    w[-1] = 0.5
    return dt * torch.sum(w * lv)


def sum_cost(ell: Callable, X, U, dt, data):
    """The plain unweighted sum over nodes, the MILP objective's form
    (eGurobi.cpp:370-386)."""
    return torch.sum(_node_values(ell, X, U, dt, data))
