"""Direct-collocation defect of one step.

Counterpart of ``step_defect`` in ``etol_tpu/transcribe/collocation.py``:
the single copy of the scheme math, written for one step on plain
tensors so that ``torch.func`` maps and differentiates it.

Schemes:
* ``euler``        x_{k+1} = x_k + dt f(x_{k+1}, u_{k+1}, t_{k+1})
* ``trapezoidal``  standard trapezoid rule.
* ``hermite_simpson``  compressed Hermite–Simpson (3rd order), midpoint
                   controls interpolated.

Radau is not ported yet.
"""
from __future__ import annotations

from typing import Callable

SCHEMES = ("euler", "trapezoidal", "hermite_simpson")


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
        raise NotImplementedError("the radau scheme is not ported yet")
    raise ValueError(f"unknown scheme {scheme!r}; pick from {SCHEMES}")
