"""Vehicle dynamics as plain functions ``f(x, u, t, data) -> xdot`` on
tensors.

Counterparts of ``etol_tpu/models/dynamics.py``. One function serves
values, derivatives (``torch.func``) and batches (``torch.func.vmap``).
"""
from __future__ import annotations

import torch


def single_integrator(x, u, t, data):
    """xdot = u. The canonical ETOL vehicle (2D when nx=2)."""
    return u[: x.shape[0]]


def double_integrator(x, u, t, data):
    """2D double integrator: x = [px, py, vx, vy], u = [ax, ay]."""
    return torch.cat([x[2:4], u[:2]])


def unicycle(x, u, t, data):
    """2D UAS kinematics with bounded speed/turn rate (BASELINE.json
    config 2): x = [px, py, heading], u = [speed, turn_rate]."""
    return torch.stack(
        [u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]]
    )
