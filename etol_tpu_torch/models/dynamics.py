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


def single_integrator_l1(x, u, t, data):
    """Single integrator with abs-epigraph controls.

    The MILP examples use 4 controls for a 2D vehicle: u0, u1 drive the
    dynamics; u2, u3 are epigraph variables with u2 >= |u0|, u3 >= |u1|
    (absConstraint, etol_glpk_example1.cpp:131-158) so the L1 objective
    min sum(u2+u3) is linear. Dynamics only see the first nx controls.
    """
    return u[: x.shape[0]]


def l1_epigraph_constraints(x, u, t, data):
    """The four abs-epigraph rows, <= 0 feasible:
    u0 - u2 <= 0, -u0 - u2 <= 0, u1 - u3 <= 0, -u1 - u3 <= 0."""
    return torch.stack(
        [u[0] - u[2], -u[0] - u[2], u[1] - u[3], -u[1] - u[3]])


def double_integrator(x, u, t, data):
    """2D double integrator: x = [px, py, vx, vy], u = [ax, ay]."""
    return torch.cat([x[2:4], u[:2]])


def point_mass_3d(x, u, t, data):
    """3D point mass, velocity-controlled: x = [px, py, pz], u = velocity."""
    return u[:3]


def unicycle(x, u, t, data):
    """2D UAS kinematics with bounded speed/turn rate (BASELINE.json
    config 2): x = [px, py, heading], u = [speed, turn_rate]."""
    return torch.stack(
        [u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]]
    )


def fixed_wing_3dof(x, u, t, data):
    """Nonlinear 3-DOF fixed-wing point mass.

    States x = [px, py, h, V, gamma, psi] (position, altitude, airspeed,
    flight-path angle, heading) in KILOMETER units (km and km/s keep
    every state O(1), so float32 collocation defects sit far above the
    rounding floor); controls u = [load_factor, bank, throttle].

        px'    = V cos(gamma) cos(psi)
        py'    = V cos(gamma) sin(psi)
        h'     = V sin(gamma)
        V'     = g (throttle - sin(gamma)) - k_d V^2
        gamma' = (g / V) (n cos(phi) - cos(gamma))
        psi'   = g n sin(phi) / (V cos(gamma))

    with g = 9.81e-3 km/s^2, drag k_d = 10 /km, and V kept away from
    zero by the state lower bound (set V_lb > 0 in the VGP).
    """
    g = 9.81e-3
    k_d = 10.0
    V = torch.clamp(x[3], min=1e-4)
    gamma, psi = x[4], x[5]
    n, phi, thr = u[0], u[1], u[2]
    cg = torch.cos(gamma)
    return torch.stack(
        [
            V * cg * torch.cos(psi),
            V * cg * torch.sin(psi),
            V * torch.sin(gamma),
            g * (thr - torch.sin(gamma)) - k_d * V * V,
            (g / V) * (n * torch.cos(phi) - cg),
            g * n * torch.sin(phi) / (V * cg),
        ]
    )
