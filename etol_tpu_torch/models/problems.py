"""Canonical VGP builders as ``(VGP, NLP)`` factories.

Counterparts of the factories of ``etol_tpu/models/problems.py``: the
two shipped XML problems (``canonical_ocp_2d``, ``canonical_mip_2d``),
the exact engine's composed demo (``composed_exact_demo``) and the
scaling ladder (``double_integrator_2d``, ``uas_2d``,
``point_mass_3d``, ``fixed_wing_3dof``); call
``vgp.to_device(device=...)`` and hand both to the solvers of
:mod:`etol_tpu_torch.solve.al_sqp`.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch

from ..core.problem import VGP
from ..core.types import ParamConfig, VarType
from ..core.xml_io import load_configs
from ..transcribe.nlp import NLP
from . import dynamics

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "configs"
)


def _default_xml(name: str) -> str:
    return os.path.join(_CONFIG_DIR, name)


def canonical_ocp_2d(
    xml_path: Optional[str] = None, scheme: str = "trapezoidal"
):
    """The smooth canonical VGP (ocp_2d_ex1.xml): 2D single integrator,
    min integral(u0^2+u1^2), edge-ellipse obstacles + 2 moving circles —
    the problem of etol_psopt_example1.cpp / etol_dymos_example1.cpp."""
    vgp = load_configs(xml_path or _default_xml("ocp_2d_ex1.xml"))
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.single_integrator,
        running_cost=lambda x, u, t, d: u[0] ** 2 + u[1] ** 2,
        scheme=scheme,
        cost_form="integral",
    )
    return vgp, nlp


def canonical_mip_2d(xml_path: Optional[str] = None):
    """The MILP canonical VGP (mip_2d_ex1.xml): 2D single integrator with
    L1 objective via abs-epigraph controls u2,u3 — the problem of
    etol_glpk_example1.cpp (min sum(u2+u3), x_k = x_{k-1} + dt u_k).
    Solved smoothly: the big-M disjunctions become edge ellipses."""
    vgp = load_configs(xml_path or _default_xml("mip_2d_ex1.xml"))
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.single_integrator_l1,
        running_cost=lambda x, u, t, d: u[2] + u[3],
        path_ineq=(dynamics.l1_epigraph_constraints,),
        scheme="euler",
        cost_form="sum",
    )
    return vgp, nlp


def _box_obstacles(
    centers: Sequence[Sequence[float]], half: float
) -> list:
    out = []
    for cx, cy in centers:
        out.append(
            [
                [cx - half, cy - half],
                [cx + half, cy - half],
                [cx + half, cy + half],
                [cx - half, cy + half],
            ]
        )
    return out


def double_integrator_2d(
    nsteps: int = 20,
    dt: float = 0.25,
    x0=(0.0, 0.0, 0.0, 0.0),
    xf=(5.0, 4.0, 0.0, 0.0),
    obstacle_centers: Sequence[Sequence[float]] = ((2.5, 2.0),),
    obstacle_half: float = 0.6,
):
    """BASELINE config 1 analog: 2D point mass (double integrator), one or
    more static square obstacles."""
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = list(x0)
    vgp.xf = list(xf)
    vgp.xtol = [0.05, 0.05, 0.1, 0.1]
    vgp.xlower = [-10.0, -10.0, -3.0, -3.0]
    vgp.xupper = [10.0, 10.0, 3.0, 3.0]
    vgp.ulower = [-2.0, -2.0]
    vgp.uupper = [2.0, 2.0]
    for poly in _box_obstacles(obstacle_centers, obstacle_half):
        vgp.add_exclusion_zone(poly)
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.double_integrator,
        running_cost=lambda x, u, t, d: u[0] ** 2 + u[1] ** 2,
        scheme="hermite_simpson",
    )
    return vgp, nlp


def uas_2d(
    nsteps: int = 50,
    dt: float = 0.2,
    x0=(0.0, 0.0, 0.0),
    xf=(8.0, 6.0, 0.0),
    v_max: float = 2.0,
    turn_max: float = 1.5,
    obstacle_centers: Sequence[Sequence[float]] = (
        (3.0, 2.0),
        (5.0, 4.5),
        (2.0, 4.0),
    ),
    obstacle_half: float = 0.7,
):
    """BASELINE config 2: 2D UAS (unicycle) with bounded speed/turn rate,
    multiple static obstacles, N=50."""
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = list(x0)
    vgp.xf = list(xf)
    vgp.xtol = [0.05, 0.05, 10.0]  # heading free at the goal
    vgp.xlower = [-20.0, -20.0, -12.0]
    vgp.xupper = [20.0, 20.0, 12.0]
    vgp.ulower = [0.0, -turn_max]
    vgp.uupper = [v_max, turn_max]
    for poly in _box_obstacles(obstacle_centers, obstacle_half):
        vgp.add_exclusion_zone(poly)
    dims = vgp.dims()

    def guess(data):
        # dynamically-consistent guess: fly straight at the goal bearing
        # with constant speed — a near-feasible unicycle rollout
        K = dims.nodes
        w = torch.linspace(0.0, 1.0, K, dtype=data.x0.dtype,
                           device=data.x0.device)[:, None]
        p0, pf = data.x0[:2], data.xf[:2]
        P = (1.0 - w) * p0 + w * pf
        d = pf - p0
        heading = torch.arctan2(d[1], d[0])
        dist = torch.sqrt(torch.sum(d * d))
        v = torch.minimum(
            torch.maximum(dist / (dims.nsteps * data.dt), data.u_lb[0]),
            data.u_ub[0],
        )
        ones = torch.ones((K, 1), dtype=data.x0.dtype, device=data.x0.device)
        X = torch.cat([P, ones * heading], dim=-1)
        U = torch.cat([ones * v, ones * 0.0], dim=-1)
        return torch.cat([X, U], dim=-1).reshape(-1)

    nlp = NLP(
        dims=dims,
        dynamics=dynamics.unicycle,
        # track fuel + smoothness: v^2 + turn^2
        running_cost=lambda x, u, t, d: u[0] ** 2 + 0.5 * u[1] ** 2,
        scheme="hermite_simpson",
        guess=guess,
    )
    return vgp, nlp


def point_mass_3d(
    nsteps: int = 32,
    dt: float = 0.25,
    x0=(0.0, 0.0, 1.0),
    xf=(6.0, 5.0, 2.0),
    track_specs: Sequence = (
        # (radius, times, waypoints): true 3-D moving spheres
        (0.6, (0.0, 8.0), ((3.0, 2.0, 1.5), (3.0, 4.0, 1.5))),
        (0.6, (0.0, 8.0), ((2.0, 4.0, 2.0), (4.0, 2.0, 1.0))),
    ),
):
    """BASELINE config 3: 3D point mass with moving spherical obstacles
    (3 datums per waypoint: a moving ball in x, y, z)."""
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = list(x0)
    vgp.xf = list(xf)
    vgp.xtol = [0.05, 0.05, 0.05]
    vgp.xlower = [-10.0, -10.0, 0.0]
    vgp.xupper = [10.0, 10.0, 5.0]
    vgp.ulower = [-2.0, -2.0, -1.0]
    vgp.uupper = [2.0, 2.0, 1.0]
    for radius, times, pts in track_specs:
        vgp.add_track(radius, times, pts)
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.point_mass_3d,
        running_cost=lambda x, u, t, d: u[0] ** 2 + u[1] ** 2 + u[2] ** 2,
        scheme="trapezoidal",
    )
    return vgp, nlp


def fixed_wing_3dof(
    nsteps: int = 100,
    dt: float = 0.5,
    x0=(0.0, 0.0, 0.100, 0.020, 0.0, 0.0),
    xf=(0.800, 0.600, 0.150, 0.020, 0.0, 0.8),
):
    """BASELINE config 4: nonlinear fixed-wing point mass, N=100, no
    obstacles. Km units (see dynamics.fixed_wing_3dof): the 800 m
    cross-range climb becomes 0.8 km. The registry runs it under the
    radau scheme (``models/tuned.py``)."""
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = list(x0)
    vgp.xf = list(xf)
    vgp.xtol = [0.005, 0.005, 0.005, 0.002, 0.2, 0.2]
    vgp.xlower = [-5.0, -5.0, 0.020, 0.010, -0.5, -math.pi]
    vgp.xupper = [5.0, 5.0, 0.500, 0.040, 0.5, math.pi]
    vgp.ulower = [0.5, -1.0, 0.0]   # load factor, bank, throttle
    vgp.uupper = [3.0, 1.0, 1.0]
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.fixed_wing_3dof,
        # effort + mild throttle cost, normalized per-state magnitudes
        running_cost=lambda x, u, t, d: (
            (u[0] - 1.0) ** 2 + u[1] ** 2 + 0.1 * u[2] ** 2
        ),
        scheme="hermite_simpson",
        use_obstacles=False,
    )
    return vgp, nlp


def composed_exact_demo():
    """Composed exact-MILP demo: a BINARY 'boost' param gating the speed
    limit (|u| <= 0.35 + 1.15 b at cost 0.4 b per active step) plus a
    square exclusion zone blocking the straight line. The horizon is too
    short to reach the goal at base speed, so an exact solve must BOTH
    switch the boost on (integer branching) and pick an escape side past
    the zone (disjunction branching): the analog of the reference's
    single GLPK model holding per-window binaries and obstacle-side
    binaries together (etol_glpk_example1.cpp:160-276).

    Linear dynamics + convex cost + linear rows: every relaxation is
    convex, so ``side_branch.solve_exact(..., convex_relaxation=True)``
    certifies the optimum. Used by ``cli solve_exact_composed``."""
    vgp = VGP(nsteps=6, dt=0.5)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [3.0, 0.0]
    vgp.xtol = [0.02, 0.02]
    vgp.xlower = [-1.0, -2.0]
    vgp.xupper = [4.0, 2.0]
    vgp.ulower = [-1.5, -1.5]
    vgp.uupper = [1.5, 1.5]
    vgp.add_exclusion_zone(
        [[1.2, -0.4], [1.8, -0.4], [1.8, 0.4], [1.2, 0.4]]
    )
    vgp.add_params(
        {"boost": ParamConfig(VarType.BINARY, 0.0, 1.0, 0.0, 3.0)}
    )

    def cost(x, u, t, d, p):
        return u[0] ** 2 + u[1] ** 2 + 0.4 * p[0]

    def speed_gate(x, u, t, d, p):
        cap = 0.35 + 1.15 * p[0]
        return torch.stack([u[0] - cap, -u[0] - cap,
                            u[1] - cap, -u[1] - cap])

    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.single_integrator,
        running_cost=cost,
        path_ineq=(speed_gate,),
        scheme="euler",
        cost_form="sum",
    )
    return vgp, nlp
