"""``TrajectoryOptimizer`` on the configuration's ETOL XML (``load_configs``,
``setup``, ``solve``, ``mpc_step``, ``solve_batch``) with its default
solver config. One card."""
from __future__ import annotations

import os

import torch


class Entry:
    """The facade on the configuration's XML."""

    # solve_batch waits for its result
    synced = True

    def __init__(self, config: dict, traffic: dict, device, group,
                 config_dir: str):
        from etol_tpu_torch import TrajectoryOptimizer
        from etol_tpu_torch.models import dynamics

        p = config["problem"]
        w = tuple(p["cost_weights"])
        topt = TrajectoryOptimizer(device=torch.device(device))
        topt.load_configs(os.path.join(config_dir, p["xml"]))
        topt.set_dynamics(getattr(dynamics, p["dynamics"]))
        topt.set_objective(
            lambda x, u, t, d: sum(wi * u[i] ** 2 for i, wi in enumerate(w)))
        topt.set_scheme(p["scheme"])
        topt.setup()
        self.topt = topt
        self.data = topt.data
        self.traffic = traffic

    @property
    def x0(self):
        return self.data.x0

    @property
    def xf(self):
        return self.data.xf

    def batch(self, x0, xf, seeds, spans, k):
        """A cold fleet of starts ``x0`` [B, nx] to the XML's goal,
        rescued over the mix's ``rescue_lanes``."""
        with spans("perfbench.solve", k):
            return self.topt.solve_batch(
                x0=x0, rescue_lanes=self.traffic["rescue_lanes"])

    def episode(self, x0):
        """An episode's cold solve from ``x0`` [nx], the zones' clock back
        at 0."""
        self.topt.data = self.data
        self.topt.set_x0(x0)
        return self.topt.solve()

    def tick(self, x0):
        """One MPC re-solve from ``x0`` [nx] (host floats)."""
        return self.topt.mpc_step(x0)
