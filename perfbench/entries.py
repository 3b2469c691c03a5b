"""The program under test, as a configuration's ``entry`` names it: the
public entries of ``etol_tpu_torch`` and nothing else of it.

* ``staged``: ``models.problems.uas_2d`` under the registry's config
  (``models.tuned``), cold batches seeded by ``solve.shooting.plan_guess``
  and solved by ``al_sqp.solve_batched_staged``, warm batches re-solved
  from the result before under ``models.tuned.warm_config``;
* ``facade``: ``TrajectoryOptimizer`` on the configuration's ETOL XML
  (``load_configs``, ``setup``, ``solve``, ``mpc_step``, ``solve_batch``).

Every entry takes its problem's numbers from the configuration's file, so
the program and the reference read the same file.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from .reference.problem import CONFIG_DIR


class Staged:
    """uas_2d fleets through the seeds and the staged solve."""

    def __init__(self, config: dict, traffic: dict, device):
        from etol_tpu_torch.core.problem import batch_tile
        from etol_tpu_torch.models.problems import uas_2d
        from etol_tpu_torch.models.tuned import (tuned_config, tuned_extras,
                                                 warm_config)

        p, s = config["problem"], config["solver"]
        if p["model"] != "uas_2d":
            raise ValueError(f"the staged entry runs uas_2d, not {p['model']}")
        vgp, nlp = uas_2d(
            nsteps=p["nsteps"], dt=p["dt"], x0=tuple(p["x0"]),
            xf=tuple(p["xf"]), v_max=p["u_upper"][0],
            turn_max=p["u_upper"][1],
            obstacle_centers=tuple(map(tuple, p["obstacle_centers"])),
            obstacle_half=p["obstacle_half"])
        extras = tuned_extras(s["registry"])
        self.nlp = dataclasses.replace(nlp,
                                       obstacle_form=extras["obstacle_form"])
        self.walks, self.pulled = extras["seed_walks"], extras["seed_pulled"]
        self.single = vgp.to_device(device=torch.device(device))[0]
        B = traffic["batch"]
        self.cfg, self.stages = tuned_config(s["registry"], batch=B,
                                             kkt_solver=s["kkt_solver"])
        self.cfg_warm, self.warm_stages = warm_config(self.cfg, batch=B)
        self.base = batch_tile(self.single, B)

    @property
    def x0(self):
        return self.single.x0

    @property
    def xf(self):
        return self.single.xf

    def _data(self, x0, xf):
        return dataclasses.replace(self.base, x0=x0, xf=xf)

    def seeds(self, x0, xf, gen):
        """The shooting seeds' z0 [B, nz] from ``gen``'s draws."""
        from etol_tpu_torch.solve import shooting

        return shooting.plan_guess(self.nlp, self._data(x0, xf), self.walks,
                                   gen, pulled=self.pulled)

    def cold(self, x0, xf, z0):
        from etol_tpu_torch.solve import al_sqp

        return al_sqp.solve_batched_staged(self.nlp, self.cfg,
                                           self._data(x0, xf), z0,
                                           self.stages)

    def warm(self, x0, xf, prev):
        from etol_tpu_torch.solve import al_sqp

        return al_sqp.solve_batched_staged(
            self.nlp, self.cfg_warm, self._data(x0, xf), prev.z,
            self.warm_stages, (prev.lam_def, prev.lam_eq, prev.mu), prev.rho)


class Facade:
    """The facade on the configuration's XML, with its default solver
    config."""

    def __init__(self, config: dict, traffic: dict, device):
        from etol_tpu_torch import TrajectoryOptimizer
        from etol_tpu_torch.models import dynamics

        p = config["problem"]
        w = tuple(p["cost_weights"])
        topt = TrajectoryOptimizer(device=torch.device(device))
        topt.load_configs(os.path.join(CONFIG_DIR, p["xml"]))
        topt.set_dynamics(getattr(dynamics, p["dynamics"]))
        topt.set_objective(
            lambda x, u, t, d: sum(wi * u[i] ** 2 for i, wi in enumerate(w)))
        topt.set_scheme(p["scheme"])
        topt.setup()
        self.topt = topt
        self.data = topt.data

    @property
    def x0(self):
        return self.data.x0

    @property
    def xf(self):
        return self.data.xf

    def batch(self, x0, rescue_lanes: int):
        """A cold fleet of starts ``x0`` [B, nx], rescued."""
        return self.topt.solve_batch(x0=x0, rescue_lanes=rescue_lanes)

    def episode(self, x0):
        """An episode's cold solve from ``x0`` [nx], the zones' clock back
        at 0."""
        self.topt.data = self.data
        self.topt.set_x0(x0)
        return self.topt.solve()

    def tick(self, x0):
        """One MPC re-solve from ``x0`` [nx] (host floats)."""
        return self.topt.mpc_step(x0)


ENTRIES = {"staged": Staged, "facade": Facade}
