"""``models.problems.uas_2d`` under the registry's config (``models.tuned``):
cold batches seeded by ``solve.shooting.plan_guess`` and solved by
``al_sqp.solve_batched_staged``, warm batches re-solved from the result
before under ``models.tuned.warm_config``. One card."""
from __future__ import annotations

import dataclasses

import torch


class Entry:
    """uas_2d fleets through the seeds and the staged solve."""

    # the staged solve returns at once; its result is ready on the card
    synced = False

    def __init__(self, config: dict, traffic: dict, device, group,
                 config_dir: str):
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

    def batch(self, x0, xf, seeds, spans, k):
        """The shooting seeds' z0 [B, nz] from ``seeds()``'s draws, then
        the staged solve from them."""
        from etol_tpu_torch.solve import al_sqp, shooting

        gen = seeds()
        with spans("perfbench.seeds", k):
            z0 = shooting.plan_guess(self.nlp, self._data(x0, xf),
                                     self.walks, gen, pulled=self.pulled)
        with spans("perfbench.solve", k):
            return al_sqp.solve_batched_staged(self.nlp, self.cfg,
                                               self._data(x0, xf), z0,
                                               self.stages)

    def warm(self, x0, xf, prev):
        from etol_tpu_torch.solve import al_sqp

        return al_sqp.solve_batched_staged(
            self.nlp, self.cfg_warm, self._data(x0, xf), prev.z,
            self.warm_stages, (prev.lam_def, prev.lam_eq, prev.mu), prev.rho)
