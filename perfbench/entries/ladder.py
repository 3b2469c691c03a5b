"""A rung of the scaling ladder (``etol_tpu_torch.bench_scaling``) read from
the configuration's ETOL XML: the port's dynamics of ``problem.model``, the
scheme ``problem.scheme``, the running cost sum_i w_i u_i^2 of
``problem.cost_weights``, under the registry's config and compaction stages
(``models.tuned``). Cold batches solved by ``al_sqp.solve_batched_staged``
from the NLP's own straight-line guess, with no seeds. One card."""
from __future__ import annotations

import dataclasses
import functools
import operator
import os

import torch


def running_cost(weights):
    """ell(x, u, t, data) = sum_i w_i u_i^2, a unit weight's term unscaled
    (so unit weights give the ladder's own cost, op for op)."""
    w = tuple(float(v) for v in weights)

    def cost(x, u, t, data):
        return functools.reduce(operator.add, [
            u[i] ** 2 if wi == 1.0 else wi * u[i] ** 2
            for i, wi in enumerate(w)])
    return cost


class Entry:
    """Cold fleets of a ladder rung through the staged solve."""

    # the staged solve returns at once; its result is ready on the card
    synced = False

    def __init__(self, config: dict, traffic: dict, device, group,
                 config_dir: str):
        from etol_tpu_torch.core.problem import batch_tile
        from etol_tpu_torch.core.xml_io import load_configs
        from etol_tpu_torch.models import dynamics
        from etol_tpu_torch.models.tuned import tuned_config, tuned_extras
        from etol_tpu_torch.transcribe.nlp import NLP

        p, s = config["problem"], config["solver"]
        vgp = load_configs(os.path.join(config_dir, p["xml"]))
        nlp = NLP(dims=vgp.dims(), dynamics=getattr(dynamics, p["model"]),
                  running_cost=running_cost(p["cost_weights"]),
                  scheme=p["scheme"])
        extras = tuned_extras(s["registry"])
        self.nlp = dataclasses.replace(nlp, **{
            k: extras[k] for k in ("obstacle_form", "scheme") if k in extras})
        self.single = vgp.to_device(device=torch.device(device))[0]
        B = traffic["batch"]
        self.cfg, self.stages = tuned_config(s["registry"], batch=B,
                                             kkt_solver=s["kkt_solver"])
        self.base = batch_tile(self.single, B)

    @property
    def x0(self):
        return self.single.x0

    @property
    def xf(self):
        return self.single.xf

    def batch(self, x0, xf, seeds, spans, k):
        """The staged solve from the NLP's initial guess."""
        from etol_tpu_torch.solve import al_sqp

        with spans("perfbench.solve", k):
            return al_sqp.solve_batched_staged(
                self.nlp, self.cfg,
                dataclasses.replace(self.base, x0=x0, xf=xf), None,
                self.stages)
