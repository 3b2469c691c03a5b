"""The main path of the JAX bench on the port: cold staged solve with
shooting seeds and the obstacle audit, then the warm fleet re-solve.

Counterpart of ``make_batch`` and the ``run``/``warm`` bodies of
``etol_tpu/bench_harness.py``, as plain functions that return their
numbers, for ``uas_2d`` under the registry's configuration
(``models/tuned.py``). There is no JSON bench line yet.
"""
from __future__ import annotations

import dataclasses
import time

import torch
from torch.func import vmap

from .core.problem import VGPData, batch_tile, map_lanes
from .models.problems import uas_2d
from .models.tuned import tuned_config, tuned_extras, warm_config
from .solve import al_sqp, shooting
from .solve.al_sqp import SolveResult
from .transcribe import obstacles as obs_mod


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(nlp, data: VGPData, B: int,
               generator: torch.Generator) -> VGPData:
    """B scattered problems: starts uniform in ±0.5 around the origin
    and goals uniform in ±0.5 around ``data.xf`` (positions only)."""
    bdata = batch_tile(data, B)
    dev, dtype = data.x0.device, data.x0.dtype

    def jitter():
        u = torch.rand((B, 2), generator=generator, device=dev, dtype=dtype)
        return torch.cat([u - 0.5, u.new_zeros((B, 1))], dim=1)

    x0 = jitter()
    xf = bdata.xf + jitter()
    return dataclasses.replace(bdata, x0=x0, xf=xf)


def prepare(B: int, nsteps: int = 50, device=None, seed: int = 0,
            kkt_solver: str = "kernel"):
    """The bench's setup: ``uas_2d`` with the registry's transcription
    choice and solver config, and a batch of B scattered problems.
    Returns (nlp, cfg, stages, data, generator)."""
    vgp, nlp = uas_2d(nsteps=nsteps)
    data, _ = vgp.to_device(device=device)
    nlp = dataclasses.replace(
        nlp, obstacle_form=tuned_extras("uas_2d")["obstacle_form"]
    )
    cfg, stages = tuned_config("uas_2d", batch=B, kkt_solver=kkt_solver)
    gen = torch.Generator(device=data.x0.device).manual_seed(seed)
    return nlp, cfg, stages, make_batch(nlp, data, B, gen), gen


def audit(nlp, res: SolveResult, data: VGPData):
    """Exact halfspace audit of the solved lanes: the deepest node
    containment (<= 0: every node of every solved lane is outside every
    piece) and the deepest mid-segment chord dip (node-wise semantics
    leave chords unconstrained). -1e9 when no lane solved."""
    solved = res.status == 1
    B = res.z.shape[0]
    X = res.z.reshape(B, nlp.dims.nodes, -1)[:, :, :2]
    mids = 0.5 * (X[:, 1:] + X[:, :-1])

    def depth(P):
        return map_lanes(
            lambda d, Pl: vmap(
                lambda p: torch.amax(obs_mod.halfspace_margins(p, d.obstacles))
            )(Pl),
            data, P,
        )

    big_neg = torch.full_like(X[:, 0, 0], -1e9)
    node = torch.where(solved, torch.amax(depth(X), dim=1), big_neg)
    mid = torch.where(solved, torch.amax(depth(mids), dim=1), big_neg)
    return float(node.max()), float(mid.max())


def _summary(res: SolveResult) -> dict:
    return dict(
        result=res,
        solved_fraction=float((res.status == 1).float().mean()),
        viol_eq_max=float(res.viol_eq.max()),
        viol_in_max=float(res.viol_in.max()),
    )


def run_cold(nlp, cfg, data: VGPData, stages,
             generator: torch.Generator) -> dict:
    """The registry's shooting seeds (walks + goal-pulled), the staged
    cold solve and the audit, timed with the host clock around work that
    ends in a device sync."""
    extras = tuned_extras("uas_2d")
    dev = data.x0.device
    t0 = time.perf_counter()
    z0 = shooting.plan_guess(nlp, data, extras["seed_walks"], generator,
                             pulled=extras["seed_pulled"])
    _sync(dev)
    t1 = time.perf_counter()
    res, trips = al_sqp.solve_batched_staged(
        nlp, cfg, data, z0, stages, return_stage_trips=True
    )
    _sync(dev)
    t2 = time.perf_counter()
    node_depth, mid_depth = audit(nlp, res, data)
    return dict(
        _summary(res),
        stage_trips=list(trips),
        audit_node_depth_max=node_depth,
        audit_midseg_depth_max=mid_depth,
        seed_s=t1 - t0,
        cold_s=t2 - t1,
    )


def run_warm(nlp, cfg_warm, data: VGPData, prev: SolveResult,
             stages) -> dict:
    """Warm fleet re-solve of ``data`` from the previous result's z,
    multipliers and penalty."""
    t0 = time.perf_counter()
    res = al_sqp.solve_batched_staged(
        nlp, cfg_warm, data, prev.z, stages,
        (prev.lam_def, prev.lam_eq, prev.mu), prev.rho,
    )
    _sync(data.x0.device)
    return dict(_summary(res), warm_s=time.perf_counter() - t0)


def main_path(B: int, nsteps: int = 50, device=None) -> dict:
    """The whole main path: cold (seeds, staged solve, audit), then the
    warm fleet re-solve on x0 + 0.01."""
    nlp, cfg, stages, data, gen = prepare(B, nsteps, device)
    cold = run_cold(nlp, cfg, data, stages, gen)
    cfg_warm, warm_stages = warm_config(cfg, batch=B)
    drifted = dataclasses.replace(data, x0=data.x0 + 0.01)
    warm = run_warm(nlp, cfg_warm, drifted, cold["result"], warm_stages)
    return dict(nlp=nlp, data=data, cold=cold, warm=warm)
