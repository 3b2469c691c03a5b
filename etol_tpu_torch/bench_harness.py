"""Benchmark harness of the port: batched ``uas_2d`` solves per second on
one card at the N=50 horizon, and the latency of a warm single-problem
re-solve.

Counterpart of ``etol_tpu/bench_harness.py``, as plain functions that
return their numbers, under the registry's configuration
(``models/tuned.py``): the cold staged solve with shooting seeds and the
exact obstacle audit, repeated timed cold batches, the warm fleet
re-solve, and the receding-horizon (MPC) re-solve of one problem.

    python -m etol_tpu_torch.bench_harness [--batch 2048] [--nsteps 50]
                                           [--iters 5] [--device cuda]

prints detail on stderr and ONE JSON line on stdout:
``{"metric": "uas2d_n50_solved_solves_per_s_per_chip", "value": ...,
"unit": "solves/s/chip", "extras": {...}}``. The headline counts ONLY
lanes whose status is SOLVED (``B * solved_fraction / t``), and the run
warns on stderr when fewer than 95% solve or a solved lane has a node
inside an obstacle. It runs on the card unless ``--device`` says
otherwise, and fails where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.func import vmap

from .core.device import resolve
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


def single_problem(nsteps: int = 50, device=None) -> VGPData:
    """The bench's one ``uas_2d`` problem (no lane axis) on ``device``
    (the card when none is given): what the batches are scattered
    around, and what the MPC re-solve runs on."""
    return uas_2d(nsteps=nsteps)[0].to_device(device=resolve(device))[0]


def prepare(B: int, nsteps: int = 50, device=None, seed: int = 0,
            kkt_solver: str = "kernel"):
    """The bench's setup: ``uas_2d`` with the registry's transcription
    choice and solver config, and a batch of B scattered problems on
    ``device`` (the card when none is given).
    Returns (nlp, cfg, stages, data, generator)."""
    data = single_problem(nsteps, device)
    _, nlp = uas_2d(nsteps=nsteps)
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


def run_cold_timed(nlp, cfg, single: VGPData, B: int, stages,
                   iters: int) -> dict:
    """Throughput of the cold path: ``iters`` batches of B problems
    scattered around ``single`` (from seeds 1..iters) are staged on the
    device first, then seeded and solved back to back with one device
    sync at the end. Returns the mean batch seconds, the mean solved
    fraction and the solved-only and raw solves per second."""
    dev = single.x0.device
    extras = tuned_extras("uas_2d")
    gens = [torch.Generator(device=dev).manual_seed(i + 1)
            for i in range(iters)]
    batches = [make_batch(nlp, single, B, g) for g in gens]
    _sync(dev)
    t0 = time.perf_counter()
    fracs = []
    for d, g in zip(batches, gens):
        z0 = shooting.plan_guess(nlp, d, extras["seed_walks"], g,
                                 pulled=extras["seed_pulled"])
        res = al_sqp.solve_batched_staged(nlp, cfg, d, z0, stages)
        fracs.append((res.status == 1).float().mean())
    _sync(dev)
    t = (time.perf_counter() - t0) / iters
    solved = float(torch.stack(fracs).mean())
    return dict(batch_s=t, solved_fraction=solved,
                solves_per_s=B * solved / t, raw_solves_per_s=B / t)


def run_warm_timed(nlp, cfg_warm, data: VGPData, prev: SolveResult,
                   stages, iters: int) -> dict:
    """Throughput of the warm fleet re-solve: ``iters`` drifted batches
    (x0 + 0.01 (i+1)), each warm-started from the result before it,
    back to back with one device sync at the end."""
    dev = data.x0.device
    B = data.x0.shape[0]
    drifted = [dataclasses.replace(data, x0=data.x0 + 0.01 * (i + 1))
               for i in range(iters)]
    _sync(dev)
    t0 = time.perf_counter()
    fracs = []
    for d in drifted:
        prev = al_sqp.solve_batched_staged(
            nlp, cfg_warm, d, prev.z, stages,
            (prev.lam_def, prev.lam_eq, prev.mu), prev.rho,
        )
        fracs.append((prev.status == 1).float().mean())
    _sync(dev)
    t = (time.perf_counter() - t0) / iters
    solved = float(torch.stack(fracs).mean())
    return dict(batch_s=t, solved_fraction=solved,
                solves_per_s=B * solved / t)


def run_mpc(nlp, cfg, data: VGPData, steps: int = 20,
            pipelined: bool = True) -> dict:
    """Receding-horizon latency on ONE problem (``data`` without a lane
    axis): a cold :func:`al_sqp.solve`, then ``steps`` warm re-solves on
    x0 + 0.01 (i+1), each from the cold result's z, multipliers and
    penalty. Two numbers: the median of the re-solves timed one by one
    with a device sync each (``p50_ms``), and ``steps`` re-solves
    dispatched back to back with one sync (``pipelined_ms`` a step; None
    when ``pipelined`` is off). On a card each re-solve's loop is one
    graph launch with its stop test on the card and the loops' trip
    counters are read only when a count is asked for, so the host
    queues the next re-solve (its copies in, the launch, the result's
    copies out) while the card runs this one: ``pipelined_ms`` is the
    card's time a re-solve wherever that exceeds the host's.
    ``ticks`` (their results), ``statuses``, ``iters`` and ``finite``
    are those of the one-by-one re-solves. The KKT route is
    ``cfg.kkt_solver``'s: under "kernel" every iteration launches the
    kernel at a batch of one."""
    dev = data.x0.device
    res = al_sqp.solve(nlp, cfg, data)
    lam = (res.lam_def, res.lam_eq, res.mu)

    def resolve_at(i):
        d = dataclasses.replace(data, x0=data.x0 + 0.01 * (i + 1))
        return al_sqp.solve(nlp, cfg, d, res.z, lam, res.rho)

    resolve_at(0)  # first-use costs stay out of the timings
    _sync(dev)
    lat, ticks, statuses, iters, finite = [], [], [], [], True
    for i in range(steps):
        t0 = time.perf_counter()
        r = resolve_at(i)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        ticks.append(r)
        statuses.append(int(r.status))
        iters.append(int(r.inner_iters))
        finite = finite and bool(torch.isfinite(r.z).all())
    pipelined_ms = None
    if pipelined:
        t0 = time.perf_counter()
        for i in range(steps):
            r = resolve_at(i)
        _sync(dev)
        pipelined_ms = (time.perf_counter() - t0) / steps * 1e3
    return dict(cold=res, ticks=ticks, statuses=statuses, iters=iters,
                finite=finite,
                p50_ms=statistics.median(lat) * 1e3,
                pipelined_ms=pipelined_ms)


def main_path(B: int, nsteps: int = 50, device=None) -> dict:
    """The whole main path: cold (seeds, staged solve, audit), then the
    warm fleet re-solve on x0 + 0.01, on ``device`` (the card when none
    is given)."""
    nlp, cfg, stages, data, gen = prepare(B, nsteps, device)
    cold = run_cold(nlp, cfg, data, stages, gen)
    cfg_warm, warm_stages = warm_config(cfg, batch=B)
    drifted = dataclasses.replace(data, x0=data.x0 + 0.01)
    warm = run_warm(nlp, cfg_warm, drifted, cold["result"], warm_stages)
    return dict(nlp=nlp, data=data, cold=cold, warm=warm)


def device_line(device) -> str:
    """The device a result ran on: the card's name and power limit as
    ``nvidia-smi`` gives them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench(B: int = 2048, nsteps: int = 50, iters: int = 5,
          device=None, mpc: dict = None) -> dict:
    """The whole bench; returns the JSON line's object. ``mpc`` is the
    result of :func:`run_mpc` where the caller has just measured it on
    the same device and horizon; without it the bench measures it."""
    nlp, cfg, stages, data, gen = prepare(B, nsteps, device)
    dev = data.x0.device
    dev_line = device_line(dev)
    log(f"device: {dev_line}  kkt_solver: {cfg.kkt_solver}  "
        f"obstacle_form: {nlp.obstacle_form}")

    cold = run_cold(nlp, cfg, data, stages, gen)
    log(f"first run: seeds {cold['seed_s']:.2f} s, cold solve "
        f"{cold['cold_s']:.2f} s; solved fraction "
        f"{cold['solved_fraction']:.3f}  max viol "
        f"{cold['viol_eq_max']:.2e}/{cold['viol_in_max']:.2e}  stage "
        f"trips {cold['stage_trips']}")
    node_depth = cold["audit_node_depth_max"]
    mid_depth = cold["audit_midseg_depth_max"]
    log(f"obstacle audit (exact halfspace margins, solved lanes): deepest "
        f"NODE containment {node_depth:.2e} (<= 0: every node of every "
        f"solved lane is outside every piece); deepest mid-segment chord "
        f"dip {mid_depth:.3f} (node-wise semantics leave chords "
        f"unconstrained)")
    if node_depth > 1e-3:
        log(f"*** BENCH UNHEALTHY: a solved lane has a node "
            f"{node_depth:.3f} INSIDE an obstacle piece ***")
    if cold["solved_fraction"] < 0.95:
        log(f"*** BENCH UNHEALTHY: solved_fraction "
            f"{cold['solved_fraction']:.3f} < 0.95: the headline counts "
            f"only solved lanes; fix the budgets ***")

    single = single_problem(nsteps, dev)
    timed = run_cold_timed(nlp, cfg, single, B, stages, iters)
    log(f"batch={B} N={nsteps} mean batch time "
        f"{timed['batch_s'] * 1e3:.1f} ms solved "
        f"{timed['solved_fraction']:.3f} -> {timed['solves_per_s']:.0f} "
        f"SOLVED solves/s/chip ({timed['raw_solves_per_s']:.0f} raw)")

    cfg_warm, warm_stages = warm_config(cfg, batch=B)
    log(f"warm config: budget {cfg_warm.max_total} stages {warm_stages}")
    first = run_warm(nlp, cfg_warm, data, cold["result"], warm_stages)
    warm = run_warm_timed(nlp, cfg_warm, data, first["result"],
                          warm_stages, iters)
    log(f"warm fleet-MPC: {warm['batch_s'] * 1e3:.1f} ms/batch solved "
        f"{warm['solved_fraction']:.3f} -> {warm['solves_per_s']:.0f} warm "
        f"SOLVED solves/s/chip")

    if mpc is None:
        mpc = run_mpc(nlp, cfg, single)
    log(f"p50 warm MPC re-solve latency: {mpc['p50_ms']:.2f} ms (a device "
        f"sync after each); {mpc['pipelined_ms']:.2f} ms/step with "
        f"{len(mpc['statuses'])} dispatched back to back and one sync (on "
        f"a card each loop's stop test runs on the card); statuses "
        f"{mpc['statuses']}")

    return {
        "metric": "uas2d_n50_solved_solves_per_s_per_chip",
        "value": round(timed["solves_per_s"], 2),
        "unit": "solves/s/chip",
        "extras": {
            "device": dev_line,
            "batch": B,
            "nsteps": nsteps,
            "obstacle_form": nlp.obstacle_form,
            "audit_node_depth_max": round(node_depth, 6),
            "audit_midseg_depth_max": round(mid_depth, 4),
            "solved_fraction": timed["solved_fraction"],
            "raw_solves_per_s_per_chip": round(
                timed["raw_solves_per_s"], 2),
            "warm_solves_per_s_per_chip": round(warm["solves_per_s"], 2),
            "warm_solved_fraction": warm["solved_fraction"],
            "p50_mpc_latency_ms": round(mpc["p50_ms"], 3),
            "p50_mpc_device_ms": round(mpc["pipelined_ms"], 3),
            "stage_trip_counts": cold["stage_trips"],
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="uas_2d solved solves/s on one card, and the MPC "
                    "re-solve latency")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--nsteps", type=int, default=50)
    ap.add_argument("--iters", type=int, default=5,
                    help="timed cold and warm batches")
    ap.add_argument("--device", default=None,
                    help="default: the card (an error where there is none)")
    args = ap.parse_args(argv)
    line = bench(args.batch, args.nsteps, args.iters, args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
