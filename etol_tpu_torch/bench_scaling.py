"""Secondary benchmark: the scaling ladder beyond the headline N=50 UAS
metric.

Counterpart of ``tools/bench_scaling.py``. Configs:

  pm20       2D point mass (double integrator), N=20, B=1024
  pm3d       3D moving obstacles, N=40, B=1024
  fw100      nonlinear fixed-wing 3-DOF, N=100, B=256
  fleet4096  the headline UAS problem at B=4096, with shooting seeds

One line per config: SOLVED solves per second (solved lanes only), the
solved fraction and the largest violation. Solver configs come from the
registry (``models/tuned.py``). Runs on the card unless ``--device`` says
otherwise:

    python -m etol_tpu_torch.bench_scaling [--bmul 1] [--reps 3]
        [--device cuda] [config ...]

A run warns on stderr when fewer than 95% of its lanes solve or a lane
ends more than ten times over the violation tolerance. ``--kkt-solver`` and ``--seed`` are
for probes (the same batch under another KKT route, another draw of the
scatter and the seeds); the ladder's figures are made without them.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .bench_harness import _sync, device_line
from .core.device import resolve
from .core.problem import VGPData, batch_tile
from .models import problems
from .models.tuned import tuned_config, tuned_extras
from .solve import al_sqp, shooting

# name -> (label, model, factory arguments, batch, x0 scatter half-width,
# scattered state dims, generator seed)
LADDER = {
    "pm20": ("point-mass 2D N=20", "double_integrator_2d", {}, 1024, 0.4,
             (0, 1), 0),
    "pm3d": ("3D moving obstacles N=40", "point_mass_3d",
             dict(nsteps=40), 1024, 0.3, (0, 1, 2), 1),
    "fw100": ("fixed-wing 3-DOF N=100", "fixed_wing_3dof", {}, 256, 0.05,
              (0, 1), 2),
    "fleet4096": ("UAS fleet MPC N=50 B=4096", "uas_2d", dict(nsteps=50),
                  4096, 0.5, (0, 1), 3),
}


def scatter_x0(data: VGPData, B: int, scale: float, dims_free,
               generator: torch.Generator) -> VGPData:
    """B copies of one problem with x0 moved uniformly within ±scale in
    the state dims ``dims_free``."""
    bdata = batch_tile(data, B)
    nx = bdata.x0.shape[-1]
    d = (torch.rand((B, nx), generator=generator, device=data.x0.device,
                    dtype=data.x0.dtype) * 2.0 - 1.0) * scale
    mask = torch.zeros((nx,), dtype=d.dtype, device=d.device)
    mask[list(dims_free)] = 1.0
    return dataclasses.replace(bdata, x0=bdata.x0 + d * mask)


def apply_extras(nlp, model: str):
    """Apply the registry's model-level transcription choices (obstacle
    form, scheme); returns (nlp, extras)."""
    ex = tuned_extras(model)
    picks = {k: ex[k] for k in ("obstacle_form", "scheme") if k in ex}
    return dataclasses.replace(nlp, **picks), ex


def prepare(name: str, device=None, bmul: int = 1,
            kkt_solver: str = "kernel", batch=None, seed=None):
    """One ladder config: (label, nlp, batch of problems, cfg, stages,
    extras, generator) on ``device`` (the card when none is given).
    ``batch`` and ``seed`` override the ladder's, for small runs and for
    other draws of the scatter and the shooting seeds."""
    label, model, kw, B, scale, dims_free, own_seed = LADDER[name]
    B = (batch or B) * bmul
    seed = own_seed if seed is None else seed
    device = resolve(device)
    vgp, nlp = getattr(problems, model)(**kw)
    nlp, ex = apply_extras(nlp, model)
    data, _ = vgp.to_device(device=device)
    gen = torch.Generator(device=data.x0.device).manual_seed(seed)
    bdata = scatter_x0(data, B, scale, dims_free, gen)
    cfg, stages = tuned_config(model, batch=B, kkt_solver=kkt_solver)
    return label, nlp, bdata, cfg, stages, ex, gen


def run_config(name, nlp, bdata: VGPData, cfg, stages, shoot: int = 0,
               reps: int = 3, pulled: int = 0, generator=None,
               log=print) -> dict:
    """A first run (its results are the ones reported), then ``reps``
    timed runs back to back with one device sync; the rate counts solved
    lanes only. With ``reps=0`` the first run is the timed one (for a
    process that has solved before, where no first-use cost is left).
    Warns on stderr when the run is unhealthy (fewer than 95% solved, or
    a lane more than 10 ``cfg.tol_cons`` from feasible)."""
    B = bdata.x0.shape[0]
    dev = bdata.x0.device

    def run():
        z0 = None
        if shoot:
            z0 = shooting.plan_guess(nlp, bdata, shoot, generator,
                                     pulled=pulled)
        return al_sqp.solve_batched_staged(
            nlp, cfg, bdata, z0, stages, return_stage_trips=True)

    t0 = time.perf_counter()
    res, trips = run()
    _sync(dev)
    first_s = time.perf_counter() - t0
    solved = float((res.status == 1).float().mean())
    viol = float(torch.maximum(res.viol_eq, res.viol_in).max())
    t = first_s
    if reps:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        _sync(dev)
        t = (time.perf_counter() - t0) / reps
    sps = B * solved / t
    log(f"{name:28s} B={B:5d} solved {solved:.3f} viol {viol:.1e} "
        f"{t * 1e3:7.1f} ms/batch -> {sps:7.0f} SOLVED solves/s/chip "
        f"(first run {first_s:.1f} s, stage trips {list(trips)})")
    if solved < 0.95 or viol > 10.0 * cfg.tol_cons:
        print(f"*** LADDER UNHEALTHY: {name.strip()}: solved fraction "
              f"{solved:.3f}, max violation {viol:.1e}: the rate counts "
              f"only solved lanes ***", file=sys.stderr, flush=True)
    return dict(result=res, solved_fraction=solved, viol_max=viol,
                stage_trips=list(trips), batch_s=t, first_s=first_s,
                solves_per_s=sps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the scaling ladder")
    ap.add_argument("configs", nargs="*",
                    help=f"default: all of {', '.join(LADDER)}")
    ap.add_argument("--bmul", type=int, default=1,
                    help="batch multiplier")
    ap.add_argument("--reps", type=int, default=3, help="timed runs")
    ap.add_argument("--seed", type=int, default=None,
                    help="for probes: generator seed of the scatter and "
                         "the shooting seeds (default: each config's own)")
    ap.add_argument("--kkt-solver", default="kernel",
                    choices=("kernel", "scan", "cr"),
                    help="for probes: the same batch under another KKT "
                         "route")
    ap.add_argument("--device", default=None,
                    help="default: the card (an error where there is none)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.configs) - set(LADDER))
    if unknown:
        ap.error(f"unknown config(s) {unknown}; pick from {list(LADDER)}")
    device = resolve(args.device)
    print(f"device: {device_line(device)}  kkt_solver: "
          f"{args.kkt_solver}", flush=True)
    out = {}
    for name in args.configs or LADDER:
        label, nlp, bdata, cfg, stages, ex, gen = prepare(
            name, device, args.bmul, args.kkt_solver, seed=args.seed)
        out[name] = run_config(
            label, nlp, bdata, cfg, stages,
            shoot=ex.get("seed_walks", 0), pulled=ex.get("seed_pulled", 0),
            reps=args.reps, generator=gen,
        )
    return out


if __name__ == "__main__":
    main()
