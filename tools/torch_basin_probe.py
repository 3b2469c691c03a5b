#!/usr/bin/env python3
"""How often the shipped problems' solves land in a bad basin, in the
PyTorch port and, for the fleet, in the JAX package beside it.

    python tools/torch_basin_probe.py fleet [--lanes 256] [--jax]
    python tools/torch_basin_probe.py mip [--seeds 6]

``fleet``: ``solve_batch`` without the rescue on ``ocp_2d_ex1.xml`` for
the first ``--lanes`` starts of the fleet that ``chip_smoke.py`` solves
(x0 = (1, 2) plus numpy-seeded offsets in [-0.1, 0] x [-0.1, 0.1]); prints
how many lanes end unsolved and which. With ``--jax`` the same starts go
through the JAX package's facade as well (set ``JAX_PLATFORMS=cpu`` in the
environment). ``mip``: the eight starts of ``solve_multistart`` on
``mip_2d_ex1.xml`` for generator seeds 0..``--seeds``-1, one line of
statuses a seed (1 = SOLVED). Runs on the CPU unless ``--device`` says
otherwise; a few minutes at the default sizes.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fleet_starts(lanes):
    rng = np.random.default_rng(0)
    x0 = np.array([1.0, 2.0]) + rng.uniform(
        [-0.1, -0.1], [0.0, 0.1], size=(2048, 2))
    return x0[:lanes].astype(np.float32)


def facade(pkg, dynamics, **kw):
    topt = pkg.TrajectoryOptimizer(**kw)
    topt.load_configs(os.path.join(
        os.path.dirname(pkg.__file__), "configs", "ocp_2d_ex1.xml"))
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    return topt


def fleet(args):
    import etol_tpu_torch
    from etol_tpu_torch.models import dynamics

    x0 = fleet_starts(args.lanes)
    res = facade(etol_tpu_torch, dynamics, device=args.device).solve_batch(
        x0=x0, rescue=False)
    bad = np.where(res.status.cpu().numpy() != 1)[0]
    print(f"port: {len(bad)} of {args.lanes} lanes unsolved after phase 1: "
          f"{bad.tolist()}", flush=True)
    if args.jax:
        import etol_tpu
        import jax.numpy as jnp
        from etol_tpu.models import dynamics as jdynamics

        jres = facade(etol_tpu, jdynamics).solve_batch(
            x0=jnp.asarray(x0), rescue=False)
        jbad = np.where(np.asarray(jres.status) != 1)[0]
        print(f"jax:  {len(jbad)} of {args.lanes} lanes unsolved after "
              f"phase 1: {jbad.tolist()}", flush=True)


def mip(args):
    import torch

    from etol_tpu_torch.core.problem import tree_map
    from etol_tpu_torch.models import problems
    from etol_tpu_torch.solve import al_sqp

    vgp, nlp = problems.canonical_mip_2d()
    data, _ = vgp.to_device(device=args.device)
    tiled = tree_map(lambda a: a[None].expand((8,) + tuple(a.shape)), data)
    for seed in range(args.seeds):
        deltas = al_sqp.draw_deltas(
            8, nlp.dims.nx, 0.4, torch.Generator().manual_seed(seed),
            data.x0.device, data.x0.dtype)
        res = al_sqp.solve_batched(
            nlp, al_sqp.SolverConfig(), tiled,
            al_sqp.multistart_guesses(nlp, data, deltas))
        print(f"seed {seed}: statuses {res.status.tolist()}, objectives "
              f"{[round(float(o), 3) for o in res.obj]}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("fleet", "mip"))
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    {"fleet": fleet, "mip": mip}[args.what](args)
