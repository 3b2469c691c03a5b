"""The multichip dry-run: every parallel path of the port, once, at small
sizes, with the JAX package's stages, checks and tolerances
(``__graft_entry__.py::dryrun_multichip``).

    python -m etol_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

1. a (batch × horizon) mesh of ``n_devices`` entries (horizon 2 when
   n is even) and a batch-sharded tiny ``uas_2d`` (K = 4·sp nodes, a goal
   within reach) whose lanes must all be SOLVED;
2. six warm re-solves ("ticks") of the sharded batch from moved starts,
   with their p50;
3. one long-horizon obstacle-and-track solve (K = ``horizon_nsteps`` + 1
   = 512 nodes by default) horizon-sharded over ``n_devices`` slabs
   against :func:`al_sqp.solve`, both from the same waypoint seed, run to
   convergence: |Δobj| < 1e-3 + 1e-3 |obj|, max |Δz| < 2e-2;
4. the horizon-sharded defect and AL-piece evaluators.

Every mesh entry is ``device`` (the card when none is given), as XLA's
fake devices are all one CPU: the shards run one process's way
(:mod:`.axis`).
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import torch

from ..core.device import resolve
from ..core.problem import VGP, batch_tile
from ..models import dynamics
from ..models.problems import uas_2d
from ..solve import al_sqp
from ..solve.al_sqp import SolverConfig
from ..transcribe.nlp import NLP
from . import horizon as hz
from .mesh import make_mesh, solve_sharded
from .solve_sharded import solve_horizon_sharded

# the long-horizon problem's span (s): 511 steps of 0.02 s
HORIZON_SECONDS = 511 * 0.02


def horizon_problem(nsteps: int = 511, device=None):
    """The dry-run's long-horizon problem: a 2-D single integrator from
    (0, 0) to (1, 0) over 10.22 s, a static zone across the straight line
    (below-line bias, so the optimal basin is unique) and a moving track,
    min ∫|u|². Returns (nlp, data, z0), z0 the waypoint seed over the
    zone through (0.5, 0.12)."""
    dt = HORIZON_SECONDS / nsteps
    vgp = VGP(nsteps=nsteps, dt=dt)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [1.0, 0.0]
    vgp.xtol = [0.02, 0.05]
    vgp.xlower = [-5.0, -5.0]
    vgp.xupper = [5.0, 5.0]
    vgp.ulower = [-4.0, -4.0]
    vgp.uupper = [4.0, 4.0]
    vgp.add_exclusion_zone(
        [[0.45, -0.10], [0.55, -0.10], [0.55, 0.04], [0.45, 0.04]])
    vgp.add_track(0.06, [0.0, nsteps * dt], [[0.75, 0.3], [0.75, -0.3]])
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=dynamics.single_integrator,
        running_cost=lambda x, u, t, dat: u[0] ** 2 + u[1] ** 2,
        scheme="trapezoidal",
    )
    data, _ = vgp.to_device(device=resolve(device))
    K = nsteps + 1
    dev = data.x0.device
    fr = torch.linspace(0.0, 1.0, K, device=dev)[:, None]
    x0, xf = data.x0, data.xf
    via = torch.tensor([0.5, 0.12], device=dev)
    X = torch.where(fr < 0.5, (1.0 - 2.0 * fr) * x0 + 2.0 * fr * via,
                    (2.0 - 2.0 * fr) * via + (2.0 * fr - 1.0) * xf)
    U = torch.diff(X, dim=0, append=X[-1:]) / dt
    return nlp, data, nlp.pack(X, U)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, device=None,
                     horizon_nsteps: int = 511) -> dict:
    """Run the four stages; raises on a failed check, returns the
    findings (statuses, the warm ticks' p50, both long-horizon solves)."""
    dev = resolve(device)
    sp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // sp
    mesh = make_mesh([dev] * n_devices, (dp, sp), ("batch", "horizon"))

    # tiny shapes, nodes a multiple of the horizon axis; the goal within
    # reach of the short horizon, so the lanes read SOLVED
    nsteps = 4 * sp - 1
    vgp, nlp = uas_2d(nsteps=nsteps, dt=0.5, xf=(2.0, 1.5, 0.0))
    data, dims = vgp.to_device(device=dev)
    B = 2 * dp
    i = torch.arange(B, device=dev, dtype=torch.float32)[:, None]
    x0s = torch.cat([0.02 * i, 0.01 * i, torch.zeros_like(i)], dim=1)
    bdata = dataclasses.replace(batch_tile(data, B), x0=x0s)

    # ---- 1. batch-sharded solve
    cold = solve_sharded(nlp, SolverConfig(max_total=300), bdata, mesh)
    if tuple(cold.z.shape) != (B, nlp.dims.nz):
        raise AssertionError(f"sharded z has shape {tuple(cold.z.shape)}")

    # ---- 2. warm ticks over the mesh
    cfg_tick = SolverConfig(max_total=40)
    warm = cold

    def tick(k):
        moved = dataclasses.replace(bdata, x0=bdata.x0 + 0.004 * k)
        return solve_sharded(nlp, cfg_tick, moved, mesh, z0=warm.z,
                             lam0=(warm.lam_def, warm.lam_eq, warm.mu),
                             rho0=warm.rho)

    warm = tick(1)
    lats = []
    for k in range(2, 8):
        _sync(dev)
        t0 = time.perf_counter()
        warm = tick(k)
        _sync(dev)
        lats.append(time.perf_counter() - t0)
    tick_p50 = statistics.median(lats) * 1e3
    warm_solved = float((warm.status == 1).float().mean())
    if warm_solved != 1.0:
        raise AssertionError(f"warm mesh tick left lanes unsolved: "
                             f"{warm_solved}")

    # ---- 3. one long horizon, SPIKE over n_devices slabs, against the
    # unsharded solve from the same seed, both to convergence (the f32
    # defect floor at K=512 is ~1.3e-4, so tol_cons is 3e-4)
    hnlp, hdata, hz0 = horizon_problem(horizon_nsteps, dev)
    hcfg = SolverConfig(max_total=900, tol_cons=3e-4)
    hmesh = make_mesh([dev] * n_devices, axis_names=("horizon",))
    runs = {}
    for name in ("sharded", "single"):
        _sync(dev)
        t0 = time.perf_counter()
        if name == "sharded":
            res = solve_horizon_sharded(hnlp, hcfg, hdata, hmesh, z0=hz0)
        else:
            res = al_sqp.solve(hnlp, hcfg, hdata, hz0)
        _sync(dev)
        runs[name] = (res, time.perf_counter() - t0)
    res_sh, res_1d = runs["sharded"][0], runs["single"][0]
    if int(res_sh.status) != 1:
        raise AssertionError(
            f"horizon-sharded obstacle solve: status {int(res_sh.status)} "
            f"viol {float(res_sh.viol_eq):.2e}/{float(res_sh.viol_in):.2e}")
    if int(res_1d.status) != 1:
        raise AssertionError(f"unsharded solve: {int(res_1d.status)}")
    dobj = abs(float(res_sh.obj) - float(res_1d.obj))
    dz = float((res_sh.z - res_1d.z).abs().max())
    if not dobj < 1e-3 + 1e-3 * abs(float(res_1d.obj)):
        raise AssertionError(f"objectives {float(res_sh.obj)} / "
                             f"{float(res_1d.obj)}")
    if not dz < 2e-2:
        raise AssertionError(
            f"horizon-sharded solve drifted from the unsharded one: {dz}")

    # ---- 4. horizon-sharded evaluators (halo + psum)
    Z = nlp.initial_guess(data).reshape(dims.nodes, -1)
    defs = hz.sharded_defects(nlp, data, mesh, "horizon")(Z)
    cost, viol = hz.sharded_al_pieces(nlp, data, mesh, "horizon")(Z)
    if tuple(defs.shape) != (dims.nodes, dims.nx) or not bool(
            torch.isfinite(cost) & torch.isfinite(viol)):
        raise AssertionError("the horizon-sharded evaluators failed")

    statuses = cold.status.tolist()
    if statuses != [1] * B:
        raise AssertionError(
            f"mesh compile-check lanes did not all solve: {statuses}")
    out = dict(
        mesh=mesh.shape, B=B, K=dims.nodes, statuses=statuses,
        tick_p50_ms=tick_p50, warm_solved=warm_solved,
        horizon={name: dict(status=int(r.status), obj=float(r.obj),
                            iters=int(r.inner_iters), seconds=s)
                 for name, (r, s) in runs.items()},
        horizon_K=horizon_nsteps + 1, horizon_dobj=dobj, horizon_dz=dz,
    )
    print(f"dryrun_multichip ok on {dev}: mesh={mesh.shape} B={B} "
          f"K={dims.nodes} statuses={statuses} (all SOLVED); warm tick "
          f"p50 {tick_p50:.1f} ms at warm_solved 1.0; K={horizon_nsteps + 1}"
          f" over {n_devices} slabs: |dobj| {dobj:.2e}, max|dz| {dz:.2e} "
          f"against the unsharded solve", flush=True)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    dryrun_multichip(int(argv[0]) if argv else 8, device)
