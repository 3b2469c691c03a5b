#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``etol_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its findings beside the card's name and power
limit; any failure raises, so the script exits non-zero and prints no
result line:

1. device  — CUDA must be available; the card's name and power limit;
2. build   — compile the KKT kernel (``etol_tpu_torch/csrc/bt_solve.cu``)
             with nvcc from this checkout and load it;
3. kernel  — both kernels of the source (the shared-memory one the main
             path launches, and the device-memory one kept for long
             horizons) against the plain PyTorch version on the card at
             every (K, w, batch) that a later phase gives the kernel (the
             full batches and the stage batches of the main path, of the
             ladder's models and of the B=64 A/Bs, taken from the
             registry) and at ragged batches; a later phase fails if it
             launched the kernel at a shape not checked here; a lane with
             an indefinite block must come out
             non-finite and leave the others alone; then, at the main
             path's four batch sizes and the ladder's full batches, both
             kernels in turns and
             the plain version timed with CUDA events over rotating
             inputs (the kernels as replays of a CUDA graph of
             launches), beside the bound from the shapes and a dense
             ``torch.linalg.solve`` of the assembled systems as the
             library yardstick, and the same at the facade's shapes;
4. main    — the port's main path on the default device: ``uas_2d`` N=50,
             B=2048, shooting seeds, the staged cold solve, the obstacle
             audit, and the warm fleet re-solve on x0 + 0.01; the kernel's
             launch count, by batch size, over exactly that run;
5. a/b     — B=64, N=50 cold solves with the kernel and with the plain
             "scan" KKT path, both on the card;
6. cr      — cyclic reduction (plain torch ops, no kernel of its own)
             against the plain block Cholesky and the kernel on the card,
             at the ladder's shapes and one width above the kernel's 9;
             then one problem (B=1) at K = 51, 101, 511, 2047, w=5: the
             plain scan, cyclic reduction and the kernel timed;
7. mpc     — the single-problem warm re-solve at N=50
             (``bench_harness.run_mpc``) under ``kkt_solver="kernel"``
             (every iteration a launch at B=1) and again under ``"cr"``
             (the JAX package's route, no launch; the first MPC_CR_STEPS
             of the MPC_STEPS re-solves): statuses, latencies, launches and
             cyclic-reduction solves of each;
8. bench   — ``bench_harness.bench`` at B=2048 with one timed cold and
             one timed warm batch and phase 7's MPC figures under
             "kernel": its JSON line;
9. ladder  — ``bench_scaling.run_config`` for pm20 (K=21, w=6, B=1024),
             pm3d (K=41, w=6, B=1024) and fw100 (K=101, w=9, B=256) under
             the registry configs: solved fractions, the kernel's launches
             by shape, and an A/B at B=64 for each: pm20's and pm3d's cold
             solves under the kernel against the plain "scan" path, and for
             fw100 a warm re-solve of moved starts under the kernel against
             "cr" (its cold solve is 156 KKT solves at K=101, a second each
             by the scan and a quarter by cyclic reduction; the plain
             version is held against the kernel at that shape in phase 3,
             and against cyclic reduction in phase 6);
10. facade — the library's entry point on the default device: the README's
             Quick start on ``ocp_2d_ex1.xml`` (load, setup, solve, debug,
             get_xtraj, save, load_csv), MPC_STEPS ``mpc_step``s under
             "kernel" and MPC_CR_STEPS under "cr", ``solve_multistart`` on
             both shipped problems
             (the OCP against the golden CSVs), ``solve_batch`` at B=2048
             cold with a rescue of 512 lanes and warm, a small fleet whose
             tight budget forces the rescue phase, and the CLI's
             ``solve_ocp`` and ``mpc_demo 5`` in-process; one JSON line of
             its findings;
11. exact  — the exact MILP path: ``side_branch.solve_exact`` on
             ``mip_2d_ex1.xml`` with ``convex_relaxation=True`` under
             ``kkt_solver="kernel"`` (every Newton trip of every wave one
             launch at (17, 6, 8)) and under ``"cr"`` (no launch), and the
             facade's ``solve_exact`` on the composed demo (a BINARY boost
             and an obstacle, wave 16; launches at (7, 5, 16)), with
             ``get_xtraj`` and ``save``; nodes, waves, trips, launches and
             seconds of each, and one JSON line of its findings;
12. planners — the sampling planners on ``uas_2d`` N=50 (three boxes) at
             the problem's default budget (N dt = 10 s, 20480 samples):
             each of the seven names (samples, trips, seconds, best score,
             tree counts, PDST's largest priority); planner-seeded
             ``al_sqp.solve``s under "kernel" from RRT, SST and PDST
             (launches at (51, 5, 1)); the facade's ``set_planner`` +
             ``plan`` on ``ocp_2d_ex1.xml`` for every name, at a budget
             of 4 s (8192 samples); one JSON line;
13. fleet  — the multi-vehicle model: three vehicles (w = 12, above the
             kernel's 9: cyclic reduction, no launch) under "kernel", then
             re-solved warm under "cr", two vehicles (w = 8) single under "kernel" (launches at
             (25, 8, 1)), and a batch of FLEET_B two-vehicle fleets with
             starts moved by a fixed draw of +-0.25 (launches at (25, 8,
             FLEET_B)); one JSON line;
14. parallel — the parallel layer: the horizon-sharded SPIKE KKT solve
             (``parallel.kkt.make_solver`` over n slabs, one launch for
             the slabs' interiors with their 2w+1 columns as lanes and one
             for the separators) at B=1, w=5, K in SPIKE_K and n in
             SPIKE_N against the direct launch and the plain version
             (max |dx|, host ms with a sync); ``dryrun_multichip(8)`` on
             the card (a batch-sharded tiny uas_2d, warm ticks, a K=512
             obstacle solve horizon-sharded over 8 slabs against the
             unsharded one, the sharded evaluators); ``cli fleet_batch
             512`` in-process; two subprocess ranks on this card over gloo
             (``python -m etol_tpu_torch.parallel.distributed``, loading
             the library this process built) whose gathered objectives
             must be this process's ``solve_batched``; one JSON line.

The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py
--phases kernel,cr`` runs phases 1 and 2 and the named ones only, and
prints neither line.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (K, w, B) that are timed: the main path's K=51, w=5 at every batch its
# stages give the kernel (2048, then B/2, B/8, B/32), and the full batches
# of the ladder's other models (pm20, pm3d, fw100)
MAIN_SHAPES = ((51, 5, 2048), (51, 5, 1024), (51, 5, 256), (51, 5, 64))
LADDER_SHAPES = ((21, 6, 1024), (41, 6, 1024), (101, 9, 256))
# the facade's: ocp_2d_ex1.xml is K=33, w=4 (one problem, 8 starts, the
# fleet, its rescue batch of RESCUE_LANES lanes times 4 starts, which is
# the fleet's size again, the batch of a default rescue, B // 8 lanes
# times 4, and the small fleet of FORCED_B lanes whose rescue takes
# FORCED_LANES of them), mip_2d_ex1.xml is K=17, w=6 (8 starts); and the
# main path's one problem. About one fleet lane in six ends its first
# phase in an infeasible basin (the starts lie 0.01 outside a moving
# obstacle), so the rescue is given a quarter of the fleet, not the
# default eighth.
FACADE_B, FORCED_B, FORCED_LANES = 2048, 64, 8
RESCUE_LANES = FACADE_B // 4
FACADE_SHAPES = ((33, 4, 1), (33, 4, 8), (33, 4, FACADE_B),
                 (33, 4, FACADE_B // 2), (17, 6, 8))
FORCED_SHAPES = ((33, 4, FORCED_B), (33, 4, FORCED_LANES * 4))
B1_SHAPE = (51, 5, 1)
# the exact path: a wave of EXACT_WAVE nodes is one batched solve, so
# mip_2d_ex1.xml launches at (17, 6, 8) (a facade shape already) and the
# composed demo (K=7, w=5: two states, two controls, the boost) at (7, 5,
# COMPOSED_WAVE): waves of 16 since the parallel phase came (on a CPU 22
# waves, 1044 trips, against 40 and 1589 at 8; the same certified optimum)
EXACT_WAVE, COMPOSED_WAVE, EXACT_MAX_NODES = 8, 16, 384
EXACT_SHAPES = ((17, 6, EXACT_WAVE), (7, 5, COMPOSED_WAVE))
# the fleet phase: fleet_2d's 24 steps (K=25) of two vehicles (w = 4V = 8)
# solved one at a time and as a batch of FLEET_B fleets whose starts move
# by a fixed numpy draw within +-FLEET_SPREAD; solve_batched keeps the
# whole batch to the end, so it launches at the full batch only
FLEET_B, FLEET_SPREAD, FLEET_SEED = 1024, 0.25, 0
FLEET_SHAPES = ((25, 8, 1), (25, 8, FLEET_B))
# the fleet test's limits (tests/test_fleet.py): goals within 0.06, the
# separation d_min = 0.5 held to 1e-2
FLEET_GOAL_TOL, FLEET_DMIN = 0.06, 0.49
# the single two-vehicle fleet (the parity test's draw) converges to
# FLEET2_OBJ in the JAX package on a CPU and in the port on a CPU to
# 1.1e-7 relative (tests/test_torch_fleet.py checks the figure); it stops
# in a flat valley whose objective moves with the arithmetic (8.668407 on
# an H100, 0.32% lower; solved to 1e-6 instead it runs out of iterations
# at 3.6e-5 on the card in float32), so the card is held to 1% of it
FLEET2_OBJ, FLEET2_RTOL = 8.696102, 1e-2
# the golden's objective for mip_2d_ex1.xml (tests/golden/mip_2d_ex1.csv),
# the composed demo's certified optimum, and how close a certified search
# is held to them: for the MIP the JAX package's own limit for its exact
# search against HiGHS's certified optimum (tests/test_golden.py, random
# instances; a SOLVED node is feasible only to tol_cons, and this MIP's
# closing relaxations spread over 11.954-11.963 with their warm starts),
# 1e-3 for the composed demo; the two KKT routes' MIP objectives are held
# within MIP_ROUTE_TOL of each other (9.3e-5 apart on an H100, 1.5e-3 when
# the same script's exact phase runs on a CPU)
MIP_GOLDEN, COMPOSED_OPT = 11.96, 8.44876
MIP_TOL, COMPOSED_TOL, MIP_ROUTE_TOL = 7e-3, 1e-3, 2e-3
# the parallel phase: SPIKE at B=1, w=SPIKE_W over n slabs; the dry-run
# over DRYRUN_N entries (horizon 2), its long horizon K = DRYRUN_NSTEPS + 1
# single-integrator nodes (w = 4) over DRYRUN_N slabs and its tiny uas_2d
# (K = 8, B = 8: the chunks share the card, one batch); cli fleet_batch at
# FLEET_BATCH_B (one card, one chunk); the two ranks' demo (double
# integrator K = 21, w = 6, 4 lanes a rank, 8 in this process; SPIKE at
# K = 16, w = 3 and the horizon solve at K = 16, w = 4, a slab a rank)
SPIKE_K, SPIKE_N, SPIKE_W, SPIKE_REPS = (512, 2048), (8, 32), 5, 20
DRYRUN_N, DRYRUN_NSTEPS = 8, 511
FLEET_BATCH_B = 512
DIST_RANKS, DIST_B = 2, 8


def spike_shapes(K, w, n, B=1, slabs=None):
    """The two launches of one SPIKE solve of B systems over n slabs, of
    which a process holds ``slabs`` (n; 1 a rank): the interiors with
    their 2w+1 columns as lanes, and the separators."""
    slabs = n if slabs is None else slabs
    return ((K // n - 1, w, B * slabs * (2 * w + 1)), (n, w, B))


PARALLEL_SHAPES = tuple(dict.fromkeys(
    [s for K in SPIKE_K for n in SPIKE_N
     for s in spike_shapes(K, SPIKE_W, n)]
    + list(spike_shapes(DRYRUN_NSTEPS + 1, 4, DRYRUN_N))
    + [(DRYRUN_NSTEPS + 1, 4, 1), (8, 5, 8), (51, 5, FLEET_BATCH_B),
       (21, 6, DIST_B), (21, 6, DIST_B // DIST_RANKS)]
    + list(spike_shapes(16, 3, DIST_RANKS, slabs=1))
    + list(spike_shapes(16, 4, DIST_RANKS, slabs=1)) + [(16, 4, 1)]))
TIMED_SHAPES = (MAIN_SHAPES + LADDER_SHAPES + FACADE_SHAPES + (B1_SHAPE,)
                + tuple(s for s in EXACT_SHAPES if s not in FACADE_SHAPES)
                + FLEET_SHAPES
                + tuple(s for s in PARALLEL_SHAPES if s != B1_SHAPE))
# batches that are no multiple of the lanes a block takes
RAGGED_SHAPES = ((51, 5, 3), (41, 6, 7), (21, 6, 1000))
TIMED_SET_BYTES = 100 * 2 ** 20
# launches recorded into the CUDA graph that times a kernel
TIMED_INNER = 10
# single calls of the plain version timed at each shape (0.07-0.8 s each)
PLAIN_REPS = 3
# the two kernels of bt_solve.cu: a lane across w threads with the factor
# in shared memory, and one thread a lane with the factor in device memory
VARIANTS = ("smem", "global")
# published peaks of one H100 SXM: device memory rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
MAIN_B, MAIN_NSTEPS, AB_B = 2048, 50, 64
# ladder config -> its (K, w)
LADDER = {"pm20": (21, 6), "pm3d": (41, 6), "fw100": (101, 9)}
# (K, w, B) the kernel phase held against the plain version; None until
# that phase has run (a run of picked phases without it checks no launch)
CHECKED = None
# phase 6: shapes where cyclic reduction is held against the plain block
# Cholesky (and the kernel, up to its width), and the B=1 horizons timed
CR_SHAPES = ((51, 5, 64), (41, 6, 64), (101, 9, 64), (21, 10, 64))
B1_HORIZONS = (51, 101, 511, 2047)
# phases 7 and 10: re-solves under "kernel" and of the "cr" side (20 and
# 10 until the parallel phase came, cut to keep the script near half its
# time limit)
MPC_STEPS, MPC_CR_STEPS = 10, 5
# phase 9, fw100's warm A/B: the starts move by this much (km; the ladder
# scatters them within 0.05), and a re-solve gets this many iterations
WARM_DRIFT, WARM_BUDGET = 0.005, 60
PHASES = ("kernel", "main", "a/b", "cr", "mpc", "bench", "ladder", "facade",
          "exact", "planners", "fleet", "parallel")
# the planners phase: the planner-seeded solves, and the facade's budget
# on ocp_2d_ex1.xml: 4 s, 8192 samples, a quarter of its problem-derived
# 16 s (32768 samples, 511 trips a tree, 48 s of the phase on a slower
# host) to keep the whole script near half its time limit
SEEDED = ("RRT", "SST", "PDST")
FACADE_PLAN_SECONDS = 4.0

CARD = None


def say(phase, msg):
    print(f"[{phase}] [{CARD}] {msg}", flush=True)


class Clock:
    """Seconds since the script's start and since the last call, said at
    the end of each phase."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, phase):
        now = time.perf_counter()
        say(phase, f"phase took {now - self.last:.1f} s "
                   f"({now - self.start:.1f} s since the start)")
        self.last = now


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def spd_problem(torch, B, K, w, seed):
    """SPD block-tridiagonal systems as tests/test_pallas_bt.py makes
    them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = rng.normal(size=(B, K, w, w)).astype(np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 5 * np.eye(w, dtype=np.float32)
    O = (rng.normal(size=(B, K - 1, w, w)) * 0.3).astype(np.float32)
    r = rng.normal(size=(B, K, w)).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (D, O, r)]


def spd_problem_sets(torch, B, K, w, seed):
    """The same kind of systems made on the card, in as many sets as hold
    more than twice the 50 MB L2 together (at most 64): a timed launch
    takes the next set in turn and finds its inputs as cold as the cache
    lets a caller find them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    set_bytes = 4 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)
    n = max(2, min(64, -(-TIMED_SET_BYTES // set_bytes)))
    eye = 5 * torch.eye(w, device="cuda")
    sets = []
    for _ in range(n):
        A = torch.randn((B, K, w, w), generator=gen, device="cuda")
        D = (A @ A.transpose(-1, -2) + eye).contiguous()
        O = 0.3 * torch.randn((B, K - 1, w, w), generator=gen,
                              device="cuda")
        r = torch.randn((B, K, w), generator=gen, device="cuda")
        sets.append((D, O, r))
    return sets


def _median_event_ms(torch, run, reps, per):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    times.sort()
    return times[len(times) // 2]


def median_ms(torch, fn, reps=20):
    """Median over ``reps`` single calls of ``fn(i)``, each between two
    CUDA events, after one warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    calls = iter(range(1, reps + 1))
    return _median_event_ms(torch, lambda: fn(next(calls)), reps, 1)


def graph_ms(torch, fn, reps=20, inner=10):
    """The card's time for one call of ``fn(i)``: ``inner`` calls in a row
    are recorded into a CUDA graph, and the median over ``reps`` replays,
    each between two CUDA events, is divided by ``inner``. A replay costs
    the host one call, so a kernel shorter than its wrapper's host time is
    timed by the card and not by the host that enqueues it."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = [fn(i) for i in range(1, inner + 1)]
    graph.replay()
    torch.cuda.synchronize()
    ms = _median_event_ms(torch, graph.replay, reps, inner)
    del held
    return ms


def bound(K, w, B):
    """The least time the card could take for one (K, w, B) solve:
    (bound_ms, bound_by, bytes, flops). Bytes: D, O, r read once, x
    written once. Operations a node and lane: Cholesky w^3/3, W = L^-1 O
    w^3, Schur update 2 w^3, four sweeps of 3 w^2, residual 6 w^2."""
    nbytes = 4 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)
    flops = B * K * (w ** 3 / 3 + 3 * w ** 3 + 18 * w ** 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_flops else "operations"
    return max(t_bytes, t_flops), by, nbytes, flops


def path_shapes(bench_scaling):
    """Every (K, w, B) the later phases give the kernel, from the
    registry: each model's full batch and its stages' batches (the cold
    ones, and the warm re-solve's for the main path), at the size its path
    runs and at the A/B's."""
    from etol_tpu_torch.models.tuned import tuned_config, warm_config

    runs = [("uas_2d", 51, 5, MAIN_B)]
    runs += [(bench_scaling.LADDER[name][1], K, w,
              bench_scaling.LADDER[name][3])
             for name, (K, w) in LADDER.items()]
    shapes = []
    for model, K, w, full in runs:
        for B in (full, AB_B):
            cfg, stages = tuned_config(model, batch=B)
            if model == "uas_2d":
                stages += warm_config(cfg, batch=B)[1]
            for b in [B] + [min(cap, B) for cap, _ in stages]:
                if (K, w, b) not in shapes:
                    shapes.append((K, w, b))
    for shape in ((B1_SHAPE,) + FACADE_SHAPES + FORCED_SHAPES + EXACT_SHAPES
                  + FLEET_SHAPES + PARALLEL_SHAPES):
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def assert_checked(path, launches_by):
    """Fail if ``path`` launched the kernel at a (K, w, B) that the kernel
    phase did not hold against the plain version."""
    if CHECKED is None:
        return
    missed = sorted({key[1:] for key in launches_by} - CHECKED)
    if missed:
        raise AssertionError(
            f"{path}: kernel launches at {missed}, shapes the kernel phase "
            "did not compare with the plain version")


def compare(torch, bt_cuda, btridiag, K, w, B, seed):
    """Both kernel variants against the plain version at one shape;
    returns the larger max |x_kernel - x_plain|."""
    D, O, r = spd_problem(torch, B, K, w, seed=seed)
    xp = btridiag.solve_refined(D, O, r)
    scale = float(xp.abs().max())
    res_p = float((r - btridiag.matvec(D, O, xp)).abs().max())
    worst = 0.0
    for variant in VARIANTS:
        xk = bt_cuda.solve(D, O, r, variant=variant)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        res_k = float((r - btridiag.matvec(D, O, xk)).abs().max())
        say("kernel", f"K={K} w={w} B={B} {variant}: max|x_kernel - "
                      f"x_plain| {err:.3e} (limit "
                      f"{2e-4 * (1 + scale):.3e}), |r - Hx|inf kernel "
                      f"{res_k:.3e} plain {res_p:.3e}")
        if not (err <= 2e-4 * (1.0 + scale)):
            raise AssertionError(
                f"{variant} kernel disagrees at {(K, w, B)}: {err}")
        if not (res_k <= res_p + 1e-4):
            raise AssertionError(
                f"{variant} kernel residual {res_k} > plain {res_p}")
        worst = max(worst, err)
    CHECKED.add((K, w, B))
    return worst


def check_indefinite(torch, bt_cuda):
    """One lane's D block set to -I: that lane's x is non-finite, every
    other lane is what it is without the bad block."""
    K, w, B = 51, 5, 64
    bad = 17
    D, O, r = spd_problem(torch, B, K, w, seed=11)
    Dbad = D.clone()
    Dbad[bad, 3] = -torch.eye(w, device="cuda")
    keep = torch.arange(B, device="cuda") != bad
    for variant in VARIANTS:
        x = bt_cuda.solve(D, O, r, variant=variant)
        xb = bt_cuda.solve(Dbad, O, r, variant=variant)
        torch.cuda.synchronize()
        if bool(torch.isfinite(xb[bad]).all()):
            raise AssertionError(
                f"{variant}: the indefinite lane came out finite")
        if not torch.equal(xb[keep], x[keep]):
            raise AssertionError(
                f"{variant}: an indefinite lane changed another lane")
        say("kernel", f"indefinite lane {bad} of {B} ({variant}): "
                      f"non-finite x there, all other lanes unchanged")


def check_kernel(torch, bt_cuda, btridiag, shapes):
    """Phase 3: both kernels vs plain on the card at ``shapes`` and the
    ragged ones, then the timings at the main path's and the ladder's
    full batches and the facade's shapes; returns (max_abs_err, times)
    with times[(K, w, B)] = dict(smem, global, plain, library, bound,
    bound_by)."""
    global CHECKED
    CHECKED = set()
    worst = 0.0
    if not set(TIMED_SHAPES) <= set(shapes):
        raise AssertionError("a timed shape is not one the paths run")
    for i, (K, w, B) in enumerate(tuple(shapes) + RAGGED_SHAPES):
        if bt_cuda.plan(K, w, B).variant != "smem":
            raise AssertionError(f"{(K, w, B)} is not planned for the "
                                 "shared-memory kernel")
        worst = max(worst, compare(torch, bt_cuda, btridiag, K, w, B,
                                   seed=K + w + i))
    check_indefinite(torch, bt_cuda)

    times = {}
    for K, w, B in TIMED_SHAPES:
        sets = spd_problem_sets(torch, B, K, w, seed=B)
        n = len(sets)
        t = {}
        # in turns within one process on one card: new, old, old, new
        runs = []
        for variant in ("smem", "global", "global", "smem"):
            runs.append((variant, graph_ms(
                torch,
                lambda i, v=variant: bt_cuda.solve(*sets[i % n], variant=v),
                inner=TIMED_INNER,
            )))
        for variant in VARIANTS:
            both = [ms for v, ms in runs if v == variant]
            t[variant] = sum(both) / len(both)
        # one call at the long horizons (1.4 s at K=511)
        t["plain"] = median_ms(
            torch, lambda i: btridiag.solve_refined(*sets[i % n]),
            reps=PLAIN_REPS if K <= 200 else 1)
        # the nearest single PyTorch call: a dense solve of the assembled
        # [B, K w, K w] systems, no refinement; the assembly is not timed
        D, O, r = sets[0]
        H = dense(torch, D, O)
        rhs = r.reshape(B, K * w, 1)
        t["library"] = median_ms(
            torch, lambda i: torch.linalg.solve(H, rhs), reps=5)
        xd = torch.linalg.solve(H, rhs).reshape(B, K, w)
        err_d = float((xd - bt_cuda.solve(D, O, r)).abs().max())
        del H, xd
        t["bound"], t["bound_by"], nbytes, flops = bound(K, w, B)
        say("kernel", f"K={K} w={w} B={B} ({n} input sets in turn): "
                      + ", ".join(f"{v} {ms:.4f} ms" for v, ms in runs)
                      + f", plain {t['plain']:.4f} ms (CUDA events: median "
                        f"of 20 replays of a graph of {TIMED_INNER} "
                        f"launches, plain of {PLAIN_REPS} single calls, one "
                        f"above K=200); "
                        f"bound {t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops:.0f} flop); "
                        f"torch.linalg.solve on the dense [{B}, {K * w}, "
                        f"{K * w}] systems (no refinement) "
                        f"{t['library']:.4f} ms, median of 5, max|x_dense "
                        f"- x_kernel| {err_d:.3e}")
        times[(K, w, B)] = t
    return worst, times


def dense(torch, D, O):
    """The systems of (D, O) as dense matrices [B, K w, K w]."""
    B, K, w, _ = D.shape
    H = torch.zeros((B, K, w, K, w), device=D.device)
    k = torch.arange(K, device=D.device)
    H[:, k, :, k, :] = D.permute(1, 0, 2, 3)
    H[:, k[:-1], :, k[1:], :] = O.permute(1, 0, 2, 3)
    H[:, k[1:], :, k[:-1], :] = O.permute(1, 0, 3, 2)
    return H.reshape(B, K * w, K * w)


def host_ms(torch, fn, reps, warm=True):
    """Median host-clock milliseconds of ``fn()`` followed by a device
    sync, after one warm-up call (none with ``warm`` off, for calls that
    take seconds): what a caller that waits for the answer sees."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def check_cr(torch, bt_cuda, btridiag, cyclic_reduction):
    """Phase 6: cyclic reduction against the plain version and the kernel,
    then the B=1 route table; returns {K: dict(scan, cr, kernel,
    variant)} in milliseconds."""
    for i, (K, w, B) in enumerate(CR_SHAPES):
        D, O, r = spd_problem(torch, B, K, w, seed=100 + i)
        xp = btridiag.solve_refined(D, O, r)
        xc = cyclic_reduction.solve_refined(D, O, r)
        limit = 2e-4 * (1.0 + float(xp.abs().max()))
        err_p = float((xc - xp).abs().max())
        msg = (f"K={K} w={w} B={B}: max|x_cr - x_plain| {err_p:.3e} "
               f"(limit {limit:.3e})")
        if not err_p <= limit:
            raise AssertionError(f"cyclic reduction disagrees: {msg}")
        if w <= bt_cuda.MAX_W:
            err_k = float((xc - bt_cuda.solve(D, O, r)).abs().max())
            msg += f", max|x_cr - x_kernel| {err_k:.3e}"
            if not err_k <= limit:
                raise AssertionError(
                    f"cyclic reduction and the kernel disagree: {msg}")
        else:
            try:
                bt_cuda.solve(D, O, r)
            except ValueError:
                msg += ", the kernel's wrapper refuses this width"
            else:
                raise AssertionError(f"bt_cuda.solve took w={w}")
        say("cr", msg)

    table = {}
    w = 5
    for K in B1_HORIZONS:
        D, O, r = spd_problem(torch, 1, K, w, seed=K)
        variant = bt_cuda.plan(K, w, 1).variant
        row = dict(
            # one call at the long horizons, with no warm-up: the scan
            # takes 1.4 s and 5.2 s there
            scan=host_ms(torch, lambda: btridiag.solve_refined(D, O, r),
                         reps=1 if K > 200 else 7, warm=K <= 200),
            cr=host_ms(torch,
                       lambda: cyclic_reduction.solve_refined(D, O, r),
                       reps=11),
            kernel=host_ms(torch, lambda: bt_cuda.solve(D, O, r), reps=21),
            variant=variant,
        )
        xk = bt_cuda.solve(D, O, r)
        xc = cyclic_reduction.solve_refined(D, O, r)
        err = float((xk - xc).abs().max())
        if not err <= 2e-4 * (1.0 + float(xc.abs().max())):
            raise AssertionError(f"B=1 K={K}: kernel and cr differ {err}")
        say("cr", f"B=1 K={K} w={w}: scan {row['scan']:.3f} ms, cyclic "
                  f"reduction {row['cr']:.3f} ms, kernel ({variant}) "
                  f"{row['kernel']:.3f} ms (host clock with a sync, "
                  f"median); max|x_kernel - x_cr| {err:.3e}")
        table[K] = row
    return table


def reset_counts(bt_cuda, cyclic_reduction):
    """Every route's count to 0, just before a path is driven."""
    bt_cuda.LAUNCHES = 0
    bt_cuda.LAUNCHES_BY.clear()
    cyclic_reduction.SOLVES = 0


def check_mpc(torch, bench_harness, bt_cuda, cyclic_reduction):
    """Phase 7: the single-problem warm re-solve at N=50 on the card under
    both KKT routes; returns {route: ``run_mpc``'s result with the
    kernel's launches and the cyclic-reduction solves over it}. Under
    "kernel" every Newton iteration is one launch at B=1 and cyclic
    reduction is never called; under "cr" the reverse. The "cr" side,
    which only stands beside the other for comparison, takes the first
    MPC_CR_STEPS of the MPC_STEPS re-solves and skips the back-to-back
    part."""
    nlp, cfg, _, _, _ = bench_harness.prepare(1, MAIN_NSTEPS)
    if cfg.kkt_solver != "kernel":
        raise AssertionError("the registry's route is not the kernel")
    single = bench_harness.single_problem(MAIN_NSTEPS)
    runs = {}
    for route in ("kernel", "cr"):
        reset_counts(bt_cuda, cyclic_reduction)
        out = bench_harness.run_mpc(
            nlp, dataclasses.replace(cfg, kkt_solver=route), single,
            steps=MPC_STEPS if route == "kernel" else MPC_CR_STEPS,
            pipelined=route == "kernel")
        out["launches"] = bt_cuda.LAUNCHES
        out["cr_solves"] = cyclic_reduction.SOLVES
        by = dict(bt_cuda.LAUNCHES_BY)
        n_ok = out["statuses"].count(1)
        say("mpc", f"uas_2d N={MAIN_NSTEPS}, one problem, kkt_solver="
                   f"{route}: {out['launches']} kernel launches "
                   f"{sorted(by.items())}, {out['cr_solves']} cyclic-"
                   f"reduction solves; cold status "
                   f"{int(out['cold'].status)} after "
                   f"{int(out['cold'].inner_iters)} iterations; re-solve "
                   f"statuses {out['statuses']}, iterations {out['iters']}")
        tail = ("" if out["pipelined_ms"] is None else
                f", {out['pipelined_ms']:.2f} ms a step with {MPC_STEPS} "
                f"dispatched "
                f"back to back and one sync")
        say("mpc", f"kkt_solver={route}: p50 re-solve latency "
                   f"{out['p50_ms']:.2f} ms over {len(out['statuses'])} "
                   f"re-solves with a sync after each{tail}")
        if not out["finite"]:
            raise AssertionError("an MPC re-solve returned non-finite z")
        if n_ok < len(out["statuses"]) - 2:
            raise AssertionError(
                f"only {n_ok} of {len(out['statuses'])} MPC re-solves "
                f"SOLVED")
        if route == "kernel":
            if out["launches"] <= 0 or out["cr_solves"] or set(by) != {
                    ("smem",) + B1_SHAPE}:
                raise AssertionError(
                    "under 'kernel' the unbatched solve should launch the "
                    f"shared-memory kernel at {B1_SHAPE} and nothing else")
            assert_checked("mpc", by)
        elif out["launches"] or out["cr_solves"] <= 0:
            raise AssertionError(
                "under 'cr' the unbatched solve should take cyclic "
                "reduction and launch no kernel")
        runs[route] = out
    return runs


def ab_runs(torch, bt_cuda, name, solve, other="scan"):
    """``solve(kkt)`` -> (result, stage trips) under "kernel" and under
    ``other`` ("scan" or "cr", neither a kernel); every launch of the
    kernel side must be at a checked shape."""
    runs = {}
    for kkt in ("kernel", other):
        bt_cuda.LAUNCHES_BY.clear()
        t0 = time.perf_counter()
        runs[kkt], trips = solve(kkt)
        torch.cuda.synchronize()
        say("a/b", f"{name} {kkt}: stage trips {list(trips)} in "
                   f"{time.perf_counter() - t0:.1f} s")
        assert_checked(f"{name} a/b ({kkt})", bt_cuda.LAUNCHES_BY)
    ab(torch, name, runs, other)


def ab(torch, name, runs, other):
    """Kernel against ``other`` on the same batch: solved counts within 2,
    mean objectives over the lanes both solved within 1%."""
    ok_k = runs["kernel"].status == 1
    ok_s = runs[other].status == 1
    both = ok_k & ok_s
    n_k, n_s = int(ok_k.sum()), int(ok_s.sum())
    obj_k = float(runs["kernel"].obj[both].mean())
    obj_s = float(runs[other].obj[both].mean())
    say("a/b", f"{name} B={AB_B}: solved kernel {n_k} {other} {n_s}; mean "
               f"objective over {int(both.sum())} lanes solved by both: "
               f"kernel {obj_k:.6f} {other} {obj_s:.6f}")
    if abs(n_k - n_s) > 2:
        raise AssertionError(
            f"{name}: kernel and {other} solved counts differ by > 2")
    if not abs(obj_k - obj_s) <= 0.01 * abs(obj_s):
        raise AssertionError(
            f"{name}: kernel and {other} objectives differ by > 1%")


def check_ladder(torch, bench_scaling, bt_cuda):
    """Phase 9: the ladder's three other models on the default device
    under the registry configs, then their A/B against a plain route;
    returns {name: dict(solved_fraction, ..., launches_by)}."""
    out = {}
    for name, (K, w) in LADDER.items():
        label, nlp, bdata, cfg, stages, _, gen = bench_scaling.prepare(name)
        B = bdata.x0.shape[0]
        if cfg.kkt_solver != "kernel" or bdata.x0.device.type != "cuda":
            raise AssertionError(f"{name}: not the kernel on the card")
        bt_cuda.LAUNCHES = 0
        bt_cuda.LAUNCHES_BY.clear()
        run = bench_scaling.run_config(
            label, nlp, bdata, cfg, stages, reps=0, generator=gen,
            log=lambda line: say("ladder", line))
        launches, by = bt_cuda.LAUNCHES, dict(bt_cuda.LAUNCHES_BY)
        say("ladder", f"{name}: kernel launches {launches} by (variant, K, "
                      f"w, B): {sorted(by.items(), key=lambda kv: -kv[0][3])}")
        res = run["result"]
        if not run["solved_fraction"] >= 0.95:
            raise AssertionError(
                f"{name}: solved {run['solved_fraction']} < 0.95")
        if not bool(torch.isfinite(res.z).all()):
            raise AssertionError(f"{name}: non-finite z")
        # one KKT solve per Newton iteration (chord steps included)
        if launches != sum(run["stage_trips"]) or any(
                key[:3] != ("smem", K, w) for key in by):
            raise AssertionError(
                f"{name}: {launches} launches for stage trips "
                f"{run['stage_trips']}, by shape {by}: every KKT solve "
                f"should be the shared-memory kernel at K={K}, w={w}")
        if max(key[3] for key in by) != B:
            raise AssertionError(f"{name}: no launch at the full batch {B}")
        assert_checked(name, by)
        run.pop("result")
        out[name] = dict(run, batch=B, launches=launches, launches_by={
            str(key[3]): n for key, n in sorted(
                by.items(), key=lambda kv: -kv[0][3])})
    for name in ("pm20", "pm3d"):
        def solve(kkt, name=name):
            _, nlp, bdata, cfg, stages, _, _ = bench_scaling.prepare(
                name, batch=AB_B, kkt_solver=kkt)
            return bench_scaling.al_sqp.solve_batched_staged(
                nlp, cfg, bdata, None, stages, return_stage_trips=True)

        ab_runs(torch, bt_cuda, name, solve)
    warm_ab(torch, bench_scaling, bt_cuda, "fw100")
    return out


def warm_ab(torch, bench_scaling, bt_cuda, name):
    """The A/B of a model whose cold solve is long (fw100: 156 KKT solves
    at K=101, a quarter of a second each by cyclic reduction): one cold
    staged solve at B=64 under the kernel, then the same batch with its
    starts moved by WARM_DRIFT re-solved from that result, under "kernel"
    and under "cr", within WARM_BUDGET iterations."""
    al_sqp = bench_scaling.al_sqp
    _, nlp, bdata, cfg, stages, _, _ = bench_scaling.prepare(
        name, batch=AB_B)
    bt_cuda.LAUNCHES_BY.clear()
    t0 = time.perf_counter()
    cold, trips = al_sqp.solve_batched_staged(
        nlp, cfg, bdata, None, stages, return_stage_trips=True)
    n_cold = int((cold.status == 1).sum())
    say("a/b", f"{name} kernel, cold: stage trips {list(trips)}, {n_cold} "
               f"of {AB_B} solved in {time.perf_counter() - t0:.1f} s")
    assert_checked(f"{name} a/b (cold)", bt_cuda.LAUNCHES_BY)
    if n_cold < AB_B - 2:
        raise AssertionError(f"{name}: the cold solve left lanes unsolved")
    drift = torch.zeros_like(bdata.x0[0])
    drift[:2] = WARM_DRIFT
    moved = dataclasses.replace(bdata, x0=bdata.x0 + drift)

    def solve(kkt):
        res = al_sqp.solve_batched(
            nlp, dataclasses.replace(cfg, kkt_solver=kkt,
                                     max_total=WARM_BUDGET),
            moved, cold.z, (cold.lam_def, cold.lam_eq, cold.mu), cold.rho)
        return res, (int(res.inner_iters.max()),)

    ab_runs(torch, bt_cuda, f"{name} warm", solve, other="cr")


def check_facade(torch, bt_cuda, cyclic_reduction):
    """Phase 10: the library's own entry point on the default device (no
    ``device`` argument anywhere); returns its findings. Every step
    raises on a miss."""
    import tempfile

    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.core import trajectory
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.solve import al_sqp

    SOLVED = int(Status.SOLVED)
    out = {}

    def counts(path):
        """The counts since the last reset, every launch at a checked
        shape."""
        by = dict(bt_cuda.LAUNCHES_BY)
        assert_checked(f"facade {path}", by)
        return bt_cuda.LAUNCHES, by, cyclic_reduction.SOLVES

    def by_batch(by):
        return {f"K{k[1]}_w{k[2]}_B{k[3]}": n for k, n in sorted(
            by.items(), key=lambda kv: -kv[0][3])}

    # -- the README's Quick start
    reset_counts(bt_cuda, cyclic_reduction)
    topt = TrajectoryOptimizer()
    topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    res = topt.solve()
    text = topt.debug()
    score = topt.get_score()
    times, X = topt.get_xtraj()
    with tempfile.TemporaryDirectory() as tmp:
        path = topt.save((times, X), os.path.join(tmp, "state.csv"))
        t_back, X_back = trajectory.load_csv(path)
    launches, by, cr_solves = counts("solve")
    iters = int(res.inner_iters)
    say("facade", f"Quick start on ocp_2d_ex1.xml: {topt.get_status().name}"
                  f", score {score:.6f}, {iters} iterations in "
                  f"{topt.last_solve_seconds:.2f} s (first-use costs "
                  f"included), xN {X[-1].tolist()}; {launches} kernel "
                  f"launches {sorted(by.items())}, {cr_solves} cyclic-"
                  f"reduction solves")
    if X.device.type != "cuda":
        raise AssertionError("the facade's default device is not the card")
    if topt.get_status() != Status.SOLVED or not 1.2 < score < 1.8:
        raise AssertionError(f"Quick start: {topt.get_status()}, {score}")
    if "status=SOLVED" not in text or "nodes=33" not in text:
        raise AssertionError(f"debug() says: {text}")
    if float((X[-1].cpu() - torch.tensor([5.0, 4.0])).abs().max()) > 0.011:
        raise AssertionError(f"xN {X[-1].tolist()} is not the goal")
    if tuple(X_back.shape) != (33, 2) or float(
            (X_back - X.cpu().double()).abs().max()) > 1e-6 or float(
            (t_back - times.cpu().double()).abs().max()) > 1e-6:
        raise AssertionError("the saved CSV does not read back")
    if by != {("smem", 33, 4, 1): iters} or cr_solves:
        raise AssertionError(
            f"facade.solve(): {iters} iterations should be {iters} launches"
            f" of the shared-memory kernel at (33, 4, 1), and no cyclic "
            f"reduction")
    out["solve"] = dict(score=score, iters=iters, launches=launches,
                        seconds=topt.last_solve_seconds)

    # -- MPC steps along the solved trajectory, under both routes, each
    # from the state the Quick start left
    snap = (topt.data, topt.result, list(topt.vgp.x0))
    cfg0 = topt.config
    out["mpc"] = {}
    for route in ("kernel", "cr"):
        topt.config = dataclasses.replace(cfg0, kkt_solver=route)
        topt.data, topt.result = snap[0], snap[1]
        topt.vgp.x0 = list(snap[2])
        reset_counts(bt_cuda, cyclic_reduction)
        lat, statuses, its = [], [], []
        steps = MPC_STEPS if route == "kernel" else MPC_CR_STEPS
        for _ in range(steps):
            _, Xk = topt.get_xtraj()
            r = topt.mpc_step(Xk[1])
            lat.append(topt.last_solve_seconds * 1e3)
            statuses.append(int(r.status))
            its.append(int(r.inner_iters))
        launches, by, cr_solves = counts(f"mpc_step ({route})")
        p50 = sorted(lat)[len(lat) // 2]
        mean = sum(lat) / len(lat)
        say("facade", f"{steps} mpc_steps, kkt_solver={route}: statuses "
                      f"{statuses}, iterations {its}; p50 {p50:.2f} ms, "
                      f"mean {mean:.2f} ms (last_solve_seconds, a sync "
                      f"each); {launches} kernel launches "
                      f"{sorted(by.items())}, {cr_solves} cyclic-reduction "
                      f"solves")
        if statuses != [SOLVED] * steps:
            raise AssertionError(f"mpc_step under {route}: {statuses}")
        want = ((sum(its), 0) if route == "kernel" else (0, sum(its)))
        if (launches, cr_solves) != want or (
                by and set(by) != {("smem", 33, 4, 1)}):
            raise AssertionError(
                f"mpc_step under {route}: {launches} launches {by}, "
                f"{cr_solves} cyclic-reduction solves for {sum(its)} "
                f"iterations")
        out["mpc"][route] = dict(p50_ms=p50, mean_ms=mean, launches=launches,
                                 cr_solves=cr_solves, iters=sum(its))
    topt.config = cfg0
    topt.data, topt.result = snap[0], snap[1]
    topt.vgp.x0 = list(snap[2])

    # -- multistart on both shipped problems
    fixtures = []
    for name in ("ocp_2d_ex1.csv", "ocp_2d_ex1_alt.csv"):
        path = os.path.join(HERE, "tests", "golden", name)
        with open(path) as fh:
            obj_g = float(fh.readline().split("obj=")[1].split(",")[0])
        rows = np.loadtxt(path, delimiter=",", skiprows=2)
        fixtures.append((name, rows[:, 1:3], obj_g))
    reset_counts(bt_cuda, cyclic_reduction)
    vgp, nlp = problems.canonical_ocp_2d()
    data, _ = vgp.to_device()
    t0 = time.perf_counter()
    res = al_sqp.solve_multistart(nlp, al_sqp.SolverConfig(), data, 8)
    Xm = nlp.unpack(res.z)[0].cpu().numpy()
    ocp_s = time.perf_counter() - t0
    launches, by, _ = counts("multistart ocp")
    errs = {n: float(np.max(np.abs(Xm - Xg))) for n, Xg, _ in fixtures}
    name, _, obj_g = min(fixtures, key=lambda f: errs[f[0]])
    say("facade", f"solve_multistart(canonical_ocp_2d, 8): status "
                  f"{int(res.status)}, objective {float(res.obj):.6f} "
                  f"(golden {name}: {obj_g:.6f}), max state error "
                  f"{errs[name]:.3e} (limit 1e-3; both basins {errs}), "
                  f"{ocp_s:.2f} s, launches {by_batch(by)}")
    if int(res.status) != SOLVED or not errs[name] <= 1e-3 or abs(
            float(res.obj) - obj_g) > 2e-3:
        raise AssertionError("the OCP multistart misses its golden")
    if set(by) != {("smem", 33, 4, 8)}:
        raise AssertionError(f"OCP multistart launches: {by}")
    out["multistart_ocp"] = dict(obj=float(res.obj), state_err=errs[name],
                                 golden=name, launches=launches,
                                 seconds=ocp_s)

    reset_counts(bt_cuda, cyclic_reduction)
    vgp, nlp = problems.canonical_mip_2d()
    data, _ = vgp.to_device()
    t0 = time.perf_counter()
    res = al_sqp.solve_multistart(
        nlp, al_sqp.SolverConfig(), data, 8,
        torch.Generator().manual_seed(cli.MIP_SEED))
    mip_obj = float(res.obj)
    mip_s = time.perf_counter() - t0
    launches, by, _ = counts("multistart mip")
    say("facade", f"solve_multistart(canonical_mip_2d, 8, seed "
                  f"{cli.MIP_SEED}): status {int(res.status)}, score "
                  f"{mip_obj:.6f}, violations {float(res.viol_eq):.2e} / "
                  f"{float(res.viol_in):.2e}, {mip_s:.2f} s, launches "
                  f"{by_batch(by)}")
    if int(res.status) != SOLVED or set(by) != {("smem", 17, 6, 8)}:
        raise AssertionError("the MIP multistart did not solve on the "
                             f"kernel at (17, 6, 8): {by}")
    out["multistart_mip"] = dict(obj=mip_obj, launches=launches,
                                 seconds=mip_s)

    # -- the fleet: x0 = (1, 2) plus offsets in [-0.1, 0] x [-0.1, 0.1] (a
    # +x offset starts inside the moving obstacle mexz0), cold with a
    # rescue of RESCUE_LANES lanes, then warm at x0 + 0.01
    rng = np.random.default_rng(0)
    x0 = (np.array([1.0, 2.0]) + rng.uniform(
        [-0.1, -0.1], [0.0, 0.1], size=(FACADE_B, 2))).astype(np.float32)

    def fleet(label, res):
        status = res.status.cpu().numpy()
        frac = float((status == SOLVED).mean())
        launches, by, _ = counts(label)
        found = dict(
            solved_fraction=frac,
            mean_iters=float(res.inner_iters.float().mean()),
            max_iters=int(res.inner_iters.max()),
            seconds=topt.last_solve_seconds, launches=launches,
            launches_by=by_batch(by))
        say("facade", f"solve_batch B={len(status)} {label}: {found}")
        if any(key[:3] != ("smem", 33, 4) for key in by):
            raise AssertionError(f"fleet launches: {by}")
        return found, {int(v): int(n) for v, n in zip(
            *np.unique(status, return_counts=True))}

    reset_counts(bt_cuda, cyclic_reduction)
    cold, cold_status = fleet(
        f"cold with rescue ({RESCUE_LANES} lanes)",
        topt.solve_batch(x0=x0, rescue_lanes=RESCUE_LANES))
    reset_counts(bt_cuda, cyclic_reduction)
    warm, warm_status = fleet("warm", topt.solve_batch(x0=x0 + 0.01,
                                                       warm=True))
    if not (cold["solved_fraction"] >= 0.99
            and warm["solved_fraction"] >= 0.99):
        raise AssertionError(
            f"the fleet solved {cold['solved_fraction']} cold and "
            f"{warm['solved_fraction']} warm; lanes by status: cold "
            f"{cold_status}, warm {warm_status}")
    if not warm["mean_iters"] < max(0.8 * cold["mean_iters"], 30.0):
        raise AssertionError("the warm fleet re-solve shows no warm start")
    out["fleet"] = dict(batch=FACADE_B, cold=cold, warm=warm)

    # -- the rescue, forced: a budget of 40 iterations leaves the whole
    # small fleet unsolved; the rescue re-solves FORCED_LANES of them cold
    # from 4 starts each under the default config
    tight = TrajectoryOptimizer(al_sqp.SolverConfig(max_total=40))
    tight.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    tight.set_dynamics(dynamics.single_integrator)
    tight.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    tight.setup()
    reset_counts(bt_cuda, cyclic_reduction)
    before = tight.solve_batch(x0=x0[:FORCED_B], rescue=False)
    n_before = int((before.status == SOLVED).sum())
    after = tight.solve_batch(x0=x0[:FORCED_B], rescue=True,
                              rescue_lanes=FORCED_LANES,
                              rescue_cfg=al_sqp.SolverConfig())
    n_after = int((after.status == SOLVED).sum())
    launches, by, _ = counts("forced rescue")
    say("facade", f"forced rescue, B={FORCED_B}, max_total=40: {n_before} "
                  f"lanes solved without the rescue, {n_after} with "
                  f"{FORCED_LANES} lanes rescued; launches {by_batch(by)}")
    if n_after - n_before < FORCED_LANES - 2 or not by.get(
            ("smem", 33, 4, FORCED_LANES * 4)):
        raise AssertionError("the rescue phase rescued too few lanes")
    out["forced_rescue"] = dict(solved_before=n_before, solved_after=n_after,
                                launches=by_batch(by))

    # -- the CLI, in-process, in a directory of its own for its CSV files
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for argv in (["solve_ocp"], ["mpc_demo", "5"]):
                reset_counts(bt_cuda, cyclic_reduction)
                rc = cli.main(argv)
                launches, by, cr_solves = counts("cli " + argv[0])
                say("facade", f"cli {' '.join(argv)}: exit code {rc}, "
                              f"{launches} kernel launches, {cr_solves} "
                              f"cyclic-reduction solves")
                if rc != 0 or launches <= 0 or cr_solves:
                    raise AssertionError(f"cli {argv} failed")
        finally:
            os.chdir(here)
    return out


def check_exact(torch, bt_cuda, cyclic_reduction):
    """Phase 11: the exact MILP path on the default device; returns its
    findings. Every step raises on a miss."""
    import tempfile

    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer
    from etol_tpu_torch.core import trajectory
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import problems
    from etol_tpu_torch.solve import al_sqp, side_branch

    SOLVED = int(Status.SOLVED)
    out = {}

    def counts(path):
        by = dict(bt_cuda.LAUNCHES_BY)
        assert_checked(f"exact {path}", by)
        return bt_cuda.LAUNCHES, by, cyclic_reduction.SOLVES

    def found(mres, seconds, launches, by, cr_solves):
        return dict(obj=mres.obj, status=mres.status,
                    certified=mres.certified, nodes=mres.nodes_solved,
                    waves=mres.waves, trips=mres.trips, launches=launches,
                    launches_by={"K%d_w%d_B%d" % key[1:]: n
                                 for key, n in sorted(by.items())},
                    cr_solves=cr_solves, seconds=seconds)

    # -- mip_2d_ex1.xml, convex, under both KKT routes
    vgp, nlp = problems.canonical_mip_2d()
    data, _ = vgp.to_device()
    for route in ("kernel", "cr"):
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        mres = side_branch.solve_exact(
            nlp, al_sqp.SolverConfig(kkt_solver=route), data,
            wave=EXACT_WAVE, convex_relaxation=True)
        seconds = time.perf_counter() - t0
        launches, by, cr_solves = counts(f"mip ({route})")
        f = found(mres, seconds, launches, by, cr_solves)
        say("exact", f"solve_exact(canonical_mip_2d, convex), kkt_solver="
                     f"{route}: {Status(mres.status).name}, certified "
                     f"{mres.certified}, objective {mres.obj:.6f} (golden "
                     f"{MIP_GOLDEN}, limit {MIP_TOL}), {mres.nodes_solved}"
                     f" nodes in {mres.waves} waves, {mres.trips} trips, "
                     f"{seconds:.2f} s; {launches} kernel launches "
                     f"{f['launches_by']}, {cr_solves} cyclic-reduction "
                     f"solves")
        if mres.status != SOLVED or not mres.certified or not abs(
                mres.obj - MIP_GOLDEN) <= MIP_TOL:
            raise AssertionError(f"exact mip under {route}: {f}")
        want = ((mres.trips, 0) if route == "kernel" else (0, mres.trips))
        if (launches, cr_solves) != want or (
                by and set(by) != {("smem",) + EXACT_SHAPES[0]}):
            raise AssertionError(
                f"exact mip under {route}: {launches} launches {by} and "
                f"{cr_solves} cyclic-reduction solves for {mres.trips} trips")
        out[f"mip_{route}"] = f
    gap = abs(out["mip_kernel"]["obj"] - out["mip_cr"]["obj"])
    say("exact", f"the two routes' objectives differ by {gap:.3e} (limit "
                 f"{MIP_ROUTE_TOL})")
    if not gap <= MIP_ROUTE_TOL:
        raise AssertionError("the exact MIP differs between KKT routes")

    # -- the composed demo through the facade
    vgp, nlp = problems.composed_exact_demo()
    topt = TrajectoryOptimizer()
    topt.vgp, topt.nlp = vgp, nlp
    topt.data, topt.dims = vgp.to_device()
    reset_counts(bt_cuda, cyclic_reduction)
    mres = topt.solve_exact(wave=COMPOSED_WAVE, max_nodes=EXACT_MAX_NODES,
                            convex_relaxation=True)
    launches, by, cr_solves = counts("composed")
    f = found(mres, topt.last_solve_seconds, launches, by, cr_solves)
    times, X = topt.get_xtraj()
    Z = topt.result.z.reshape(topt.dims.nodes, -1).cpu().numpy()
    boost = Z[1:, 4]
    with tempfile.TemporaryDirectory() as tmp:
        path = topt.save((times, X), os.path.join(tmp, "state.csv"))
        _, X_back = trajectory.load_csv(path)
    say("exact", f"facade solve_exact(composed_exact_demo, wave "
                 f"{COMPOSED_WAVE}, max_nodes {EXACT_MAX_NODES}, convex): "
                 f"{topt.get_status().name}, certified {mres.certified}, "
                 f"score {topt.get_score():.6f} (limit {COMPOSED_OPT} +- "
                 f"{COMPOSED_TOL}), boost schedule "
                 f"{np.round(boost, 4).tolist()}, xN {X[-1].tolist()}; "
                 f"{mres.nodes_solved} nodes in {mres.waves} waves, "
                 f"{mres.trips} trips, {topt.last_solve_seconds:.2f} s; "
                 f"{launches} kernel launches {f['launches_by']}")
    if topt.get_status() != Status.SOLVED or not mres.certified or not abs(
            topt.get_score() - COMPOSED_OPT) <= COMPOSED_TOL:
        raise AssertionError(f"exact composed: {f}")
    if not (np.abs(boost - np.round(boost)).max() < 2e-3
            and np.round(boost).max() == 1):
        raise AssertionError(f"the boost schedule {boost} is not an "
                             "integral one that switches on")
    if X.device.type != "cuda" or tuple(X_back.shape) != (7, 2) or float(
            (X_back - X.cpu().double()).abs().max()) > 1e-6:
        raise AssertionError("the composed demo's trajectory does not "
                             "save and read back from the card")
    if launches != mres.trips or set(by) != {("smem",) + EXACT_SHAPES[1]}:
        raise AssertionError(f"exact composed: {launches} launches {by} "
                             f"for {mres.trips} trips")
    out["composed"] = f
    return out


def check_planners(torch, bt_cuda, cyclic_reduction):
    """Phase 12: the sampling planners on the default device; returns its
    findings. Every step raises on a miss."""
    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.models.tuned import tuned_extras
    from etol_tpu_torch.solve import al_sqp, planners

    sync = torch.cuda.synchronize
    SOLVED = int(Status.SOLVED)
    names = planners.PLANNERS + planners.EXTRA_PLANNERS
    out = {"uas_2d": {}, "seeded": {}, "facade": {}}

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    def on_card(label, *ts):
        for t in ts:
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: an output is not finite on "
                                     "the card")

    def trips_of(name, S):
        if name == "CEM":
            return 8  # rounds
        if name == "SHOOTING":
            return 1
        return planners.tree_shape(S)[2]

    vgp, nlp = problems.uas_2d(nsteps=MAIN_NSTEPS)
    nlp = dataclasses.replace(
        nlp, obstacle_form=tuned_extras("uas_2d")["obstacle_form"])
    data, dims = vgp.to_device()
    S = planners.budget_samples(dims.nsteps * vgp.dt)
    d0 = float(torch.linalg.norm(data.x0 - data.xf))
    plans = {}
    for name in names:
        sync()
        t0 = time.perf_counter()
        X, U, info = planners.plan(name, nlp.dynamics, dims.nsteps, data, S,
                                   gen())
        sync()
        secs = time.perf_counter() - t0
        on_card(f"plan {name}", X, U)
        plans[name] = (X, U)
        dN = float(torch.linalg.norm(X[-1] - data.xf))
        trips = trips_of(name, S)
        if name in planners.PLANNERS:
            best = float(info["scores"][info["best"]])
            prio = info["cell_priority"]
            found = dict(n_nodes=int(info["n_nodes"]),
                         n_pruned=int(info["n_pruned"]),
                         best_depth=int(info["best_depth"]),
                         # a cell picked 128 times overflows float32 to
                         # inf (in the JAX package too) and then reads as
                         # empty
                         max_finite_priority=float(prio[torch.isfinite(
                             prio)].max()),
                         inf_priority_cells=int(torch.isinf(prio).sum()))
        elif name == "CEM":
            best, found = float(info["best_score"]), {}
        else:
            best = float(info["scores"].min())
            found = dict(valid_fraction=float(info["valid_fraction"]))
        found = dict(samples=S, trips=trips, seconds=secs,
                     s_per_trip=secs / trips, best_score=best,
                     valid=best < 1e6, goal_dist=dN, start_dist=d0, **found)
        say("planners", f"uas_2d N={dims.nsteps} {name}: {found}")
        if name == "SST":
            # SST's witness cells (grid 16 over the 40 x 40 box: 2.5 wide)
            # are wider than one extension (at most 1.6), so on uas_2d a
            # child never leaves its parent's cell cheaper than the cell's
            # champion: the tree stops at the root and the champions of
            # the two cells beside it, in the JAX package as here
            # (tests/test_torch_planners.py::
            # test_sst_stops_on_uas_as_the_reference). Its check is SST's
            # own invariant: the root and one live champion a witness cell.
            cells = int(torch.isfinite(info["witness_cost"]).sum())
            if found["n_nodes"] != 1 + cells or found["n_pruned"] <= 0:
                raise AssertionError(f"SST's tree is not the root and one "
                                     f"champion a cell: {found}, {cells}")
        elif not dN < 0.5 * d0:
            raise AssertionError(f"{name} ends {dN} from the goal, the "
                                 f"start is {d0}")
        out["uas_2d"][name] = found

    # planner-seeded solves: the KKT kernel at a batch of one
    for name in SEEDED:
        z0 = planners.plan_guess(nlp, data, S, gen(), planner=name)
        if not torch.equal(z0, torch.cat(plans[name], dim=-1).reshape(-1)):
            raise AssertionError(f"{name}: plan_guess is not the plan of "
                                 "the same seed")
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        res = al_sqp.solve(nlp, al_sqp.SolverConfig(kkt_solver="kernel"),
                           data, z0)
        sync()
        secs = time.perf_counter() - t0
        by = dict(bt_cuda.LAUNCHES_BY)
        iters = int(res.inner_iters)
        found = dict(status=int(res.status), obj=float(res.obj),
                     iters=iters, seconds=secs, launches=bt_cuda.LAUNCHES,
                     cr_solves=cyclic_reduction.SOLVES,
                     launches_by={"K%d_w%d_B%d" % k[1:]: n
                                  for k, n in sorted(by.items())})
        say("planners", f"{name}-seeded al_sqp.solve, kkt_solver=kernel: "
                        f"{found}")
        on_card(f"{name}-seeded solve", res.z)
        if found["status"] != SOLVED:
            raise AssertionError(f"the {name}-seeded solve: {found}")
        if by != {("smem",) + B1_SHAPE: iters} or found["cr_solves"]:
            raise AssertionError(
                f"the {name}-seeded solve: {iters} iterations should be "
                f"{iters} launches at {B1_SHAPE}, no cyclic reduction")
        assert_checked(f"planners {name}-seeded", by)
        out["seeded"][name] = found

    # the facade, eOMPL's backend role, at the problem-derived budget
    topt = TrajectoryOptimizer()
    topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    d0 = float(torch.linalg.norm(topt.data.x0 - topt.data.xf))
    for name in names:
        topt.set_planner(name)
        res = topt.plan(solve_time=FACADE_PLAN_SECONDS, generator=gen())
        _, X = topt.get_xtraj()
        on_card(f"facade plan {name}", res.z)
        dN = float(torch.linalg.norm(X[-1] - topt.data.xf))
        found = dict(
            samples=planners.budget_samples(FACADE_PLAN_SECONDS),
            status=Status(int(res.status)).name,
            seconds=topt.last_solve_seconds, goal_dist=dN, start_dist=d0,
            viol_in=float(res.viol_in))
        say("planners", f"facade set_planner({name!r}) + plan() on "
                        f"ocp_2d_ex1.xml: {found}")
        if not dN < 0.5 * d0:
            raise AssertionError(f"facade {name} ends {dN} from the goal")
        out["facade"][name] = found
    return out


def check_fleet(torch, bt_cuda, cyclic_reduction):
    """Phase 13: the multi-vehicle model on the default device; returns its
    findings. Every step raises on a miss."""
    import numpy as np

    from etol_tpu_torch.core.problem import batch_tile
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models.fleet import fleet_2d, min_pairwise_distance
    from etol_tpu_torch.solve import al_sqp

    SOLVED = int(Status.SOLVED)
    batch = FLEET_B
    out = {}

    def run(label, nlp, data, route, batched=False, warm=None):
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        solve = al_sqp.solve_batched if batched else al_sqp.solve
        args = () if warm is None else (
            warm.z, (warm.lam_def, warm.lam_eq, warm.mu), warm.rho)
        res = solve(nlp, al_sqp.SolverConfig(kkt_solver=route), data, *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by = dict(bt_cuda.LAUNCHES_BY)
        assert_checked(f"fleet {label}", by)
        if res.z.device.type != "cuda" or not bool(
                torch.isfinite(res.z).all()):
            raise AssertionError(f"fleet {label}: z is not finite on the "
                                 "card")
        return res, dict(seconds=secs, launches=bt_cuda.LAUNCHES,
                         cr_solves=cyclic_reduction.SOLVES,
                         launches_by={"K%d_w%d_B%d" % k[1:]: n
                                      for k, n in sorted(by.items())})

    # three vehicles: w = 12, cyclic reduction under both route names. The
    # "cr" side is a warm re-solve of the same problem from the "kernel"
    # side's result: cold, it would repeat the same solve (114 trips of
    # ~300 ms)
    vgp, nlp = fleet_2d(n_vehicles=3)
    data, dims = vgp.to_device()
    cold = None
    for route in ("kernel", "cr"):
        res, found = run(f"V=3 {route}", nlp, data, route, warm=cold)
        X, _ = nlp.unpack(res.z)
        found.update(status=int(res.status), obj=float(res.obj),
                     iters=int(res.inner_iters),
                     viol=[float(res.viol_eq), float(res.viol_in)],
                     goal_err=float((X[-1] - data.xf).abs().max()),
                     dmin=float(min_pairwise_distance(X, 3)))
        say("fleet", f"fleet_2d V=3 (K={dims.nodes}, w={dims.node_width}), "
                     f"kkt_solver={route}{'' if cold is None else ', warm'}"
                     f": {found}")
        if found["status"] != SOLVED or found["goal_err"] > FLEET_GOAL_TOL \
                or found["dmin"] < FLEET_DMIN:
            raise AssertionError(f"fleet V=3 under {route}: {found}")
        if found["launches"] or found["cr_solves"] != found["iters"] or \
                found["iters"] <= 0:
            raise AssertionError(
                f"fleet V=3 under {route}: w=12 should take cyclic "
                f"reduction for every iteration and launch nothing")
        out[f"v3_{route}"] = found
        cold = res
    # the warm re-solve stays in the cold solve's valley: its objective
    # trades against the violation there within tol_cons (0.44% in 3
    # iterations on an H100, 3.8e-4 in 6 on a CPU; the JAX package's two
    # routes end 0.27% apart from cold), so it is held to 1%, and to fewer
    # iterations than the cold solve
    if abs(out["v3_cr"]["obj"] / out["v3_kernel"]["obj"] - 1) > 1e-2 or \
            out["v3_cr"]["iters"] >= out["v3_kernel"]["iters"]:
        raise AssertionError("fleet V=3: the warm re-solve left the cold "
                             "solve's answer")

    # two vehicles: w = 8 on the kernel; starts moved by the parity
    # test's draw (the default head-on pair never separates, MAX_ITER in
    # both packages)
    rng = np.random.default_rng(FLEET_SEED)
    vgp, nlp = fleet_2d(n_vehicles=2)
    circle = np.asarray(vgp.x0).reshape(2, 2)
    goals = np.asarray(vgp.xf).reshape(2, 2)
    vgp, nlp = fleet_2d(n_vehicles=2, starts=circle + rng.uniform(
        -FLEET_SPREAD, FLEET_SPREAD, size=(2, 2)), goals=goals)
    data, dims = vgp.to_device()
    res, found = run("V=2", nlp, data, "kernel")
    X, _ = nlp.unpack(res.z)
    found.update(status=int(res.status), obj=float(res.obj),
                 iters=int(res.inner_iters),
                 viol=[float(res.viol_eq), float(res.viol_in)],
                 dmin=float(min_pairwise_distance(X, 2)))
    say("fleet", f"fleet_2d V=2 (K={dims.nodes}, w={dims.node_width}) "
                 f"single, kkt_solver=kernel: {found} (the JAX package on a "
                 f"CPU: {FLEET2_OBJ}, limit {FLEET2_RTOL} relative)")
    if found["status"] != SOLVED or abs(found["obj"] / FLEET2_OBJ - 1) > \
            FLEET2_RTOL or found["dmin"] < FLEET_DMIN:
        raise AssertionError(f"fleet V=2: {found}")
    if found["launches_by"] != {"K25_w8_B1": found["iters"]}:
        raise AssertionError(f"fleet V=2: launches {found['launches_by']}"
                             f" for {found['iters']} iterations")
    out["v2"] = found

    # a batch of two-vehicle fleets: the default pair's starts moved by a
    # fixed draw within +-FLEET_SPREAD
    x0 = (np.asarray(fleet_2d(n_vehicles=2)[0].x0)[None, :] + rng.uniform(
        -FLEET_SPREAD, FLEET_SPREAD, size=(batch, 4))).astype(np.float32)
    vgp, nlp = fleet_2d(n_vehicles=2)
    single, _ = vgp.to_device()
    bdata = dataclasses.replace(batch_tile(single, batch),
                                x0=torch.tensor(x0, device=single.x0.device))
    res, found = run(f"batch of {batch}", nlp, bdata, "kernel", batched=True)
    ok = res.status == SOLVED
    trips = int(res.inner_iters.max())
    Xb = res.z.reshape(batch, dims.nodes, -1)[:, :, :4]
    dmins = torch.stack([min_pairwise_distance(Xb[i], 2)
                         for i in range(batch)])
    found.update(batch=batch, solved_fraction=float(ok.float().mean()),
                 trips=trips, mean_iters=float(res.inner_iters.float().mean()),
                 min_dmin_solved=float(dmins[ok].min()) if bool(ok.any())
                 else None)
    say("fleet", f"{batch} two-vehicle fleets, solve_batched, kkt_solver="
                 f"kernel: {found}")
    if not found["solved_fraction"] >= 0.9 or not (
            found["min_dmin_solved"] >= FLEET_DMIN):
        raise AssertionError(f"the batch of fleets: {found}")
    if found["launches_by"] != {f"K25_w8_B{batch}": trips}:
        raise AssertionError(f"the batch of fleets: launches "
                             f"{found['launches_by']} for {trips} trips")
    out["batch"] = found
    return out


def check_parallel(torch, bt_cuda, btridiag, cyclic_reduction):
    """Phase 14: the parallel layer on the card; returns its findings.
    Every step raises on a miss."""
    import contextlib
    import io
    import socket

    from etol_tpu_torch import cli
    from etol_tpu_torch.parallel import distributed, kkt, make_mesh
    from etol_tpu_torch.parallel.dryrun import dryrun_multichip
    from etol_tpu_torch.solve import al_sqp

    sync = torch.cuda.synchronize
    out = {}

    def counts(path):
        by = dict(bt_cuda.LAUNCHES_BY)
        assert_checked(f"parallel {path}", by)
        return bt_cuda.LAUNCHES, {"K%d_w%d_B%d" % k[1:]: n
                                  for k, n in sorted(by.items())}, by

    # -- SPIKE against the direct launch and the plain version, B=1
    systems = {K: spd_problem(torch, 1, K, SPIKE_W, seed=K) for K in SPIKE_K}
    meshes = {n: make_mesh(["cuda"] * n, axis_names=("horizon",))
              for n in SPIKE_N}
    solvers = {(n, route): kkt.make_solver(meshes[n], "horizon", route)
               for n in SPIKE_N for route in kkt.ROUTES}
    reset_counts(bt_cuda, cyclic_reduction)
    xs = {(K, n): solvers[n, "kernel"](*systems[K])
          for K in SPIKE_K for n in SPIKE_N}
    sync()
    launches, by_name, by = counts("spike")
    want = {}
    for K in SPIKE_K:
        for n in SPIKE_N:
            for shape in spike_shapes(K, SPIKE_W, n):
                want[("smem",) + shape] = want.get(("smem",) + shape, 0) + 1
    if by != want:
        raise AssertionError(f"SPIKE launches {by}, expected {want}")
    out["spike_launches"] = launches

    def refined(f, D, O, r):
        # what the solver's override does: a solve and one refinement pass
        x = f(D, O, r)
        return x + f(D, O, r - btridiag.matvec(D, O, x))

    rows = {}
    for K in SPIKE_K:
        D, O, r = systems[K]
        direct = bt_cuda.solve(D, O, r)
        sync()
        t0 = time.perf_counter()
        plain = btridiag.solve_refined(D, O, r)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        limit = 2e-4 * (1.0 + float(plain.abs().max()))
        direct_ms = host_ms(torch, lambda: bt_cuda.solve(D, O, r),
                            reps=SPIKE_REPS)
        for n in SPIKE_N:
            x = xs[K, n]
            row = dict(
                variant_direct=bt_cuda.plan(K, SPIKE_W, 1).variant,
                err_direct=float((x - direct).abs().max()),
                err_plain=float((x - plain).abs().max()),
                resid=float((r - btridiag.matvec(D, O, x)).abs().max()),
                spike_ms=host_ms(
                    torch, lambda: solvers[n, "kernel"](D, O, r),
                    reps=SPIKE_REPS),
                spike_refined_ms=host_ms(
                    torch, lambda: refined(solvers[n, "kernel"], D, O, r),
                    reps=SPIKE_REPS),
                spike_plain_ms=host_ms(
                    torch, lambda: solvers[n, "scan"](D, O, r), reps=3),
                direct_ms=direct_ms, plain_direct_ms=plain_ms)
            say("parallel", f"SPIKE B=1 K={K} w={SPIKE_W} over n={n} "
                            f"slabs: {row} (host ms with a sync, median of "
                            f"{SPIKE_REPS}; the plain SPIKE of 3; the plain "
                            f"direct solve one call; limit {limit:.3e})")
            if not (row["err_direct"] <= limit and row["err_plain"] <= limit):
                raise AssertionError(f"SPIKE disagrees at K={K}, n={n}")
            rows[f"K{K}_n{n}"] = row
    out["spike"] = rows

    # -- the dry run, every mesh entry the card
    reset_counts(bt_cuda, cyclic_reduction)
    t0 = time.perf_counter()
    dry = dryrun_multichip(DRYRUN_N, horizon_nsteps=DRYRUN_NSTEPS)
    sync()
    dry["seconds"] = time.perf_counter() - t0
    dry["launches"], dry["launches_by"], by = counts("dryrun")
    say("parallel", f"dryrun_multichip({DRYRUN_N}): {dry}")
    need = [("smem",) + shape for shape in
            spike_shapes(DRYRUN_NSTEPS + 1, 4, DRYRUN_N)
            + ((DRYRUN_NSTEPS + 1, 4, 1), (8, 5, 8))]
    if not all(by.get(key) for key in need) or cyclic_reduction.SOLVES:
        raise AssertionError(f"the dry run's launches {by}: every KKT solve "
                             f"should be the kernel, at {need}")
    out["dryrun"] = dry

    # -- cli fleet_batch, in-process
    reset_counts(bt_cuda, cyclic_reduction)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.fleet_batch([str(FLEET_BATCH_B)])
    text = text.getvalue()
    launches, by_name, by = counts("cli fleet_batch")
    solved = float(text.split("solved: ")[1].split("%")[0]) / 100
    say("parallel", f"cli fleet_batch {FLEET_BATCH_B}: exit code {rc}; "
                    + " | ".join(text.strip().splitlines())
                    + f"; {launches} kernel launches {by_name}")
    if rc != 0 or not solved >= 0.95 or set(by) != {
            ("smem", 51, 5, FLEET_BATCH_B)}:
        raise AssertionError(f"cli fleet_batch: solved {solved}, {by}")
    out["fleet_batch"] = dict(solved_fraction=solved, launches=launches,
                              output=text.strip().splitlines())

    # -- two ranks on this card over gloo, against this process's solve
    reset_counts(bt_cuda, cyclic_reduction)
    res = al_sqp.solve_batched(*distributed.demo_problem("cuda", DIST_B))
    obj = res.obj.tolist()
    counts("distributed parent")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(DIST_RANKS):
            env = dict(os.environ, ETOL_COORDINATOR=f"127.0.0.1:{port}",
                       ETOL_NUM_PROCS=str(DIST_RANKS),
                       ETOL_PROC_ID=str(rank),
                       PYTHONPATH=HERE + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etol_tpu_torch.parallel.distributed",
                 "--device", "cuda:0", "--backend", "gloo"],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for rank, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} failed:\n{text[-3000:]}")
        found = json.loads([line for line in text.splitlines()
                            if line.startswith("{")][-1])
        say("parallel", f"rank {rank} of {DIST_RANKS} on cuda:0 over gloo: "
                        f"{found}")
        err = max(abs(a - b) for a, b in zip(found["obj"], obj))
        missed = {tuple(int(v) for v in re.findall(r"\d+", k))
                  for k in found["launches_by"]} - CHECKED
        if (found["statuses"] != [1] * (DIST_B // DIST_RANKS)
                or not err <= 1e-4 or found["warm_solved"] != 1.0
                or found["horizon"]["status"] != 1
                or found["launches"] <= 0 or missed):
            raise AssertionError(f"rank {rank}: |dobj| {err}, unchecked "
                                 f"launch shapes {missed}: {found}")
        found["max_abs_dobj"] = err
        ranks.append(found)
    out["distributed"] = dict(obj_single_process=obj, ranks=ranks)
    return out


def main(phases=PHASES):
    """Phases 1 and 2, then the named ones in order; the two result lines
    are printed only when every phase ran."""
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a card")
    if not os.path.isfile(os.path.join(HERE, "etol_tpu_torch",
                                       "__init__.py")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (etol_tpu_torch/ not found)")
    sys.path.insert(0, HERE)

    clock = Clock()
    # 1. device
    CARD = card_line()
    print(CARD, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")

    # 2. build
    from etol_tpu_torch import bench_harness, bench_scaling
    from etol_tpu_torch.ops import bt_cuda, cyclic_reduction
    from etol_tpu_torch.solve import btridiag

    t0 = time.perf_counter()
    bt_cuda.build()
    say("build", f"bt_solve.cu built and loaded in "
                 f"{time.perf_counter() - t0:.2f} s")
    entry = None
    for line in bt_cuda.BUILD_LOG.splitlines():
        m = re.search(r"bt_(solve|smem)_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            entry = f"{'global' if m.group(1) == 'solve' else 'smem'} " \
                    f"W={m.group(2)}"
        elif entry and ("registers" in line or "spill" in line):
            info = line.replace("ptxas info    :", "").strip()
            say("build", f"{entry}: {info}")
    clock.lap("build")

    # 3. both kernels vs plain, and their times
    if "kernel" in phases:
        max_abs_err, times = check_kernel(
            torch, bt_cuda, btridiag, path_shapes(bench_scaling))
        clock.lap("kernel")

    # 4. main path, on the default device
    if "main" in phases:
        bt_cuda.LAUNCHES = 0
        bt_cuda.LAUNCHES_BY.clear()
        out = bench_harness.main_path(MAIN_B, MAIN_NSTEPS)
        launches = bt_cuda.LAUNCHES
        launches_by = dict(bt_cuda.LAUNCHES_BY)
        check_main(torch, out, launches, launches_by)
        clock.lap("main")

    # 5. in-situ A/B: kernel vs the plain scan path, same batch and seeds
    if "a/b" in phases:
        def solve(kkt):
            nlp, cfg, stages, data, gen = bench_harness.prepare(
                AB_B, MAIN_NSTEPS, seed=1, kkt_solver=kkt)
            cold = bench_harness.run_cold(nlp, cfg, data, stages, gen)
            return cold["result"], cold["stage_trips"]

        ab_runs(torch, bt_cuda, f"uas_2d N={MAIN_NSTEPS}", solve)
        clock.lap("a/b")

    # 6. cyclic reduction, and the B=1 routes
    if "cr" in phases:
        b1 = check_cr(torch, bt_cuda, btridiag, cyclic_reduction)
        clock.lap("cr")

    # 7. the single-problem MPC re-solve
    if "mpc" in phases:
        mpc = check_mpc(torch, bench_harness, bt_cuda, cyclic_reduction)
        clock.lap("mpc")

    # 8. the bench entry point; its JSON line goes out on a line of its
    # own, well before the last two
    if "bench" in phases:
        bt_cuda.LAUNCHES = 0
        bt_cuda.LAUNCHES_BY.clear()
        bench_line = bench_harness.bench(
            MAIN_B, MAIN_NSTEPS, iters=1,
            mpc=mpc["kernel"] if "mpc" in phases else None)
        print(json.dumps(bench_line), flush=True)
        bench_launches = bt_cuda.LAUNCHES
        assert_checked("bench", bt_cuda.LAUNCHES_BY)
        ex = bench_line["extras"]
        say("bench", f"{bench_line['value']} solved solves/s at B={MAIN_B} "
                     f"(solved {ex['solved_fraction']:.4f}), warm "
                     f"{ex['warm_solves_per_s_per_chip']} (solved "
                     f"{ex['warm_solved_fraction']:.4f}); "
                     f"{bench_launches} kernel launches")
        if not (ex["solved_fraction"] >= 0.95
                and ex["warm_solved_fraction"] >= 0.95
                and ex["audit_node_depth_max"] <= 1e-3):
            raise AssertionError(f"the bench line is unhealthy: {ex}")
        if bench_launches <= 0:
            raise AssertionError("the bench launched no kernel")
        clock.lap("bench")

    # 9. the ladder's other models
    if "ladder" in phases:
        ladder = check_ladder(torch, bench_scaling, bt_cuda)
        clock.lap("ladder")

    # 10. the library's entry point; its JSON line goes out before the
    # last two
    if "facade" in phases:
        facade = check_facade(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "facade", "card": CARD, **facade}),
              flush=True)
        clock.lap("facade")

    # 11. the exact MILP path; its JSON line goes out before the last two
    if "exact" in phases:
        exact = check_exact(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "exact", "card": CARD, **exact}),
              flush=True)
        clock.lap("exact")

    # 12. the sampling planners; their JSON line goes out before the last two
    if "planners" in phases:
        plan_out = check_planners(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "planners", "card": CARD, **plan_out}),
              flush=True)
        clock.lap("planners")

    # 13. the multi-vehicle fleet; its JSON line goes out before the last two
    if "fleet" in phases:
        fleet_out = check_fleet(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "fleet", "card": CARD, **fleet_out}),
              flush=True)
        clock.lap("fleet")

    # 14. the parallel layer; its JSON line goes out before the last two
    if "parallel" in phases:
        par = check_parallel(torch, bt_cuda, btridiag, cyclic_reduction)
        print(json.dumps({"phase": "parallel", "card": CARD, **par}),
              flush=True)
        clock.lap("parallel")

    if tuple(phases) != PHASES:
        return
    print(CARD, flush=True)
    top = times[(51, 5, MAIN_B)]

    def shape_key(shape):
        return "K%d_w%d_B%d" % shape

    print(json.dumps({"kernels": [{
        "name": "bt_solve",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/bt_solve.cu",
        "replaces": "etol_tpu/ops/pallas_bt.py:51",
        "launches": launches,
        "launches_by_batch": {
            str(key[3]): n for key, n in sorted(
                launches_by.items(), key=lambda kv: -kv[0][3])},
        "launches_by_path": {
            "main": launches, "mpc": mpc["kernel"]["launches"],
            "mpc_cr": mpc["cr"]["launches"],
            "bench": bench_launches,
            **{name: run["launches"] for name, run in ladder.items()},
            "facade_solve": facade["solve"]["launches"],
            "facade_mpc": facade["mpc"]["kernel"]["launches"],
            "facade_mpc_cr": facade["mpc"]["cr"]["launches"],
            "facade_multistart_ocp": facade["multistart_ocp"]["launches"],
            "facade_multistart_mip": facade["multistart_mip"]["launches"],
            "facade_fleet_cold": facade["fleet"]["cold"]["launches"],
            "facade_fleet_warm": facade["fleet"]["warm"]["launches"],
            "exact_mip": exact["mip_kernel"]["launches"],
            "exact_mip_cr": exact["mip_cr"]["launches"],
            "exact_composed": exact["composed"]["launches"],
            **{f"planner_seeded_{name}": run["launches"]
               for name, run in plan_out["seeded"].items()},
            "fleet_v3": fleet_out["v3_kernel"]["launches"],
            "fleet_v3_cr": fleet_out["v3_cr"]["launches"],
            "fleet_v2": fleet_out["v2"]["launches"],
            "fleet_batch": fleet_out["batch"]["launches"],
            "parallel_spike": par["spike_launches"],
            "parallel_dryrun": par["dryrun"]["launches"],
            "cli_fleet_batch": par["fleet_batch"]["launches"],
            **{f"distributed_rank{r['rank']}": r["launches"]
               for r in par["distributed"]["ranks"]}},
        "max_abs_err": max_abs_err,
        "ms": top["smem"],
        "ms_global_scratch": top["global"],
        "plain_ms": top["plain"],
        "bound_ms": top["bound"],
        "bound_by": top["bound_by"],
        "library_ms": top["library"],
        "by_shape": {
            shape_key(shape): {
                "ms": t["smem"], "ms_global_scratch": t["global"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["bound_by"], "library_ms": t["library"]}
            for shape, t in times.items()},
        "ladder": ladder,
        "b1_routes_ms": {str(K): row for K, row in b1.items()},
        "mpc": {route: {"launches": run["launches"],
                        "cr_solves": run["cr_solves"],
                        "p50_ms": run["p50_ms"],
                        "pipelined_ms": run["pipelined_ms"],
                        "solved": run["statuses"].count(1)}
                for route, run in mpc.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def check_main(torch, out, launches, launches_by):
    """Phase 4's findings and checks."""
    cold, warm = out["cold"], out["warm"]
    res = warm["result"]
    say("main", f"uas_2d N={MAIN_NSTEPS} B={MAIN_B}: cold solved "
                f"{cold['solved_fraction']:.4f}, warm solved "
                f"{warm['solved_fraction']:.4f}")
    say("main", f"max violation cold {cold['viol_eq_max']:.3e} / "
                f"{cold['viol_in_max']:.3e}, warm {warm['viol_eq_max']:.3e}"
                f" / {warm['viol_in_max']:.3e}")
    say("main", f"stage trips {cold['stage_trips']}")
    say("main", f"audit: deepest node containment "
                f"{cold['audit_node_depth_max']:.3e}, deepest mid-segment "
                f"dip {cold['audit_midseg_depth_max']:.4f}")
    say("main", f"wall: seeds {cold['seed_s']:.2f} s, cold solve "
                f"{cold['cold_s']:.2f} s, warm re-solve {warm['warm_s']:.2f}"
                f" s")
    say("main", f"bt_solve kernel launches during the main path: {launches}"
                f"; by (variant, K, w, batch): "
                f"{sorted(launches_by.items(), key=lambda kv: -kv[0][3])}")
    n_smem = sum(n for key, n in launches_by.items()
                 if key[:3] == ("smem", 51, 5))
    if launches <= 0 or n_smem != launches:
        raise AssertionError(
            f"the main path made {launches} kernel launches, {n_smem} of "
            "them of the shared-memory kernel at K=51, w=5: all of them "
            "should be")
    assert_checked("main", launches_by)
    if out["data"].x0.device.type != "cuda":
        raise AssertionError("the main path's default device is not the "
                             "card")
    if not cold["solved_fraction"] >= 0.95:
        raise AssertionError(f"cold solved {cold['solved_fraction']} < 0.95")
    if not cold["audit_node_depth_max"] <= 1e-3:
        raise AssertionError("a solved lane has a node inside an obstacle")
    nz = out["nlp"].dims.nz
    if tuple(res.z.shape) != (MAIN_B, nz) or not bool(
            torch.isfinite(res.z).all()):
        raise AssertionError(f"warm z has shape {tuple(res.z.shape)} or "
                             "non-finite values")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        picked = sys.argv[2].split(",")
        if not set(picked) <= set(PHASES):
            raise SystemExit(f"chip_smoke: phases are {', '.join(PHASES)}")
        main(tuple(p for p in PHASES if p in picked))
    elif len(sys.argv) == 1:
        main()
    else:
        raise SystemExit("usage: chip_smoke.py [--phases a,b,...]")
