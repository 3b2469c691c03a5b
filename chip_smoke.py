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
             inputs (the kernels as replays of a CUDA graph of launches), beside the bound from the shapes, and one dense
             ``torch.linalg.solve`` as the library yardstick;
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
             (``bench_harness.run_mpc``): statuses, both latencies, and
             the kernel's launches (none: that route is cyclic reduction);
8. bench   — ``bench_harness.bench`` at B=2048 with two timed cold and
             warm batches and phase 7's MPC figures: its JSON line;
9. ladder  — ``bench_scaling.run_config`` for pm20 (K=21, w=6, B=1024),
             pm3d (K=41, w=6, B=1024) and fw100 (K=101, w=9, B=256) under
             the registry configs: solved fractions, the kernel's launches
             by shape, and a kernel-against-scan A/B at B=64 for each.

The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py
--phases kernel,cr`` runs phases 1 and 2 and the named ones only, and
prints neither line.
"""
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
TIMED_SHAPES = MAIN_SHAPES + LADDER_SHAPES
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
PHASES = ("kernel", "main", "a/b", "cr", "mpc", "bench", "ladder")

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
    full batches; returns (max_abs_err, times, library_ms) with
    times[(K, w, B)] = dict(smem, global, plain, bound, bound_by)."""
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
        t["plain"] = median_ms(
            torch, lambda i: btridiag.solve_refined(*sets[i % n]),
            reps=PLAIN_REPS)
        t["bound"], t["bound_by"], nbytes, flops = bound(K, w, B)
        say("kernel", f"K={K} w={w} B={B} ({n} input sets in turn): "
                      + ", ".join(f"{v} {ms:.4f} ms" for v, ms in runs)
                      + f", plain {t['plain']:.4f} ms (CUDA events: median "
                        f"of 20 replays of a graph of {TIMED_INNER} "
                        f"launches, plain of {PLAIN_REPS} single calls); "
                        f"bound {t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops:.0f} flop)")
        times[(K, w, B)] = t
    # the nearest single PyTorch call: a dense solve of the assembled
    # [B, K w, K w] systems, no refinement; the assembly is not timed
    K, w, B = TIMED_SHAPES[0]
    D, O, r = spd_problem(torch, B, K, w, seed=0)
    H = dense(torch, D, O)
    rhs = r.reshape(B, K * w, 1)
    library_ms = median_ms(torch, lambda i: torch.linalg.solve(H, rhs),
                           reps=5)
    xd = torch.linalg.solve(H, rhs).reshape(B, K, w)
    xk = bt_cuda.solve(D, O, r)
    say("kernel", f"K={K} w={w} B={B}: torch.linalg.solve on the dense "
                  f"[{B}, {K * w}, {K * w}] systems (dense, no refinement) "
                  f"{library_ms:.4f} ms, median of 5; max|x_dense - "
                  f"x_kernel| {float((xd - xk).abs().max()):.3e}")
    return worst, times, library_ms


def dense(torch, D, O):
    """The systems of (D, O) as dense matrices [B, K w, K w]."""
    B, K, w, _ = D.shape
    H = torch.zeros((B, K, w, K, w), device=D.device)
    k = torch.arange(K, device=D.device)
    H[:, k, :, k, :] = D.permute(1, 0, 2, 3)
    H[:, k[:-1], :, k[1:], :] = O.permute(1, 0, 2, 3)
    H[:, k[1:], :, k[:-1], :] = O.permute(1, 0, 3, 2)
    return H.reshape(B, K * w, K * w)


def host_ms(torch, fn, reps):
    """Median host-clock milliseconds of ``fn()`` followed by a device
    sync, after one warm-up call: what a caller that waits for the answer
    sees."""
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
            scan=host_ms(torch, lambda: btridiag.solve_refined(D, O, r),
                         reps=3 if K > 200 else 7),
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


def check_mpc(torch, bench_harness, bt_cuda):
    """Phase 7: the single-problem warm re-solve at N=50 on the card;
    returns ``run_mpc``'s result with the kernel's launch count over it
    (``launches``: 0, since the unbatched solve's route is cyclic
    reduction, so these latencies are that route's and not the
    kernel's)."""
    nlp, cfg, _, _, _ = bench_harness.prepare(1, MAIN_NSTEPS)
    single = bench_harness.single_problem(MAIN_NSTEPS)
    bt_cuda.LAUNCHES = 0
    out = bench_harness.run_mpc(nlp, cfg, single)
    out["launches"] = bt_cuda.LAUNCHES
    n_ok = out["statuses"].count(1)
    say("mpc", f"uas_2d N={MAIN_NSTEPS}, one problem, kkt_solver="
               f"{cfg.kkt_solver} (the unbatched solve takes cyclic "
               f"reduction: {out['launches']} kernel launches): cold "
               f"status {int(out['cold'].status)} after "
               f"{int(out['cold'].inner_iters)} iterations; re-solve "
               f"statuses {out['statuses']}")
    say("mpc", f"p50 re-solve latency {out['p50_ms']:.2f} ms with a sync "
               f"after each, {out['pipelined_ms']:.2f} ms a step with 20 "
               f"dispatched back to back and one sync")
    if not out["finite"]:
        raise AssertionError("an MPC re-solve returned non-finite z")
    if n_ok < 18:
        raise AssertionError(f"only {n_ok} of 20 MPC re-solves SOLVED")
    if out["launches"]:
        raise AssertionError("the unbatched solve launched the kernel")
    return out


def ab_runs(torch, bt_cuda, name, solve):
    """``solve(kkt)`` -> (result, stage trips) under "kernel" and under
    "scan"; every launch of the kernel side must be at a checked shape."""
    runs = {}
    for kkt in ("kernel", "scan"):
        bt_cuda.LAUNCHES_BY.clear()
        t0 = time.perf_counter()
        runs[kkt], trips = solve(kkt)
        torch.cuda.synchronize()
        say("a/b", f"{name} {kkt}: stage trips {list(trips)} in "
                   f"{time.perf_counter() - t0:.1f} s")
        assert_checked(f"{name} a/b ({kkt})", bt_cuda.LAUNCHES_BY)
    ab(torch, name, runs)


def ab(torch, name, runs):
    """Kernel against scan on the same batch: solved counts within 2,
    mean objectives over the lanes both solved within 1%."""
    ok_k = runs["kernel"].status == 1
    ok_s = runs["scan"].status == 1
    both = ok_k & ok_s
    n_k, n_s = int(ok_k.sum()), int(ok_s.sum())
    obj_k = float(runs["kernel"].obj[both].mean())
    obj_s = float(runs["scan"].obj[both].mean())
    say("a/b", f"{name} B={AB_B}: solved kernel {n_k} scan {n_s}; mean "
               f"objective over {int(both.sum())} lanes solved by both: "
               f"kernel {obj_k:.6f} scan {obj_s:.6f}")
    if abs(n_k - n_s) > 2:
        raise AssertionError(
            f"{name}: kernel and scan solved counts differ by > 2")
    if not abs(obj_k - obj_s) <= 0.01 * abs(obj_s):
        raise AssertionError(
            f"{name}: kernel and scan objectives differ by > 1%")


def check_ladder(torch, bench_scaling, bt_cuda):
    """Phase 9: the ladder's three other models on the default device
    under the registry configs, then their kernel-against-scan A/B;
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
            label, nlp, bdata, cfg, stages, reps=1, generator=gen,
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
        # one KKT solve per Newton iteration (chord steps included), so
        # the first run alone makes sum(trips) launches
        if launches < sum(run["stage_trips"]) or any(
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
    for name in LADDER:
        def solve(kkt, name=name):
            _, nlp, bdata, cfg, stages, _, _ = bench_scaling.prepare(
                name, batch=AB_B, kkt_solver=kkt)
            return bench_scaling.al_sqp.solve_batched_staged(
                nlp, cfg, bdata, None, stages, return_stage_trips=True)

        ab_runs(torch, bt_cuda, name, solve)
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
        max_abs_err, times, library_ms = check_kernel(
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
        mpc = check_mpc(torch, bench_harness, bt_cuda)
        clock.lap("mpc")

    # 8. the bench entry point; its JSON line goes out on a line of its
    # own, well before the last two
    if "bench" in phases:
        bt_cuda.LAUNCHES = 0
        bt_cuda.LAUNCHES_BY.clear()
        bench_line = bench_harness.bench(
            MAIN_B, MAIN_NSTEPS, iters=2,
            mpc=mpc if "mpc" in phases else None)
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
            "main": launches, "mpc": mpc["launches"],
            "bench": bench_launches,
            **{name: run["launches"] for name, run in ladder.items()}},
        "max_abs_err": max_abs_err,
        "ms": top["smem"],
        "ms_global_scratch": top["global"],
        "plain_ms": top["plain"],
        "bound_ms": top["bound"],
        "bound_by": top["bound_by"],
        "library_ms": library_ms,
        "by_shape": {
            shape_key(shape): {
                "ms": t["smem"], "ms_global_scratch": t["global"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["bound_by"]}
            for shape, t in times.items()},
        "ladder": ladder,
        "b1_routes_ms": {str(K): row for K, row in b1.items()},
        "mpc": {"route": "cyclic reduction", "launches": mpc["launches"],
                "p50_ms": mpc["p50_ms"],
                "pipelined_ms": mpc["pipelined_ms"],
                "solved": mpc["statuses"].count(1)},
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
