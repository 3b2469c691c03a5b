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
             the main path's shapes, the other ladder widths and ragged
             batches; a lane with an indefinite block must come out
             non-finite and leave the others alone; then, at K=51, w=5 and
             the main path's four batch sizes, both kernels in turns and
             the plain version timed with CUDA events over rotating
             inputs (the kernels as replays of a CUDA graph of launches), beside the bound from the shapes, and one dense
             ``torch.linalg.solve`` as the library yardstick;
4. main    — the port's main path on the default device: ``uas_2d`` N=50,
             B=2048, shooting seeds, the staged cold solve, the obstacle
             audit, and the warm fleet re-solve on x0 + 0.01; the kernel's
             launch count, by batch size, over exactly that run;
5. a/b     — B=64, N=50 cold solves with the kernel and with the plain
             "scan" KKT path, both on the card.

The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py
--kernel-only`` stops after phase 3 and prints neither.
"""
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (K, w, B): the main path's K=51, w=5 at every batch its stages give the
# kernel (2048, then B/2, B/8, B/32), a ragged batch at w=6, and the
# widest node the kernel takes at the fixed-wing horizon
KERNEL_SHAPES = ((51, 5, 2048), (51, 5, 1024), (51, 5, 256), (51, 5, 64),
                 (21, 6, 1000), (101, 9, 256))
# batches that are no multiple of the lanes a block takes
RAGGED_SHAPES = ((51, 5, 3), (41, 6, 7))
TIMED_SHAPES = ((51, 5, 2048), (51, 5, 1024), (51, 5, 256), (51, 5, 64))
TIMED_SET_BYTES = 100 * 2 ** 20
# launches recorded into the CUDA graph that times a kernel
TIMED_INNER = 10
# the two kernels of bt_solve.cu: a lane across w threads with the factor
# in shared memory, and one thread a lane with the factor in device memory
VARIANTS = ("smem", "global")
# published peaks of one H100 SXM: device memory rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
MAIN_B, MAIN_NSTEPS, AB_B = 2048, 50, 64

CARD = None


def say(phase, msg):
    print(f"[{phase}] [{CARD}] {msg}", flush=True)


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


def check_kernel(torch, bt_cuda, btridiag):
    """Phase 3: both kernels vs plain on the card, then the timings at
    the main path's shapes; returns (max_abs_err, times) with
    times[B] = dict(smem, global, plain, bound..., library)."""
    worst = 0.0
    for i, (K, w, B) in enumerate(KERNEL_SHAPES + RAGGED_SHAPES):
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
            torch, lambda i: btridiag.solve_refined(*sets[i % n]), reps=5)
        t["bound"], t["bound_by"], nbytes, flops = bound(K, w, B)
        say("kernel", f"K={K} w={w} B={B} ({n} input sets in turn): "
                      + ", ".join(f"{v} {ms:.4f} ms" for v, ms in runs)
                      + f", plain {t['plain']:.4f} ms (CUDA events: median "
                        f"of 20 replays of a graph of {TIMED_INNER} "
                        f"launches, plain of 5 single calls); bound {t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops:.0f} flop)")
        times[B] = t
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


def main(kernel_only=False):
    """All phases; ``kernel_only`` stops after phase 3 (a short check of
    a changed kernel, with no result lines)."""
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

    # 1. device
    CARD = card_line()
    print(CARD, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")

    # 2. build
    from etol_tpu_torch import bench_harness
    from etol_tpu_torch.ops import bt_cuda
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

    # 3. both kernels vs plain, and their times
    max_abs_err, times, library_ms = check_kernel(torch, bt_cuda, btridiag)
    if kernel_only:
        return

    # 4. main path, on the default device
    bt_cuda.LAUNCHES = 0
    bt_cuda.LAUNCHES_BY.clear()
    out = bench_harness.main_path(MAIN_B, MAIN_NSTEPS)
    launches = bt_cuda.LAUNCHES
    launches_by = dict(bt_cuda.LAUNCHES_BY)
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
                f"; by (variant, batch): "
                f"{sorted(launches_by.items(), key=lambda kv: -kv[0][1])}")
    n_smem = sum(n for (v, _), n in launches_by.items() if v == "smem")
    if launches <= 0 or n_smem != launches:
        raise AssertionError(
            f"the main path made {launches} kernel launches, {n_smem} of "
            "them of the shared-memory kernel: all of them should be")
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

    # 5. in-situ A/B: kernel vs the plain scan path, same batch and seeds
    ab = {}
    for kkt in ("kernel", "scan"):
        nlp, cfg, stages, data, gen = bench_harness.prepare(
            AB_B, MAIN_NSTEPS, seed=1, kkt_solver=kkt)
        ab[kkt] = bench_harness.run_cold(nlp, cfg, data, stages,
                                         gen)["result"]
    ok_k = ab["kernel"].status == 1
    ok_s = ab["scan"].status == 1
    both = ok_k & ok_s
    n_k, n_s = int(ok_k.sum()), int(ok_s.sum())
    obj_k = float(ab["kernel"].obj[both].mean())
    obj_s = float(ab["scan"].obj[both].mean())
    say("a/b", f"B={AB_B} N={MAIN_NSTEPS}: solved kernel {n_k} scan {n_s};"
               f" mean objective over {int(both.sum())} lanes solved by "
               f"both: kernel {obj_k:.6f} scan {obj_s:.6f}")
    if abs(n_k - n_s) > 2:
        raise AssertionError("kernel and scan solved counts differ by > 2")
    if not abs(obj_k - obj_s) <= 0.01 * abs(obj_s):
        raise AssertionError("kernel and scan objectives differ by > 1%")

    print(CARD, flush=True)
    top = times[MAIN_B]
    print(json.dumps({"kernels": [{
        "name": "bt_solve",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/bt_solve.cu",
        "replaces": "etol_tpu/ops/pallas_bt.py:51",
        "launches": launches,
        "launches_by_batch": {
            str(B): n for (_, B), n in sorted(launches_by.items(),
                                              key=lambda kv: -kv[0][1])},
        "max_abs_err": max_abs_err,
        "ms": top["smem"],
        "ms_global_scratch": top["global"],
        "plain_ms": top["plain"],
        "bound_ms": top["bound"],
        "bound_by": top["bound_by"],
        "library_ms": library_ms,
        "by_batch": {
            str(B): {"ms": t["smem"], "ms_global_scratch": t["global"],
                     "plain_ms": t["plain"], "bound_ms": t["bound"]}
            for B, t in times.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main(kernel_only=sys.argv[1:] == ["--kernel-only"])
