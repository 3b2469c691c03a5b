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
3. kernel  — the kernel against its plain PyTorch version on the card at
             the main path's shapes and the other ladder widths, and both
             timed with CUDA events at (K, w, B) = (51, 5, 2048);
4. main    — the port's main path: ``uas_2d`` N=50, B=2048, shooting
             seeds, the staged cold solve, the obstacle audit, and the
             warm fleet re-solve on x0 + 0.01; the kernel's launch count
             over exactly that run;
5. a/b     — B=64, N=50 cold solves with the kernel and with the plain
             "scan" KKT path, both on the card.

The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
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
TIMED_SHAPE = (51, 5, 2048)
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


def median_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_kernel(torch, bt_cuda, btridiag):
    """Phase 3: kernel vs plain on the card; returns (max_abs_err, ms,
    plain_ms)."""
    worst = 0.0
    for i, (K, w, B) in enumerate(KERNEL_SHAPES):
        D, O, r = spd_problem(torch, B, K, w, seed=K + w + i)
        xk = bt_cuda.solve(D, O, r)
        xp = btridiag.solve_refined(D, O, r)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())
        res_k = float((r - btridiag.matvec(D, O, xk)).abs().max())
        res_p = float((r - btridiag.matvec(D, O, xp)).abs().max())
        say("kernel", f"K={K} w={w} B={B}: max|x_kernel - x_plain| "
                      f"{err:.3e} (limit {2e-4 * (1 + scale):.3e}), "
                      f"|r - Hx|inf kernel {res_k:.3e} plain {res_p:.3e}")
        if not (err <= 2e-4 * (1.0 + scale)):
            raise AssertionError(f"kernel disagrees at {(K, w, B)}: {err}")
        if not (res_k <= res_p + 1e-4):
            raise AssertionError(f"kernel residual {res_k} > plain {res_p}")
        worst = max(worst, err)
    K, w, B = TIMED_SHAPE
    D, O, r = spd_problem(torch, B, K, w, seed=0)
    ms = median_ms(torch, lambda: bt_cuda.solve(D, O, r))
    plain_ms = median_ms(torch, lambda: btridiag.solve_refined(D, O, r))
    say("kernel", f"K={K} w={w} B={B}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (CUDA events, median of 20)")
    return worst, ms, plain_ms


def main():
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
    width = None
    for line in bt_cuda.BUILD_LOG.splitlines():
        m = re.search(r"bt_solve_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            width = m.group(1)
        elif width and ("registers" in line or "spill" in line):
            info = line.replace("ptxas info    :", "").strip()
            say("build", f"W={width}: {info}")

    # 3. kernel vs plain
    max_abs_err, ms, plain_ms = check_kernel(torch, bt_cuda, btridiag)

    # 4. main path
    bt_cuda.LAUNCHES = 0
    out = bench_harness.main_path(MAIN_B, MAIN_NSTEPS, device="cuda")
    launches = bt_cuda.LAUNCHES
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
    say("main", f"bt_solve kernel launches during the main path: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
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
            AB_B, MAIN_NSTEPS, "cuda", seed=1, kkt_solver=kkt)
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
    print(json.dumps({"kernels": [{
        "name": "bt_solve",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/bt_solve.cu",
        "replaces": "etol_tpu/ops/pallas_bt.py:51",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
