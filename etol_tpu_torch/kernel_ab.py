"""Same-call A/B of the KKT kernel against other versions of its source.

    python -m etol_tpu_torch.kernel_ab OTHER.cu [OTHER.cu ...] \\
        [--shapes K,w,B ...] [--out FILE]

Each OTHER.cu is another version of ``etol_tpu_torch/csrc/bt_solve.cu``
(an earlier commit's, unpacked with ``git archive``, or a candidate
change). All are built with the wrapper's nvcc flags, in parallel, into
``build/etol_tpu_torch/``. At each shape the kernel that this checkout's
:func:`~etol_tpu_torch.ops.bt_cuda.plan` picks is launched from every
library through the same C entry point, with the same plan, inputs and
stream, in turns (this checkout, the others, the others in reverse
order, this checkout) within one process on one card; a library that
lacks the entry point is left out of that row. A time is the card's,
as ``chip_smoke.py`` phase 3 takes it: CUDA events around the replays of
a CUDA graph of launches over rotating input sets of more than 100 MB
(20 replays of 10 launches; 5 of 2 past K=200), and each version's time
is the mean of its two turns. Every version's x is held against this
checkout's at 2e-4 (1 + max|x|). One line a shape, then a JSON line,
which ``--out`` also writes to a file. Needs a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess

import torch

from .ops import bt_cuda

#: the shapes the paths launch the shared-memory kernel at (chip_smoke.py
#: phase 3's timed rows), from the main path's (51, 5, B) down to the
#: smallest ranks' separators
DEFAULT_SHAPES = (
    (51, 5, 2048), (51, 5, 1024), (51, 5, 256), (51, 5, 64), (51, 5, 1),
    (21, 6, 1024), (41, 6, 1024), (101, 9, 256), (33, 4, 1), (33, 4, 8),
    (33, 4, 2048), (17, 6, 8), (7, 5, 16), (25, 8, 1), (63, 5, 88),
    (8, 5, 1), (255, 5, 88), (63, 4, 72), (8, 4, 1), (512, 4, 1),
    (7, 3, 7), (2, 3, 1), (7, 4, 9), (2, 4, 1), (16, 4, 1),
)
SET_BYTES = 100 * 2 ** 20
ENTRY = {"smem": "etol_bt_solve_smem_f32",
         "stream": "etol_bt_solve_stream_f32"}


def problem_sets(B, K, w, seed):
    """SPD block-tridiagonal systems made on the card, in as many sets as
    hold more than SET_BYTES together (2 to 64)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    set_bytes = 4 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)
    n = max(2, min(64, -(-SET_BYTES // set_bytes)))
    eye = 5 * torch.eye(w, device="cuda")
    sets = []
    for _ in range(n):
        A = torch.randn((B, K, w, w), generator=gen, device="cuda")
        O = 0.3 * torch.randn((B, K - 1, w, w), generator=gen,
                              device="cuda")
        r = torch.randn((B, K, w), generator=gen, device="cuda")
        sets.append(((A @ A.transpose(-1, -2) + eye).contiguous(), O, r))
    return sets


def graph_ms(fn, reps, inner):
    """The median over ``reps`` replays of a CUDA graph of ``inner`` calls
    ``fn(i)``, each replay between two CUDA events, over ``inner``."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = [fn(i) for i in range(1, inner + 1)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del held
    times.sort()
    return times[len(times) // 2]


def run(others, shapes=DEFAULT_SHAPES):
    """{"versions": [...], "rows": [...]}: per shape the planned variant
    and each version's ms (None where its library lacks the entry)."""
    sources = [bt_cuda._SOURCE, *others]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(bt_cuda.compile_source, sources))
    libs = [bt_cuda.load(path) for path, _, _ in built]
    n = len(libs)
    turns = list(range(n)) + list(range(n - 1, -1, -1))
    rows = []
    for K, w, B in shapes:
        pl = bt_cuda.plan(K, w, B)
        sets = problem_sets(B, K, w, seed=B)
        long_k = K > 200
        D, O, r = sets[0]
        ref = None
        ms = [[] for _ in libs]
        errs = [None] * n
        for j in turns:
            lib = libs[j]
            if not hasattr(lib, ENTRY[pl.variant]):
                continue
            if errs[j] is None:
                x = torch.empty_like(r)
                rc = bt_cuda.launch(lib, pl, D, O, r, x)
                if rc != 0:
                    raise RuntimeError(f"{sources[j]}: cudaError {rc} at "
                                       f"{(K, w, B)}")
                torch.cuda.synchronize()
                ref = x if ref is None else ref
                errs[j] = float((x - ref).abs().max())
                limit = 2e-4 * (1 + float(ref.abs().max()))
                if not errs[j] <= limit:
                    raise AssertionError(
                        f"{sources[j]} disagrees with this checkout at "
                        f"{(K, w, B)}: {errs[j]} > {limit}")

            def call(i, lib=lib):
                D, O, r = sets[i % len(sets)]
                x = torch.empty_like(r)
                bt_cuda.launch(lib, pl, D, O, r, x)
                return x

            ms[j].append(graph_ms(call, reps=5 if long_k else 20,
                                  inner=2 if long_k else 10))
        row = {"shape": [K, w, B], "variant": pl.variant,
               "ms": [sum(t) / len(t) if t else None for t in ms],
               "max_abs_diff": errs}
        rows.append(row)
        print(f"K={K} w={w} B={B} ({pl.variant}): " + ", ".join(
            f"{src} {t:.5f} ms" if t is not None else f"{src} —"
            for src, t in zip(sources, row["ms"])), flush=True)
        del sets
        torch.cuda.empty_cache()
    return {"versions": sources, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", help="other bt_solve.cu sources")
    ap.add_argument("--shapes", nargs="*", metavar="K,w,B",
                    help="shapes to time (default: the paths' shapes)")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    shapes = (tuple(tuple(int(v) for v in s.split(",")) for s in args.shapes)
              if args.shapes else DEFAULT_SHAPES)
    out = run(args.others, shapes)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = torch.cuda.get_device_name(0) + ", power limit not read"
    print(card, flush=True)
    line = json.dumps({"card": card, **out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
