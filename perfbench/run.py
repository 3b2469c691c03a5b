"""The benchmark of etol_tpu_torch: one run of one cell, on the cards its
``chips`` names.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

The cells, their metrics and bounds are in BENCHMARK.json at the checkout's
root. The last line on stdout is the result: {"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "compared"}; untraced the
metrics are the cell's end-to-end ones, traced its per-layer ones. The last
lines on stderr are the numbers the output check compared, each beside its
limit. ``--control 1`` also prints on stderr what the check reads on the
window's outputs rounded to bfloat16 (the check's control). Exits non-zero,
printing no result, where CUDA or the cell's cards are missing, or where
JAX or the JAX package is loaded once the window has closed.

A cell of one card runs in this process alone. A cell of n > 1 cards runs
as n ranks, one card each (``cuda:r``): this process is rank 0 and starts
the others, every rank runs the same window, and rank 0 checks and prints
the line, whose ``device.count`` is n (``perfbench/ranks.py``). A rank's
fault ends the run on every rank, counted in ``failed``, or with a
non-zero exit and no line, within ``ranks.TIMEOUT_S + ranks.GRACE_S``
seconds past ``--seconds``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run inside the checkout, at fixed
# paths (the program builds its kernels into build/etol_tpu_torch/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    import torch

    # n cards: one rank on each of cuda:0 .. cuda:n-1
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); available: "
              f"{torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from perfbench import ranks

    line = ranks.run(args.workload, args.seed, args.seconds,
                     bool(args.trace), chips, "cuda", t_start=T_START,
                     control=bool(args.control), bench=bench)
    if line is None:
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
