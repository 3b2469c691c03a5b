"""The share of the loops' stamped card time spent in a program's loops
after its first (the staged solve's stages, the rescue's phase 2), over
the window's loops."""
from perfbench import recorder


def read(ctx):
    loops = recorder.window_loops(ctx) if ctx.fleet else None
    total = sum(r["ns"] for r in loops) if loops else 0
    if total <= 0:
        return None
    return 100.0 * sum(r["ns"] for r in loops if r["position"] > 0) / total
