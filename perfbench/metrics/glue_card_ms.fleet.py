"""The card's own ms a batch of the solve programs outside their loops: the
programs' launches (CUDA events around each, span perfbench.solve) less
their loops' card time (stamped on the card by the loops' condition kernel,
read by the settle() after the window): the prologue, the gathers, the
merges and the result."""
from perfbench import recorder


def read(ctx):
    ms = ctx.span_ms("perfbench.solve")
    if not ctx.fleet or not ctx.traced or not ms or not ctx.window.ops:
        return None
    loops = recorder.window_loops(ctx)
    if loops is None:
        return None
    return (sum(ms) - sum(r["ns"] for r in loops) / 1e6) / len(ctx.window.ops)
