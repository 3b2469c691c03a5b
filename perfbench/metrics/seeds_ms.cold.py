"""The card's own ms a batch of the shooting seeds' program (CUDA events
around its launch), mean over the window's cold batches."""


def read(ctx):
    ms = ctx.span_ms("perfbench.seeds")
    return sum(ms) / len(ms) if ms else None
