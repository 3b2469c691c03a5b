"""The card's own ms of the window's solve programs (CUDA events around
each launch) over the loop's trips (device counters)."""


def read(ctx):
    ms = ctx.span_ms("perfbench.solve")
    if not ctx.fleet or not ms or ctx.trips <= 0:
        return None
    return sum(ms) / ctx.trips
