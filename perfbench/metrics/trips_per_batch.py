"""Trips of the solver loop a batch: the loops' device counters, read once
after the window (trip_graph.settle), over the window's batches."""


def read(ctx):
    if not ctx.fleet or not ctx.window.ops or ctx.trips <= 0:
        return None
    return ctx.trips / len(ctx.window.ops)
