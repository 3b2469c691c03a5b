"""Lanes the program did not report SOLVED, over the lanes attempted."""


def read(ctx):
    t = ctx.tally
    if not ctx.fleet or t.lanes == 0:
        return None
    return 100.0 * (t.lanes - t.solved) / t.lanes
