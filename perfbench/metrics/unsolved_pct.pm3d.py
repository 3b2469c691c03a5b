"""``unsolved_pct.fleet`` in the pm3d cell: lanes not reported SOLVED, over
the lanes attempted."""


def read(ctx):
    return ctx.metric("unsolved_pct.fleet")
