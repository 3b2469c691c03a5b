"""``trip_ms.fleet`` in the pm3d cell: the card's ms of the window's solve
programs over the loop's trips."""


def read(ctx):
    return ctx.metric("trip_ms.fleet")
