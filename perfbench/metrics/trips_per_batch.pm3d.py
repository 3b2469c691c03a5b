"""``trips_per_batch`` in the pm3d cell: trips of the solver loop a batch,
from the loops' device counters."""


def read(ctx):
    return ctx.metric("trips_per_batch")
