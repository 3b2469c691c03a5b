"""The Hessian blocks' (gn_blocks) share of the trips' card time, stamped
on the card at a traced trip's phase boundaries, over the window's trips.
Only a run with the program's span recorder on captures traced trips."""
from perfbench import recorder


def read(ctx):
    ph = recorder.window_phases(ctx) if ctx.fleet else None
    return 100.0 * ph["assembly"] / sum(ph.values()) if ph else None
