"""The line search's share (its candidates' residuals and the pick) of the
trips' card time, stamped on the card at a traced trip's phase boundaries,
over the window's trips. Only a run with the program's span recorder on
captures traced trips."""
from perfbench import recorder


def read(ctx):
    ph = recorder.window_phases(ctx) if ctx.fleet else None
    return 100.0 * ph["line_search"] / sum(ph.values()) if ph else None
