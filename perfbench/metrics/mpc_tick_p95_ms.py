"""The 95th percentile over every tick of the window (linear between order
statistics), each timed by the host from the call to its synced result."""
import numpy as np


def read(ctx):
    ms = ctx.window.tick_ms
    return float(np.percentile(ms, 95)) if ms else None
