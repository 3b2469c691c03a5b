"""The median over every tick of the window, each timed by the host from the
call to its synced result."""
import statistics


def read(ctx):
    ms = ctx.window.tick_ms
    return statistics.median(ms) if ms else None
