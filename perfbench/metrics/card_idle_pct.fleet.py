"""100 x (1 - the card's time in the window's program launches, by CUDA
events, over the window)."""


def read(ctx):
    if not ctx.fleet or not ctx.traced or not ctx.intervals:
        return None
    return 100.0 * (1.0 - ctx.busy_ms() / (ctx.window.seconds * 1e3))
