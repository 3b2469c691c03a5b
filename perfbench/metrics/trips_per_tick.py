"""Newton iterations (one trip of the loop each) of a tick, as its result
reports them, mean over the window's ticks."""


def read(ctx):
    its = ctx.window.inner_iters
    if not its:
        return None
    return sum(float(i) for i in its) / len(its)
