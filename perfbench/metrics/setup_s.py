"""Process start to the first timed dispatch: imports, the kernels' builds
or loads, the problem and entry, and each of the cell's keys' first uses."""


def read(ctx):
    return ctx.setup_s
