"""Checked SOLVED lanes of every batch of the window (SOLVED and passed by
the output check) over the window's whole time, first dispatch to the last
batch's end."""


def read(ctx):
    if not ctx.fleet or ctx.window.seconds <= 0:
        return None
    return (ctx.tally.solved - ctx.tally.rejected) / ctx.window.seconds
