"""The host's ms of a tick: its wall time less the card's own time of its
program launches (CUDA events), median over the window's ticks."""
import statistics


def read(ctx):
    w = ctx.window
    if not ctx.traced or not w.tick_ms:
        return None
    card = {}
    for span, op, a, b in ctx.intervals:
        if span == "perfbench.tick":
            card[op] = card.get(op, 0.0) + b - a
    return statistics.median(ms - card.get(op, 0.0)
                             for ms, op in zip(w.tick_ms, w.tick_ops))
