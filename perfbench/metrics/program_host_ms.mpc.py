"""The program runner's host ms a tick: the ``program`` span under each
``facade.mpc_step`` less its ``program.launch`` (the key, the copies in,
the clones out), median over the window's ticks. Only a run with the
program's span recorder on has spans."""
import statistics

from perfbench import recorder


def read(ctx):
    recs = recorder.window_spans(ctx) if not ctx.fleet else None
    if not recs:
        return None
    ms = []
    for kids in recorder.under(recs, "facade.mpc_step").values():
        prog = sum(r.ns for r in kids if r.name == "program")
        launch = sum(r.ns for r in kids if r.name == "program.launch")
        if prog:
            ms.append((prog - launch) / 1e6)
    return statistics.median(ms) if ms else None
