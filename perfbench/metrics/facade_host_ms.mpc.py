"""The facade's own host ms a tick: ``facade.mpc_step`` less its
``program`` and its ``facade.sync`` (the new start, the tracks' and the
warm start's shift, the solve's prologue), median over the window's
ticks. Only a run with the program's span recorder on has spans."""
import statistics

from perfbench import recorder


def read(ctx):
    recs = recorder.window_spans(ctx) if not ctx.fleet else None
    if not recs:
        return None
    by_id = {r.id: r for r in recs}
    ms = [(by_id[i].ns - sum(r.ns for r in kids
                             if r.name in ("program", "facade.sync"))) / 1e6
          for i, kids in recorder.under(recs, "facade.mpc_step").items()]
    return statistics.median(ms) if ms else None
