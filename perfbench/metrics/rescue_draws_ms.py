"""The host ms a call of the draws made before the rescue's program
(``solve.draws`` under ``facade.solve_batch``: the bumps and shooting units
from the generator, and their copy to the card), mean over the window's
calls. Only a run with the program's span recorder on has spans."""
from perfbench import recorder


def read(ctx):
    recs = recorder.window_spans(ctx) if ctx.fleet else None
    if not recs:
        return None
    names = {r.id: r.name for r in recs}
    ms = [r.ns / 1e6 for r in recs if r.name == "solve.draws"
          and names.get(r.parent) == "facade.solve_batch"]
    return sum(ms) / len(ms) if ms else None
