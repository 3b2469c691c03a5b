"""The line search's share of the solver loops' card time: 100 x the
window's loops' line-search ns (two stamps in every trip, at the line
search's start and end, moved into the loop's stamp slot by its condition
kernel) over the same loops' ns, both read by the settle() after the
window. None where the program stamps no line search."""
from perfbench import recorder


def read(ctx):
    loops = recorder.window_loops(ctx) if ctx.fleet else None
    if not loops or any("ls_ns" not in r for r in loops):
        return None
    total = sum(r["ns"] for r in loops)
    if total <= 0:
        return None
    return 100.0 * sum(r["ls_ns"] for r in loops) / total
