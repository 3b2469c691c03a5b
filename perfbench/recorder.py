"""What the program records of itself, read for a run's window: its loops'
card stamps (``etol_tpu_torch.solve.trip_graph.LAST_READ``: the loops'
card time, always stamped, and a traced trip's phases) and the spans of its
recorder (``etol_tpu_torch.utils.profiling``, on only where the run switched
it on, as ``perfbench/traced.py`` does).

Each reader returns None where the program records no such thing (a
program without stamps or spans: nothing to read, nothing raised), or
where what it holds is not the window's.
"""
from __future__ import annotations


def window_loops(ctx):
    """The loops the harness's settle() after the window read, one dict an
    insertion (body, position, lanes, runs, trips, ns), where their trips
    are the window's; else None."""
    from etol_tpu_torch.solve import trip_graph

    read = getattr(trip_graph, "LAST_READ", None)
    if not read or not read["loops"]:
        return None
    if sum(r["trips"] for r in read["loops"]) != ctx.trips:
        return None
    return read["loops"]


def window_phases(ctx):
    """The traced trips' card ns by phase over the window ({phase: ns}),
    or None."""
    from etol_tpu_torch.solve import trip_graph

    if window_loops(ctx) is None:
        return None
    out = {}
    for r in trip_graph.LAST_READ["phases"]:
        for phase, ns in r["ns"].items():
            out[phase] = out.get(phase, 0) + ns
    return out if sum(out.values()) > 0 else None


def window_spans(ctx):
    """The recorder's spans of the window (opened from its latest mark(),
    the window's start, to the window's end), or None."""
    from etol_tpu_torch.utils import profiling as prof

    if not hasattr(prof, "records"):
        return None
    since = prof.last_mark()
    until = since + int(ctx.window.seconds * 1e9)
    recs = [r for r in prof.records(since) if r.start_ns <= until]
    return recs or None


def under(recs, root_name):
    """{id of each span named ``root_name``: [its descendants]}."""
    by_id = {r.id: r for r in recs}
    out = {r.id: [] for r in recs if r.name == root_name}
    for r in recs:
        p = r.parent
        while p is not None and p in by_id:
            if p in out:
                out[p].append(r)
                break
            p = by_id[p].parent
    return out
