"""Host-side computational geometry.

Replaces the reference's CGAL usage (``optimal_convex_partition_2`` inside
``TrajectoryOptimizer::genRegion``, TrajectoryOptimizer.cpp:84-159) and
builds the device-side obstacle forms (halfspaces, edge ellipses).

This is *preprocessing*: it runs once per obstacle field on the host (numpy
only, optionally accelerated by the C++ extension in ``native/``) and emits
fixed-shape arrays for the device. It is the part of
``etol_tpu/core/geometry.py`` that the port uses, copied because importing
that package imports jax.

A convex partition is produced with ear-clipping triangulation followed by
Hertel–Mehlhorn diagonal merging, which yields at most 4x the optimal number
of convex pieces (in practice optimal or near-optimal for the small polygons
ETOL handles). The reference uses CGAL's optimal partition; piece *count* may
differ but both are valid convex covers, and all downstream consumers
(half-space big-M rows, edge ellipses) only require convexity.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Array = np.ndarray
_EPS = 1e-12


# ---------------------------------------------------------------------------
# basic predicates
# ---------------------------------------------------------------------------

def cross2(o: Array, a: Array, b: Array) -> float:
    """Signed area*2 of triangle (o, a, b); >0 means CCW turn."""
    return float((a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]))


def polygon_area(poly: Array) -> float:
    """Signed area; >0 for counter-clockwise winding."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def ensure_ccw(poly: Array) -> Array:
    poly = np.asarray(poly, dtype=np.float64)[:, :2]
    if polygon_area(poly) < 0:
        poly = poly[::-1].copy()
    return poly


# ---------------------------------------------------------------------------
# triangulation + Hertel–Mehlhorn convex partition
# ---------------------------------------------------------------------------

def _is_ear(poly: Array, idxs: List[int], i: int) -> bool:
    n = len(idxs)
    p_prev = poly[idxs[(i - 1) % n]]
    p_curr = poly[idxs[i]]
    p_next = poly[idxs[(i + 1) % n]]
    if cross2(p_prev, p_curr, p_next) <= _EPS:  # reflex or collinear
        return False
    # no other vertex inside OR on the boundary of the candidate ear —
    # a vertex on the ear's chord splits the remainder into degenerate
    # pieces (overlap bug on e.g. an L-shape whose reflex vertex is
    # collinear with the chord)
    for j in range(n):
        if j in ((i - 1) % n, i, (i + 1) % n):
            continue
        q = poly[idxs[j]]
        d1 = cross2(p_prev, p_curr, q)
        d2 = cross2(p_curr, p_next, q)
        d3 = cross2(p_next, p_prev, q)
        if d1 > -1e-9 and d2 > -1e-9 and d3 > -1e-9:
            return False
    return True


def triangulate(poly: Array) -> List[Tuple[int, int, int]]:
    """Ear-clipping triangulation of a simple polygon. Returns index triples
    into ``poly`` (CCW)."""
    poly = ensure_ccw(poly)
    n = len(poly)
    if n < 3:
        raise ValueError("polygon needs >= 3 vertices")
    idxs = list(range(n))
    tris: List[Tuple[int, int, int]] = []
    guard = 0
    while len(idxs) > 3:
        guard += 1
        if guard > 10 * n * n:
            raise RuntimeError("ear clipping failed (degenerate polygon?)")
        m = len(idxs)
        clipped = False
        for i in range(m):
            if _is_ear(poly, idxs, i):
                tris.append(
                    (idxs[(i - 1) % m], idxs[i], idxs[(i + 1) % m])
                )
                idxs.pop(i)
                clipped = True
                break
        if not clipped:
            # fall back: clip the least-reflex vertex to make progress on
            # nearly-degenerate inputs
            best, best_c = 0, -np.inf
            for i in range(m):
                c = cross2(
                    poly[idxs[(i - 1) % m]],
                    poly[idxs[i]],
                    poly[idxs[(i + 1) % m]],
                )
                if c > best_c:
                    best, best_c = i, c
            tris.append(
                (idxs[(best - 1) % m], idxs[best], idxs[(best + 1) % m])
            )
            idxs.pop(best)
    tris.append((idxs[0], idxs[1], idxs[2]))
    return tris


def _piece_is_convex(poly: Array, piece: List[int]) -> bool:
    n = len(piece)
    for i in range(n):
        if (
            cross2(
                poly[piece[(i - 1) % n]],
                poly[piece[i]],
                poly[piece[(i + 1) % n]],
            )
            < -1e-9
        ):
            return False
    return True


def _merge(piece_a: List[int], piece_b: List[int], i: int, j: int) -> List[int]:
    """Merge two CCW pieces sharing the diagonal (piece_a[i], piece_a[i+1])
    == (piece_b[j+1], piece_b[j])."""
    na, nb = len(piece_a), len(piece_b)
    out = []
    # walk a from i+1 around to i (inclusive)
    k = (i + 1) % na
    while True:
        out.append(piece_a[k])
        if k == i:
            break
        k = (k + 1) % na
    # insert b's vertices strictly between the shared edge endpoints
    k = (j + 1) % nb
    mid = []
    while True:
        k = (k + 1) % nb
        if k == j:
            break
        mid.append(piece_b[k])
    # out currently ends at piece_a[i] == piece_b[j+1]; append b's interior
    return out + mid


def convex_partition_indices(poly: Array) -> List[List[int]]:
    """Hertel–Mehlhorn: triangulate, then greedily delete inessential
    diagonals. Returns convex pieces as CCW index lists into ``poly``."""
    poly = ensure_ccw(poly)
    pieces: List[List[int]] = [list(t) for t in triangulate(poly)]
    merged = True
    while merged:
        merged = False
        for ai in range(len(pieces)):
            a = pieces[ai]
            done = False
            for i in range(len(a)):
                e = (a[i], a[(i + 1) % len(a)])
                for bi in range(len(pieces)):
                    if bi == ai:
                        continue
                    b = pieces[bi]
                    for j in range(len(b)):
                        if (b[j], b[(j + 1) % len(b)]) == (e[1], e[0]):
                            cand = _merge(a, b, i, j)
                            if _piece_is_convex(poly, cand):
                                pieces[ai] = cand
                                pieces.pop(bi)
                                merged = True
                                done = True
                            break
                    if done:
                        break
                if done:
                    break
            if done:
                break
    return pieces


def convex_partition(poly: Array) -> List[Array]:
    """Partition a simple polygon into convex CCW pieces (vertex arrays).

    Uses the native engine (native/geometry.cpp, the CGAL
    ``optimal_convex_partition_2`` replacement) when built, else the
    pure-Python Hertel-Mehlhorn above."""
    from . import _native

    poly = ensure_ccw(poly)
    pieces = _native.convex_partition_indices(poly)
    if pieces is None:
        pieces = convex_partition_indices(poly)
    return [poly[piece] for piece in pieces]


# ---------------------------------------------------------------------------
# halfspace form: the device-friendly convex-piece representation
# ---------------------------------------------------------------------------

def piece_halfspaces(piece: Array) -> Array:
    """Outward halfspaces of a convex CCW polygon: rows (nx, ny, b) with the
    interior satisfying nx*x + ny*y <= b for every row. Avoidance of the
    piece is the disjunction  ∃ row: nx*x + ny*y >= b  — exactly the per-side
    big-M structure of the MILP backends (eGLPK.cpp:190-246), but in normal
    form rather than slope form so vertical edges need no special casing."""
    piece = ensure_ccw(piece)
    nrm = []
    n = len(piece)
    for i in range(n):
        a, b = piece[i], piece[(i + 1) % n]
        e = b - a
        # outward normal of a CCW polygon edge
        nvec = np.array([e[1], -e[0]])
        ln = np.hypot(*nvec)
        if ln < _EPS:
            continue
        nvec = nvec / ln
        nrm.append([nvec[0], nvec[1], float(nvec @ a)])
    return np.asarray(nrm)


def edge_ellipses(poly: Array, flatten: float = 0.2) -> Array:
    """Per-edge exclusion ellipses — the smooth obstacle reformulation used
    by the reference's NLP examples (etol_psopt_example1.cpp:140-197).

    For each polygon edge (a, b): center c = midpoint, rotation aligning the
    edge with x', semi-axes a^2 = |c-a|^2 (half edge length squared) and
    b^2 = flatten * a^2. A point p is *violating* when it is inside the
    ellipse:  asq*bsq - (bsq*dx'^2 + asq*dy'^2) > 0.

    Returns rows (cx, cy, cos_t, sin_t, asq, bsq) with the rotation angle
    t = -atan2(cy-ay, cx-ax) exactly as the reference computes it.
    """
    poly = np.asarray(poly, dtype=np.float64)[:, :2]
    rows = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        c = (a + b) / 2.0
        radsq = float((c[0] - a[0]) ** 2 + (c[1] - a[1]) ** 2)
        if radsq < _EPS:
            continue
        t = -np.arctan2(c[1] - a[1], c[0] - a[0])
        rows.append([c[0], c[1], np.cos(t), np.sin(t), radsq, flatten * radsq])
    return np.asarray(rows)
