"""ctypes bridge to the native geometry engine (native/geometry.cpp).

Loads ``libetpu_geometry.so`` when present (build: ``make -C native``);
every entry point returns None on unavailability so callers fall back to
the pure-Python implementations in :mod:`etol_tpu_torch.core.geometry`.
The convex-partition entry of ``etol_tpu/core/_native.py``, copied
because importing that package would import jax. Both load the same
library.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "native",
        "libetpu_geometry.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    lib.etpu_convex_partition.restype = ctypes.c_int
    lib.etpu_convex_partition.argtypes = [
        dptr, ctypes.c_int, iptr, iptr, ctypes.c_int, ctypes.c_int, iptr,
    ]
    _LIB = lib
    return _LIB


def _as_c(poly: np.ndarray):
    poly = np.ascontiguousarray(poly[:, :2], dtype=np.float64)
    return poly, poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def convex_partition_indices(poly: np.ndarray) -> Optional[List[List[int]]]:
    """Pieces as CCW index lists into the CCW-oriented polygon, or None."""
    lib = _load()
    if lib is None:
        return None
    poly, ptr = _as_c(np.asarray(poly))
    n = len(poly)
    max_pieces = n  # a simple polygon partitions into <= n-2 pieces
    cap = 4 * n * 3
    offsets = np.zeros(max_pieces + 1, dtype=np.int32)
    indices = np.zeros(cap, dtype=np.int32)
    ccw = np.zeros(n, dtype=np.int32)
    iptr = ctypes.POINTER(ctypes.c_int)
    rc = lib.etpu_convex_partition(
        ptr, n,
        offsets.ctypes.data_as(iptr),
        indices.ctypes.data_as(iptr),
        max_pieces, cap,
        ccw.ctypes.data_as(iptr),
    )
    if rc < 0:
        return None
    return [
        indices[offsets[p] : offsets[p + 1]].tolist() for p in range(rc)
    ]
