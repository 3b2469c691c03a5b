"""The Vehicle Guidance Problem (VGP) as frozen dataclasses of tensors.

Counterpart of ``etol_tpu/core/problem.py``:

* :class:`VGP` — the host-side builder with the reference's knobs
  (bounds, x0/xf, obstacles, tracks), a copy of the JAX package's;
* :class:`VGPData` — the problem as the solver sees it: a frozen
  dataclass of fixed-shape tensors. A batch of problems carries a
  leading lane axis on every tensor.

Variable-count features (obstacle corners, convex pieces, track
waypoints) are padded to static maxima and masked, exactly as the JAX
package pads them, so the two packages hold the same numbers.

:func:`tree_flatten` lists the tensors of a :class:`VGPData` in the order
``jax.tree.leaves`` lists the JAX package's, which is what
:func:`vgpdata_from_numpy` relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from . import geometry
from .types import Dims, ParamConfig, VarType


@dataclasses.dataclass(frozen=True)
class TrackData:
    """Moving exclusion zones ("tracks", ETOL_Types.hpp:102-105) as
    padded tensors: ``times`` [T, W], ``xy`` [T, W, D], ``radius`` [T],
    ``mask`` [T] (1.0 where the track exists) and ``dim_mask`` [T, D]
    (1.0 for the real dims of each track)."""

    times: torch.Tensor
    xy: torch.Tensor
    radius: torch.Tensor
    mask: torch.Tensor
    dim_mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ObstacleData:
    """Static polygonal exclusion zones in two forms: per-edge ellipses
    ``ellipses`` [E, 6] (rows cx, cy, cos, sin, asq, bsq) with
    ``ellipse_mask`` [E], and per-convex-piece outward halfspaces
    ``halfspaces`` [P, H, 3] (rows nx, ny, b) with ``hs_mask`` [P, H] and
    ``piece_mask`` [P]."""

    ellipses: torch.Tensor
    ellipse_mask: torch.Tensor
    halfspaces: torch.Tensor
    hs_mask: torch.Tensor
    piece_mask: torch.Tensor


def _empty_params():
    return torch.zeros((0,), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class VGPData:
    """One VGP (or, with a leading lane axis on every tensor, a batch of
    them) as seen by the solver."""

    x0: torch.Tensor        # [nx] initial state
    xf: torch.Tensor        # [nx] goal state
    xtol: torch.Tensor      # [nx] goal tolerance band
    x_lb: torch.Tensor      # [nx]
    x_ub: torch.Tensor      # [nx]
    u_lb: torch.Tensor      # [nu]
    u_ub: torch.Tensor      # [nu]
    dt: torch.Tensor        # [] step size
    obstacles: ObstacleData
    tracks: TrackData
    # auxiliary ("param") decision columns; zero-size when none
    p_lb: torch.Tensor = dataclasses.field(default_factory=_empty_params)
    p_ub: torch.Tensor = dataclasses.field(default_factory=_empty_params)
    p_window: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 2), dtype=torch.float32)
    )


# ---------------------------------------------------------------------------
# tree helpers (the jax.tree counterparts for these dataclasses)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over dataclasses of tensors of one shape of
    tree (nested dataclasses are descended into, in field order)."""
    first = trees[0]
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
        })
    return fn(*trees)


def tree_flatten(tree) -> List[torch.Tensor]:
    """The leaves of a dataclass tree, depth-first in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out.extend(tree_flatten(getattr(tree, f.name)))
        return out
    return [tree]


_CHILDREN = {"obstacles": ObstacleData, "tracks": TrackData}


def _unflatten(cls, it):
    kw = {}
    for f in dataclasses.fields(cls):
        child = _CHILDREN.get(f.name) if cls is VGPData else None
        kw[f.name] = _unflatten(child, it) if child else next(it)
    return cls(**kw)


def vgpdata_unflatten(leaves: Sequence[torch.Tensor]) -> VGPData:
    """Inverse of :func:`tree_flatten` for a :class:`VGPData`."""
    it = iter(leaves)
    data = _unflatten(VGPData, it)
    if next(it, None) is not None:
        raise ValueError("too many leaves for a VGPData")
    return data


def map_lanes(fn: Callable, data: VGPData, *args):
    """``fn(data_of_lane, *args_of_lane)`` for every lane of a batched
    ``data`` (``torch.func.vmap`` over the leading axis of its tensors
    and of ``args``) — the port's counterpart of ``jax.vmap`` over a
    batched VGPData."""
    return vmap(
        lambda leaves, *a: fn(vgpdata_unflatten(leaves), *a)
    )(tuple(tree_flatten(data)), *args)


def vgpdata_from_numpy(leaves: Sequence, device=None) -> VGPData:
    """Build the port's :class:`VGPData` from the JAX package's VGPData
    leaves as numpy arrays (``[np.asarray(a) for a in
    jax.tree.leaves(data)]``), keeping their dtypes."""
    return vgpdata_unflatten(
        [torch.tensor(np.asarray(a), device=device) for a in leaves]
    )


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Track:
    radius: float
    times: List[float]
    points: List[List[float]]  # [W][ndim]


@dataclasses.dataclass
class VGP:
    """Host-side problem description with reference-parity knobs.
    ``to_device`` freezes it into a :class:`VGPData` + :class:`Dims`
    pair."""

    nsteps: int = 0
    dt: float = 0.0
    x_rhorizon: int = 0
    u_rhorizon: int = 0
    xnames: List[str] = dataclasses.field(default_factory=list)
    unames: List[str] = dataclasses.field(default_factory=list)
    x0: List[float] = dataclasses.field(default_factory=list)
    xf: List[float] = dataclasses.field(default_factory=list)
    xtol: List[float] = dataclasses.field(default_factory=list)
    xlower: List[float] = dataclasses.field(default_factory=list)
    xupper: List[float] = dataclasses.field(default_factory=list)
    xvartype: List[VarType] = dataclasses.field(default_factory=list)
    ulower: List[float] = dataclasses.field(default_factory=list)
    uupper: List[float] = dataclasses.field(default_factory=list)
    uvartype: List[VarType] = dataclasses.field(default_factory=list)
    obstacles: List[np.ndarray] = dataclasses.field(default_factory=list)
    tracks: List[Track] = dataclasses.field(default_factory=list)
    params: Dict[str, ParamConfig] = dataclasses.field(default_factory=dict)
    maximize: bool = False

    @property
    def nx(self) -> int:
        return len(self.x0)

    @property
    def nu(self) -> int:
        return len(self.ulower)

    def add_exclusion_zone(self, corners: Sequence[Sequence[float]]) -> None:
        """addExclZone (TrajectoryOptimizer.cpp:1642-1647); a z column is
        stored, avoidance acts on the xy footprint."""
        arr = np.asarray(corners, dtype=np.float64)
        self.obstacles.append(arr[:, :3] if arr.shape[1] >= 3 else arr)

    def add_track(
        self,
        radius: float,
        times: Sequence[float],
        points: Sequence[Sequence[float]],
    ) -> None:
        """addAdjTrack (TrajectoryOptimizer.cpp:1649-1651)."""
        self.tracks.append(
            Track(float(radius), [float(t) for t in times],
                  [list(map(float, p)) for p in points])
        )

    def regions(self):
        """Convex partition of every obstacle
        (genRegion, TrajectoryOptimizer.cpp:84-159)."""
        return [geometry.convex_partition(p[:, :2]) for p in self.obstacles]

    def dims(
        self,
        pad_ellipses: Optional[int] = None,
        pad_pieces: Optional[int] = None,
        pad_halfspaces: Optional[int] = None,
        pad_tracks: Optional[int] = None,
        pad_waypoints: Optional[int] = None,
    ) -> Dims:
        parts = self.regions()
        n_e = sum(len(p) for p in self.obstacles)
        pieces = [pc for region in parts for pc in region]
        n_p = len(pieces)
        n_h = max((len(pc) for pc in pieces), default=0)
        n_t = len(self.tracks)
        n_w = max((len(t.times) for t in self.tracks), default=2)
        return Dims(
            nx=self.nx,
            nu=self.nu,
            nsteps=self.nsteps,
            rhorizon=max(self.x_rhorizon, 1),
            max_ellipses=pad_ellipses if pad_ellipses is not None else n_e,
            max_pieces=pad_pieces if pad_pieces is not None else n_p,
            max_halfspaces=(
                pad_halfspaces if pad_halfspaces is not None else n_h
            ),
            max_tracks=pad_tracks if pad_tracks is not None else n_t,
            max_waypoints=(
                pad_waypoints if pad_waypoints is not None else max(n_w, 2)
            ),
            n_params=len(self.params),
        )

    def to_device(
        self,
        dims: Optional[Dims] = None,
        dtype=torch.float32,
        device=None,
    ) -> Tuple[VGPData, Dims]:
        """Freeze into padded tensors on ``device`` (the same padding as
        ``etol_tpu.core.problem.VGP.to_device``)."""
        if dims is None:
            dims = self.dims()
        E = max(dims.max_ellipses, 1)
        P = max(dims.max_pieces, 1)
        H = max(dims.max_halfspaces, 1)
        T = max(dims.max_tracks, 1)
        W = max(dims.max_waypoints, 2)

        ell = np.zeros((E, 6))
        ell_mask = np.zeros((E,))
        k = 0
        for poly in self.obstacles:
            rows = geometry.edge_ellipses(poly[:, :2])
            for r in rows:
                if k >= E:
                    raise ValueError("pad_ellipses too small")
                ell[k] = r
                ell_mask[k] = 1.0
                k += 1

        hs = np.zeros((P, H, 3))
        hs_mask = np.zeros((P, H))
        piece_mask = np.zeros((P,))
        k = 0
        for region in self.regions():
            for piece in region:
                if k >= P:
                    raise ValueError("pad_pieces too small")
                rows = geometry.piece_halfspaces(piece)
                if len(rows) > H:
                    raise ValueError("pad_halfspaces too small")
                hs[k, : len(rows)] = rows
                hs_mask[k, : len(rows)] = 1.0
                piece_mask[k] = 1.0
                k += 1

        D = max(
            [2] + [len(p) for trk in self.tracks for p in trk.points]
        )
        tt = np.zeros((T, W))
        txy = np.zeros((T, W, D))
        tr = np.zeros((T,))
        tmask = np.zeros((T,))
        tdim = np.zeros((T, D))
        for i, trk in enumerate(self.tracks):
            if i >= T:
                raise ValueError("pad_tracks too small")
            w = len(trk.times)
            if w > W:
                raise ValueError("pad_waypoints too small")
            tt[i, :w] = trk.times
            # pad by repeating the last waypoint so interpolation clamps
            tt[i, w:] = trk.times[-1]
            nd = min(len(trk.points[0]), D)
            pts = np.asarray(trk.points)[:, :nd]
            txy[i, :w, :nd] = pts
            txy[i, w:, :nd] = pts[-1]
            tr[i] = trk.radius
            tmask[i] = 1.0
            tdim[i, :nd] = 1.0

        # param columns in sorted-name order
        np_ = dims.n_params
        pnames = sorted(self.params)[:np_]
        plb = np.zeros((np_,))
        pub = np.zeros((np_,))
        pwin = np.zeros((np_, 2))
        for j, name in enumerate(pnames):
            pc = self.params[name]
            plb[j] = pc.lower
            pub[j] = pc.upper
            pwin[j] = (pc.t_start, pc.t_stop)

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        data = VGPData(
            x0=f(self.x0),
            xf=f(self.xf),
            xtol=f(self.xtol),
            x_lb=f(self.xlower),
            x_ub=f(self.xupper),
            u_lb=f(self.ulower),
            u_ub=f(self.uupper),
            dt=f(self.dt),
            obstacles=ObstacleData(
                ellipses=f(ell),
                ellipse_mask=f(ell_mask),
                halfspaces=f(hs),
                hs_mask=f(hs_mask),
                piece_mask=f(piece_mask),
            ),
            tracks=TrackData(
                times=f(tt), xy=f(txy), radius=f(tr), mask=f(tmask),
                dim_mask=f(tdim),
            ),
            p_lb=f(plb),
            p_ub=f(pub),
            p_window=f(pwin),
        )
        return data, dims


def stack(datas: Sequence[VGPData]) -> VGPData:
    """Stack per-problem VGPData into a batch (leading axis)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *datas)


def batch_tile(data: VGPData, batch: int) -> VGPData:
    """Broadcast one problem into a batch of identical problems."""
    return tree_map(
        lambda a: a.expand((batch,) + tuple(a.shape)).contiguous(), data
    )
