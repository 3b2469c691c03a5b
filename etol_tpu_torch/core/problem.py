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
:func:`vgpdata_from_numpy` relies on; :func:`tree_unflatten` is its
inverse for any tree (``map_lanes``, the checkpoint loader).
"""
from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from . import geometry
from .device import resolve
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

    @staticmethod
    def empty(max_tracks: int, max_waypoints: int, ndim: int = 2,
              dtype=torch.float32, device=None) -> "TrackData":
        """No tracks, padded to at least one track of two waypoints in
        two dims, on ``device`` (the card when none is given)."""
        T, W, D = max(max_tracks, 1), max(max_waypoints, 2), max(ndim, 2)
        z = functools.partial(torch.zeros, dtype=dtype,
                              device=resolve(device))
        return TrackData(times=z((T, W)), xy=z((T, W, D)), radius=z((T,)),
                         mask=z((T,)), dim_mask=z((T, D)))


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

    @staticmethod
    def empty(max_e: int, max_p: int, max_h: int, dtype=torch.float32,
              device=None) -> "ObstacleData":
        """No obstacles, padded to at least one row of each form, on
        ``device`` (the card when none is given)."""
        E, P, H = max(max_e, 1), max(max_p, 1), max(max_h, 1)
        z = functools.partial(torch.zeros, dtype=dtype,
                              device=resolve(device))
        return ObstacleData(ellipses=z((E, 6)), ellipse_mask=z((E,)),
                            halfspaces=z((P, H, 3)), hs_mask=z((P, H)),
                            piece_mask=z((P,)))


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

    @property
    def dtype(self) -> torch.dtype:
        return self.x0.dtype

    def astype(self, dtype) -> "VGPData":
        """Every tensor cast to ``dtype`` (float64 problems take the
        cyclic-reduction KKT route)."""
        return tree_map(lambda a: a.to(dtype), self)


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


def _children(tree):
    """(keys, children, rebuild) of an inner node of a tree: a dataclass
    (its fields in order), a dict (keys sorted, as ``jax.tree`` orders
    them), a list or a tuple (by index); None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return (names, [getattr(tree, n) for n in names],
                lambda kids: type(tree)(**dict(zip(names, kids))))
    if isinstance(tree, dict):
        keys = sorted(tree)

        def rebuild(kids):
            by_key = dict(zip(keys, kids))
            return {k: by_key[k] for k in tree}  # the dict's own order

        return keys, [tree[k] for k in keys], rebuild
    if isinstance(tree, (list, tuple)):
        return (list(range(len(tree))), list(tree),
                lambda kids: type(tree)(kids))
    return None


def tree_flatten(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dataclasses, dicts, lists and tuples,
    depth-first (dataclass fields in order, dict keys sorted)."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for kid in node[1] for leaf in tree_flatten(kid)]


def tree_flatten_with_paths(tree, prefix: str = ""
                            ) -> List[Tuple[str, object]]:
    """(path, leaf) pairs in :func:`tree_flatten`'s order; a path joins
    the field names, dict keys and indices above the leaf with ``/``."""
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    return [kv for key, kid in zip(node[0], node[1])
            for kv in tree_flatten_with_paths(
                kid, f"{prefix}/{key}" if prefix else str(key))]


def _structure(cls):
    """A template of a dataclass type for :func:`tree_unflatten`: its
    nested dataclass fields (read from the annotations) as templates,
    every other field a leaf."""
    hints = typing.get_type_hints(cls)
    return cls(**{
        f.name: (_structure(hints[f.name])
                 if dataclasses.is_dataclass(hints[f.name]) else None)
        for f in dataclasses.fields(cls)
    })


def _unflatten(like, it):
    node = _children(like)
    if node is None:
        return next(it)
    _, kids, rebuild = node
    return rebuild([_unflatten(k, it) for k in kids])


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """Inverse of :func:`tree_flatten`: a tree of the structure of
    ``like`` with ``leaves`` in its places. ``like`` is a tree, or a
    dataclass type such as :class:`VGPData`."""
    if isinstance(like, type):
        like = _structure(like)
    it = iter(leaves)
    tree = _unflatten(like, it)
    if next(it, None) is not None:
        raise ValueError(f"too many leaves for a {type(like).__name__}")
    return tree


def map_lanes(fn: Callable, data, *args):
    """``fn(data_of_lane, *args_of_lane)`` for every lane of a batched
    ``data`` (``torch.func.vmap`` over the leading axis of its tensors
    and of ``args``) — the port's counterpart of ``jax.vmap`` over a
    batched VGPData. ``data`` is any dataclass tree of tensors; each lane
    is rebuilt in the structure of ``data`` itself."""
    return vmap(
        lambda leaves, *a: fn(tree_unflatten(data, leaves), *a)
    )(tuple(tree_flatten(data)), *args)


def vgpdata_from_numpy(leaves: Sequence, device=None) -> VGPData:
    """Build the port's :class:`VGPData` from the JAX package's VGPData
    leaves as numpy arrays (``[np.asarray(a) for a in
    jax.tree.leaves(data)]``), keeping their dtypes, on ``device`` (the
    card when none is given)."""
    device = resolve(device)
    return tree_unflatten(
        VGPData,
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

    def add_params(self, items: Dict[str, ParamConfig]) -> None:
        self.params.update(items)

    @property
    def horizon(self) -> float:
        return self.nsteps * self.dt

    def print_configs(self) -> str:
        """Console dump of the problem spec — printConfigs parity
        (TrajectoryOptimizer.cpp:699-785)."""
        lines = [
            f"nSteps:\t\t{self.nsteps}",
            f"dt:\t\t{self.dt}",
            f"Time Span:\t{self.horizon}",
            f"nStates:\t{self.nx} (rhorizon {self.x_rhorizon})",
        ]
        for i in range(self.nx):
            name = self.xnames[i] if i < len(self.xnames) else f"x{i}"
            vt = (
                self.xvartype[i].to_xml()
                if i < len(self.xvartype)
                else "C"
            )
            lines.append(
                f"  state {name} [{vt}]: bounds [{self.xlower[i]}, "
                f"{self.xupper[i]}] x0={self.x0[i]} xf={self.xf[i]} "
                f"tol={self.xtol[i]}"
            )
        lines.append(f"nControls:\t{self.nu} (rhorizon {self.u_rhorizon})")
        for i in range(self.nu):
            name = self.unames[i] if i < len(self.unames) else f"u{i}"
            vt = (
                self.uvartype[i].to_xml()
                if i < len(self.uvartype)
                else "C"
            )
            lines.append(
                f"  control {name} [{vt}]: bounds [{self.ulower[i]}, "
                f"{self.uupper[i]}]"
            )
        lines.append(f"Exclusion Zones:\t{len(self.obstacles)}")
        for i, poly in enumerate(self.obstacles):
            corners = ", ".join(f"({p[0]}, {p[1]})" for p in poly)
            lines.append(f"  exz{i}: {corners}")
        lines.append(f"Moving Exclusion Zones:\t{len(self.tracks)}")
        for i, trk in enumerate(self.tracks):
            lines.append(
                f"  mexz{i}: r={trk.radius} waypoints="
                + ", ".join(
                    f"t={t}:{p}" for t, p in zip(trk.times, trk.points)
                )
            )
        if self.params:
            lines.append(f"Params:\t{sorted(self.params)}")
        out = "\n".join(lines)
        print(out)
        return out

    # ---- regions (genRegion parity) -----------------------------------
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
        """Freeze into padded tensors on ``device``, the card when none
        is given (the same padding as
        ``etol_tpu.core.problem.VGP.to_device``)."""
        device = resolve(device)
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
