"""Meshes and batch-axis sharded solving.

Counterpart of ``etol_tpu/parallel/mesh.py``. The batch axis is pure
data parallelism: lanes never communicate, so splitting the leading axis
of every :class:`~etol_tpu_torch.core.problem.VGPData` leaf (and of the
warm-start state) partitions the whole solve with no collective at all.

A :class:`Mesh` is an array of entries with axis names, in one of two
kinds:

* a device mesh (entries are ``torch.device``\\ s): one process drives
  every entry. A batch-sharded solve runs each chunk on its device, the
  devices one after another; a horizon-sharded solve stacks its slabs on
  the data's device (:class:`~.axis.SlabAxis`), as XLA's fake host
  devices are one CPU, so on one card every entry is the card;
* a process mesh (entries are ``int`` ranks of ``torch.distributed``;
  :func:`.distributed.global_mesh`): every rank runs its own chunk or
  slab, the ranks in parallel (:class:`~.axis.GroupAxis`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import VGPData, tree_map
from ..solve import al_sqp
from ..solve.al_sqp import SolverConfig
from ..transcribe.nlp import NLP
from .axis import GroupAxis, SlabAxis


class Mesh:
    """Entries (devices or ranks) in an array with named axes; ``shape``
    is a dict as JAX's ``Mesh.shape`` is."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} mesh dims, axis names "
                             f"{self.axis_names}")
        self.processes = all(isinstance(e, (int, np.integer))
                             for e in self.devices.flat)
        self._groups = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def _lines(self, axis: str) -> np.ndarray:
        """The entries as [other entries, mesh.shape[axis]]: each row one
        line along ``axis``."""
        i = self.axis_names.index(axis)
        return np.moveaxis(self.devices, i, -1).reshape(
            -1, self.devices.shape[i])

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis`` (a process mesh)."""
        import torch.distributed as dist

        rows, cols = np.nonzero(self._lines(axis) == dist.get_rank())
        return int(cols[0])

    def axis(self, axis: str):
        """The collectives of ``axis``: a :class:`SlabAxis` on a device
        mesh, on a process mesh the :class:`GroupAxis` of this rank's line
        along it (every rank calls this at the same point: a group that
        is not the whole world is made by all ranks together)."""
        if not self.processes:
            return SlabAxis(self.shape[axis])
        if axis not in self._groups:
            import torch.distributed as dist

            lines = self._lines(axis)
            group = None
            if lines.shape[0] > 1:
                me = dist.get_rank()
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if me in line:
                        group = g
            self._groups[axis] = GroupAxis(group)
        return self._groups[axis]


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("batch",),
) -> Mesh:
    """A mesh; default: 1-D over every CUDA device, axis "batch" (an error
    where there is none: pass ``devices``, e.g. ``["cpu"] * 8``). ``int``
    entries are ranks and make a process mesh."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass the devices (e.g. "
                "['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    entries = [e if isinstance(e, (int, np.integer)) else torch.device(e)
               for e in devices]
    if shape is None:
        shape = (len(entries),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(entries), dtype=object)
    arr[:] = entries
    return Mesh(arr.reshape(shape), axis_names)


def batch_spec(mesh: Mesh, axis: str = "batch") -> str:
    """The axis the leading (lane) dim is split over."""
    return axis


def shard_batch(data: VGPData, mesh: Mesh, axis: str = "batch"):
    """A batched VGPData (leading lane axis on every leaf) split into one
    chunk of lanes for each entry along ``axis``, in lane order: on a
    device mesh each chunk on its entry's device (the first entry of its
    line), on a process mesh on the data's own device."""
    n = mesh.shape[axis]
    B = data.x0.shape[0]
    if B % n:
        raise ValueError(f"batch {B} must divide the {axis} axis ({n})")
    lb = B // n
    firsts = mesh._lines(axis)[0]
    chunks = []
    for i in range(n):
        dev = data.x0.device if mesh.processes else firsts[i]
        chunks.append(tree_map(
            lambda a: a[i * lb:(i + 1) * lb].to(dev), data))
    return chunks


def _lanes_of(x, i, lb, device):
    """Lanes i lb .. (i+1) lb of a tensor or a tuple of them, on
    ``device``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_lanes_of(a, i, lb, device) for a in x)
    return x[i * lb:(i + 1) * lb].to(device)


def solve_sharded(
    nlp: NLP,
    cfg: SolverConfig,
    data: VGPData,
    mesh: Mesh,
    axis: str = "batch",
    z0=None,
    lam0=None,
    rho0=None,
):
    """:func:`al_sqp.solve_batched` with the lanes split over
    ``mesh[axis]``; ``z0``, ``lam0`` and ``rho0`` (lane axis first) are
    split with them. The per-lane solver is the single-device one.

    On a device mesh each chunk is solved on its device (the chunks of
    entries that share a device as one batch there, the devices one
    after another) and the results are joined in lane order on the
    first. On a process mesh every rank passes the whole batch (and the
    whole warm start), solves its own chunk and gets its own lanes back;
    :func:`.distributed.gather_lanes` gives every rank all of them."""
    chunks = shard_batch(data, mesh, axis)
    lb = data.x0.shape[0] // len(chunks)
    lam0 = None if lam0 is None else tuple(lam0)

    def solve(ids):
        dev = chunks[ids[0]].x0.device

        def lanes(x):
            if x is None:
                return None
            parts = [_lanes_of(x, i, lb, dev) for i in ids]
            if isinstance(x, tuple):
                return tuple(torch.cat(p) for p in zip(*parts))
            return torch.cat(parts)

        return al_sqp.solve_batched(
            nlp, cfg, tree_map(lambda *a: torch.cat(a),
                               *(chunks[i] for i in ids)),
            lanes(z0), lanes(lam0), lanes(rho0))

    if mesh.processes:
        return solve([mesh.coord(axis)])
    # entries that share a device are solved there as one batch (lanes
    # never interact: the same result, one pass of the loop)
    groups = {}
    for i, c in enumerate(chunks):
        groups.setdefault(c.x0.device, []).append(i)
    per_chunk = [None] * len(chunks)
    for ids in groups.values():
        res = solve(ids)
        for j, i in enumerate(ids):
            per_chunk[i] = tree_map(lambda a: a[j * lb:(j + 1) * lb], res)
    first = chunks[0].x0.device
    return tree_map(lambda *xs: torch.cat([x.to(first) for x in xs]),
                    *per_chunk)
