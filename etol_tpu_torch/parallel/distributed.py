"""Multi-process execution on ``torch.distributed``.

Counterpart of ``etol_tpu/parallel/distributed.py``. One rank drives one
device. The batch axis spans processes (problems are independent; the
only traffic is the gathering of results), and a horizon axis of a
two-axis mesh stays within the ranks of one host, where the links are
fast.

Usage on every rank (``torchrun`` sets RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT and LOCAL_RANK; without it set ``ETOL_COORDINATOR=host:port``,
``ETOL_NUM_PROCS`` and ``ETOL_PROC_ID``)::

    from etol_tpu_torch.parallel import distributed, mesh as pmesh
    device = distributed.initialize()
    m = distributed.global_mesh(("batch",))
    res = pmesh.solve_sharded(nlp, cfg, bdata, m)   # this rank's lanes
    res = distributed.gather_lanes(res)             # every rank: all

``bdata`` is the whole batch on ``device``; each rank solves its own
lanes. On the CPU two processes over gloo stand in for two hosts.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve
from ..core.problem import tree_map
from .axis import GroupAxis
from .mesh import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the process group; returns this rank's device.

    The coordinator (``host:port``), the process count and this process's
    id come from the arguments, else from ``ETOL_COORDINATOR`` /
    ``ETOL_NUM_PROCS`` / ``ETOL_PROC_ID``, else from ``torchrun``'s
    environment. ``device`` defaults to the card of this rank
    (``LOCAL_RANK``, else the process id, modulo the cards) and raises
    where there is none; pass "cpu" to run on the CPU. ``backend``
    defaults to "nccl" on a card and "gloo" on the CPU; a caller names
    "gloo" for ranks that share one card, which NCCL refuses. Call once a
    process, before any collective."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "ETOL_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("ETOL_NUM_PROCS")
                            or os.environ.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(os.environ.get("ETOL_PROC_ID")
                         or os.environ.get("RANK") or 0)
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return device


def global_mesh(
    axes: Tuple[str, ...] = ("batch",),
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """A process mesh over every rank, rank-major: with ``("batch",
    "horizon")`` the batch axis splits across hosts and the horizon axis
    across the ranks of one host (``LOCAL_WORLD_SIZE``, 1 when unset).
    ``shape`` defaults to (ranks,) for one axis and (hosts, ranks a host)
    for two."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            shape = (n // local, local)
        else:
            raise ValueError("pass an explicit shape for >2 axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return Mesh(np.arange(n).reshape(shape), axes)


def process_local_batch(global_batch: int) -> Tuple[int, int]:
    """(local_batch, offset) of this rank's lanes of a global batch."""
    import torch.distributed as dist

    nproc = dist.get_world_size()
    if global_batch % nproc:
        raise ValueError(
            f"global batch {global_batch} must divide process count "
            f"{nproc}"
        )
    lb = global_batch // nproc
    return lb, lb * dist.get_rank()


def gather_lanes(res, group=None):
    """Every rank's lanes of a result (any dataclass of tensors with the
    lane axis first), joined in rank order on every rank."""
    ax = GroupAxis(group)
    return tree_map(lambda a: ax.gather(a, 0), res)


def demo_problem(device, B: int = 8):
    """:func:`demo`'s batch: ``double_integrator_2d`` (its 20 × 0.25 s
    horizon and obstacle) at B lanes with starts 0.1 apart on ``device``,
    and its solver config. Returns (nlp, cfg, data)."""
    from ..core.problem import batch_tile
    from ..models.problems import double_integrator_2d
    from ..solve.al_sqp import SolverConfig

    vgp, nlp = double_integrator_2d()
    data, _ = vgp.to_device(device=device)
    i = torch.arange(B, device=data.x0.device, dtype=torch.float32)[:, None]
    x0 = torch.cat([0.1 * i, torch.zeros_like(i).expand(B, 3)], dim=1)
    return (nlp, SolverConfig(max_total=400),
            dataclasses.replace(batch_tile(data, B), x0=x0))


def demo(device, B: int = 8) -> dict:
    """One multi-process run over the process group on this rank's
    ``device`` (what :func:`initialize` returned), every rank the same
    code: :func:`demo_problem`'s batch sharded over the ranks: all
    SOLVED; the gathered objectives; then 8 warm re-solves of moved starts
    ("ticks") with their p50; the SPIKE solve of a K=16, w=3 system with
    one slab a rank against the plain solve; and a horizon-sharded solve
    of the dry-run's problem at K=16, one slab a rank, against the
    unsharded solve. Returns the findings, this rank's kernel launches
    included."""
    import statistics
    import time

    import torch.distributed as dist

    from ..ops import bt_cuda
    from ..solve import btridiag
    from ..solve import al_sqp
    from ..solve.al_sqp import SolverConfig
    from . import kkt
    from .dryrun import horizon_problem
    from .mesh import solve_sharded
    from .solve_sharded import solve_horizon_sharded

    nlp, cfg, bdata = demo_problem(device, B)
    dev = bdata.x0.device
    lb, off = process_local_batch(B)
    mesh = global_mesh(("batch",))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = solve_sharded(nlp, cfg, bdata, mesh)
    status = res.status.tolist()
    if len(status) != lb or status != [1] * lb:
        raise AssertionError(f"rank {dist.get_rank()}: statuses {status}")
    full = gather_lanes(res)

    # warm starts are whole-batch, as the data is
    cfg_w = dataclasses.replace(cfg, max_total=40)
    warm = full

    def tick(k):
        moved = dataclasses.replace(bdata, x0=bdata.x0 + 0.005 * k)
        return gather_lanes(solve_sharded(
            nlp, cfg_w, moved, mesh, z0=warm.z,
            lam0=(warm.lam_def, warm.lam_eq, warm.mu), rho0=warm.rho))

    warm = tick(1)
    lats = []
    for k in range(2, 10):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        warm = tick(k)
        sync()
        dist.barrier()
        lats.append(time.perf_counter() - t0)
    warm_solved = float((warm.status == 1).float().mean())
    if warm_solved != 1.0:
        raise AssertionError(f"warm ticks left lanes unsolved: "
                             f"{warm_solved}")

    K, w = 16, 3
    gen = torch.Generator().manual_seed(0)
    A = torch.randn((K, w, w), generator=gen)
    D = (A @ A.transpose(-1, -2) + (3.0 + w) * torch.eye(w)).to(dev)
    O = (0.3 * torch.randn((K - 1, w, w), generator=gen)).to(dev)
    r = torch.randn((K, w), generator=gen).to(dev)
    x = kkt.make_solver(global_mesh(("horizon",)), "horizon")(D, O, r)
    spike_err = float((x - btridiag.solve(D, O, r)).abs().max())
    if not spike_err <= 2e-4:
        raise AssertionError(f"SPIKE over the ranks: max|dx| {spike_err}")

    # one horizon-sharded solve, every rank one slab, against the
    # unsharded one (the dry-run's problem at K=16)
    hnlp, hdata, hz0 = horizon_problem(15, dev)
    hcfg = SolverConfig(max_total=300, tol_cons=3e-4)
    sh = solve_horizon_sharded(hnlp, hcfg, hdata,
                               global_mesh(("horizon",)), z0=hz0)
    single = al_sqp.solve(hnlp, hcfg, hdata, hz0)
    horizon = dict(status=int(sh.status), obj=float(sh.obj),
                   obj_single=float(single.obj), iters=int(sh.inner_iters))
    if horizon["status"] != 1 or not abs(horizon["obj"] - horizon[
            "obj_single"]) <= 1e-3 + 1e-3 * abs(horizon["obj_single"]):
        raise AssertionError(f"horizon-sharded over the ranks: {horizon}")
    return dict(
        rank=dist.get_rank(), world=dist.get_world_size(), device=str(dev),
        backend=dist.get_backend(), lanes=[off, off + lb],
        statuses=status, obj=full.obj.tolist(),
        warm_tick_p50_ms=statistics.median(lats) * 1e3,
        warm_solved=warm_solved, spike_max_abs_err=spike_err,
        horizon=horizon,
        launches=bt_cuda.LAUNCHES,
        launches_by={"K%d_w%d_B%d" % key[1:]: n
                     for key, n in sorted(bt_cuda.LAUNCHES_BY.items())},
    )


if __name__ == "__main__":
    import json
    import sys

    # python -m etol_tpu_torch.parallel.distributed [--device D]
    # [--backend B], on every rank (ETOL_* or torchrun's environment):
    # initialize, run demo(), print its findings as one JSON line
    args = sys.argv[1:]
    opts = dict(zip(args[::2], args[1::2]))
    dev = initialize(device=opts.get("--device"),
                     backend=opts.get("--backend"))
    try:
        print(json.dumps(demo(dev)), flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
