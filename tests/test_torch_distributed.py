"""The port's multi-process layer on torch.distributed, on the CPU.

The slow test launches 2 real processes joined over gloo TCP through the
``ETOL_*`` variables, each one "host" with one CPU slot, and runs
``python -m etol_tpu_torch.parallel.distributed`` (``distributed.demo``)
in both: tests/test_distributed.py's worker (``double_integrator_2d``,
B=8, 4 lanes a rank, all SOLVED, the gathered objectives equal to one
process's ``solve_batched`` at atol 1e-4, the warm-tick p50), plus the
SPIKE solve with one slab a rank (parallel/axis.py::GroupAxis) against
the plain solve and a horizon-sharded solve over the ranks. The tier-1
test joins a group of one.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from etol_tpu_torch.parallel import distributed, kkt
from etol_tpu_torch.parallel.axis import GroupAxis
from etol_tpu_torch.solve import btridiag
from etol_tpu_torch.solve.al_sqp import solve_batched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class _Lanes:
    z: torch.Tensor
    status: torch.Tensor


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_a_group_of_one(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("ETOL_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("ETOL_NUM_PROCS", "1")
    monkeypatch.setenv("ETOL_PROC_ID", "0")
    device = distributed.initialize(device="cpu")
    try:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        assert distributed.process_local_batch(8) == (8, 0)
        with pytest.raises(ValueError, match="1 ranks"):
            distributed.global_mesh(("batch",), shape=(2,))
        mesh = distributed.global_mesh(("batch", "horizon"))
        assert mesh.processes and mesh.shape == {"batch": 1, "horizon": 1}
        ax = GroupAxis()
        x = torch.arange(6.0).reshape(1, 2, 3)
        for got in (ax.psum(x), ax.from_left(x, 1), ax.from_right(x, 1),
                    ax.gather(x, 1)):
            assert torch.equal(got, x)
        rng = np.random.default_rng(0)
        A = rng.normal(size=(8, 3, 3)).astype(np.float32)
        D = torch.from_numpy(A @ A.transpose(0, 2, 1) + 6 * np.eye(3))
        D = D.float()
        O = torch.from_numpy(0.3 * rng.normal(size=(7, 3, 3))).float()
        r = torch.from_numpy(rng.normal(size=(8, 3))).float()
        x = kkt.make_solver(distributed.global_mesh(("horizon",)))(D, O, r)
        np.testing.assert_allclose(x.numpy(),
                                   btridiag.solve(D, O, r).numpy(),
                                   rtol=2e-4, atol=2e-4)
        lanes = _Lanes(torch.arange(3.0), torch.arange(3, dtype=torch.int32))
        got = distributed.gather_lanes(lanes)
        assert torch.equal(got.z, lanes.z) and torch.equal(got.status,
                                                           lanes.status)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_two_process_gloo_batched_solve():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            ETOL_COORDINATOR=f"127.0.0.1:{port}", ETOL_NUM_PROCS="2",
            ETOL_PROC_ID=str(pid), OMP_NUM_THREADS="1",
            PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etol_tpu_torch.parallel.distributed",
             "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    found = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
        found.append(json.loads(out.strip().splitlines()[-1]))
        assert found[-1]["rank"] == pid and found[-1]["backend"] == "gloo"
        assert found[-1]["lanes"] == [4 * pid, 4 * pid + 4]
        assert found[-1]["statuses"] == [1] * 4
        assert found[-1]["warm_solved"] == 1.0
        assert found[-1]["spike_max_abs_err"] <= 2e-4
        assert found[-1]["horizon"]["status"] == 1

    # one process's solve of the same batch
    torch.set_num_threads(1)
    res = solve_batched(*distributed.demo_problem("cpu", 8))
    for f in found:
        np.testing.assert_allclose(f["obj"], res.obj.numpy(), atol=1e-4)
    print(f"\n2-process gloo warm tick p50: {found[0]['warm_tick_p50_ms']:.2f}"
          " ms (CPU)")
