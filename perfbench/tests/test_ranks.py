"""A cell of n > 1 devices runs as n ranks: two CPU ranks under gloo, rank 0
started as the benchmark's command is and rank 1 by it, each run in a
process of its own under a time limit. A stub entry answers each batch
with the single integrator's straight line, its objective made by one
psum over the program's group, and writes what each op saw; a rank that
raises in an op ends the run on both within the stated timeout."""
import json
import os
import subprocess
import sys
import time

from perfbench import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: a stub of the port: the straight line from start to goal (the single
#: integrator's optimum under trapezoidal collocation), every lane on
#: every rank, its objective psum(cost) / size over the group
STUB_ENTRY = '''"""Straight lines, the objective a psum over the ranks."""
import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Result:
    z: torch.Tensor
    obj: torch.Tensor
    status: torch.Tensor
    lam_def: torch.Tensor
    mu: torch.Tensor


class Entry:
    synced = True

    def __init__(self, config, traffic, device, group, config_dir):
        p, self.stub = config["problem"], config["stub"]
        self.group, self.calls = group, 0
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.x0 = torch.tensor(p["x0"], dtype=torch.float64, device=device)
        self.xf = torch.tensor(p["xf"], dtype=torch.float64, device=device)
        self.N, self.dt = p["nsteps"], p["dt"]
        self.scale = torch.tensor([max(1.0, (hi - lo) / 2) for lo, hi in
                                   zip(p["x_lower"], p["x_upper"])],
                                  dtype=torch.float64, device=device)
        self.log = os.path.join(self.stub["log_dir"], f"ops.{self.rank}")

    def batch(self, x0, xf, seeds, spans, k):
        self.calls += 1
        if self.calls == self.stub.get("raise_at_call") and \\
                self.rank == self.stub["raise_rank"]:
            raise RuntimeError("a planted fault")
        s = torch.linspace(0, 1, self.N + 1, dtype=x0.dtype,
                           device=x0.device)[:, None]
        X = x0[:, None] + s * (xf - x0)[:, None]
        U = ((xf - x0) / (self.N * self.dt))[:, None].expand_as(X)
        w = torch.ones(self.N + 1, dtype=x0.dtype, device=x0.device)
        w[0] = w[-1] = 0.5
        cost = self.dt * ((U ** 2).sum(-1) * w).sum(-1)
        total = cost.clone()
        with spans("perfbench.solve", k):
            dist.all_reduce(total, group=self.group)
        B = x0.shape[0]
        with open(self.log, "a") as fh:
            fh.write(f"{self.calls} {k} {float(total.sum() / cost.sum())}\\n")
        return Result(
            z=torch.cat([X, U], -1).reshape(B, -1), obj=total / self.size,
            status=torch.ones(B, dtype=torch.int32),
            lam_def=(2.0 * U[:, :-1] * self.scale).reshape(B, -1),
            mu=torch.zeros(B, self.N + 1, dtype=x0.dtype))
'''
STUB_CONFIG = {
    "name": "stub2", "source": "a stub", "reduced": [], "entry": "psum_stub",
    "problem": {"nsteps": 10, "dt": 0.5, "x0": [0.0, 0.0], "xf": [5.0, 0.0],
                "xtol": [0.0, 0.0], "x_lower": [-1.0, -3.0],
                "x_upper": [7.0, 3.0], "u_lower": [-2.0, -2.0],
                "u_upper": [2.0, 2.0], "obstacle_centers": [],
                "obstacle_half": 0.5, "dynamics": "single_integrator",
                "scheme": "trapezoidal", "cost_weights": [1.0, 1.0]},
    "limits": {"defect": 1e-9, "bound": 1e-9, "obj_gap": 1e-12,
               "stationarity": 1e-9}}
STUB_TRAFFIC = {"loop": "fleet", "start": "cold", "batch": 4,
                "x0_offset": {"low": [-0.5, -0.5], "high": [0.5, 0.5]},
                "xf_offset": {"low": [-0.5, -0.5], "high": [0.5, 0.5]}}
#: seconds a program collective of the stub's runs waits
TIMEOUT = 5.0


def _stub_cell(checkout, **stub):
    checkout.add("entries/psum_stub.py", STUB_ENTRY)
    checkout.add_json("configs/stub2.json", dict(
        STUB_CONFIG, stub=dict(stub, log_dir=checkout.root)))
    checkout.add_json("traffic/stub_cold.json", STUB_TRAFFIC)
    checkout.add_entries(
        configs=[{"name": "stub2", "source": "a stub",
                  "file": "perfbench/configs/stub2.json", "reduced": [],
                  "why": "straight lines"}],
        workloads=[{"name": "stub2_cold", "config": "stub2",
                    "traffic": "stub_cold", "chips": 2,
                    "why": "two ranks, one psum an op"}])


def _run(checkout, seconds):
    """Rank 0 in a process of its own, as the benchmark's command: (exit
    code, its last stdout line or None, stderr, seconds it took)."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from perfbench import ranks\n"
            "line = ranks.run('stub2_cold', 2 ** 31 + 3, %r, False, 2, 'cpu',"
            " root=%r, timeout=%r)\n"
            "print(json.dumps(line))\n"
            % (ROOT, seconds, checkout.root, TIMEOUT))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=checkout.root,
                         timeout=seconds + TIMEOUT + ranks.GRACE_S + 60)
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    return out.returncode, line, out.stderr, time.monotonic() - t0


def _ops(checkout, rank):
    path = os.path.join(checkout.root, f"ops.{rank}")
    return open(path).read().splitlines() if os.path.exists(path) else []


def test_two_ranks_run_the_same_ops_and_print_one_line(checkout):
    _stub_cell(checkout)
    rc, line, err, _ = _run(checkout, 0.3)
    assert rc == 0, err[-3000:]
    assert line["correct"] and line["failed"] == 0, err[-3000:]
    assert line["device"]["count"] == 2
    # set-up's two batches and the window's, the same on both ranks, each
    # psum the sum of two ranks' costs
    ops = _ops(checkout, 0)
    assert len(ops) >= 3 and ops == _ops(checkout, 1)
    assert all(op.split()[2] == "2.0" for op in ops)
    assert line["attempted"] == 4 * (len(ops) - 2)
    assert "ranks [ops, their indices' digest" in err
    assert not os.listdir(os.path.join(checkout.root, "build", "perfbench"))
    assert checkout.edited() == []


def test_a_rank_that_raises_ends_the_run_on_both_in_time(checkout):
    # rank 1 raises in its third op of the window (after set-up's two)
    _stub_cell(checkout, raise_at_call=5, raise_rank=1)
    rc, line, err, took = _run(checkout, 30.0)
    # rank 0 waits the psum out (TIMEOUT) and the window ends at once,
    # long before its 30 s
    assert took < 30.0, err[-3000:]
    assert "a planted fault" in err
    if rc == 0:
        assert not line["correct"] and line["failed"] == 4, err[-3000:]
        assert line["attempted"] == 3 * 4
    else:
        assert line is None
    assert len(_ops(checkout, 1)) == 4
