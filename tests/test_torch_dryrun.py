"""The port's multichip dry-run and ``cli fleet_batch`` on the CPU at small
sizes (the JAX package's dry-run is tests/test_parallel.py's last test).
A mesh of ``["cpu"] * 8`` is eight entries of one CPU: the batch chunks
that share it are solved as one batch, the horizon slabs are stacked on
it (parallel/axis.py::SlabAxis)."""
import torch

from etol_tpu_torch import cli
from etol_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)


def test_dryrun_multichip():
    # the K=512 stage cut to K=64 (8 slabs of 8 nodes) on the CPU
    out = dryrun_multichip(8, device="cpu", horizon_nsteps=63)
    assert out["mesh"] == {"batch": 4, "horizon": 2}
    assert out["statuses"] == [1] * 8 and out["warm_solved"] == 1.0
    assert out["horizon"]["sharded"]["status"] == 1
    assert out["horizon_dz"] < 2e-2


def test_cli_fleet_batch(capsys):
    assert cli.fleet_batch(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "devices: 1  batch: 4" in out
    solved = float(out.split("solved: ")[1].split("%")[0])
    assert solved >= 75.0, out
