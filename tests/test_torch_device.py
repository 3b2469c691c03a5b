"""The port's entry points run on the card unless the caller asks for the
CPU: called without a device where there is no card they raise a
RuntimeError that names CUDA (no quiet step down to the CPU), and with
``device="cpu"`` they run."""
import numpy as np
import pytest
import torch

from etol_tpu_torch import bench_harness
from etol_tpu_torch.core import device as tdevice
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems

torch.set_num_threads(1)

NSTEPS = 6


def _leaves():
    vgp, _ = tproblems.uas_2d(nsteps=NSTEPS)
    data, _ = vgp.to_device(device="cpu")
    return [a.numpy() for a in tproblem.tree_flatten(data)]


ENTRY_POINTS = {
    "resolve": lambda **kw: tdevice.resolve(**kw),
    "to_device": lambda **kw: tproblems.uas_2d(nsteps=NSTEPS)[0].to_device(
        **kw)[0].x0.device,
    "vgpdata_from_numpy": lambda **kw: tproblem.vgpdata_from_numpy(
        _leaves(), **kw).x0.device,
    "prepare": lambda **kw: bench_harness.prepare(
        2, NSTEPS, **kw)[3].x0.device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu") == torch.device("cpu")


def test_main_path_default_device_is_the_card():
    if torch.cuda.is_available():
        out = bench_harness.main_path(2, NSTEPS)
        assert out["data"].x0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_harness.main_path(2, NSTEPS)


def test_main_path_runs_on_the_cpu_when_asked():
    out = bench_harness.main_path(2, NSTEPS, device="cpu")
    z = out["warm"]["result"].z
    assert z.device.type == "cpu"
    assert z.shape == (2, out["nlp"].dims.nz)
    assert bool(torch.isfinite(z).all())


def test_prepare_batch_is_on_the_given_device():
    nlp, cfg, stages, data, gen = bench_harness.prepare(3, NSTEPS, "cpu",
                                                        seed=1)
    assert gen.device == torch.device("cpu")
    assert data.x0.shape == (3, 3)
    assert all(a.device.type == "cpu" for a in tproblem.tree_flatten(data))
    assert np.isfinite(data.x0.numpy()).all()
