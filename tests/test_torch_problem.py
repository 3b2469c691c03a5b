"""Port parity: problem data. The PyTorch package's ``uas_2d`` ->
``to_device`` must give the JAX package's leaves exactly (both pad and
round the same float64 host arrays to float32), and
``vgpdata_from_numpy`` must rebuild the port's VGPData from the JAX
leaves."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems

torch.set_num_threads(1)


def _both(**kw):
    jv, jnlp = jproblems.uas_2d(**kw)
    tv, tnlp = tproblems.uas_2d(**kw)
    jdata, jdims = jv.to_device()
    tdata, tdims = tv.to_device(device="cpu")
    return jdata, jdims, tdata, tdims, jnlp, tnlp


@pytest.mark.parametrize("nsteps", [12, 50])
def test_uas_to_device_leaves_match_exactly(nsteps):
    jdata, jdims, tdata, tdims, _, _ = _both(nsteps=nsteps)
    assert dataclasses.asdict(jdims) == dataclasses.asdict(tdims)
    jl = jax.tree.leaves(jdata)
    tl = tproblem.tree_flatten(tdata)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_vgpdata_from_numpy_equals_to_device():
    jdata, _, tdata, _, _, _ = _both()
    rebuilt = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu"
    )
    for a, b in zip(tproblem.tree_flatten(rebuilt),
                    tproblem.tree_flatten(tdata)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tproblem.vgpdata_from_numpy(
            [np.asarray(a) for a in jax.tree.leaves(jdata)] + [np.zeros(1)],
            device="cpu",
        )


def test_stack_and_batch_tile():
    jdata, _, tdata, _, _, _ = _both(nsteps=12)
    tiled = tproblem.batch_tile(tdata, 3)
    jtiled = jproblem.batch_tile(jdata, 3)
    for a, b in zip(jax.tree.leaves(jtiled), tproblem.tree_flatten(tiled)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    stacked = tproblem.stack([tdata, tdata])
    assert stacked.x0.shape == (2, 3)
    assert stacked.obstacles.halfspaces.shape[0] == 2


def test_initial_guess_matches():
    # linspace and arctan2 round alike within one f32 ulp
    jdata, _, tdata, _, jnlp, tnlp = _both(nsteps=12, dt=0.4,
                                           xf=(4.0, 3.0, 0.0))
    z = tnlp.initial_guess(tdata)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jnlp.initial_guess(jdata)), rtol=1e-6,
        atol=1e-6,
    )
    X, U = tnlp.unpack(z)
    assert X.shape == (13, 3) and U.shape == (13, 2)
    assert torch.equal(tnlp.pack(X, U), z)
