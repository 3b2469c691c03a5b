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


def _leaves_equal(jdata, tdata):
    jl = jax.tree.leaves(jdata)
    tl = tproblem.tree_flatten(tdata)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["ocp_2d_ex1.xml", "mip_2d_ex1.xml"])
def test_xml_problem_leaves_match_exactly(name):
    """A problem loaded from XML (static zones and moving tracks) freezes
    to the same leaves in both packages, and the JAX leaves carry over."""
    import pathlib

    from etol_tpu.core import xml_io as jxml
    from etol_tpu_torch.core import xml_io as txml

    root = pathlib.Path(__file__).resolve().parent.parent
    jv = jxml.load_configs(str(root / "etol_tpu" / "configs" / name))
    tv = txml.load_configs(str(root / "etol_tpu_torch" / "configs" / name))
    jdata, jdims = jv.to_device()
    tdata, tdims = tv.to_device(device="cpu")
    assert dataclasses.asdict(jdims) == dataclasses.asdict(tdims)
    assert tdims.max_tracks == 2
    _leaves_equal(jdata, tdata)
    _leaves_equal(jdata, tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu"))


def test_param_problem_leaves_match_exactly():
    """Param columns (sorted by name) with their windows, padded tracks,
    and a lane axis: the leaves carry over one for one."""
    from etol_tpu.core import types as jtypes
    from etol_tpu_torch.core import types as ttypes

    def build(pkg, ty):
        vgp, _ = pkg.uas_2d(nsteps=6)
        vgp.add_params({
            "s": ty.ParamConfig(ty.VarType.CONTINUOUS, 0.0, 10.0, 0.5, 2.0),
            "b": ty.ParamConfig(ty.VarType.BINARY, 0.0, 1.0, 0.0, 3.0),
        })
        vgp.add_track(0.4, [0.0, 2.0, 3.0], [[1.0, 1.0], [2.0, 1.0],
                                             [2.0, 2.0]])
        return vgp

    jv, tv = build(jproblems, jtypes), build(tproblems, ttypes)
    jdata, jdims = jv.to_device(jv.dims(pad_tracks=3, pad_waypoints=4))
    tdata, tdims = tv.to_device(tv.dims(pad_tracks=3, pad_waypoints=4),
                                device="cpu")
    assert dataclasses.asdict(jdims) == dataclasses.asdict(tdims)
    assert tdims.n_params == 2 and tdims.node_width == 7
    _leaves_equal(jdata, tdata)
    assert tdata.p_lb.tolist() == [0.0, 0.0]      # b, then s
    assert tdata.p_ub.tolist() == [1.0, 10.0]
    assert tdata.p_window.tolist() == [[0.0, 3.0], [0.5, 2.0]]
    rebuilt = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(
            jproblem.batch_tile(jdata, 3))], device="cpu")
    _leaves_equal(jproblem.batch_tile(jdata, 3), rebuilt)
    assert rebuilt.p_window.shape == (3, 2, 2)
