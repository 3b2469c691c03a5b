"""Port parity: trajectory helpers and the CSV export. Seeded numpy
trajectories go through the JAX package's functions and the port's."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import trajectory as jtraj
from etol_tpu_torch.core import trajectory as ttraj

torch.set_num_threads(1)


def _traj(seed=0, K=7, d=3):
    rng = np.random.default_rng(seed)
    times = np.arange(K, dtype=np.float32) * 0.5
    values = rng.normal(size=(K, d)).astype(np.float32)
    return times, values


def _both(times, values):
    return ((torch.from_numpy(times), torch.from_numpy(values)),
            (jnp.asarray(times), jnp.asarray(values)))


@pytest.mark.parametrize("idxs", [[0, 2], [3, 1], [1]])
def test_extract(idxs):
    tt, jt = _both(*_traj())
    _, tv = ttraj.extract(tt, idxs)
    _, jv = jtraj.extract(jt, idxs)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


@pytest.mark.parametrize("entries", [[2.0], [1.0, -3.0, 0.5],
                                     [1.0, 2.0, 3.0, 4.0]])
def test_scale_and_offset(entries):
    tt, jt = _both(*_traj(seed=1))
    for name in ("scale", "offset"):
        _, tv = getattr(ttraj, name)(tt, entries)
        _, jv = getattr(jtraj, name)(jt, entries)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        assert tv.dtype == torch.float32


def test_linear_interpolation_matches():
    rng = np.random.default_rng(2)
    tvec = np.cumsum(rng.uniform(0.1, 1.0, size=6)).astype(np.float32)
    ref = rng.normal(size=(6, 2)).astype(np.float32)
    tval = np.linspace(tvec[0] - 1.0, tvec[-1] + 1.0, 23).astype(np.float32)
    got = ttraj.linear_interpolation(
        torch.from_numpy(tval), torch.from_numpy(tvec),
        torch.from_numpy(ref))
    want = jtraj.linear_interpolation(tval, tvec, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_save_writes_the_same_file(tmp_path):
    times, values = _traj(seed=3)
    tt, jt = _both(times, values)
    tp = ttraj.save(tt, str(tmp_path / "t.csv"))
    jp = jtraj.save(jt, str(tmp_path / "j.csv"))
    text = open(tp).read()
    assert text == open(jp).read()
    assert text.splitlines()[0] == "time,traj0,traj1,traj2"
    assert len(text.splitlines()) == 1 + len(times)


def test_save_increments_and_loads_back(tmp_path):
    times, values = _traj(seed=4)
    tt, _ = _both(times, values)
    first = ttraj.save(tt, str(tmp_path / "run.csv"))
    second = ttraj.save(tt, str(tmp_path / "run.csv"))
    third = ttraj.save(tt, str(tmp_path / "run.csv"))
    assert [os.path.basename(p) for p in (first, second, third)] == [
        "run.csv", "run1.csv", "run2.csv"]
    assert ttraj._increment_path(str(tmp_path / "run2.csv")) == \
        jtraj._increment_path(str(tmp_path / "run2.csv"))
    t_back, v_back = ttraj.load_csv(third)
    jt_back, jv_back = jtraj.load_csv(third)
    np.testing.assert_allclose(t_back.numpy(), np.asarray(jt_back))
    np.testing.assert_allclose(v_back.numpy(), np.asarray(jv_back))
    np.testing.assert_allclose(v_back.numpy(), values, atol=1e-6)
    np.testing.assert_allclose(t_back.numpy(), times, atol=1e-6)


def test_save_takes_numpy_times_and_refuses_empty(tmp_path, capsys):
    times, values = _traj(seed=5)
    # the facade hands host times beside device states
    p = ttraj.save((times, torch.from_numpy(values)),
                   str(tmp_path / "mixed.csv"))
    assert len(open(p).read().splitlines()) == 1 + len(times)
    empty = str(tmp_path / "empty.csv")
    assert ttraj.save((torch.zeros(0), torch.zeros((0, 2))), empty) == empty
    assert not os.path.exists(empty)
    assert "No Data to Save" in capsys.readouterr().out
