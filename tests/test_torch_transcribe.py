"""Port parity: transcription. The same numpy-made points, nodes and
steps go through the JAX package's functions and the PyTorch port's.

Tolerance: rtol 1e-5 (atol 1e-5 for values near zero) — both sides
evaluate the same float32 formulas, and the only differences are the
order of float32 sums and the libm each framework calls for
sin/cos/exp/log, a few ulps apart."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from etol_tpu.models import dynamics as jdyn
from etol_tpu.models import problems as jproblems
from etol_tpu.transcribe import collocation as jcol
from etol_tpu.transcribe import obstacles as jobs
from etol_tpu_torch.models import dynamics as tdyn
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.transcribe import collocation as tcol
from etol_tpu_torch.transcribe import obstacles as tobs

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _setup(form="pieces", nsteps=12):
    jv, jnlp = jproblems.uas_2d(nsteps=nsteps, dt=0.4, xf=(4.0, 3.0, 0.0))
    tv, tnlp = tproblems.uas_2d(nsteps=nsteps, dt=0.4, xf=(4.0, 3.0, 0.0))
    jnlp = dataclasses.replace(jnlp, obstacle_form=form)
    tnlp = dataclasses.replace(tnlp, obstacle_form=form)
    jdata, _ = jv.to_device()
    tdata, _ = tv.to_device(device="cpu")
    return jnlp, jdata, tnlp, tdata


def _close(t, j):
    np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL
    )


def _points(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 7.0, size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("scheme", ["hermite_simpson", "trapezoidal",
                                    "euler"])
def test_step_defect(scheme):
    rng = np.random.default_rng(1)
    x0, x1 = rng.normal(size=(2, 32, 3)).astype(np.float32)
    u0, u1 = rng.normal(size=(2, 32, 2)).astype(np.float32)
    t0 = rng.uniform(0, 5, size=32).astype(np.float32)
    j = jax.vmap(lambda a, b, c, d, t: jcol.step_defect(
        jdyn.unicycle, a, b, c, d, t, 0.2, None, scheme))(
            x0, u0, x1, u1, t0)
    t = vmap(lambda a, b, c, d, tt: tcol.step_defect(
        tdyn.unicycle, a, b, c, d, tt, 0.2, None, scheme))(
            *map(torch.from_numpy, (x0, u0, x1, u1, t0)))
    _close(t, j)


def test_piece_values_and_halfspace_margins():
    jnlp, jdata, tnlp, tdata = _setup()
    P = _points()
    for jf, tf in ((jobs.piece_values, tobs.piece_values),
                   (jobs.halfspace_margins, tobs.halfspace_margins),
                   (jobs.ellipse_values, tobs.ellipse_values)):
        j = jax.vmap(lambda p: jf(p, jdata.obstacles))(P)
        t = vmap(lambda p: tf(p, tdata.obstacles))(torch.from_numpy(P))
        _close(t, j)


@pytest.mark.parametrize("form", ["pieces", "both"])
def test_collision_values_cached(form):
    jnlp, jdata, tnlp, tdata = _setup(form)
    P = _points(seed=2)
    jtc = jnlp.track_center_table(jdata)
    ttc = tnlp.track_center_table(tdata)
    _close(ttc, jtc)
    j = jax.vmap(lambda p: jobs.collision_values_cached(
        p, jtc[0], jdata.obstacles, jdata.tracks, form))(P)
    t = vmap(lambda p: tobs.collision_values_cached(
        p, ttc[0], tdata.obstacles, tdata.tracks, form))(
            torch.from_numpy(P))
    _close(t, j)
    # the uncached form agrees with the cached one
    t2 = vmap(lambda p: tobs.collision_values(
        p, torch.tensor(0.0), tdata.obstacles, tdata.tracks, form))(
            torch.from_numpy(P))
    _close(t2, np.asarray(j))


def test_node_cost_and_node_ineq():
    jnlp, jdata, tnlp, tdata = _setup()
    K, w = jnlp.dims.nodes, jnlp.dims.node_width
    rng = np.random.default_rng(3)
    Z = rng.uniform(-1, 5, size=(K, w)).astype(np.float32)
    ks = np.arange(K)
    j = jax.vmap(lambda zn, k: jnlp.node_cost(zn, k, jdata))(Z, ks)
    t = vmap(lambda zn, k: tnlp.node_cost(zn, k, tdata))(
        torch.from_numpy(Z), torch.from_numpy(ks))
    _close(t, j)
    j = jax.vmap(lambda zn, k: jnlp.node_ineq(zn, k, jdata))(Z, ks)
    t = vmap(lambda zn, k: tnlp.node_ineq(zn, k, tdata))(
        torch.from_numpy(Z), torch.from_numpy(ks))
    _close(t, j)
    j = jax.vmap(lambda a, b, k: jnlp.step_defect(a, b, k, jdata))(
        Z[:-1], Z[1:], ks[:-1])
    t = vmap(lambda a, b, k: tnlp.step_defect(a, b, k, tdata))(
        torch.from_numpy(Z[:-1]), torch.from_numpy(Z[1:]),
        torch.from_numpy(ks[:-1]))
    _close(t, j)
    _close(tnlp.score(torch.from_numpy(Z.reshape(-1)), tdata),
           jnlp.score(jnp.asarray(Z.reshape(-1)), jdata))


def test_bounds_and_scales():
    jnlp, jdata, tnlp, tdata = _setup()
    for jb, tb in zip(jnlp.bounds(jdata), tnlp.bounds(tdata)):
        _close(tb, jb)
    _close(tnlp.variable_scales(tdata), jnlp.variable_scales(jdata))
    _close(tnlp.defect_scales(tdata), jnlp.defect_scales(jdata))


def test_unported_options_raise():
    _, tnlp = tproblems.uas_2d(nsteps=4)
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tnlp, x_delay=1)
    with pytest.raises(NotImplementedError):
        tcol.step_defect(tdyn.unicycle, *([torch.zeros(3)] * 4), 0.0, 0.1,
                         None, "radau")
