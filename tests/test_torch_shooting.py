"""Port parity: shooting seeds. The deterministic parts (rollout,
collision test, walk scoring) get the same numpy-made controls in both
packages; the port's draws come from a torch.Generator and are not
compared with jax.random's.

Tolerance: rtol/atol 1e-5 on rollouts and scores — the same float32
midpoint steps, with sin/cos from two libms a few ulps apart, over 12
steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import vmap

from etol_tpu.models import dynamics as jdyn
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import shooting as jshoot
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import dynamics as tdyn
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import shooting as tshoot
from etol_tpu_torch.transcribe import obstacles as tobs

torch.set_num_threads(1)

KW = dict(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))


def _setup():
    jv, _ = jproblems.uas_2d(**KW)
    tv, tnlp = tproblems.uas_2d(**KW)
    jdata, _ = jv.to_device()
    tdata, _ = tv.to_device(device="cpu")
    return jdata, tdata, tnlp


def _controls(S=64, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(S, 1, 2)).astype(np.float32)
    steps = rng.uniform(size=(S, KW["nsteps"], 2)).astype(np.float32)
    return base, steps


def test_walk_rollout_collision_and_score_match():
    jdata, tdata, _ = _setup()
    base, steps = _controls()
    # the walk family from unit draws, as plan() scales them
    span = np.asarray(jdata.u_ub - jdata.u_lb)
    lb, ub = np.asarray(jdata.u_lb), np.asarray(jdata.u_ub)
    U = np.clip(lb + span * base
                + np.cumsum(-0.3 * span + 0.6 * span * steps, axis=1),
                lb, ub).astype(np.float32)
    Ut = tshoot._walk_controls(tdata, *map(torch.from_numpy, (base, steps)))
    np.testing.assert_allclose(Ut.numpy(), U, rtol=1e-5, atol=1e-5)

    X = jax.vmap(lambda u: jshoot.rollout(
        jdyn.unicycle, jdata.x0, u, jdata.dt, jdata))(U)
    Xt = vmap(lambda u: tshoot.rollout(
        tdyn.unicycle, tdata.x0, u, tdata.dt, tdata))(torch.from_numpy(U))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(X), rtol=1e-5,
                               atol=1e-5)

    ok = jax.vmap(lambda x: jshoot._collision_free(x, jdata.dt, jdata))(X)
    okt = vmap(lambda x: tshoot._collision_free(x, tdata.dt, tdata))(
        torch.tensor(np.asarray(X)))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(ok))
    assert 0 < int(np.asarray(ok).sum()) < len(U)  # both outcomes occur

    # the JAX plan()'s eval_one score, written out on its public parts
    in_box = jnp.all((X >= jdata.x_lb) & (X <= jdata.x_ub), axis=(1, 2))
    goal = jnp.sum((X[:, -1] - jdata.xf) ** 2, axis=-1)
    effort = jnp.mean(jnp.asarray(U) ** 2, axis=(1, 2))
    jscore = 10.0 * goal + 0.1 * effort + jnp.where(ok & in_box, 0.0, 1e6)
    tscore, _ = tshoot._score_rollouts(tdyn.unicycle, tdata,
                                       torch.from_numpy(U))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore),
                               rtol=1e-5, atol=1e-5)


def test_pulled_controls_stay_in_box():
    _, tdata, _ = _setup()
    g = torch.Generator().manual_seed(3)
    cand = torch.rand((4, KW["nsteps"], 8, 2), generator=g)
    jit = torch.randn((4, KW["nsteps"], 8), generator=g)
    U = tshoot._pulled_controls(tdyn.unicycle, tdata, cand, jit)
    assert U.shape == (4, KW["nsteps"], 2)
    assert bool(((U >= tdata.u_lb) & (U <= tdata.u_ub)).all())


def test_plan_guess_is_collision_free_and_in_bounds():
    _, tdata, tnlp = _setup()
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    batch = tproblem.batch_tile(tdata, 3)
    batch = dataclasses.replace(
        batch, x0=batch.x0 + torch.tensor([[0.0, 0, 0], [0.3, -0.2, 0],
                                           [-0.2, 0.4, 0]]))
    z = tshoot.plan_guess(tnlp, batch, 256, torch.Generator().manual_seed(0),
                          pulled=8)
    K, w = tnlp.dims.nodes, tnlp.dims.node_width
    assert z.shape == (3, K * w)
    Z = z.reshape(3, K, w)
    assert torch.allclose(Z[:, 0, :3], batch.x0)
    X = Z[..., :3]
    assert bool(((X >= batch.x_lb[:, None]) & (X <= batch.x_ub[:, None]))
                .all())
    U = Z[..., 3:]
    assert bool(((U >= batch.u_lb[:, None]) & (U <= batch.u_ub[:, None]))
                .all())
    for b in range(3):
        margins = vmap(lambda p: tobs.halfspace_margins(p, tdata.obstacles))(
            X[b, :, :2])
        assert float(margins.max()) <= 0.0
