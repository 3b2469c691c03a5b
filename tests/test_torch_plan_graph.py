"""The seeds and the planners as programs of ``solve/trip_graph.py``, on the
CPU.

A card captures ``shooting.plan_from_units``, ``planners.plan_cem_from_
normals`` and the tree (``planners.plan_tree_from_draws`` over every
trip's staged draws) once per key and replays each from static buffers;
here the same static path runs the body on its buffers without a capture
(``trip_graph.override("static")``). Held, for the seeds (shared and
per-lane draws, with and without pulled rollouts), CEM and each of the
five tree rules:

* (a) a body reads nothing on the host: no ``.item()`` or ``bool()`` of
  a tensor (a 0-dim tensor used as an index is one), no ``nonzero``, no
  tensor made from Python data, no copy across devices;
* (b) the static route gives bitwise the eager route's result, and two
  calls of one key with other data and another generator each give their
  own eager result (nothing stale is left in a buffer);
* (c) a changed key field (``goal_weight``, ``per_lane``, ``select``)
  makes a new entry and an unchanged one does not; the CPU without an
  override runs eagerly and makes none;
* (d) through the static route the JAX package's draws still give the JAX
  package's seeds, CEM and trees, within the tolerances of
  ``tests/test_torch_shooting.py`` and ``tests/test_torch_planners.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.models import problems as jproblems
from etol_tpu.solve import planners as jpl
from etol_tpu.solve import shooting as jshoot
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import planners, shooting, trip_graph
from _torch_parity import HostReads
from test_torch_planners import TOL, _both, jax_cem_normals, jax_tree_draws
from test_torch_shooting import _reference_units

torch.set_num_threads(1)

KW = dict(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))
B = 3
SEEDS = {
    "seeds": {},
    "seeds_pulled": dict(pulled=4),
    "seeds_per_lane": dict(per_lane=True),
    "seeds_per_lane_pulled": dict(pulled=4, per_lane=True),
}
BODIES = list(SEEDS) + ["CEM"] + list(planners.PLANNERS)


def _run(body, seed=0, shift=0.0, **kw):
    """``body``'s entry point (``shooting.plan`` for the seeds over B
    lanes, ``planners.plan`` for the rest) on uas_2d of 12 steps, its
    start moved by ``shift``, with draws from ``seed``."""
    vgp, nlp = tproblems.uas_2d(**KW)
    data, _ = vgp.to_device(device="cpu")
    data = dataclasses.replace(
        data, x0=data.x0 + torch.tensor([shift, -shift, 0.0]))
    gen = torch.Generator().manual_seed(seed)
    if body in SEEDS:
        lanes = tproblem.batch_tile(data, B)
        lanes = dataclasses.replace(lanes, x0=lanes.x0 + torch.tensor(
            [[0.0, 0.0, 0.0], [0.3, -0.2, 0.0], [-0.2, 0.4, 0.0]]))
        return shooting.plan(nlp.dynamics, KW["nsteps"], lanes, 64, gen,
                             **SEEDS[body], **kw)
    if body == "CEM":
        return planners.plan(body, nlp.dynamics, KW["nsteps"], data, 128,
                             gen, n_elite=16, **kw)
    return planners.plan(body, nlp.dynamics, KW["nsteps"], data, 256, gen,
                         batch=16, **kw)


def _leaves(out):
    return tproblem.tree_flatten(out)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("body", BODIES)
def test_body_reads_nothing_on_the_host(body, monkeypatch):
    """The body of the static route, as the graph captures it, under a
    dispatch mode that records host reads and transfers: none."""
    step = trip_graph._Program.step
    seen = []

    def recorded(self):
        with HostReads() as mode:
            out = step(self)
        seen.append(mode.seen)
        return out

    monkeypatch.setattr(trip_graph._Program, "step", recorded)
    with trip_graph.override("static"):
        _run(body)
    assert seen == [[]]


@pytest.mark.parametrize("body", BODIES)
def test_static_route_is_the_eager_route(body):
    """Bitwise the eager route's X, U and every info tensor, on a key's
    first call and on a second call with other data and other draws,
    which gives a result of its own."""
    with trip_graph.override("eager"):
        eager = [_run(body), _run(body, seed=1, shift=0.2)]
    assert not _equal(eager[0], eager[1])
    trip_graph._CACHE.clear()
    before = trip_graph.COUNTS["programs"]
    with trip_graph.override("static"):
        static = [_run(body), _run(body, seed=1, shift=0.2)]
    assert len(trip_graph._CACHE) == 1
    assert trip_graph.COUNTS["programs"] - before == 2
    for a, b in zip(eager, static):
        assert len(_leaves(a)) == len(_leaves(b)) >= 3
        assert _equal(a, b)


def test_key_fields_make_new_entries():
    """A call with other data and draws reuses its key's entry; another
    goal weight, per-lane draws or another tree rule makes a new one. The
    CPU without an override takes the eager route and makes no entry."""
    trip_graph._CACHE.clear()
    _run("seeds")
    assert len(trip_graph._CACHE) == 0
    calls = [
        (("seeds",), {}, 1),
        (("seeds",), dict(seed=1, shift=0.2), 1),
        (("seeds",), dict(goal_weight=5.0), 2),
        (("seeds_per_lane",), {}, 3),
        (("RRT",), {}, 4),
        (("RRT",), dict(seed=2, shift=0.1), 4),
        (("RRT",), dict(goal_weight=5.0), 5),
        (("EST",), {}, 6),
        (("CEM",), {}, 7),
        (("CEM",), dict(seed=1), 7),
    ]
    with trip_graph.override("static"):
        for args, kw, entries in calls:
            _run(*args, **kw)
            assert len(trip_graph._CACHE) == entries, (args, kw)


def _static(fn, *args, **kw):
    with trip_graph.override("static"):
        return fn(*args, **kw)


def _seeds_parity():
    """``tests/test_torch_shooting.py``'s shared-draw parity: the JAX
    ``plan(key=None)``'s unit draws give its per-lane seeds."""
    S, P, nb = 48, 6, 4
    jv, jnlp = jproblems.uas_2d(**KW)
    tv, tnlp = tproblems.uas_2d(**KW)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    jdata, _ = jv.to_device()
    tdata, _ = tv.to_device(device="cpu")
    shift = (np.random.default_rng(5).uniform(-0.4, 0.4, size=(nb, 3))
             * [1, 1, 0]).astype(np.float32)
    jbatch = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (nb,) + a.shape), jdata)
    jbatch = dataclasses.replace(jbatch, x0=jbatch.x0 + shift)
    tbatch = tproblem.batch_tile(tdata, nb)
    tbatch = dataclasses.replace(
        tbatch, x0=tbatch.x0 + torch.from_numpy(shift))
    _, _, jinfo = jax.vmap(lambda d: jshoot.plan(
        jnlp.dynamics, KW["nsteps"], d, S, None, pulled=P))(jbatch)
    jz = jax.vmap(lambda d: jshoot.plan_guess(jnlp, d, S, pulled=P))(jbatch)
    units = _reference_units(S, P, KW["nsteps"])
    tX, tU, tinfo = _static(trip_graph.program, shooting.plan_from_units,
                            tnlp.dynamics, tbatch, *units)
    tz = torch.cat([tX, tU], dim=-1).reshape(nb, -1)
    jscores = np.asarray(jinfo["scores"])
    free = jscores < 1e5
    assert free.any(axis=1).all()
    np.testing.assert_array_equal(tinfo["scores"].numpy() < 1e5, free)
    np.testing.assert_allclose(tinfo["scores"].numpy()[free], jscores[free],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tinfo["best"].numpy(),
                                  np.asarray(jinfo["best"]))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=2e-4)


def _cem_parity():
    """``tests/test_torch_planners.py``'s CEM parity on uas_2d."""
    jdata, jf, tdata, tf, dims = _both("uas")
    key, S = jax.random.PRNGKey(0), 256
    JX, JU, ji = jpl._plan_cem(jf, dims.nsteps, jdata, S, key)
    eps = jax_cem_normals(key, S, dims.nsteps, dims.nu)
    TX, TU, ti = _static(trip_graph.program, planners.plan_cem_from_normals,
                         tf, dims.nsteps, tdata, eps)
    np.testing.assert_allclose(float(ti["best_score"]),
                               float(ji["best_score"]), rtol=TOL)
    np.testing.assert_allclose(ti["round_best"].numpy(),
                               np.asarray(ji["round_best"]), rtol=1e-4)
    assert bool(ti["valid"]) == bool(ji["valid"])
    np.testing.assert_allclose(TX.numpy(), np.asarray(JX), atol=TOL)
    np.testing.assert_allclose(TU.numpy(), np.asarray(JU), atol=TOL)


def _tree_parity(name, M=128, batch=16):
    """``tests/test_torch_planners.py``'s tree parity on uas_2d, the
    draws staged whole as a card stages them."""
    jdata, jf, tdata, tf, dims = _both("uas")
    key = jax.random.PRNGKey(3)
    JX, JU, ji = jpl._plan_tree(jf, dims.nsteps, jdata, M, key,
                                select=name, batch=batch)
    trip_graph._CACHE.clear()
    TX, TU, ti = _static(planners.run_tree, tf, dims.nsteps, tdata,
                         jax_tree_draws(key, name, M, jdata, batch), M,
                         select=name, batch=batch)
    assert len(trip_graph._CACHE) == 1  # the tree ran as a program
    for k in ("best", "n_nodes", "n_pruned", "best_depth"):
        assert int(ti[k]) == int(ji[k]), k
    assert np.array_equal(ti["depth"].numpy(), np.asarray(ji["depth"]))
    assert np.array_equal(ti["cell_priority"].numpy(),
                          np.asarray(ji["cell_priority"]))
    np.testing.assert_allclose(ti["witness_cost"].numpy(),
                               np.asarray(ji["witness_cost"]), atol=TOL)
    np.testing.assert_allclose(ti["cost"].numpy(), np.asarray(ji["cost"]),
                               atol=TOL)
    np.testing.assert_allclose(TX.numpy(), np.asarray(JX), atol=TOL)
    np.testing.assert_allclose(TU.numpy(), np.asarray(JU), atol=TOL)


@pytest.mark.parametrize("body", ["seeds", "CEM"] + list(planners.PLANNERS))
def test_static_route_keeps_the_reference_parity(body):
    if body == "seeds":
        _seeds_parity()
    elif body == "CEM":
        _cem_parity()
    else:
        _tree_parity(body)
