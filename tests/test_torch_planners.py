"""Port parity: the named sampling planners (eOMPL parity: RRT/SST/EST/
KPIECE/PDST, plus CEM and SHOOTING).

The behaviour tests mirror ``tests/test_planners.py`` on
``etol_tpu_torch`` with its own ``torch.Generator`` draws. The parity
tests hand the port's deterministic bodies the JAX package's own draws,
remade from its key splits (:func:`jax_tree_draws`, :func:`jax_cem_normals`,
themselves held against ``jax.random.categorical`` on the same keys),
and require the JAX package's tree: the same best node, node, pruning and
depth counts and PDST priorities exactly; witness costs, node costs and
the returned X and U within 1e-5 (float32 sums of the same terms, and
sin/cos from two libms a few ulps apart for the unicycle)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core.problem import VGP as JVGP
from etol_tpu.models import dynamics as jdyn
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import planners as jpl
from etol_tpu_torch import TrajectoryOptimizer
from etol_tpu_torch.core.problem import VGP
from etol_tpu_torch.models import dynamics
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import al_sqp, planners, shooting
from etol_tpu_torch.transcribe import obstacles as obs_mod

torch.set_num_threads(1)

TOL = 1e-5


def _problem(cls=VGP):
    vgp = cls(nsteps=16, dt=0.25)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [3.0, 2.5]
    vgp.xtol = [0.3, 0.3]
    vgp.xlower = [-5.0, -5.0]
    vgp.xupper = [5.0, 5.0]
    vgp.ulower = [-2.0, -2.0]
    vgp.uupper = [2.0, 2.0]
    vgp.add_exclusion_zone(
        [[1.2, 0.8], [1.8, 0.8], [1.8, 1.6], [1.2, 1.6]]
    )
    return vgp


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _data():
    data, dims = _problem().to_device(device="cpu")
    return data, dims


_SIZES = {"PDST": 512, "SST": 512, "RRT": 256, "EST": 512,
          "KPIECE": 512, "CEM": 256, "SHOOTING": 512}


@pytest.mark.parametrize("name", planners.PLANNERS + planners.EXTRA_PLANNERS)
def test_each_planner_progresses_to_goal(name):
    data, dims = _data()
    X, U, info = planners.plan(
        name, dynamics.single_integrator, dims.nsteps, data,
        n_samples=_SIZES[name], generator=_gen(3),
    )
    assert X.shape == (dims.nodes, dims.nx)
    assert U.shape == (dims.nodes, dims.nu)
    assert bool(torch.isfinite(X).all())
    # strictly closer to the goal than the start (weak but universal)
    d0 = float(torch.linalg.norm(data.x0 - data.xf))
    dN = float(torch.linalg.norm(X[-1] - data.xf))
    assert dN < 0.5 * d0, f"{name}: {dN} vs start {d0}"


@pytest.mark.parametrize("name", ["SHOOTING", "CEM"])
def test_batch_planners_reach_goal_collision_free(name):
    data, dims = _data()
    X, U, info = planners.plan(
        name, dynamics.single_integrator, dims.nsteps, data,
        n_samples=1024, generator=_gen(0),
    )
    ts = torch.arange(dims.nodes, dtype=X.dtype) * data.dt
    g = torch.stack([
        obs_mod.collision_values(x[:2], t, data.obstacles, data.tracks)
        for x, t in zip(X, ts)])
    assert float(g.max()) <= 1e-5
    assert float(torch.linalg.norm(X[-1] - data.xf)) < 0.6


def test_tree_planner_grows_tree():
    data, dims = _data()
    X, U, info = planners.plan(
        "RRT", dynamics.single_integrator, dims.nsteps, data,
        n_samples=128, generator=_gen(1), batch=16,
    )
    assert int(info["n_nodes"]) > 10  # the tree actually grew
    assert int(info["best_depth"]) > 0


def test_sst_witness_pruning_sparsifies():
    """Witness cells keep only their locally-cheapest node: dominated
    nodes are pruned, the active set is sparser than RRT's, and every
    finite witness cost is some live node's cost."""
    data, dims = _data()
    _, _, info_sst = planners.plan(
        "SST", dynamics.single_integrator, dims.nsteps, data,
        n_samples=512, generator=_gen(5),
    )
    _, _, info_rrt = planners.plan(
        "RRT", dynamics.single_integrator, dims.nsteps, data,
        n_samples=512, generator=_gen(5),
    )
    assert int(info_sst["n_pruned"]) > 0
    assert int(info_sst["n_nodes"]) < int(info_rrt["n_nodes"])
    wc = info_sst["witness_cost"].numpy()
    live_costs = info_sst["cost"].numpy()[info_sst["scores"].numpy() < np.inf]
    finite = wc[np.isfinite(wc)]
    assert finite.size > 0
    for c in finite:
        assert np.any(np.abs(live_costs - c) < 1e-5), c


def test_pdst_priority_schedule_advances():
    """Selected cells double in priority: after growth the priorities are
    non-uniform exact powers of two, spread over many cells."""
    data, dims = _data()
    _, _, info = planners.plan(
        "PDST", dynamics.single_integrator, dims.nsteps, data,
        n_samples=512, generator=_gen(4),
    )
    prio = info["cell_priority"].numpy()
    assert prio.max() >= 4.0
    lg = np.log2(prio)
    assert np.allclose(lg, np.round(lg), atol=1e-6)
    assert (prio > 1.0).sum() >= 8


def test_unknown_planner_raises():
    data, dims = _data()
    with pytest.raises(ValueError):
        planners.plan("PRM*", dynamics.single_integrator, dims.nsteps, data)


def _facade(vgp):
    opt = TrajectoryOptimizer(device="cpu")
    opt.vgp = vgp
    opt.set_dynamics(dynamics.single_integrator)
    opt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    return opt


def test_optimizer_facade_set_planner_and_plan():
    """eOMPL-as-backend flow: set_planner -> setup -> plan -> getters."""
    opt = _facade(_problem())
    opt.set_planner("SST")
    opt.setup()
    res = opt.plan(n_samples=512, generator=_gen(0))
    assert res.z.shape == (opt.dims.nz,)
    ts, Xt = opt.get_xtraj()
    assert Xt.shape == (opt.dims.nodes, 2)
    with pytest.raises(ValueError):
        opt.set_planner("nope")


def test_solve_time_budget_semantics(monkeypatch):
    """eOMPL solve-budget parity: the budget maps deterministically onto
    an extension count; a starved budget gives the approximate-solution
    status (MAX_ITER), the problem-derived default (nsteps * dt = 4 s ->
    8192 samples) reaches the goal band collision-free (SOLVED).

    The default budget's search is handed the JAX package's draws of its
    own test's key (PRNGKey(7), remade as unit draws): 8192 random walks
    reach this tight band for some draws and not others — the port's own
    seeds 0-19 reach it 5 times and the JAX package's keys 0-19 9 times,
    seed 7 of the port's not among them."""
    assert planners.budget_samples(0.001) == 64
    assert planners.budget_samples(1e9) == 65536
    assert planners.budget_samples(4.0) == 8192
    assert planners.budget_samples(0.5) < planners.budget_samples(4.0)

    vgp = _problem()
    vgp.xtol = [0.1, 0.1]  # tight band: luck can't close a tiny search
    opt = _facade(vgp)
    opt.setup()
    res_short = opt.plan(solve_time=0.001, generator=_gen(7))
    assert int(res_short.status) == 2  # MAX_ITER
    S = planners.budget_samples(4.0)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(7), 3)
    units = (_np(jax.random.uniform(k1, (S, 1, 2))),
             _np(jax.random.uniform(k2, (S, 16, 2))), None, None)
    monkeypatch.setattr(shooting, "draw_units", lambda *a, **kw: units)
    res_full = opt.plan()
    assert int(res_full.status) == 1  # SOLVED


# ---------------------------------------------------------------------------
# parity with the JAX package, given its draws
# ---------------------------------------------------------------------------


def _np(a):
    return torch.from_numpy(np.array(a))


def jax_tree_draws(key, select, n_samples, jdata, batch=64, ext_max=4):
    """The draws ``etol_tpu.solve.planners._plan_tree`` makes from
    ``key``, trip by trip, as the port's bodies take them: the categorical
    parent choice as its Gumbel noise (``jax.random.categorical`` is the
    argmax of logits plus ``gumbel(key, [batch, M])``)."""
    M, batch, n_iters = planners.tree_shape(n_samples, batch)
    nx, nu = jdata.x0.shape[0], jdata.u_lb.shape[0]
    dt = jdata.x0.dtype
    out = []
    for k in jax.random.split(key, n_iters):
        kt, kp, ku, ke = jax.random.split(k, 4)
        d = {}
        if select in ("RRT", "SST"):
            d["tgt"] = jax.random.uniform(kt, (batch, nx), dt, jdata.x_lb,
                                          jdata.x_ub)
            d["goal_u"] = jax.random.uniform(kp, (batch, 1))[:, 0]
        else:
            d["gumbel"] = jax.random.gumbel(kt, (batch, M), dt)
            d["goal_u"] = jax.random.uniform(kp, (batch,))
        d["u"] = jax.random.uniform(ku, (batch, nu), dt, jdata.u_lb,
                                    jdata.u_ub)
        d["elen"] = jax.random.randint(ke, (batch,), 1, ext_max + 1)
        out.append({name: _np(a) for name, a in d.items()})
    return out


def jax_cem_normals(key, n_samples, nsteps, nu, n_rounds=8):
    return _np(np.stack([
        np.asarray(jax.random.normal(k, (n_samples, nsteps, nu), jnp.float32))
        for k in jax.random.split(key, n_rounds)]))


def test_jax_draws_are_the_references_categorical_choices():
    """The Gumbel noise of a trip's key, argmax'd with logits, gives
    ``jax.random.categorical`` on that key in both of the JAX package's
    call forms: a shared [1, M] row with ``shape=(batch,)`` (EST, KPIECE)
    and a [batch, M] matrix (PDST, rows masked to -inf outside a cell)."""
    M, batch = 96, 16
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(11)
    jdata, _ = _problem(JVGP).to_device()
    draws = jax_tree_draws(key, "EST", M, jdata, batch)[0]
    n_iters = planners.tree_shape(M, batch)[2]
    kt, kp, ku, ke = jax.random.split(jax.random.split(key, n_iters)[0], 4)
    g = draws["gumbel"].numpy()
    row = rng.normal(size=(1, M)).astype(np.float32)
    want = jax.random.categorical(kt, row, axis=1, shape=(batch,))
    assert np.array_equal(np.argmax(row + g, axis=1), np.asarray(want))
    mat = np.where(rng.random((batch, M)) < 0.1, 0.0, -np.inf).astype(
        np.float32)
    mat[:, 0] = 0.0
    want = jax.random.categorical(kt, mat, axis=1)
    assert np.array_equal(np.argmax(mat + g, axis=1), np.asarray(want))
    # the port's body takes the uniforms and lengths as the trip makes them
    assert np.array_equal(draws["elen"].numpy(), np.asarray(
        jax.random.randint(ke, (batch,), 1, 5)))
    assert np.array_equal(draws["u"].numpy(), np.asarray(jax.random.uniform(
        ku, (batch, 2), jnp.float32, jdata.u_lb, jdata.u_ub)))


def _uas(nsteps=20):
    jv, _ = jproblems.uas_2d(nsteps=nsteps)
    tv, tnlp = tproblems.uas_2d(nsteps=nsteps)
    return (jv, jdyn.unicycle), (tv, dynamics.unicycle)


def _both(problem):
    if problem == "small":
        j, t = (_problem(JVGP), jdyn.single_integrator), (
            _problem(), dynamics.single_integrator)
    else:
        j, t = _uas()
    jdata, dims = j[0].to_device()
    tdata, _ = t[0].to_device(device="cpu")
    return jdata, j[1], tdata, t[1], dims


# (problem, capacity, extensions a trip)
_PARITY = [("small", 256, 32), ("uas", 128, 16)]


@pytest.mark.parametrize("problem,M,batch", _PARITY)
@pytest.mark.parametrize("name", planners.PLANNERS)
def test_tree_matches_the_reference_given_its_draws(name, problem, M, batch):
    jdata, jf, tdata, tf, dims = _both(problem)
    key = jax.random.PRNGKey(3)
    JX, JU, ji = jpl._plan_tree(jf, dims.nsteps, jdata, M, key,
                                select=name, batch=batch)
    TX, TU, ti = planners.plan_tree_from_draws(
        tf, dims.nsteps, tdata, jax_tree_draws(key, name, M, jdata, batch),
        M, select=name, batch=batch)
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
    if name == "SST":
        assert int(ti["n_pruned"]) > 0
    if name == "PDST":
        assert float(ti["cell_priority"].max()) >= 4.0


@pytest.mark.parametrize("problem", ["small", "uas"])
def test_cem_matches_the_reference_given_its_normals(problem):
    jdata, jf, tdata, tf, dims = _both(problem)
    key = jax.random.PRNGKey(0)
    S = 256
    JX, JU, ji = jpl._plan_cem(jf, dims.nsteps, jdata, S, key)
    eps = jax_cem_normals(key, S, dims.nsteps, dims.nu)
    TX, TU, ti = planners.plan_cem_from_normals(tf, dims.nsteps, tdata, eps)
    np.testing.assert_allclose(float(ti["best_score"]),
                               float(ji["best_score"]), rtol=TOL)
    np.testing.assert_allclose(ti["round_best"].numpy(),
                               np.asarray(ji["round_best"]), rtol=1e-4)
    assert bool(ti["valid"]) == bool(ji["valid"])
    np.testing.assert_allclose(TX.numpy(), np.asarray(JX), atol=TOL)
    np.testing.assert_allclose(TU.numpy(), np.asarray(JU), atol=TOL)


def test_planner_seeded_solve():
    """``plan_guess(planner=...)`` packs the planner's rollout as z, and
    the AL-SQP solves from it (the facade's NLP of the small problem)."""
    opt = _facade(_problem())
    opt.setup()
    z0 = planners.plan_guess(opt.nlp, opt.data, 256, _gen(0), planner="RRT")
    X, U, _ = planners.plan("RRT", opt.nlp.dynamics, opt.dims.nsteps,
                            opt.data, 256, _gen(0))
    assert torch.equal(z0, opt.nlp.pack(X, U))
    res = al_sqp.solve(opt.nlp, al_sqp.SolverConfig(), opt.data, z0)
    assert int(res.status) == 1


def test_sst_stops_on_uas_as_the_reference():
    """On uas_2d SST's witness cells (a 16-cell grid over the 40 x 40
    box: 2.5 wide) are wider than one extension (at most 4 steps of
    0.2 s at speed 2), so no child leaves its parent's cell cheaper than
    the cell's champion: the tree stops at the root and the champions of
    the two cells beside it and makes no progress to the goal — in the
    JAX package as in the port, given its draws. (The card's run holds
    SST on uas_2d to this invariant instead of the progress test.)"""
    jv, _ = jproblems.uas_2d(nsteps=50)
    tv, _ = tproblems.uas_2d(nsteps=50)
    jdata, dims = jv.to_device()
    tdata, _ = tv.to_device(device="cpu")
    key, M = jax.random.PRNGKey(0), 2048
    JX, _, ji = jpl._plan_tree(jdyn.unicycle, 50, jdata, M, key,
                               select="SST")
    TX, _, ti = planners.plan_tree_from_draws(
        dynamics.unicycle, 50, tdata, jax_tree_draws(key, "SST", M, jdata),
        M, select="SST")
    for k in ("best", "n_nodes", "n_pruned", "best_depth"):
        assert int(ti[k]) == int(ji[k]), k
    cells = int(torch.isfinite(ti["witness_cost"]).sum())
    assert int(ti["n_nodes"]) == 1 + cells <= 3
    d0 = float(torch.linalg.norm(tdata.x0 - tdata.xf))
    assert float(torch.linalg.norm(TX[-1] - tdata.xf)) > 0.5 * d0
    np.testing.assert_allclose(TX.numpy(), np.asarray(JX), atol=TOL)
