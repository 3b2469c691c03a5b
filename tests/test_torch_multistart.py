"""Port parity: ``solve_multistart`` and ``solve_batched_rescue``. The
random draws differ between the packages by construction (``jax.random``
against a ``torch.Generator``), so the tests hand both the same numpy
bumps: the JAX package's own draws for its default key, which the port
takes through ``deltas=``."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carry_data
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.core.types import Status
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SOLVED, MAX_ITER = int(Status.SOLVED), int(Status.MAX_ITER)


def _jax_draws(n_starts, nx, spread=0.4):
    """The bumps ``jal.solve_multistart`` draws from its default key, as
    fractions of the state range."""
    return np.array(jax.random.uniform(
        jax.random.PRNGKey(0), (n_starts, nx), minval=-spread,
        maxval=spread))


@pytest.mark.parametrize("name", ["canonical_ocp_2d", "canonical_mip_2d"])
def test_guesses_from_handed_deltas_match(name):
    jv, jn = getattr(jproblems, name)()
    tv, tn = getattr(tproblems, name)()
    jd, td = carry_data(jv, tv)
    d = jn.dims
    n = 5
    u = _jax_draws(n, d.nx)
    # the reference's guess math (al_sqp.solve_multistart) on its package
    base = jn.initial_guess(jd).reshape(d.nodes, d.node_width)
    window = jnp.sin(jnp.pi * jnp.arange(d.nodes) / (d.nodes - 1))[:, None]
    deltas = (jnp.asarray(u) * (jd.x_ub - jd.x_lb)).at[0].set(0.0)
    want = jax.vmap(lambda dl: jnp.concatenate(
        [base[:, : d.nx] + window * dl, base[:, d.nx:]], axis=-1
    ).reshape(-1))(deltas)
    got = tal.multistart_guesses(tn, td, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # start 0 is the nominal guess, and every start keeps x0 and xf
    assert torch.equal(got[0], tn.initial_guess(td))
    G = got.reshape(n, d.nodes, d.node_width)
    np.testing.assert_allclose(G[:, 0, : d.nx].numpy(),
                               np.tile(td.x0.numpy(), (n, 1)), atol=1e-6)
    np.testing.assert_allclose(G[:, -1, : d.nx].numpy(),
                               np.tile(td.xf.numpy(), (n, 1)), atol=1e-6)
    # the shooting seed lands at index 1 % n_starts
    zs = torch.full((d.nz,), 7.0)
    with_seed = tal.multistart_guesses(tn, td, torch.from_numpy(u), zs)
    assert torch.equal(with_seed[1], zs)
    assert torch.equal(with_seed[[0, 2, 3, 4]], got[[0, 2, 3, 4]])
    one = tal.multistart_guesses(tn, td, torch.from_numpy(u[:1]), zs)
    assert torch.equal(one[0], zs)


def test_draw_deltas_ranges_and_host_default():
    g = torch.Generator().manual_seed(3)
    d = tal.draw_deltas(64, 2, 0.4, g, "cpu", torch.float32)
    assert d.shape == (64, 2) and float(d.abs().max()) <= 0.4
    assert float(d.min()) < -0.3 and float(d.max()) > 0.3
    g = torch.Generator().manual_seed(3)
    lanes = tal.draw_deltas(4, 2, 0.4, g, "cpu", torch.float32, lanes=16)
    assert lanes.shape == (16, 4, 2)
    assert torch.equal(lanes.reshape(64, 2), d)


def _result(obj, viol_eq, viol_in, status=None):
    """A synthetic SolveResult with scalar fields of obj's shape."""
    obj = torch.as_tensor(obj, dtype=torch.float32)
    shape = obj.shape

    def f(v):
        return torch.as_tensor(v, dtype=torch.float32).expand(shape).clone()

    status = (torch.full(shape, SOLVED) if status is None
              else torch.as_tensor(status)).to(torch.int32)
    zeros = torch.zeros(shape, dtype=torch.int32)
    return tal.SolveResult(
        z=obj[..., None] * torch.ones(3), obj=obj, status=status,
        outer_iters=zeros, inner_iters=zeros, viol_eq=f(viol_eq),
        viol_in=f(viol_in), grad_norm=f(0.0),
        lam_def=obj[..., None, None] * torch.ones(2, 1),
        lam_eq=torch.zeros(shape + (3, 0)),
        mu=torch.zeros(shape + (3, 1)), rho=f(10.0))


@pytest.mark.parametrize("obj,viol,maximize,want", [
    # the cheapest feasible start
    ([3.0, 1.0, 2.0], [0.0, 0.0, 0.0], False, 1),
    # an infeasible start ranks behind every feasible one
    ([3.0, 1.0, 2.0], [0.0, 5e-3, 0.0], False, 2),
    # a tie goes to the first
    ([2.0, 1.0, 1.0], [0.0, 0.0, 0.0], False, 1),
    # a NaN objective is last, even when "feasible"
    ([float("nan"), 4.0, 5.0], [0.0, 0.0, 0.0], False, 1),
    ([float("nan"), float("inf"), 5.0], [0.0, 0.0, 5e-3], False, 2),
    # maximize flips the sign
    ([3.0, 1.0, 2.0], [0.0, 0.0, 0.0], True, 0),
    # all infeasible: 1e9 swallows the objectives in float32, in both
    # packages, so the first start is kept
    ([3.0, 1.0, 2.0], [1.0, 1.0, 1.0], False, 0),
    # within 10 tol_cons counts as feasible
    ([3.0, 1.0, 2.0], [0.0, 9e-4, 0.0], False, 1),
])
def test_selection_rule(obj, viol, maximize, want):
    cfg = tal.SolverConfig()
    res = _result(obj, viol, 0.0)
    assert int(tal.select_best(res, cfg, maximize)) == want
    # the reference's rule on the same numbers (al_sqp.py, multistart)
    o, v = jnp.asarray(obj), jnp.asarray(viol)
    feas = (v <= 10.0 * cfg.tol_cons)
    sign = -1.0 if maximize else 1.0
    score = jnp.where(jnp.isfinite(o), sign * o, jnp.inf) + jnp.where(
        feas, 0.0, 1e9)
    assert int(jnp.argmin(score)) == want
    # per lane along the last axis
    two = _result([obj, obj[::-1]], [viol, viol[::-1]], 0.0)
    assert tal.select_best(two, cfg, maximize).shape == (2,)
    assert int(tal.select_best(two, cfg, maximize)[0]) == want


def test_rescue_merge_every_branch():
    """Lanes 1, 3, 4, 6 of seven were rescued. ok2 & ~ok1 adopts; both
    unsolved adopts only a lower violation; a solved phase-1 lane is
    never replaced, not even by a solved rescue."""
    res1 = _result(
        [10., 11., 12., 13., 14., 15., 16.],
        [0.0, 0.5, 0.0, 0.5, 0.5, 0.0, 0.0], 0.0,
        [SOLVED, MAX_ITER, SOLVED, MAX_ITER, MAX_ITER, SOLVED, SOLVED])
    idx = torch.tensor([1, 3, 4, 6])
    res2 = _result(
        [21., 23., 24., 26.], [0.0, 0.2, 0.9, 0.0], 0.0,
        [SOLVED, MAX_ITER, MAX_ITER, SOLVED])
    out = tal.rescue_merge(res1, res2, idx)
    assert out.obj.tolist() == [10., 21., 12., 23., 14., 15., 16.]
    assert out.status.tolist() == [SOLVED, SOLVED, SOLVED, MAX_ITER,
                                   MAX_ITER, SOLVED, SOLVED]
    np.testing.assert_allclose(out.viol_eq.numpy(),
                               [0.0, 0.0, 0.0, 0.2, 0.5, 0.0, 0.0])
    # every leaf moves with its lane
    assert out.z[:, 0].tolist() == out.obj.tolist()
    assert out.lam_def[:, 0, 0].tolist() == out.obj.tolist()
    # the violation compared is the larger of the two kinds
    res2b = dataclasses.replace(res2, viol_in=torch.tensor(
        [0.0, 0.6, 0.0, 0.0]))
    assert tal.rescue_merge(res1, res2b, idx).obj[3] == 13.0


def test_ocp_multistart_matches_and_meets_golden():
    """The contract of tests/test_golden.py through the port, with the
    reference's draws: status, objective (1e-3 relative) and the golden
    state error <= 1e-3 against the nearer basin."""
    fixtures = []
    for name in ("ocp_2d_ex1.csv", "ocp_2d_ex1_alt.csv"):
        path = os.path.join(GOLDEN, name)
        rows = np.loadtxt(path, delimiter=",", skiprows=2)
        with open(path) as fh:
            obj_g = float(fh.readline().split("obj=")[1].split(",")[0])
        fixtures.append((name, rows[:, 1:3], obj_g))
    jv, jn = jproblems.canonical_ocp_2d()
    tv, tn = tproblems.canonical_ocp_2d()
    jd, td = carry_data(jv, tv)
    jres = jal.solve_multistart(jn, jal.SolverConfig(), jd, 8)
    tres = tal.solve_multistart(
        tn, tal.SolverConfig(), td, 8,
        deltas=torch.from_numpy(_jax_draws(8, 2)))
    assert int(tres.status) == int(jres.status) == SOLVED
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    assert float(tres.viol_eq) <= 1e-4 and float(tres.viol_in) <= 1e-4
    assert tres.z.shape == (tn.dims.nz,) and tres.status.shape == ()
    X = tn.unpack(tres.z)[0].numpy()
    errs = {n: np.max(np.abs(X - Xg)) for n, Xg, _ in fixtures}
    name, _, obj_g = min(fixtures, key=lambda f: errs[f[0]])
    assert errs[name] <= 1e-3, errs
    assert float(tres.obj) == pytest.approx(obj_g, abs=2e-3)
    np.testing.assert_allclose(X, np.asarray(jn.unpack(jres.z)[0]),
                               atol=1e-3)


def test_mip_multistart_matches():
    jv, jn = jproblems.canonical_mip_2d()
    tv, tn = tproblems.canonical_mip_2d()
    jd, td = carry_data(jv, tv)
    # the user inequalities (4 rows a node) ride beside the obstacles
    m_eq, m_in = tal._result_sizes(tn, tal.tree_map(lambda a: a[None], td))
    assert (m_eq, m_in) == jal._result_sizes(jn, jd)
    jres = jal.solve_multistart(jn, jal.SolverConfig(), jd, 8)
    tres = tal.solve_multistart(
        tn, tal.SolverConfig(), td, 8,
        deltas=torch.from_numpy(_jax_draws(8, 2)))
    assert int(tres.status) == int(jres.status) == SOLVED
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    assert float(tres.viol_eq) <= 1e-4 and float(tres.viol_in) <= 1e-4


def test_multistart_default_draws_are_the_hosts():
    """With no generator the bumps are drawn on the host from seed 0: a
    call is reproducible, and the same as handing that generator in."""
    tv, tn = tproblems.double_integrator_2d(nsteps=8)
    td, _ = tv.to_device(device="cpu")
    cfg = tal.SolverConfig(max_total=6)
    a = tal.solve_multistart(tn, cfg, td, 3, shooting_samples=16)
    b = tal.solve_multistart(tn, cfg, td, 3,
                             torch.Generator().manual_seed(0),
                             shooting_samples=16)
    assert torch.equal(a.z, b.z)
    c = tal.solve_multistart(tn, cfg, td, 3,
                             torch.Generator().manual_seed(1),
                             shooting_samples=16)
    assert c.z.shape == a.z.shape


def test_rescue_solves_what_a_tight_budget_left():
    """Phase 1 under a budget of 40 iterations leaves every lane of a
    small OCP fleet unsolved; the rescue takes the first rescue_lanes of
    them in stable order, re-solves them cold from 4 starts under the
    default config, and leaves the others an honest MAX_ITER."""
    tv, tn = tproblems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    B, M = 6, 2
    bd = tal.tree_map(lambda a: a[None].expand((B,) + tuple(a.shape)), td)
    off = np.array([[0.0, 0.0], [-0.05, -0.05], [-0.1, 0.1],
                    [-0.02, 0.03], [-0.08, -0.02], [-0.04, 0.08]],
                   np.float32)
    bd = dataclasses.replace(bd, x0=bd.x0 + torch.from_numpy(off))
    tight = tal.SolverConfig(max_total=40)
    res1 = tal.solve_batched(tn, tight, bd)
    assert res1.status.tolist() == [MAX_ITER] * B
    res = tal.solve_batched_rescue(
        tn, tight, bd, rescue_lanes=M, rescue_cfg=tal.SolverConfig())
    assert res.status.tolist() == [SOLVED] * M + [MAX_ITER] * (B - M)
    assert torch.equal(res.z[M:], res1.z[M:])
    assert float(torch.maximum(res.viol_eq, res.viol_in)[:M].max()) <= 1e-4
    assert 1.2 < float(res.obj[0]) < 1.8


def test_rescue_is_skipped_when_every_lane_solved(monkeypatch):
    """When phase 1 solves every lane, phase 2 still runs, as in the JAX
    package (its rescue is fixed-shape, with no host read to skip it),
    and adopts nothing: every field is phase 1's."""
    tv, tn = tproblems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    bd = tal.tree_map(lambda a: a[None].expand((2,) + tuple(a.shape)), td)
    res1 = tal.solve_batched(tn, tal.SolverConfig(), bd)
    assert res1.status.tolist() == [SOLVED] * 2
    ran = []
    steps = tal._multistart_steps

    def counted(*a, **kw):
        ran.append(a[2].x0.shape[0])
        return (yield from steps(*a, **kw))

    monkeypatch.setattr(tal, "_multistart_steps", counted)
    res = tal.solve_batched_rescue(tn, tal.SolverConfig(), bd,
                                   shooting_samples=16)
    assert ran == [1]  # phase 2 over M = max(1, 2 // 8) lanes
    for f in dataclasses.fields(res):
        assert torch.equal(getattr(res, f.name), getattr(res1, f.name)), f


def test_per_lane_shooting_units():
    """The rescue's seeds: with a lane axis every lane has draws of its
    own, and a lane handed the shared draws plans what the shared call
    plans for it."""
    from etol_tpu_torch.solve import shooting

    tv, tn = tproblems.canonical_ocp_2d()
    td, _ = tv.to_device(device="cpu")
    B, S, N = 3, 12, tn.dims.nsteps
    bd = tal.tree_map(lambda a: a[None].expand((B,) + tuple(a.shape)), td)
    bd = dataclasses.replace(bd, x0=bd.x0 + torch.tensor(
        [[0.0, 0.0], [-0.05, -0.05], [-0.1, 0.1]]))
    g = torch.Generator().manual_seed(5)
    shared = shooting.draw_units(S, N, 2, 0, 8, g, "cpu", torch.float32)
    g = torch.Generator().manual_seed(5)
    own = shooting.draw_units(S, N, 2, 0, 8, g, "cpu", torch.float32,
                              lanes=B)
    assert own[0].shape == (B, S, 1, 2) and own[1].shape == (B, S, N, 2)
    assert own[2] is None and not torch.equal(own[1][0], own[1][1])
    Xs, Us, _ = shooting.plan_from_units(tn.dynamics, bd, *shared)
    tiled = [a[None].expand((B,) + tuple(a.shape)) for a in shared[:2]]
    Xp, Up, _ = shooting.plan_from_units(tn.dynamics, bd, *tiled,
                                         per_lane=True)
    assert torch.equal(Xs, Xp) and torch.equal(Us, Up)
    z = shooting.plan_guess(tn, bd, S, torch.Generator().manual_seed(5),
                            per_lane=True)
    assert z.shape == (B, tn.dims.nz)
    np.testing.assert_allclose(z.reshape(B, N + 1, 4)[:, 0, :2].numpy(),
                               bd.x0.numpy())
