"""Port parity: the side-branching branch-and-bound
(``etol_tpu_torch.solve.side_branch``) against ``etol_tpu.solve.side_branch``
on the CPU — the side rows under the solver's transforms, the box override
of the bounds, one padded wave of nodes, and whole searches whose outcome
and certificates must agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core.problem import VGP as JVGP
from etol_tpu.models import canonical_mip_2d as jcanonical_mip_2d
from etol_tpu.models import composed_exact_demo as jcomposed_exact_demo
from etol_tpu.models import dynamics as jdynamics
from etol_tpu.solve import al_sqp as jal
from etol_tpu.solve import side_branch as jsb
from etol_tpu.transcribe.nlp import NLP as JNLP
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.core.problem import VGP
from etol_tpu_torch.core.types import Status
from etol_tpu_torch.models import dynamics, problems
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import side_branch as tsb
from etol_tpu_torch.solve.branch_bound import integer_mask
from etol_tpu_torch.transcribe.nlp import NLP

from _torch_parity import carry_data, lane

torch.set_num_threads(1)


def _side_data_both(jd, td, selp, selt):
    return (jsb.SideData(jd, jnp.asarray(selp), jnp.asarray(selt)),
            tsb.SideData(td, torch.from_numpy(selp), torch.from_numpy(selt)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_side_rows_match_under_the_solver(seed):
    """The side rows at random positions and side assignments (drops,
    piece rows and track sides) on mip_2d_ex1 (3 pieces, 2 tracks): the
    NLP's rows, the solver's batched residuals and AL gradient."""
    jv, jn = jcanonical_mip_2d()
    tv, tn = problems.canonical_mip_2d()
    jd, td = carry_data(jv, tv)
    K, w = jn.dims.nodes, jn.dims.node_width
    P, H, _ = jd.obstacles.halfspaces.shape
    T = jd.tracks.xy.shape[0]
    assert (P, T) == (3, 2)
    rng = np.random.default_rng(seed)
    selp = rng.integers(-1, H, size=(K, P)).astype(np.int32)
    selt = rng.integers(-1, 4, size=(K, T)).astype(np.int32)
    assert (selp == -1).any() and (selt >= 0).any()
    Z = rng.uniform(0.0, 6.0, size=(K, w)).astype(np.float32)
    jsd, tsd = _side_data_both(jd, td, selp, selt)
    jb, tb = jsb.branch_nlp(jn), tsb.branch_nlp(tn)
    jg = np.asarray(jb.node_ineqs(jnp.asarray(Z.reshape(-1)), jsd))
    tg = tb.node_ineqs(torch.from_numpy(Z.reshape(-1)), tsd).numpy()
    assert jg.shape == tg.shape == (K, 4 + P + T)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    # dropped pairs report -1
    assert np.all(tg[:, 4:4 + P][selp < 0] == -1.0)

    F = tal._ALFuncs(tb, tal.SolverConfig(), lane(tsd))
    g = F.residuals(torch.from_numpy(Z)[None])[2][0].numpy()
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    m_eq, m_in = jal._result_sizes(jb, jsd)
    lam_def = rng.normal(size=(K - 1, jn.dims.nx)).astype(np.float32)
    lam_eq = np.zeros((K, m_eq), np.float32)
    mu = np.abs(rng.normal(size=(K, m_in))).astype(np.float32)
    rho = np.float32(100.0)
    JF = jal._ALFuncs(jb, jal.SolverConfig(), jsd)
    jgrad = np.asarray(JF.al_grad(*(jnp.asarray(a) for a in (
        Z, lam_def, lam_eq, mu, rho))))
    tgrad = F.al_grad(*(torch.from_numpy(np.asarray(a))[None] for a in (
        Z, lam_def, lam_eq, mu, rho)))[0].numpy()
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-5, atol=1e-4)


def test_box_override_intersects_the_bounds():
    """``_ALFuncs(..., box)``: the box intersected with the NLP bounds
    (param window pins included) before ``pinned`` — exactly JAX's."""
    jv, jn = jcomposed_exact_demo()
    tv, tn = problems.composed_exact_demo()
    jd, td = carry_data(jv, tv)
    K, w = jn.dims.nodes, jn.dims.node_width
    rng = np.random.default_rng(5)
    lo = np.full((K, w), -np.finfo(np.float32).max / 4, np.float32)
    hi = -lo
    lo[2, 4], hi[3, 4] = 1.0, 0.0          # boost forced on / off
    lo[4, 2] = hi[4, 2] = 0.25             # one control fixed
    hi[5, 0] = rng.uniform(1.0, 2.0)       # a state capped
    JF = jal._ALFuncs(jn, jal.SolverConfig(), jd,
                      box=(jnp.asarray(lo), jnp.asarray(hi)))
    TF = tal._ALFuncs(tn, tal.SolverConfig(), lane(td),
                      box=(torch.from_numpy(lo)[None],
                           torch.from_numpy(hi)[None]))
    for a, b in ((TF.lb, JF.lb), (TF.ub, JF.ub), (TF.pinned, JF.pinned)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    assert bool(TF.pinned[0, 4, 2]) and bool(TF.pinned[0, 3, 4])
    # without a box the bounds are the NLP's
    T0 = tal._ALFuncs(tn, tal.SolverConfig(), lane(td))
    lb, ub = tn.bounds(td)
    np.testing.assert_array_equal(T0.lb[0].reshape(-1).numpy(), lb.numpy())
    np.testing.assert_array_equal(T0.ub[0].reshape(-1).numpy(), ub.numpy())


def test_one_padded_wave_matches():
    """A wave of 5 children of the composed demo's root (mixed sides,
    boxes, the root's warm multipliers and penalty), padded to 8 lanes
    with copies of the first, through the port's batched solve and the
    JAX package's ``_wave_jit`` on the same numpy inputs."""
    jv, jn = jcomposed_exact_demo()
    tv, tn = problems.composed_exact_demo()
    jd, td = carry_data(jv, tv)
    K, w = jn.dims.nodes, jn.dims.node_width
    P, T = jd.obstacles.halfspaces.shape[0], jd.tracks.xy.shape[0]
    jb, tb = jsb.branch_nlp(jn), tsb.branch_nlp(tn)
    cfg_j, cfg_t = jal.SolverConfig(), tal.SolverConfig()
    # the root relaxation, cold, in the JAX package: the warm state
    root = jsb.SideData(jd, jnp.full((K, P), -1, jnp.int32),
                        jnp.full((K, T), -1, jnp.int32))
    lam0 = jal.init_multipliers(jb, root)
    rres = jal._solve_single(jb, cfg_j, root, jn.initial_guess(jd), lam0)
    z0 = np.asarray(rres.z)
    lam = [np.asarray(a) for a in (rres.lam_def, rres.lam_eq, rres.mu)]
    rho = float(rres.rho)

    big = np.finfo(np.float32).max / 4
    nodes = []
    for k, m, box in ((3, 0, None), (3, 1, None), (2, 2, "floor"),
                      (3, 3, "ceil"), (-1, 0, "ceil")):
        selp = np.full((K, P), -1, np.int32)
        if k >= 0:
            selp[k, 0] = m
            selp[k - 1, 0] = (m + 1) % 4
        lo = np.full((K, w), -big, np.float32)
        hi = np.full((K, w), big, np.float32)
        if box == "floor":
            hi[1:, 4] = 0.0
        elif box == "ceil":
            lo[1:, 4] = 1.0
        nodes.append((selp, np.full((K, T), -1, np.int32), lo, hi))
    W = 8
    nodes += [nodes[0]] * (W - len(nodes))

    def stk(i):
        return np.stack([n[i] for n in nodes])

    Z0 = np.stack([z0] * W)
    lams = [np.stack([a] * W) for a in lam]
    rhos = np.full((W,), rho, np.float32)

    jsd = jsb.SideData(jax.tree.map(lambda a: jnp.broadcast_to(
        a, (W,) + a.shape), jd), jnp.asarray(stk(0)), jnp.asarray(stk(1)))
    jres = jsb._wave_jit(jb, cfg_j, jsd, jnp.asarray(stk(2)),
                         jnp.asarray(stk(3)), jnp.asarray(Z0),
                         tuple(jnp.asarray(a) for a in lams),
                         jnp.asarray(rhos))
    tsd = tsb.SideData(tproblem.tree_map(
        lambda a: a.expand((W,) + tuple(a.shape)), td),
        torch.from_numpy(stk(0)), torch.from_numpy(stk(1)))
    tres = tal._solve_batch(
        tb, cfg_t, tsd, torch.from_numpy(Z0),
        tuple(torch.from_numpy(a) for a in lams), torch.from_numpy(rhos),
        (torch.from_numpy(stk(2)), torch.from_numpy(stk(3))))
    st_j = np.asarray(jres.status)
    st_t = tres.status.numpy()
    print("statuses", st_j.tolist(), st_t.tolist())
    print("iterations", np.asarray(jres.inner_iters).tolist(),
          tres.inner_iters.tolist())
    np.testing.assert_array_equal(st_t, st_j)
    assert (st_t == int(Status.SOLVED)).sum() >= 4
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj),
                               rtol=1e-4)
    # the padded lanes are the first node's solve again
    for i in range(5, W):
        assert torch.equal(tres.z[i], tres.z[0])
    # every lane stays inside its box
    Zt = tres.z.reshape(W, K, w).numpy()
    assert np.all(Zt >= stk(2) - 1e-6) and np.all(Zt <= stk(3) + 1e-6)


def _corridor(pkg_vgp, pkg_nlp, dyn):
    vgp = pkg_vgp(nsteps=6, dt=0.5)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [3.0, 0.0]
    vgp.xtol = [0.01, 0.01]
    vgp.xlower = [-1.0, -2.0]
    vgp.xupper = [4.0, 2.0]
    vgp.ulower = [-1.5, -1.5]
    vgp.uupper = [1.5, 1.5]
    vgp.add_exclusion_zone(
        [[1.2, -0.4], [1.8, -0.4], [1.8, 0.4], [1.2, 0.4]]
    )
    nlp = pkg_nlp(
        dims=vgp.dims(),
        dynamics=dyn.single_integrator,
        running_cost=lambda x, u, t, d: u[0] ** 2 + u[1] ** 2,
        scheme="euler",
        cost_form="sum",
    )
    return vgp, nlp


def _same_outcome(rt, rj, tol=1e-3):
    print(f"port: status {rt.status} certified {rt.certified} obj "
          f"{rt.obj} nodes {rt.nodes_solved} waves {rt.waves} trips "
          f"{rt.trips}; jax: status {rj.status} certified {rj.certified} "
          f"obj {rj.obj} nodes {rj.nodes_solved} waves {rj.waves}")
    assert rt.status == rj.status
    assert rt.certified == rj.certified
    assert rt.incumbent_found == rj.incumbent_found
    if rj.incumbent_found:
        assert rt.obj == pytest.approx(rj.obj, abs=tol)
    else:
        assert np.isnan(rt.obj) and np.isnan(rj.obj)


def test_exact_on_small_corridor_matches():
    """JAX's small blocked corridor (tests/test_golden.py): the tree
    closes, SOLVED, at JAX's objective; the goal is reached and no node
    lies inside the obstacle deeper than the search's inside_eps."""
    jv, jn = _corridor(JVGP, JNLP, jdynamics)
    tv, tn = _corridor(VGP, NLP, dynamics)
    jd, td = carry_data(jv, tv)
    rj = jsb.solve_exact(jn, jal.SolverConfig(), jd, wave=4, max_nodes=64)
    rt = tsb.solve_exact(tn, tal.SolverConfig(), td, wave=4, max_nodes=64)
    _same_outcome(rt, rj)
    assert rt.status == int(Status.SOLVED)
    X = rt.z.reshape(tn.dims.nodes, -1)[:, :2]
    assert np.max(np.abs(X[-1] - [3.0, 0.0])) <= 0.011
    eps = 2e-3
    inside = (
        (X[:, 0] > 1.2 + eps) & (X[:, 0] < 1.8 - eps)
        & (X[:, 1] > -0.4 + eps) & (X[:, 1] < 0.4 - eps)
    )
    assert not inside.any(), X


def _unreachable(pkg_vgp, pkg_nlp, dyn):
    vgp = pkg_vgp(nsteps=4, dt=0.5)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [10.0, 0.0]
    vgp.xtol = [0.01, 0.01]
    vgp.xlower = [-20.0, -20.0]
    vgp.xupper = [20.0, 20.0]
    vgp.ulower = [-0.5, -0.5]
    vgp.uupper = [0.5, 0.5]
    nlp = pkg_nlp(
        dims=vgp.dims(),
        dynamics=dyn.single_integrator,
        running_cost=lambda x, u, t, d: u[0] ** 2 + u[1] ** 2,
        scheme="euler",
        cost_form="sum",
        use_obstacles=False,
    )
    return vgp, nlp


@pytest.mark.parametrize("retries", [2, 0])
def test_infeasible_certificate_matches(retries):
    """A provably infeasible problem (goal 10 away, reach 1): with warm
    retries the stagnation certificate gives a certified INFEASIBLE;
    with none the node is dropped uncertified (MAX_ITER) — in both
    packages."""
    jv, jn = _unreachable(JVGP, JNLP, jdynamics)
    tv, tn = _unreachable(VGP, NLP, dynamics)
    jd, td = carry_data(jv, tv)
    rj = jsb.solve_exact(jn, jal.SolverConfig(max_total=150), jd, wave=2,
                         max_nodes=16, max_retries=retries)
    rt = tsb.solve_exact(tn, tal.SolverConfig(max_total=150), td, wave=2,
                         max_nodes=16, max_retries=retries)
    _same_outcome(rt, rj)
    assert not rt.incumbent_found
    if retries:
        assert rt.status == int(Status.INFEASIBLE) and rt.certified
    else:
        assert not rt.certified


def test_stagnation_counter_resets_on_improvement():
    assert tsb._next_stagn(0, True) == 1
    assert tsb._next_stagn(1, True) == 2
    s = 0
    for stagnant in (True, False, True):
        s = tsb._next_stagn(s, stagnant)
    assert s == 1
    for stagn, now in ((0, True), (3, False), (2, True)):
        assert tsb._next_stagn(stagn, now) == jsb._next_stagn(stagn, now)


def test_violations_is_the_references():
    """The host-side disjunction test on random trajectories of
    mip_2d_ex1 (pieces and tracks, with some pairs already assigned)."""
    jv, _ = jcanonical_mip_2d()
    jd, dims = jv.to_device()
    K = dims.nodes
    hs = np.asarray(jd.obstacles.halfspaces)
    P, T = hs.shape[0], jd.tracks.xy.shape[0]
    rng = np.random.default_rng(0)
    for _ in range(20):
        Z2 = rng.uniform(1.5, 4.0, size=(K, 2))
        centers = rng.uniform(1.0, 4.0, size=(K, T, 2))
        selp = rng.integers(-1, 2, size=(K, P)).astype(np.int8)
        selt = rng.integers(-1, 2, size=(K, T)).astype(np.int8)
        args = (Z2, hs, np.asarray(jd.obstacles.hs_mask),
                np.asarray(jd.obstacles.piece_mask), centers,
                np.asarray(jd.tracks.radius), np.asarray(jd.tracks.mask),
                selp, selt, 1e-3)
        assert tsb._violations(*args) == jsb._violations(*args)


def test_side_data_reads_like_its_base_and_maps_over_lanes():
    """A SideData lane keeps its side arrays through ``map_lanes`` (the
    tree is rebuilt in its own structure) and forwards reads to base."""
    tv, tn = problems.composed_exact_demo()
    td, dims = tv.to_device(device="cpu")
    K = dims.nodes
    sd = tsb.SideData(td, torch.full((K, 1), 2, dtype=torch.int32),
                      torch.full((K, 1), -1, dtype=torch.int32))
    assert sd.x0 is td.x0 and sd.obstacles is td.obstacles
    batch = tproblem.tree_map(lambda a: a.expand((3,) + tuple(a.shape)), sd)
    out = tproblem.map_lanes(
        lambda d: (d.sel_piece.sum() + d.sel_track.sum(), d.x0.sum()), batch)
    assert out[0].tolist() == [K, K, K]
    with pytest.raises(ValueError, match="too many leaves"):
        tproblem.tree_unflatten(td, tproblem.tree_flatten(sd))
    assert integer_mask(tv).tolist() == [False] * 4 + [True]


def test_float64_search_keeps_off_the_kernel(monkeypatch):
    """A float64 problem's waves take cyclic reduction under
    ``kkt_solver="kernel"`` (chosen from the dtype up front): its blocks
    never reach the float32 kernel's wrapper."""
    from etol_tpu_torch.ops import bt_cuda, cyclic_reduction

    def refuse(*a, **kw):
        raise AssertionError("float64 blocks reached the kernel's wrapper")

    monkeypatch.setattr(bt_cuda, "solve", refuse)
    tv, tn = _corridor(VGP, NLP, dynamics)
    td, _ = tv.to_device(dtype=torch.float64, device="cpu")
    before = cyclic_reduction.TALLY.count
    rt = tsb.solve_exact(tn, tal.SolverConfig(), td, wave=4, max_nodes=64)
    assert rt.status == int(Status.SOLVED) and rt.z.dtype == np.float64
    assert cyclic_reduction.TALLY.count - before == rt.trips > 0
