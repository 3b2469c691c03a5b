"""Port parity: the ``TrajectoryOptimizer`` facade, mirroring
``tests/test_optimizer.py`` on ``etol_tpu_torch`` with ``device="cpu"``
and holding the converged outcomes against the JAX facade's on the same
shipped XML."""
import numpy as np
import pytest
import torch

import etol_tpu
import etol_tpu_torch
from etol_tpu.models import dynamics as jdynamics
from etol_tpu_torch import TrajectoryOptimizer
from etol_tpu_torch.core import trajectory
from etol_tpu_torch.core.types import Status
from etol_tpu_torch.models import dynamics
from etol_tpu_torch.solve import al_sqp, planners

torch.set_num_threads(1)


def _cost(x, u, t, d):
    return u[0] ** 2 + u[1] ** 2


def _facade(pkg, dyn, xml, **kw):
    topt = pkg.TrajectoryOptimizer(**kw)
    topt.load_configs(xml)
    topt.set_dynamics(dyn.single_integrator)
    topt.set_objective(_cost)
    topt.setup()
    return topt


@pytest.fixture(scope="module")
def solved_opt(ocp_xml):
    topt = _facade(etol_tpu_torch, dynamics, ocp_xml, device="cpu")
    topt.solve()
    return topt


@pytest.fixture(scope="module")
def jax_solved(ocp_xml):
    topt = _facade(etol_tpu, jdynamics, ocp_xml)
    topt.solve()
    return topt


def test_package_surface():
    for name in etol_tpu.__all__:
        assert name in etol_tpu_torch.__all__, name
        getattr(etol_tpu_torch, name)
    assert etol_tpu_torch.TrajectoryOptimizer is TrajectoryOptimizer
    with pytest.raises(AttributeError):
        etol_tpu_torch.no_such_name


def test_lifecycle_matches(solved_opt, jax_solved):
    topt = solved_opt
    assert topt.get_status() == Status.SOLVED
    assert int(jax_solved.get_status()) == int(Status.SOLVED)
    assert 1.2 < topt.get_score() < 1.8
    np.testing.assert_allclose(topt.get_score(), jax_solved.get_score(),
                               rtol=1e-3)
    assert float(topt.result.viol_eq) <= 1e-4
    assert float(topt.result.viol_in) <= 1e-4
    times, X = topt.get_xtraj()
    _, U = topt.get_utraj()
    assert X.shape == (33, 2) and U.shape == (33, 2)
    assert float(times[-1]) == pytest.approx(16.0)
    np.testing.assert_allclose(X[-1].numpy(), [5.0, 4.0], atol=0.011)
    np.testing.assert_allclose(
        X.numpy(), np.asarray(jax_solved.get_xtraj()[1]), atol=2e-3)
    out = topt.debug()
    assert "status=SOLVED" in out and "nodes=33" in out
    assert "device=cpu" in out and "dtype=float32" in out
    assert topt.last_solve_seconds > 0.0


def test_save_csv_and_load_back(solved_opt, tmp_path):
    times, X = solved_opt.get_xtraj()
    p = solved_opt.save((times, X), str(tmp_path / "x.csv"))
    rows = open(p).read().strip().splitlines()
    assert rows[0].startswith("time,") and len(rows) == 34
    t_back, X_back = trajectory.load_csv(p)
    np.testing.assert_allclose(X_back.numpy(), X.numpy(), atol=1e-6)
    np.testing.assert_allclose(t_back.numpy(), times.numpy(), atol=1e-6)
    xml = solved_opt.save_configs(str(tmp_path / "saved.xml"))
    assert xml.startswith("<?xml") and (tmp_path / "saved.xml").exists()


def test_mpc_step(solved_opt):
    topt = solved_opt
    _, X = topt.get_xtraj()
    cold_iters = int(topt.result.inner_iters)
    t_before = topt.data.tracks.times.clone()
    res = topt.mpc_step(X[1].numpy())
    assert int(res.status) == int(Status.SOLVED)
    # warm: clearly fewer inner iterations than cold
    assert int(res.inner_iters) < max(cold_iters, 30)
    # the track clock moved by one step, and x0 is the new start
    np.testing.assert_allclose(
        topt.data.tracks.times.numpy(), t_before.numpy() - 0.5, atol=1e-6)
    np.testing.assert_allclose(topt.data.x0.numpy(), X[1].numpy())
    assert topt.vgp.x0 == pytest.approx(X[1].tolist())
    # a second step takes a tensor as it comes out of get_xtraj
    _, X = topt.get_xtraj()
    res = topt.mpc_step(X[1])
    assert int(res.status) == int(Status.SOLVED)
    np.testing.assert_allclose(
        topt.data.tracks.times.numpy(), t_before.numpy() - 1.0, atol=1e-6)


def test_mpc_step_matches_the_reference(ocp_xml, jax_solved):
    """One step from the same solved state in both packages."""
    topt = _facade(etol_tpu_torch, dynamics, ocp_xml, device="cpu")
    topt.solve()
    x1 = np.asarray(jax_solved.get_xtraj()[1][1])
    jres = jax_solved.mpc_step(x1)
    tres = topt.mpc_step(x1)
    assert int(tres.status) == int(jres.status) == int(Status.SOLVED)
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    # advance_time=False leaves the track clock where it is
    clock = topt.data.tracks.times.clone()
    topt.mpc_step(topt.get_xtraj()[1][1], advance_time=False)
    assert torch.equal(topt.data.tracks.times, clock)
    with pytest.raises(ValueError, match="solve"):
        _facade(etol_tpu_torch, dynamics, ocp_xml,
                device="cpu").mpc_step(x1)


def test_setup_requires_callbacks(ocp_xml):
    topt = TrajectoryOptimizer(device="cpu")
    topt.load_configs(ocp_xml)
    with pytest.raises(ValueError, match="set_dynamics"):
        topt.setup()
    topt.set_dynamics(dynamics.single_integrator)
    with pytest.raises(ValueError, match="set_objective"):
        topt.setup()
    with pytest.raises(ValueError, match="setup"):
        topt.solve()
    with pytest.raises(ValueError, match="setup"):
        topt.solve_batch(x0=np.zeros((2, 2)))


def test_default_device_is_the_card(ocp_xml):
    """Without a device the facade runs on the card; where there is none
    setup() raises and names CUDA."""
    topt = TrajectoryOptimizer()
    topt.load_configs(ocp_xml)
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(_cost)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.setup()


def test_close(solved_opt):
    solved = solved_opt
    solved.close()
    assert solved.result is None and solved.batch_result is None
    solved.set_x0([1.0, 2.0])  # the canonical start (mpc moved it)
    solved.solve()
    assert solved.get_status() == Status.SOLVED
    warm = solved.solve(warm=True)
    assert int(warm.status) == int(Status.SOLVED)
    assert int(warm.inner_iters) < 30


def test_solve_batch(solved_opt):
    topt = solved_opt
    # stay clear of track mexz0 (center (1.51, 2), r=0.5 at t=0): +x
    # offsets from x0=(1,2) start inside the moving obstacle
    x0 = topt.data.x0.numpy()[None, :] + np.array(
        [[0.0, 0.0], [-0.05, -0.05], [-0.1, 0.1]], dtype=np.float32)
    res = topt.solve_batch(x0=x0)
    assert res.z.shape[0] == 3
    assert res.status.tolist() == [int(Status.SOLVED)] * 3
    assert topt.batch_result is res and topt.result is not res
    float(topt.get_score())  # the scalar lifecycle is untouched
    res2 = topt.solve_batch(x0=torch.from_numpy(x0 + 0.01), warm=True)
    assert res2.status.tolist() == [int(Status.SOLVED)] * 3
    warm_mean = float(res2.inner_iters.float().mean())
    cold_mean = float(res.inner_iters.float().mean())
    assert warm_mean < max(0.8 * cold_mean, 30.0)
    with pytest.warns(UserWarning, match="falling back to cold"):
        res3 = topt.solve_batch(x0=x0[:2], warm=True, rescue=False)
    assert res3.z.shape[0] == 2
    with pytest.raises(ValueError, match="x0/xf"):
        topt.solve_batch()
    # a batched data with xf on top
    data = etol_tpu_torch.batch_tile(topt.data, 2)
    res4 = topt.solve_batch(data=data, xf=np.array(
        [[5.0, 4.0], [5.0, 4.0]], np.float32), rescue=False)
    assert res4.status.tolist() == [int(Status.SOLVED)] * 2


def test_rescue_default_cold_rescues_warm_skips(solved_opt, monkeypatch):
    topt = solved_opt
    calls = []
    monkeypatch.setattr(
        al_sqp, "solve_batched_rescue",
        lambda *a, **kw: calls.append("rescue") or al_sqp.solve_batched(
            a[0], a[1], a[2], kw["z0"], kw["lam0"], kw["rho0"]))
    cfg, topt.config = topt.config, al_sqp.SolverConfig(max_total=3)
    try:
        x0 = topt.data.x0.numpy()[None, :].repeat(2, 0)
        topt.solve_batch(x0=x0)
        topt.solve_batch(x0=x0, warm=True)
        topt.solve_batch(x0=x0, warm=True, rescue=True)
    finally:
        topt.config = cfg
    assert calls == ["rescue", "rescue"]


def test_planner_names_are_checked(solved_opt):
    solved_opt.set_planner("rrt")  # a known name is accepted, and runs
    res = solved_opt.plan(n_samples=8)
    assert res.z.shape == (solved_opt.dims.nz,)
    assert bool(torch.isfinite(res.z).all())
    with pytest.raises(ValueError, match="unknown planner"):
        solved_opt.set_planner("dijkstra")
    with pytest.raises(ValueError, match="unknown planner"):
        planners.plan("dijkstra", None, 1, solved_opt.data)
    solved_opt.set_planner("shooting")


def test_facade_solve_exact():
    """MILP-backend parity on the facade (as tests/test_optimizer.py):
    ``solve_exact()`` runs the certified branch-and-bound, stores the
    MIPResult, and the scalar lifecycle (get_score/get_xtraj/save) works
    on the incumbent trajectory."""
    from etol_tpu_torch.models import problems

    vgp, nlp = problems.composed_exact_demo()
    topt = TrajectoryOptimizer(device="cpu")
    topt.vgp = vgp
    topt.nlp = nlp
    topt.data, topt.dims = vgp.to_device(device="cpu")
    mres = topt.solve_exact(wave=8, max_nodes=384, convex_relaxation=True)
    print(f"facade solve_exact: obj {mres.obj:.6f}, {mres.nodes_solved} "
          f"nodes, {mres.waves} waves, {mres.trips} trips, "
          f"{topt.last_solve_seconds:.1f} s")
    assert mres.certified and mres.status == int(Status.SOLVED)
    assert topt.mip_result is mres
    assert topt.get_status() == Status.SOLVED
    assert topt.get_score() == pytest.approx(mres.obj, abs=1e-6)
    assert mres.obj == pytest.approx(8.44876, abs=1e-3)
    ts, X = topt.get_xtraj()
    assert X.shape == (topt.dims.nodes, 2) and ts.shape == (7,)
    assert float(topt.result.viol_in) == 0.0


def test_facade_solve_exact_without_an_incumbent():
    """A search that finds nothing leaves infinite violations in the
    installed result, so it never reads as a feasible solve."""
    vgp = etol_tpu_torch.VGP(nsteps=4, dt=0.5)
    vgp.x0, vgp.xf, vgp.xtol = [0.0, 0.0], [10.0, 0.0], [0.01, 0.01]
    vgp.xlower, vgp.xupper = [-20.0, -20.0], [20.0, 20.0]
    vgp.ulower, vgp.uupper = [-0.5, -0.5], [0.5, 0.5]
    topt = TrajectoryOptimizer(al_sqp.SolverConfig(max_total=150),
                               device="cpu")
    topt.vgp = vgp
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(_cost, form="sum")
    topt.set_scheme("euler")
    topt.setup()
    mres = topt.solve_exact(wave=2, max_nodes=16, max_retries=0)
    assert not mres.incumbent_found and not mres.certified
    assert topt.get_status() == Status.MAX_ITER
    assert float(topt.result.viol_eq) == float("inf")
    assert topt.result.z.shape == (topt.dims.nz,)


def test_plan_packs_a_rollout(solved_opt):
    topt = solved_opt
    res = topt.plan(n_samples=256)
    assert res.z.shape == (topt.dims.nz,)
    assert int(res.status) in (int(Status.SOLVED), int(Status.MAX_ITER))
    assert int(res.inner_iters) == 0 and float(res.viol_eq) == 0.0
    assert res.mu.shape == topt.batch_result.mu.shape[1:]
    _, X = topt.get_xtraj()
    np.testing.assert_allclose(X[0].numpy(), topt.data.x0.numpy())
    # the budget dial, as the reference maps it
    from etol_tpu.solve import planners as jplanners

    for secs in (0.001, 1.0, 16.0, 1e3):
        assert planners.budget_samples(secs) == jplanners.budget_samples(
            secs)
    assert planners.PLANNERS == jplanners.PLANNERS
    assert planners.EXTRA_PLANNERS == jplanners.EXTRA_PLANNERS
    topt.set_x0([1.0, 2.0])
    topt.solve()


def test_solver_options_and_setters(ocp_xml):
    topt = TrajectoryOptimizer(device="cpu")
    hints = topt.set_solver_options(
        {"hessian": "exact", "collocation_method": "trapezoidal",
         "nodes": 12, "junk": 1})
    assert topt.config.hessian == "full" and hints["ignored"] == ["junk"]
    assert topt._scheme == "trapezoidal" and topt.vgp.nsteps == 12
    topt.set_optimizer("snopt")
    assert topt._solver_hints["optimizer"] == "SNOPT"
    topt.set_maximize(True)
    topt.set_scheme("euler")
    topt.set_terminal_cost(lambda x, d: x[0])
    topt.set_constraints([lambda x, u, t, d: u[0] - 1.0])
    topt.add_eq_constraints([lambda x, u, t, d: u[1]])
    topt.load_configs(ocp_xml)
    topt.set_gradient(dynamics.single_integrator)
    topt.set_objective(_cost, form="sum")
    topt.setup()
    nlp = topt.nlp
    assert (nlp.scheme, nlp.cost_form, nlp.maximize) == (
        "euler", "sum", True)
    assert len(nlp.path_ineq) == len(nlp.path_eq) == 1
    assert nlp.terminal_cost is not None and nlp.use_obstacles


def test_mip_xml_sets_up_a_delayed_problem(mip_xml):
    """mip_2d_ex1.xml has <states rhorizon="1">: the facade hands it on
    as x_delay=1, so the dynamics sees history windows, as in the JAX
    facade; float64 gets its KKT route (cyclic reduction) from the dtype
    up front."""
    def build(pkg, **kw):
        topt = pkg.TrajectoryOptimizer(**kw)
        topt.load_configs(mip_xml)
        topt.set_dynamics(lambda xw, uw, t, d: uw[-1][:2])
        topt.set_objective(lambda x, u, t, d: u[2] + u[3], form="sum")
        topt.set_scheme("euler")
        topt.setup()
        return topt

    topt = build(etol_tpu_torch, device="cpu", dtype=torch.float64)
    jopt = build(etol_tpu)
    assert (topt.nlp.x_delay, topt.nlp.u_delay, topt.nlp.delay) == (
        jopt.nlp.x_delay, jopt.nlp.u_delay, jopt.nlp.delay) == (1, 0, 1)
    assert topt.data.x0.dtype == torch.float64
    F = al_sqp._ALFuncs(topt.nlp, topt.config,
                        al_sqp.tree_map(lambda a: a[None], topt.data))
    assert topt.config.kkt_solver == "kernel" and F.kkt == "cr"
    z = topt.nlp.initial_guess(topt.data)
    np.testing.assert_allclose(
        topt.nlp.step_defects(z, topt.data).numpy(),
        np.asarray(jopt.nlp.step_defects(
            jopt.nlp.initial_guess(jopt.data), jopt.data)), atol=1e-6)
    topt.config = al_sqp.SolverConfig(max_total=3)
    res = topt.solve()
    assert res.z.dtype == torch.float64 and int(res.inner_iters) == 3
