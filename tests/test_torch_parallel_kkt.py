"""Port parity: the horizon-sharded (SPIKE) KKT solve and the
horizon-sharded AL-SQP against the JAX package's, on the same numpy
systems and problem data.

The JAX side runs over 8 fake CPU devices (tests/conftest.py), as
tests/test_parallel_kkt.py runs it; the port's over an 8-entry CPU mesh,
its slabs stacked on one device (parallel/axis.py::SlabAxis), under both
routes: "kernel" (bt_cuda.solve, on the CPU its plain version, which adds
one refinement pass to each slab solve) and "scan" (the plain factor and
solve_factored_multi, JAX's arithmetic). Tolerances are
tests/test_parallel_kkt.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from etol_tpu.parallel import kkt as jkkt
from etol_tpu.solve import btridiag as jbt
from etol_tpu_torch.parallel import kkt, make_mesh
from etol_tpu_torch.solve import btridiag

torch.set_num_threads(1)


def _random_system(K, w, seed=0, batch=()):
    """tests/test_parallel_kkt.py's systems (with leading ``batch``
    dims), as numpy arrays."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=batch + (K, w, w)).astype(np.float32)
    D = (D @ np.swapaxes(D, -1, -2)
         + (3.0 + w) * np.eye(w, dtype=np.float32))
    O = (rng.normal(size=batch + (K - 1, w, w)) * 0.3).astype(np.float32)
    r = rng.normal(size=batch + (K, w)).astype(np.float32)
    return D, O, r


def _both(K, w, n, seed):
    """x of JAX's make_solver and of the port's under both routes."""
    D, O, r = _random_system(K, w, seed)
    jmesh = Mesh(np.array(jax.devices()[:n]), ("horizon",))
    with jmesh:
        jx = np.asarray(jax.jit(jkkt.make_solver(jmesh, "horizon"))(
            *(jnp.asarray(a) for a in (D, O, r))))
    mesh = make_mesh(["cpu"] * n, axis_names=("horizon",))
    tD, tO, tr = (torch.from_numpy(a) for a in (D, O, r))
    xs = {route: kkt.make_solver(mesh, "horizon", route)(tD, tO, tr)
          for route in kkt.ROUTES}
    return (tD, tO, tr), jx, xs


@pytest.mark.parametrize("K,w,n", [(16, 3, 4), (64, 5, 8), (24, 2, 2)])
def test_sharded_solve_matches_the_reference(K, w, n):
    _, jx, xs = _both(K, w, n, seed=K + w)
    for route, x in xs.items():
        np.testing.assert_allclose(x.numpy(), jx, rtol=2e-4, atol=2e-4,
                                   err_msg=route)


def test_sharded_solve_long_horizon():
    (D, O, r), jx, xs = _both(512, 5, 8, seed=7)
    for route, x in xs.items():
        res = r - btridiag.matvec(D, O, x)
        assert float(res.abs().max()) < 1e-3, route
        np.testing.assert_allclose(x.numpy(), jx, rtol=5e-4, atol=5e-4,
                                   err_msg=route)


def test_a_batch_is_its_lanes_solved_one_by_one():
    D, O, r = (torch.from_numpy(a)
               for a in _random_system(16, 3, seed=5, batch=(3,)))
    mesh = make_mesh(["cpu"] * 4, axis_names=("horizon",))
    for route in kkt.ROUTES:
        f = kkt.make_solver(mesh, "horizon", route)
        x = f(D, O, r)
        assert x.shape == (3, 16, 3)
        for i in range(3):
            np.testing.assert_allclose(x[i].numpy(),
                                       f(D[i], O[i], r[i]).numpy(),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x.numpy(),
                                   btridiag.solve(D, O, r).numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_solve_factored_multi_matches_the_reference():
    D, O, _ = _random_system(12, 4, seed=3)
    R = np.random.default_rng(4).normal(size=(12, 4, 9)).astype(np.float32)
    jL = jbt.factor(jnp.asarray(D), jnp.asarray(O))
    jX = np.asarray(jbt.solve_factored_multi(*jL, jnp.asarray(R)))
    tL = btridiag.factor(torch.from_numpy(D), torch.from_numpy(O))
    tX = btridiag.solve_factored_multi(*tL, torch.from_numpy(R))
    np.testing.assert_allclose(tX.numpy(), jX, rtol=1e-5, atol=1e-5)
    # one column is solve_factored
    np.testing.assert_allclose(
        tX[..., 2].numpy(),
        btridiag.solve_factored(*tL, torch.from_numpy(R[..., 2])).numpy(),
        rtol=1e-6, atol=1e-6)


def test_the_shapes_it_refuses():
    D, O, r = (torch.from_numpy(a) for a in _random_system(16, 3))
    mesh = make_mesh(["cpu"] * 8, axis_names=("horizon",))
    with pytest.raises(ValueError, match=">= 2 nodes"):
        kkt.make_solver(mesh)(D[:8], O[:7], r[:8])      # one node a slab
    with pytest.raises(ValueError, match="must divide"):
        kkt.make_solver(mesh)(D[:12], O[:11], r[:12])
    with pytest.raises(ValueError, match="route"):
        kkt.make_solver(mesh, route="cr")


def _obstacle_problem(pkg):
    """tests/test_parallel_kkt.py's K=64 obstacle-and-track problem,
    built by ``pkg``'s VGP: (vgp, nlp)."""
    if pkg == "jax":
        from etol_tpu.core.problem import VGP
        from etol_tpu.models import dynamics as dyn
        from etol_tpu.transcribe.nlp import NLP
    else:
        from etol_tpu_torch.core.problem import VGP
        from etol_tpu_torch.models import dynamics as dyn
        from etol_tpu_torch.transcribe.nlp import NLP
    nsteps = 63
    vgp = VGP(nsteps=nsteps, dt=0.1)
    vgp.x0 = [0.0, 0.0]
    vgp.xf = [2.0, 0.0]
    vgp.xtol = [0.02, 0.05]
    vgp.xlower = [-5.0, -5.0]
    vgp.xupper = [5.0, 5.0]
    vgp.ulower = [-4.0, -4.0]
    vgp.uupper = [4.0, 4.0]
    vgp.add_exclusion_zone(
        [[0.8, -0.25], [1.2, -0.25], [1.2, 0.1], [0.8, 0.1]])
    vgp.add_track(0.15, [0.0, nsteps * 0.1], [[1.6, 0.8], [1.6, -0.8]])
    nlp = NLP(dims=vgp.dims(), dynamics=dyn.single_integrator,
              running_cost=lambda x, u, t, data: u[0] ** 2 + u[1] ** 2,
              scheme="trapezoidal")
    return vgp, nlp


def test_horizon_sharded_solve_matches_single_device_and_the_reference():
    from _torch_parity import carry_data
    from etol_tpu.parallel.solve_sharded import (
        solve_horizon_sharded as jsolve_horizon_sharded)
    from etol_tpu.solve import SolverConfig as JConfig
    from etol_tpu_torch.parallel.solve_sharded import solve_horizon_sharded
    from etol_tpu_torch.solve.al_sqp import SolverConfig, solve

    jv, jnlp = _obstacle_problem("jax")
    tv, tnlp = _obstacle_problem("torch")
    jdata, tdata = carry_data(jv, tv)
    jres = jsolve_horizon_sharded(
        jnlp, JConfig(max_total=600), jdata,
        Mesh(np.array(jax.devices()[:8]), ("horizon",)))
    cfg = SolverConfig(max_total=600)
    res_ref = solve(tnlp, cfg, tdata)
    res_sh = solve_horizon_sharded(
        tnlp, cfg, tdata, make_mesh(["cpu"] * 8, axis_names=("horizon",)))

    assert int(jres.status) == 1 and int(res_ref.status) == 1
    assert int(res_sh.status) == 1, (float(res_sh.viol_eq),
                                     float(res_sh.viol_in))
    assert float(res_sh.viol_eq) < 1e-4
    assert float(res_sh.viol_in) < 1e-4
    # same basin and optimum up to the solver's stationarity tolerance
    for other in (res_ref, jres):
        np.testing.assert_allclose(float(res_sh.obj), float(other.obj),
                                   rtol=1e-2)
        np.testing.assert_allclose(res_sh.z.numpy(), np.asarray(other.z),
                                   atol=5e-2)
    X = res_sh.z.numpy().reshape(tv.dims().nodes, -1)[:, :2]
    inside = (
        (X[:, 0] > 0.8 + 1e-3) & (X[:, 0] < 1.2 - 1e-3)
        & (X[:, 1] > -0.25 + 1e-3) & (X[:, 1] < 0.1 - 1e-3)
    )
    assert not inside.any()
