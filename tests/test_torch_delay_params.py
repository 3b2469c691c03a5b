"""Port parity: delayed dynamics (history windows) and param columns.
The same seeded numpy inputs go through the JAX package's ``NLP`` /
``_ALFuncs`` and the port's; the solves are compared on converged
outcomes (status, objective 1e-3 relative, violations under
``tol_cons``), mirroring ``tests/test_delay.py`` and
``tests/test_params.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.core import types as jtypes
from etol_tpu.solve import al_sqp as jal
from etol_tpu.transcribe import nlp as jnlp_mod
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.core import types as ttypes
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.transcribe import nlp as tnlp_mod

from _torch_parity import blocks_both as _blocks_both
from _torch_parity import carry_data as _data

torch.set_num_threads(1)

JAX = dict(VGP=jproblem.VGP, NLP=jnlp_mod.NLP, types=jtypes,
           stack=jnp.stack)
TORCH = dict(VGP=tproblem.VGP, NLP=tnlp_mod.NLP, types=ttypes,
             stack=torch.stack)


def _delayed(pkg, nsteps=20, dt=0.5, u_delay=2, scheme="euler"):
    """1-D integrator with control latency: xdot(t) = u(t - u_delay dt),
    min sum u^2 (``tests/test_delay.py``)."""
    vgp = pkg["VGP"](nsteps=nsteps, dt=dt)
    vgp.x_rhorizon, vgp.u_rhorizon = 1, u_delay
    vgp.x0, vgp.xf, vgp.xtol = [0.0], [2.0], [0.02]
    vgp.xlower, vgp.xupper = [-10.0], [10.0]
    vgp.ulower, vgp.uupper = [-2.0], [2.0]
    nlp = pkg["NLP"](
        dims=vgp.dims(),
        dynamics=lambda xw, uw, t, data: uw[0],
        running_cost=lambda x, u, t, data: u[0] ** 2,
        scheme=scheme, cost_form="sum", use_obstacles=False,
        x_delay=0, u_delay=u_delay,
    )
    return vgp, nlp


def _state_delayed(pkg, nsteps=16, dt=0.25, x_delay=2,
                   scheme="trapezoidal"):
    """Discrete delay ODE xdot = -a x(t - d) + u, nonlinear in nothing but
    with a state window (``tests/test_delay.py``), plus a curved term so
    that the defect has curvature."""
    vgp = pkg["VGP"](nsteps=nsteps, dt=dt)
    vgp.x_rhorizon = x_delay
    vgp.x0, vgp.xf, vgp.xtol = [1.0], [0.0], [0.05]
    vgp.xlower, vgp.xupper = [-5.0], [5.0]
    vgp.ulower, vgp.uupper = [-3.0], [3.0]
    nlp = pkg["NLP"](
        dims=vgp.dims(),
        dynamics=lambda xw, uw, t, data: (
            -0.8 * xw[0] + uw[0] - 0.1 * xw[-1] ** 2),
        running_cost=lambda x, u, t, data: u[0] ** 2,
        scheme=scheme, cost_form="sum", use_obstacles=False,
        x_delay=x_delay, u_delay=0,
    )
    return vgp, nlp


def _epigraph(pkg, nsteps=16, dt=0.5, window=None):
    """1-D single integrator, min sum |u| via an epigraph param column
    s >= |u| (``tests/test_params.py``)."""
    ty = pkg["types"]
    vgp = pkg["VGP"](nsteps=nsteps, dt=dt)
    vgp.x0, vgp.xf, vgp.xtol = [0.0], [4.0], [0.05]
    vgp.xlower, vgp.xupper = [-10.0], [10.0]
    vgp.ulower, vgp.uupper = [-1.0], [1.0]
    win = window or (0.0, nsteps * dt)
    vgp.add_params(
        {"s": ty.ParamConfig(ty.VarType.CONTINUOUS, 0.0, 10.0, *win)})
    stack = pkg["stack"]
    nlp = pkg["NLP"](
        dims=vgp.dims(),
        dynamics=lambda x, u, t, data: u,
        running_cost=lambda x, u, t, data, p: p[0],
        path_ineq=(lambda x, u, t, data, p: stack(
            [u[0] - p[0], -u[0] - p[0]]),),
        scheme="trapezoidal", cost_form="sum", use_obstacles=False,
    )
    return vgp, nlp


def test_step_windows_clamp_and_match():
    _, jn = _delayed(JAX, nsteps=4)
    _, tn = _delayed(TORCH, nsteps=4)
    Z = np.arange(5.0, dtype=np.float32)[:, None] * np.ones(
        (1, 2), np.float32)
    W = tn.step_windows(torch.from_numpy(Z))
    assert W.shape == (4, 4, 2)
    np.testing.assert_array_equal(W[0, :, 0].numpy(), [0, 0, 0, 1])
    np.testing.assert_array_equal(W[3, :, 0].numpy(), [1, 2, 3, 4])
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tn.step_windows(torch.from_numpy(Z)).numpy(),
        np.asarray(jn.step_windows(jnp.asarray(Z))), atol=1e-6)
    assert tn.delay == jn.delay == 2 and tn.nz == jn.nz


@pytest.mark.parametrize("build,scheme", [
    (_delayed, "euler"), (_delayed, "trapezoidal"),
    (_state_delayed, "euler"), (_state_delayed, "trapezoidal"),
])
def test_pair_defect_and_step_defects_match(build, scheme):
    jv, jn = build(JAX, scheme=scheme)
    tv, tn = build(TORCH, scheme=scheme)
    jd, td = _data(jv, tv)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(jn.dims.nz,)).astype(np.float32)
    W = np.asarray(jn.step_windows(jnp.asarray(z).reshape(
        jn.dims.nodes, -1)))
    for k in (0, 1, 5):
        want = jn.pair_defect(jnp.asarray(W[k]), jnp.int32(k), jd)
        got = tn.pair_defect(torch.from_numpy(W[k]), torch.tensor(k), td)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
    np.testing.assert_allclose(
        tn.step_defects(torch.from_numpy(z), td).numpy(),
        np.asarray(jn.step_defects(jnp.asarray(z), jd)), atol=1e-6)
    np.testing.assert_allclose(
        tn.eq_residuals(torch.from_numpy(z), td).numpy(),
        np.asarray(jn.eq_residuals(jnp.asarray(z), jd)), atol=1e-6)


def test_pair_defect_is_step_defect_when_memoryless():
    tv, tn = _delayed(TORCH, nsteps=6, u_delay=0)
    tn = dataclasses.replace(tn, dynamics=lambda x, u, t, data: u)
    td, dims = tv.to_device(device="cpu")
    Z = (tn.initial_guess(td) + 0.1).reshape(dims.nodes, -1)
    k = torch.tensor(2)
    np.testing.assert_allclose(
        tn.pair_defect(torch.stack([Z[2], Z[3]]), k, td).numpy(),
        tn.step_defect(Z[2], Z[3], k, td).numpy(), rtol=1e-6)


def test_delayed_hermite_simpson_raises_as_the_reference():
    jv, jn = _delayed(JAX, scheme="hermite_simpson")
    tv, tn = _delayed(TORCH, scheme="hermite_simpson")
    jd, td = _data(jv, tv)
    W = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="does not support delayed"):
        jn.pair_defect(jnp.asarray(W), jnp.int32(0), jd)
    with pytest.raises(ValueError, match="does not support delayed"):
        tn.pair_defect(torch.from_numpy(W), torch.tensor(0), td)


def test_param_callbacks_and_views_match():
    jv, jn = _epigraph(JAX)
    tv, tn = _epigraph(TORCH)
    jd, td = _data(jv, tv)
    assert tn.dims.node_width == 3
    rng = np.random.default_rng(2)
    z = rng.normal(size=(jn.dims.nz,)).astype(np.float32)
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    zn = z[:3]
    for k in (0, 7, 16):
        np.testing.assert_allclose(
            float(tn.node_cost(torch.from_numpy(zn), torch.tensor(k), td)),
            float(jn.node_cost(jnp.asarray(zn), jnp.int32(k), jd)),
            atol=1e-6)
    x, u, p = tn._split(torch.from_numpy(zn))
    assert (x.shape, u.shape, p.shape) == ((1,), (1,), (1,))
    for view in ("node_ineqs", "ineq_residuals", "step_defects",
                 "node_eqs", "eq_residuals"):
        np.testing.assert_allclose(
            getattr(tn, view)(zt, td).numpy(),
            np.asarray(getattr(jn, view)(zj, jd)), atol=1e-6)
    np.testing.assert_allclose(float(tn.objective(zt, td)),
                               float(jn.objective(zj, jd)), rtol=1e-6)
    np.testing.assert_allclose(
        tn.variable_scales(td).numpy(),
        np.asarray(jn.variable_scales(jd)), atol=1e-6)
    np.testing.assert_allclose(
        tn.initial_guess(td).numpy(), np.asarray(jn.initial_guess(jd)),
        atol=1e-6)
    X, U = tn.unpack(zt)
    P = zt.reshape(17, 3)[:, 2:]
    assert torch.equal(tn.pack(X, U, P), zt)
    assert torch.equal(tn.pack(X, U).reshape(17, 3)[:, 2],
                       torch.zeros(17))


@pytest.mark.parametrize("window", [None, (4.0, 8.0), (1.0, 2.5)])
def test_bounds_with_param_window_match(window):
    jv, jn = _epigraph(JAX, window=window)
    tv, tn = _epigraph(TORCH, window=window)
    jd, td = _data(jv, tv)
    for got, want in zip(tn.bounds(td), jn.bounds(jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
    if window == (4.0, 8.0):
        lb, ub = (a.reshape(17, 3).numpy() for a in tn.bounds(td))
        ts = np.arange(17) * 0.5
        inside = (ts >= 4.0) & (ts <= 8.0)
        np.testing.assert_array_equal(lb[~inside, 2], 0.0)
        np.testing.assert_array_equal(ub[~inside, 2], 0.0)
        np.testing.assert_array_equal(ub[inside, 2], 10.0)


@pytest.mark.parametrize("build,scheme,hessian", [
    (_delayed, "euler", "defect"),
    (_state_delayed, "trapezoidal", "defect"),
    (_state_delayed, "euler", "gn"),
    (_state_delayed, "trapezoidal", "full"),
])
def test_delayed_gn_blocks_match(build, scheme, hessian):
    jv, jn = build(JAX, scheme=scheme)
    tv, tn = build(TORCH, scheme=scheme)
    jd, td = _data(jv, tv)
    tD, tO, jD, jO = _blocks_both(jn, jd, tn, td, hessian)
    np.testing.assert_allclose(tD, jD, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tO, jO, rtol=1e-4, atol=1e-5)


def test_param_gn_blocks_match():
    jv, jn = _epigraph(JAX)
    tv, tn = _epigraph(TORCH)
    jd, td = _data(jv, tv)
    tD, tO, jD, jO = _blocks_both(jn, jd, tn, td)
    np.testing.assert_allclose(tD, jD, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tO, jO, rtol=1e-4, atol=1e-5)


def _same_outcome(tres, jres, tol_cons=1e-4):
    assert int(tres.status) == int(jres.status) == 1
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    assert float(tres.viol_eq) <= tol_cons
    assert float(tres.viol_in) <= tol_cons


def test_delayed_solve_outcome_matches():
    u_delay, nsteps, dt = 2, 20, 0.5
    jv, jn = _delayed(JAX)
    tv, tn = _delayed(TORCH)
    jd, td = _data(jv, tv)
    jres = jal.solve(jn, jal.SolverConfig(), jd)
    tres = tal.solve(tn, tal.SolverConfig(), td)
    _same_outcome(tres, jres)
    X, U = (a.numpy()[:, 0] for a in tn.unpack(tres.z))
    # the delay's semantics: x_{k+1} = x_k + dt u_{k+1-u_delay}, clamped
    x = np.zeros(nsteps + 1)
    for k in range(nsteps):
        x[k + 1] = x[k] + dt * U[max(k + 1 - u_delay, 0)]
    np.testing.assert_allclose(X, x, atol=2e-2)
    assert abs(X[-1] - 2.0) <= 0.03
    assert np.all(np.abs(U[-u_delay:]) < 0.05)
    assert 0.66 <= float(tres.obj) <= 0.76


def test_delayed_state_window_solve_outcome_matches():
    jv, jn = _state_delayed(JAX, scheme="euler")
    tv, tn = _state_delayed(TORCH, scheme="euler")
    assert tn.dims.rhorizon == 2
    jd, td = _data(jv, tv)
    jres = jal.solve(jn, jal.SolverConfig(), jd)
    tres = tal.solve(tn, tal.SolverConfig(), td)
    _same_outcome(tres, jres)
    X = tn.unpack(tres.z)[0].numpy()[:, 0]
    # the first x_delay nodes are pinned to x0 by the rhorizon bounds
    np.testing.assert_allclose(X[:2], 1.0, atol=1e-6)
    assert abs(X[-1]) <= 0.06


def test_param_solve_outcome_matches():
    jv, jn = _epigraph(JAX)
    tv, tn = _epigraph(TORCH)
    jd, td = _data(jv, tv)
    jres = jal.solve(jn, jal.SolverConfig(), jd)
    tres = tal.solve(tn, tal.SolverConfig(), td)
    _same_outcome(tres, jres)
    Z = tres.z.reshape(17, 3).numpy()
    # the epigraph is tight: s ~ |u|, and the cost the L1 distance
    assert np.all(Z[:, 2] >= np.abs(Z[:, 1]) - 1e-3)
    assert abs(Z[-1, 0] - 4.0) <= 0.06
    assert float(tres.obj) <= 8.6
