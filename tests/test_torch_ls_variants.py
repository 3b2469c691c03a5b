"""Port parity: the solver's line-search and Levenberg variants and the
sequential damped-Newton step.

The three variants that ``chip_smoke.py`` runs on the card beside the uas
registry config (the nonmonotone line search with the "best" rule, the
count-rule damping without the patience exit, and the over-relaxed
multipliers with a sparse exponent grid and the deep-step round exit) go
through ``solve_batched_staged`` from the same z0 in both packages, on
uas_2d cut to 12 steps over a seeded batch of 8 (the batch, z0 and
stages of ``tests/test_torch_solver.py::test_staged_solve_outcomes_match``,
which compares the registry config itself). They are compared on
converged outcomes, not iterates (AL solves are basin-sensitive to
float32 reduction order, ``etol_tpu/solve/al_sqp.py:963-967``): the same
status per lane, objectives within 1e-3 relative, solved lanes within
``tol_cons``.
``_ALFuncs.newton_step`` is compared step for step against the JAX
package's, vmapped over the lanes. The canonical OCP goes through the
facade under the three knob configurations of ``tests/test_solver.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import uas_batch
from etol_tpu.models.tuned import _TUNED as J_TUNED
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch import TrajectoryOptimizer
from etol_tpu_torch.core.types import Status
from etol_tpu_torch.models import dynamics, tuned as ttuned
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

B = 8
VARIANTS = {
    "nonmonotone_best": dict(ls_eta=0.85, ls_rule="best"),
    "count": dict(lm_rule="count", round_viol_patience=0),
    "relaxed_sparse_deep": dict(
        dual_relax=1.6, ls_exponents=(0, 1, 2, 3, 4, 5, 6, 7, 9, 12, 16, 22),
        ls_deep_round=12),
}
# tests/test_solver.py::test_nonmonotone_and_patience_knobs_solve
OCP_KNOBS = (
    dict(ls_eta=0.85),
    dict(round_viol_patience=4, rho_growth=3.16),
    dict(lm_rule="count", round_viol_patience=0),
)


def _configs(variant):
    overrides, _ = J_TUNED["uas_2d"]
    jcfg = jal.SolverConfig(kkt_solver="scan", **dict(overrides, **variant))
    tcfg, stages = ttuned.tuned_config("uas_2d", batch=B)
    return jcfg, dataclasses.replace(tcfg, **variant), stages


def _newton_both(jnlp, jb, tnlp, tb, jcfg, tcfg, Z, lam, rho, lm=None):
    """One ``newton_step`` per lane in both packages from the same point,
    in the dtype of ``Z``: (Z, lm_next, diagnostics) of each, as numpy."""
    lam_def, lam_eq, mu = lam

    def lane(d, Zl, ld, le, m, r, l):
        return jal._ALFuncs(jnlp, jcfg, d).newton_step(Zl, ld, le, m, r, l)

    jl = np.full((B,), jcfg.lm0, Z.dtype) if lm is None else lm
    jZ, jlm, jdiag = jax.jit(jax.vmap(lane))(
        jb, Z, lam_def, lam_eq, mu, rho, jl)
    F = tal._ALFuncs(tnlp, tcfg, tb)
    t = [torch.from_numpy(np.array(a)) for a in (Z, lam_def, lam_eq, mu,
                                                    rho)]
    tZ, tlm, tdiag = F.newton_step(
        *t, None if lm is None else torch.from_numpy(np.array(lm)))
    jdiag = {k: np.asarray(v) for k, v in jdiag.items()}
    tdiag = {k: v.numpy() for k, v in tdiag.items()}
    return (np.asarray(jZ), np.asarray(jlm), jdiag), (
        tZ.numpy(), tlm.numpy(), tdiag)


def _start(jnlp, jb, seed=None):
    """The straight-line guess (perturbed by a seeded draw when ``seed``
    is given), zero multipliers and the registry's rho0."""
    K, w = jnlp.dims.nodes, jnlp.dims.node_width
    Z = np.asarray(jax.vmap(jnlp.initial_guess)(jb)).reshape(B, K, w)
    if seed is not None:
        rng = np.random.default_rng(seed)
        Z = Z + rng.normal(scale=0.05, size=Z.shape)
    _, m_in = jal._result_sizes(jnlp, jax.tree.map(lambda a: a[0], jb))
    lam = (np.zeros((B, K - 1, 3), np.float32),
           np.zeros((B, K, 0), np.float32),
           np.zeros((B, K, m_in), np.float32))
    rho = np.full((B,), J_TUNED["uas_2d"][0]["rho0"], np.float32)
    return Z.astype(np.float32), lam, rho


def _assert_step_matches(jout, tout, atol):
    """The same accepted steps, backtrack counts and damping; Z within
    ``atol``."""
    (jZ, jlm, jd), (tZ, tlm, td) = jout, tout
    np.testing.assert_array_equal(td["ls_ok"], jd["ls_ok"])
    np.testing.assert_array_equal(td["bad"], jd["bad"])
    np.testing.assert_array_equal(td["ls_steps"], jd["ls_steps"])
    np.testing.assert_allclose(tlm, jlm, rtol=1e-6)
    np.testing.assert_allclose(tZ, jZ, rtol=0, atol=atol)


@pytest.mark.parametrize("case", list(VARIANTS) + ["newton_step"])
def test_variant_outcomes_match(case):
    jnlp, jb, tnlp, tb = uas_batch(B)
    if case == "newton_step":
        # float32 at the registry's start (rho0 = 3160) on the kernel
        # route: Z carries the float32 KKT solve's noise, which is what the
        # JAX package's own two routes differ by here ("scan" and "cr":
        # 6.6e-5 in Z), so Z is held at 1e-4 of its scale
        jcfg, tcfg, _ = _configs({})
        Z, lam, rho = _start(jnlp, jb)
        jout, tout = _newton_both(jnlp, jb, tnlp, tb, jcfg, tcfg, Z, lam,
                                  rho)
        assert jout[2]["ls_ok"].all()
        _assert_step_matches(jout, tout,
                             atol=1e-4 * (1.0 + np.abs(jout[0]).max()))
        return
    jcfg, tcfg, stages = _configs(VARIANTS[case])
    z0 = np.array(jax.vmap(jnlp.initial_guess)(jb))
    jres = jal.solve_batched_staged(jnlp, jcfg, jb, jnp.asarray(z0), stages)
    tres = tal.solve_batched_staged(tnlp, tcfg, tb, torch.from_numpy(z0),
                                    stages)
    jst = np.asarray(jres.status)
    np.testing.assert_array_equal(tres.status.numpy(), jst)
    ok = jst == int(Status.SOLVED)
    assert ok.any(), jst
    np.testing.assert_allclose(tres.obj.numpy()[ok],
                               np.asarray(jres.obj)[ok], rtol=1e-3)
    for res in (tres, jres):
        viol = np.maximum(np.asarray(res.viol_eq), np.asarray(res.viol_in))
        assert viol[ok].max() <= tcfg.tol_cons


def test_newton_step_matches():
    """Two chained steps in float64 (``VGPData.astype`` in both packages;
    the port's float64 KKT route is cyclic reduction) from a perturbed
    point with multipliers, the damping carried: each step's Z within
    1e-5 of the JAX package's, the same backtrack counts and count-rule
    damping. In float64 the KKT solves' rounding is far below the
    tolerance, so what is compared is the step's logic."""
    jnlp, jb, tnlp, tb = uas_batch(B)
    jcfg, tcfg, _ = _configs({})
    Z, (ld, le, mu), rho = _start(jnlp, jb, seed=1)
    rng = np.random.default_rng(2)
    ld = rng.normal(scale=0.5, size=ld.shape)
    mu = np.abs(rng.normal(scale=0.5, size=mu.shape))
    lam = (ld, le.astype(np.float64), mu)
    Z, rho = Z.astype(np.float64), np.full((B,), 10.0)
    tb = tb.astype(torch.float64)
    assert tb.dtype == torch.float64
    with jax.enable_x64(True):
        jb = jb.astype(jnp.float64)
        jout, tout = _newton_both(jnlp, jb, tnlp, tb, jcfg, tcfg, Z, lam,
                                  rho)
        _assert_step_matches(jout, tout, atol=1e-5)
        # the second step from the JAX package's first, damping carried
        jout2, tout2 = _newton_both(jnlp, jb, tnlp, tb, jcfg, tcfg,
                                    jout[0], lam, rho, lm=jout[1])
        _assert_step_matches(jout2, tout2, atol=1e-5)
    assert (jout[2]["ls_steps"] > 1).any()


def test_newton_step_launches_through_the_kernel_wrapper(monkeypatch):
    """The direction of ``newton_step`` goes through the kernel's wrapper
    (one call for the batch) under ``kkt_solver="kernel"``; the
    backtracking stops at ``ls_backtracks`` halvings."""
    jnlp, jb, tnlp, tb = uas_batch(B)
    _, tcfg, _ = _configs({})
    calls = []
    wrapper = tal.bt_cuda.solve

    def counted(D, O, r):
        calls.append(tuple(D.shape))
        return wrapper(D, O, r)

    monkeypatch.setattr(tal.bt_cuda, "solve", counted)
    Z, (ld, le, mu), rho = _start(jnlp, jb)
    F = tal._ALFuncs(tnlp, dataclasses.replace(tcfg, ls_backtracks=2), tb)
    t = [torch.from_numpy(a) for a in (Z, ld, le, mu, rho)]
    Zn, lm, diag = F.newton_step(*t)
    assert calls == [(B, 13, 5, 5)]
    assert float(diag["ls_steps"].max()) <= 2.0
    # a lane that found no step keeps its Z and damps ten times harder
    stuck = ~diag["ls_ok"]
    assert torch.equal(Zn[stuck], t[0][stuck])
    np.testing.assert_allclose(lm[stuck].numpy(), 10 * tcfg.lm0, rtol=1e-6)


@pytest.mark.parametrize("knobs", OCP_KNOBS,
                         ids=["ls_eta", "patience", "count"])
def test_facade_ocp_solves_under_the_knobs(ocp_xml, knobs):
    """``tests/test_solver.py``'s three knob configurations each solve the
    canonical OCP, here through the port's facade, to the same limit."""
    topt = TrajectoryOptimizer(tal.SolverConfig(**knobs), device="cpu")
    topt.load_configs(ocp_xml)
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    res = topt.solve()
    assert int(res.status) == int(Status.SOLVED), knobs
    assert float(res.viol_eq) < 1e-4
