"""Port parity: the AL-SQP solver. Seeded numpy inputs go through the JAX
package's ``_ALFuncs`` (vmapped over lanes, as its batched solve does)
and the port's batch-native ``_ALFuncs``; then the slice as a whole —
``solve_batched_staged`` from the same z0 in both packages — is compared
on converged outcomes, not iterates (AL solves are basin-sensitive to
float32 reduction order, ``etol_tpu/solve/al_sqp.py:963-967``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu.models.tuned import _TUNED as J_TUNED
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.models import tuned as ttuned
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

B = 8
KW = dict(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))


def _setup(B=B, seed=0):
    """Both packages' uas_2d (pieces) on the same scattered batch."""
    jv, jnlp = jproblems.uas_2d(**KW)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    _, tnlp = tproblems.uas_2d(**KW)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    jdata, _ = jv.to_device()
    rng = np.random.default_rng(seed)
    off = np.zeros((2, B, 3), np.float32)
    off[:, :, :2] = rng.uniform(-0.5, 0.5, size=(2, B, 2))
    jb = jproblem.batch_tile(jdata, B)
    jb = dataclasses.replace(jb, x0=jnp.asarray(off[0]),
                             xf=jb.xf + jnp.asarray(off[1]))
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu"
    )
    return jnlp, jb, tnlp, tb


def _configs():
    overrides, stages = J_TUNED["uas_2d"]
    jcfg = jal.SolverConfig(kkt_solver="scan", **overrides)
    tcfg, tstages = ttuned.tuned_config("uas_2d", batch=B)
    for f in dataclasses.fields(tcfg):
        if f.name != "kkt_solver":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (jcfg.hessian, jcfg.lm_rule) == (tcfg.hessian, tcfg.lm_rule)
    jstages = tuple((max(B // dv, 1), bd) for dv, bd in stages)
    assert tstages == jstages
    return jcfg, tcfg, jstages


def _state(jnlp, jb, seed=1):
    """A seeded point: Z near the straight-line guess, multipliers, and
    rho=3160 (the registry's rho0)."""
    rng = np.random.default_rng(seed)
    K, w = jnlp.dims.nodes, jnlp.dims.node_width
    z0 = np.asarray(jax.vmap(jnlp.initial_guess)(jb)).reshape(B, K, w)
    Z = (z0 + rng.normal(scale=0.05, size=z0.shape)).astype(np.float32)
    lam_def = rng.normal(scale=0.5, size=(B, K - 1, 3)).astype(np.float32)
    _, m_in = jal._result_sizes(jnlp, jax.tree.map(lambda a: a[0], jb))
    mu = np.abs(rng.normal(scale=0.5, size=(B, K, m_in))).astype(np.float32)
    lam_eq = np.zeros((B, K, 0), np.float32)
    rho = np.full((B,), 3160.0, np.float32)
    lm = np.full((B,), 1e-3, np.float32)
    return Z, lam_def, lam_eq, mu, rho, lm


def _jax_lanes(jnlp, jcfg, jb, fn, *args):
    """fn(F, *lane_args) per lane with the JAX package's _ALFuncs."""
    return jax.jit(jax.vmap(
        lambda d, *a: fn(jal._ALFuncs(jnlp, jcfg, d), *a)
    ))(jb, *args)


def test_precision_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_al_grad_and_gn_blocks_match():
    jnlp, jb, tnlp, tb = _setup()
    jcfg, tcfg, _ = _configs()
    Z, lam_def, lam_eq, mu, rho, lm = _state(jnlp, jb)
    args = (Z, lam_def, lam_eq, mu, rho)
    jg = _jax_lanes(jnlp, jcfg, jb, lambda F, *a: F.al_grad(*a), *args)
    F = tal._ALFuncs(tnlp, tcfg, tb)
    targs = [torch.from_numpy(a) for a in args]
    tg = F.al_grad(*targs)
    # f32 summation order: gradients carry rho*(residual) terms
    gscale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                               atol=1e-5 * gscale)

    free = np.ones(Z.shape, bool)
    free[:, 0, :3] = False  # x0 pinned
    g = np.array(_jax_lanes(
        jnlp, jcfg, jb, lambda F, Zl: F.residuals(Zl)[2], Z))
    jD, jO = _jax_lanes(
        jnlp, jcfg, jb,
        lambda F, *a: F.gn_blocks(*a),
        Z, lam_def, lam_eq, mu, rho, free, lm, g,
    )
    tD, tO = F.gn_blocks(*targs, torch.from_numpy(free),
                         torch.from_numpy(lm), torch.from_numpy(g))
    dscale = float(np.abs(np.asarray(jD)).max())
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD),
                               atol=1e-5 * dscale)
    np.testing.assert_allclose(tO.numpy(), np.asarray(jO),
                               atol=1e-5 * dscale)


def test_direction_matches():
    jnlp, jb, tnlp, tb = _setup()
    jcfg, tcfg, _ = _configs()
    Z, lam_def, lam_eq, mu, rho, lm = _state(jnlp, jb, seed=2)
    grad = np.array(_jax_lanes(
        jnlp, jcfg, jb, lambda F, *a: F.al_grad(*a),
        Z, lam_def, lam_eq, mu, rho))
    g = np.array(_jax_lanes(
        jnlp, jcfg, jb, lambda F, Zl: F.residuals(Zl)[2], Z))
    jp, jbad = _jax_lanes(
        jnlp, jcfg, jb, lambda F, *a: F.direction(*a),
        Z, grad, lam_def, lam_eq, mu, rho, lm, g,
    )
    F = tal._ALFuncs(tnlp, tcfg, tb)
    tp, tbad = F.direction(*[torch.from_numpy(a) for a in
                             (Z, grad, lam_def, lam_eq, mu, rho, lm, g)])
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    # a KKT solve at rho=3160 in f32: relative agreement 1e-3
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-3,
                               atol=1e-3 * np.abs(jp).max())


def test_staged_solve_outcomes_match():
    jnlp, jb, tnlp, tb = _setup()
    jcfg, tcfg, stages = _configs()
    z0 = np.array(jax.vmap(jnlp.initial_guess)(jb))
    jres, jtrips = jal.solve_batched_staged(
        jnlp, jcfg, jb, jnp.asarray(z0), stages, return_stage_trips=True
    )
    tres, ttrips = tal.solve_batched_staged(
        tnlp, tcfg, tb, torch.from_numpy(z0), stages,
        return_stage_trips=True,
    )
    jok = np.asarray(jres.status) == 1
    tok = tres.status.numpy() == 1
    assert jok.sum() >= B - 1, jres.status
    # the same lanes SOLVED, with at most one lane of difference
    assert (jok != tok).sum() <= 1, (jres.status, tres.status)
    both = jok & tok
    np.testing.assert_allclose(tres.obj.numpy()[both],
                               np.asarray(jres.obj)[both], rtol=1e-2)
    assert len(ttrips) == len(jtrips)
    assert float(tres.viol_eq[torch.from_numpy(tok)].max()) <= 1e-4


def test_unported_config_raises():
    """Every knob of the JAX package's config exists with its default;
    a value outside a knob's vocabulary raises ValueError."""
    # cyclic reduction, the separable assembly and the chord steps exist
    cfg = tal.SolverConfig(kkt_solver="cr", chord_steps=2,
                           sep_assembly=False)
    assert (cfg.kkt_solver, cfg.chord_steps, cfg.sep_assembly) == (
        "cr", 2, False)
    assert tal.SolverConfig().sep_assembly is True
    assert tal.SolverConfig().chord_steps == 0
    with pytest.raises(ValueError):
        tal.SolverConfig(kkt_solver="pallas")
    with pytest.raises(ValueError):
        tal.SolverConfig(chord_steps=-1)
    # the line-search and Levenberg variants: JAX's defaults, and they
    # take JAX's values
    knobs = ("lm_rule", "ls_eta", "ls_rule", "dual_relax",
             "ls_deep_round", "ls_exponents", "ls_backtracks")
    for knob in knobs:
        assert getattr(tal.SolverConfig(), knob) == getattr(
            jal.SolverConfig(), knob), knob
    cfg = tal.SolverConfig(lm_rule="count", ls_eta=0.85, ls_rule="best",
                           dual_relax=1.6, ls_deep_round=12,
                           ls_exponents=(0, 1, 2, 4), ls_backtracks=16)
    assert (cfg.lm_rule, cfg.ls_rule, cfg.ls_backtracks) == (
        "count", "best", 16)
    for knob in ("ls_rule", "lm_rule"):
        with pytest.raises(ValueError):
            tal.SolverConfig(**{knob: "greedy"})
    # the Hessian variants exist; anything else is refused
    assert tal.SolverConfig(hessian="gn").hessian == "gn"
    with pytest.raises(ValueError):
        tal.SolverConfig(hessian=1)


@pytest.mark.parametrize("kkt", ["scan", "cr"])
def test_unbatched_solve_matches(kkt):
    """One problem through ``solve`` in both packages: same status,
    objective within 1e-3 relative, and under "scan" the same iteration
    count."""
    jv, jnlp = jproblems.uas_2d(**KW)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    _, tnlp = tproblems.uas_2d(**KW)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    jdata, _ = jv.to_device()
    tdata = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu")
    overrides, _ = J_TUNED["uas_2d"]
    overrides = dict(overrides, max_total=0)
    jcfg = jal.SolverConfig(kkt_solver=kkt, **overrides)
    tcfg = dataclasses.replace(ttuned.tuned_config("uas_2d")[0],
                               kkt_solver=kkt, max_total=0)
    jres = jal.solve(jnlp, jcfg, jdata)
    tres = tal.solve(tnlp, tcfg, tdata)
    assert tres.z.shape == (tnlp.dims.nz,) and tres.status.shape == ()
    assert tres.lam_def.shape == (12, 3) and tres.rho.shape == ()
    assert int(tres.status) == int(jres.status) == 1
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    if kkt == "scan":
        assert int(tres.inner_iters) == int(jres.inner_iters)
    # a warm re-solve from the result: a handful of iterations, and the
    # same outcome in both packages
    jd2 = dataclasses.replace(jdata, x0=jdata.x0 + 0.01)
    td2 = dataclasses.replace(tdata, x0=tdata.x0 + 0.01)
    jw = jal.solve(jnlp, jcfg, jd2, jres.z,
                   (jres.lam_def, jres.lam_eq, jres.mu), jres.rho)
    tw = tal.solve(tnlp, tcfg, td2, tres.z,
                   (tres.lam_def, tres.lam_eq, tres.mu), tres.rho)
    assert int(tw.status) == int(jw.status) == 1
    assert int(tw.inner_iters) < int(tres.inner_iters)
    np.testing.assert_allclose(float(tw.obj), float(jw.obj), rtol=1e-3)


@pytest.mark.parametrize("kkt", ["kernel", "cr"])
def test_unbatched_solve_route_is_the_configs(monkeypatch, kkt):
    """Under "kernel" the unbatched solve calls the kernel's wrapper once
    a KKT solve (a batch of one) and never cyclic reduction; under "cr"
    the reverse."""
    _, tnlp = tproblems.uas_2d(**KW)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    tdata, _ = tproblems.uas_2d(**KW)[0].to_device(device="cpu")
    cfg = dataclasses.replace(ttuned.tuned_config("uas_2d")[0], max_total=12)
    assert cfg.kkt_solver == "kernel"
    cfg = dataclasses.replace(cfg, kkt_solver=kkt)
    calls = {"kernel": [], "cr": []}
    wrapper, cr = tal.bt_cuda.solve, tal.cyclic_reduction.solve_refined

    def counted(route, fn):
        def call(D, O, r):
            calls[route].append(tuple(D.shape))
            return fn(D, O, r)
        return call

    monkeypatch.setattr(tal.bt_cuda, "solve", counted("kernel", wrapper))
    monkeypatch.setattr(tal.cyclic_reduction, "solve_refined",
                        counted("cr", cr))
    res = tal.solve(tnlp, cfg, tdata)
    assert int(res.inner_iters) == 12
    other = "cr" if kkt == "kernel" else "kernel"
    assert calls[kkt] == [(1, 13, 5, 5)] * 12 and calls[other] == []


def test_float64_and_wide_nodes_route_to_cyclic_reduction():
    """The route comes from the dtype and the width up front: the
    kernel's wrapper takes float32 nodes up to 9 wide and is not asked
    for anything else."""
    vgp, tnlp = tproblems.uas_2d(**KW)
    cfg = ttuned.tuned_config("uas_2d")[0]
    for dtype, want in ((torch.float32, "kernel"), (torch.float64, "cr")):
        data, _ = vgp.to_device(dtype=dtype, device="cpu")
        F = tal._ALFuncs(tnlp, cfg, tproblem.batch_tile(data, 2))
        assert F.kkt == want
        for name in ("scan", "cr"):
            assert tal._ALFuncs(
                tnlp, dataclasses.replace(cfg, kkt_solver=name),
                tproblem.batch_tile(data, 2)).kkt == name
    data, _ = vgp.to_device(dtype=torch.float64, device="cpu")
    res = tal.solve(tnlp, dataclasses.replace(cfg, max_total=2), data)
    assert res.z.dtype == torch.float64 and int(res.inner_iters) == 2
