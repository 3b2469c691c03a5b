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
        [np.asarray(a) for a in jax.tree.leaves(jb)]
    )
    return jnlp, jb, tnlp, tb


def _configs():
    overrides, stages = J_TUNED["uas_2d"]
    jcfg = jal.SolverConfig(kkt_solver="scan", **overrides)
    tcfg, tstages = ttuned.tuned_config("uas_2d", batch=B)
    for f in dataclasses.fields(tcfg):
        if f.name != "kkt_solver":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    # what the port has as its only path, the JAX config selects
    assert (jcfg.hessian, jcfg.lm_rule) == ("defect", "ratio")
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
    with pytest.raises(ValueError):
        tal.SolverConfig(kkt_solver="cr")
    for knob in ("hessian", "lm_rule", "ls_eta", "chord_steps"):
        with pytest.raises(TypeError):
            tal.SolverConfig(**{knob: 1})
