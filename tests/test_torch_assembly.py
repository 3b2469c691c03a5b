"""Port parity: the parts of the NLP surface and of the block assembly
that the uas_2d main path does not reach — user path equalities and
inequalities (their Jacobian products in ``gn_blocks``), the "both"
obstacle form, and the models' dynamics; and the separable assembly
(``sep_assembly``) of the euler and trapezoidal schemes, on and off,
against the JAX blocks.

Tolerances: rtol 1e-5 on dynamics values (same float32 formulas);
atol 1e-5·max|x| on gradients and Hessian blocks (float32 summation
order, the blocks carry rho=3160 terms)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.func import vmap

from etol_tpu.core import problem as jproblem
from etol_tpu.models import dynamics as jdyn
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import dynamics as tdyn
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)


@pytest.mark.parametrize("name,nx,nu", [
    ("unicycle", 3, 2), ("single_integrator", 2, 2),
    ("double_integrator", 4, 2), ("point_mass_3d", 3, 3),
    ("fixed_wing_3dof", 6, 3),
])
def test_dynamics_match(name, nx, nu):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16, nx)).astype(np.float32)
    U = rng.normal(size=(16, nu)).astype(np.float32)
    j = jax.vmap(lambda x, u: getattr(jdyn, name)(x, u, 0.0, None))(X, U)
    t = vmap(lambda x, u: getattr(tdyn, name)(x, u, 0.0, None))(
        torch.from_numpy(X), torch.from_numpy(U))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


# scalar rows written with arithmetic only, so one lambda serves both
def _speed_row(x, u, t, d):
    return u[0] * x[1] - 1.5


def _turn_row(x, u, t, d):
    return 0.1 * u[1] * x[0]


def test_blocks_with_user_rows_match():
    B = 3
    kw = dict(nsteps=8, dt=0.5, xf=(4.0, 3.0, 0.0))
    jv, jnlp = jproblems.uas_2d(**kw)
    _, tnlp = tproblems.uas_2d(**kw)
    extra = dict(obstacle_form="both", path_ineq=(_speed_row,),
                 path_eq=(_turn_row,))
    jnlp = dataclasses.replace(jnlp, **extra)
    tnlp = dataclasses.replace(tnlp, **extra)
    jdata, _ = jv.to_device()
    jb = jproblem.batch_tile(jdata, B)
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu")
    jcfg = jal.SolverConfig(kkt_solver="scan")
    tcfg = tal.SolverConfig(kkt_solver="scan")

    K, w = jnlp.dims.nodes, jnlp.dims.node_width
    m_eq, m_in = jal._result_sizes(jnlp, jdata)
    assert (m_eq, m_in) == tal._result_sizes(tnlp, tb) == (1, 12 + 3 + 1 + 1)
    rng = np.random.default_rng(5)
    z0 = np.asarray(jax.vmap(jnlp.initial_guess)(jb)).reshape(B, K, w)
    Z = (z0 + rng.normal(scale=0.1, size=z0.shape)).astype(np.float32)
    lam_def = rng.normal(scale=0.5, size=(B, K - 1, 3)).astype(np.float32)
    lam_eq = rng.normal(scale=0.5, size=(B, K, m_eq)).astype(np.float32)
    mu = np.abs(rng.normal(scale=0.5, size=(B, K, m_in))).astype(np.float32)
    rho = np.full((B,), 3160.0, np.float32)
    lm = np.full((B,), 1e-3, np.float32)
    free = np.ones(Z.shape, bool)
    free[:, 0, :3] = False

    def jlanes(fn, *args):
        return jax.jit(jax.vmap(
            lambda d, *a: fn(jal._ALFuncs(jnlp, jcfg, d), *a)))(jb, *args)

    args = (Z, lam_def, lam_eq, mu, rho)
    F = tal._ALFuncs(tnlp, tcfg, tb)
    targs = [torch.from_numpy(a) for a in args]

    for jr, tr in zip(jlanes(lambda F, Zl: F.residuals(Zl), Z),
                      F.residuals(targs[0])):
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-5)
    jg = np.asarray(jlanes(lambda F, *a: F.al_grad(*a), *args))
    np.testing.assert_allclose(F.al_grad(*targs).numpy(), jg,
                               atol=1e-5 * np.abs(jg).max())
    g = np.array(jlanes(lambda F, Zl: F.residuals(Zl)[2], Z))
    jD, jO = jlanes(lambda F, *a: F.gn_blocks(*a), *args, free, lm, g)
    tD, tO = F.gn_blocks(*targs, torch.from_numpy(free),
                         torch.from_numpy(lm), torch.from_numpy(g))
    scale = float(np.abs(np.asarray(jD)).max())
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), atol=1e-5 * scale)
    np.testing.assert_allclose(tO.numpy(), np.asarray(jO), atol=1e-5 * scale)


SEP_CASES = [
    ("uas_2d", dict(nsteps=8, dt=0.5, xf=(4.0, 3.0, 0.0)), "trapezoidal"),
    ("uas_2d", dict(nsteps=8, dt=0.5, xf=(4.0, 3.0, 0.0)), "euler"),
    ("point_mass_3d", dict(nsteps=10, dt=0.8), "trapezoidal"),
]


@pytest.mark.parametrize("sep", [True, False])
@pytest.mark.parametrize("model,kw,scheme", SEP_CASES)
def test_sep_assembly_blocks_match(model, kw, scheme, sep):
    """``gn_blocks`` under the separable schemes, with the per-node fast
    path and with the generic pair path, against the JAX package's blocks
    under the same setting; and the two paths against each other.
    ``point_mass_3d`` brings 3-D tracks (``pos_dims`` = 3)."""
    B = 3
    jv, jnlp = getattr(jproblems, model)(**kw)
    _, tnlp = getattr(tproblems, model)(**kw)
    jnlp = dataclasses.replace(jnlp, scheme=scheme)
    tnlp = dataclasses.replace(tnlp, scheme=scheme)
    jdata, _ = jv.to_device()
    jb = jproblem.batch_tile(jdata, B)
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu")
    if model == "point_mass_3d":
        assert tnlp.pos_dims(tproblem.tree_map(lambda a: a[0], tb)) == 3
    jcfg = jal.SolverConfig(kkt_solver="scan", sep_assembly=sep)
    tcfg = tal.SolverConfig(kkt_solver="scan", sep_assembly=sep)

    K, w, nx = jnlp.dims.nodes, jnlp.dims.node_width, jnlp.dims.nx
    m_eq, m_in = jal._result_sizes(jnlp, jdata)
    assert (m_eq, m_in) == tal._result_sizes(tnlp, tb)
    rng = np.random.default_rng(5)
    z0 = np.asarray(jax.vmap(jnlp.initial_guess)(jb)).reshape(B, K, w)
    Z = (z0 + rng.normal(scale=0.1, size=z0.shape)).astype(np.float32)
    lam_def = rng.normal(scale=0.5, size=(B, K - 1, nx)).astype(np.float32)
    lam_eq = np.zeros((B, K, m_eq), np.float32)
    mu = np.abs(rng.normal(scale=0.5, size=(B, K, m_in))).astype(np.float32)
    # a small penalty keeps the defect terms (what the two paths compute
    # differently) within sight of the obstacle terms' scale
    rho = np.full((B,), 10.0, np.float32)
    lm = np.full((B,), 1e-3, np.float32)
    free = np.ones(Z.shape, bool)
    free[:, 0, :nx] = False

    def jlanes(fn, *args):
        return jax.jit(jax.vmap(
            lambda d, *a: fn(jal._ALFuncs(jnlp, jcfg, d), *a)))(jb, *args)

    g = np.array(jlanes(lambda F, Zl: F.residuals(Zl)[2], Z))
    args = (Z, lam_def, lam_eq, mu, rho, free, lm, g)
    jD, jO = jlanes(lambda F, *a: F.gn_blocks(*a), *args)
    targs = [torch.from_numpy(a) for a in args]
    tD, tO = tal._ALFuncs(tnlp, tcfg, tb).gn_blocks(*targs)
    scale = float(np.abs(np.asarray(jD)).max())
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), atol=1e-5 * scale)
    np.testing.assert_allclose(tO.numpy(), np.asarray(jO), atol=1e-5 * scale)
    # the other path computes the same blocks
    other = tal.SolverConfig(kkt_solver="scan", sep_assembly=not sep)
    oD, oO = tal._ALFuncs(tnlp, other, tb).gn_blocks(*targs)
    np.testing.assert_allclose(oD.numpy(), tD.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(oO.numpy(), tO.numpy(), atol=1e-5 * scale)
