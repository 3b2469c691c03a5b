"""Port parity: the option dialects translate to the JAX package's config
and hints, and the refinement ladder interpolates and converges as the
reference's does."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.models import problems as jproblems
from etol_tpu.solve import al_sqp as jal
from etol_tpu.solve import options as joptions
from etol_tpu.solve import refine as jrefine
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import options as toptions
from etol_tpu_torch.solve import refine as trefine

torch.set_num_threads(1)


OPTION_DICTS = [
    {"nlp_tolerance": 1e-6, "nlp_iter_max_count": 200,
     "collocation_method": "Legendre", "hessian": "exact",
     "mesh_refinement": True},
    {"optimizer": "SNOPT", "tol": 1e-3, "max_iter": 500, "mu_init": 0.01,
     "transcription": "radau", "transcription_order": 3,
     "refine_iteration_limit": 2, "print_level": 5},
    {"Hessian": "limited-memory", "nodes": 40, "transcription_order": 5,
     "collocation_method": "nonsense", "warm_start": True},
    {"hessian": "bfgs", "mr_max_iterations": 9, "num_segments": 12,
     "mu_init": -1.0, "acceptable_tol": 1e-3},
    {},
]


@pytest.mark.parametrize("options", OPTION_DICTS)
def test_option_dialects_translate_alike(options):
    jcfg, jhints = joptions.nlp_config(options)
    tcfg, thints = toptions.nlp_config(options)
    assert thints == jhints
    for f in dataclasses.fields(tcfg):
        if f.name != "kkt_solver":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert toptions._SCHEME_MAP == joptions._SCHEME_MAP
    assert toptions._HESSIAN_MAP == joptions._HESSIAN_MAP


def test_options_keep_the_base_config():
    base = tal.SolverConfig(kkt_solver="cr", rho0=3.0)
    cfg, hints = toptions.nlp_config({"hessian": "exact"}, base)
    assert (cfg.kkt_solver, cfg.rho0, cfg.hessian) == ("cr", 3.0, "full")
    assert hints == {"ignored": []}


def test_interp_solution_matches():
    jv, jn = jproblems.canonical_ocp_2d()
    tv, tn = tproblems.canonical_ocp_2d()
    rng = np.random.default_rng(0)
    z = rng.normal(size=(jn.dims.nz,)).astype(np.float32)
    fine = dataclasses.replace(jv, nsteps=64, dt=0.25)
    jf, tf = fine.dims(), dataclasses.replace(
        tv, nsteps=64, dt=0.25).dims()
    want = jrefine.interp_solution(jnp.asarray(z), jn.dims, jf, 0.5, 0.25)
    got = trefine.interp_solution(torch.from_numpy(z), tn.dims, tf, 0.5,
                                  0.25)
    assert got.shape == (65 * 4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the coarse nodes are kept
    np.testing.assert_allclose(got.reshape(65, 4)[::2].numpy(),
                               z.reshape(33, 4), atol=1e-5)


def _make(pkg, nsteps):
    """The canonical smooth VGP at an arbitrary mesh over its 16 s."""
    vgp, nlp = pkg.canonical_ocp_2d()
    vgp.nsteps = nsteps
    vgp.dt = 16.0 / nsteps
    return vgp, dataclasses.replace(nlp, dims=vgp.dims())


def test_refinement_ladder_outcomes_match():
    """Two rungs from 16 steps. (From 8 steps the coarse rungs agree to
    1e-4, but its solution warm-starts the 16-step rung into a cheaper
    route where the two packages stop 0.4% apart, both SOLVED.)"""
    jout = jrefine.solve_refined(
        lambda n: _make(jproblems, n), jal.SolverConfig(), nsteps0=16,
        levels=2)
    tout = trefine.solve_refined(
        lambda n: _make(tproblems, n), tal.SolverConfig(), nsteps0=16,
        levels=2, device="cpu")
    assert [n for n, _ in tout] == [n for n, _ in jout] == [16, 32]
    for (_, tr), (_, jr) in zip(tout, jout):
        assert int(tr.status) == int(jr.status) == 1
        np.testing.assert_allclose(float(tr.obj), float(jr.obj), rtol=1e-3)
        assert float(tr.viol_eq) <= 1e-4 and float(tr.viol_in) <= 1e-4
    # both rungs keep the 16 s horizon and reach the goal band
    _, fine = tout[1]
    assert fine.z.shape == (33 * 4,)
    np.testing.assert_allclose(fine.z.reshape(33, 4)[-1, :2].numpy(),
                               [5.0, 4.0], atol=0.011)
