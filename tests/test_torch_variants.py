"""Port parity: the Hessian variants ("gn", "full") give the JAX
package's blocks at a seeded point and its converged outcome."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import blocks_both, carry_data
from etol_tpu.models import problems as jproblems
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

UAS = dict(nsteps=8, dt=0.6, xf=(4.0, 3.0, 0.0))


def _uas_with_eq(pkg, np_mod):
    """uas_2d (unicycle, Hermite-Simpson: the node-pair path) with a
    curved user equality and a curved user inequality, so that every
    term of hessian="full" is non-zero."""
    vgp, nlp = pkg.uas_2d(**UAS)
    nlp = dataclasses.replace(
        nlp,
        path_eq=(lambda x, u, t, d: u[0] * np_mod.cos(x[2]) - 0.5,),
        path_ineq=(lambda x, u, t, d: u[1] ** 2 - 0.3,),
    )
    return vgp, nlp


PROBLEMS = {
    "ocp": lambda: (jproblems.canonical_ocp_2d(),
                    tproblems.canonical_ocp_2d()),
    "mip": lambda: (jproblems.canonical_mip_2d(),
                    tproblems.canonical_mip_2d()),
    "uas": lambda: (jproblems.uas_2d(**UAS), tproblems.uas_2d(**UAS)),
    "uas_eq": lambda: (_uas_with_eq(jproblems, jnp),
                       _uas_with_eq(tproblems, torch)),
}


@pytest.mark.parametrize("name,hessian", [
    ("ocp", "gn"), ("ocp", "full"), ("mip", "gn"), ("mip", "full"),
    ("uas", "gn"), ("uas", "full"), ("uas_eq", "full"),
    ("uas_eq", "defect"),
])
def test_gn_blocks_match(name, hessian):
    (jv, jn), (tv, tn) = PROBLEMS[name]()
    jd, td = carry_data(jv, tv)
    tD, tO, jD, jO = blocks_both(jn, jd, tn, td, hessian)
    np.testing.assert_allclose(tD, jD, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(jD).max()))
    np.testing.assert_allclose(tO, jO, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(jD).max()))


def test_variants_differ_where_they_should():
    """On a curved problem the three variants are three sets of blocks;
    on linear dynamics without inequality curvature "gn" equals
    "defect"."""
    (jv, jn), (tv, tn) = PROBLEMS["uas_eq"]()
    jd, td = carry_data(jv, tv)
    D = {h: blocks_both(jn, jd, tn, td, h)[0] for h in
         ("gn", "defect", "full")}
    assert np.abs(D["gn"] - D["defect"]).max() > 1e-3
    assert np.abs(D["full"] - D["defect"]).max() > 1e-3
    (jv, jn), (tv, tn) = PROBLEMS["mip"]()
    jd, td = carry_data(jv, tv)
    a = blocks_both(jn, jd, tn, td, "gn")
    b = blocks_both(jn, jd, tn, td, "defect")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_unknown_hessian_raises():
    with pytest.raises(ValueError, match="hessian"):
        tal.SolverConfig(hessian="exact")
    assert tal.SolverConfig().hessian == jal.SolverConfig().hessian


def _free_space_uas(pkg):
    """uas_2d without obstacles and with a convex turn-rate limit: every
    variant's blocks stay positive definite, so each converges."""
    vgp, nlp = pkg.uas_2d(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))
    return vgp, dataclasses.replace(
        nlp, use_obstacles=False,
        path_ineq=(lambda x, u, t, d: u[1] ** 2 - 0.05,))


@pytest.mark.parametrize("hessian", ["gn", "full"])
def test_variant_solve_outcome_matches(hessian):
    """A curved problem under each variant: the status of the JAX
    package's solve and its objective to 1e-3. (On the canonical OCP
    "full" ends MAX_ITER in both packages: its obstacle curvature turns
    blocks indefinite, as the config's comment warns.)"""
    jv, jn = _free_space_uas(jproblems)
    tv, tn = _free_space_uas(tproblems)
    jd, td = carry_data(jv, tv)
    jres = jal.solve(jn, jal.SolverConfig(hessian=hessian), jd)
    tres = tal.solve(tn, tal.SolverConfig(hessian=hessian), td)
    assert int(tres.status) == int(jres.status) == 1
    np.testing.assert_allclose(float(tres.obj), float(jres.obj), rtol=1e-3)
    assert float(tres.viol_eq) <= 1e-4 and float(tres.viol_in) <= 1e-4
    if hessian == "gn":
        # without the defect curvature the unicycle takes more iterations
        full = tal.solve(tn, tal.SolverConfig(), td)
        assert int(tres.inner_iters) > int(full.inner_iters)
