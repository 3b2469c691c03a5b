"""Port parity: cyclic reduction. Seeded numpy systems go through the JAX
package's ``ops.cyclic_reduction.solve``, a dense float64 solve and the
port's batch-native ``ops.cyclic_reduction``.

Tolerance: rtol 3e-4, atol 3e-5, the limits ``tests/test_cyclic_reduction
.py`` holds the JAX function to against the dense solve (float32
elimination over log2(K) levels); the refined solve against the refined
block Cholesky at atol/rtol 2e-4, the limit of the KKT kernel's tests."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.ops import cyclic_reduction as jcr
from etol_tpu_torch.core.problem import VGP
from etol_tpu_torch.ops import bt_cuda
from etol_tpu_torch.ops import cyclic_reduction as tcr
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import btridiag as tbt
from etol_tpu_torch.transcribe.nlp import NLP

torch.set_num_threads(1)


def _spd(rng, K, w, lead=(), coupling=0.3):
    D = rng.normal(size=lead + (K, w, w))
    D = D @ np.swapaxes(D, -1, -2) + 5.0 * np.eye(w)
    O = rng.normal(size=lead + (max(K - 1, 0), w, w)) * coupling
    r = rng.normal(size=lead + (K, w))
    return D, O, r


def _dense_solve(D, O, r):
    K, w = r.shape
    H = np.zeros((K, w, K, w))
    for k in range(K):
        H[k, :, k, :] = D[k]
    for k in range(K - 1):
        H[k, :, k + 1, :] = O[k]
        H[k + 1, :, k, :] = O[k].T
    return np.linalg.solve(H.reshape(K * w, K * w), r.reshape(-1)).reshape(
        K, w)


def _t(*arrs):
    return [torch.tensor(a, dtype=torch.float32) for a in arrs]


@pytest.mark.parametrize("K,w", [(1, 3), (4, 4), (7, 5), (33, 4), (51, 5)])
def test_matches_jax_and_dense(K, w):
    rng = np.random.default_rng(K * 7 + w)
    D, O, r = _spd(rng, K, w)
    x = tcr.solve(*_t(D, O, r)).numpy()
    xj = np.asarray(jcr.solve(*(jnp.asarray(a, jnp.float32)
                                for a in (D, O, r))))
    np.testing.assert_allclose(x, xj, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(x, _dense_solve(D, O, r), rtol=3e-4,
                               atol=3e-5)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_leading_dims_are_lanes(lead):
    rng = np.random.default_rng(0)
    K, w = 9, 4
    D, O, r = _t(*_spd(rng, K, w, lead))
    xs = tcr.solve(D, O, r)
    assert xs.shape == lead + (K, w)
    np.testing.assert_allclose(tbt.matvec(D, O, xs).numpy(), r.numpy(),
                               atol=2e-3)
    flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in (D, O, r)]
    for b in range(flat[0].shape[0]):
        one = tcr.solve(*(a[b] for a in flat))
        np.testing.assert_allclose(
            xs.reshape((-1, K, w))[b].numpy(), one.numpy(), rtol=1e-5,
            atol=1e-6)


@pytest.mark.parametrize("K,w", [(51, 5), (41, 6), (101, 9), (21, 10)])
def test_refined_matches_the_refined_block_cholesky(K, w):
    rng = np.random.default_rng(K + w)
    D, O, r = _t(*_spd(rng, K, w, (4,)))
    x = tcr.solve_refined(D, O, r)
    np.testing.assert_allclose(x.numpy(),
                               tbt.solve_refined(D, O, r).numpy(),
                               rtol=2e-4, atol=2e-4)
    # the refinement does not make the residual worse
    res0 = (r - tbt.matvec(D, O, tcr.solve(D, O, r))).abs().max()
    res1 = (r - tbt.matvec(D, O, x)).abs().max()
    assert float(res1) <= float(res0) + 1e-6


def test_indefinite_lane_is_not_finite_and_alone():
    rng = np.random.default_rng(1)
    D, O, r = _spd(rng, 6, 3, (4,))
    good = tcr.solve_refined(*_t(D, O, r))
    D[2, 1] = -np.eye(3)
    x = tcr.solve_refined(*_t(D, O, r))
    assert not bool(torch.isfinite(x[2]).all())
    keep = [0, 1, 3]
    assert torch.equal(x[keep], good[keep])


def _wide_problem(device="cpu"):
    """A 6-state, 4-control integrator: node width 10, above the KKT
    kernel's 9."""
    vgp = VGP(nsteps=6, dt=0.5)
    vgp.x0 = [0.0] * 6
    vgp.xf = [1.0, 0.5, -0.5, 0.2, 0.3, 0.1]
    vgp.xtol = [0.05] * 4 + [10.0] * 2  # the last two follow the first
    vgp.xlower, vgp.xupper = [-5.0] * 6, [5.0] * 6
    vgp.ulower, vgp.uupper = [-2.0] * 4, [2.0] * 4
    nlp = NLP(
        dims=vgp.dims(),
        dynamics=lambda x, u, t, d: torch.cat([u, u[:2] * x[:2].cos()]),
        running_cost=lambda x, u, t, d: torch.sum(u * u),
        use_obstacles=False,
    )
    data, _ = vgp.to_device(device=device)
    return nlp, data


def test_solver_routes_wide_nodes_to_cyclic_reduction(monkeypatch):
    nlp, data = _wide_problem()
    assert nlp.dims.node_width == 10 > bt_cuda.MAX_W
    batch = tal.tree_map(lambda a: torch.stack([a, a]), data)
    batch = dataclasses.replace(
        batch, xf=batch.xf + torch.tensor([[0.0], [0.1]]))
    cfg = tal.SolverConfig(kkt_solver="kernel", max_total=200)
    assert tal._ALFuncs(nlp, cfg, batch).kkt == "cr"
    def no_kernel(*a, **kw):
        raise AssertionError("the kernel's wrapper was called at w=10")

    monkeypatch.setattr(bt_cuda, "solve", no_kernel)
    res = tal.solve_batched(nlp, cfg, batch)
    ref = tal.solve_batched(
        nlp, dataclasses.replace(cfg, kkt_solver="cr"), batch)
    assert torch.equal(res.z, ref.z)
    assert res.status.tolist() == [1, 1]
    scan = tal.solve_batched(
        nlp, dataclasses.replace(cfg, kkt_solver="scan"), batch)
    assert scan.status.tolist() == [1, 1]
    np.testing.assert_allclose(res.obj.numpy(), scan.obj.numpy(), rtol=1e-3)
