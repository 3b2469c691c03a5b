"""Port parity: the block-tridiagonal KKT solve. The port's plain block
Cholesky (factor, solve, one refinement pass) against the JAX package's
Pallas kernel in interpret mode and its ``jax.vmap(btridiag.solve)``, on
the SPD problems ``tests/test_pallas_bt.py`` makes; and the CUDA
kernel's wrapper on CPU tensors, which must be exactly that plain
version.

Tolerance: atol/rtol 2e-4, as ``tests/test_pallas_bt.py`` uses for the
Pallas kernel against the scan — float32 sweeps over K nodes in another
operation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.ops import pallas_bt
from etol_tpu.solve import btridiag as jbt
from etol_tpu_torch.ops import bt_cuda
from etol_tpu_torch.solve import btridiag as tbt

torch.set_num_threads(1)

TOL = 2e-4


def _problem(B, K, w, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(B, K, w, w)).astype(np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 5 * np.eye(w, dtype=np.float32)
    O = (rng.normal(size=(B, K - 1, w, w)) * 0.3).astype(np.float32)
    r = rng.normal(size=(B, K, w)).astype(np.float32)
    return D, O, r


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("K,w", [(4, 3), (9, 4), (17, 5), (13, 9)])
def test_plain_matches_pallas_and_scan(K, w):
    D, O, r = _problem(128, K, w, seed=K + w)
    x_pallas = np.asarray(
        pallas_bt.solve_lanes(jnp.asarray(D), jnp.asarray(O),
                              jnp.asarray(r), True)
    )
    x_scan = np.asarray(jax.vmap(jbt.solve)(D, O, r))
    x = tbt.solve_refined(*_t(D, O, r)).numpy()
    np.testing.assert_allclose(x, x_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x, x_scan, rtol=TOL, atol=TOL)
    # without the refinement pass too
    np.testing.assert_allclose(tbt.solve(*_t(D, O, r)).numpy(), x_scan,
                               rtol=TOL, atol=TOL)
    # the residual of the refined solve is small
    back = tbt.matvec(*_t(D, O), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(back, r, atol=2e-3)


def test_factor_and_matvec_match_jax():
    D, O, r = _problem(8, 6, 5, seed=3)
    Ld, Ls = tbt.factor(*_t(D, O))
    jLd, jLs = jax.vmap(jbt.factor)(D, O)
    np.testing.assert_allclose(Ld.numpy(), np.asarray(jLd), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(Ls.numpy(), np.asarray(jLs), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        tbt.matvec(*_t(D, O, r)).numpy(),
        np.asarray(jax.vmap(jbt.matvec)(D, O, r)), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("K,w", [(1, 3), (17, 5), (51, 5)])
def test_wrapper_on_cpu_is_the_plain_version(K, w):
    D, O, r = _problem(16, K, w, seed=7)
    before = bt_cuda.LAUNCHES
    x = bt_cuda.solve(*_t(D, O, r))
    assert torch.equal(x, tbt.solve_refined(*_t(D, O, r)))
    assert bt_cuda.LAUNCHES == before  # no kernel ran


def test_indefinite_block_gives_nan():
    D, O, r = _problem(4, 5, 3, seed=1)
    D[2, 1] = -np.eye(3, dtype=np.float32)
    x = bt_cuda.solve(*_t(D, O, r)).numpy()
    assert np.isnan(x[2]).any()
    assert np.isfinite(x[[0, 1, 3]]).all()


def test_wrapper_rejects_bad_inputs():
    # a direct call at w > 9 is an error: the solver picks cyclic
    # reduction from the width and never gets here
    # (tests/test_torch_cr.py holds that route)
    D, O, r = _problem(2, 4, 10)
    with pytest.raises(ValueError, match="cyclic reduction"):
        bt_cuda.solve(*_t(D, O, r))
    D, O, r = _problem(2, 4, 3)
    with pytest.raises(TypeError, match="float32"):
        bt_cuda.solve(*[torch.from_numpy(a.astype(np.float64))
                        for a in (D, O, r)])
    Dt, Ot, rt = _t(D, O, r)
    with pytest.raises(ValueError, match="O must be"):
        bt_cuda.solve(Dt, Ot[:, :-1], rt)
    with pytest.raises(ValueError, match="contiguous"):
        bt_cuda.solve(Dt.transpose(-1, -2), Ot, rt)


LADDER = [(51, 5), (21, 6), (41, 6), (101, 9)]
BATCHES = [3, 64, 1000, 2048]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K,w", LADDER)
def test_plan_ladder_shapes_take_the_shared_memory_kernel(K, w, B):
    pl = bt_cuda.plan(K, w, B)
    assert pl.variant == "smem"
    assert 0 < pl.smem_bytes <= 232_448
    assert pl.lanes_per_block >= 1
    assert pl.group >= w
    assert pl.group * pl.lanes_per_block <= pl.threads == 32
    assert pl.blocks * pl.lanes_per_block >= B
    assert (pl.blocks - 1) * pl.lanes_per_block < B
    # the factor and Lsub of a node padded to 16 bytes, y and c; the lane
    # stride an odd multiple of 4 floats (16-byte loads, bank spread)
    def p4(n):
        return -(-n // 4) * 4

    per_lane = (p4(w * (w + 1) // 2) + p4(w * w) + 2 * w) * K
    assert per_lane <= pl.lane_stride <= per_lane + 7
    assert pl.lane_stride % 8 == 4
    assert pl.smem_bytes == 4 * pl.lanes_per_block * pl.lane_stride


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K,w", [(2048, 5), (600, 9)])
def test_plan_long_horizon_takes_the_device_memory_kernel(K, w, B):
    pl = bt_cuda.plan(K, w, B)
    assert pl.variant == "global"
    assert pl.smem_bytes == 0
    assert pl.blocks * pl.lanes_per_block >= B
    with pytest.raises(ValueError, match="shared memory"):
        bt_cuda.plan(K, w, B, variant="smem")


def test_plan_variant_can_be_forced_and_is_checked():
    assert bt_cuda.plan(51, 5, 64, variant="global").variant == "global"
    assert bt_cuda.plan(51, 5, 64, variant="smem") == bt_cuda.plan(51, 5, 64)
    with pytest.raises(ValueError, match="unknown variant"):
        bt_cuda.plan(51, 5, 64, variant="fast")


def test_plan_fewer_lanes_where_shared_memory_holds_fewer():
    # K=250, w=9: one lane is 144 KB, so a block takes one lane, not 3
    pl = bt_cuda.plan(250, 9, 10)
    assert pl.variant == "smem" and pl.lanes_per_block == 1
    assert pl.blocks == 10 and pl.smem_bytes <= 232_448
