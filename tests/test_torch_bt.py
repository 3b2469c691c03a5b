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
    before = bt_cuda.TALLY.count
    x = bt_cuda.solve(*_t(D, O, r))
    assert torch.equal(x, tbt.solve_refined(*_t(D, O, r)))
    assert bt_cuda.TALLY.count == before  # no kernel ran


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
    # the stream kernel: the lane split of the shared-memory kernel, 32 // w
    # lanes a warp, the factor in device memory, a read-ahead ring in
    # shared memory
    pl = bt_cuda.plan(K, w, B)
    assert pl.variant == "stream"
    assert pl.group == w and pl.threads == 32
    assert pl.lanes_per_block == 32 // w
    assert pl.blocks == -(-B // (32 // w))
    assert 0 < pl.smem_bytes <= bt_cuda.SMEM_LIMIT
    assert pl.scratch_bytes == 4 * B * pl.lane_stride
    with pytest.raises(ValueError, match="shared memory"):
        bt_cuda.plan(K, w, B, variant="smem")


# the last horizon whose lane factor fits a block's shared memory, and the
# first that does not, at each width
SWITCH = {4: 1615, 5: 1077, 6: 808, 8: 501, 9: 388}


@pytest.mark.parametrize("B", [1, 8, 256])
@pytest.mark.parametrize("w", sorted(SWITCH))
def test_plan_switches_to_the_stream_kernel_where_one_lane_no_longer_fits(
        w, B):
    below = bt_cuda.plan(SWITCH[w] - 1, w, B)
    at = bt_cuda.plan(SWITCH[w], w, B)
    assert below.variant == "smem" and below.lanes_per_block == 1
    assert below.smem_bytes <= bt_cuda.SMEM_LIMIT
    assert at.variant == "stream" and at.lanes_per_block == 32 // w
    assert 4 * (at.lane_stride + 4) > bt_cuda.SMEM_LIMIT


@pytest.mark.parametrize("K,w,B", [(2048, 4, 1), (2048, 5, 1), (2047, 5, 3),
                                   (2048, 5, 64), (388, 9, 256), (1, 1, 1),
                                   (51, 5, 7)])
def test_plan_stream_scratch_is_the_per_lane_layout(K, w, B):
    # per lane (p4(w(w+1)/2) + p4(w^2) + 2w) K floats, rounded up to a
    # multiple of 4 so that every lane's factor starts on 16 bytes; in
    # shared memory two barriers (16 bytes) and two buffers a lane, each 16
    # nodes' factor and Lsub and two runs of 16 w floats with 4 to spare
    def p4(n):
        return -(-n // 4) * 4

    pl = bt_cuda.plan(K, w, B, variant="stream")
    per_lane = (p4(w * (w + 1) // 2) + p4(w * w) + 2 * w) * K
    assert bt_cuda.lane_floats(K, w) == per_lane
    assert pl.lane_stride == p4(per_lane) and pl.lane_stride % 4 == 0
    assert pl.scratch_bytes == 4 * B * p4(per_lane)
    node = p4(w * (w + 1) // 2) + p4(w * w)
    assert bt_cuda.STREAM_CHUNK == 16
    assert pl.smem_bytes == 4 * (32 // w) * (4 + 2 * (16 * node + 32 * w + 8))


def test_plan_stream_scratch_sizes():
    # the sizes the long-horizon shapes ask of device memory
    mb = {s: bt_cuda.plan(*s).scratch_bytes / 1e6
          for s in [(2048, 4, 1), (2048, 5, 1), (2048, 5, 64),
                    (388, 9, 256)]}
    assert mb == pytest.approx({(2048, 4, 1): 0.294912,
                                (2048, 5, 1): 0.442368,
                                (2048, 5, 64): 28.311552,
                                (388, 9, 256): 59.5968})


def test_plan_variant_can_be_forced_and_is_checked():
    assert bt_cuda.plan(51, 5, 64, variant="stream").variant == "stream"
    assert bt_cuda.plan(51, 5, 64, variant="smem") == bt_cuda.plan(51, 5, 64)
    assert bt_cuda.plan(2048, 5, 1, variant="stream") == bt_cuda.plan(
        2048, 5, 1)
    assert set(bt_cuda.VARIANTS) == {"smem", "stream"}
    # "global", the first port's thread-a-lane kernel, left the source
    for name in ("fast", "global"):
        with pytest.raises(ValueError, match="unknown variant"):
            bt_cuda.plan(51, 5, 64, variant=name)


@pytest.mark.parametrize("K,w", [(1615, 4), (1077, 5), (388, 9)])
def test_plain_matches_scan_at_the_stream_kernels_horizons(K, w):
    # the horizons the stream kernel takes: the plain version (which a
    # CPU tensor gets from the wrapper) against the JAX package's scan
    # solve; the Pallas kernel's VMEM limit is below these horizons (it
    # falls back to cyclic reduction there), so it is not run
    D, O, r = _problem(2, K, w, seed=K)
    x_scan = np.asarray(jax.vmap(jbt.solve)(D, O, r))
    x = bt_cuda.solve(*_t(D, O, r)).numpy()
    np.testing.assert_allclose(x, x_scan, rtol=TOL, atol=TOL)
    back = tbt.matvec(*_t(D, O), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(back, r, atol=2e-3)


def test_plan_fewer_lanes_where_shared_memory_holds_fewer():
    # K=250, w=9: one lane is 144 KB, so a block takes one lane, not 3
    pl = bt_cuda.plan(250, 9, 10)
    assert pl.variant == "smem" and pl.lanes_per_block == 1
    assert pl.blocks == 10 and pl.smem_bytes <= 232_448


def test_library_path_is_keyed_by_the_source(tmp_path):
    # another version of the source (kernel_ab's A/B) builds to its own
    # library; the same text to the same one
    text = open(bt_cuda._SOURCE).read()
    other = tmp_path / "bt_solve.cu"
    other.write_text(text)
    assert bt_cuda.library_path(str(other)) == bt_cuda.library_path()
    other.write_text(text + "\n// another version\n")
    assert bt_cuda.library_path(str(other)) != bt_cuda.library_path()


def test_kernel_ab_refuses_to_run_without_a_card(monkeypatch):
    from etol_tpu_torch import kernel_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_ab.main(["other.cu"])
