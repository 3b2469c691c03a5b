"""Every input of a window comes from a generator keyed by (seed, stream,
op): op k of seed s is the same in any run and whatever the window's
length."""
import dataclasses

import torch

from perfbench import draws, harness
from perfbench.trace import Spans


def test_key_is_fixed_and_separates_its_parts():
    k = draws.key(2 ** 31 + 12345, "batch", 7)
    assert k == draws.key(2 ** 31 + 12345, "batch", 7)
    assert 0 <= k < 2 ** 63
    others = {draws.key(2 ** 31 + 12345, "batch", 8),
              draws.key(2 ** 31 + 12346, "batch", 7),
              draws.key(2 ** 31 + 12345, "seeds", 7)}
    assert k not in others and len(others) == 3


def test_batch_draws_repeat_and_differ_by_index():
    t = draws.load_traffic("fleet_cold")
    x0, xf = torch.zeros(3), torch.tensor([8.0, 6.0, 0.0])

    def batch(seed, k):
        return draws.starts_goals(t, x0, xf, 16,
                                  draws.generator(seed, "batch", k, "cpu"))

    a, b = batch(5, 3), batch(5, 3)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c = batch(5, 4)
    assert not torch.equal(a[0], c[0])
    # the mix's offsets: +-0.5 in position, heading left at the problem's
    assert a[0][:, :2].abs().max() <= 0.5 and a[0][:, 2].abs().max() == 0
    assert (a[1][:, :2] - xf[:2]).abs().max() <= 0.5


@dataclasses.dataclass
class _Res:
    z: torch.Tensor
    obj: torch.Tensor
    status: torch.Tensor
    lam_def: torch.Tensor
    mu: torch.Tensor


class _Stub:
    """An entry that answers at once: what a window handed it is what is
    compared."""

    synced = False

    def __init__(self, nx=3):
        self.x0, self.xf = torch.zeros(nx), torch.tensor([8.0, 6.0, 0.0])
        self.seen = []

    def batch(self, x0, xf, seeds, spans, k):
        z0 = torch.rand((x0.shape[0], 4), generator=seeds())
        self.seen.append((x0.clone(), xf.clone(), z0.clone()))
        B = x0.shape[0]
        return _Res(torch.zeros(B, 1), torch.zeros(B),
                    torch.ones(B, dtype=torch.int32), torch.zeros(B, 1),
                    torch.zeros(B, 1))


def _window(seconds):
    bench = harness.load_benchmark()
    t = dict(draws.load_traffic("fleet_cold"), batch=8)
    cell = harness.Cell("uas2d_fleet_cold", "cpu", bench, traffic=t)
    cell.entry = _Stub()
    w = cell.window(2 ** 31 + 99, seconds, Spans(False))
    return cell.entry.seen, w


def test_op_k_is_the_same_whatever_the_window_length():
    short, ws = _window(0.0)
    long, wl = _window(0.2)
    assert len(short) == 1 and len(long) > len(short)
    for (a0, af, az), (b0, bf, bz) in zip(short, long):
        assert torch.equal(a0, b0) and torch.equal(af, bf)
        assert torch.equal(az, bz)
    assert not torch.equal(long[0][0], long[1][0])


def test_pool_passes_are_permutations_fixed_by_seed_and_pass():
    seq = [draws.pool_index(2 ** 31 + 5, 6, i) for i in range(18)]
    assert seq == [draws.pool_index(2 ** 31 + 5, 6, i) for i in range(18)]
    for p in range(3):
        assert sorted(seq[6 * p:6 * p + 6]) == list(range(6))
    other = [draws.pool_index(2 ** 31 + 6, 6, i) for i in range(18)]
    assert other != seq
