"""The card's peaks and the KKT solve's count of work, the yardstick of the
KKT kernel's roofline share.

A block-tridiagonal solve of B lanes, K nodes of width w, needs
(10/3 w^3 + 18 w^2) flop a node and lane (the block Cholesky by the Schur
recurrence, both sweeps, one refinement pass), and reads D [B, K, w, w],
O [B, K-1, w, w] and r [B, K, w] once and writes x [B, K, w] once, in
float32. The least time is the larger of flop over the float32 peak outside
the tensor cores and bytes over the memory's bandwidth.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet's dense float32 rate and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: input sets of one timing, rotated so each launch reads from memory
SET_BYTES = 100 * 2 ** 20
#: a kernel's time: the median of REPS replays of a graph of INNER launches
REPS, INNER = 20, 10


def kkt_flops(K: int, w: int, B: int) -> float:
    return (10.0 / 3.0 * w ** 3 + 18.0 * w ** 2) * K * B


def kkt_bytes(K: int, w: int, B: int) -> float:
    return 4.0 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)


def kkt_bound_ms(K: int, w: int, B: int) -> float:
    return 1e3 * max(kkt_flops(K, w, B) / PEAK_FLOPS,
                     kkt_bytes(K, w, B) / PEAK_BYTES_PER_S)


def _problem_sets(K, w, B, seed):
    """SPD block-tridiagonal systems made on the card, in as many sets as
    hold more than SET_BYTES together (2 to 64)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = max(2, min(64, -(-SET_BYTES // int(kkt_bytes(K, w, B)))))
    eye = 5 * torch.eye(w, device="cuda")
    sets = []
    for _ in range(n):
        A = torch.randn((B, K, w, w), generator=gen, device="cuda")
        O = 0.3 * torch.randn((B, K - 1, w, w), generator=gen, device="cuda")
        r = torch.randn((B, K, w), generator=gen, device="cuda")
        sets.append(((A @ A.transpose(-1, -2) + eye).contiguous(), O, r))
    return sets


def kernel_ms(K: int, w: int, B: int):
    """The KKT kernel's own ms a solve at (K, w, B): the median over REPS
    replays of a CUDA graph of INNER launches over rotating inputs, each
    replay between two CUDA events."""
    import torch
    from etol_tpu_torch.ops import bt_cuda

    sets = _problem_sets(K, w, B, seed=B)

    def call(i):
        D, O, r = sets[i % len(sets)]
        return bt_cuda.solve(D, O, r)

    call(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = [call(i) for i in range(1, INNER + 1)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / INNER)
    del held, sets
    times.sort()
    return times[len(times) // 2]
