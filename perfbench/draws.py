"""Traffic: every input a window hands the program, drawn from a generator
keyed by (seed, stream, index), so that op k of seed s is the same in any run
and whatever the window's length.

A traffic mix is a JSON file of parameters in ``traffic/``; this is the one
generator that reads them. Keys:

* ``loop``: "fleet" (a closed loop of batches) or "episodes" (a closed loop
  of one client's MPC episodes: a cold solve, then ``ticks`` re-solves);
* ``batch``: lanes a batch (fleet);
* ``x0_offset`` / ``xf_offset``: {"low": [...], "high": [...]}, one entry a
  state: each lane's start / goal is the configuration's plus a uniform
  offset in [low, high); ``null`` keeps the configuration's;
* ``start``: "cold", or "warm": re-solves warm-started from the result
  before, in chains of ``chain``, the k-th of a chain with every start moved
  by ``drift`` * k per state, from one of ``bases`` cold batches solved in
  set-up;
* ``rescue_lanes``: the facade's rescued lanes a cold batch (fleet);
* ``ticks``: re-solves an episode (episodes);
* ``pool``: episodes drawn from a pool of this many starts (episodes);
* ``pool_seed``: where ``bases`` or ``pool`` is given, the batches or
  starts are drawn under this seed, the same for every run, and the run's
  seed only orders them: each pass over them a permutation of its own
  (:func:`pool_index`). A window's work then hardly depends on its seed.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "traffic")
#: the streams a run draws from, each its own part of the key: a stream's
#: place here is in its key, so a name no run draws from any more
#: ("profiled") keeps its place
STREAMS = ("batch", "seeds", "episode", "setup", "warmup", "profiled",
           "order")


def load_traffic(name: str, traffic_dir: str = TRAFFIC_DIR) -> dict:
    with open(os.path.join(traffic_dir, f"{name}.json")) as fh:
        return json.load(fh)


def key(seed: int, stream: str, index: int) -> int:
    """A 63-bit generator seed for op ``index`` of ``stream`` under the run's
    ``seed`` (any whole number: it is taken modulo 2**64)."""
    ss = np.random.SeedSequence(
        [seed % 2 ** 64, STREAMS.index(stream), index])
    lo, hi = ss.generate_state(2, dtype=np.uint32)
    return (int(hi) << 32 | int(lo)) & (2 ** 63 - 1)


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by :func:`key`: draws on the card
    need no copy and no wait."""
    return torch.Generator(device=device).manual_seed(
        key(seed, stream, index))


def offsets(spec, n: int, gen: torch.Generator, dtype=torch.float32):
    """[n, len(low)] uniform offsets in [low, high) on the generator's
    device; None where ``spec`` is None."""
    if spec is None:
        return None
    dev = gen.device
    low = torch.tensor(spec["low"], dtype=dtype, device=dev)
    high = torch.tensor(spec["high"], dtype=dtype, device=dev)
    u = torch.rand((n, low.shape[0]), generator=gen, device=dev, dtype=dtype)
    return low + (high - low) * u


def starts_goals(traffic: dict, x0, xf, n: int, gen: torch.Generator):
    """(x0 [n, nx], xf [n, nx]) of one batch or episode: the problem's
    start and goal ``x0``, ``xf`` [nx] plus the mix's offsets, both drawn
    from ``gen`` in that order."""
    dx0 = offsets(traffic.get("x0_offset"), n, gen, x0.dtype)
    dxf = offsets(traffic.get("xf_offset"), n, gen, xf.dtype)
    x0s = x0.expand(n, -1) + (0 if dx0 is None else dx0)
    xfs = xf.expand(n, -1) + (0 if dxf is None else dxf)
    return x0s.contiguous(), xfs.contiguous()


def pool_index(seed: int, pool: int, i: int) -> int:
    """The pool entry of the run's i-th use of a pool of ``pool``: pass
    i // pool over the pool in a permutation drawn for (seed, pass)."""
    perm = torch.randperm(pool, generator=generator(seed, "order",
                                                    i // pool, "cpu"))
    return int(perm[i % pool])
