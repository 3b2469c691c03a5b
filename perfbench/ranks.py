"""A run of one cell on the devices its ``chips`` names.

On one device the run is :func:`harness.run` in this process: no process is
started and no process group made. A cell of n > 1 cards runs as n ranks,
one card and one process each:

* **Launch.** The calling process is rank 0. It starts ranks 1..n-1 as
  processes of its own (this file, run as a script), and all meet at a
  ``FileStore`` under ``build/perfbench/`` of the checkout: no port. Rank r
  builds the cell's entry on ``cuda:r`` (on the CPU, for tests, every rank
  on the CPU).
* **Groups.** The program's group, the default one (NCCL on cards, gloo on
  the CPU), goes to the entry, which shards and gathers over it. A second
  group, gloo on the host, carries the harness's own messages.
* **Window.** Every rank runs the same set-up and the same ops in the same
  order (the draws are keyed by seed, stream and index, so every rank
  draws the same inputs). The window starts at a barrier; rank 0 owns the
  clock, and once an op or episode has been dispatched every rank learns
  from it whether to go on, and whether an op raised on any rank (a fault
  on one rank ends the window on all, counted once in ``failed``).
* **Results.** Rank 0 holds each op's whole result (gathering the lanes is
  the entry's job). After the window every rank sends rank 0 its ops'
  count and its peak memory; rank 0 alone checks, reads the metrics and
  returns the line, ``device.count`` n and ``memory_peak_bytes`` the
  fullest card's. Rank 0's card gives the spans and the trace.
* **Faults.** A program collective gives up after ``TIMEOUT_S``; a host
  message after ``TIMEOUT_S + GRACE_S`` (a rank may wait a program
  collective out before it reaches one). Rank 0 ends the run ``GRACE_S``
  after ``seconds + TIMEOUT_S`` from the window's start whatever the
  ranks do, with a non-zero exit and no line; a rank dies with rank 0;
  rank 0 waits for each rank it started and kills one that has not ended.

    python3 perfbench/ranks.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> --rank <r> --size <n> --store <path> --device <type>
        --root <checkout> --timeout <s> --parent <pid>

is how rank 0 starts rank r; nothing else starts this file.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from perfbench import harness  # noqa: E402

#: seconds a program collective waits for the other ranks
TIMEOUT_S = 60.0
#: seconds past the window's length and TIMEOUT_S before rank 0 ends the run
GRACE_S = 60.0


def device_of(device_type: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: its own card, or the CPU."""
    return (torch.device("cuda", rank) if device_type == "cuda"
            else torch.device("cpu"))


class Ranks:
    """This process's place among a cell's ranks: its number, the ranks'
    count, the program's group and the host's group (rank 0 also holds the
    processes it started, to end them)."""

    def __init__(self, rank: int, size: int, group, host, timeout: float,
                 procs=()):
        self.rank, self.size = rank, size
        self.group, self.host = group, host
        self.timeout = timeout
        self.procs = list(procs)
        self._watch = None

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(group=self.host)

    def decide(self, expired: bool, raised: bool):
        """(stop, faulted) after an op: rank 0's ``expired``, and whether
        ``raised`` holds on any rank."""
        import torch.distributed as dist

        t = torch.tensor([int(expired) if self.rank == 0 else 0,
                          int(raised)], dtype=torch.int64)
        dist.all_reduce(t, group=self.host)
        return bool(t[0]), bool(t[1])

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def watch(self, seconds: float):
        """On rank 0: end the run, every rank with it, if the window and
        the exchange after it have not closed within ``seconds`` +
        ``timeout`` + GRACE_S."""
        if self.rank != 0:
            return
        self._watch = threading.Timer(seconds + self.timeout + GRACE_S,
                                      self._expire, args=(seconds,))
        self._watch.daemon = True
        self._watch.start()

    def _expire(self, seconds):
        harness.log(f"ranks: the window has not closed {seconds} + "
                    f"{self.timeout} + {GRACE_S} s after its start; ending "
                    "the run")
        reap(self.procs, 0.0)
        os._exit(3)

    def close(self):
        """Leave both groups (the window's exchange is over)."""
        import torch.distributed as dist

        if self._watch is not None:
            self._watch.cancel()
        dist.destroy_process_group()


def join(rank: int, size: int, store: str, device: torch.device,
         timeout: float = TIMEOUT_S, procs=()) -> Ranks:
    """Join the cell's ranks at the file ``store``."""
    import torch.distributed as dist

    # every rank is on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        store=dist.FileStore(store, size), rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout))
    host = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=timeout + GRACE_S))
    return Ranks(rank, size, dist.group.WORLD, host, timeout, procs)


def reap(procs, wait_s: float):
    """Wait up to ``wait_s`` for the ranks ``procs`` (ranks 1, 2, ...), then
    kill those still running; log a rank that did not end with code 0."""
    deadline = time.monotonic() + wait_s
    for r, p in enumerate(procs, 1):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode:
            harness.log(f"ranks: rank {r} ended with code {p.returncode}")


def run(cell_name: str, seed: int, seconds: float, trace: bool, chips: int,
        device_type: str = "cuda", root: str = harness.ROOT,
        timeout: float = TIMEOUT_S, **kw):
    """One run of a cell on ``chips`` devices of ``device_type``; returns
    rank 0's line, or None where it may print none. ``kw``: the rest of
    :func:`harness.run`'s arguments, for rank 0."""
    if chips == 1:
        return harness.run(cell_name, seed, seconds, trace,
                           device=device_of(device_type, 0), root=root, **kw)
    store = os.path.join(root, "build", "perfbench", f"ranks.{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    procs, done = [], False
    try:
        for r in range(1, chips):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--workload", cell_name, "--seed", str(seed),
                 "--seconds", repr(float(seconds)),
                 "--trace", str(int(trace)), "--rank", str(r),
                 "--size", str(chips), "--store", store,
                 "--device", device_type, "--root", root,
                 "--timeout", repr(float(timeout)),
                 "--parent", str(os.getpid())],
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
        ranks = join(0, chips, store, device_of(device_type, 0), timeout,
                     procs)
        line = harness.run(cell_name, seed, seconds, trace,
                           device=device_of(device_type, 0), root=root,
                           ranks=ranks, **kw)
        done = True
        return line
    finally:
        reap(procs, GRACE_S if done else 0.0)
        if os.path.exists(store):
            os.remove(store)


def _die_with_parent(parent: int):
    """Have the kernel kill this process when its parent, rank 0, ends."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="rank r > 0 of a cell's run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--size", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    torch.set_num_threads(4)
    harness.LOG_PREFIX = f"rank {args.rank}: "
    device = device_of(args.device, args.rank)
    ranks = join(args.rank, args.size, args.store, device, args.timeout)
    harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                device=device, root=args.root, ranks=ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
