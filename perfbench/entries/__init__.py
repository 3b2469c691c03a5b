"""The program under test, as a configuration's ``entry`` names it: the
file ``entries/<entry>.py`` beside this one, loaded by its path. Each file
calls the public entries of ``etol_tpu_torch`` and nothing else of it, and
takes its problem's numbers from the configuration's file, so that the
program and the reference read the same file.

The contract. The file defines ``Entry``, built once a run (on each rank):

``Entry(config, traffic, device, group, config_dir)``
    ``config`` and ``traffic`` the cell's files as dicts, ``device`` the
    rank's ``torch.device``, ``group`` the program's process group over
    the cell's ranks (NCCL on cards, gloo on the CPU; None on one card),
    ``config_dir`` the directory of the configuration's file (and of any
    file it names).

``synced``
    True where ``batch`` returns only once its result is ready (the
    harness then times a batch's end on the host at the call's return);
    False where it returns at once (the harness queues batch k+1 while
    batch k runs and waits on an event).

``x0``, ``xf``
    The problem's start and goal, [nx] tensors on ``device``: the draws'
    offsets are added to these.

``batch(x0, xf, seeds, spans, k)`` (fleets)
    One cold batch of starts and goals [B, nx]. ``seeds()`` returns the
    generator of the batch's other draws (call it once, outside any span);
    ``spans(name, k)`` is a context that files the card's launches under
    ``name`` in a traced run: the solve's under ``perfbench.solve``, its
    seeds' under ``perfbench.seeds``.

``warm(x0, xf, prev)`` (warm fleets)
    A re-solve of starts ``x0`` [B, nx] warm-started from ``prev``, the
    result before; the harness files it under ``perfbench.solve``.

``episode(x0)``, ``tick(x0)`` (episodes)
    A client's cold solve from ``x0`` (host floats) with its zones' clock
    back at 0, and one re-solve from the plan's next state; the harness
    files them under ``perfbench.episode`` and ``perfbench.tick``.

An entry defines what its cells' traffic calls. A result carries, lane
axis first and every lane on rank 0 (gathering lanes over the group is
the entry's job): ``z`` [B, K * (nx + nu)], ``obj``, ``status`` [B],
``lam_def`` [B, N * nx], ``mu`` [B, K * m]; a tick's also
``inner_iters``.
"""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, entry_dir: str = HERE):
    """The ``Entry`` class of ``<entry_dir>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench.entries.{name}", os.path.join(entry_dir, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Entry
