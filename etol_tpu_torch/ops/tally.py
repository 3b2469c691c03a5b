"""Launch counts of the port's hand-written kernels and of cyclic
reduction's solves, those a CUDA graph captured counted at each replay.

Each counted module holds one :class:`Tally` (``bt_cuda.TALLY``,
``cyclic_reduction.TALLY``, ``hs_coupling.TALLY``,
``ls_candidates.TALLY``) and calls :meth:`Tally.add` at each launch. A
CUDA graph's capture records a kernel into the graph and runs nothing, so
``trip_graph`` captures inside :func:`recording`, which opens a record on
every tally, and adds the records at each replay (:func:`replayed`): a
new kernel's tally is counted there without a change to ``trip_graph``.
"""
from __future__ import annotations

import contextlib

#: every tally, in the order their modules made them
ALL = []


class Tally:
    """One kernel's launches in this process: ``by`` its module's key (a
    launch's shape) and ``count``, their sum."""

    def __init__(self):
        self.by = {}
        # open records of a capture's launches (innermost last)
        self._records = []
        ALL.append(self)

    @property
    def count(self) -> int:
        return sum(self.by.values())

    def add(self, key) -> None:
        """One launch at ``key``: into the innermost open record, else into
        the counts."""
        if self._records:
            record = self._records[-1]
            record[key] = record.get(key, 0) + 1
        else:
            self.replayed({key: 1})

    @contextlib.contextmanager
    def recording(self):
        """Count the launches made inside into the dict it yields, by key,
        and not into the counts."""
        record = {}
        self._records.append(record)
        try:
            yield record
        finally:
            self._records.pop()

    def replayed(self, record: dict, times: int = 1) -> None:
        """Add a captured graph's launches (``record``, from
        :meth:`recording`) for ``times`` replays."""
        for key, n in record.items():
            self.by[key] = self.by.get(key, 0) + n * times

    def clear(self) -> None:
        self.by.clear()


@contextlib.contextmanager
def recording():
    """A record on every tally of the launches made inside: yields the
    list of (tally, record) that :func:`replayed` adds."""
    with contextlib.ExitStack() as stack:
        yield [(t, stack.enter_context(t.recording())) for t in ALL]


def replayed(records, times: int = 1) -> None:
    """Add ``records`` (from :func:`recording`) for ``times`` replays."""
    for t, record in records:
        t.replayed(record, times)
