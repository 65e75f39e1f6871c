"""Stage spans inside the port's operations.

``span(pk, name, units)`` times one stage of an operation where the work
happens.  It is always on: on exit it adds the elapsed
``time.perf_counter_ns()`` to ``pk._engine.stats["ns." + name]``, the
counters of work routed through that engine (a ``MeshEngine`` counts on
its rank 0, where the operations run).  A key with no engine counts
nothing.  A span is reusable: ``start()`` / ``stop()`` (or ``with``) may
run many times on one object, which is how per-product loops time their
stages without making a new object each time.  :func:`count` adds amounts
of work (edge pairs, products by route, layers) to the same stats under
the same rule.

The span log is off unless :func:`recording` (or
``utils.profiling.trace``) turns it on.  While it records, every span
appends a :class:`Record`; the outermost open span of a call opens a new
request id and its children inherit it.  :func:`spans` returns the
records with their times on ``time.time_ns`` nanoseconds, the clock of
``torch.profiler``'s device events, so a record lines up with the kernels
and copies it waited on.  Inside ``profiling.trace`` each span is also a
``torch.profiler.record_function`` range, so the Chrome trace shows the
stages beside the kernels.

The stack of open spans assumes one thread, as the port's operations do.
Nothing here writes a file.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

_clock = time.perf_counter_ns


class Record(NamedTuple):
    """One span: ``start``/``end`` in ``time.time_ns`` nanoseconds (``end``
    is None while the span is open), ``parent`` the index of the enclosing
    span's record or -1, ``request`` the id its outermost span opened."""

    name: str
    start: int
    end: int | None
    units: int
    parent: int
    request: int


class _Log:
    """The records of one recording, on the perf_counter clock."""

    __slots__ = ("rows", "open", "offset", "requests", "profile")

    def __init__(self, profile: bool):
        self.rows = []    # [name, start, end, units, parent, request, range]
        self.open = []    # indices of the open spans' rows, innermost last
        self.offset = time.time_ns() - _clock()
        self.requests = 0
        self.profile = profile

    def enter(self, name: str, units: int, t0: int) -> int:
        if self.open:
            parent = self.open[-1]
            request = self.rows[parent][5]
        else:
            parent, request = -1, self.requests
            self.requests += 1
        rng = None
        if self.profile:
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        self.rows.append([name, t0, None, units, parent, request, rng])
        self.open.append(len(self.rows) - 1)
        return len(self.rows) - 1

    def exit(self, i: int, t1: int) -> None:
        row = self.rows[i]
        row[2] = t1
        if row[6] is not None:
            row[6].__exit__(None, None, None)
            row[6] = None
        self.open.remove(i)

    def records(self) -> list[Record]:
        off = self.offset
        return [Record(n, s + off, None if e is None else e + off, u, p, r)
                for n, s, e, u, p, r, _ in self.rows]


_active: _Log | None = None   # the log spans append to, while recording
_last: _Log | None = None     # the newest log, read by spans()


class span:
    """Time a stage of ``pk``'s operation into its engine's
    ``stats["ns." + name]``; ``units`` is the work the span stands for
    (ciphertexts, products), kept in its record."""

    __slots__ = ("stats", "key", "name", "units", "t0", "log", "row")

    def __init__(self, pk, name: str, units: int = 0):
        eng = getattr(pk, "_engine", None)
        self.stats = None if eng is None else eng.stats
        self.key = "ns." + name
        self.name = name
        self.units = units
        self.log = None

    def start(self) -> "span":
        self.t0 = t0 = _clock()
        log = _active
        if log is not None:
            self.log = log
            self.row = log.enter(self.name, self.units, t0)
        return self

    def stop(self, *exc) -> None:
        t1 = _clock()
        stats = self.stats
        if stats is not None:
            stats[self.key] = stats.get(self.key, 0) + t1 - self.t0
        if self.log is not None:
            self.log.exit(self.row, t1)
            self.log = None

    __enter__ = start
    __exit__ = stop


def count(pk, counts: dict) -> None:
    """Add each of ``counts`` (name -> amount of work) to
    ``pk._engine.stats[name]``, as a span adds its nanoseconds; a key with
    no engine counts nothing."""
    eng = getattr(pk, "_engine", None)
    if eng is not None:
        stats = eng.stats
        for k, n in counts.items():
            stats[k] = stats.get(k, 0) + n


@contextlib.contextmanager
def recording(profile: bool = False):
    """Keep a record of every span in the block (a new log each time;
    :func:`spans` reads it, during the block and after).  With
    ``profile`` each span is also a ``torch.profiler.record_function``
    range of the profiler running around the block."""
    global _active, _last
    prev = _active
    _active = _last = _Log(profile)
    try:
        yield
    finally:
        _active = prev


def spans() -> list[Record]:
    """The newest recording's records, in the order the spans started."""
    return [] if _last is None else _last.records()
