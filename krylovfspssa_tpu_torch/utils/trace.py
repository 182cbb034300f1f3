"""Host spans of the solver's layers.

``span(name)`` marks a region of host code as one call of the layer
``name``::

    with trace.span("replay"):
        graph.replay()

Recording is off unless a caller turns it on, for one process, with
``recording()``; off, ``span`` returns one shared object that does
nothing, after a single check of a module global, so the spans cost the
solve nearly nothing.  On, each span adds to its name's calls, inclusive
host seconds and self host seconds (inclusive minus the time in spans
nested inside it), on ``time.perf_counter_ns``, and opens a host range
``kfs::<name>`` for torch.profiler (``_RecordFunctionFast``: a plain host
event on the profiler's clock, with no device-side twin; nothing when no
profiler runs).  A span never waits for the card: its host seconds are
the host's, and the work it enqueued may still be running when it ends.

    with trace.recording() as rec:
        solve_cme_box(...)
    rec.spans  # {name: (calls, inclusive_s, self_s)}

A function is spanned whole with the decorator ``spanned(name)``.
"""

from __future__ import annotations

import contextlib
import functools
import time

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # a torch without it: the spans still count
    _Range = None

#: the recording in progress, or None
_REC = None


class _Off:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recording:
    """Per span name: calls, inclusive and self host nanoseconds."""

    def __init__(self):
        #: name -> [calls, inclusive ns, self ns]
        self._totals: dict = {}
        #: open spans, innermost last
        self._stack: list = []
        #: name -> how many spans of that name are open
        self._open: dict = {}

    @property
    def spans(self) -> dict:
        """{name: (calls, inclusive_s, self_s)}.  A name nested inside
        itself counts its outermost span's time once."""
        return {k: (c, i * 1e-9, s * 1e-9)
                for k, (c, i, s) in self._totals.items()}


class _Span:
    __slots__ = ("rec", "name", "t0", "child", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        rec._stack.append(self)
        rec._open[self.name] = rec._open.get(self.name, 0) + 1
        self.child = 0
        if _Range is not None:
            self.range = _Range("kfs::" + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _Range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        rec._stack.pop()
        dur = t1 - self.t0
        if rec._stack:
            rec._stack[-1].child += dur
        depth = rec._open[self.name] - 1
        rec._open[self.name] = depth
        tot = rec._totals.setdefault(self.name, [0, 0, 0])
        tot[0] += 1
        if depth == 0:
            tot[1] += dur
        tot[2] += dur - self.child
        return False


def span(name: str):
    """A context manager marking one call of the layer ``name``."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Span(rec, name)


def spanned(name: str):
    """Decorator: every call of the function is one ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording():
    """Record every span of this process until the block ends; yields the
    :class:`Recording`.  Not re-entrant."""
    global _REC
    if _REC is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None
