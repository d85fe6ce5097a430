"""The port's tracer: spans and counters recorded where the work happens.

A span records its name, an id, its parent's id (the span open around it
in the same thread, or 0), the thread, its start and end on
``time.time_ns()`` (the clock a ``torch.profiler`` trace is aligned to
through a marker taken on both clocks), and a small dict of meta. The
spans of one engine call nest under its ``engine.infer`` span, so they
share that span's id as their ``root``. A counter is a named integer.

Records live in a bounded in-memory buffer (:data:`CAPACITY` spans; the
oldest go first, and :attr:`Tracer.dropped` counts them). Readers take
:meth:`Tracer.records` and :meth:`Tracer.counters`; nothing is written
to a file.

The tracer is on while a ``torch.profiler`` runs in the process
(``torch.autograd._profiler_enabled()``), or while :func:`enable` has
turned it on. While it is on, each span also opens a profiler range of
its name (``torch._C._profiler._RecordFunctionFast``, what
``record_function`` is without its user-annotation scope), so a profiler
or Perfetto trace shows the program's spans on the host's timeline beside
the device's. Not a user annotation: the profiler turns each user
annotation that encloses device work into an event on the device
(``gpu_user_annotation``), which a reader of the device's events would
count as busy time over the very gaps these spans are there to split.
While it is off, :func:`span` returns one shared null context after one
check, and nothing is recorded or counted.

Spans the program records (the metric or view that reads each is listed
in PERF.md):

* ``engine.infer`` (one engine call; meta ``bucket``, ``B``, ``lens``, the
  valid feature lengths, ``routing`` where the bucket reports it, an
  (expert calls, E) int32 array, and ``waits`` under a micro-batcher),
  with the children ``engine.prepare``,
  ``engine.stage``, ``engine.replay``, ``engine.sync`` and
  ``engine.copy_out``;
* ``engine.capture`` (a CUDA graph's warm-up runs and capture) and
  ``kernels.build`` (an nvcc build);
* ``batcher.wait`` (a request from enqueue to dispatch) and
  ``stream.tick`` (a stream batcher's tick).

Counters: ``engine.captures`` (:meth:`Tracer.counters`), and the
routing totals (:meth:`Tracer.routing`): the valid tokens each expert
call of a forward sent to each expert, summed over the calls.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np
from torch._C._profiler import _RecordFunctionFast as profiler_range
from torch.autograd import _profiler_enabled

CAPACITY = 1 << 16
NULL = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "id", "parent", "root", "thread", "start", "end",
                 "meta")

    def __init__(self, name, id, parent, root, thread, start, end, meta):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.thread, self.start, self.end, self.meta = \
            thread, start, end, meta

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.end - self.start) / 1e6:.3f} ms)")


class _Open:
    """An open span: records it on exit, with a profiler range of its
    name around it."""

    __slots__ = ("tracer", "span", "rf")

    def __init__(self, tracer, span):
        self.tracer, self.span = tracer, span

    def __enter__(self):
        stack = self.tracer._stack()
        sp = self.span
        if stack:
            sp.parent, sp.root = stack[-1].id, stack[-1].root
        stack.append(sp)
        self.rf = profiler_range(sp.name)
        self.rf.__enter__()
        sp.start = time.time_ns()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.end = time.time_ns()
        self.rf.__exit__(*exc)
        t = self.tracer
        stack = t._stack()
        stack.pop()
        if not stack:
            t._local.root = sp
        t._append(sp)
        return False


class Tracer:
    """Spans and counters of one process (see the module's docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self.dropped = 0
        self._buf = collections.deque(maxlen=capacity)
        self._counters = {}
        self._routing = None        # (expert calls, E) int64 totals
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def enable(self, on: bool = True) -> None:
        """Turn the tracer on (or back off) whether or not a profiler
        runs."""
        self.enabled = bool(on)

    def on(self) -> bool:
        return self.enabled or _profiler_enabled()

    def span(self, name: str, **meta):
        """A context around one span; it yields the :class:`Span` (whose
        ``meta`` may still be filled in), or None while the tracer is
        off."""
        if not (self.enabled or _profiler_enabled()):
            return NULL
        i = next(self._ids)
        return _Open(self, Span(name, i, 0, i, threading.get_ident(), 0, 0,
                                meta))

    def record(self, name: str, start: int, end: int, **meta) -> int:
        """A span timed by its caller (``time_ns`` bounds, no parent);
        returns its id, or 0 while the tracer is off."""
        if not self.on():
            return 0
        i = next(self._ids)
        self._append(Span(name, i, 0, i, threading.get_ident(), start, end,
                          meta))
        return i

    def annotate(self, name: str, **meta) -> None:
        """Add ``meta`` to the innermost open span called ``name`` of this
        thread, if there is one."""
        for sp in reversed(self._stack()):
            if sp.name == name:
                sp.meta.update(meta)
                return

    def last_root(self):
        """The last outermost span (no parent) that this thread closed,
        or None."""
        return getattr(self._local, "root", None)

    def count(self, name: str, n: int = 1) -> None:
        if self.on():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + int(n)

    def add_routing(self, hist) -> None:
        """Add a call's routing, (expert calls, E) valid tokens, to the
        routing totals. One engine's forwards all have the same shape; a
        call of another shape starts the totals anew."""
        if not self.on():
            return
        h = np.asarray(hist, np.int64)
        with self._lock:
            if self._routing is None or self._routing.shape != h.shape:
                self._routing = np.zeros(h.shape, np.int64)
            self._routing += h

    def records(self, t0: int = None, t1: int = None) -> list:
        """The buffered spans that overlap [t0, t1] (``time_ns``), in the
        order they ended."""
        with self._lock:
            recs = list(self._buf)
        if t0 is not None:
            recs = [r for r in recs if r.end >= t0]
        if t1 is not None:
            recs = [r for r in recs if r.start <= t1]
        return recs

    def counters(self) -> dict:
        """The named counters (``engine.captures``)."""
        with self._lock:
            return dict(self._counters)

    def routing(self) -> list:
        """The routing totals, (expert calls, E) lists of tokens, []
        when none was counted."""
        with self._lock:
            return [] if self._routing is None else self._routing.tolist()

    def reset(self) -> None:
        """Drop every record and counter."""
        with self._lock:
            self._buf.clear()
            self._counters.clear()
            self._routing = None
            self.dropped = 0

    def _stack(self) -> list:
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack = []
        return loc.stack

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(sp)


def span_stats(records) -> dict:
    """Per span name: the count, the total ms, and the p50 and p95 of the
    self time in ms (the duration less the part its child spans
    cover)."""
    kids = collections.defaultdict(list)
    for r in records:
        if r.parent:
            kids[r.parent].append((r.start, r.end))
    by = collections.defaultdict(lambda: ([], []))
    for r in records:
        covered, end = 0, r.start
        for s, e in sorted(kids.get(r.id, ())):
            s, e = max(s, end), min(e, r.end)
            if e > s:
                covered += e - s
                end = e
        tot, own = by[r.name]
        tot.append(r.end - r.start)
        own.append(r.end - r.start - covered)
    out = {}
    for name, (tot, own) in sorted(by.items()):
        p50, p95 = np.percentile(np.asarray(own) / 1e6, [50, 95])
        out[name] = {"count": len(tot), "total_ms": sum(tot) / 1e6,
                     "self_ms_p50": float(p50), "self_ms_p95": float(p95)}
    return out


TRACER = Tracer()
enable = TRACER.enable
on = TRACER.on
span = TRACER.span
record = TRACER.record
annotate = TRACER.annotate
last_root = TRACER.last_root
count = TRACER.count
add_routing = TRACER.add_routing
records = TRACER.records
counters = TRACER.counters
routing = TRACER.routing
reset = TRACER.reset
