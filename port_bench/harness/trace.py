"""Host spans around the harness's calls into the program, and the
reading of a traced window.

Spans are always recorded (two clock reads and an append each): name,
thread, start and end on ``time.time_ns``, and a dict of what the call
carried (batch, lengths, bucket). With ``--trace 1`` the window runs
under ``torch.profiler`` (CPU and CUDA activities); its device events
(kernels, copies, sets, by the names the profiler gives) are read from
the raw kineto events, and a marker taken on both clocks aligns the
spans with them.
"""

from __future__ import annotations

import contextlib
import threading
import time

CLOCK_MARK = "port_bench.clock"


class Spans:
    def __init__(self):
        self.rec = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        t0 = time.time_ns()
        try:
            yield meta
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.rec.append((name, threading.get_ident(), t0, t1, meta))


def union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """What a traced window recorded: device events on the host's
    ``time_ns`` clock, the window's bounds, and the spans."""

    def __init__(self, events, t0: int, t1: int, spans: Spans):
        self.events = events          # (name, start_ns, end_ns)
        self.t0, self.t1, self.spans = t0, t1, spans
        self.busy = union((max(s, t0), min(e, t1)) for _, s, e in events
                          if e > t0 and s < t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the events whose name holds any of
        ``parts``."""
        return sum(e - s for n, s, e in self.events
                   if any(p in n for p in parts)) / 1e9

    def by_name(self, top: int = 10):
        tot = {}
        for n, s, e in self.events:
            k = short_name(n)
            tot[k] = tot.get(k, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """Idle device time in the window, summed by the innermost host
        span that covers each gap's middle ("none" where no span does)."""
        import numpy as np
        edges = np.array([[self.t0, self.t0]] + self.busy
                         + [[self.t1, self.t1]], np.int64)
        a, b = edges[:-1, 1], edges[1:, 0]
        keep = b > a
        a, b = a[keep], b[keep]
        mid = (a + b) // 2
        names = ["none"]
        owner = np.zeros(len(mid), np.int64)
        # longest spans first, so that a shorter (inner) one overwrites
        for name, _, s, e, _ in sorted(self.spans.rec,
                                       key=lambda r: r[2] - r[3]):
            lo, hi = np.searchsorted(mid, [s, e + 1])
            if hi > lo:
                if name not in names:
                    names.append(name)
                owner[lo:hi] = names.index(name)
        tot = np.bincount(owner, weights=(b - a).astype(np.float64),
                          minlength=len(names))
        order = np.argsort(-tot)[:top]
        return [[names[i], float(tot[i]) / 1e9] for i in order if tot[i]]


def short_name(kernel: str) -> str:
    """A device event's name without return type, namespace or
    arguments, at most 80 characters."""
    name = kernel.replace("void ", "", 1)
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:80]


class Tracer:
    """Context around a window: with ``enabled``, ``torch.profiler`` over
    it; ``result`` is then a :class:`Trace` of [start, end]."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled, self.spans = enabled, spans
        self.result = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def mark(self):
        """A clock marker for the alignment (called in the window's
        thread while the profiler runs); returns its time_ns."""
        if not self.enabled:
            return time.time_ns()
        from torch.profiler import record_function
        t = time.time_ns()
        with record_function(CLOCK_MARK):
            pass
        self._mark = t
        return t

    def close(self, t0: int, t1: int):
        if not self.enabled:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        raw = self._prof.profiler.kineto_results.events()
        offset = None
        events = []
        for e in raw:
            if e.device_type() == DeviceType.CUDA:
                events.append((e.name(), e.start_ns(), e.end_ns()))
            elif offset is None and e.name() == CLOCK_MARK:
                offset = e.start_ns() - self._mark
        if offset is None:
            raise RuntimeError("the profiler recorded no clock marker")
        events = [(n, s - offset, e - offset) for n, s, e in events]
        self.result = Trace(events, t0, t1, self.spans)

    def __exit__(self, *exc):
        if self._prof is not None and self.result is None:
            self._prof.__exit__(*exc)
