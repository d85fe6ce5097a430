"""CUDA-graph programs and the device lock shared by the engine's bucket
programs and the stream batchers' chunk programs.

:class:`GraphProgram` runs one function of fixed ("static") input
tensors behind one call interface: on ``cuda`` it captures the function
into a CUDA graph once and replays it; on the CPU, or without a graph
pool, it calls the function eagerly.

:data:`DEVICE_LOCK` is the process-wide reader-writer lock between
captures and the rest of the device work. A capture made while another
thread launches work, allocates device memory or synchronises fails, or
corrupts that thread's work, under the default
``capture_error_mode="global"``. So every capture, with the allocation
of its static inputs, holds the lock exclusively
(:meth:`DeviceLock.exclusive`), and every other device section holds it
shared (:meth:`DeviceLock.shared`): the engine's ``infer`` from
stage-in to copy-back, a stream batcher's tick, a session's chunk step,
a slot reset, a server's engine load. Shared sections run side by side
(each object's own lock or thread keeps its buffers to one caller); a
capture waits for them to end, and sections that start while it waits
queue behind it.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from m3asr_tpu_torch.runtime import trace


class DeviceLock:
    """A re-entrant reader-writer lock: :meth:`shared` sections run side
    by side, an :meth:`exclusive` one alone. A thread that holds the lock
    exclusively may take either side again; one that holds it shared may
    take the shared side again, and raises if it asks for the exclusive
    side (the upgrade would deadlock against another thread's). A thread
    waiting for the exclusive side holds back new shared sections, so a
    capture does not wait for a quiet moment in live traffic."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._shared = {}       # thread id -> its shared holds
        self._owner = None      # the thread that holds it exclusively
        self._depth = 0         # the owner's exclusive holds
        self._waiting = 0       # threads waiting for the exclusive side

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cv:
            if self._owner != me and me not in self._shared:
                while self._owner is not None or self._waiting:
                    self._cv.wait()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cv:
                n = self._shared.pop(me) - 1
                if n:
                    self._shared[me] = n
                else:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cv:
            if self._owner != me:
                if me in self._shared:
                    raise RuntimeError(
                        "DEVICE_LOCK: a capture inside a shared device "
                        "section of the same thread")
                self._waiting += 1
                try:
                    while self._owner is not None or self._shared:
                        self._cv.wait()
                finally:
                    self._waiting -= 1
                self._owner = me
            self._depth += 1
        try:
            yield
        finally:
            with self._cv:
                self._depth -= 1
                if not self._depth:
                    self._owner = None
                    self._cv.notify_all()


DEVICE_LOCK = DeviceLock()

# eager runs a program makes, on a side stream, before its capture: they
# build the kernels' libraries and warm cuBLAS and cuDNN up
GRAPH_WARMUP_RUNS = 2


def _align(n: int) -> int:
    return (n + 63) // 64 * 64


class HostStaging:
    """Host buffers for the copies to and from a device: pinned on
    ``cuda``, so that the copies run asynchronously. Every call reuses
    them (its copies end before it returns); they grow to the largest
    call and never shrink. The owner serialises their use."""

    def __init__(self, pin: bool):
        self.pin, self.bufs = pin, {}

    def views(self, name: str, specs):
        """Tensors of the given (shape, dtype) specs, carved from buffer
        ``name``."""
        sizes = [int(np.prod(shape)) * dt.itemsize for shape, dt in specs]
        total = sum(map(_align, sizes))
        buf = self.bufs.get(name)
        if buf is None or buf.numel() < total:
            buf = torch.empty(max(1, total), dtype=torch.uint8,
                              pin_memory=self.pin)
            self.bufs[name] = buf
        out, off = [], 0
        for (shape, dt), n in zip(specs, sizes):
            out.append(buf[off:off + n].view(dt).view(shape))
            off += _align(n)
        return out


class GraphProgram:
    """``fn(*inputs)`` behind one call interface. ``inputs`` are the
    static input tensors, on one device; callers write into them and call
    :meth:`run`. With a graph pool (``cuda``) the program runs ``fn``
    :data:`GRAPH_WARMUP_RUNS` times on a side stream and captures it into
    a CUDA graph, holding :data:`DEVICE_LOCK` exclusively; :meth:`run`
    then replays the graph and returns the same static output tensors
    each time, valid until the next replay of any program sharing the
    pool. Without a pool, :meth:`run` calls ``fn`` eagerly. A failed
    capture raises. The caller allocates the static inputs under the
    same exclusive hold.

    ``fn`` may write into its inputs (a chunk step's state): the warm-up
    runs do too, so the caller arranges that they leave the inputs as
    they were (a chunk step's slot mask all False). ``pool_bytes`` is
    what the capture added to the caching allocator's reserved memory,
    the graph's pool as this capture left it (0 without a graph); the
    memory the warm-ups left (their cached blocks, the libraries'
    workspaces for the side stream) is outside it. The warm-ups and the
    capture are the span ``engine.capture``, each capture one count of
    ``engine.captures`` (``runtime/trace.py``)."""

    def __init__(self, fn, inputs, graph_pool=None):
        self.fn, self.inputs = fn, tuple(inputs)
        self.graph = self.outputs = None
        self.pool_bytes = 0
        if graph_pool is not None:
            dev = self.inputs[0].device
            trace.count("engine.captures")
            with trace.span("engine.capture"), DEVICE_LOCK.exclusive():
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(GRAPH_WARMUP_RUNS):
                        fn(*self.inputs)
                torch.cuda.current_stream(dev).wait_stream(side)
                # the capture empties the allocator's cache as it starts;
                # empty it here too, so that the difference is the pool
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=graph_pool):
                    outputs = fn(*self.inputs)
                self.pool_bytes = torch.cuda.memory_reserved(dev) - before
            self.graph, self.outputs = graph, outputs

    def run(self):
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        return self.outputs


def copy_to_host(staging: HostStaging, name: str, tensors, device,
                 spans=None):
    """Copy device tensors, each in its own dtype, into staging buffer
    ``name`` (asynchronously on ``cuda``, then one synchronisation) and
    return them as numpy arrays of their own: bf16 widened to float32 on
    the host (exact), the rest copied out of the reused buffer.
    ``spans``: the names of the trace spans around the synchronisation
    and around the copy out, or None."""
    hosts = staging.views(name, [(tuple(t.shape), t.dtype) for t in tensors])
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    sync, out = spans or (None, None)
    with trace.span(sync) if sync else trace.NULL:
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    with trace.span(out) if out else trace.NULL:
        return [(h.float() if h.dtype == torch.bfloat16 else h.clone())
                .numpy() for h in hosts]
