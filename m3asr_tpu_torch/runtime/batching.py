"""Request micro-batching for serving (port of
``m3asr_tpu/runtime/batching.py``).

Requests that arrive within a small time window are padded to a common
bucket and run as one engine call: the MoE layers read every active
expert's weights once per forward, so a batch of B requests costs about
the device time of one.

Thread model: callers (the server's handler threads) block in
:meth:`MicroBatcher.infer`; one dispatcher thread drains the queue every
``window_ms`` (or as soon as ``max_batch`` requests wait) and calls the
engine. The engine is re-entrant (its own lock), so handler threads may
call it directly at the same time (``infer_long``).

While the tracer is on (``runtime/trace.py``), each request's wait from
enqueue to dispatch is a ``batcher.wait`` span, and the ``engine.infer``
span of the dispatch lists the ids of the waits it served (``waits``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from m3asr_tpu_torch.runtime import trace


class _Pending:
    __slots__ = ("feat", "length", "event", "result", "error", "queued")

    def __init__(self, feat: np.ndarray, length: int):
        self.feat = feat          # (T, D)
        self.length = length
        self.queued = time.time_ns()
        self.event = threading.Event()
        self.result: Optional[Tuple[np.ndarray, int]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Batches concurrent single-utterance infer calls.

    infer_fn: (feat (B, T, D) float32, lens (B,) int32) ->
              (out (B, T', V), out_lens (B,)), Engine.infer's contract.
    window_ms: how long to wait for co-arriving requests after the
               first one (0 disables waiting but still coalesces
               requests that queued while the engine was busy).
    max_batch: dispatch immediately once this many requests wait.
    """

    def __init__(self, infer_fn: Callable, window_ms: float = 5.0,
                 max_batch: int = 8, beam_output: bool = False):
        self._infer = infer_fn
        # engine decode_output="beam": out is (B, beam, T') hypothesis
        # ids and the extras are per-hypothesis (B, beam) lens and
        # scores; the time axis moves to axis 2 and extras are not
        # time-sliced
        self._beam_output = beam_output
        self._window_s = window_ms / 1e3
        self._max_batch = max_batch
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._running = True
        self._batch_sizes: List[int] = []   # observability
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="m3asr-microbatcher")
        self._thread.start()

    # -- caller side -----------------------------------------------------
    def infer(self, feat: np.ndarray, length: Optional[int] = None
              ) -> Tuple[np.ndarray, int]:
        """feat: (T, D) one utterance. Blocks until the batch containing
        it completes. Returns (out (T', V), out_len)."""
        feat = np.asarray(feat, np.float32)
        assert feat.ndim == 2, f"one utterance (T, D), got {feat.shape}"
        item = _Pending(feat, int(length or feat.shape[0]))
        with self._cv:
            if not self._running:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(item)
            self._cv.notify_all()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join()
        # fail anything still queued
        for item in self._queue:
            item.error = RuntimeError("MicroBatcher closed")
            item.event.set()
        self._queue.clear()

    @property
    def batch_sizes(self) -> List[int]:
        """Dispatch history (for tests / metrics)."""
        return list(self._batch_sizes)

    # -- dispatcher side ---------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait()
                if not self._running:
                    return
                # first request seen: hold the window open for co-arrivals
                deadline = time.monotonic() + self._window_s
                while (len(self._queue) < self._max_batch
                       and self._running):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._queue[:self._max_batch]
                del self._queue[:len(batch)]
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]):
        try:
            T = max(it.feat.shape[0] for it in batch)
            D = batch[0].feat.shape[1]
            feats = np.zeros((len(batch), T, D), np.float32)
            lens = np.zeros((len(batch),), np.int32)
            for i, it in enumerate(batch):
                feats[i, :it.feat.shape[0]] = it.feat
                lens[i] = it.length
            now = time.time_ns()
            waits = [trace.record("batcher.wait", it.queued, now)
                     for it in batch]
            res = self._infer(feats, lens)
            call = trace.last_root() if waits[0] else None
            if call is not None and call.name == "engine.infer" and \
                    call.start >= now:
                call.meta["waits"] = waits
            out, out_lens, extras = res[0], res[1], res[2:]
            self._batch_sizes.append(len(batch))
            if len(self._batch_sizes) > 1000:   # bounded history
                del self._batch_sizes[:-1000]
            for i, it in enumerate(batch):
                n = int(out_lens[i])
                if self._beam_output:
                    it.result = (out[i, :, :n], n) + tuple(
                        np.asarray(e)[i] for e in extras)
                else:
                    # extras: sparse decode outputs, hidden, taps: all
                    # (B, T', ...) arrays sliced the same way
                    it.result = (out[i, :n], n) + tuple(
                        np.asarray(e)[i, :n] for e in extras)
        except BaseException as e:  # propagate to every waiter
            for it in batch:
                it.error = e
        finally:
            for it in batch:
                it.event.set()
