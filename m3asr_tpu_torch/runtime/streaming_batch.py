"""Cross-stream chunk micro-batching for streaming serving (port of
``m3asr_tpu/runtime/streaming_batch.py``, conformer families).

Up to ``slots`` concurrent streams share one batched chunk program;
co-pending chunks of different streams run as one step with an
active-slot mask, so B streams cost about one stream's expert-weight
traffic per tick.

* The batched state gives every slot its own stream age (per-slot
  offsets drive per-slot positional rows and cache-validity masks).
* Idle slots get zero windows and keep their state (``select_state``
  inside the step), so an idle stream never advances.
* One tick takes at most one pending chunk per slot (a stream's chunks
  depend on each other's state).

On ``cuda`` the step is a CUDA graph (``runtime/graphs.py``) over static
inputs: the windows (slots, 4 * chunk + 3, input_dim), the slot mask and
both encoders' state tensors, which the step writes in place. Only the
chunk outputs cross to the host ((slots, C, K) values and ids with
``topk``). Each batcher has its own graph pool: its thread replays while
the engine's ``MicroBatcher`` thread replays the engine's graphs, so the
two must not share one. Slot resets write zeros into the same state
tensors, on the same stream, outside the graph; a reset asked for during
a tick is applied after it (the JAX deferral). The program's
allocation and capture hold ``DEVICE_LOCK`` exclusively, every other
device section holds it shared.

``DfsmnStreamBatcher`` and ``BatchedDfsmnStreamingSession`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.runtime.graphs import (DEVICE_LOCK, GraphProgram,
                                            HostStaging, copy_to_host)
from m3asr_tpu_torch.runtime.streaming_session import (
    DfsmnStreamingSession, StreamingSession, chunk_step_fn,
    params_device_dtype, state_tensors, use_graph)


class SlotsFull(Exception):
    """All concurrent-stream slots are occupied."""


class _PendingChunk:
    __slots__ = ("window", "event", "result", "error")

    def __init__(self, window: np.ndarray):
        self.window = window          # (1, W, D)
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BatcherCore:
    """Slot management and the pending-chunk dispatch loop. Subclasses
    provide :meth:`_tick` (run one batched step on the windows and mask,
    return the outputs as numpy arrays) and :meth:`_reset_slots`."""

    def __init__(self, slots: int, window_ms: float, window_frames: int,
                 input_dim: int):
        self.slots = slots
        self._window_s = window_ms / 1e3
        # push-side validation: all windows of a batcher share one (W, D);
        # a malformed client window fails ITS push only, never the
        # co-batched streams
        self.window_frames = window_frames
        self._input_dim = input_dim
        self._free: List[int] = list(range(slots))
        self._pending: Dict[int, List[_PendingChunk]] = {}
        self._cv = threading.Condition()
        self._running = True
        self._batch_sizes: List[int] = []      # observability
        # resets asked for while a tick is in flight are applied after it;
        # otherwise the tick's write-back would leave a recycled slot
        # with its stale caches
        self._in_flight = False
        self._deferred_resets: set = set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="m3asr-streambatcher")
        self._thread.start()

    # -- provided by the subclass ----------------------------------------
    def _tick(self, windows: np.ndarray, mask: np.ndarray):
        raise NotImplementedError

    def _reset_slots(self, slots) -> None:
        raise NotImplementedError

    # -- slot management ---------------------------------------------------
    def open_slot(self) -> int:
        with self._cv:
            if not self._free:
                raise SlotsFull(f"all {self.slots} stream slots in use")
            return self._free.pop()

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's caches and offset (a fresh stream, slot kept);
        during a tick, after it."""
        with self._cv:
            self._deferred_resets.add(slot)
            if self._in_flight:
                return
        with DEVICE_LOCK.shared(), self._cv:
            self._apply_deferred_resets_locked()

    def _apply_deferred_resets_locked(self) -> None:
        """Apply the pending resets (DEVICE_LOCK shared and _cv held)."""
        if self._deferred_resets:
            self._reset_slots(sorted(self._deferred_resets))
            self._deferred_resets.clear()

    def close_slot(self, slot: int) -> None:
        self.reset_slot(slot)
        with self._cv:
            self._free.append(slot)

    # -- caller side -------------------------------------------------------
    def push(self, slot: int, window: np.ndarray):
        """window: (1, W, input_dim). Blocks until the batched tick that
        holds it ran; returns this slot's (1, C, ...) output."""
        window = np.asarray(window, np.float32)
        if window.shape != (1, self.window_frames, self._input_dim):
            raise ValueError(
                f"window must be (1, {self.window_frames}, "
                f"{self._input_dim}), got {window.shape}")
        item = _PendingChunk(window)
        with self._cv:
            if not self._running:
                raise RuntimeError("StreamBatcher is closed")
            self._pending.setdefault(slot, []).append(item)
            self._cv.notify_all()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join()
        for lst in self._pending.values():
            for item in lst:
                item.error = RuntimeError("StreamBatcher closed")
                item.event.set()
        self._pending.clear()

    @property
    def batch_sizes(self) -> List[int]:
        """Streams per dispatched tick (for tests and metrics)."""
        return list(self._batch_sizes)

    # -- dispatcher --------------------------------------------------------
    def _take_one_per_slot(self) -> Dict[int, _PendingChunk]:
        batch = {}
        for slot, lst in list(self._pending.items()):
            if lst:
                batch[slot] = lst.pop(0)
            if not lst:
                del self._pending[slot]
        return batch

    def _loop(self):
        while True:
            with self._cv:
                while self._running and not self._pending:
                    self._cv.wait()
                if not self._running:
                    return
                # hold the window open for co-pending streams
                deadline = time.monotonic() + self._window_s
                while (len(self._pending) < len(
                        set(range(self.slots)) - set(self._free))
                        and self._running):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._take_one_per_slot()
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: Dict[int, _PendingChunk]):
        try:
            W, D = next(iter(batch.values())).window.shape[1:]
            windows = np.zeros((self.slots, W, D), np.float32)
            mask = np.zeros((self.slots,), bool)
            for slot, item in batch.items():
                windows[slot] = item.window[0]
                mask[slot] = True
            with DEVICE_LOCK.shared():
                with self._cv:
                    self._apply_deferred_resets_locked()
                    self._in_flight = True
                out = self._tick(windows, mask)
                with self._cv:
                    self._in_flight = False
                    self._apply_deferred_resets_locked()
            self._batch_sizes.append(len(batch))
            if len(self._batch_sizes) > 1000:
                del self._batch_sizes[:-1000]
            for slot, item in batch.items():
                item.result = (tuple(o[slot:slot + 1] for o in out)
                               if isinstance(out, tuple)
                               else out[slot:slot + 1])
        except BaseException as e:   # propagate to every waiter
            for item in batch.values():
                item.error = e
        finally:
            # a failed step must not wedge
            with DEVICE_LOCK.shared(), self._cv:
                self._in_flight = False
                self._apply_deferred_resets_locked()
            for item in batch.values():
                item.event.set()


class StreamBatcher(_BatcherCore):
    """The shared batched chunk program of up to ``slots`` concurrent
    conformer-family streams of one (chunk_size, num_left_chunks)
    configuration; the hier MoE variant batches its embed sub-encoder's
    state too. ``params`` live on the device the batcher runs on, in its
    activation dtype; ``input_dim`` is the feature width. The chunk
    program is built here (on ``cuda``: captured). ``pool_bytes`` is what
    its graph reserved."""

    def __init__(self, params, cfg: EncoderConfig, *, input_dim: int,
                 chunk_size: int = 16, num_left_chunks: int = 2,
                 slots: int = 8, moe: bool = False, moe_impl: str = "dense",
                 window_ms: float = 2.0, topk: int = 0,
                 cuda_graphs: bool = True):
        if moe and not isinstance(cfg, MoEEncoderConfig):
            raise TypeError("moe=True needs a MoEEncoderConfig")
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_size
        self.left = num_left_chunks
        self.slots = slots
        self.moe = moe
        self.moe_impl = moe_impl
        self.topk = topk
        self.cuda_graphs = cuda_graphs
        self._cache_T = chunk_size * num_left_chunks
        self.device, self.dtype = params_device_dtype(params)
        self._staging = HostStaging(pin=self.device.type == "cuda")
        with DEVICE_LOCK.exclusive(), torch.inference_mode():
            windows = torch.zeros((slots, 4 * chunk_size + 3, input_dim),
                                  dtype=self.dtype, device=self.device)
            # all False while the program warms up: the state stays
            mask = torch.zeros((slots,), dtype=torch.bool,
                               device=self.device)
            state = state_tensors(cfg, moe, slots, self._cache_T, True,
                                  self.dtype, self.device)
            pool = (torch.cuda.graph_pool_handle()
                    if use_graph(self.device, cuda_graphs, moe, moe_impl)
                    else None)
            self._prog = GraphProgram(
                chunk_step_fn(params, cfg, moe, moe_impl, topk, masked=True),
                (windows, mask) + state, pool)
        super().__init__(slots, window_ms, 4 * chunk_size + 3, input_dim)

    @property
    def pool_bytes(self) -> int:
        return self._prog.pool_bytes

    @property
    def graph(self):
        """The captured CUDA graph, or None (eager)."""
        return self._prog.graph

    def _tick(self, windows: np.ndarray, mask: np.ndarray):
        prog = self._prog
        with torch.inference_mode():
            hw, hm = self._staging.views("in", [
                (tuple(windows.shape), torch.float32),
                (tuple(mask.shape), torch.bool)])
            hw.numpy()[...] = windows
            hm.numpy()[...] = mask
            prog.inputs[0].copy_(hw, non_blocking=True)
            prog.inputs[1].copy_(hm, non_blocking=True)
            out = copy_to_host(self._staging, "out", prog.run(), self.device)
        return tuple(out) if self.topk else out[0]

    def _reset_slots(self, slots) -> None:
        with torch.inference_mode():
            for t in self._prog.inputs[2:]:
                # offsets (slots,), caches (L, slots, ...)
                view = t if t.dim() == 1 else t.transpose(0, 1)
                for s in slots:
                    view[s].zero_()


class DfsmnStreamBatcher:
    """The DFSMN family's batched chunk program: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DFSMN stream batching is not ported yet (ROADMAP Queue 1 item "
            "10)")


class BatchedStreamingSession(StreamingSession):
    """A StreamingSession whose chunk step runs on a shared StreamBatcher
    slot: the same push/finish/reset surface, so ``serve``'s SessionPool
    and stream protocol are unchanged.

    The slot is taken at the first chunk and released on reset(): pool
    templates and idle pooled sessions hold none. When every slot is
    taken, the session runs a dedicated single-stream chunk program for
    its lifetime (overload beyond ``slots`` still serves, unbatched)."""

    def __init__(self, batcher: StreamBatcher):
        self.batcher = batcher
        self.chunk = batcher.chunk
        self.window = 4 * batcher.chunk + 3
        self.stride = 4 * batcher.chunk
        self.topk = batcher.topk
        self.slot = None
        self._fallback: Optional[StreamingSession] = None
        self._buf = None
        self._consumed = 0

    def _step(self, w: np.ndarray):
        if self._fallback is None and self.slot is None:
            try:
                self.slot = self.batcher.open_slot()
            except SlotsFull:
                b = self.batcher
                self._fallback = StreamingSession(
                    b.params, b.cfg, chunk_size=b.chunk,
                    num_left_chunks=b.left, moe=b.moe, moe_impl=b.moe_impl,
                    topk=b.topk, cuda_graphs=b.cuda_graphs)
        if self._fallback is not None:
            return self._fallback._step(w)
        return self.batcher.push(self.slot, w)

    def reset(self) -> None:
        if self.slot is not None:
            self.batcher.close_slot(self.slot)
            self.slot = None
        if self._fallback is not None:
            self._fallback.reset()   # keeps its chunk program
        self._buf = None
        self._consumed = 0

    def clone(self):
        return BatchedStreamingSession(self.batcher)


class BatchedDfsmnStreamingSession(DfsmnStreamingSession):
    """The DFSMN family's batched session: not ported yet."""
