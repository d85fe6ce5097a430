"""Cross-stream chunk micro-batching for streaming serving (port of
``m3asr_tpu/runtime/streaming_batch.py``).

Up to ``slots`` concurrent streams share one batched chunk program;
co-pending chunks of different streams run as one step with an
active-slot mask, so B streams cost about one stream's expert-weight
traffic per tick.

* The batched state gives every slot its own stream age (per-slot
  offsets drive per-slot positional rows and cache-validity masks).
* Idle slots get zero windows and keep their state (the step writes the
  new state into the mask's slots only), so an idle stream never
  advances.
* One tick takes at most one pending chunk per slot (a stream's chunks
  depend on each other's state).

:class:`StreamBatcher` batches the conformer families' windows (4 *
chunk + 3 raw frames); :class:`DfsmnStreamBatcher` the DFSMN families'
frame-aligned chunks. On ``cuda`` the step is a CUDA graph
(``runtime/graphs.py``) over static inputs: the windows, the slot mask
and the state tensors, which the step writes in place. Only the chunk
outputs cross to the host ((slots, C, K) values and ids with ``topk``).
Each batcher has its own graph pool: its thread replays while the
engine's ``MicroBatcher`` thread replays the engine's graphs, so the two
must not share one. Slot resets write zeros into the same state tensors,
on the same stream, outside the graph; a reset asked for during a tick
is applied after it (the JAX deferral). The program's allocation and
capture hold ``DEVICE_LOCK`` exclusively, every other device section
holds it shared.

On a sharded engine (``mesh``: the engine's ep/tp mesh) the chunk
program runs eager (gloo's collectives cannot be captured) on the rank's
shard, its K/V caches at the rank's heads, and the tick thread enters
the mesh itself (the mesh is thread-local). On rank 0 a batcher that
:meth:`~_BatcherCore.lead` s a ``parallel/follow.Leader`` broadcasts
each tick's windows and mask (STREAM_TICK) and each slot reset
(STREAM_RESET) and runs them under the leader's lock, which every device
section of the batcher takes first. The other ranks keep a mirror
(``follower=True``): no thread, no slot bookkeeping; their follower loop
applies rank 0's ticks and resets to its state (:meth:`mirror_tick`,
:meth:`mirror_reset`).

While the tracer is on (``runtime/trace.py``), each dispatched tick is a
``stream.tick`` span (meta ``streams``: the streams it served).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.runtime.graphs import (DEVICE_LOCK, GraphProgram,
                                            HostStaging, copy_to_host)
from m3asr_tpu_torch.models import dfsmn_streaming, streaming
from m3asr_tpu_torch.models.dfsmn import check_moe_stage
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.runtime import trace
from m3asr_tpu_torch.runtime.streaming_session import (
    DfsmnMoeStreamingSession, DfsmnStreamingSession, StreamingSession,
    chunk_step_fn, dfsmn_state, dfsmn_step_fn, full_float32,
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
    provide :meth:`_run_tick` (run one batched step on the windows and
    mask, return the outputs as numpy arrays) and :meth:`_zero_slots`;
    :meth:`_tick` and :meth:`_reset_slots` run them, through the leader
    when the batcher leads. The subclass sets ``mesh`` (the forward's
    ep/tp mesh, which the tick thread enters, or None); ``start=False``
    (a follower's mirror) starts no thread."""

    mesh = None

    def __init__(self, slots: int, window_ms: float, window_frames: int,
                 input_dim: int, start: bool = True):
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
        self._leader = self._generation = self.key = None
        self._thread = None
        if start:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="m3asr-streambatcher")
            self._thread.start()

    # -- provided by the subclass ----------------------------------------
    def _run_tick(self, windows: np.ndarray, mask: np.ndarray):
        raise NotImplementedError

    def _zero_slots(self, slots) -> None:
        raise NotImplementedError

    # -- the leader (rank 0 of a sharded engine) ---------------------------
    def lead(self, leader, key) -> None:
        """Send this batcher's ticks and resets through ``leader`` (a
        ``parallel/follow.Leader``) to the followers' mirrors of ``key``
        (chunk, left), under the leader's current generation."""
        self._leader, self._generation, self.key = \
            leader, leader.generation, tuple(key)

    def _lead_lock(self):
        """The leader's lock (taken before DEVICE_LOCK and the slot
        lock), or a null context."""
        return (contextlib.nullcontext() if self._leader is None
                else self._leader.lock)

    def _call(self, op: int, fields, payloads):
        return self._leader.call(op, tuple(self.key) + tuple(fields),
                                 payloads, self._generation)

    def _tick(self, windows: np.ndarray, mask: np.ndarray):
        if self._leader is None:
            return self._run_tick(windows, mask)
        from m3asr_tpu_torch.parallel import follow
        with self._call(follow.STREAM_TICK, windows.shape, (
                torch.from_numpy(np.ascontiguousarray(windows, np.float32)),
                torch.from_numpy(mask.astype(np.uint8)))):
            return self._run_tick(windows, mask)

    def _reset_slots(self, slots) -> None:
        slots = list(slots)
        if self._leader is None:
            return self._zero_slots(slots)
        from m3asr_tpu_torch.parallel import follow
        with self._call(follow.STREAM_RESET, (len(slots),),
                        (torch.tensor(slots, dtype=torch.int64),)):
            self._zero_slots(slots)

    # -- a follower's mirror -----------------------------------------------
    def mirror_tick(self, windows: np.ndarray, mask: np.ndarray):
        """Rank 0's tick on this rank's shard (the follower loop)."""
        with pmesh.sharded(self.mesh):
            return self._run_tick(windows, mask)

    def mirror_reset(self, slots) -> None:
        """Rank 0's slot reset on this rank's state."""
        self._zero_slots(slots)

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
        with self._lead_lock(), DEVICE_LOCK.shared(), self._cv:
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
        if self._thread is not None:
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
        with pmesh.sharded(self.mesh):
            self._serve_loop()

    def _serve_loop(self):
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
        with trace.span("stream.tick", streams=len(batch)):
            self._dispatch_tick(batch)

    def _dispatch_tick(self, batch: Dict[int, _PendingChunk]):
        try:
            W, D = next(iter(batch.values())).window.shape[1:]
            windows = np.zeros((self.slots, W, D), np.float32)
            mask = np.zeros((self.slots,), bool)
            for slot, item in batch.items():
                windows[slot] = item.window[0]
                mask[slot] = True
            with self._lead_lock(), DEVICE_LOCK.shared():
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
            # a failed step must not wedge: every waiter wakes, whatever
            # the deferred resets do. On ranks they can raise (a stale
            # runtime, a broken leader); they then stay pending and raise
            # again, to that tick's waiters, before the next tick runs
            try:
                with self._lead_lock(), DEVICE_LOCK.shared(), self._cv:
                    self._in_flight = False
                    self._apply_deferred_resets_locked()
            except Exception:           # noqa: BLE001 (raised again)
                pass
            for item in batch.values():
                item.event.set()


class _GraphBatcher(_BatcherCore):
    """A batcher over one chunk program ``self._prog`` whose static inputs
    are (windows, slot mask, *state tensors with the slots first or
    second)."""

    _prog: GraphProgram

    @property
    def pool_bytes(self) -> int:
        return self._prog.pool_bytes

    @property
    def graph(self):
        """The captured CUDA graph, or None (eager)."""
        return self._prog.graph

    def _run_tick(self, windows: np.ndarray, mask: np.ndarray):
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

    def _build(self, fn, windows_shape, state, moe: bool, moe_impl: str):
        """The chunk program of ``fn`` over zero windows, an all-False
        mask (the warm-up runs leave the state as it is) and ``state``
        (a tuple of tensors), allocated by the caller under the exclusive
        DEVICE_LOCK."""
        windows = torch.zeros(windows_shape, dtype=self.dtype,
                              device=self.device)
        mask = torch.zeros((self.slots,), dtype=torch.bool,
                           device=self.device)
        pool = (torch.cuda.graph_pool_handle()
                if self.mesh is None and use_graph(
                    self.device, self.cuda_graphs, moe, moe_impl)
                else None)
        self._prog = GraphProgram(fn, (windows, mask) + state, pool)


class StreamBatcher(_GraphBatcher):
    """The shared batched chunk program of up to ``slots`` concurrent
    conformer-family streams of one (chunk_size, num_left_chunks)
    configuration; the hier MoE variant batches its embed sub-encoder's
    state too. ``params`` live on the device the batcher runs on, in its
    activation dtype; ``input_dim`` is the feature width. The chunk
    program is built here (on ``cuda``: captured). ``pool_bytes`` is what
    its graph reserved.

    ``mesh``: a sharded engine's ep/tp mesh, ``params`` then the rank's
    shard: the program runs eager under it. ``follower=True``: a
    follower rank's mirror (no thread; see the module's docstring)."""

    def __init__(self, params, cfg: EncoderConfig, *, input_dim: int,
                 chunk_size: int = 16, num_left_chunks: int = 2,
                 slots: int = 8, moe: bool = False, moe_impl: str = "dense",
                 window_ms: float = 2.0, topk: int = 0,
                 cuda_graphs: bool = True, mesh=None,
                 follower: bool = False):
        if moe and not isinstance(cfg, MoEEncoderConfig):
            raise TypeError("moe=True needs a MoEEncoderConfig")
        streaming.check_stream_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_size
        self.left = num_left_chunks
        self.slots = slots
        self.moe = moe
        self.moe_impl = moe_impl
        self.topk = topk
        self.cuda_graphs = cuda_graphs
        self.mesh = mesh
        self._cache_T = chunk_size * num_left_chunks
        self.device, self.dtype = params_device_dtype(params)
        full_float32(self.device, self.dtype)
        self._staging = HostStaging(pin=self.device.type == "cuda")
        with DEVICE_LOCK.exclusive(), torch.inference_mode():
            state = state_tensors(cfg, moe, slots, self._cache_T, True,
                                  self.dtype, self.device, params)
            self._build(chunk_step_fn(params, cfg, moe, moe_impl, topk,
                                      masked=True),
                        (slots, 4 * chunk_size + 3, input_dim), state, moe,
                        moe_impl)
        super().__init__(slots, window_ms, 4 * chunk_size + 3, input_dim,
                         start=not follower)

    def _zero_slots(self, slots) -> None:
        with torch.inference_mode():
            for t in self._prog.inputs[2:]:
                # offsets (slots,), caches (L, slots, ...)
                view = t if t.dim() == 1 else t.transpose(0, 1)
                for s in slots:
                    view[s].zero_()


class DfsmnStreamBatcher(_GraphBatcher):
    """The shared batched chunk program of up to ``slots`` concurrent
    DFSMN-family streams of one chunk size: frame-aligned chunks of
    ``chunk_size`` frames, a window cache of ``cache_T`` frames per
    block, per-slot offsets driving the positional gather and the FIR
    delay masks. ``moe=True`` runs the MoE-DFSMN net with expert stage
    ``moe_impl`` (its embed sub-stream, ring and input delay buffer are
    per-slot state too). ``params`` live on the device the batcher runs
    on, in its activation dtype; ``input_dim`` is the feature width. The
    chunk program is built here (on ``cuda``: captured)."""

    def __init__(self, params, cfg, *, input_dim: int, chunk_size: int = 16,
                 slots: int = 8, cache_T: int = 256, moe: bool = False,
                 moe_impl: str = "dense", window_ms: float = 2.0,
                 topk: int = 0, cuda_graphs: bool = True):
        if moe:
            check_moe_stage(moe_impl)
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_size
        self.slots = slots
        self.moe = moe
        self.moe_impl = moe_impl
        self.topk = topk
        self.cuda_graphs = cuda_graphs
        self._cache_T = cache_T
        self.device, self.dtype = params_device_dtype(params)
        full_float32(self.device, self.dtype)
        self._staging = HostStaging(pin=self.device.type == "cuda")
        with DEVICE_LOCK.exclusive(), torch.inference_mode():
            state = dfsmn_state(cfg, moe, slots, cache_T, chunk_size,
                                input_dim, True, self.dtype, self.device)
            self._build(dfsmn_step_fn(params, cfg, moe, moe_impl, topk,
                                      True, state),
                        (slots, chunk_size, input_dim),
                        dfsmn_streaming.state_tensors(state), moe, moe_impl)
        super().__init__(slots, window_ms, chunk_size, input_dim)

    def _zero_slots(self, slots) -> None:
        with torch.inference_mode():
            # every state tensor has the slots first: offsets, in_buf, the
            # embed sub-stream's state, the ring, the caches
            for t in self._prog.inputs[2:]:
                for s in slots:
                    t[s].zero_()


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
                if b.mesh is not None:
                    # a single stream's program would run collectives the
                    # followers do not mirror
                    raise SlotsFull(f"all {b.slots} stream slots in use; a "
                                    "sharded engine's streams run on the "
                                    "batcher's slots only") from None
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
    """A DfsmnStreamingSession whose chunk step runs on a shared
    DfsmnStreamBatcher slot (either DFSMN family: the batcher owns the
    whole chunk-program state; this session keeps the host maturity
    bookkeeping). The slot is taken at the first chunk and released on
    reset(); when every slot is taken, the session runs a dedicated
    single-stream session's chunk program for its lifetime, as
    BatchedStreamingSession does."""

    def __init__(self, batcher: DfsmnStreamBatcher):
        self.batcher = batcher
        self.chunk = batcher.chunk
        self.topk = batcher.topk
        self.delay = (dfsmn_streaming.moe_stream_delay(batcher.cfg,
                                                       batcher.chunk)
                      if batcher.moe
                      else dfsmn_streaming.stream_delay(batcher.cfg))
        self.slot = None
        self._fallback: Optional[DfsmnStreamingSession] = None
        self._buf = None
        self._consumed = 0
        self._fed = 0
        self._next_pos = 0

    def _step(self, c: np.ndarray):
        if self._fallback is None and self.slot is None:
            try:
                self.slot = self.batcher.open_slot()
            except SlotsFull:
                b = self.batcher
                kw = dict(chunk_size=b.chunk, cache_T=b._cache_T,
                          topk=b.topk, cuda_graphs=b.cuda_graphs)
                self._fallback = (
                    DfsmnMoeStreamingSession(b.params, b.cfg,
                                             moe_impl=b.moe_impl, **kw)
                    if b.moe else DfsmnStreamingSession(b.params, b.cfg,
                                                        **kw))
        if self._fallback is not None:
            return self._fallback._step(c)
        return self.batcher.push(self.slot, c)

    def reset(self) -> None:
        if self.slot is not None:
            self.batcher.close_slot(self.slot)
            self.slot = None
        if self._fallback is not None:
            self._fallback.reset()   # keeps its chunk program
        self._buf = None
        self._consumed = 0
        self._fed = 0
        self._next_pos = 0

    def clone(self):
        return BatchedDfsmnStreamingSession(self.batcher)
