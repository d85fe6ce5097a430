"""The control channel of a sharded serving loop (recognize and serve on
an ep/tp engine dir).

The JAX package runs one process over every device, so its recognizer
and server need nothing more than ``Engine.load``. The port runs one
process per shard: rank 0 runs the loop (the loader and the decoding,
or the HTTP listener) and every other rank runs :func:`follow`, which
does on its shard exactly what rank 0 does on its own, call by call,
until a stop message arrives:

    world = join_world()                  # every rank, before the load
    engine = Engine.load(engine_dir)      # every rank: its shard
    if world.rank:
        follow(world, engine)             # returns on STOP
    else:
        leader = Leader(world)
        engine.lead(leader)               # every infer goes through it
        try:
            ... the loop ...
        finally:
            leader.stop(failed=...)

The channel is one gloo process group (:func:`join_world`), so headers
and payloads travel as host tensors whatever the world's backend. A call
is a header, a fixed-length int64 vector (the op, then its fields),
broadcast from rank 0, then the payload tensors its fields size:

    INFER         batch, length, width, out_mode index; feat (B, T, D)
                  float32, feat_len (B,) int32
    STREAM_OPEN   chunk, left: a stream batcher of that key
    STREAM_RESET  chunk, left, n; the slots (n,) int64
    STREAM_TICK   chunk, left, slots, window, width; windows (S, W, D)
                  float32, the slot mask (S,) uint8
    RELOAD        re-read the engine dir (SIGHUP), drop the batchers
    STOP          failed (0 or 1)

INFER carries the request, not the padded bucket: every rank then calls
the same ``Engine.infer`` and picks the same bucket, so ``infer_long``
and ``warmup(execute=True)`` mirror with nothing more.

:class:`Leader` sends a call and runs its local twin under one lock per
process: the broadcast and the whole forward, whose all-reduces follow
it, so that two threads of rank 0 (the micro-batcher's, a stream
batcher's tick) never interleave collectives on the same groups. A
failure after a header went out (the local call raising, a send
failing) leaves the ranks out of step: the leader is then broken, calls
raise, and :meth:`Leader.stop` sends STOP with ``failed`` where it still
can, on which the followers raise too. So a caller checks whatever
comes from a client before its call (``Engine.infer`` the request's
shape and lengths, the server a stream's key, ``push`` a window's
shape): a malformed request is refused on rank 0 alone. A follower's
error ends its process with a non-zero code, and rank 0's next
collective then fails.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

INFER, STREAM_OPEN, STREAM_RESET, STREAM_TICK, RELOAD, STOP = range(1, 7)
OPS = {INFER: "INFER", STREAM_OPEN: "STREAM_OPEN",
       STREAM_RESET: "STREAM_RESET", STREAM_TICK: "STREAM_TICK",
       RELOAD: "RELOAD", STOP: "STOP"}
HEADER_LEN = 8
# the control group's timeout: how long a follower waits for rank 0's
# next call (an idle server sends none); a dead rank 0 closes its
# sockets, which ends the wait at once
IDLE_TIMEOUT_S = 30 * 24 * 3600.0


def encode(op: int, *fields: int) -> torch.Tensor:
    """The header of a call: (HEADER_LEN,) int64, the op then its fields,
    zero-padded."""
    if op not in OPS:
        raise ValueError(f"unknown control op {op}")
    if len(fields) > HEADER_LEN - 1:
        raise ValueError(f"{OPS[op]}: {len(fields)} fields, at most "
                         f"{HEADER_LEN - 1}")
    h = torch.zeros((HEADER_LEN,), dtype=torch.int64)
    h[0] = op
    h[1:1 + len(fields)] = torch.tensor([int(f) for f in fields],
                                        dtype=torch.int64)
    return h


def decode(header: torch.Tensor) -> Tuple[int, Tuple[int, ...]]:
    """(op, its HEADER_LEN - 1 fields) of a header; an op outside
    :data:`OPS` raises ValueError."""
    vals = [int(v) for v in header.tolist()]
    if len(vals) != HEADER_LEN:
        raise ValueError(f"a header holds {HEADER_LEN} values, not "
                         f"{len(vals)}")
    if vals[0] not in OPS:
        raise ValueError(f"unknown control op {vals[0]}")
    return vals[0], tuple(vals[1:])


class World:
    """This rank's place in the world and the control channel: rank 0
    broadcasts (:meth:`send`), the others receive (:meth:`recv`), over
    ``group``."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank, self.size, self.group = rank, size, group

    def send(self, t: torch.Tensor) -> None:
        import torch.distributed as dist
        dist.broadcast(t.contiguous(), src=0, group=self.group)

    def recv(self, shape, dtype) -> torch.Tensor:
        import torch.distributed as dist
        t = torch.empty(tuple(shape), dtype=dtype)
        dist.broadcast(t, src=0, group=self.group)
        return t


def join_world() -> Optional[World]:
    """Bring the torch.distributed world up from the env
    (``distributed.initialize``) and create the control group, the same
    call on every rank at the same point of its setup. None for a single
    process (no env, or a world of one rank: nothing to follow)."""
    import torch.distributed as dist
    from m3asr_tpu_torch.parallel import distributed
    if not distributed.initialize() or dist.get_world_size() == 1:
        return None
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=IDLE_TIMEOUT_S))
    return World(dist.get_rank(), dist.get_world_size(), group)


def check_world(world: Optional[World], engine) -> None:
    """Raise unless the engine runs one shard a rank of ``world``: a
    world of N > 1 ranks needs an ep x tp engine of N shards (a sharded
    engine already checks its own world, ``runtime/engine.serving_mesh``)."""
    if world is None or world.size == 1:
        return
    if engine.mesh is None:
        raise RuntimeError(
            f"a world of {world.size} ranks runs an ep x tp engine of "
            f"{world.size} shards; this engine is unsharded (run it as one "
            "process)")


class LeaderBroken(RuntimeError):
    """A call failed after its header went out: the ranks are out of
    step."""


class Leader:
    """Rank 0's side of the channel. :meth:`call` broadcasts a header
    and its payloads, then runs the caller's local twin inside, all under
    :attr:`lock` (re-entrant; exclusive: one call of the process at a
    time). Callers that pass a ``generation`` are refused once a
    :meth:`reload` made it stale (the followers hold only the newest
    runtime). :attr:`on_broken`, when set, is called with the error that
    broke the leader (the server stops on it)."""

    def __init__(self, world: World):
        if world.rank != 0:
            raise ValueError("the leader is rank 0")
        self.world = world
        self.lock = threading.RLock()
        self.generation = 0
        self.broken: Optional[BaseException] = None
        self.stopped = False
        self.on_broken: Optional[Callable[[BaseException], None]] = None
        self.calls: Dict[str, int] = {name: 0 for name in OPS.values()}

    def _break(self, e: BaseException) -> None:
        if self.broken is None:
            self.broken = e
            if self.on_broken is not None:
                self.on_broken(e)

    @contextlib.contextmanager
    def call(self, op: int, fields: Sequence[int] = (),
             payloads: Sequence[torch.Tensor] = (),
             generation: Optional[int] = None):
        """Broadcast ``op`` and ``payloads``, then run the body (the local
        twin of what the followers run) under the lock. An error in the
        broadcast or the body breaks the leader (:class:`LeaderBroken` on
        every later call) and propagates."""
        with self.lock:
            if self.broken is not None:
                raise LeaderBroken(f"an earlier call failed ({self.broken!r}): "
                                   "the ranks are out of step")
            if self.stopped:
                raise RuntimeError("the leader has sent STOP")
            if generation is not None and generation != self.generation:
                raise RuntimeError("this runtime was replaced by a reload; "
                                   "retry on the new one")
            try:
                self.world.send(encode(op, *fields))
                for p in payloads:
                    self.world.send(p)
                self.calls[OPS[op]] += 1
                yield
            except BaseException as e:
                self._break(e)
                raise

    def infer(self, feat: np.ndarray, feat_len: np.ndarray, mode_index: int,
              generation: Optional[int] = None):
        """:meth:`call` of INFER for a float32 (B, T, D) request and its
        int32 (B,) lengths."""
        B, T, D = feat.shape
        return self.call(INFER, (B, T, D, mode_index),
                         (torch.from_numpy(feat), torch.from_numpy(feat_len)),
                         generation)

    @contextlib.contextmanager
    def reload(self):
        """:meth:`call` of RELOAD: the body rebuilds rank 0's runtime while
        the followers rebuild theirs; every runtime led before is
        stale."""
        with self.lock:
            self.generation += 1
            with self.call(RELOAD):
                yield

    def stop(self, failed: bool = False) -> None:
        """Send STOP once (``failed``: the followers raise on it). After a
        broken call the send is tried and its failure ignored: the
        followers then end at the failed collective or its timeout."""
        with self.lock:
            if self.stopped:
                return
            self.stopped = True
            try:
                self.world.send(encode(STOP, int(failed or self.broken
                                                 is not None)))
                self.calls["STOP"] += 1
            except Exception:           # noqa: BLE001 (best effort)
                if self.broken is None:
                    raise


def follow(world: World, engine, batchers: Optional[Dict] = None,
           open_batcher: Optional[Callable] = None,
           reload: Optional[Callable] = None) -> Dict[str, int]:
    """The follower loop (ranks > 0): receive each call of rank 0's and
    run it on this rank's ``engine`` and mirror ``batchers`` ({(chunk,
    left): StreamBatcher built with ``follower=True``}), until STOP.
    ``open_batcher(chunk, left)`` makes a mirror batcher (STREAM_OPEN);
    ``reload()`` rebuilds the runtime from the engine dir and returns
    (engine, batchers, open_batcher) (RELOAD). Returns the count of
    each op followed. STOP with ``failed`` raises RuntimeError, as does
    a call this rank cannot run; nothing else ends the loop but an
    error."""
    from m3asr_tpu_torch.runtime.engine import DECODE_OUTPUTS
    batchers = {} if batchers is None else batchers
    counts = {name: 0 for name in OPS.values()}
    while True:
        op, f = decode(world.recv((HEADER_LEN,), torch.int64))
        counts[OPS[op]] += 1
        if op == INFER:
            B, T, D, mode = f[:4]
            feat = world.recv((B, T, D), torch.float32)
            feat_len = world.recv((B,), torch.int32)
            engine.infer(feat.numpy(), feat_len.numpy(),
                         out_mode=DECODE_OUTPUTS[mode])
        elif op == STREAM_OPEN:
            if open_batcher is None:
                raise RuntimeError("STREAM_OPEN: this follower serves no "
                                   "streams")
            batchers[(f[0], f[1])] = open_batcher(f[0], f[1])
        elif op == STREAM_RESET:
            slots = world.recv((f[2],), torch.int64)
            batchers[(f[0], f[1])].mirror_reset(slots.tolist())
        elif op == STREAM_TICK:
            S, W, D = f[2:5]
            windows = world.recv((S, W, D), torch.float32)
            mask = world.recv((S,), torch.uint8)
            batchers[(f[0], f[1])].mirror_tick(windows.numpy(),
                                               mask.numpy().astype(bool))
        elif op == RELOAD:
            if reload is None:
                raise RuntimeError("RELOAD: this follower has no engine dir "
                                   "to re-read")
            engine, batchers, open_batcher = reload()
        else:                                           # STOP
            if f[0]:
                raise RuntimeError("rank 0 stopped the world after an "
                                   "error")
            return counts
