"""The port's serving daemon: newline-delimited JSON over TCP (port of
the root ``serve.py``), run as

    python -m m3asr_tpu_torch.serve -p <engine_dir> [--device cpu]

One engine; concurrent requests arriving within --batch_window_ms are
padded into one batched engine call (``runtime/batching.MicroBatcher``);
requests longer than the largest bucket go through ``Engine.infer_long``
from their handler threads (the engine is re-entrant). CTC decoding runs
on the host, in the native C++ library when it builds
(``decode/native.py``), else in Python.

Protocol (one JSON object per line):
  request:  {"id": "utt1", "feat": [[...frame...], ...],
             "decode": "greedy"|"beam", "beam_size": 10,
             "timestamps": true,                  # optional
             "confidence": true,                  # optional
             "nbest": 5,                          # optional (beam)
             "context": [[ids...], ...],          # optional hotword
             "context_bonus": 3.0}                #   biasing (beam)
  response: {"id": "utt1", "hyp": [ids...], "out_len": N,
             "latency_ms": x, "times": [frames...],   # if requested
             "nbest": [{"hyp": [...], "score": s}, ...]}  # if requested
  {"stats": true} -> dispatch history, stream slots, latency percentiles

Streaming (one stream per connection; chunk-incremental greedy CTC
partials, or a prefix beam with hotwords and the server's LM; sessions
are pooled and share one batched chunk program per (chunk_size,
num_left_chunks), a CUDA graph on the card; the DFSMN families' per
chunk_size, of 256 cached frames, whose chunks are frames, not
subsampled windows):
  {"stream": "start", "chunk_size": 16, "num_left_chunks": 2,
   "decode": "beam", "beam_size": 10, "context": [[ids...]],
   "timestamps": true, "endpoint_blank_frames": N}
      -> {"ok": true, "chunk_size": 16}
  {"stream": "chunk", "feat": [[...frame...], ...]}
      -> {"partial": [ids...], "out_frames": N}
         (+"endpoint": true once >= endpoint_blank_frames trailing
          blank frames follow speech)
  {"stream": "end"}
      -> {"hyp": [ids...], "out_frames": N, "final": true}

By default chunk programs emit per-frame log-softmax top-K values and
ids on the device (--stream_topk): (C, K) cross to the host instead of
(C, V) logits, with the same partials (greedy = column 0; beam =
advance_sparse, exact for beam_size <= K). --stream_topk 0 gives dense
logits chunks. SIGHUP rebuilds the runtime from the engine dir and swaps
it in; SIGTERM/SIGINT stop accepting and drain in-flight requests for up
to --drain_secs.

An ep/tp-sharded engine dir (``build --ep/--tp``) serves on ep*tp ranks:

    python -m torch.distributed.run --nproc-per-node N \
        -m m3asr_tpu_torch.serve -p engine_dir --port 8000

Every rank runs the setup (the engine's shard, the warm-up, the default
stream batcher with ``--warmup``); rank 0 then listens, and each of its
engine calls, stream batcher openings, ticks and slot resets goes
through a ``parallel/follow.Leader`` to the other ranks, which follow it
on their shards until rank 0 sends STOP after the drain (they ignore
SIGHUP, SIGTERM and SIGINT). SIGHUP on rank 0 sends RELOAD: every rank
re-reads the dir, and requests still on the old runtime then fail
instead of running on weights the followers dropped. A sharded server's
streams run on the batcher's slots only (no unbatched overflow stream).
A failed call stops the server: no rank carries on alone.
"""

import argparse
import collections
import json
import socketserver
import threading
import time

import numpy as np

# a stream start's (chunk_size, num_left_chunks) when it names none
DEFAULT_STREAM_KEY = (16, 2)


class _StreamDecode:
    """Incremental CTC over emitted chunks. Default: greedy (collapse
    consecutive repeats, drop blanks; frame-local, so it streams). With
    ``beam_state`` (``decode/ctc.PrefixBeamState`` or the native
    ``NativeBeamState``): the chunk-incremental prefix beam search, with
    optional hotword biasing and LM fusion; beam partials may revise
    earlier tokens as more audio arrives."""

    def __init__(self, session, blank: int = 0, beam_state=None,
                 endpoint_blank_frames: int = 0):
        self.session = session
        self.blank = blank
        self.beam = beam_state
        self.prev = -1
        self.hyp = []
        self.times = []  # absolute emission frame per token
        self.frames = 0
        # rule-based endpointing (the WeNet-style trailing-silence
        # rule): once speech was seen, >= N consecutive trailing blank
        # frames (post-subsample argmax) flag end-of-speech
        self.ep_blanks = int(endpoint_blank_frames)
        self._trailing_blanks = 0
        self._spoke = False

    def update(self, chunks) -> None:
        for ch in chunks:
            if isinstance(ch, tuple):
                # sparse chunk (--stream_topk): per-frame top-K
                # log-softmax (vals, idx), best first; column 0 is the
                # dense argmax; beam partials ride advance_sparse (the
                # same hypotheses for K >= beam_size, decode/ctc.py)
                vals, idx = (np.asarray(ch[0])[0], np.asarray(ch[1])[0])
                top1 = idx[:, 0]
                if self.ep_blanks:
                    for t in top1:
                        if int(t) == self.blank:
                            self._trailing_blanks += 1
                        else:
                            self._trailing_blanks = 0
                            self._spoke = True
                if self.beam is not None:
                    self.beam.advance_sparse(vals, idx)
                    self.frames += vals.shape[0]
                    continue
                for t in top1:
                    t = int(t)
                    if t != self.prev and t != self.blank:
                        self.hyp.append(t)
                        self.times.append(self.frames)
                    self.prev = t
                    self.frames += 1
                continue
            arr = np.asarray(ch)[0]          # (T, V) logits
            if self.ep_blanks:
                for t in arr.argmax(-1):
                    if int(t) == self.blank:
                        self._trailing_blanks += 1
                    else:
                        self._trailing_blanks = 0
                        self._spoke = True
            if self.beam is not None:
                m = arr.max(-1, keepdims=True)
                lp = arr - m - np.log(
                    np.exp(arr - m).sum(-1, keepdims=True))
                self.beam.advance(lp)
                self.frames += arr.shape[0]
                continue
            for t in arr.argmax(-1):
                t = int(t)
                if t != self.prev and t != self.blank:
                    self.hyp.append(t)
                    self.times.append(self.frames)
                self.prev = t
                self.frames += 1

    def endpoint(self) -> bool:
        """End-of-speech per the trailing-blank rule (False when
        endpointing is disabled or no speech has been seen yet)."""
        return bool(self.ep_blanks and self._spoke
                    and self._trailing_blanks >= self.ep_blanks)

    def result(self):
        """(tokens, times) of the current best hypothesis."""
        if self.beam is not None:
            best = self.beam.nbest()[0]
            return list(best.tokens), list(best.times)
        return list(self.hyp), list(self.times)


class SessionPool:
    """Released sessions keep their chunk program; acquire() prefers one
    with the same (chunk_size, left) key. The first session per key
    becomes a template that later misses clone(), so concurrent cold
    streams share one batcher (one captured chunk program)."""

    def __init__(self, factory):
        self._factory = factory
        self._free = {}
        self._templates = {}
        self._lock = threading.Lock()

    def acquire(self, key):
        with self._lock:
            lst = self._free.get(key)
            if lst:
                return lst.pop()
            template = self._templates.get(key)
        if template is None:
            template = self._factory(*key)
            with self._lock:
                template = self._templates.setdefault(key, template)
        return template.clone()

    def release(self, key, session) -> None:
        session.reset()
        with self._lock:
            self._free.setdefault(key, []).append(session)


def make_handler(state, default_beam, lm=None, default_lm_weight=0.5):
    """state: mutable dict {"engine", "batcher", "stream_pool"}, read per
    request, so that a SIGHUP reload (main._reload) swaps the whole
    runtime at once; in-flight requests and open streams finish on the
    objects they started with."""
    from m3asr_tpu_torch.decode import native

    class Handler(socketserver.StreamRequestHandler):
        # requests being processed (not open connections: an idle
        # keep-alive or stream connection must not hold up the shutdown
        # drain), for the bounded drain at shutdown
        active = 0
        last_activity = 0.0
        _active_lock = threading.Lock()
        # rolling request latencies for the stats endpoint
        _lat_ms = collections.deque(maxlen=2048)
        _started = time.time()
        _served = 0

        def _stream_request(self, req):
            stream_pool = state["stream_pool"]
            if stream_pool is None:
                return {"error": state.get(
                    "stream_error",
                    "streaming unsupported for this model family")}
            op = req["stream"]
            if op == "start":
                if self._stream is not None:
                    return {"error": "stream already started"}
                key = (int(req.get("chunk_size", DEFAULT_STREAM_KEY[0])),
                       int(req.get("num_left_chunks",
                                   DEFAULT_STREAM_KEY[1])))
                if key[0] < 1 or key[1] < 0:
                    # refused before any batcher is built (on ranks a
                    # build that fails after STREAM_OPEN stops the world)
                    return {"error": "chunk_size must be >= 1 and "
                                     "num_left_chunks >= 0, got "
                                     f"{key[0]} and {key[1]}"}
                self._stream_key = key
                # sessions must release into the pool they came from
                # (a hot reload may swap state["stream_pool"] mid-stream)
                self._stream_pool = stream_pool
                beam_state = None
                if req.get("decode") == "beam":
                    from m3asr_tpu_torch.decode.ctc import ContextTrie
                    ctx = req.get("context")
                    trie = (ContextTrie(
                        ctx, float(req.get("context_bonus", 3.0)))
                        if ctx else None)
                    use_lm = lm if req.get("lm", True) else None
                    # C++ incremental beam when the native lib loads,
                    # python PrefixBeamState otherwise (same contract)
                    beam_state = native.make_beam_state(
                        int(req.get("beam_size", default_beam)),
                        context=trie, lm=use_lm,
                        lm_weight=float(req.get("lm_weight",
                                                default_lm_weight)))
                self._stream = _StreamDecode(
                    stream_pool.acquire(key), beam_state=beam_state,
                    endpoint_blank_frames=int(
                        req.get("endpoint_blank_frames", 0)))
                self._stream_times = bool(req.get("timestamps"))
                return {"ok": True, "chunk_size": key[0]}
            if self._stream is None:
                return {"error": "no active stream (send start first)"}
            if op == "chunk":
                feat = np.asarray(req["feat"], np.float32)[None]
                self._stream.update(self._stream.session.push(feat))
                toks, times = self._stream.result()
                resp = {"partial": toks,
                        "out_frames": self._stream.frames}
                if self._stream.endpoint():
                    # end of speech detected: the client should send
                    # {"stream": "end"}
                    resp["endpoint"] = True
                if self._stream_times:
                    resp["times"] = times
                return resp
            if op == "end":
                self._stream.update(self._stream.session.finish())
                toks, times = self._stream.result()
                resp = {"hyp": toks,
                        "out_frames": self._stream.frames, "final": True}
                if self._stream_times:
                    resp["times"] = times
                self._stream_pool.release(self._stream_key,
                                          self._stream.session)
                self._stream = None
                return resp
            return {"error": f"unknown stream op {op!r}"}

        def finish(self):
            # connection dropped mid-stream: recycle the session
            if getattr(self, "_stream", None) is not None:
                self._stream_pool.release(self._stream_key,
                                          self._stream.session)
                self._stream = None
            super().finish()

        def handle(self):
            self._stream = None
            cls = type(self)
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                with cls._active_lock:
                    cls.active += 1
                    cls.last_activity = time.time()
                try:
                    self._one_request(line)
                finally:
                    with cls._active_lock:
                        cls.active -= 1
                        cls.last_activity = time.time()

        def _one_request(self, line):
            try:
                req = json.loads(line)
                if req.get("stats"):
                    # observability: dispatch history + slot usage
                    # + rolling latency percentiles + uptime
                    cls = type(self)
                    lat = sorted(cls._lat_ms)
                    pct = (lambda q: round(
                        lat[min(len(lat) - 1,
                                int(q * len(lat)))], 2)) \
                        if lat else (lambda q: None)
                    stream_pool = state["stream_pool"]
                    resp = {"request_batch_sizes":
                            state["batcher"].batch_sizes[-50:],
                            "served": cls._served,
                            "uptime_s": round(
                                time.time() - cls._started, 1),
                            "latency_ms": {"p50": pct(0.50),
                                           "p95": pct(0.95),
                                           "p99": pct(0.99)}}
                    if stream_pool is not None:
                        resp["stream_batchers"] = {
                            str(key): {
                                "slots": b.batcher.slots,
                                "slots_free": len(b.batcher._free),
                                "tick_batch_sizes":
                                    b.batcher.batch_sizes[-50:],
                                "graph_pool_bytes": b.batcher.pool_bytes}
                            for key, b in list(
                                stream_pool._templates.items())}
                    self.wfile.write((json.dumps(resp) + "\n")
                                     .encode())
                    self.wfile.flush()
                    return
                if "stream" in req:
                    resp = self._stream_request(req)
                    self.wfile.write((json.dumps(resp) + "\n")
                                     .encode())
                    self.wfile.flush()
                    return
                feat = np.asarray(req["feat"], np.float32)
                t0 = time.perf_counter()
                engine = state["engine"]
                batcher = state["batcher"]
                # sparse on-device decode outputs (engine built with
                # --decode_output argmax/topk): out1 is ids / top-K
                # values and aux1 the best log-probs / top-K ids
                dmode = (engine.cfg.decode_output
                         if engine is not None else "logits")
                aux1 = None
                if (engine is not None
                        and feat.shape[0] > engine.buckets.lengths[-1]):
                    # long-form: beyond the largest bucket, decode
                    # through windowed center-cut stitching (bypasses
                    # the micro-batcher: these are rare, slow calls)
                    r = engine.infer_long(feat)
                    out1, out_len = r[0][0], int(r[1][0])
                    if len(r) > 2:
                        aux1 = np.asarray(r[2])[0]
                else:
                    r = batcher.infer(feat)
                    out1, out_len = r[0], r[1]
                    if dmode == "beam":
                        # (beam, T') n-best ids + (beam,) lens/scores
                        beam_lens = np.asarray(r[2])
                        beam_scores = np.asarray(r[3])
                    elif len(r) > 2:
                        aux1 = np.asarray(r[2])
                mode = req.get("decode", "greedy")
                want_conf = bool(req.get("confidence"))
                want_times = bool(req.get("timestamps")) or want_conf
                ctx = req.get("context")  # [[token ids], ...]
                times = None
                nbest_n = int(req.get("nbest", 1))
                nbest_out = None
                if dmode == "beam":
                    # the prefix beam search ran inside the engine
                    # (decode/device.py): serve its n-best directly
                    # (greedy requests get the best hypothesis)
                    if want_times or want_conf:
                        raise ValueError(
                            "on-device beam engines emit token ids "
                            "only; rebuild with --decode_output topk "
                            "for timestamps/confidence")
                    if ctx or (mode == "beam" and lm is not None
                               and req.get("lm", True)):
                        raise ValueError(
                            "hotword/LM fusion is a host-side search "
                            "feature; rebuild with --decode_output "
                            "topk to combine it with on-device "
                            "candidates")
                    hyp = [int(t) for t in out1[0, :beam_lens[0]]]
                    if mode == "beam" and nbest_n > 1:
                        nbest_out = [
                            {"hyp": [int(t) for t in
                                     out1[j, :beam_lens[j]]],
                             "score": round(float(beam_scores[j]), 4)}
                            for j in range(min(nbest_n, out1.shape[0]))
                            if np.isfinite(beam_scores[j])]
                elif mode == "beam":
                    if dmode == "argmax":
                        raise ValueError(
                            "engine decode_output='argmax' supports "
                            "greedy only; rebuild with --decode_output"
                            " topk (or logits) for beam decoding")
                    beam = int(req.get("beam_size", default_beam))
                    # server-loaded LM applies to beam decoding
                    # unless the request opts out ("lm": false)
                    use_lm = lm if req.get("lm", True) else None
                    if dmode == "topk":
                        if beam > out1.shape[-1]:
                            raise ValueError(
                                f"beam_size {beam} > engine "
                                f"decode_topk {out1.shape[-1]}")
                        from m3asr_tpu_torch.decode.ctc import ContextTrie
                        trie = (ContextTrie(
                            ctx, float(req.get("context_bonus", 3.0)))
                            if ctx else None)
                        hyps_nb = \
                            native.ctc_prefix_beam_search_sparse_ext(
                                out1, aux1, out_len, beam,
                                context=trie, lm=use_lm,
                                lm_weight=float(req.get(
                                    "lm_weight", default_lm_weight)))
                    elif want_times or ctx or nbest_n > 1 or use_lm:
                        m = out1.max(-1, keepdims=True)
                        lp = out1 - m - np.log(
                            np.exp(out1 - m).sum(-1, keepdims=True))
                        from m3asr_tpu_torch.decode.ctc import ContextTrie
                        trie = (ContextTrie(
                            ctx, float(req.get("context_bonus", 3.0)))
                            if ctx else None)
                        hyps_nb = native.ctc_prefix_beam_search_ext(
                            lp, out_len, beam, context=trie,
                            lm=use_lm,
                            lm_weight=float(req.get(
                                "lm_weight", default_lm_weight)))
                    else:
                        m = out1.max(-1, keepdims=True)
                        lp = out1 - m - np.log(
                            np.exp(out1 - m).sum(-1, keepdims=True))
                        hyps_nb = None
                        hyp = list(native.ctc_prefix_beam_search(
                            lp, out_len, beam)[0][0])
                    if hyps_nb is not None:
                        best = hyps_nb[0]
                        hyp = list(best.tokens)
                        times = list(best.times)
                        if nbest_n > 1:
                            nbest_out = [
                                {"hyp": [int(x) for x in h.tokens],
                                 "score": round(float(h.score), 4),
                                 **({"times": [int(x) for x in h.times]}
                                    if want_times else {})}
                                for h in hyps_nb[:nbest_n]]
                else:
                    if dmode in ("argmax", "topk"):
                        ids = (out1 if dmode == "argmax"
                               else aux1[..., 0])
                        blp = (aux1 if dmode == "argmax"
                               else out1[..., 0])
                        from m3asr_tpu_torch.decode.ctc import (
                            ctc_greedy_from_ids,
                            ctc_greedy_times_from_ids)
                        if want_times:
                            best = ctc_greedy_times_from_ids(
                                ids[None], blp[None],
                                np.array([out_len]))[0]
                            hyp = list(best.tokens)
                            times = list(best.times)
                        else:
                            hyp = ctc_greedy_from_ids(
                                ids[None], np.array([out_len]))[0]
                    elif want_times:
                        from m3asr_tpu_torch.decode.ctc import (
                            ctc_greedy_search_times)
                        best = ctc_greedy_search_times(
                            out1[None], np.array([out_len]))[0]
                        hyp = list(best.tokens)
                        times = list(best.times)
                    else:
                        hyp = native.ctc_greedy_search(
                            out1[None], np.array([out_len]))[0]
                lat_ms = round((time.perf_counter() - t0) * 1e3, 2)
                cls = type(self)
                with cls._active_lock:
                    cls._lat_ms.append(lat_ms)
                    cls._served += 1
                resp = {"id": req.get("id"), "hyp": [int(t) for t in hyp],
                        "out_len": out_len,
                        "latency_ms": lat_ms}
                if req.get("timestamps"):
                    # post-subsample frame indices (x subsample x
                    # 10 ms for wall-clock)
                    resp["times"] = [int(t) for t in times]
                if want_conf:
                    # per-token posterior at the emission frame
                    if dmode == "argmax":
                        # emission frames are argmax frames: the
                        # best log-prob IS the token's posterior
                        resp["confidence"] = [
                            round(float(np.exp(aux1[t])), 4)
                            for t in times]
                    elif dmode == "topk":
                        from m3asr_tpu_torch.decode.ctc import (
                            token_confidence_sparse)
                        resp["confidence"] = [
                            round(c, 4) for c in
                            token_confidence_sparse(out1, aux1, hyp,
                                                    times)]
                    else:
                        from m3asr_tpu_torch.decode.ctc import (
                            token_confidence)
                        if mode != "beam":  # beam path already has lp
                            m = out1.max(-1, keepdims=True)
                            lp = out1 - m - np.log(
                                np.exp(out1 - m).sum(-1,
                                                     keepdims=True))
                        resp["confidence"] = [
                            round(c, 4)
                            for c in token_confidence(lp, hyp, times)]
                if nbest_out is not None:
                    resp["nbest"] = nbest_out
            except Exception as e:  # noqa: BLE001 (report to client)
                resp = {"id": None, "error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()

    return Handler


def _stream_moe_impl(engine, slots: int) -> str:
    """The expert stage of the batched chunk programs: the engine's
    policy (``moe_auto_impl``) at 16 x slots tokens, as the JAX server
    sizes it. Float engines run K1 (``runs_f``), int4/w4a8 K6
    (``quant4_pallas`` / ``quant4_a8``) and int8/w8a8 the plain
    ``quant`` / ``quant_a8`` stage up to 128 tokens, their run-length
    kernels beyond; never a stage of ``HOST_SYNC_STAGES``. A sharded
    engine's streams run its mesh policy (``Engine.moe_impl_for``: a
    stage of ``ops/moe.MESH_STAGES``)."""
    from m3asr_tpu_torch.runtime.engine import moe_auto_impl
    if engine.mesh is not None:
        return engine.moe_impl_for(max(1, slots), 16)
    return moe_auto_impl(16 * max(1, slots), "auto", engine.quant_bits,
                         engine.cfg.act_quant)


def stream_params(engine):
    """The engine's parameters as the chunk forwards read them: separate
    q/k/v weights and float dense kernels, undoing ``dense_quant`` and
    then ``fuse_qkv`` (exact inverses; the expert weights are shared, not
    copied). The JAX server undoes them in the other order, which fails
    on an engine with both: its fused q/k/v kernel is quantized."""
    params = engine.params
    if engine.cfg.dense_quant:
        from m3asr_tpu_torch.ops.quant import dequantize_dense_params
        params = dequantize_dense_params(params, engine.dtype)
    if engine.cfg.fuse_qkv:
        from m3asr_tpu_torch.ops.attention import defuse_qkv_params
        params = defuse_qkv_params(params)
    return params


def _build_runtime(args, engine=None, follower: bool = False):
    """Engine, micro-batcher and stream session pool, bundled so that
    SIGHUP can rebuild the whole runtime from the (possibly updated)
    engine dir and swap it in without dropping the listener. An
    ``engine`` given here is served instead of loading ``args.plan_name``
    (an in-process server).

    Every rank of a sharded server builds it (the same args, at the same
    point). ``follower=True`` (ranks > 0) makes no micro-batcher and
    builds the stream batchers as mirrors; rank 0's runtime leads once
    :func:`lead_runtime` attached the leader. ``runtime["open_batcher"]``
    is the (chunk, left) -> batcher factory.

    Streams, by family: the hier MoE and dense conformers share a
    ``StreamBatcher`` per (chunk, left), the DFSMN families a
    ``DfsmnStreamBatcher`` per chunk size (their window cache is 256
    frames whatever ``left`` says), as the JAX server does. A dense
    conformer whose front end the chunk forwards do not run, and
    dfsmn_base_res, get no streams: their stream requests are answered
    with the reason."""
    from m3asr_tpu_torch.models import streaming
    from m3asr_tpu_torch.models.registry import dfsmn_stream_config
    from m3asr_tpu_torch.runtime.batching import MicroBatcher
    from m3asr_tpu_torch.parallel import follow
    from m3asr_tpu_torch.runtime.engine import Engine
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    from m3asr_tpu_torch.runtime.streaming_batch import (
        BatchedDfsmnStreamingSession, BatchedStreamingSession,
        DfsmnStreamBatcher, StreamBatcher)

    if engine is None:
        # its uploads must not meet another thread's capture (SIGHUP)
        with DEVICE_LOCK.shared():
            engine = Engine.load(args.plan_name, device=args.device)
    if args.warmup:
        # every bucket (on the card: its CUDA graph) and one executed
        # call; a cold bucket is built inside a live request otherwise
        engine.warmup(execute=True)
    # never collect more requests than the largest batch bucket runs
    max_batch = min(args.max_batch, max(engine.buckets.batches))
    batcher = None if follower else MicroBatcher(
        engine.infer, window_ms=args.batch_window_ms, max_batch=max_batch,
        beam_output=engine.cfg.decode_output == "beam")
    family = engine.family.name
    dfsmn = family.startswith("dfsmn")
    runtime = {"engine": engine, "batcher": batcher, "stream_pool": None,
               "stream_batchers": {}, "open_batcher": None, "leader": None}
    try:
        if dfsmn:
            enc_cfg = dfsmn_stream_config(engine.model_cfg)
        else:
            enc_cfg = engine.model_cfg.encoder_conf
            streaming.check_stream_supported(enc_cfg)
    except ValueError as e:
        runtime["stream_error"] = f"streaming unsupported: {e}"
        return runtime
    params = stream_params(engine)
    moe_impl = _stream_moe_impl(engine, args.stream_slots)
    # streams of one key share one batched chunk program: co-pending
    # chunks of different connections run as one tick
    batchers = runtime["stream_batchers"]
    batchers_lock = threading.Lock()
    common = dict(slots=args.stream_slots, window_ms=args.stream_window_ms,
                  topk=args.stream_topk,
                  input_dim=engine.model_cfg.input_dim)

    def make(chunk, left):
        if dfsmn:
            return DfsmnStreamBatcher(
                params, enc_cfg, chunk_size=chunk,
                moe=family == "dfsmn_moe", moe_impl=moe_impl, **common)

        def build():
            return StreamBatcher(
                params, enc_cfg, chunk_size=chunk, num_left_chunks=left,
                moe=engine.is_moe, moe_impl=moe_impl, mesh=engine.mesh,
                follower=follower, **common)
        if runtime["leader"] is None:
            return build()
        leader, generation = runtime["leader"]
        with leader.call(follow.STREAM_OPEN, (chunk, left),
                         generation=generation):
            b = build()
        b.lead(leader, (chunk, left))
        return b

    def batcher_for(chunk, left):
        key = chunk if dfsmn else (chunk, left)
        with batchers_lock:
            if key not in batchers:
                batchers[key] = make(chunk, left)
            return batchers[key]

    if args.warmup:
        # the default key's program too (on the card: its capture), which
        # live traffic would build at its first stream
        batcher_for(*DEFAULT_STREAM_KEY)

    def factory(chunk, left):
        b = batcher_for(chunk, left)
        return (BatchedDfsmnStreamingSession(b) if dfsmn
                else BatchedStreamingSession(b))

    runtime["stream_pool"] = SessionPool(factory)
    runtime["open_batcher"] = batcher_for
    return runtime


def lead_runtime(runtime, leader) -> None:
    """Rank 0 of a sharded server: the runtime's engine calls, its stream
    batchers' ticks and resets, and the batchers it opens from now on go
    through ``leader`` (``parallel/follow.Leader``)."""
    runtime["engine"].lead(leader)
    runtime["leader"] = (leader, leader.generation)
    for key, b in list(runtime["stream_batchers"].items()):
        b.lead(leader, key)


def reload_runtime(state, args, leader=None) -> None:
    """Rebuild the runtime from the engine dir and swap it into
    ``state`` (SIGHUP). With a leader every rank rebuilds at once
    (RELOAD): rank 0 under the leader's lock, so that no call runs
    between, and the runtime it replaces is refused from then on."""
    if leader is None:
        state.update(_build_runtime(args))
        return
    with leader.reload():
        new = _build_runtime(args)
        lead_runtime(new, leader)
    state.update(new)


def follow_runtime(world, runtime, args):
    """A follower rank's serving loop (``parallel/follow.follow``) on
    ``runtime`` (built with ``follower=True``); RELOAD rebuilds it and
    swaps it into ``runtime``. Returns the count of each op followed, at
    rank 0's STOP."""
    from m3asr_tpu_torch.parallel import follow

    def reload():
        runtime.update(_build_runtime(args, follower=True))
        return (runtime["engine"], runtime["stream_batchers"],
                runtime["open_batcher"])
    return follow.follow(world, runtime["engine"],
                         runtime["stream_batchers"], runtime["open_batcher"],
                         reload)


def load_lm(args):
    """The server's ARPA LM (``--lm``, with ``--units``), or None."""
    if not args.lm:
        return None
    from m3asr_tpu_torch.decode.lm import NgramLM, read_symbol_table
    symtab = read_symbol_table(args.units) if args.units else None
    lm = NgramLM(args.lm, symtab)
    print(f"loaded {lm.order}-gram LM ({len(lm.logp)} ngrams)", flush=True)
    return lm


def main(args):
    import signal
    from m3asr_tpu_torch.parallel import follow

    world = follow.join_world()
    follower = world is not None and world.rank > 0
    state = _build_runtime(args, follower=follower)
    follow.check_world(world, state["engine"])
    if follower:
        # rank 0 drains, then sends STOP: the followers outlive the drain
        for sig in (signal.SIGHUP, signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        follow_runtime(world, state, args)
        return
    leader = None
    if world is not None:
        leader = follow.Leader(world)
        lead_runtime(state, leader)
    try:
        _listen(args, state, leader)
    except BaseException:
        if leader is not None:
            leader.stop(failed=True)
        raise
    if leader is not None:
        leader.stop()
        if leader.broken is not None:
            raise RuntimeError("a call on the ranks failed; the server "
                               "stopped") from leader.broken


def _listen(args, state, leader):
    """Rank 0's listener (a single process's) until SIGTERM/SIGINT and
    the drain, or a failed call on the ranks."""
    import signal
    lm = load_lm(args)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True   # in-flight handler threads must not
        # block process exit after shutdown (they hold batcher slots)

    with Server((args.host, args.port),
                make_handler(state, args.beam_size, lm=lm,
                             default_lm_weight=args.lm_weight)) as srv:
        def _stop(signum, frame):
            # stop accepting and return from serve_forever; in-flight
            # requests finish (the drain below)
            threading.Thread(target=srv.shutdown, daemon=True).start()

        if leader is not None:
            leader.on_broken = lambda e: _stop(None, None)

        # SIGHUP rebuilds the runtime from the engine dir in a background
        # thread, then swaps it in; in-flight requests and open streams
        # finish on the old objects
        reloading = threading.Lock()

        def _reload(signum, frame):
            def run():
                if not reloading.acquire(blocking=False):
                    print("reload already in progress", flush=True)
                    return
                try:
                    reload_runtime(state, args, leader)
                    print("engine reloaded", flush=True)
                except Exception as e:  # noqa: BLE001 (keep serving)
                    # on ranks a failed reload broke the leader, which
                    # stops the server
                    print(f"engine reload FAILED (still serving the old "
                          f"weights): {e}", flush=True)
                finally:
                    reloading.release()
            threading.Thread(target=run, daemon=True).start()

        signal.signal(signal.SIGHUP, _reload)
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
        print(f"serving on {args.host}:{srv.server_address[1]}", flush=True)
        srv.serve_forever()
        # bounded drain: finish in-flight requests plus anything that
        # arrives on open connections within a short quiet period, but a
        # stuck long-lived stream must not hold the shutdown past
        # --drain_secs
        handler = srv.RequestHandlerClass
        grace = min(1.0, args.drain_secs)
        with handler._active_lock:
            handler.last_activity = time.time()
        deadline = time.time() + args.drain_secs
        while time.time() < deadline:
            if (handler.active == 0
                    and time.time() - handler.last_activity > grace):
                break
            time.sleep(0.05)
        print(f"shutdown: listener closed, {handler.active} "
              "request(s) still in flight", flush=True)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-p", "--plan_name", required=True,
                   help="engine directory (either package's format)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--warmup", action="store_true",
                   help="build every bucket and the default (chunk 16, "
                        "left 2) stream batcher (capture their CUDA "
                        "graphs) and run one call before serving")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="co-arrival window for request micro-batching")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--stream_slots", type=int, default=8,
                   help="concurrent streams sharing one batched chunk "
                        "program (overflow streams get dedicated "
                        "single-stream sessions)")
    p.add_argument("--stream_topk", type=int, default=10,
                   help="on-device sparse chunk outputs: per-frame top-K "
                        "log-softmax (vals, ids) instead of (C, V) logits; "
                        "beam partials match the dense search for "
                        "beam_size <= K. 0 = dense logits")
    p.add_argument("--stream_window_ms", type=float, default=2.0,
                   help="co-pending window for cross-stream chunk "
                        "batching")
    p.add_argument("--lm", required=False,
                   help="ARPA n-gram LM: shallow fusion on beam requests "
                        "(per-request opt-out 'lm': false)")
    p.add_argument("--lm_weight", type=float, default=0.5)
    p.add_argument("--units", required=False,
                   help="symbol table mapping ARPA words to unit ids")
    p.add_argument("--drain_secs", type=float, default=10.0,
                   help="max seconds to let in-flight requests (and "
                        "requests arriving within a 1 s quiet window on "
                        "open connections) finish after SIGTERM/SIGINT")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
