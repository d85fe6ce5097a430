"""Streaming in the PyTorch port against the JAX package, on the CPU: the
chunk forwards (``models/streaming.py``), the single-stream session, the
stream batcher, the on-device sparse top-K, the positional rows past the
5000-row table, and the engine called from two threads.

The small hier MoE conformer of ``tests/test_torch_outputs.py`` (2 embed
+ 2 MoE blocks, d=64, E=4, V=32) with every weight drawn from a numpy
seed runs in both packages; chunk 4, two left chunks. float32 outputs
must agree within allclose(rtol 1e-5, atol 1e-3), the reference
standard; int4 (the port's bf16 activations on K6's plain version
against JAX's ``quant`` stage, JAX given bf16 caches and windows) within
0.05 of max|ref|.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.config import model_config_from_dict as j_config
from m3asr_tpu.models import streaming as j_stream
from m3asr_tpu.runtime import streaming_session as j_session
from m3asr_tpu.runtime.engine import Engine as JEngine
from m3asr_tpu.runtime.engine import EngineConfig as JEngineConfig

from m3asr_tpu_torch.checkpoint import to_torch
from m3asr_tpu_torch.config import model_config_from_dict as t_config
from m3asr_tpu_torch.models import moe_conformer as t_model
from m3asr_tpu_torch.models import streaming as t_stream
from m3asr_tpu_torch.models.conformer import chunk_attention_mask
from m3asr_tpu_torch.ops.positional import MAX_LEN
from m3asr_tpu_torch.runtime import streaming_session as t_session
from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
from m3asr_tpu_torch.runtime.streaming_batch import (BatchedStreamingSession,
                                                     SlotsFull, StreamBatcher)

from test_op_parity import allclose
from test_torch_outputs import random_params, small_yaml

C, LEFT = 4, 2
CACHE_T = C * LEFT
W = 4 * C + 3
CPU = torch.device("cpu")


def causal_yaml():
    """The small model with causal convolutions in both encoders: the
    configuration whose streams equal the chunk-masked offline forward."""
    y = small_yaml()
    enc = y["model_conf"]["encoder_conf"]
    enc["causal"] = True
    enc["embed_conf"]["causal"] = True
    return y


def feats(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T, 20)).astype(np.float32)
            for T in lengths]


def rel_err(a, ref):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(ref, np.float32)).max()
                 / np.abs(np.asarray(ref, np.float32)).max())


def run_port(params, cfg, feat, n, impl="runs_f", dtype=torch.float32):
    B = feat.shape[0]
    st = t_stream.init_state(cfg, B, CACHE_T, dtype=dtype)
    es = t_stream.init_state(cfg.embed_conf, B, CACHE_T, dtype=dtype)
    outs = []
    for i in range(n):
        w = torch.from_numpy(feat[:, 4 * C * i:4 * C * i + W]).to(dtype)
        o, st, es = t_stream.forward_chunk_moe(params, cfg, w, st, es,
                                               moe_impl=impl)
        outs.append(o.float().numpy())
    return np.concatenate(outs, 1), st, es


def run_jax(params, cfg, feat, n, impl="dense", dtype=jnp.float32):
    B = feat.shape[0]

    def state(c):
        s = j_stream.init_state(c, B, CACHE_T)
        return j_stream.StreamState(s.offset, s.att_cache.astype(dtype),
                                    s.cnn_cache.astype(dtype))
    st, es = state(cfg), state(cfg.embed_conf)
    outs = []
    for i in range(n):
        w = jnp.asarray(feat[:, 4 * C * i:4 * C * i + W], dtype)
        o, st, es = j_stream.forward_chunk_moe(params, cfg, w, st, es,
                                               moe_impl=impl)
        outs.append(np.asarray(o.astype(jnp.float32)))
    return np.concatenate(outs, 1), st, es


def test_forward_chunk_moe_fp32_matches_jax_and_offline():
    """Four chunks of two streams: logits and every cache against JAX's
    forward_chunk_moe, and (causal model) the logits against the port's
    offline forward under chunk_attention_mask."""
    tree = random_params(1)
    jc = j_config(causal_yaml()).encoder_conf
    tc = t_config(causal_yaml()).encoder_conf
    n = 4
    feat = np.random.default_rng(2).standard_normal(
        (2, 4 * C * n + 3, 20)).astype(np.float32)
    tp = to_torch(tree, CPU, torch.float32)
    got, st, es = run_port(tp, tc, feat, n)
    ref, jst, jes = run_jax(jax.tree.map(jnp.asarray, tree), jc, feat, n)
    allclose(got, ref)
    for a, b in ((st, jst), (es, jes)):
        np.testing.assert_array_equal(a.offset.numpy(), np.asarray(b.offset))
        allclose(a.att_cache.numpy(), np.asarray(b.att_cache))
        allclose(a.cnn_cache.numpy(), np.asarray(b.cnn_cache))
    T = feat.shape[1]
    full = t_model.forward(tp, tc, torch.from_numpy(feat),
                           torch.tensor([T, T]), moe_impl="dense",
                           chunk_mask=chunk_attention_mask(C * n, C, LEFT)
                           )[0].numpy()
    allclose(got, full)


def test_forward_chunk_dense_encoder_matches_jax():
    """The dense conformer's forward_chunk (the embed encoder alone)."""
    tree = random_params(3)["embed"]
    jc = j_config(small_yaml()).encoder_conf.embed_conf
    tc = t_config(small_yaml()).encoder_conf.embed_conf
    feat = np.random.default_rng(4).standard_normal((1, 4 * C * 3 + 3, 20)) \
        .astype(np.float32)
    tp = to_torch(tree, CPU, torch.float32)
    st = t_stream.init_state(tc, 1, CACHE_T)
    jst = j_stream.init_state(jc, 1, CACHE_T)
    jp = jax.tree.map(jnp.asarray, tree)
    for i in range(3):
        w = feat[:, 4 * C * i:4 * C * i + W]
        o, st = t_stream.forward_chunk(tp, tc, torch.from_numpy(w), st)
        r, jst = j_stream.forward_chunk(jp, jc, jnp.asarray(w), jst)
        allclose(o.numpy(), np.asarray(r))
    allclose(st.att_cache.numpy(), np.asarray(jst.att_cache))


def test_forward_chunk_moe_int4_matches_jax_quant():
    """int4 experts: the port's bf16 stream on quant4_pallas (K6's plain
    version) against JAX's quant stage with bf16 caches and windows."""
    tree = random_params(5)
    t_eng = Engine(t_config(small_yaml()), tree, EngineConfig(dtype="int4"),
                   device="cpu")
    j_eng = JEngine(j_config(small_yaml()), tree,
                    JEngineConfig(dtype="int4", donate_input=False))
    feat = np.random.default_rng(6).standard_normal((2, 4 * C * 3 + 3, 20)) \
        .astype(np.float32)
    got, _, _ = run_port(t_eng.params, t_eng.model_cfg.encoder_conf, feat,
                         3, impl="quant4_pallas", dtype=torch.bfloat16)
    ref, _, _ = run_jax(j_eng.params, j_eng.model_cfg.encoder_conf, feat, 3,
                        impl="quant", dtype=jnp.bfloat16)
    assert rel_err(got, ref) <= 0.05


def test_select_state_keeps_idle_slots():
    tc = t_config(small_yaml()).encoder_conf
    old = t_stream.init_state(tc, 3, CACHE_T, per_slot=True)
    new = t_stream.StreamState(old.offset + 4, old.att_cache + 1,
                               old.cnn_cache + 2)
    mask = torch.tensor([True, False, True])
    t_stream.write_state(old, new, mask)
    assert old.offset.tolist() == [4, 0, 4]
    assert old.att_cache[:, 1].abs().max() == 0
    assert (old.cnn_cache[:, 0] == 2).all()


@pytest.mark.parametrize("per_slot", [False, True])
def test_positional_rows_past_the_table_match_jax(per_slot):
    """Offsets whose window runs past the 5000-row table: per-slot rows
    past it are NaN (jnp.take's fill), a scalar offset's window is
    clamped to end at the last row (dynamic_slice); never an index past
    the table. Key validity follows the unclamped offset in both."""
    tree = random_params(7)
    jc = j_config(small_yaml()).encoder_conf
    tc = t_config(small_yaml()).encoder_conf
    # past 5000 - cache_T - C: partly (the first) and wholly past the end
    offsets = [MAX_LEN - 2, MAX_LEN + 3, 0, 5]
    if not per_slot:
        offsets = offsets[:1]
    off = np.array(offsets if per_slot else offsets[0], np.int32)
    feat = np.random.default_rng(8).standard_normal(
        (len(offsets), W, 20)).astype(np.float32)
    tp = to_torch(tree, CPU, torch.float32)
    st = t_stream.init_state(tc, len(offsets), CACHE_T, per_slot=per_slot)
    st.offset = torch.from_numpy(off)
    jst = j_stream.init_state(jc, len(offsets), CACHE_T, per_slot=per_slot)
    jst = j_stream.StreamState(jnp.asarray(off), jst.att_cache,
                               jst.cnn_cache)
    _, pos, valid, _ = t_stream._frontend_chunk(
        tp, tc, torch.from_numpy(feat), st, CACHE_T)
    _, jpos, jvalid, _ = j_stream._frontend_chunk(
        jax.tree.map(jnp.asarray, tree), jc, jnp.asarray(feat), jst,
        CACHE_T)
    jpos = np.asarray(jpos)
    np.testing.assert_array_equal(np.isnan(pos.numpy()), np.isnan(jpos))
    fin = ~np.isnan(jpos)
    np.testing.assert_array_equal(pos.numpy()[fin], jpos[fin])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.isnan(jpos).any() == per_slot


@pytest.mark.parametrize("k", [1, 5, 40])
def test_sparse_topk_matches_jax(k):
    logits = np.random.default_rng(k).standard_normal((3, 4, 32)) \
        .astype(np.float32) * 3
    vals, idx = t_session.sparse_topk(torch.from_numpy(logits), k)
    rv, ri = j_session.sparse_topk(jnp.asarray(logits), k)
    assert idx.dtype == torch.int32 and vals.shape == (3, 4, min(k, 32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=0,
                               atol=1e-6)


def feed(sess, feat, pieces, outs):
    i = 0
    for n in pieces:
        outs.extend(sess.push(feat[:, i:i + n]))
        i += n
    outs.extend(sess.finish())


@pytest.mark.parametrize("topk", [0, 5])
def test_streaming_session_matches_jax(topk):
    """Uneven pushes and finish(): the same chunk outputs as JAX's
    StreamingSession (dense logits, or top-K values and ids)."""
    tree = random_params(9)
    y = small_yaml()
    f, = feats(10, 4 * C * 3 + 9)
    pieces = [5, 30, 2, 20]
    got, ref = [], []
    feed(t_session.StreamingSession(
        to_torch(tree, CPU, torch.float32), t_config(y).encoder_conf,
        chunk_size=C, num_left_chunks=LEFT, moe=True, moe_impl="runs_f",
        topk=topk), f, pieces, got)
    feed(j_session.StreamingSession(
        jax.tree.map(jnp.asarray, tree), j_config(y).encoder_conf,
        chunk_size=C, num_left_chunks=LEFT, moe=True, topk=topk), f, pieces,
        ref)
    assert len(got) == len(ref) == 4   # three windows and the tail
    for g, r in zip(got, ref):
        if topk:
            np.testing.assert_array_equal(g[1], np.asarray(r[1]))
            allclose(g[0], np.asarray(r[0]))
        else:
            allclose(g, np.asarray(r))
    assert (got[-1][0] if topk else got[-1]).shape[1] == (57 - 48 - 3) // 4


def test_stream_batcher_matches_single_sessions():
    """Three slots, staggered starts, uneven pushes from three threads;
    each session resets (releasing its slot, after the tick in flight if
    there is one) and the first then serves a fourth stream on a
    recycled slot. Every stream's outputs equal an independent single
    session's, and some tick held more than one stream."""
    tree = random_params(11)
    cfg = t_config(small_yaml()).encoder_conf
    tp = to_torch(tree, CPU, torch.float32)
    kw = dict(chunk_size=C, num_left_chunks=LEFT, moe=True,
              moe_impl="runs_f", topk=5)
    fs = feats(12, 4 * C * 3 + 3, 4 * C * 2 + 9, 4 * C * 4, 4 * C * 2 + 3)
    pieces = [[30, 21, 16], [17, 40], [29, 35], [3, 32]]
    refs = []
    for f, ps in zip(fs, pieces):
        refs.append([])
        feed(t_session.StreamingSession(tp, cfg, **kw), f, ps, refs[-1])
    b = StreamBatcher(tp, cfg, slots=3, window_ms=20.0, input_dim=20, **kw)
    got = [[] for _ in range(4)]
    try:
        sessions = [BatchedStreamingSession(b) for _ in range(3)]
        go = threading.Barrier(3)

        def run(i):
            go.wait()
            threading.Event().wait(0.01 * i)     # staggered starts
            feed(sessions[i], fs[i], pieces[i], got[i])
            sessions[i].reset()
            if i == 0:                           # a recycled slot
                feed(sessions[0], fs[3], pieces[3], got[3])
                sessions[0].reset()
        ths = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    finally:
        b.close()
    assert max(b.batch_sizes) > 1, b.batch_sizes
    assert sorted(b._free) == [0, 1, 2]
    for g, r in zip(got, refs):
        assert len(g) == len(r)
        for a, c in zip(g, r):
            np.testing.assert_array_equal(a[1], c[1])
            allclose(a[0], c[0])


def test_reset_during_a_tick_applies_after_it():
    """A reset of a slot whose chunk is in the tick: the tick's state
    write-back happens, then the slot is zeroed."""
    tree = random_params(13)
    cfg = t_config(small_yaml()).encoder_conf
    tp = to_torch(tree, CPU, torch.float32)
    b = StreamBatcher(tp, cfg, chunk_size=C, num_left_chunks=LEFT, slots=2,
                      moe=True, moe_impl="runs_f", input_dim=20)
    orig_tick = b._tick

    def tick(windows, mask):
        b.reset_slot(0)                     # during the tick: deferred
        out = orig_tick(windows, mask)
        assert b._prog.inputs[2][0] == C    # written back first
        return out
    b._tick = tick
    try:
        slot = b.open_slot()
        assert slot == 1
        f, = feats(14, W)
        b.push(0, f)
    finally:
        b.close()
    state = b._prog.inputs[2:]
    assert all(float(t[0].abs().max() if t.dim() == 1 else
                     t[:, 0].abs().max()) == 0 for t in state)


def test_batched_session_falls_back_when_slots_are_full():
    tree = random_params(15)
    cfg = t_config(small_yaml()).encoder_conf
    tp = to_torch(tree, CPU, torch.float32)
    b = StreamBatcher(tp, cfg, chunk_size=C, num_left_chunks=LEFT, slots=1,
                      moe=True, moe_impl="runs_f", input_dim=20)
    try:
        s1, s2 = BatchedStreamingSession(b), BatchedStreamingSession(b)
        f, = feats(16, 2 * W)
        a, c = [], []
        feed(s1, f, [2 * W], a)
        with pytest.raises(SlotsFull):
            b.open_slot()
        feed(s2, f, [2 * W], c)
        assert s2._fallback is not None and s1.slot is not None
        for x, y in zip(a, c):
            allclose(x, y)
        s1.reset()
        assert s1.slot is None and len(b._free) == 1
    finally:
        b.close()


def test_dfsmn_sessions_are_not_ported():
    from m3asr_tpu_torch.runtime.streaming_batch import DfsmnStreamBatcher
    for cls in (t_session.DfsmnStreamingSession,
                t_session.DfsmnMoeStreamingSession, DfsmnStreamBatcher):
        with pytest.raises(NotImplementedError, match="item 10"):
            cls(None, None)


def test_engine_is_reentrant():
    """Two threads, 120 calls each on their own 1x50 input, on one engine
    (bucket 2x64): every result equals the serial one."""
    eng = Engine(t_config(small_yaml()), random_params(17),
                 EngineConfig(bucket_lengths=(64,), bucket_batches=(2,)),
                 device="cpu")
    rng = np.random.default_rng(18)
    inputs = [rng.standard_normal((1, 50, 20)).astype(np.float32)
              for _ in range(2)]
    serial = [eng.infer(x, np.array([50])) for x in inputs]
    bad = [0, 0]

    def run(i):
        for _ in range(120):
            got = eng.infer(inputs[i], np.array([50]))
            bad[i] += not all(np.array_equal(a, b)
                              for a, b in zip(got, serial[i]))
    ths = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)     # switch threads often
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ths)
    assert bad == [0, 0]


def test_device_lock_sides():
    """Shared sections run side by side; an exclusive one runs alone and,
    while it waits, holds back new shared sections; both sides nest in an
    exclusive hold, and a shared hold cannot be upgraded."""
    from m3asr_tpu_torch.runtime.graphs import DeviceLock
    lock = DeviceLock()
    both = threading.Barrier(2, timeout=10)

    def reader():
        with lock.shared():
            both.wait()             # raises unless both are inside
    ths = [threading.Thread(target=reader) for _ in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=10)
    assert not both.broken
    order = []
    first_in, release = threading.Event(), threading.Event()

    def first():
        with lock.shared():
            first_in.set()
            release.wait(10)
            order.append("shared 1 out")

    def writer():
        with lock.exclusive():
            order.append("exclusive")

    def late_reader():
        with lock.shared():
            order.append("shared 2")
    t1 = threading.Thread(target=first)
    t1.start()
    first_in.wait(10)
    tw = threading.Thread(target=writer)
    tw.start()
    while not lock._waiting:        # the writer queued behind reader 1
        threading.Event().wait(0.001)
    t2 = threading.Thread(target=late_reader)
    t2.start()
    t2.join(timeout=0.2)
    assert t2.is_alive() and order == []
    release.set()
    for t in (t1, tw, t2):
        t.join(timeout=10)
    assert order == ["shared 1 out", "exclusive", "shared 2"]
    with lock.exclusive():
        with lock.shared(), lock.exclusive(), lock.shared():
            pass
    with lock.shared(), lock.shared():
        with pytest.raises(RuntimeError, match="capture inside a shared"):
            with lock.exclusive():
                pass
    assert lock._owner is None and not lock._shared


@pytest.mark.parametrize("build", ["engine bucket", "session program",
                                   "batcher program"])
def test_program_builds_hold_the_device_lock_alone(build):
    """A program's static inputs (and, on the card, its capture) are
    allocated under DEVICE_LOCK's exclusive side: the build waits for
    another thread's shared device section to end."""
    from m3asr_tpu_torch.runtime.graphs import DEVICE_LOCK
    tree = random_params(19)
    cfg = t_config(small_yaml())
    if build == "engine bucket":
        eng = Engine(cfg, tree, EngineConfig(bucket_lengths=(64,),
                                             bucket_batches=(1,)),
                     device="cpu")
        run = lambda: eng.get_fn(1, 64)                       # noqa: E731
    else:
        tp = to_torch(tree, CPU, torch.float32)
        kw = dict(chunk_size=C, num_left_chunks=LEFT, moe=True,
                  moe_impl="runs_f")
        if build == "session program":
            sess = t_session.StreamingSession(tp, cfg.encoder_conf, **kw)
            run = lambda: sess.push(feats(20, W)[0])          # noqa: E731
        else:
            run = lambda: StreamBatcher(                      # noqa: E731
                tp, cfg.encoder_conf, slots=2, input_dim=20, **kw).close()
    done = threading.Event()
    t = threading.Thread(target=lambda: (run(), done.set()))
    with DEVICE_LOCK.shared():
        t.start()
        assert not done.wait(0.3)
    t.join(timeout=60)
    assert done.is_set()
