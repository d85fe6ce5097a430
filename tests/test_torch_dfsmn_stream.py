"""DFSMN streaming in the PyTorch port against the JAX package, on the CPU:
the chunk forwards (``models/dfsmn_streaming.py``), the single-stream
sessions, the stream batcher with its batched sessions, the sparse
top-K outputs, the positional clip past the 5000-row table, the causal
stream against the chunk-masked offline forward, and the port's server
answering DFSMN streams.

Small nets: a dfsmn_san of 2 blocks x 2 cFSMN (hidden 24, memory 16, 4
heads, 8 memory slots), and the MoE net with 4 experts and an embed
sub-net of 1 block x 2 cFSMN; look-ahead 1 (so the MoE main path reads
through a 1-frame input delay) unless a test says causal. Parameters are
the JAX package's init with every float leaf redrawn from a numpy seed
(``test_torch_dfsmn.redrawn``: decisive routers), carried across as the
same numpy tree. Tolerances: float32 allclose(rtol 1e-5, atol 1e-3), the
reference's; bf16 and the quantized stages within 0.05 of max|ref|
against JAX with the same routing (decisive routers: no near-ties), JAX
given bf16 caches and chunks where the port keeps bf16 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.models import dfsmn as j_dfsmn
from m3asr_tpu.models import dfsmn_streaming as j_stream
from m3asr_tpu.ops import quant as j_quant
from m3asr_tpu.runtime import streaming_session as j_session

from m3asr_tpu_torch.checkpoint import to_torch
from m3asr_tpu_torch.models import dfsmn as t_dfsmn
from m3asr_tpu_torch.models import dfsmn_streaming as t_stream
from m3asr_tpu_torch.ops.positional import MAX_LEN
from m3asr_tpu_torch.runtime import streaming_session as t_session
from m3asr_tpu_torch.runtime.streaming_batch import (
    BatchedDfsmnStreamingSession, DfsmnStreamBatcher, SlotsFull)

from test_op_parity import allclose
from test_torch_dfsmn import redrawn, tree_j

IN, OUT = 12, 7
C = 4                     # chunk frames
CACHE_T = 8               # window cache (smaller than the streams)
SAN = dict(num_block=2, fsmn_each_block=2, hidden_dim=24, memory_dim=16,
           num_head=4, num_memory=8)
EMBED = dict(num_block=1, fsmn_each_block=2, hidden_dim=24, memory_dim=16,
             num_head=4, num_memory=8)


def san_cfgs(look_ahead=1):
    return (j_dfsmn.DfsmnSanConfig(**SAN, look_ahead=look_ahead),
            t_dfsmn.DfsmnSanConfig(**SAN, look_ahead=look_ahead))


def moe_cfgs(look_ahead=1):
    kw = dict(SAN, look_ahead=look_ahead, num_experts=4, embed_dim=16)
    return (j_dfsmn.DfsmnSanMoEConfig(**kw, embed_conf=j_dfsmn.DfsmnSanConfig(
                **EMBED, look_ahead=look_ahead)),
            t_dfsmn.DfsmnSanMoEConfig(**kw, embed_conf=t_dfsmn.DfsmnSanConfig(
                **EMBED, look_ahead=look_ahead)))


def san_params(cfg_j, seed=0):
    return redrawn(j_dfsmn.init_dfsmn_san(jax.random.PRNGKey(seed), cfg_j,
                                          IN, OUT), seed)


def moe_params(cfg_j, seed=1):
    return redrawn(j_dfsmn.init_dfsmn_san_moe(jax.random.PRNGKey(seed),
                                              cfg_j, IN, OUT), seed)


def jax_quantized(tree, bits):
    """The numpy tree with every expert node quantized by the JAX
    package (the tree both sides then read)."""
    def q(node):
        if isinstance(node, dict):
            if "w1" in node and "w2" in node and "router" in node:
                return jax.tree.map(np.asarray, j_quant.quantize_moe_params(
                    tree_j(node), bits=bits))
            return {k: q(v) for k, v in node.items()}
        if isinstance(node, list):
            return [q(v) for v in node]
        return node
    return q(tree)


def feats(seed, *lengths, batch=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, T, IN)).astype(np.float32)
            for T in lengths]


def held(got, ref, fp32):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if fp32:
        allclose(got, ref)
    else:
        assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def run_jax(params, cfg, x, n, moe=False, impl="dense", per_slot=False,
            dtype=jnp.float32, offset=None):
    """n chunks of x (B, n*C, IN) through the JAX chunk forward (jitted):
    the outputs (B, n*C, V) float32 and the last state."""
    B = x.shape[0]
    if moe:
        st = j_stream.init_moe_state(cfg, B, CACHE_T, C, IN,
                                     per_slot=per_slot)
        step = jax.jit(lambda c, s: j_stream.forward_chunk_moe(
            params, cfg, c, s, moe_impl=impl))
    else:
        st = j_stream.init_state(cfg, B, CACHE_T, per_slot=per_slot)
        step = jax.jit(lambda c, s: j_stream.forward_chunk(params, cfg, c,
                                                          s))
    st = jax.tree.map(lambda a: a.astype(dtype)
                      if a.dtype == jnp.float32 else a, st)
    if offset is not None:
        st.offset = st.offset + offset
    outs = []
    for i in range(n):
        o, st = step(jnp.asarray(x[:, i * C:(i + 1) * C], dtype), st)
        outs.append(np.asarray(o, np.float32))
    return np.concatenate(outs, axis=1), st


def run_port(params, cfg, x, n, moe=False, impl="dense", per_slot=False,
             dtype=torch.float32, offset=None):
    B = x.shape[0]
    st = (t_stream.init_moe_state(cfg, B, CACHE_T, C, IN, per_slot,
                                  dtype=dtype) if moe else
          t_stream.init_state(cfg, B, CACHE_T, per_slot, dtype=dtype))
    if offset is not None:
        st.offset += offset
    outs = []
    for i in range(n):
        c = torch.from_numpy(x[:, i * C:(i + 1) * C]).to(dtype)
        if moe:
            o, st = t_stream.forward_chunk_moe(params, cfg, c, st,
                                               moe_impl=impl)
        else:
            o, st = t_stream.forward_chunk(params, cfg, c, st)
        outs.append(o.float().numpy())
    return np.concatenate(outs, axis=1), st


# ---------------------------------------------------------------------------
# the chunk forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first", [True, False])
def test_stream_cfsmn_matches_jax(first):
    """One cFSMN layer with look-ahead chunk by chunk: the port equals
    JAX's _stream_cfsmn, and, delay-aligned, its own offline layer."""
    in_dim = IN if first else 16
    jp = redrawn(j_dfsmn.init_cfsmn(jax.random.PRNGKey(3), in_dim, 24, 16,
                                    4, 1), 3)
    tp = to_torch(jp)
    fj = j_dfsmn.FsmnConfig(upper_bound=None if first else 1.0,
                            skip_connect=not first)
    ft = t_dfsmn.FsmnConfig(upper_bound=None if first else 1.0,
                            skip_connect=not first)
    x = np.random.default_rng(4).standard_normal((2, 24, in_dim)) \
        .astype(np.float32)
    cj = jnp.zeros((2, 9, 16), jnp.float32)
    ct = torch.zeros((2, 9, 16))
    got, ref = [], []
    for k in range(6):
        o, cj = j_stream._stream_cfsmn(tree_j(jp), jnp.asarray(
            x[:, 4 * k:4 * k + 4]), cj, fj)
        ref.append(np.asarray(o))
        o, ct = t_stream._stream_cfsmn(tp, torch.from_numpy(
            x[:, 4 * k:4 * k + 4]), ct, ft)
        got.append(o.numpy())
    got, ref = np.concatenate(got, 1), np.concatenate(ref, 1)
    allclose(got, ref)
    allclose(ct.numpy(), np.asarray(cj))
    full = t_dfsmn.cfsmn_layer(tp, torch.from_numpy(x), None, ft).numpy()
    allclose(got[:, 1:], full[:, :-1])       # rctx = 1 frame later


@pytest.mark.parametrize("per_slot", [False, True])
def test_forward_chunk_matches_jax(per_slot):
    """dfsmn_san: 7 chunks (past the 8-frame window), scalar and per-slot
    offsets; outputs and the final state equal JAX's."""
    cj, ct = san_cfgs()
    jp = san_params(cj)
    x, = feats(5, 7 * C, batch=2)
    ref, jst = run_jax(tree_j(jp), cj, x, 7, per_slot=per_slot)
    got, tst = run_port(to_torch(jp), ct, x, 7, per_slot=per_slot)
    allclose(got, ref)
    for a, b in zip(t_stream.state_tensors(tst),
                    jax.tree.leaves(jst)):
        allclose(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("per_slot", [False, True])
def test_forward_chunk_moe_matches_jax(per_slot):
    """The MoE net (input delay 1, the embed ring) over 7 chunks, scalar
    and per-slot offsets, the port's runs_f (K1's plain version here)
    against JAX's dense stage: outputs and the final state."""
    cj, ct = moe_cfgs()
    assert t_stream.moe_stream_delay(ct, C) == \
        j_stream.moe_stream_delay(cj, C) == 5
    jp = moe_params(cj)
    x, = feats(6, 7 * C, batch=2)
    ref, jst = run_jax(tree_j(jp), cj, x, 7, moe=True, per_slot=per_slot)
    got, tst = run_port(to_torch(jp), ct, x, 7, moe=True, impl="runs_f",
                        per_slot=per_slot)
    allclose(got, ref)
    for a, b in zip(t_stream.state_tensors(tst), jax.tree.leaves(jst)):
        allclose(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int4", "w4a8"])
def test_moe_stream_modes_match_jax(mode):
    """bf16 (runs_f) and the quantized trees through the stages the port's
    server picks at 16 x 8 tokens (int8: quant; int4: quant4_pallas, K6's
    plain version; w4a8: quant4_a8) against JAX's stream on the same tree
    with its own stage names (the JAX stream maps every name but 'quant'
    to the float dense stage, which cannot read a quantized tree: it is
    given 'quant'; w4a8 against JAX's weight-only quant), JAX in bf16 with
    bf16 caches: within 0.05 of max|ref|."""
    cj, ct = moe_cfgs()
    jp = moe_params(cj)
    bits = {"bfloat16": None, "int8": 8, "int4": 4, "w4a8": 4}[mode]
    tree = jp if bits is None else jax_quantized(jp, bits)
    impl = {"bfloat16": "runs_f", "int8": "quant", "int4": "quant4_pallas",
            "w4a8": "quant4_a8"}[mode]
    x, = feats(7, 5 * C, batch=2)
    ref, _ = run_jax(tree_j(tree, jnp.bfloat16), cj, x, 5, moe=True,
                     impl="dense" if bits is None else "quant",
                     dtype=jnp.bfloat16)
    got, _ = run_port(to_torch(tree, dtype=torch.bfloat16), ct, x, 5,
                      moe=True, impl=impl, dtype=torch.bfloat16)
    held(got, ref, False)


def test_moe_stream_refuses_stages_outside_the_table():
    _, ct = moe_cfgs()
    st = t_stream.init_moe_state(ct, 1, CACHE_T, C, IN)
    with pytest.raises(ValueError, match="DFSMN-MoE"):
        t_stream.forward_chunk_moe({}, ct, torch.zeros(1, C, IN), st,
                                   moe_impl="pallas")


def test_positional_rows_clip_past_the_table():
    """A stream whose offset nears 5000 frames: each frame's positional
    row is clipped to the table's last row, as JAX clips it, so the
    port's chunks equal JAX's there (scalar and per-slot offsets); past
    the table every frame adds row 4999, where the offline forward's
    grown table gives new rows."""
    cj, ct = san_cfgs()
    jp = san_params(cj, seed=8)
    x, = feats(9, 4 * C, batch=2)
    for per_slot in (False, True):
        ref, _ = run_jax(tree_j(jp), cj, x, 4, per_slot=per_slot,
                         offset=MAX_LEN - 6)
        got, _ = run_port(to_torch(jp), ct, x, 4, per_slot=per_slot,
                          offset=MAX_LEN - 6)
        allclose(got, ref)
    z = torch.zeros(1, C, 16)
    rows = t_stream._add_positions(z, torch.tensor(MAX_LEN + 40,
                                                   dtype=torch.int32),
                                   2, 16)[0]
    last = t_dfsmn.position_table(16, MAX_LEN, torch.float32, "cpu")[-1]
    grown = t_dfsmn.position_table(16, MAX_LEN + 60, torch.float32, "cpu")
    assert torch.equal(rows, last.expand(C, -1))
    assert not torch.equal(grown[MAX_LEN + 38], last)


def test_position_table_keeps_replaced_tables():
    """A longer request replaces the kept table, and the table it replaces
    stays alive with its rows: a captured CUDA graph (an offline bucket, a
    stream's chunk program) reads the table it was captured with by
    address."""
    d = 26                                  # a width no other test builds
    first = t_dfsmn.position_table(d, MAX_LEN, torch.float32, "cpu")
    ptr = first.untyped_storage().data_ptr()
    grown = t_dfsmn.position_table(d, MAX_LEN + 100, torch.float32, "cpu")
    assert grown.untyped_storage().data_ptr() != ptr
    kept = [t for t in t_dfsmn._PE_SUPERSEDED
            if t.untyped_storage().data_ptr() == ptr]
    assert len(kept) == 1 and kept[0].shape[0] == MAX_LEN
    assert torch.equal(kept[0], grown[:MAX_LEN])


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

PIECES = (5, 13, 2, 9, 1, 17)


def pushed(sess, x):
    """x (1, T, IN) pushed in uneven pieces, then finish(): the stream's
    outputs (T', V) and the pieces' count."""
    outs, i, k = [], 0, 0
    while i < x.shape[1]:
        n = PIECES[k % len(PIECES)]
        outs += sess.push(x[:, i:i + n])
        i += n
        k += 1
    outs += sess.finish()
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([o[j] for o in outs], 1)[0]
                     for j in range(2))
    return np.concatenate(outs, 1)[0]


@pytest.mark.parametrize("moe", [False, True])
def test_session_matches_jax(moe):
    """Sessions with look-ahead over a 37-frame stream pushed in uneven
    pieces: delay (4 FIR frames; 5 for the MoE net), T matured frames
    out, each equal to the JAX session's; reset() replays the same
    stream; clone() starts fresh."""
    cj, ct = moe_cfgs() if moe else san_cfgs()
    jp = moe_params(cj) if moe else san_params(cj)
    x, = feats(10, 37)
    if moe:
        js = j_session.DfsmnMoeStreamingSession(tree_j(jp), cj, C,
                                                cache_T=CACHE_T)
        ts = t_session.DfsmnMoeStreamingSession(to_torch(jp), ct, C,
                                                cache_T=CACHE_T,
                                                moe_impl="runs_f")
    else:
        js = j_session.DfsmnStreamingSession(tree_j(jp), cj, C,
                                             cache_T=CACHE_T)
        ts = t_session.DfsmnStreamingSession(to_torch(jp), ct, C,
                                             cache_T=CACHE_T)
    assert ts.delay == js.delay == (5 if moe else 4)
    ref = pushed(js, x)
    got = pushed(ts, x)
    assert got.shape == ref.shape == (37, OUT)
    allclose(got, ref)
    ts.reset()
    np.testing.assert_array_equal(pushed(ts, x), got)
    np.testing.assert_array_equal(pushed(ts.clone(), x), got)


def test_session_finish_and_buffer_bookkeeping():
    """finish() of a stream shorter than one chunk still emits every
    frame; an empty session emits nothing; a long stream keeps less than
    a chunk buffered."""
    cj, ct = san_cfgs()
    tp = to_torch(san_params(cj))
    s = t_session.DfsmnStreamingSession(tp, ct, C, cache_T=CACHE_T)
    assert s.finish() == []
    x, = feats(11, 3)
    s.push(x)
    out = s.finish()
    assert sum(o.shape[1] for o in out) == 3
    s.reset()
    z = np.zeros((1, 3, IN), np.float32)
    for _ in range(40):
        s.push(z)
    assert s._buf.shape[1] < C and s._fed == 120


def test_topk_outputs_are_the_sparse_logits():
    """topk=3: per-frame log-softmax top-3 values and ids of the dense
    session's logits, best first."""
    cj, ct = moe_cfgs()
    tp = to_torch(moe_params(cj))
    x, = feats(12, 21)
    dense = pushed(t_session.DfsmnMoeStreamingSession(
        tp, ct, C, cache_T=CACHE_T, moe_impl="runs_f"), x)
    vals, ids = pushed(t_session.DfsmnMoeStreamingSession(
        tp, ct, C, cache_T=CACHE_T, moe_impl="runs_f", topk=3), x)
    lp = torch.log_softmax(torch.from_numpy(dense), -1)
    v, i = torch.topk(lp, 3, -1)
    np.testing.assert_allclose(vals, v.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ids, i.numpy())
    assert ids.dtype == np.int32


@pytest.mark.parametrize("moe", [False, True])
def test_causal_stream_equals_chunk_masked_offline(moe):
    """look_ahead=0 and a window covering the stream: the session's
    outputs equal the port's offline forward under the chunk-causal mask
    on the zero-padded utterance (the MoE net's embed sub-net too)."""
    cj, ct = moe_cfgs(0) if moe else san_cfgs(0)
    tp = to_torch(moe_params(cj, 13) if moe else san_params(cj, 13))
    T = 22
    Tp = -(-T // C) * C
    x, = feats(14, T)
    cls = (t_session.DfsmnMoeStreamingSession if moe
           else t_session.DfsmnStreamingSession)
    kw = dict(moe_impl="runs_f") if moe else {}
    got = pushed(cls(tp, ct, C, cache_T=Tp, **kw), x)
    xp = np.zeros((1, Tp, IN), np.float32)
    xp[:, :T] = x
    pos = np.arange(Tp)
    mask = torch.from_numpy(pos[None, :] < (pos[:, None] // C + 1) * C)
    if moe:
        full = t_dfsmn.dfsmn_san_moe_forward(tp, ct, torch.from_numpy(xp),
                                             None, moe_impl="runs_f",
                                             attn_mask=mask)[0]
    else:
        full = t_dfsmn.dfsmn_san_forward(tp, ct, torch.from_numpy(xp), None,
                                         attn_mask=mask)[0]
    allclose(got, full[0, :T].numpy())


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe", [False, True])
def test_batcher_matches_single_sessions(moe):
    """Three staggered streams of different lengths on a 4-slot
    DfsmnStreamBatcher through BatchedDfsmnStreamingSession: each equals
    an independent single session; an idle slot's state never moves; a
    closed slot comes back zeroed."""
    cj, ct = moe_cfgs() if moe else san_cfgs()
    tp = to_torch(moe_params(cj) if moe else san_params(cj))
    kw = dict(moe_impl="runs_f") if moe else {}
    b = DfsmnStreamBatcher(tp, ct, input_dim=IN, chunk_size=C, slots=4,
                           cache_T=CACHE_T, moe=moe, window_ms=0.0, **kw)
    try:
        xs = feats(15, 29, 17, 40)
        sess = [BatchedDfsmnStreamingSession(b) for _ in xs]
        outs = [[] for _ in xs]
        for k in range(12):              # stream i starts at step i
            for i, (s, x) in enumerate(zip(sess, xs)):
                lo, hi = (k - i) * 5, (k - i + 1) * 5
                if lo >= 0 and lo < x.shape[1]:
                    outs[i] += s.push(x[:, lo:hi])
        idle = [t for t in b._prog.inputs[2:]]
        free = sorted(set(range(4)) - {s.slot for s in sess})
        assert len(free) == 1 and all(
            not t[free[0]].any() for t in idle)
        cls = (t_session.DfsmnMoeStreamingSession if moe
               else t_session.DfsmnStreamingSession)
        for s, x, o in zip(sess, xs, outs):
            o += s.finish()
            got = np.concatenate(o, 1)[0]
            ref = pushed(cls(tp, ct, C, cache_T=CACHE_T, **kw), x)
            assert got.shape == (x.shape[1], OUT)
            allclose(got, ref)
        slot = sess[0].slot
        sess[0].reset()
        assert sess[0].slot is None and all(
            not t[slot].any() for t in b._prog.inputs[2:])
    finally:
        b.close()


def test_batcher_overload_falls_back_to_a_dedicated_session():
    """Every slot taken: the next session runs its own single-stream
    chunk program, with the same outputs; reset() frees the slot."""
    cj, ct = san_cfgs()
    tp = to_torch(san_params(cj))
    b = DfsmnStreamBatcher(tp, ct, input_dim=IN, chunk_size=C, slots=1,
                           cache_T=CACHE_T, window_ms=0.0)
    try:
        s1, s2 = BatchedDfsmnStreamingSession(b), \
            BatchedDfsmnStreamingSession(b)
        x, = feats(16, 19)
        a = pushed(s1, x)
        with pytest.raises(SlotsFull):
            b.open_slot()
        c = pushed(s2, x)
        assert s2._fallback is not None and s1.slot is not None
        allclose(a, c)
        s1.reset()
        assert s1.slot is None and len(b._free) == 1
        vals, ids = pushed(BatchedDfsmnStreamingSession(
            DfsmnStreamBatcher(tp, ct, input_dim=IN, chunk_size=C, slots=1,
                               cache_T=CACHE_T, topk=2)), x)
        assert vals.shape == ids.shape == (19, 2)
    finally:
        b.close()


def test_batcher_refuses_malformed_chunks():
    cj, ct = san_cfgs()
    b = DfsmnStreamBatcher(to_torch(san_params(cj)), ct, input_dim=IN,
                           chunk_size=C, slots=2, cache_T=CACHE_T)
    try:
        slot = b.open_slot()
        with pytest.raises(ValueError, match="window must be"):
            b.push(slot, np.zeros((1, C + 1, IN), np.float32))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the port's server
# ---------------------------------------------------------------------------

def _server_state(engine, **kw):
    import m3asr_tpu_torch.serve as serve
    args = serve.parser().parse_args(["-p", "unused", "--stream_slots", "2",
                                      "--stream_topk", "0"])
    for k, v in kw.items():
        setattr(args, k, v)
    return serve, serve._build_runtime(args, engine=engine)


def test_server_streams_dfsmn_engines():
    """A MoE-DFSMN engine (fp32) served in process: its stream pool runs
    one DfsmnStreamBatcher per chunk size, and a stream's greedy partials
    equal the ones decoded from a direct session's logits; dfsmn_base_res
    gets no streams and says why."""
    from m3asr_tpu_torch.config import model_config_from_dict as t_config
    from m3asr_tpu_torch.models.registry import dfsmn_stream_config
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    from test_torch_dfsmn import proto_yaml
    raw = proto_yaml("dfsmn_san_fmoe_localComm_catEmbed")
    mc = t_config(raw)
    cfg = dfsmn_stream_config(mc)
    g = torch.Generator().manual_seed(3)
    from m3asr_tpu_torch.models.registry import get_family
    params = get_family(mc.nnet_proto).init(mc, g)
    for node in params["blocks_sw"][0]["fsmn_layers"][1:]:
        node["router"]["kernel"].normal_(generator=g)
    eng = Engine(mc, params, EngineConfig(bucket_lengths=(32,),
                                          bucket_batches=(1,)), device="cpu")
    serve, state = _server_state(eng)
    try:
        pool = state["stream_pool"]
        sess = pool.acquire((C, 2))
        assert isinstance(sess, BatchedDfsmnStreamingSession)
        assert list(state["stream_batchers"]) == [C]
        assert sess.batcher.moe_impl == "runs_f"
        x, = feats(17, 26)
        dec = serve._StreamDecode(sess)
        i = 0
        for n in (7, 11, 8):
            dec.update(sess.push(x[:, i:i + n]))
            i += n
        dec.update(sess.finish())
        direct = pushed(t_session.DfsmnMoeStreamingSession(
            eng.params, cfg, C, moe_impl="runs_f"), x)
        ref = serve._StreamDecode(None)
        ref.update([direct[None]])
        assert dec.frames == 26 and dec.result() == ref.result()
        pool.release((C, 2), sess)
        assert sess.slot is None
    finally:
        state["batcher"].close()
        for b in state["stream_batchers"].values():
            b.close()
    base = t_config(proto_yaml("dfsmn_base_res"))
    eng = Engine(base, get_family("dfsmn_base_res").init(base, g),
                 EngineConfig(bucket_lengths=(32,), bucket_batches=(1,)),
                 device="cpu")
    _, state = _server_state(eng)
    state["batcher"].close()
    assert state["stream_pool"] is None
    assert "stream forward" in state["stream_error"]
