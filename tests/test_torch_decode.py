"""CTC decoding in the PyTorch port against the JAX package, on the CPU:
the batched prefix beam search in device tensors
(``decode/device.py``) against ``m3asr_tpu.decode.device``; the host
functions for the engine's on-device outputs (``decode/ctc.py``: the
sparse prefix beam search, greedy search from ids, emission times,
confidences) against ``m3asr_tpu.decode.ctc``; the extended searches
(``ContextTrie``, ``PrefixBeamState``, ``ctc_prefix_beam_search[_sparse]
_ext``) with and without hotwords and the n-gram LM
(``decode/lm.py``), and the native C++ library the port builds for
itself (``decode/native.py``) against the JAX package's.

Log-probs are log-softmaxed from seeded numpy draws. Tokens, lengths,
emission times and hypotheses must be equal, n-best lists entry for
entry; scores within 1e-5 (float32 sums in another order; the native
library's float32 scores within 1e-4, the JAX binding's own test's
tolerance)."""

import numpy as np
import pytest
import torch

from m3asr_tpu.decode import ctc as j_ctc
from m3asr_tpu.decode import device as j_device
from m3asr_tpu.decode import lm as j_lm
from m3asr_tpu.decode import native as j_native

from m3asr_tpu_torch.decode import ctc as t_ctc
from m3asr_tpu_torch.decode import device as t_device
from m3asr_tpu_torch.decode import lm as t_lm
from m3asr_tpu_torch.decode import native as t_native
from m3asr_tpu_torch.utils import native_build

LENS = (40, 17, 1)          # mixed lengths of the (B=3, T=40) batch


def log_probs(seed, B=3, T=40, V=12, scale=2.0):
    x = np.random.default_rng(seed).standard_normal((B, T, V)) \
        .astype(np.float32) * scale
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def candidates(lp, K, seed):
    """Per-frame top-K (values, indices) in a shuffled order."""
    idx = np.argsort(-lp, axis=-1, kind="stable")[..., :K]
    perm = np.random.default_rng(seed).permuted(
        np.broadcast_to(np.arange(K), idx.shape).copy(), axis=-1)
    idx = np.take_along_axis(idx, perm, -1).astype(np.int32)
    return np.take_along_axis(lp, idx, -1), idx


def assert_search_equal(ref, got):
    """Lengths equal; tokens equal within each hypothesis's length and
    -1 beyond it on live beams; scores within 1e-5, -inf on the same
    (dead) beams."""
    rt, rl, rs = (np.asarray(a) for a in ref)
    gt, gl, gs = (a.numpy() for a in got)
    assert (gt.dtype, gl.dtype, gs.dtype) == (np.int32, np.int32,
                                              np.float32)
    assert gt.shape == rt.shape
    np.testing.assert_array_equal(gl, rl)
    within = np.arange(rt.shape[-1]) < rl[..., None]
    np.testing.assert_array_equal(np.where(within, gt, 0),
                                  np.where(within, rt, 0))
    live = np.isfinite(rs)
    np.testing.assert_array_equal(np.isfinite(gs), live)
    np.testing.assert_array_equal(np.where(within, -1, gt)[live], -1)
    np.testing.assert_allclose(gs[live], rs[live], rtol=0, atol=1e-5)


@pytest.mark.parametrize("beam", [1, 4, 8])
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_device_beam_search_matches_jax(form, beam):
    lp = log_probs(beam)
    lens = np.array(LENS, np.int32)
    if form == "dense":
        ref = j_device.ctc_beam_search_device(lp, lens, beam)
        got = t_device.ctc_beam_search_device(
            torch.from_numpy(lp), torch.from_numpy(lens), beam)
    else:
        vals, idx = candidates(lp, min(beam + 2, 12), beam)
        ref = j_device.ctc_beam_search_sparse_device(vals, idx, lens, beam)
        got = t_device.ctc_beam_search_sparse_device(
            torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(lens), beam)
    assert_search_equal(ref, got)


@pytest.mark.parametrize("beam", [1, 4, 8])
def test_device_beam_best_equals_host_search(beam):
    """The best hypothesis of the device search equals the port's host
    prefix beam search of the same width, score within 1e-4."""
    lp = log_probs(20 + beam, V=20, scale=1.5)
    lens = np.array(LENS, np.int32)
    toks, hl, sc = (a.numpy() for a in t_device.ctc_beam_search_device(
        torch.from_numpy(lp), torch.from_numpy(lens), beam))
    for b in range(3):
        host = t_ctc.ctc_prefix_beam_search(lp[b], LENS[b], beam)
        assert tuple(toks[b, 0, :hl[b, 0]]) == host[0][0]
        assert abs(sc[b, 0] - host[0][1]) < 1e-4


def test_hash_products_wrap_as_uint32():
    """The int64 rolling-hash product equals uint32 arithmetic."""
    h = np.random.default_rng(30).integers(0, 2**32, 10000, dtype=np.uint64)
    for m in (t_device._M1, t_device._M2, 2654435761):
        want = (h * np.uint64(m)) & np.uint64(0xFFFFFFFF)
        got = t_device._mul32(torch.from_numpy(h.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_prefix_beam_matches_jax_and_dense(seed):
    """The sparse host search over top-K candidates: the JAX package's
    n-best, and the dense search's when K >= beam."""
    lp = log_probs(40 + seed, B=1, T=30, V=15)[0]
    vals, idx = candidates(lp[None], 6, seed)
    order = np.argsort(-vals[0], axis=-1, kind="stable")
    vals = np.take_along_axis(vals[0], order, -1)       # best first
    idx = np.take_along_axis(idx[0], order, -1)
    for beam in (3, 6):
        got = t_ctc.ctc_prefix_beam_search_sparse(vals, idx, 30, beam)
        ref = j_ctc.ctc_prefix_beam_search_sparse(vals, idx, 30, beam)
        assert [h for h, _ in got] == [h for h, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                                   rtol=1e-6)
        dense = t_ctc.ctc_prefix_beam_search(lp, 30, beam)
        assert [h for h, _ in got] == [h for h, _ in dense]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_from_ids_and_times_match_jax(seed):
    lp = log_probs(50 + seed, V=6, scale=1.0)   # few tokens: long runs
    lens = np.array(LENS, np.int32)
    ids, best = lp.argmax(-1).astype(np.int32), lp.max(-1)
    assert t_ctc.ctc_greedy_from_ids(ids, lens) == \
        j_ctc.ctc_greedy_from_ids(ids, lens) == \
        t_ctc.ctc_greedy_search(lp, lens)
    got = t_ctc.ctc_greedy_times_from_ids(ids, best, lens)
    ref = j_ctc.ctc_greedy_times_from_ids(ids, best, lens)
    dense = t_ctc.ctc_greedy_search_times(lp, lens)
    assert [(h.tokens, h.times) for h in got] == \
        [(h.tokens, h.times) for h in ref] == \
        [(h.tokens, h.times) for h in dense]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in ref], rtol=1e-6)
    dref = j_ctc.ctc_greedy_search_times(lp, lens)
    assert [tuple(h) for h in dense] == [tuple(h) for h in dref]


@pytest.mark.parametrize("seed", [0, 1])
def test_token_confidence_dense_and_sparse_match_jax(seed):
    lp = log_probs(60 + seed, B=1, V=10)[0]
    hyp = t_ctc.ctc_greedy_search_times(lp[None], np.array([40]))[0]
    got = t_ctc.token_confidence(lp, hyp.tokens, hyp.times)
    assert got == j_ctc.token_confidence(lp, hyp.tokens, hyp.times)
    vals, idx = candidates(lp[None], 4, seed)
    toks = list(hyp.tokens) + [int(idx[0, 0, 0])]
    times = list(hyp.times) + [0]
    # a token outside its frame's candidates gets 0
    toks[0] = next(v for v in range(10) if v not in idx[0, hyp.times[0]])
    sparse = t_ctc.token_confidence_sparse(vals[0], idx[0], toks, times)
    assert sparse == j_ctc.token_confidence_sparse(vals[0], idx[0], toks,
                                                   times)
    assert sparse[0] == 0.0
    np.testing.assert_allclose(sparse[1:-1], got[1:], rtol=1e-6)


PHRASES = [[1, 2], [3, 4, 5], [1, 6, 2], [7]]

# a bigram ARPA over unit ids 1..7, with <unk> and a symbol-table twin
ARPA = """\\data\\
ngram 1=10
ngram 2=6

\\1-grams:
-0.9 <s> -0.2
-1.1 1 -0.3
-1.2 2 -0.25
-1.0 3 -0.1
-1.3 4
-0.8 5 -0.4
-1.6 6
-1.4 7 -0.2
-2.0 <unk>
-0.7 </s>

\\2-grams:
-0.3 <s> 1
-0.2 1 2
-0.5 3 4
-0.4 2 </s>
-0.6 5 5
-0.1 7 1

\\end\\
"""


@pytest.fixture
def lms(tmp_path):
    """(JAX NgramLM, port NgramLM) of ARPA."""
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    return j_lm.NgramLM(str(path)), t_lm.NgramLM(str(path))


def test_context_trie_matches_jax():
    j, t = j_ctc.ContextTrie(PHRASES, 2.5), t_ctc.ContextTrie(PHRASES, 2.5)
    assert (t.children, t.depth, t.is_end, t.refund) == \
        (j.children, j.depth, j.is_end, j.refund)
    rng = np.random.default_rng(3)
    sj = st = 0
    for tok in rng.integers(0, 9, 200):
        (sj, dj), (st, dt) = j.advance(sj, int(tok)), t.advance(st, int(tok))
        assert (st, dt) == (sj, dj)
        assert t.finalize(st) == j.finalize(sj)


def test_ngram_lm_matches_jax(lms, tmp_path):
    j, t = lms
    assert (t.order, t.logp, t.backoff) == (j.order, j.logp, j.backoff)
    rng = np.random.default_rng(4)
    sj, st = j.start(), t.start()
    assert sj == st
    for tok in rng.integers(1, 10, 100):
        (sj, lj), (st, lt) = j.score(sj, int(tok)), t.score(st, int(tok))
        assert (st, lt) == (sj, lj)
        assert t.score_eos(st) == j.score_eos(sj)
    for a, b in zip(t.to_arrays(), j.to_arrays()):
        np.testing.assert_array_equal(a, b)
    # ARPA words through a symbol table
    sym = tmp_path / "units.txt"
    sym.write_text("a 1\nb 2\n")
    table = t_lm.read_symbol_table(str(sym))
    assert table == j_lm.read_symbol_table(str(sym)) == {"a": 1, "b": 2}
    words = tmp_path / "words.arpa"
    words.write_text(ARPA.replace(" 1 ", " a ").replace(" 2\n", " b\n"))
    assert t_lm.NgramLM(str(words), table).logp == \
        j_lm.NgramLM(str(words), table).logp


def assert_hyps_equal(got, ref, atol=1e-5):
    """Two n-best lists: the same hypotheses, emission times and order;
    scores within atol."""
    assert [(h.tokens, h.times) for h in got] == \
        [(h.tokens, h.times) for h in ref]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in ref], rtol=0, atol=atol)


@pytest.mark.parametrize("lm_on", [False, True])
@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_ext_searches_and_beam_state_match_jax(form, ctx, lm_on, lms):
    """ctc_prefix_beam_search[_sparse]_ext and PrefixBeamState advanced
    in uneven chunks, with and without hotwords and the LM: the JAX
    package's n-best lists, entry for entry."""
    jlm, tlm = lms if lm_on else (None, None)
    tctx = t_ctc.ContextTrie(PHRASES, 2.0) if ctx else None
    jctx = j_ctc.ContextTrie(PHRASES, 2.0) if ctx else None
    lp = log_probs(70 + 2 * ctx + lm_on, B=1, T=36, V=9, scale=1.5)[0]
    beam = 4
    if form == "dense":
        got = t_ctc.ctc_prefix_beam_search_ext(lp, 36, beam, 0, tctx, tlm,
                                               0.7)
        ref = j_ctc.ctc_prefix_beam_search_ext(lp, 36, beam, 0, jctx, jlm,
                                               0.7)
    else:
        idx = np.argsort(-lp, axis=-1, kind="stable")[:, :6].astype(np.int32)
        vals = np.take_along_axis(lp, idx, -1)
        got = t_ctc.ctc_prefix_beam_search_sparse_ext(vals, idx, 36, beam, 0,
                                                      tctx, tlm, 0.7)
        ref = j_ctc.ctc_prefix_beam_search_sparse_ext(vals, idx, 36, beam, 0,
                                                      jctx, jlm, 0.7)
    assert_hyps_equal(got, ref)
    state = t_ctc.PrefixBeamState(beam, 0, tctx, tlm, 0.7)
    jstate = j_ctc.PrefixBeamState(beam, 0, jctx, jlm, 0.7)
    for a, b in ((0, 5), (5, 6), (6, 20), (20, 36)):
        if form == "dense":
            state.advance(lp[a:b])
            jstate.advance(lp[a:b])
        else:
            state.advance_sparse(vals[a:b], idx[a:b])
            jstate.advance_sparse(vals[a:b], idx[a:b])
        assert_hyps_equal(state.nbest(), jstate.nbest())
    assert_hyps_equal(state.nbest(), got)


def test_native_library_builds_into_the_port():
    """The port's own library, built from native/ctc_decoder by g++ into
    m3asr_tpu_torch/_build/ under a name keyed by source and flags."""
    assert t_native.available(), t_native.load_error()
    path = native_build.lib_path(t_native.SOURCE)
    assert path.startswith(native_build.BUILD_DIR)
    assert native_build.ensure_built(t_native.SOURCE) == path


@pytest.mark.parametrize("lm_on", [False, True])
def test_native_searches_match_jax(lm_on, lms):
    """The port's native greedy, prefix beam, extended beam (dense and
    sparse, hotwords, LM) and incremental beam state against the JAX
    package's native binding."""
    assert t_native.available() and j_native.available()
    jlm, tlm = lms if lm_on else (None, None)
    tctx, jctx = (t_ctc.ContextTrie(PHRASES, 2.0),
                  j_ctc.ContextTrie(PHRASES, 2.0))
    lp = log_probs(80 + lm_on, B=2, T=30, V=9, scale=1.5)
    lens = np.array([30, 21], np.int32)
    assert t_native.ctc_greedy_search(lp, lens) == \
        j_native.ctc_greedy_search(lp, lens)
    got = t_native.ctc_prefix_beam_search(lp[0], 30, 4)
    ref = j_native.ctc_prefix_beam_search(lp[0], 30, 4)
    assert [h for h, _ in got] == [h for h, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               rtol=0, atol=1e-6)
    assert_hyps_equal(
        t_native.ctc_prefix_beam_search_ext(lp[0], 30, 4, context=tctx,
                                            lm=tlm),
        j_ctc.ctc_prefix_beam_search_ext(lp[0], 30, 4, context=jctx, lm=jlm),
        atol=1e-4)
    idx = np.argsort(-lp[1], axis=-1, kind="stable")[:, :5].astype(np.int32)
    vals = np.take_along_axis(lp[1], idx, -1)
    assert_hyps_equal(
        t_native.ctc_prefix_beam_search_sparse_ext(vals, idx, 21, 4,
                                                   context=tctx, lm=tlm),
        j_native.ctc_prefix_beam_search_sparse_ext(vals, idx, 21, 4,
                                                   context=jctx, lm=jlm))
    state = t_native.make_beam_state(4, context=tctx, lm=tlm)
    assert isinstance(state, t_native.NativeBeamState)
    jstate = j_native.make_beam_state(4, context=jctx, lm=jlm)
    for a, b in ((0, 7), (7, 30)):
        state.advance(lp[0, a:b])
        jstate.advance(lp[0, a:b])
    assert_hyps_equal(state.nbest(), jstate.nbest())
    state.reset()
    state.advance_sparse(vals[:21], idx[:21])
    assert_hyps_equal(state.nbest(), j_ctc.ctc_prefix_beam_search_sparse_ext(
        vals, idx, 21, 4, context=jctx, lm=jlm), atol=1e-4)
