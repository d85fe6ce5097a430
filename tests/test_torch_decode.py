"""CTC decoding in the PyTorch port against the JAX package, on the CPU:
the batched prefix beam search in device tensors
(``decode/device.py``) against ``m3asr_tpu.decode.device``, and the host
functions for the engine's on-device outputs (``decode/ctc.py``: the
sparse prefix beam search, greedy search from ids, emission times,
confidences) against ``m3asr_tpu.decode.ctc``.

Log-probs are log-softmaxed from seeded numpy draws. Tokens, lengths and
hypotheses must be equal; scores within 1e-5 (float32 sums in another
order)."""

import numpy as np
import pytest
import torch

from m3asr_tpu.decode import ctc as j_ctc
from m3asr_tpu.decode import device as j_device

from m3asr_tpu_torch.decode import ctc as t_ctc
from m3asr_tpu_torch.decode import device as t_device

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
