"""The AED decoders of the PyTorch port against the JAX package's
``m3asr_tpu.models.aed``, on the CPU in float32.

A golden ``TransformerDecoder`` (tests/golden, 2 blocks, d=32, 4 heads,
V=13) is converted by both packages' ``convert_decoder``; the port's tree
must equal the JAX tree bit for bit, and every checkpoint key must be
consumed. On the same memories and tokens (numpy, from a seed) the
port's teacher-forced logits, incremental steps, hypothesis scores,
rescorings and beam searches are held to the JAX package's at the
reference standard allclose(rtol 1e-5, atol 1e-3); hypotheses must be
equal, also where candidates tie exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import torch_ref as G

from m3asr_tpu import checkpoint as j_ckpt
from m3asr_tpu.config import (DecoderConfig as JDecoderConfig,
                              EncoderConfig as JEncoderConfig,
                              ModelConfig as JModelConfig)
from m3asr_tpu.models import aed as j_aed
from m3asr_tpu.ops import attention as j_attention
from m3asr_tpu.ops import masking as j_masking
from m3asr_tpu.ops import positional as j_positional

from m3asr_tpu_torch import checkpoint as t_ckpt
from m3asr_tpu_torch.config import DecoderConfig, ModelConfig
from m3asr_tpu_torch.models import aed
from m3asr_tpu_torch.ops import attention as t_attention
from m3asr_tpu_torch.ops import masking as t_masking
from m3asr_tpu_torch.ops import positional as t_positional

from test_op_parity import allclose

V, D, SOS = 13, 32, 12


def _golden(seed):
    torch.manual_seed(seed)
    return G.randomize_(G.TransformerDecoder(V, D, attention_heads=4,
                                             linear_units=48, num_blocks=2),
                        seed=seed + 1)


def _configs(r_num_blocks=0):
    jc = JModelConfig()
    jc.encoder_conf = JEncoderConfig(attention_dim=D)
    jc.decoder_conf = JDecoderConfig(attention_heads=4, linear_units=48,
                                     num_blocks=2, r_num_blocks=r_num_blocks)
    tc = ModelConfig()
    tc.encoder_conf.attention_dim = D
    tc.decoder_conf = DecoderConfig(attention_heads=4, linear_units=48,
                                    num_blocks=2, r_num_blocks=r_num_blocks)
    return jc, tc


def _state_dict(kind, name="decoder"):
    if kind == "transformer":
        return {f"{name}.{k}": v.numpy()
                for k, v in _golden(50).state_dict().items()}
    sd = {}
    for side, seed in (("left_decoder", 60), ("right_decoder", 70)):
        sd.update({f"{name}.{side}.{k}": v.numpy()
                   for k, v in _golden(seed).state_dict().items()})
    return sd


def _params(kind="transformer", name="decoder"):
    """(JAX tree, port tree, port DecoderConfig) of one converted
    golden decoder."""
    jc, tc = _configs(r_num_blocks=2 if kind == "bi" else 0)
    sd = _state_dict(kind, name)
    jp = j_ckpt.convert_decoder(sd, jc, name)
    tp = t_ckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, tp, jc.decoder_conf, tc.decoder_conf


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("kind", ["transformer", "bi"])
def test_convert_decoder_equals_jax_and_consumes_every_key(kind):
    jc, tc = _configs(r_num_blocks=2 if kind == "bi" else 0)
    sd = _state_dict(kind)
    ref = dict(_leaves(jax.tree.map(np.asarray,
                                    j_ckpt.convert_decoder(sd, jc))))
    tracked = t_ckpt.TrackedDict(sd)
    got = dict(_leaves(t_ckpt.params_to_numpy(
        t_ckpt.convert_decoder(tracked, tc))))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert t_ckpt.check_consumed(tracked, strict=True, log=lambda *a: None) \
        == []


def test_init_has_the_jax_tree_paths_and_shapes():
    _, tc = _configs()
    jtree = j_aed.init(jax.random.PRNGKey(0), _configs()[0].decoder_conf, V,
                       D)
    ref = {k: v.shape for k, v in _leaves(jax.tree.map(np.asarray, jtree))}
    g = torch.Generator().manual_seed(0)
    got = {k: v.shape for k, v in _leaves(t_ckpt.params_to_numpy(
        aed.init(tc.decoder_conf, V, D, g)))}
    assert got == ref


def _memory(seed, B=2, T=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, D)).astype(np.float32)


def test_masks_and_positional_equal_jax():
    lens = np.array([3, 0, 5], np.int32)
    np.testing.assert_array_equal(
        t_masking.make_pad_mask(torch.from_numpy(lens), 6).numpy(),
        np.asarray(j_masking.make_pad_mask(jnp.asarray(lens), 6)))
    np.testing.assert_array_equal(t_masking.subsequent_mask(5).numpy(),
                                  np.asarray(j_masking.subsequent_mask(5)))
    score = np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]], np.float32)
    flag = np.array([[True], [False]])
    pred = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    np.testing.assert_array_equal(
        t_masking.mask_finished_scores(torch.from_numpy(score),
                                       torch.from_numpy(flag)).numpy(),
        np.asarray(j_masking.mask_finished_scores(jnp.asarray(score),
                                                  jnp.asarray(flag))))
    np.testing.assert_array_equal(
        t_masking.mask_finished_preds(torch.from_numpy(pred),
                                      torch.from_numpy(flag), 9).numpy(),
        np.asarray(j_masking.mask_finished_preds(jnp.asarray(pred),
                                                 jnp.asarray(flag), 9)))
    x = _memory(1)
    pe = np.array(j_positional.sinusoid_table(D))
    ref, ref_pe = j_positional.abs_positional_encoding(jnp.asarray(pe),
                                                       jnp.asarray(x), 3)
    got, got_pe = t_positional.abs_positional_encoding(torch.from_numpy(pe),
                                                       torch.from_numpy(x), 3)
    allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_pe.numpy(), np.asarray(ref_pe))


@pytest.mark.parametrize("masked", [False, True])
def test_mha_cross_attention_equals_jax(masked):
    """Query from one tensor, key/value from another (the decoder's
    source attention), with key lengths and optionally a causal mask."""
    jp, tp, _, _ = _params()
    jl = jax.tree.map(lambda a: a[0], jp["decoders"]["src_attn"])
    tl = {k: {n: v[0] for n, v in d.items()}
          for k, d in tp["decoders"]["src_attn"].items()}
    q, kv = _memory(2, T=9), _memory(3, T=9)
    lens = np.array([9, 4], np.int32)
    jmask = j_masking.subsequent_mask(9)[None, None] if masked else None
    tmask = t_masking.subsequent_mask(9)[None, None] if masked else None
    ref = j_attention.mha(jl, jnp.asarray(q), jnp.asarray(kv),
                          jnp.asarray(kv), jnp.asarray(lens), 4, mask=jmask)
    kvt = torch.from_numpy(kv)
    got = t_attention.mha(tl, torch.from_numpy(q), kvt, kvt,
                          torch.from_numpy(lens), 4, mask=tmask)
    allclose(got.numpy(), np.asarray(ref))


def test_forward_equals_jax_and_golden():
    jp, tp, jdc, tdc = _params()
    mem = _memory(4)
    mlens = np.array([9, 6], np.int32)
    ys_in = np.array([[SOS, 3, 5, 7, 0], [SOS, 2, 4, 0, 0]], np.int32)
    ys_lens = np.array([5, 3], np.int32)
    ref = np.asarray(j_aed.forward(jp, jdc, jnp.asarray(mem),
                                   jnp.asarray(mlens), jnp.asarray(ys_in),
                                   jnp.asarray(ys_lens)))
    got = aed.forward(tp, tdc, torch.from_numpy(mem), mlens,
                      torch.from_numpy(ys_in), torch.from_numpy(ys_lens))
    with torch.no_grad():
        gold = _golden(50)(torch.from_numpy(mem), torch.from_numpy(mlens),
                           torch.from_numpy(ys_in).long(),
                           torch.from_numpy(ys_lens)).numpy()
    for b, n in enumerate(ys_lens):
        allclose(got.detach().numpy()[b, :n], ref[b, :n])
        allclose(got.detach().numpy()[b, :n], gold[b, :n])


@pytest.mark.parametrize("precomputed", [False, True])
def test_forward_one_step_matches_teacher_forcing_and_jax(precomputed):
    """Each cached step's log-probs equal the teacher-forced forward's at
    that position, and the JAX package's step; with the memory's
    key/value heads projected once (memory_kv) too."""
    jp, tp, jdc, tdc = _params()
    B, U = 2, 5
    mem = _memory(5)
    mlens = np.array([9, 6], np.int32)
    ys_in = np.array([[SOS, 3, 5, 7, 2], [SOS, 2, 4, 1, 6]], np.int32)
    logits = aed.forward(tp, tdc, torch.from_numpy(mem), mlens,
                         torch.from_numpy(ys_in), torch.full((B,), U))
    teacher = torch.log_softmax(logits, -1).detach().numpy()
    cache = aed.init_cache(tdc, B, U, D)
    jcache = j_aed.init_cache(jdc, B, U, D)
    mem_t, ml_t = torch.from_numpy(mem), torch.from_numpy(mlens).long()
    mem_kv = aed.memory_kv(tp, tdc, mem_t) if precomputed else None
    for t in range(U):
        y, cache = aed.forward_one_step(tp, tdc, mem_t, ml_t,
                                        torch.from_numpy(ys_in[:, t]).long(),
                                        t, cache, mem_kv)
        jy, jcache = j_aed.forward_one_step(
            jp, jdc, jnp.asarray(mem), jnp.asarray(mlens),
            jnp.asarray(ys_in[:, t]), jnp.int32(t), jcache)
        allclose(y.detach().numpy(), teacher[:, t])
        allclose(y.detach().numpy(), np.asarray(jy))
    allclose(cache.numpy(), np.asarray(jcache))


def _nbest():
    return [((3, 5), -1.0), ((4, 6, 2), -1.2), ((3,), -1.5),
            ((7, 7, 1, 2), -2.0)]


@pytest.mark.parametrize("reverse", [False, True])
def test_score_hyps_equals_jax(reverse):
    jp, tp, jdc, tdc = _params()
    mem = _memory(6, B=1)
    hyps = [list(h) for h, _ in _nbest()]
    ref = j_aed.score_hyps(jp, jdc, jnp.asarray(mem), jnp.asarray([7]),
                           hyps, SOS, SOS, 0, reverse=reverse)
    got = aed.score_hyps(tp, tdc, mem, [7], hyps, SOS, SOS, 0,
                         reverse=reverse)
    assert got.dtype == np.float64
    allclose(got, ref)


@pytest.mark.parametrize("kind,reverse_weight", [
    ("transformer", 0.0), ("bi", 0.0), ("bi", 0.3)])
def test_attention_rescoring_equals_jax(kind, reverse_weight):
    jp, tp, jdc, tdc = _params(kind)
    mem = _memory(7, B=1)
    for ctc_weight in (0.5, 1e6):
        ref = j_aed.attention_rescoring(
            jp, jdc, _nbest(), jnp.asarray(mem), 8, SOS, SOS, 0,
            ctc_weight=ctc_weight, reverse_weight=reverse_weight)
        got = aed.attention_rescoring(
            tp, tdc, _nbest(), torch.from_numpy(mem), 8, SOS, SOS, 0,
            ctc_weight=ctc_weight, reverse_weight=reverse_weight)
        assert got[0] == ref[0]
        allclose(got[1], ref[1])


def test_hier_attention_rescoring_equals_jax():
    """Three decoders, each on its own tap (h6, h12, h_final), scores
    averaged."""
    jd, td = {}, {}
    for i, name in enumerate(("decoder", "decoder_1", "decoder_2")):
        jd[name], td[name], jdc, tdc = _params(name=name)
    taps = [_memory(10 + i, B=1) for i in range(3)]
    for ctc_weight in (0.0, 0.5):
        ref = j_aed.hier_attention_rescoring(
            jd, jdc, _nbest(), tuple(jnp.asarray(t) for t in taps), 9,
            SOS, SOS, 0, ctc_weight=ctc_weight)
        got = aed.hier_attention_rescoring(
            td, tdc, _nbest(), tuple(torch.from_numpy(t) for t in taps), 9,
            SOS, SOS, 0, ctc_weight=ctc_weight)
        assert got[0] == ref[0]
        allclose(got[1], ref[1])


def test_topk_stable_breaks_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, 0.5],
                  [-np.inf, -np.inf, 2.0, -np.inf, 2.0, -np.inf]],
                 np.float32)
    for k in (1, 3, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = aed.topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def _search(jp, tp, jdc, tdc, mem, mlens, beam, max_len):
    ref_h, ref_s = j_aed.attention_beam_search(
        jp, jdc, jnp.asarray(mem), jnp.asarray(mlens), beam, max_len, SOS,
        SOS)
    got_h, got_s = aed.attention_beam_search(
        tp, tdc, torch.from_numpy(mem), mlens, beam, max_len, SOS, SOS)
    return (got_h.numpy(), got_s.numpy()), (np.asarray(ref_h),
                                            np.asarray(ref_s))


def test_attention_beam_search_equals_jax():
    jp, tp, jdc, tdc = _params()
    mem = _memory(8, B=2, T=7)
    (gh, gs), (rh, rs) = _search(jp, tp, jdc, tdc, mem,
                                 np.array([7, 5], np.int32), 3, 6)
    np.testing.assert_array_equal(gh, rh)
    allclose(gs, rs)


def test_attention_beam_search_planted_ties_equal_jax():
    """Output columns duplicated (tokens 2 = 5 = 9, 3 = 8) give exactly
    tied log-probs at every step, and a finished beam's -inf candidates
    tie too: both searches must keep the lower index."""
    jp, tp, jdc, tdc = _params()
    jp = jax.tree.map(np.array, jp)              # writable copies
    out = jp["output_layer"]
    for src, dst in ((2, 5), (2, 9), (3, 8)):
        out["kernel"][:, dst] = out["kernel"][:, src]
        out["bias"][dst] = out["bias"][src]
    # eos (= sos) leads token 3 by 0.5, so beams finish early
    out["kernel"][:, SOS] = out["kernel"][:, 3]
    out["bias"][SOS] = out["bias"][3] + 0.5
    tp = t_ckpt.params_from_jax(jp)
    jp = jax.tree.map(jnp.asarray, jp)
    mem = _memory(9, B=2, T=6)
    mlens = np.array([6, 4], np.int32)
    logp, _ = aed.forward_one_step(
        tp, tdc, torch.from_numpy(mem), torch.from_numpy(mlens).long(),
        torch.full((2,), SOS), 0, aed.init_cache(tdc, 2, 1, D))
    assert bool((logp[:, 2] == logp[:, 5]).all())
    for beam in (2, 4):
        (gh, gs), (rh, rs) = _search(jp, tp, jdc, tdc, mem, mlens, beam, 6)
        np.testing.assert_array_equal(gh, rh)
        allclose(gs, rs)
        assert (gh == SOS).any()


def test_attention_search_decode_equals_jax():
    jp, tp, jdc, tdc = _params()
    mem = _memory(11, B=3, T=8)
    mlens = np.array([8, 5, 3], np.int32)
    ref = j_aed.attention_search_decode(jp, jdc, mem, mlens, beam_size=3,
                                        sos=SOS, eos=SOS)
    stats = {}
    got = aed.attention_search_decode(tp, tdc, mem, mlens, beam_size=3,
                                      sos=SOS, eos=SOS, stats=stats)
    assert got == ref
    assert 1 <= stats["steps"] <= 8
