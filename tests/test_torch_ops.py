"""Leaf ops of the PyTorch port against their JAX counterparts.

Inputs are made with numpy from a seed and handed to both sides; the
port runs on the CPU. Tolerance: float32, rtol 1e-5 / atol 1e-5 (both
sides compute in float32; only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3asr_tpu.ops import attention as j_attn
from m3asr_tpu.ops import common as j_common
from m3asr_tpu.ops import conv as j_conv
from m3asr_tpu.ops import masking as j_mask
from m3asr_tpu.ops import positional as j_pos
from m3asr_tpu.ops import subsampling as j_sub

from m3asr_tpu_torch.checkpoint import params_from_jax
from m3asr_tpu_torch.ops import attention as t_attn
from m3asr_tpu_torch.ops import common as t_common
from m3asr_tpu_torch.ops import conv as t_conv
from m3asr_tpu_torch.ops import masking as t_mask
from m3asr_tpu_torch.ops import positional as t_pos
from m3asr_tpu_torch.ops import subsampling as t_sub

RTOL, ATOL = 1e-5, 1e-5


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(tree):
    """(JAX tree, port tree) from one numpy tree."""
    return (jax.tree.map(jnp.asarray, tree), params_from_jax(tree))


def test_linear_layer_norm_scale_shift_swish():
    rng = np.random.default_rng(0)
    x = rnd(rng, 2, 7, 16)
    lin = {"kernel": rnd(rng, 16, 24, scale=0.3), "bias": rnd(rng, 24)}
    ln = {"scale": rnd(rng, 16), "bias": rnd(rng, 16)}
    for p, jf, tf in ((lin, j_common.linear, t_common.linear),
                      (ln, j_common.layer_norm, t_common.layer_norm),
                      (ln, j_common.scale_shift, t_common.scale_shift)):
        jp, tp = both(p)
        close(tf(tp, torch.from_numpy(x)), jf(jp, jnp.asarray(x)))
    close(t_common.swish(torch.from_numpy(x)),
          j_common.swish(jnp.asarray(x)))


def test_layer_norm_bf16_statistics_in_f32():
    rng = np.random.default_rng(1)
    x = rnd(rng, 3, 5, 32, scale=4.0) + 10.0
    ln = {"scale": rnd(rng, 32), "bias": rnd(rng, 32)}
    jp, tp = both(ln)
    got = t_common.layer_norm(
        params_from_jax(ln, dtype=torch.bfloat16),
        torch.from_numpy(x).to(torch.bfloat16))
    ref = j_common.layer_norm(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                           jp),
                              jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(ref, np.float32), rtol=0, atol=1e-2)


def test_masked_fill_and_subsampling_lengths():
    rng = np.random.default_rng(2)
    x = rnd(rng, 3, 9, 4)
    lens = np.array([9, 4, 0], np.int32)
    close(t_mask.masked_fill(torch.from_numpy(x), torch.from_numpy(lens),
                             -2.0),
          j_mask.masked_fill(jnp.asarray(x), jnp.asarray(lens), -2.0))
    n = np.arange(0, 400, dtype=np.int32)
    got = t_mask.subsampling4_length(torch.from_numpy(n))
    ref = j_mask.subsampling4_length(jnp.asarray(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert t_mask.SUBSAMPLED_LENGTH["conv2d"](256) == 63
    np.testing.assert_array_equal(
        t_mask.make_valid_mask(torch.from_numpy(lens), 9).numpy(),
        np.asarray(j_mask.make_valid_mask(jnp.asarray(lens), 9)))


def test_rel_positional_encoding():
    rng = np.random.default_rng(3)
    x = rnd(rng, 2, 11, 32)
    pe_t = t_pos.sinusoid_table(32)
    pe_j = j_pos.sinusoid_table(32)
    np.testing.assert_array_equal(pe_t.numpy(), np.asarray(pe_j))
    xs_t, pos_t = t_pos.rel_positional_encoding(pe_t, torch.from_numpy(x))
    xs_j, pos_j = j_pos.rel_positional_encoding(pe_j, jnp.asarray(x))
    close(xs_t, xs_j)
    close(pos_t, pos_j)


@pytest.mark.parametrize("in_ch", [1, 2])
def test_conv2d_subsampling4(in_ch):
    rng = np.random.default_rng(4 + in_ch)
    idim, odim = 20, 16
    f_out = ((idim // in_ch - 1) // 2 - 1) // 2
    p = {"conv0": {"kernel": rnd(rng, 3, 3, in_ch, odim, scale=0.3),
                   "bias": rnd(rng, odim)},
         "conv1": {"kernel": rnd(rng, 3, 3, odim, odim, scale=0.1),
                   "bias": rnd(rng, odim)},
         "out": {"kernel": rnd(rng, odim * f_out, odim, scale=0.1),
                 "bias": rnd(rng, odim)}}
    jp, tp = both(p)
    x = rnd(rng, 2, 37, idim)
    lens = np.array([37, 22], np.int32)
    y_t, l_t = t_sub.conv2d_subsampling4(tp, torch.from_numpy(x),
                                         torch.from_numpy(lens), in_ch)
    y_j, l_j = j_sub.conv2d_subsampling4(jp, jnp.asarray(x),
                                         jnp.asarray(lens), in_ch)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    close(y_t, y_j)


def _conv_params(rng, C, K, layer_norm):
    p = {"pointwise_conv1": {"kernel": rnd(rng, C, 2 * C, scale=0.2),
                             "bias": rnd(rng, 2 * C)},
         "depthwise_conv": {"kernel": rnd(rng, K, C, scale=0.3),
                            "bias": rnd(rng, C)},
         "norm": {"scale": rnd(rng, C), "bias": rnd(rng, C)},
         "pointwise_conv2": {"kernel": rnd(rng, C, C, scale=0.2),
                             "bias": rnd(rng, C)}}
    return p


@pytest.mark.parametrize("lorder,use_ln", [(0, False), (14, False),
                                           (0, True)])
def test_conv_module(lorder, use_ln):
    rng = np.random.default_rng(7 + lorder)
    C, K = 16, 15
    p = _conv_params(rng, C, K, use_ln)
    jp, tp = both(p)
    x = rnd(rng, 3, 23, C)
    lens = np.array([23, 17, 5], np.int32)
    got = t_conv.conv_module(tp, torch.from_numpy(x), torch.from_numpy(lens),
                             use_layer_norm=use_ln, lorder=lorder)
    ref = j_conv.conv_module(jp, jnp.asarray(x), jnp.asarray(lens),
                             use_layer_norm=use_ln, lorder=lorder)
    close(got, ref)
    close(t_conv.glu(torch.from_numpy(x)), j_conv.glu(jnp.asarray(x)))


@pytest.mark.parametrize("chunk", [False, True])
def test_masked_softmax(chunk):
    rng = np.random.default_rng(11)
    s = rnd(rng, 2, 3, 9, 9, scale=3.0)
    lens = np.array([9, 4], np.int32)
    mask = None
    if chunk:
        mask = np.asarray(j_mask.subsequent_chunk_mask(9, 3, 0))[None, None]
        # a row that attends to nothing exercises the zeroed-row rule
        mask = np.broadcast_to(mask, (2, 1, 9, 9)).copy()
        mask[1, 0, 7] = False
    got = t_attn.masked_softmax(torch.from_numpy(s), torch.from_numpy(lens),
                                0.125,
                                None if mask is None
                                else torch.from_numpy(mask))
    ref = j_attn.masked_softmax(jnp.asarray(s), jnp.asarray(lens), 0.125,
                                None if mask is None else jnp.asarray(mask))
    close(got, ref)


def test_rel_mha():
    rng = np.random.default_rng(12)
    D, H = 32, 4
    p = {n: {"kernel": rnd(rng, D, D, scale=0.2), "bias": rnd(rng, D)}
         for n in ("linear_q", "linear_k", "linear_v", "linear_out")}
    p["linear_pos"] = {"kernel": rnd(rng, D, D, scale=0.2)}
    p["pos_bias_u"] = rnd(rng, H, D // H)
    p["pos_bias_v"] = rnd(rng, H, D // H)
    jp, tp = both(p)
    x = rnd(rng, 2, 13, D)
    pos = np.array(j_pos.sinusoid_table(D))[:13]
    lens = np.array([13, 6], np.int32)
    got = t_attn.rel_mha(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         torch.from_numpy(lens), H)
    ref = j_attn.rel_mha(jp, jnp.asarray(x), jnp.asarray(pos),
                         jnp.asarray(lens), H)
    close(got, ref)


# ---------------------------------------------------------------------------
# the model zoo's other norms: float32 statistics, padded rows
# ---------------------------------------------------------------------------

def _norm_close(got, ref, dtype):
    """float32: the module tolerance; bf16: within one bf16 step of the
    output's scale (both sides round the same float32 value)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(got - ref).max() <= 8e-3 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm(dtype):
    rng = np.random.default_rng(31)
    x = rnd(rng, 2, 7, 24, scale=3.0) + 1.5
    p = {"scale": rnd(rng, 24) + 1.0, "bias": rnd(rng, 24)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_common.group_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, jdt), 4)
    got = t_common.group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x).to(tdt), 4)
    assert got.dtype == tdt
    _norm_close(got, ref, dtype)
    with pytest.raises(ValueError, match="groups"):
        t_common.group_norm(p, torch.zeros(2, 10), 4)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_batch_norm(train, dtype):
    """Masked statistics over the valid frames (the padded ones hold
    large values that must not count), the unbiased variance and the
    momentum update in train mode, the running stats in eval mode."""
    rng = np.random.default_rng(32)
    x = rnd(rng, 20, 16, scale=2.0)
    valid = np.arange(20) < 13
    x[~valid] = 1e3
    p = {"scale": rnd(rng, 16) + 1.0, "bias": rnd(rng, 16),
         "running_mean": rnd(rng, 16), "running_var": np.abs(rnd(rng, 16))
         + 0.5}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref, ref_stats = j_common.mask_batch_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt),
        jnp.asarray(valid), train=train)
    got, stats = t_common.mask_batch_norm(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(tdt), torch.from_numpy(valid), train=train)
    _norm_close(got[:13], np.asarray(ref)[:13], dtype)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(stats[k].float().numpy(),
                                   np.asarray(ref_stats[k], np.float32),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_varlen_instance_norm_2d(affine, dtype):
    """Per-utterance statistics over (channel, valid time) per feature
    column, divided by lengths x F bins; padded frames zeroed."""
    rng = np.random.default_rng(33)
    x = rnd(rng, 2, 3, 11, 5, scale=2.0) + 0.5
    lens = np.array([11, 6], np.int32)
    x[1, :, 6:] = 50.0
    p = {"scale": rnd(rng, 3) + 1.0, "bias": rnd(rng, 3)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_common.varlen_instance_norm_2d(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt),
        jnp.asarray(lens), affine=affine)
    got = t_common.varlen_instance_norm_2d(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(tdt), torch.from_numpy(lens), affine=affine)
    assert got.dtype == tdt
    _norm_close(got, ref, dtype)


# ---------------------------------------------------------------------------
# SpecAugment, the activation registry, dump_tensor, the int8 MoE FFN
# ---------------------------------------------------------------------------

def test_spec_augment_matches_jax_on_its_draws():
    """The port's masking given the draws JAX's spec_augment takes from its
    key (test_torch_train.jax_spec_aug_draws) equals the JAX function's
    output exactly, on float32 and bf16 features, with mask widths past
    the utterance's end and the feature dimension."""
    from test_torch_train import jax_spec_aug_draws
    rng = np.random.default_rng(0)
    feat = rnd(rng, 3, 40, 12)
    lens = np.array([40, 17, 2], np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        conf = dict(num_t_mask=3, num_f_mask=2, max_t=15, max_f=6)
        for dtype, tdtype in ((jnp.float32, torch.float32),
                              (jnp.bfloat16, torch.bfloat16)):
            ref = j_mask.spec_augment(key, jnp.asarray(feat, dtype),
                                      jnp.asarray(lens), **conf)
            draws = jax_spec_aug_draws(key, lens, 12, **conf)
            got = t_mask.apply_spec_augment(
                torch.from_numpy(feat).to(tdtype), torch.from_numpy(lens),
                draws)
            assert got.dtype == tdtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref, np.float32))


def test_spec_augment_draws_keep_jax_bounds():
    """Over 200 seeds of the port's CPU generator: time masks start in
    [0, max(len - 1, 1)) and are [1, max(max_t, 2)) wide, frequency masks
    start in [0, max(D - 1, 1)) and are [1, max(max_f, 2)) wide; the
    masked features are zero and the rest untouched, in the input's
    dtype; a time mask ends at the utterance's length."""
    lens = torch.tensor([50, 9, 1, 2])
    D = 8
    feat = torch.ones((4, 50, D), dtype=torch.bfloat16)
    for seed in range(200):
        g = torch.Generator().manual_seed(seed)
        d = t_mask.spec_augment_draws(g, lens, D, 2, 3, max_t=7, max_f=1)
        hi = (lens - 1).clamp(min=1)[:, None]
        assert ((d["t_start"] >= 0) & (d["t_start"] < hi)).all()
        assert ((d["t_len"] >= 1) & (d["t_len"] < 7)).all()
        assert ((d["f_start"] >= 0) & (d["f_start"] < D - 1)).all()
        assert (d["f_len"] == 1).all()
        out = t_mask.apply_spec_augment(feat, lens, d)
        assert out.dtype == torch.bfloat16
        assert set(out.unique().tolist()) <= {0.0, 1.0}
        for b in range(4):
            t_end = torch.minimum(d["t_start"][b] + d["t_len"][b], lens[b])
            for t0, t1 in zip(d["t_start"][b], t_end):
                assert (out[b, t0:t1] == 0).all()
            for f0, n in zip(d["f_start"][b], d["f_len"][b]):
                assert (out[b, :, f0:f0 + n] == 0).all()
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(
        t_mask.spec_augment(g, feat.float(), lens),
        t_mask.apply_spec_augment(feat.float(), lens, t_mask.spec_augment_draws(
            torch.Generator().manual_seed(0), lens, D)))


@pytest.mark.parametrize("name", ["hardtanh", "tanh", "relu", "selu",
                                  "swish", "silu", "gelu"])
def test_get_activation_matches_jax(name):
    """Every name of the registry (gelu: jax.nn.gelu's tanh
    approximation) on values across [-6, 6]."""
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    close(t_common.get_activation(name)(torch.from_numpy(x)),
          j_common.get_activation(name)(jnp.asarray(x)))


def test_dump_tensor_prints_and_returns_its_input(capsys):
    x = torch.arange(6.0).reshape(2, 3)
    assert t_common.dump_tensor(x, "h") is x
    out = capsys.readouterr().out
    assert "h shape=(2, 3) sum=15.0" in out


def test_moe_ffn_q_matches_jax():
    """The int8 MoE FFN (router on cat[embed, x], every expert dequantized
    on every token, the chosen one times the gate) on JAX-quantized
    weights, with padded rows: rtol 1e-5, atol 1e-5."""
    from m3asr_tpu.ops import moe as j_moe
    from m3asr_tpu.ops import quant as j_quant
    from m3asr_tpu_torch.ops import quant as t_quant
    rng = np.random.default_rng(3)
    p = j_moe.init_moe_ffn(jax.random.PRNGKey(1), 16, 8, 4, 24)
    p = jax.tree.map(np.asarray, p)
    p["router"]["kernel"] = rnd(rng, 24, 4, scale=0.5)
    q = jax.tree.map(np.asarray, j_quant.quantize_moe_params(p, bits=8))
    x, embed = rnd(rng, 2, 7, 16), rnd(rng, 2, 7, 8)
    lens = np.array([7, 4], np.int32)
    ref = j_quant.moe_ffn_q(jax.tree.map(jnp.asarray, q), jnp.asarray(x),
                            jnp.asarray(embed), jnp.asarray(lens))
    got = t_quant.moe_ffn_q(params_from_jax(q), torch.from_numpy(x),
                            torch.from_numpy(embed), torch.from_numpy(lens))
    close(got, ref)
