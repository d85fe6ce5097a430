"""The flagship hier MoE conformer with the catEmbed router (port of
``m3asr_tpu/models/moe_conformer.py``, inference forward):

    embed_out, _, embed = embed_encoder(feat, feat_len)   # dense blocks
    x, x_len = Conv2dSubsampling4(feat, feat_len)         # own stack
    x, pos_emb = RelPositionalEncoding(x)
    for each MoE block: x = conformer_block(x, router sees cat[embed, x])
    out = out_linear(after_norm(x))

The block loop walks per-layer views of the stacked ``(L, ...)``
parameters; the expert weights ``(L, E, d, h)`` are indexed, not copied.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.models import conformer
from m3asr_tpu_torch.models.layers import conformer_block
from m3asr_tpu_torch.ops import positional
from m3asr_tpu_torch.ops.common import layer_norm, linear


def forward(params, cfg: MoEEncoderConfig, feat: torch.Tensor,
            feat_len: Optional[torch.Tensor], output_embed: bool = False,
            moe_impl: str = "dense"):
    """feat: (B, T, input_dim) -> (logits (B, T', V), out_len[,
    embed_out])."""
    if cfg.exmarc:
        raise NotImplementedError("the ExMarc (MoE macaron) variant is not "
                                  "ported (ROADMAP Queue 1 item 10)")
    embed_out, _, embed = conformer.forward(
        params["embed"], cfg.embed_conf, feat, feat_len, output_embed=True)
    x, pos_emb, out_len = conformer.frontend(params, cfg, feat, feat_len)
    kw = conformer.block_kwargs(cfg)
    blocks = params["blocks"]
    for i in range(conformer.num_layers(blocks)):
        x = conformer_block(conformer.layer_view(blocks, i), x, out_len,
                            pos_emb, moe=True, embed=embed,
                            moe_impl=moe_impl, **kw)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    out = linear(params["out_linear"], x)
    if output_embed:
        return out, out_len, embed_out
    return out, out_len


# ---------------------------------------------------------------------------
# synthetic weights (random, from a torch.Generator), with the JAX tree's
# paths and shapes
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def uniform(self, shape, bound):
        u = torch.rand(shape, generator=self.g, device=self.device)
        return ((u * 2 - 1) * bound).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out, bias=True):
        b = 1.0 / math.sqrt(d_in)
        p = {"kernel": self.uniform((d_in, d_out), b)}
        if bias:
            p["bias"] = self.uniform((d_out,), b)
        return p

    def norm(self, d):
        return {"scale": self.ones((d,)), "bias": self.zeros((d,))}

    def subsampling4(self, idim, odim, in_ch):
        f_out = ((idim - 1) // 2 - 1) // 2

        def conv(cin):
            b = 1.0 / math.sqrt(cin * 9)
            return {"kernel": self.uniform((3, 3, cin, odim), b),
                    "bias": self.uniform((odim,), b)}
        return {"conv0": conv(in_ch), "conv1": conv(odim),
                "out": self.linear(odim * f_out, odim)}

    def block(self, d, heads, ffn_hidden, kernel, moe=None):
        dk = d // heads
        xb = math.sqrt(6.0 / (heads + dk))
        attn = {n: self.linear(d, d) for n in
                ("linear_q", "linear_k", "linear_v", "linear_out")}
        attn["linear_pos"] = self.linear(d, d, bias=False)
        attn["pos_bias_u"] = self.uniform((heads, dk), xb)
        attn["pos_bias_v"] = self.uniform((heads, dk), xb)
        p = {
            "norm_mha": self.norm(d), "self_attn": attn,
            "norm_ff": self.norm(d), "norm_ff_macaron": self.norm(d),
            "feed_forward_macaron": {"w_1": self.linear(d, ffn_hidden),
                                     "w_2": self.linear(ffn_hidden, d)},
            "norm_conv": self.norm(d),
            "conv_module": {
                "pointwise_conv1": {
                    "kernel": self.uniform((d, 2 * d), 1 / math.sqrt(d)),
                    "bias": self.zeros((2 * d,))},
                "depthwise_conv": {
                    "kernel": self.uniform((kernel, d),
                                           1 / math.sqrt(kernel)),
                    "bias": self.zeros((d,))},
                "norm": self.norm(d),
                "pointwise_conv2": {
                    "kernel": self.uniform((d, d), 1 / math.sqrt(d)),
                    "bias": self.zeros((d,))}},
            "norm_final": self.norm(d),
        }
        if moe is None:
            p["feed_forward"] = {"w_1": self.linear(d, ffn_hidden),
                                 "w_2": self.linear(ffn_hidden, d)}
        else:
            embed_dim, E, h = moe
            # FMoELinear: xavier-uniform, gain 0.5, over (out, in) slices
            xb = 0.5 * math.sqrt(6.0 / (d + h))
            # zero routers, as the reference initialises them
            p["feed_forward"] = {
                "router": {"kernel": self.zeros((d + embed_dim, E))},
                "w1": self.uniform((E, d, h), xb), "b1": self.zeros((E, h)),
                "w2": self.uniform((E, h, d), xb), "b2": self.zeros((E, d))}
        return p

    def stacked(self, n, make):
        blocks = [make() for _ in range(n)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return torch.stack(xs)
        return stack(*blocks)

    def dense_encoder(self, cfg: EncoderConfig, input_dim, output_dim):
        d = cfg.attention_dim
        return {
            "subsampling": self.subsampling4(
                input_dim // cfg.conv_subsample_in_ch, d,
                cfg.conv_subsample_in_ch),
            "pos_enc": {"pe": positional.sinusoid_table(
                d, dtype=self.dtype, device=self.device)},
            "after_norm": self.norm(d),
            "out_linear": self.linear(d, output_dim),
            "blocks": self.stacked(cfg.num_blocks, lambda: self.block(
                d, cfg.attention_heads, cfg.linear_units,
                cfg.cnn_module_kernel)),
        }


def init(cfg: MoEEncoderConfig, input_dim: int, output_dim: int,
         generator: torch.Generator, device=None,
         dtype: torch.dtype = torch.float32):
    """Random parameters for the hier MoE conformer, drawn on
    ``generator``'s device. Routers start at zero, as in the reference
    (every token then goes to expert 0): randomise them for real
    dispatch."""
    ini = _Init(generator, device, dtype)
    d = cfg.attention_dim
    params = ini.dense_encoder(cfg, input_dim, output_dim)
    del params["blocks"]
    params["embed"] = ini.dense_encoder(cfg.embed_conf, input_dim,
                                        output_dim)
    moe = (cfg.embed_dim, cfg.moe_conf.total_experts,
           cfg.moe_conf.hidden_units)
    params["blocks"] = ini.stacked(cfg.num_blocks, lambda: ini.block(
        d, cfg.attention_heads, cfg.moe_conf.hidden_units,
        cfg.cnn_module_kernel, moe=moe))
    params["after_norm_6"] = ini.norm(d)
    params["after_norm_12"] = ini.norm(d)
    return params
