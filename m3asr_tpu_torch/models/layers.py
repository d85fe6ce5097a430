"""Conformer block (port of ``m3asr_tpu/models/layers.py``).

Macaron structure with pre-norm (the deployed configuration):

    x += 0.5 * ffn_macaron(LN(x))
    x += rel_mha(LN(x))
    x += conv_module(LN(x))
    x += 0.5 * ffn(LN(x))          # the MoE FFN in MoE blocks
    x = LN_final(x)
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.ops.attention import rel_mha
from m3asr_tpu_torch.ops.common import layer_norm, linear, swish
from m3asr_tpu_torch.ops.conv import conv_module
from m3asr_tpu_torch.ops.flash_attention import flash_rel_mha
from m3asr_tpu_torch.ops.moe import moe_ffn


def positionwise_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN: linear -> SiLU -> linear."""
    return linear(p["w_2"], swish(linear(p["w_1"], x)))


def conformer_block(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                    pos_emb: torch.Tensor, *, num_heads: int,
                    macaron: bool = True, use_cnn: bool = True,
                    conv_layer_norm: bool = False, conv_lorder: int = 0,
                    normalize_before: bool = True, moe: bool = False,
                    embed: Optional[torch.Tensor] = None,
                    moe_impl: str = "dense",
                    mask: Optional[torch.Tensor] = None,
                    attn_impl: str = "xla") -> torch.Tensor:
    """One conformer block; ``moe=True`` makes the final FFN the catEmbed
    MoE FFN with ``embed`` as the router's extra feature. ``mask``: an
    optional (B|1, 1, T, T) chunk attend-mask; ``attn_impl="flash"`` runs
    the attention on the flash kernels (K2, K3 when training)."""
    ff_scale = 0.5 if macaron else 1.0

    def pre(name, v):
        return layer_norm(p[name], v) if normalize_before else v

    def post(name, v):
        return v if normalize_before else layer_norm(p[name], v)

    if macaron:
        h = positionwise_ffn(p["feed_forward_macaron"],
                             pre("norm_ff_macaron", x))
        x = post("norm_ff_macaron", x + ff_scale * h)

    if attn_impl == "flash":
        h = flash_rel_mha(p["self_attn"], pre("norm_mha", x), pos_emb,
                          lengths, num_heads, mask=mask)
    elif attn_impl == "xla":
        h = rel_mha(p["self_attn"], pre("norm_mha", x), pos_emb, lengths,
                    num_heads, mask=mask)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    x = post("norm_mha", x + h)

    if use_cnn:
        h = conv_module(p["conv_module"], pre("norm_conv", x), lengths,
                        use_layer_norm=conv_layer_norm, lorder=conv_lorder)
        x = post("norm_conv", x + h)

    h = pre("norm_ff", x)
    if moe:
        h = moe_ffn(p["feed_forward"], h, embed, lengths, impl=moe_impl)
    else:
        h = positionwise_ffn(p["feed_forward"], h)
    x = post("norm_ff", x + ff_scale * h)

    if use_cnn:
        x = layer_norm(p["norm_final"], x)
    return x
