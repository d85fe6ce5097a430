"""Conformer block (port of ``m3asr_tpu/models/layers.py``).

Macaron structure with pre-norm (the deployed configuration):

    x += 0.5 * ffn_macaron(LN(x))
    x += rel_mha(LN(x))
    x += conv_module(LN(x))
    x += 0.5 * ffn(LN(x))          # the MoE FFN in MoE blocks
    x = LN_final(x)

In the ExMarc blocks (``moe_macaron=True``) the macaron FFN is a MoE FFN
too, routed on the same catEmbed router input; its residual keeps the
0.5 scale.

A block whose attention has no ``linear_pos`` (the ``no_pos`` models)
runs plain multi-head attention, as the JAX package's block does.
:func:`init_conformer_block` draws a dense block's seeded parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from m3asr_tpu_torch.ops.attention import init_mha, mha, rel_mha
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear,
                                        row_parallel_linear, swish)
from m3asr_tpu_torch.ops.conv import conv_module
from m3asr_tpu_torch.ops.flash_attention import flash_rel_mha
from m3asr_tpu_torch.ops.moe import init_moe_ffn, moe_ffn
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.parallel import sp as psp


def positionwise_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN: linear -> SiLU -> linear (under a tp mesh w_1's columns
    and w_2's rows are this rank's, w_2's partial product summed over
    "tp")."""
    return row_parallel_linear(p["w_2"], swish(linear(p["w_1"],
                                                      pmesh.into(x, "tp"))))


def conformer_block(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                    pos_emb: torch.Tensor, *, num_heads: int,
                    macaron: bool = True, use_cnn: bool = True,
                    conv_layer_norm: bool = False, conv_lorder: int = 0,
                    normalize_before: bool = True, moe: bool = False,
                    embed: Optional[torch.Tensor] = None,
                    moe_impl: str = "dense", moe_macaron: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    return_moe_aux: bool = False,
                    attn_impl: str = "xla"):
    """One conformer block; ``moe=True`` makes the final FFN the catEmbed
    MoE FFN with ``embed`` as the router's extra feature, and
    ``moe_macaron=True`` the macaron FFN as well (ExMarc). ``mask``: an
    optional (B|1, 1, T, T) chunk attend-mask; ``attn_impl="flash"`` runs
    the attention on the flash kernels (K2, K3 when training).
    ``return_moe_aux``: return (x, the final FFN router's probabilities
    (B, T, E) float32), as the JAX block does."""
    ff_scale = 0.5 if macaron else 1.0
    # under sp, x holds this rank's rows: ``lengths`` masks them as the
    # global lengths mask the global rows; attention reads the gathered
    # keys with the global lengths
    key_lengths = lengths
    sp_mesh = psp.active()
    if sp_mesh is not None:
        lengths = psp.row_lengths(sp_mesh, key_lengths, x.shape[1])
        mask = psp.local_rows(sp_mesh, mask, x.shape[1])

    def pre(name, v):
        return layer_norm(p[name], v) if normalize_before else v

    def post(name, v):
        return v if normalize_before else layer_norm(p[name], v)

    if macaron:
        h = pre("norm_ff_macaron", x)
        if moe_macaron:
            h = moe_ffn(p["feed_forward_macaron"], h, embed, lengths,
                        impl=moe_impl)
        else:
            h = positionwise_ffn(p["feed_forward_macaron"], h)
        x = post("norm_ff_macaron", x + ff_scale * h)

    if attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    h = pre("norm_mha", x)
    kv = None if sp_mesh is None else psp.gather_time(sp_mesh, h)
    if "linear_pos" not in p["self_attn"]:
        # no_pos blocks carry plain MHA weights; flash serves rel-pos
        # attention only, as in the JAX package
        hq = pmesh.into(h, "tp")
        hk = hq if kv is None else pmesh.into(kv, "tp")
        h = mha(p["self_attn"], hq, hk, hk, key_lengths,
                num_heads // pmesh.axis_size("tp"), mask=mask)
    elif attn_impl == "flash":
        h = flash_rel_mha(p["self_attn"], h, pos_emb, key_lengths,
                          num_heads, mask=mask, kv=kv)
    else:
        h = rel_mha(p["self_attn"], h, pos_emb, key_lengths, num_heads,
                    mask=mask, kv=kv)
    x = post("norm_mha", x + h)

    if use_cnn:
        h = conv_module(p["conv_module"], pre("norm_conv", x), lengths,
                        use_layer_norm=conv_layer_norm, lorder=conv_lorder)
        x = post("norm_conv", x + h)

    h = pre("norm_ff", x)
    probs = None
    if moe:
        h = moe_ffn(p["feed_forward"], h, embed, lengths, impl=moe_impl,
                    return_router_probs=return_moe_aux)
        if return_moe_aux:
            h, probs = h
    else:
        h = positionwise_ffn(p["feed_forward"], h)
    x = post("norm_ff", x + ff_scale * h)

    if use_cnn:
        x = layer_norm(p["norm_final"], x)
    return (x, probs) if return_moe_aux else x


# ---------------------------------------------------------------------------
# seeded init of a dense block (torch.nn defaults, as the JAX package's
# init_conformer_block draws them), from a torch.Generator on its device
# ---------------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, bound: float, dtype):
    u = torch.rand(shape, generator=g, device=g.device)
    return ((u * 2 - 1) * bound).to(dtype)


def init_ffn(g: torch.Generator, d_model: int, hidden: int,
             dtype=torch.float32):
    return {"w_1": init_linear(g, d_model, hidden, dtype=dtype),
            "w_2": init_linear(g, hidden, d_model, dtype=dtype)}


def init_rel_mha(g: torch.Generator, d_model: int, num_heads: int,
                 dtype=torch.float32):
    """linear_q/k/v/out, linear_pos (no bias) and the pos_bias_u/v
    (xavier-uniform over (H, Dk))."""
    p = init_mha(g, d_model, dtype)
    p["linear_pos"] = init_linear(g, d_model, d_model, bias=False,
                                  dtype=dtype)
    dk = d_model // num_heads
    bound = math.sqrt(6.0 / (num_heads + dk))
    p["pos_bias_u"] = _uniform(g, (num_heads, dk), bound, dtype)
    p["pos_bias_v"] = _uniform(g, (num_heads, dk), bound, dtype)
    return p


def init_conv_module(g: torch.Generator, channels: int, kernel_size: int,
                     dtype=torch.float32):
    """The pointwise and depthwise convs (torch Conv1d fan-in bounds, zero
    biases) and a unit norm."""
    b1 = 1.0 / math.sqrt(channels)
    dev = g.device

    def zeros(n):
        return torch.zeros((n,), device=dev, dtype=dtype)
    return {
        "pointwise_conv1": {
            "kernel": _uniform(g, (channels, 2 * channels), b1, dtype),
            "bias": zeros(2 * channels)},
        "depthwise_conv": {
            "kernel": _uniform(g, (kernel_size, channels),
                               1.0 / math.sqrt(kernel_size), dtype),
            "bias": zeros(channels)},
        "norm": init_layer_norm(channels, dev, dtype),
        "pointwise_conv2": {
            "kernel": _uniform(g, (channels, channels), b1, dtype),
            "bias": zeros(channels)}}


def init_conformer_block(g: torch.Generator, d_model: int, num_heads: int,
                         ffn_hidden: int, cnn_kernel: int = 15,
                         macaron: bool = True, use_cnn: bool = True,
                         moe: bool = False, moe_embed_dim: int = 0,
                         moe_num_experts: int = 0, moe_hidden: int = 0,
                         router_with_bias: bool = False,
                         moe_macaron: bool = False,
                         rel_attn: bool = True, dtype=torch.float32):
    """A conformer block: rel-pos attention, or plain MHA with
    ``rel_attn=False`` (the no_pos models). ``moe=True`` makes the final
    FFN a catEmbed MoE FFN (:func:`~m3asr_tpu_torch.ops.moe.init_moe_ffn`)
    and ``moe_macaron=True`` the macaron FFN as well (ExMarc)."""
    dev = g.device

    def ffn(is_moe):
        if is_moe:
            return init_moe_ffn(g, d_model, moe_embed_dim, moe_num_experts,
                                moe_hidden, router_with_bias, dtype)
        return init_ffn(g, d_model, ffn_hidden, dtype)
    p = {"norm_mha": init_layer_norm(d_model, dev, dtype),
         "self_attn": (init_rel_mha(g, d_model, num_heads, dtype)
                       if rel_attn else init_mha(g, d_model, dtype)),
         "norm_ff": init_layer_norm(d_model, dev, dtype),
         "feed_forward": ffn(moe)}
    if macaron:
        p["norm_ff_macaron"] = init_layer_norm(d_model, dev, dtype)
        p["feed_forward_macaron"] = ffn(moe and moe_macaron)
    if use_cnn:
        p["norm_conv"] = init_layer_norm(d_model, dev, dtype)
        p["conv_module"] = init_conv_module(g, d_model, cnn_kernel, dtype)
        p["norm_final"] = init_layer_norm(d_model, dev, dtype)
    return p
