"""Dense conformer encoder, used as the hier model's embed sub-encoder
(port of ``m3asr_tpu/models/conformer.py``).

Block parameters stay stacked over layers ``(L, ...)`` as in the JAX
tree; :func:`run_blocks` walks per-layer views of them (indexing a
contiguous stacked tensor is a view: no copy).
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.config import EncoderConfig
from m3asr_tpu_torch.models.layers import conformer_block
from m3asr_tpu_torch.ops import positional
from m3asr_tpu_torch.ops.common import layer_norm, linear
from m3asr_tpu_torch.ops.subsampling import conv2d_subsampling4


def layer_view(tree, i: int):
    """The i-th layer of a tree of stacked (L, ...) tensors, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def check_supported(cfg: EncoderConfig) -> None:
    """Reject encoder settings this slice has not ported."""
    if cfg.input_layer != "conv2d":
        raise NotImplementedError(
            f"input_layer {cfg.input_layer!r}: only 'conv2d' "
            "(Conv2dSubsampling4) is ported (ROADMAP Queue 1 item 10)")
    if cfg.pos_enc_layer_type != "rel_pos":
        raise NotImplementedError(
            f"pos_enc_layer_type {cfg.pos_enc_layer_type!r}: only "
            "'rel_pos' is ported (ROADMAP Queue 1 item 10)")
    if cfg.subsampling_feat_norm:
        raise NotImplementedError(
            "subsampling_feat_norm is not ported (ROADMAP Queue 1 item 10)")


def frontend(params, cfg: EncoderConfig, feat: torch.Tensor,
             feat_len: Optional[torch.Tensor]):
    """Subsampling + relative positional encoding.
    Returns (x (B,T',D), pos_emb (T',D), out_len)."""
    check_supported(cfg)
    x, out_len = conv2d_subsampling4(params["subsampling"], feat, feat_len,
                                     in_ch=cfg.conv_subsample_in_ch)
    x, pos_emb = positional.rel_positional_encoding(params["pos_enc"]["pe"],
                                                    x)
    return x, pos_emb, out_len


def block_kwargs(cfg: EncoderConfig) -> dict:
    return dict(num_heads=cfg.attention_heads, macaron=cfg.macaron_style,
                use_cnn=cfg.use_cnn_module,
                conv_layer_norm=(cfg.cnn_module_norm == "layer_norm"),
                conv_lorder=cfg.cnn_module_kernel - 1 if cfg.causal else 0,
                normalize_before=cfg.normalize_before)


def run_blocks(stacked_blocks, cfg: EncoderConfig, x: torch.Tensor,
               lengths: Optional[torch.Tensor], pos_emb: torch.Tensor,
               mask: Optional[torch.Tensor] = None, attn_impl: str = "xla"):
    """The dense block stack: a Python loop over per-layer views. ``mask``
    is an optional (B|1, 1, T, T) chunk attend-mask."""
    kw = block_kwargs(cfg)
    for i in range(num_layers(stacked_blocks)):
        x = conformer_block(layer_view(stacked_blocks, i), x, lengths,
                            pos_emb, mask=mask, attn_impl=attn_impl, **kw)
    return x


def forward(params, cfg: EncoderConfig, feat: torch.Tensor,
            feat_len: Optional[torch.Tensor], output_embed: bool = False,
            chunk_mask: Optional[torch.Tensor] = None,
            attn_impl: str = "xla"):
    """feat: (B, T, input_dim) -> (logits, out_len[, embed]); embed is
    the after_norm'd hidden (the catEmbed router feature)."""
    x, pos_emb, out_len = frontend(params, cfg, feat, feat_len)
    x = run_blocks(params["blocks"], cfg, x, out_len, pos_emb,
                   mask=chunk_mask, attn_impl=attn_impl)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    out = linear(params["out_linear"], x)
    if output_embed:
        return out, out_len, x
    return out, out_len
