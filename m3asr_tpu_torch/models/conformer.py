"""Dense conformer encoder (port of ``m3asr_tpu/models/conformer.py``):
the dense conformer protos' CTC encoder (``conformer``, ``conformer2``,
``conformer_embed``, ... and the AED wrappers' encoder) and the hier
model's embed sub-encoder.

Every input layer (:data:`SUBSAMPLERS`: ``conv2d``, ``conv2d6``,
``conv2d8``, ``linear``), the optional LayerNorm after it
(``subsampling_feat_norm``) and the three positional types (``rel_pos``,
``abs_pos``, ``no_pos``). Block parameters stay stacked over layers
``(L, ...)`` as in the JAX tree; :func:`run_blocks` walks per-layer views
of them (indexing a contiguous stacked tensor is a view: no copy).
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.config import EncoderConfig
from m3asr_tpu_torch.models.layers import (conformer_block,
                                           init_conformer_block)
from m3asr_tpu_torch.ops import positional
from m3asr_tpu_torch.ops import subsampling as sub
from m3asr_tpu_torch.ops.masking import subsequent_chunk_mask
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear)
from m3asr_tpu_torch.parallel import fsdp
from m3asr_tpu_torch.parallel import sp as psp

# input_layer -> (forward, init)
SUBSAMPLERS = {
    "conv2d": (sub.conv2d_subsampling4, sub.init_conv2d_subsampling4),
    "conv2d6": (sub.conv2d_subsampling6, sub.init_conv2d_subsampling6),
    "conv2d8": (sub.conv2d_subsampling8, sub.init_conv2d_subsampling8),
    "linear": (sub.linear_no_subsampling, sub.init_linear_no_subsampling),
}
POS_ENC_TYPES = ("rel_pos", "abs_pos", "no_pos")
# the LayerNorm after the input layer (torch.nn.LayerNorm's epsilon)
FEAT_NORM_EPS = 1e-5


def _index_view(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_view(v, i) for k, v in tree.items()}
    return tree[i]


def layer_view(tree, i: int):
    """The i-th layer of a tree of stacked (L, ...) tensors, as views
    (gathered over dp where ``parallel/fsdp.gathering`` says)."""
    return fsdp.layer_view(tree, i, _index_view)


def _count(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def num_layers(tree) -> int:
    """The layer count of a tree of stacked (L, ...) tensors (under FSDP's
    ``parallel/fsdp.gathering`` the whole stack's)."""
    return fsdp.num_layers(tree, _count)


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ValueError for an input layer or positional type outside the
    JAX package's tables."""
    if cfg.input_layer not in SUBSAMPLERS:
        raise ValueError(f"unknown input_layer {cfg.input_layer!r}; choose "
                         f"one of {sorted(SUBSAMPLERS)}")
    if cfg.pos_enc_layer_type not in POS_ENC_TYPES:
        raise ValueError(f"unknown pos_enc_layer_type "
                         f"{cfg.pos_enc_layer_type!r}; choose one of "
                         f"{list(POS_ENC_TYPES)}")


def frontend(params, cfg: EncoderConfig, feat: torch.Tensor,
             feat_len: Optional[torch.Tensor]):
    """The input layer, the optional LayerNorm after it (when the config
    asks for it and the params carry ``subsampling_layer_norm``, as in
    JAX) and the positional encoding. Returns (x (B,T',D), pos_emb
    (T',D), out_len)."""
    check_supported(cfg)
    fwd, _ = SUBSAMPLERS[cfg.input_layer]
    if cfg.input_layer == "linear":
        x, out_len = fwd(params["subsampling"], feat, feat_len)
    else:
        x, out_len = fwd(params["subsampling"], feat, feat_len,
                         in_ch=cfg.conv_subsample_in_ch)
    if cfg.subsampling_feat_norm and "subsampling_layer_norm" in params:
        x = layer_norm(params["subsampling_layer_norm"], x,
                       eps=FEAT_NORM_EPS)
    if cfg.pos_enc_layer_type == "no_pos":
        x, pos_emb = positional.no_pos(x, cfg.attention_dim)
    else:
        encode = (positional.rel_positional_encoding
                  if cfg.pos_enc_layer_type == "rel_pos"
                  else positional.abs_positional_encoding)
        x, pos_emb = encode(params["pos_enc"]["pe"], x)
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
    is an optional (B|1, 1, T, T) chunk attend-mask. Under an sp mesh the
    stack runs on this rank's rows (``parallel/sp.py``)."""
    kw = block_kwargs(cfg)
    sp_mesh = psp.active()
    if sp_mesh is not None:
        x, pos_emb, _, mask, T = psp.split(sp_mesh, x, pos_emb, None, mask)
    for i in range(num_layers(stacked_blocks)):
        x = conformer_block(layer_view(stacked_blocks, i), x, lengths,
                            pos_emb, mask=mask, attn_impl=attn_impl, **kw)
    return x if sp_mesh is None else psp.join(sp_mesh, x, T)


def chunk_attention_mask(T: int, chunk_size: int, num_left_chunks: int = -1,
                         device=None) -> torch.Tensor:
    """Static-chunk attend-mask (1, 1, T, T) of a full-utterance forward
    that sees what a stream of ``chunk_size`` output frames and
    ``num_left_chunks`` cached chunks sees: the offline oracle of
    ``models/streaming.py``."""
    return subsequent_chunk_mask(T, chunk_size, num_left_chunks,
                                 device)[None, None]


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


def init(cfg: EncoderConfig, input_dim: int, output_dim: int,
         generator: torch.Generator, dtype: torch.dtype = torch.float32):
    """Seeded random parameters of the dense encoder, drawn on
    ``generator``'s device: the input layer, the sinusoid table, the
    blocks (plain MHA for ``no_pos``, as the JAX package's init),
    after_norm and out_linear. With ``subsampling_feat_norm`` the front
    end's LayerNorm too (the JAX init leaves it out, and its forward then
    skips the norm; a converted checkpoint carries it)."""
    check_supported(cfg)
    g, dev, d = generator, generator.device, cfg.attention_dim
    _, sub_init = SUBSAMPLERS[cfg.input_layer]
    if cfg.input_layer == "linear":
        subsampling = sub_init(g, input_dim, d, dtype)
    else:
        subsampling = sub_init(g, input_dim // cfg.conv_subsample_in_ch, d,
                               cfg.conv_subsample_in_ch, dtype)
    params = {
        "subsampling": subsampling,
        "pos_enc": {"pe": positional.sinusoid_table(d, dtype=dtype,
                                                    device=dev)},
        "after_norm": init_layer_norm(d, dev, dtype),
        "out_linear": init_linear(g, d, output_dim, dtype=dtype)}
    if cfg.subsampling_feat_norm:
        params["subsampling_layer_norm"] = init_layer_norm(d, dev, dtype)
    blocks = [init_conformer_block(
        g, d, cfg.attention_heads, cfg.linear_units,
        cnn_kernel=cfg.cnn_module_kernel, macaron=cfg.macaron_style,
        use_cnn=cfg.use_cnn_module,
        rel_attn=cfg.pos_enc_layer_type != "no_pos", dtype=dtype)
        for _ in range(cfg.num_blocks)]
    params["blocks"] = _stack(blocks)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
