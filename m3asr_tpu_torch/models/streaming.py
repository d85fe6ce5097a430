"""Chunk-by-chunk streaming inference with fixed-shape caches (port of
``m3asr_tpu/models/streaming.py``).

* Every cache is a fixed-size tensor: the attention K/V cache holds the
  last ``cache_T`` post-projection frames of each layer, the conv cache
  the last ``lorder`` module-input frames. A chunk program therefore has
  one shape for a stream's whole life, which a CUDA graph needs.
* Cache slot i of a chunk at output offset ``off`` holds absolute frame
  ``off - cache_T + i``; slots with negative positions are masked, so
  early chunks need no other shapes.
* The positional rows come from a gather on the device, never from a
  host read. Past the end of the 5000-row table the two JAX forms differ
  and the port keeps both: with per-slot offsets (batched streams) a row
  past the table is NaN, as ``jnp.take``'s fill gives; with one scalar
  offset (a single stream) the window's start is clamped so that it ends
  at the table's last row, as ``lax.dynamic_slice`` clamps. No index
  past the table is ever read.

Activations and caches take the chunk's dtype (the engine's: float32 or
bfloat16); attention scores and the softmax run in float32, as in the
offline path. The JAX package keeps float32 caches, which on bf16
weights promote its streams to float32 activations; a JAX stream given
caches and windows in bf16 computes what the port's bf16 stream does.

Exact streaming needs a causally convolved, chunk-trained model
(``causal=True`` and chunk masks): then a stream equals the offline
forward with :func:`m3asr_tpu_torch.models.conformer.chunk_attention_mask`
on every full chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.models import conformer
from m3asr_tpu_torch.models.layers import positionwise_ffn
from m3asr_tpu_torch.ops.common import layer_norm, linear, swish
from m3asr_tpu_torch.ops.conv import depthwise_conv1d, glu
from m3asr_tpu_torch.ops.moe import moe_ffn
from m3asr_tpu_torch.ops.subsampling import conv2d_subsampling4

_NEG_INF = -1e30


@dataclasses.dataclass
class StreamState:
    """One encoder's streaming caches (all fixed-shape)."""
    offset: torch.Tensor     # () or (B,) int32: output frames consumed
    att_cache: torch.Tensor  # (L, B, H, cache_T, 2*dk)
    cnn_cache: torch.Tensor  # (L, B, lorder, D)

    def tensors(self):
        return (self.offset, self.att_cache, self.cnn_cache)


def init_state(cfg: EncoderConfig, batch: int, cache_T: int,
               per_slot: bool = False, dtype: torch.dtype = torch.float32,
               device=None) -> StreamState:
    """Zero caches. ``per_slot=True`` gives each batch row its own offset:
    the batched multi-stream mode, where every slot hosts an independent
    stream of its own age (``runtime/streaming_batch.py``)."""
    dk = cfg.head_dim
    lorder = cfg.cnn_module_kernel - 1
    return StreamState(
        offset=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
        att_cache=torch.zeros((cfg.num_blocks, batch, cfg.attention_heads,
                               cache_T, 2 * dk), dtype=dtype, device=device),
        cnn_cache=torch.zeros((cfg.num_blocks, batch, lorder,
                               cfg.attention_dim), dtype=dtype,
                              device=device))


def select_state(mask: torch.Tensor, new: StreamState,
                 old: StreamState) -> StreamState:
    """Per-slot update: ``new`` where mask (B,) is True, ``old``
    elsewhere; idle slots of a batched step must not advance."""
    off = (torch.where(mask, new.offset, old.offset) if new.offset.dim()
           else new.offset)
    return StreamState(
        offset=off,
        att_cache=torch.where(mask[None, :, None, None, None],
                              new.att_cache, old.att_cache),
        cnn_cache=torch.where(mask[None, :, None, None], new.cnn_cache,
                              old.cnn_cache))


def write_state(dst: StreamState, new: StreamState,
                mask: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` into ``dst``'s tensors in place (``select_state``
    first when a slot mask is given): a chunk program's state lives at
    fixed addresses."""
    if mask is not None:
        new = select_state(mask, new, dst)
    for d, n in zip(dst.tensors(), new.tensors()):
        d.copy_(n)


def positional_rows(pe: torch.Tensor, offset: torch.Tensor, cache_T: int,
                    C: int) -> torch.Tensor:
    """The positional rows of [cache, chunk] for output offset(s)
    ``offset``: row i is pe[offset - cache_T + i], zero before position 0.
    Per-slot offsets (B,) give (B, cache_T + C, D) with NaN rows past the
    table (``jnp.take``'s fill); a scalar offset gives (cache_T + C, D)
    with the window's start clamped so that it ends at the table's last
    row (``lax.dynamic_slice``'s clamp). Only indices inside the table
    are read."""
    P = pe.shape[0]
    idx = torch.arange(cache_T + C, device=pe.device)
    if offset.dim():
        pos = offset.long()[:, None] + idx[None, :] - cache_T
    else:
        start = torch.clamp(offset.long(), 0, P - C)
        pos = start + idx - cache_T
    rows = pe[torch.clamp(pos, 0, P - 1)]
    zero = torch.zeros((), dtype=pe.dtype, device=pe.device)
    rows = torch.where((pos < 0)[..., None], zero, rows)
    if offset.dim():
        nan = torch.full((), float("nan"), dtype=pe.dtype, device=pe.device)
        rows = torch.where((pos >= P)[..., None], nan, rows)
    return rows


def _frontend_chunk(params, cfg: EncoderConfig, chunk_feat: torch.Tensor,
                    state: StreamState, cache_T: int):
    """Subsample a raw chunk; the positional rows and key validity of
    [cache, chunk]. Returns (x (B, C, D), pos_emb, key_valid, C)."""
    conformer.check_supported(cfg)
    x, _ = conv2d_subsampling4(params["subsampling"], chunk_feat, None,
                               in_ch=cfg.conv_subsample_in_ch)
    C = x.shape[1]
    x = x * torch.full((), math.sqrt(cfg.attention_dim), dtype=x.dtype,
                       device=x.device)
    pos_emb = positional_rows(params["pos_enc"]["pe"], state.offset,
                              cache_T, C).to(x.dtype)
    idx = torch.arange(cache_T + C, device=x.device)
    if state.offset.dim():
        key_valid = (state.offset[:, None] - cache_T + idx[None, :]) >= 0
    else:
        key_valid = (state.offset - cache_T + idx) >= 0
    return x, pos_emb, key_valid, C


def _stream_rel_mha(p, x: torch.Tensor, pos_emb: torch.Tensor,
                    cache_kv: torch.Tensor, key_valid: torch.Tensor,
                    num_heads: int):
    """Rel-pos attention of the chunk's queries over [cache, chunk] keys.
    x: (B, C, D); cache_kv: (B, H, Tc, 2dk); pos_emb: (Tc+C, D), or
    (B, Tc+C, D) per slot; key_valid: (Tc+C,) or (B, Tc+C). Returns
    (out, [k; v] of cache and chunk (B, H, Tc+C, 2dk))."""
    B, C, D = x.shape
    h = num_heads
    dk = D // h

    def heads(name):
        return linear(p[name], x).reshape(B, C, h, dk)

    q = heads("linear_q")
    k, v = (heads(n).transpose(1, 2) for n in ("linear_k", "linear_v"))
    ck, cv = torch.split(cache_kv, dk, dim=-1)             # (B,H,Tc,dk)
    full_k = torch.cat([ck, k], dim=2)                     # (B,H,Tc+C,dk)
    full_v = torch.cat([cv, v], dim=2)
    new_cache = torch.cat([full_k, full_v], dim=-1)

    u = p["pos_bias_u"].to(x.dtype)
    w = p["pos_bias_v"].to(x.dtype)
    # float32 score products of the activations' values
    ac = torch.einsum("bthd,bhsd->bhts", (q + u).float(), full_k.float())
    if pos_emb.dim() == 3:                                 # per-slot rows
        pp = linear(p["linear_pos"], pos_emb).reshape(B, -1, h, dk)
        bd = torch.einsum("bthd,bshd->bhts", (q + w).float(), pp.float())
    else:
        pp = linear(p["linear_pos"], pos_emb[None])[0].reshape(-1, h, dk)
        bd = torch.einsum("bthd,shd->bhts", (q + w).float(), pp.float())
    scores = (ac + bd) * (dk ** -0.5)
    kv = (key_valid[:, None, None, :] if key_valid.dim() == 2
          else key_valid[None, None, None, :])
    scores = scores.masked_fill(~kv, _NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.matmul(attn.to(full_v.dtype), full_v).to(x.dtype)
    out = linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, C, D))
    return out, new_cache


def _stream_conv(p, x: torch.Tensor, cnn_cache: torch.Tensor,
                 use_layer_norm: bool, lorder: int):
    """Causal conv module on a chunk with cached left context.
    x: (B, C, D); cnn_cache: (B, lorder, D), the module-input tail."""
    ext = torch.cat([cnn_cache, x], dim=1)                 # (B, lorder+C, D)
    new_cache = ext[:, ext.shape[1] - lorder:] if lorder > 0 else cnn_cache
    h = glu(linear(p["pointwise_conv1"], ext), dim=-1)
    h = depthwise_conv1d(p["depthwise_conv"], h, lorder=lorder)  # valid
    if use_layer_norm:
        h = layer_norm(p["norm"], h)
    else:
        h = h * p["norm"]["scale"].to(h.dtype) + p["norm"]["bias"].to(h.dtype)
    h = linear(p["pointwise_conv2"], swish(h))
    return h, new_cache


def _stream_block(bp, x, pos_emb, att_cache, cnn_cache, key_valid,
                  cfg: EncoderConfig, embed=None, moe: bool = False,
                  moe_impl: str = "dense"):
    ff_scale = 0.5 if cfg.macaron_style else 1.0
    lorder = cfg.cnn_module_kernel - 1
    if cfg.macaron_style:
        x = x + ff_scale * positionwise_ffn(
            bp["feed_forward_macaron"], layer_norm(bp["norm_ff_macaron"], x))
    h, new_att = _stream_rel_mha(bp["self_attn"],
                                 layer_norm(bp["norm_mha"], x), pos_emb,
                                 att_cache, key_valid, cfg.attention_heads)
    x = x + h
    if cfg.use_cnn_module:
        h, new_cnn = _stream_conv(
            bp["conv_module"], layer_norm(bp["norm_conv"], x), cnn_cache,
            cfg.cnn_module_norm == "layer_norm", lorder)
        x = x + h
    else:
        new_cnn = cnn_cache
    h = layer_norm(bp["norm_ff"], x)
    if moe:
        h = moe_ffn(bp["feed_forward"], h, embed, None, impl=moe_impl)
    else:
        h = positionwise_ffn(bp["feed_forward"], h)
    x = x + ff_scale * h
    if cfg.use_cnn_module:
        x = layer_norm(bp["norm_final"], x)
    return x, new_att, new_cnn


def _run_stream_blocks(blocks, cfg: EncoderConfig, x, pos_emb, key_valid,
                       state: StreamState, cache_T: int, **kw):
    """The block stack over per-layer views of the stacked parameters
    (the expert weights of a MoE block stay ``(L, E, ...)`` views: no
    copy). Returns (x, new att_cache, new cnn_cache)."""
    atts, cnns = [], []
    for i in range(conformer.num_layers(blocks)):
        x, att, cnn = _stream_block(conformer.layer_view(blocks, i), x,
                                    pos_emb, state.att_cache[i],
                                    state.cnn_cache[i], key_valid, cfg, **kw)
        atts.append(att[:, :, att.shape[2] - cache_T:])
        cnns.append(cnn)
    return x, torch.stack(atts), torch.stack(cnns)


def forward_chunk(params, cfg: EncoderConfig, chunk_feat: torch.Tensor,
                  state: StreamState):
    """One streaming step of the dense conformer encoder. chunk_feat:
    (B, W, input_dim) raw frames with the subsampling overlap (W = 4C + 3
    for C output frames; ``runtime/streaming_session.py`` keeps the
    overlap). Returns (logits (B, C, V), new state)."""
    cache_T = state.att_cache.shape[3]
    x, pos_emb, key_valid, C = _frontend_chunk(params, cfg, chunk_feat,
                                               state, cache_T)
    x, att, cnn = _run_stream_blocks(params["blocks"], cfg, x, pos_emb,
                                     key_valid, state, cache_T)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    out = linear(params["out_linear"], x)
    return out, StreamState(state.offset + C, att, cnn)


def forward_chunk_moe(params, cfg: MoEEncoderConfig,
                      chunk_feat: torch.Tensor, state: StreamState,
                      embed_state: StreamState, moe_impl: str = "dense"):
    """One streaming step of the hier MoE encoder: the embed sub-encoder
    streams in lock-step (its own caches) and its normalized chunk hidden
    feeds the routers. Returns (logits, new state, new embed state)."""
    if cfg.exmarc:
        raise NotImplementedError("the ExMarc (MoE macaron) variant is not "
                                  "ported (ROADMAP Queue 1 item 10)")
    e_cfg = cfg.embed_conf
    e_cache_T = embed_state.att_cache.shape[3]
    ex, e_pos, e_valid, C = _frontend_chunk(params["embed"], e_cfg,
                                            chunk_feat, embed_state,
                                            e_cache_T)
    ex, e_att, e_cnn = _run_stream_blocks(params["embed"]["blocks"], e_cfg,
                                          ex, e_pos, e_valid, embed_state,
                                          e_cache_T)
    embed = layer_norm(params["embed"]["after_norm"], ex)
    new_embed = StreamState(embed_state.offset + C, e_att, e_cnn)

    cache_T = state.att_cache.shape[3]
    x, pos_emb, key_valid, C = _frontend_chunk(params, cfg, chunk_feat,
                                               state, cache_T)
    x, att, cnn = _run_stream_blocks(params["blocks"], cfg, x, pos_emb,
                                     key_valid, state, cache_T, embed=embed,
                                     moe=True, moe_impl=moe_impl)
    if cfg.normalize_before:
        x = layer_norm(params["after_norm"], x)
    out = linear(params["out_linear"], x)
    return out, StreamState(state.offset + C, att, cnn), new_embed
