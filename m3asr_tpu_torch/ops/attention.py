"""Relative-position multi-head self-attention (port of
``m3asr_tpu/ops/attention.py``, the separate q/k/v path).

Scores and the softmax run in float32 even for bf16 activations, as in
the JAX package (``preferred_element_type=float32`` there): bf16 operands
are widened to float32 before the score products, which is exact for
the products themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.ops.common import linear
from m3asr_tpu_torch.ops.masking import make_valid_mask

_NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, lengths: Optional[torch.Tensor],
                   scale: float, mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """softmax(scale * scores) over keys, keys >= length masked out.

    scores: (B, H, T1, T2); lengths: (B,) or None; mask: optional bool
    attend-mask broadcastable to scores. With a mask, rows that attend
    to nothing are zeroed (a -1e30 fill alone would give a uniform row).
    """
    s = scores.float() * scale
    valid = None
    if lengths is not None:
        valid = make_valid_mask(lengths, scores.shape[-1])[:, None, None, :]
        s = s.masked_fill(~valid, _NEG_INF)
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    out = torch.softmax(s, dim=-1)
    if mask is not None:
        any_valid = mask.any(dim=-1, keepdim=True)
        if valid is not None:
            any_valid = any_valid & valid.any(dim=-1, keepdim=True)
        out = torch.where(any_valid, out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return out.to(scores.dtype)


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dk)."""
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)


def rel_mha(p, x: torch.Tensor, pos_emb: torch.Tensor,
            lengths: Optional[torch.Tensor], num_heads: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformer-XL relative-position self-attention:

        ac = (q + pos_bias_u) k^T,  bd = (q + pos_bias_v) linear_pos(pos)^T
        out = linear_out(masked_softmax((ac + bd) / sqrt(d_k)) v)

    x: (B, T, D); pos_emb: (T, D); mask: optional bool attend-mask
    broadcastable to (B, H, T, T) (chunk masks, ``(B, 1, T, T)``).
    Returns (B, T, D)."""
    h = num_heads
    q = _split_heads(linear(p["linear_q"], x), h)            # (B,H,T,Dk)
    k = _split_heads(linear(p["linear_k"], x), h)
    v = _split_heads(linear(p["linear_v"], x), h)
    pp = _split_heads(linear(p["linear_pos"], pos_emb[None]), h)[0]
    u = p["pos_bias_u"].to(x.dtype)[None, :, None, :]         # (1,H,1,Dk)
    w = p["pos_bias_v"].to(x.dtype)[None, :, None, :]
    d_k = q.shape[-1]
    ac = torch.matmul((q + u).float(), k.float().transpose(-1, -2))
    bd = torch.matmul((q + w).float(), pp.float().transpose(-1, -2))
    attn = masked_softmax(ac + bd, lengths, float(d_k) ** -0.5, mask)
    ctx = torch.matmul(attn.to(v.dtype), v)                  # (B,H,T,Dk)
    B, T = x.shape[:2]
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, -1))
