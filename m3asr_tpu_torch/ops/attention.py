"""Relative-position multi-head self-attention (port of
``m3asr_tpu/ops/attention.py``): separate q/k/v projections, or the
fused form of ``fuse_qkv`` engines (one ``(D, 3D)`` ``linear_qkv``
projection and one score product over ``[q+u; q+v] . [k; pos]``).

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


def _qkv(p, x: torch.Tensor, h: int):
    """q, k, v as (B, H, T, Dk): one fused ``linear_qkv`` product split in
    three when the params carry it, else three ``(D, D)`` products."""
    if "linear_qkv" in p:
        q, k, v = torch.chunk(linear(p["linear_qkv"], x), 3, dim=-1)
        return _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    return tuple(_split_heads(linear(p[name], x), h)
                 for name in ("linear_q", "linear_k", "linear_v"))


def rel_mha(p, x: torch.Tensor, pos_emb: torch.Tensor,
            lengths: Optional[torch.Tensor], num_heads: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformer-XL relative-position self-attention:

        ac = (q + pos_bias_u) k^T,  bd = (q + pos_bias_v) linear_pos(pos)^T
        out = linear_out(masked_softmax((ac + bd) / sqrt(d_k)) v)

    With fused params (``linear_qkv``) the two score products are one,
    ``[q+u; q+v] . [k; pos]`` over a 2*Dk contraction.
    x: (B, T, D); pos_emb: (T, D); mask: optional bool attend-mask
    broadcastable to (B, H, T, T) (chunk masks, ``(B, 1, T, T)``).
    Returns (B, T, D)."""
    h = num_heads
    q, k, v = _qkv(p, x, h)                                  # (B,H,T,Dk)
    pp = _split_heads(linear(p["linear_pos"], pos_emb[None]), h)[0]
    u = p["pos_bias_u"].to(x.dtype)[None, :, None, :]         # (1,H,1,Dk)
    w = p["pos_bias_v"].to(x.dtype)[None, :, None, :]
    d_k = q.shape[-1]
    if "linear_qkv" in p:
        q2 = torch.cat([q + u, q + w], dim=-1)               # (B,H,T,2Dk)
        kp = torch.cat([k, pp[None].expand_as(k)], dim=-1)
        scores = torch.matmul(q2.float(), kp.float().transpose(-1, -2))
    else:
        ac = torch.matmul((q + u).float(), k.float().transpose(-1, -2))
        bd = torch.matmul((q + w).float(), pp.float().transpose(-1, -2))
        scores = ac + bd
    attn = masked_softmax(scores, lengths, float(d_k) ** -0.5, mask)
    ctx = torch.matmul(attn.to(v.dtype), v)                  # (B,H,T,Dk)
    B, T = x.shape[:2]
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, -1))


def fuse_qkv_params(tree):
    """Fold every node named ``self_attn``'s linear_q/k/v into one ``(in,
    3*out)`` ``linear_qkv`` (kernels and biases concatenated on the
    output axis; stacked ``(L, in, out)`` kernels too). Nodes already
    fused, or holding dense-quant ``kernel_q`` leaves, stay as they are.
    Returns a new tree."""
    def walk(node, name):
        if isinstance(node, dict):
            node = {k: walk(v, k) for k, v in node.items()}
            if name == "self_attn" and "kernel" in node.get("linear_q", {}):
                parts = [node.pop(n)
                         for n in ("linear_q", "linear_k", "linear_v")]
                node["linear_qkv"] = {
                    key: torch.cat([torch.as_tensor(q[key]) for q in parts],
                                   dim=-1) for key in ("kernel", "bias")}
            return node
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(tree, "")


def defuse_qkv_params(tree):
    """Inverse of :func:`fuse_qkv_params`: ``linear_qkv`` split back into
    linear_q/k/v (exact: the fusion is a concatenation)."""
    def walk(node):
        if isinstance(node, dict):
            node = {k: walk(v) for k, v in node.items()}
            if "linear_qkv" in node:
                fused = node.pop("linear_qkv")
                ks = torch.chunk(torch.as_tensor(fused["kernel"]), 3, dim=-1)
                bs = torch.chunk(torch.as_tensor(fused["bias"]), 3, dim=-1)
                for i, n in enumerate(("linear_q", "linear_k", "linear_v")):
                    node[n] = {"kernel": ks[i].contiguous(),
                               "bias": bs[i].contiguous()}
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)
