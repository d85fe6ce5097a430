"""Multi-head attention (port of ``m3asr_tpu/ops/attention.py``): the
encoders' relative-position self-attention, with separate q/k/v
projections or the fused form of ``fuse_qkv`` engines (one ``(D, 3D)``
``linear_qkv`` projection and one score product over
``[q+u; q+v] . [k; pos]``), and the AED decoders' plain self- and
cross-attention (:func:`mha`).

Scores and the softmax run in float32 even for bf16 activations, as in
the JAX package (``preferred_element_type=float32`` there): bf16 operands
are widened to float32 before the score products, which is exact for
the products themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from m3asr_tpu_torch.ops.common import init_linear, linear, row_parallel_linear
from m3asr_tpu_torch.ops.masking import make_valid_mask
from m3asr_tpu_torch.parallel import mesh as pmesh

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


def project_kv(p, key: torch.Tensor, value: torch.Tensor,
               num_heads: int):
    """The key and value heads of :func:`mha`, (B, H, T2, Dk) each: what
    :func:`attend` takes, so that a memory attended many times (the AED
    beam search's steps) is projected once."""
    return (_split_heads(linear(p["linear_k"], key), num_heads),
            _split_heads(linear(p["linear_v"], value), num_heads))


def _attend_heads(p, q, k, v, lengths, mask):
    B, _, T, d_k = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = masked_softmax(scores, lengths, float(d_k) ** -0.5, mask)
    ctx = torch.matmul(attn.to(v.dtype), v)                  # (B,H,T1,Dk)
    return row_parallel_linear(p["linear_out"],
                               ctx.transpose(1, 2).reshape(B, T, -1))


def attend(p, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: Optional[torch.Tensor], num_heads: int,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mha` of ``query`` over key/value heads from
    :func:`project_kv`."""
    q = _split_heads(linear(p["linear_q"], query), num_heads)
    return _attend_heads(p, q, k, v, lengths, mask)


def mha(p, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        lengths: Optional[torch.Tensor], num_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scaled-dot-product attention of ``query`` (B, T1, D) over
    ``key`` / ``value`` (B, T2, D): the AED decoder's self-attention
    (query is key is value) and its cross-attention on the encoder
    memory. ``lengths`` masks keys >= length; ``mask`` is an optional
    bool attend-mask broadcastable to (B, H, T1, T2). Scores and softmax
    in float32. Returns (B, T1, D)."""
    if query is key and key is value:
        return _attend_heads(p, *_qkv(p, query, num_heads), lengths, mask)
    return attend(p, query, *project_kv(p, key, value, num_heads), lengths,
                  num_heads, mask)


def init_mha(generator: torch.Generator, d_model: int,
             dtype: torch.dtype = torch.float32):
    """Random linear_q/k/v/out of :func:`mha` (torch.nn.Linear's init),
    drawn on ``generator``'s device."""
    return {name: init_linear(generator, d_model, d_model, dtype=dtype)
            for name in ("linear_q", "linear_k", "linear_v", "linear_out")}


def rel_mha(p, x: torch.Tensor, pos_emb: torch.Tensor,
            lengths: Optional[torch.Tensor], num_heads: int,
            mask: Optional[torch.Tensor] = None,
            kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformer-XL relative-position self-attention:

        ac = (q + pos_bias_u) k^T,  bd = (q + pos_bias_v) linear_pos(pos)^T
        out = linear_out(masked_softmax((ac + bd) / sqrt(d_k)) v)

    With fused params (``linear_qkv``) the two score products are one,
    ``[q+u; q+v] . [k; pos]`` over a 2*Dk contraction.
    x: (B, T, D); pos_emb: (T, D); mask: optional bool attend-mask
    broadcastable to (B, H, T, T) (chunk masks, ``(B, 1, T, T)``).
    Returns (B, T, D).

    Under a tp mesh (``parallel/mesh.py``) the weights are this rank's
    heads: q/k/v/pos columns and pos_bias_u/v split by heads (the local
    head count is the biases'), linear_out's rows split, its partial
    product summed over "tp" before the bias.

    ``kv``: the keys' and values' input (B, S, D) when it is not x (under
    sp, x's rows are this rank's and kv is the gathered hidden; pos_emb
    and the lengths are then S long, the mask (B|1, 1, T, S))."""
    h = p["pos_bias_u"].shape[0] if "pos_bias_u" in p else num_heads
    x = pmesh.into(x, "tp")
    if kv is None:
        q, k, v = _qkv(p, x, h)                              # (B,H,T,Dk)
    else:
        q = _split_heads(linear(p["linear_q"], x), h)
        k, v = project_kv(p, *(pmesh.into(kv, "tp"),) * 2, h)
    pos_emb = pmesh.into(pos_emb, "tp")
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
    return row_parallel_linear(p["linear_out"],
                               ctx.transpose(1, 2).reshape(B, T, -1))


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
