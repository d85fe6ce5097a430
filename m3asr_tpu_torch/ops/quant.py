"""Int8 / int4 expert quantization, int8 dense-weight quantization, and
the dequantizing expert stages of the quantized engines (port of the
serving subset of ``m3asr_tpu/ops/quant.py``).

Quantization runs in numpy on the host, exactly as the JAX package does
it (``np.round`` is half-to-even), so both packages write the same bytes
for the same weights. Symmetric scales: int8 keeps one scale per
(expert, output column), ``(..., 1, out)``; int4 adds 128-row groups
along the contraction dim, ``(..., in/128, 1, out)``, and packs two
values per byte (:func:`pack_int4`). Scales are float32 everywhere.

The expert stages here are plain PyTorch on purpose: they are the JAX
package's XLA einsum paths (impls ``quant``, ``quant_a8``,
``quant_tiled``, ``quant_a8_tiled``, ``quant_capacity``), not Pallas
kernels, and round where those round.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from m3asr_tpu_torch.ops.common import swish

INT4_GROUP = 128  # contraction-dim scale group for int4 (AWQ layout)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int4 values (int8 storage, range [-8, 7]) two per byte along
    the LAST axis, concat-half layout: ``packed[..., j]`` holds column j
    in its low nibble and column ``j + out // 2`` in its high nibble."""
    out = q.shape[-1]
    if out % 2:
        raise ValueError(f"odd output dim {out} cannot nibble-pack")
    lo = q[..., : out // 2].astype(np.uint8) & 0xF
    hi = q[..., out // 2:].astype(np.uint8) & 0xF
    return ((hi << 4) | lo).astype(np.uint8).view(np.int8)


def unpack_int4(packed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., out//2) int8 -> (..., out)
    ``dtype``, sign-extending each nibble."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(dtype)


def _host_f32(w) -> np.ndarray:
    """A weight as a float32 numpy array on the host (a bf16 tensor
    widens exactly)."""
    if torch.is_tensor(w):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def quantize_tensor(w, axis: int = -2, bits: int = 8,
                    group_size: Optional[int] = None):
    """Symmetric quantization of ``w`` over the contraction dim ``axis``.

    bits=8: w (..., in, out) -> (q int8, scale (..., 1, out)).
    bits=4 with group_size g dividing ``in`` (and ``in > g``): q int4
    values in int8 storage (..., in, out), scale (..., in//g, 1, out);
    otherwise one whole-axis group (per-column scales)."""
    w = _host_f32(w)
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    if group_size is not None and w.shape[axis] % group_size == 0 \
            and w.shape[axis] > group_size:
        if axis not in (-2, w.ndim - 2):
            raise ValueError("grouping expects (..., in, out)")
        g = w.shape[-2] // group_size
        wg = w.reshape(w.shape[:-2] + (g, group_size, w.shape[-1]))
        amax = np.max(np.abs(wg), axis=-2, keepdims=True)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q = np.clip(np.round(wg / scale), -qmax, qmax)
        q = q.reshape(w.shape)
    else:
        amax = np.max(np.abs(w), axis=axis, keepdims=True)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q = np.clip(np.round(w / scale), -qmax, qmax)
    return q.astype(np.int8), scale


def quantize_moe_params(p, bits: int = 8,
                        group_size: Optional[int] = None) -> Dict:
    """Quantize the expert tensors ``w1``/``w2`` of a MoE param dict
    (numpy arrays or tensors, stacked ``(L, E, ...)`` or not); router
    and biases stay as they are. Returns a new dict whose quantized
    leaves are numpy: ``w*_q`` int8 (bits=8) or ``w*_q4`` packed int8
    (bits=4, INT4_GROUP-row groups by default), and ``w*_scale``
    float32."""
    if bits == 4 and group_size is None:
        group_size = INT4_GROUP
    q = dict(p)
    for name in ("w1", "w2"):
        qw, s = quantize_tensor(p[name], bits=bits, group_size=group_size)
        if bits == 4:
            q[name + "_q4"] = pack_int4(qw)
        else:
            q[name + "_q"] = qw
        q[name + "_scale"] = s
        q.pop(name)
    return q


# Param-tree nodes whose "kernel" is not a matmul weight read by
# ops.common.linear, or is small and accuracy-critical: the MoE router
# (its logits feed an argmax), the depthwise conv kernel, the
# subsampling conv stacks, the positional table.
DENSE_QUANT_EXCLUDE = ("router", "depthwise_conv", "conv0", "conv1",
                       "conv2", "pos_enc")


def quantize_dense_params(tree, min_size: int = 256,
                          exclude=DENSE_QUANT_EXCLUDE):
    """Weight-only int8 for the dense (non-expert) weights: every dict
    holding a ``kernel`` of at least 2 dims and ``min_size`` values, and
    not under a node named in ``exclude``, gets ``kernel_q`` int8 and
    ``kernel_scale`` float32 per output column instead (``(1, out)``, or
    ``(L, 1, out)`` for stacked ``(L, in, out)`` kernels). Biases and
    norms stay as they are. Returns a new tree whose new leaves are
    numpy; the bytes are the JAX package's."""
    def walk(node, name):
        if isinstance(node, dict):
            if name in exclude:
                return node
            node = {k: walk(v, k) for k, v in node.items()}
            k = node.get("kernel")
            if k is not None and k.ndim >= 2 and int(np.prod(k.shape)) \
                    >= min_size:
                q, s = quantize_tensor(k)
                node.pop("kernel")
                node["kernel_q"], node["kernel_scale"] = q, s
            return node
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(tree, "")


def dequantize_dense_params(tree, dtype: torch.dtype = torch.bfloat16):
    """Inverse of :func:`quantize_dense_params`: ``kernel = (kernel_q *
    kernel_scale)`` in float32, rounded to ``dtype`` (bfloat16, the
    quantized engines' activation type, by default)."""
    def walk(node):
        if isinstance(node, dict):
            node = {k: walk(v) for k, v in node.items()}
            if "kernel_q" in node:
                q = torch.as_tensor(node.pop("kernel_q"))
                s = torch.as_tensor(node.pop("kernel_scale"))
                node["kernel"] = (q.float() * s.float()).to(dtype)
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


def _apply_scale(qf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """qf (..., in, out) * scale in qf's dtype; scale is (..., 1, out)
    (per column) or (..., G, 1, out) (group-wise)."""
    if s.dim() == qf.dim() + 1:
        g, gs = s.shape[-3], qf.shape[-2] // s.shape[-3]
        wg = qf.reshape(qf.shape[:-2] + (g, gs, qf.shape[-1]))
        return (wg * s.to(qf.dtype)).reshape(qf.shape)
    return qf * s.to(qf.dtype)


def _deq(p, name: str, dtype: torch.dtype) -> torch.Tensor:
    q4 = p.get(name + "_q4")
    if q4 is not None:
        return _apply_scale(unpack_int4(q4, dtype), p[name + "_scale"])
    return _apply_scale(p[name + "_q"].to(dtype), p[name + "_scale"])


def _gather_deq(p, name: str, tile_e: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The tiled stages' per-tile weights: each tile's expert's quantized
    bytes gathered (packed for int4), then unpacked and scaled in
    ``dtype``. Returns (n_tiles, in, out)."""
    idx = tile_e.long()
    q4 = p.get(name + "_q4")
    if q4 is not None:
        qg = unpack_int4(q4[idx], dtype)
    else:
        qg = p[name + "_q"][idx].to(dtype)
    return _apply_scale(qg, p[name + "_scale"][idx])


def _select(y: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
    """y (B, E, T, d) -> (B, T, d) at each token's expert."""
    idx = gate_idx.long()[:, None, :, None].expand(-1, 1, -1, y.shape[-1])
    return torch.gather(y, 1, idx)[:, 0]


def moe_experts_dense_q(p, x: torch.Tensor,
                        gate_idx: torch.Tensor) -> torch.Tensor:
    """Impl ``quant``: every expert on every token, on int8 or packed
    int4 weights dequantized in x's dtype (``q.to(dtype) * s.to(dtype)``,
    as the JAX package rounds them); both products and the bias adds run
    in x's dtype. x: (B, T, d); gate_idx: (B, T)."""
    w1 = _deq(p, "w1", x.dtype)
    w2 = _deq(p, "w2", x.dtype)
    h = torch.einsum("btd,edh->beth", x, w1)
    if p.get("b1") is not None:
        h = h + p["b1"].to(x.dtype)[None, :, None, :]
    h = swish(h)
    y = torch.einsum("beth,ehd->betd", h, w2)
    if p.get("b2") is not None:
        y = y + p["b2"].to(x.dtype)[None, :, None, :]
    return _select(y, gate_idx)


def moe_experts_capacity_q(p, x: torch.Tensor,
                           gate_idx: torch.Tensor) -> torch.Tensor:
    """Impl ``quant_capacity``: the capacity stage
    (``ops/moe.py::moe_experts_capacity``) on int8 or packed int4
    weights dequantized in x's dtype."""
    from m3asr_tpu_torch.ops.moe import moe_experts_capacity
    deq = dict(p, w1=_deq(p, "w1", x.dtype), w2=_deq(p, "w2", x.dtype))
    return moe_experts_capacity(deq, x, gate_idx)


def moe_experts_tiled_q(p, x: torch.Tensor, gate_idx: torch.Tensor,
                        tile: int = 128) -> torch.Tensor:
    """Impl ``quant_tiled``: the tiled grouped GEMM
    (``ops/moe.py::moe_experts_tiled``) on int8 or packed int4 weights,
    each tile's expert gathered quantized and dequantized in x's dtype
    (:func:`_gather_deq`); products and bias adds in x's dtype."""
    from m3asr_tpu_torch.ops.moe import tiled_tokens, untile
    E = next(p[k] for k in ("w1_q4", "w1_q") if k in p).shape[0]
    lay, xt = tiled_tokens(x, gate_idx, E, tile)
    te = lay.tile_e.long()
    h = torch.bmm(xt, _gather_deq(p, "w1", lay.tile_e, x.dtype))
    if p.get("b1") is not None:
        h = h + p["b1"].to(x.dtype)[te][:, None, :]
    h = swish(h)
    y = torch.bmm(h, _gather_deq(p, "w2", lay.tile_e, x.dtype))
    if p.get("b2") is not None:
        y = y + p["b2"].to(x.dtype)[te][:, None, :]
    return untile(y, lay, x.shape)


def quantize_act(x: torch.Tensor, qmax: float = 127.0):
    """Per-token symmetric int8 quantization, as the JAX package's XLA
    path does it: the scale ``amax / qmax`` is taken in x's dtype and
    the division ``x / scale`` too. x (..., d) -> (q int8, scale (..., 1)
    float32)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / qmax, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x / s.to(x.dtype)), -qmax, qmax)
    return q.to(torch.int8), s


def _int_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An s8 x s8 contraction summed in float32. Every product and every
    partial sum is an integer below 127^2 * K, so for contractions up to
    K = 1040 (127^2 * 1040 < 2^24, which covers d=512 and h=1024) the
    float32 sum is exact in any order. TF32 would round the operands'
    products, so it must be off."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the w8a8 product is summed in float32 and needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if a.shape[-1] > 1040:
        raise ValueError(f"contraction {a.shape[-1]} > 1040: the float32 "
                         "sum of s8 products is no longer exact")
    return torch.einsum(eq, a.float(), b.float())


def moe_experts_dense_w8a8(p, x: torch.Tensor,
                           gate_idx: torch.Tensor) -> torch.Tensor:
    """Impl ``quant_a8``: every expert on every token with int8 weights
    AND per-token int8 activations; each s8 x s8 product is rescaled per
    token x per output column in float32, then rounded to x's dtype,
    where the bias, SiLU and the hidden's quantization run."""
    if "w1_q" not in p or p["w1_q"].dtype != torch.int8:
        raise ValueError("w8a8 needs int8 expert weights")
    out_dtype = x.dtype
    xq, xs = quantize_act(x)                         # (B,T,d), (B,T,1)
    h32 = _int_product("btd,edh->beth", xq, p["w1_q"])
    h = (h32 * xs[:, None, :, :] * p["w1_scale"][None]).to(out_dtype)
    if p.get("b1") is not None:
        h = h + p["b1"].to(out_dtype)[None, :, None, :]
    h = swish(h)
    hq, hs = quantize_act(h)                         # (B,E,T,H)
    y32 = _int_product("beth,ehd->betd", hq, p["w2_q"])
    y = (y32 * hs * p["w2_scale"][None]).to(out_dtype)
    if p.get("b2") is not None:
        y = y + p["b2"].to(out_dtype)[None, :, None, :]
    return _select(y, gate_idx)


def moe_experts_tiled_w8a8(p, x: torch.Tensor, gate_idx: torch.Tensor,
                           tile: int = 128) -> torch.Tensor:
    """Impl ``quant_a8_tiled``: the tiled grouped GEMM with int8 weights
    and per-token int8 activations (quantized in x's dtype, as
    ``quant_a8``); each tile's s8 x s8 sums rescaled by the token and
    column scales in float32, then rounded to x's dtype. Pad rows carry
    activation scale 1."""
    from m3asr_tpu_torch.ops.moe import tiled_tokens, untile
    if "w1_q" not in p or p["w1_q"].dtype != torch.int8:
        raise ValueError("w8a8 needs int8 expert weights")
    out_dtype = x.dtype
    E = p["w1_q"].shape[0]
    xq, xs = quantize_act(x)
    lay, xt = tiled_tokens(xq, gate_idx, E, tile)
    _, st = tiled_tokens(xs, gate_idx, E, tile, fill=1.0)
    te = lay.tile_e.long()
    h32 = _int_product("gtd,gdh->gth", xt, p["w1_q"][te])
    h = (h32 * st * p["w1_scale"][te]).to(out_dtype)
    if p.get("b1") is not None:
        h = h + p["b1"].to(out_dtype)[te][:, None, :]
    h = swish(h)
    hq, hs = quantize_act(h)
    y32 = _int_product("gth,ghd->gtd", hq, p["w2_q"][te])
    y = (y32 * hs * p["w2_scale"][te]).to(out_dtype)
    if p.get("b2") is not None:
        y = y + p["b2"].to(out_dtype)[te][:, None, :]
    return untile(y, lay, x.shape)
