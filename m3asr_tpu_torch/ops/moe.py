"""Top-1 catEmbed MoE FFN (port of ``m3asr_tpu/ops/moe.py``).

Expert weights: w1 ``(E, d, h)``, w2 ``(E, h, d)`` (or their int8 /
packed int4 forms, ``ops/quant.py``); expert math
``y_e(x) = silu(x w1_e + b1_e) w2_e + b2_e``. Expert stages (``impl``),
with the JAX package's names:

* float weights: ``"dense"`` (every expert on every token, the oracle),
  the plain-PyTorch XLA paths ``"tiled"``, ``"ragged"``,
  ``"ragged_padded"`` and ``"capacity"``, and the kernels ``"runs_f"``
  (K1) and ``"pallas"`` (K8);
* quantized weights: the plain-PyTorch XLA paths ``"quant"``,
  ``"quant_a8"``, ``"quant_tiled"``, ``"quant_a8_tiled"`` and
  ``"quant_capacity"`` (``ops/quant.py``); the kernels
  ``"quant_runs"`` / ``"quant4_runs"`` (K4 / K5, by weight format),
  ``"quant_a8_runs"`` / ``"quant4_a8_runs"`` (the same with per-token
  int8 activations), ``"quant4_pallas"`` / ``"quant4_a8"`` (K6),
  ``"quant4_tiled"`` / ``"quant4_a8_tiled"`` (K7) and ``"quant_pallas"``
  (K6 on int4 weights, K8 on int8 weights).

Each kernel stage launches its CUDA kernel on the card and takes its
plain version on the CPU. The XLA-path stages round where the JAX
package's einsums with ``preferred_element_type=x.dtype`` round: every
product and bias add in x's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from m3asr_tpu_torch.ops.common import swish
from m3asr_tpu_torch.ops.masking import make_valid_mask
from m3asr_tpu_torch.ops import quant
from m3asr_tpu_torch.ops.moe_q4 import q4_kernel, q4_tiled_kernel
from m3asr_tpu_torch.ops.moe_runs import (_pad_tokens, _unpad, runs_for,
                                          runs_layout)
from m3asr_tpu_torch.ops.moe_stream import stream_kernel


def softmax_top1_gate(p, router_inputs: torch.Tensor,
                      lengths: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 router gate over ``cat([embed, x])`` features.

    Logits are float32 (the kernel cast to the input dtype first, as the
    JAX package does). gate value = softmax prob of the argmax =
    1 / sum(exp(logits - max)); idx = first argmax. Positions past the
    valid length get gate 0 / idx 0. Returns (gate (B,T,1) in the input
    dtype, idx int32 (B,T))."""
    kern = p["kernel"].to(router_inputs.dtype)
    logits = torch.matmul(router_inputs.float(), kern.float())
    if p.get("bias") is not None:
        logits = logits + p["bias"].float()
    m = logits.amax(dim=-1, keepdim=True)
    denom = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    gate_value = (1.0 / denom).to(router_inputs.dtype)
    gate_idx = torch.argmax(logits, dim=-1).to(torch.int32)
    if lengths is not None:
        valid = make_valid_mask(lengths, router_inputs.shape[1])
        gate_value = gate_value.masked_fill(~valid[..., None], 0.0)
        gate_idx = gate_idx.masked_fill(~valid, 0)
    return gate_value, gate_idx


def moe_experts_dense(p, x: torch.Tensor,
                      gate_idx: torch.Tensor) -> torch.Tensor:
    """Every expert computes every token; the gate index selects.
    x: (B, T, d); gate_idx: (B, T). The oracle for every expert kernel.

    Float32 arithmetic with the hidden and the output rounded to x's
    dtype: the rounding points of K1, so in bf16 the two differ only by
    summation order (bf16 products are exact in float32)."""
    cdt = x.dtype

    def f32(t):
        return t.to(cdt).float()

    h = torch.einsum("btd,edh->beth", x.float(), f32(p["w1"]))
    if p.get("b1") is not None:
        h = h + f32(p["b1"])[None, :, None, :]
    h = f32(swish(h))
    y = torch.einsum("beth,ehd->betd", h, f32(p["w2"]))
    if p.get("b2") is not None:
        y = y + f32(p["b2"])[None, :, None, :]
    idx = gate_idx.long()[:, None, :, None].expand(-1, 1, -1, y.shape[-1])
    return torch.gather(y, 1, idx)[:, 0].to(cdt)


# ---------------------------------------------------------------------------
# the XLA-path stages: plain PyTorch in x's dtype
# ---------------------------------------------------------------------------

def _hidden_act(h: torch.Tensor, activation, upper_bound) -> torch.Tensor:
    h = activation(h)
    if upper_bound is not None:       # the DFSMN expert's clamp
        h = torch.minimum(h, torch.tensor(upper_bound, dtype=h.dtype,
                                          device=h.device))
    return h


def _bias(p, name: str, dtype: torch.dtype, rows: torch.Tensor):
    """Bias ``name`` in ``dtype`` at the expert indices ``rows``, or
    None."""
    b = p.get(name)
    return None if b is None else b.to(dtype)[rows.long()]


def _ffn_rows(p, a: torch.Tensor, row_e: torch.Tensor, mm, activation,
              upper_bound) -> torch.Tensor:
    """``act(mm(a, w1) + b1) -> mm(., w2) + b2`` on rows ``a`` whose
    experts are ``row_e`` (the bias rows); ``mm(a, name)`` is the
    stage's grouped product."""
    h = mm(a, "w1")
    b1 = _bias(p, "b1", a.dtype, row_e)
    if b1 is not None:
        h = h + b1
    h = _hidden_act(h, activation, upper_bound)
    y = mm(h, "w2")
    b2 = _bias(p, "b2", a.dtype, row_e)
    return y if b2 is None else y + b2


def _ragged_dot(a: torch.Tensor, w: torch.Tensor,
                sizes: List[int]) -> torch.Tensor:
    """``lax.ragged_dot``: rows of ``a`` in consecutive groups of
    ``sizes[e]`` rows, group e times ``w[e]``; rows past the groups are
    zero."""
    out = a.new_zeros((a.shape[0], w.shape[-1]))
    r = 0
    for e, n in enumerate(sizes):
        if n:
            out[r:r + n] = a[r:r + n] @ w[e]
        r += n
    return out


def tiled_tokens(x: torch.Tensor, gate_idx: torch.Tensor, E: int,
                 tile: int, fill: float = 0.0):
    """The tiled stages' layout (``_tile_layout``) and x's rows (B, T, c)
    sorted by expert into ``(n_tiles, tile, c)`` tiles of one expert
    each; pad rows hold ``fill``."""
    c = x.shape[-1]
    lay = runs_layout(gate_idx.reshape(-1), E, tile)
    xt = _pad_tokens(x.reshape(-1, c), lay, tile, fill)
    return lay, xt.reshape(lay.n_tiles, tile, c)


def untile(y: torch.Tensor, lay, shape) -> torch.Tensor:
    """Tile outputs ``(n_tiles, tile, d)`` back to token order, as
    ``shape``; pad rows are dropped."""
    return _unpad(y.reshape(-1, y.shape[-1]), lay).reshape(shape)


def moe_experts_ragged(p, x: torch.Tensor, gate_idx: torch.Tensor,
                       activation=swish,
                       upper_bound: Optional[float] = None) -> torch.Tensor:
    """Sort-based grouped GEMM: tokens stably sorted by expert, one
    product per expert's group (``lax.ragged_dot`` as a loop over the
    groups, whose sizes the host reads: a device sync)."""
    B, T, d = x.shape
    E = p["w1"].shape[0]
    flat_x, flat_e = x.reshape(B * T, d), gate_idx.reshape(B * T).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sizes = torch.bincount(flat_e, minlength=E).tolist()

    def mm(a, name):
        return _ragged_dot(a, p[name].to(x.dtype), sizes)
    y = _ffn_rows(p, flat_x[order], sorted_e, mm, activation, upper_bound)
    out = torch.zeros_like(flat_x)
    out[order] = y
    return out.reshape(B, T, d)


def moe_experts_tiled(p, x: torch.Tensor, gate_idx: torch.Tensor,
                      tile: int = 128, activation=swish,
                      upper_bound: Optional[float] = None) -> torch.Tensor:
    """Skew-robust grouped GEMM (megablocks-style): each expert's group
    padded to a multiple of ``tile`` rows, a static tile count, one
    batched product with each tile's expert's weights gathered. Pad rows
    are zeros and never gathered back."""
    E = p["w1"].shape[0]
    lay, xt = tiled_tokens(x, gate_idx, E, tile)
    te = lay.tile_e.long()

    def mm(a, name):
        return torch.bmm(a, p[name].to(x.dtype)[te])
    y = _ffn_rows(p, xt, te[:, None], mm, activation, upper_bound)
    return untile(y, lay, x.shape)


def moe_experts_ragged_padded(p, x: torch.Tensor, gate_idx: torch.Tensor,
                              tile: int = 256, activation=swish,
                              upper_bound: Optional[float] = None
                              ) -> torch.Tensor:
    """The tiled layout run through ragged products: group sizes are the
    tile-padded counts, the static remainder added to the last group so
    that they cover the padded rows (a device sync, as the ragged
    stage)."""
    B, T, d = x.shape
    E = p["w1"].shape[0]
    lay = runs_layout(gate_idx.reshape(-1), E, tile)
    x_pad = _pad_tokens(x.reshape(B * T, d), lay, tile)
    sizes = (torch.diff(lay.starts.long()) * tile).tolist()
    sizes[-1] += lay.n_tiles * tile - sum(sizes)
    row_e = torch.repeat_interleave(
        torch.arange(E, device=x.device),
        torch.tensor(sizes, device=x.device))

    def mm(a, name):
        return _ragged_dot(a, p[name].to(x.dtype), sizes)
    y = _ffn_rows(p, x_pad, row_e, mm, activation, upper_bound)
    return _unpad(y, lay).reshape(B, T, d)


def _dense_in_dtype(p, x: torch.Tensor, gate_idx: torch.Tensor,
                    activation, upper_bound) -> torch.Tensor:
    """The JAX package's ``moe_experts_dense``: every expert on every
    token, products and bias adds in x's dtype (the capacity stage's
    overflow path)."""
    h = torch.einsum("btd,edh->beth", x, p["w1"].to(x.dtype))
    if p.get("b1") is not None:
        h = h + p["b1"].to(x.dtype)[None, :, None, :]
    h = _hidden_act(h, activation, upper_bound)
    y = torch.einsum("beth,ehd->betd", h, p["w2"].to(x.dtype))
    if p.get("b2") is not None:
        y = y + p["b2"].to(x.dtype)[None, :, None, :]
    return quant._select(y, gate_idx)


def moe_experts_capacity(p, x: torch.Tensor, gate_idx: torch.Tensor,
                         capacity: Optional[int] = None, activation=swish,
                         upper_bound: Optional[float] = None
                         ) -> torch.Tensor:
    """Capacity dispatch (GShard-style, exact): tokens gather into C slots
    per expert and run as one batched (E, C, d) product. C defaults to
    ``min(max(8, ceil8(4N/E)), N)``. If an expert overflows C, the
    dense stage runs instead (``lax.cond`` in the JAX package; here a
    Python branch on ``counts.max() <= C``, which reads the counts on
    the host: a device sync)."""
    B, T, d = x.shape
    E = p["w1"].shape[0]
    N = B * T
    C = capacity if capacity is not None else \
        min(max(8, (4 * N // E + 7) // 8 * 8), N)
    flat_x, flat_e = x.reshape(N, d), gate_idx.reshape(N).long()
    counts = torch.bincount(flat_e, minlength=E)
    if int(counts.max()) > C:
        return _dense_in_dtype(p, x, gate_idx, activation, upper_bound)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    offsets = torch.cumsum(counts, 0) - counts
    slot = sorted_e * C + torch.arange(N, device=x.device) \
        - offsets[sorted_e]
    x_cap = flat_x.new_zeros((E * C, d))
    x_cap[slot] = flat_x[order]

    def mm(a, name):
        return torch.bmm(a, p[name].to(x.dtype))
    y = _ffn_rows(p, x_cap.reshape(E, C, d),
                  torch.arange(E, device=x.device)[:, None], mm,
                  activation, upper_bound)
    out = torch.zeros_like(flat_x)
    out[order] = y.reshape(E * C, d)[slot]
    return out.reshape(B, T, d)


def _tile_layout(flat_e: torch.Tensor, N: int, E: int, tile: int):
    """The JAX package's megablocks-style layout contract: (order, slot,
    n_tiles, tile_e) — tokens sorted by expert, each expert's group
    padded to a multiple of ``tile``, one expert per tile."""
    if flat_e.shape[0] != N:
        raise ValueError(f"flat_e has {flat_e.shape[0]} tokens, not {N}")
    lay = runs_layout(flat_e, E, tile)
    return lay.order, lay.slot, lay.n_tiles, lay.tile_e


def _dispatch(p, x: torch.Tensor, gate_idx: torch.Tensor,
              impl: str) -> torch.Tensor:
    if impl == "dense":
        return moe_experts_dense(p, x, gate_idx)
    if impl == "ragged":
        return moe_experts_ragged(p, x, gate_idx)
    if impl == "tiled":
        return moe_experts_tiled(p, x, gate_idx)
    if impl == "ragged_padded":
        return moe_experts_ragged_padded(p, x, gate_idx)
    if impl == "capacity":
        return moe_experts_capacity(p, x, gate_idx)
    if impl == "pallas":
        return stream_kernel(p, x, gate_idx)
    if impl == "quant":
        return quant.moe_experts_dense_q(p, x, gate_idx)
    if impl == "quant_tiled":
        return quant.moe_experts_tiled_q(p, x, gate_idx)
    if impl == "quant_capacity":
        return quant.moe_experts_capacity_q(p, x, gate_idx)
    if impl == "quant_a8":
        return quant.moe_experts_dense_w8a8(p, x, gate_idx)
    if impl == "quant_a8_tiled":
        return quant.moe_experts_tiled_w8a8(p, x, gate_idx)
    if impl == "quant_pallas":
        if "w1_q4" in p:
            return q4_kernel(p, x, gate_idx)
        return stream_kernel(p, x, gate_idx)
    if impl in ("quant4_pallas", "quant4_a8"):
        return q4_kernel(p, x, gate_idx, act_quant=impl == "quant4_a8")
    if impl in ("quant4_tiled", "quant4_a8_tiled"):
        return q4_tiled_kernel(p, x, gate_idx,
                               act_quant=impl == "quant4_a8_tiled")
    if impl in ("runs_f", "quant_runs", "quant4_runs"):
        return runs_for(p)(p, x, gate_idx)
    if impl in ("quant_a8_runs", "quant4_a8_runs"):
        return runs_for(p)(p, x, gate_idx, act_quant=True)
    raise ValueError(f"unknown moe impl: {impl}")


def moe_ffn(p, x: torch.Tensor, embed: Optional[torch.Tensor],
            lengths: Optional[torch.Tensor],
            impl: str = "dense") -> torch.Tensor:
    """catEmbed top-1 MoE FFN: router(cat[embed, x]) -> gate -> expert
    FFN -> * gate value."""
    router_inputs = x if embed is None else torch.cat([embed, x], dim=-1)
    gate_value, gate_idx = softmax_top1_gate(p["router"], router_inputs,
                                             lengths)
    return _dispatch(p, x, gate_idx, impl) * gate_value
