"""Top-1 catEmbed MoE FFN (port of the main-path subset of
``m3asr_tpu/ops/moe.py``).

Expert weights: w1 ``(E, d, h)``, w2 ``(E, h, d)`` (or their int8 /
packed int4 forms, ``ops/quant.py``); expert math
``y_e(x) = silu(x w1_e + b1_e) w2_e + b2_e``. Expert stages (``impl``),
with the JAX package's names:

* float weights: ``"dense"`` (every expert on every token, the oracle)
  and ``"runs_f"`` (K1);
* quantized weights: ``"quant"`` / ``"quant_a8"`` (every expert on
  every token in plain PyTorch, the JAX package's XLA paths),
  ``"quant_runs"`` / ``"quant4_runs"`` (K4 / K5, by weight format),
  ``"quant_a8_runs"`` / ``"quant4_a8_runs"`` (the same with per-token
  int8 activations), ``"quant4_pallas"`` / ``"quant4_a8"`` (K6).

Each kernel stage launches its CUDA kernel on the card and takes its
plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from m3asr_tpu_torch.ops.common import swish
from m3asr_tpu_torch.ops.masking import make_valid_mask
from m3asr_tpu_torch.ops import quant
from m3asr_tpu_torch.ops.moe_q4 import q4_kernel
from m3asr_tpu_torch.ops.moe_runs import runs_for, runs_layout


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
    if impl == "quant":
        return quant.moe_experts_dense_q(p, x, gate_idx)
    if impl == "quant_a8":
        return quant.moe_experts_dense_w8a8(p, x, gate_idx)
    if impl in ("runs_f", "quant_runs", "quant4_runs"):
        return runs_for(p)(p, x, gate_idx)
    if impl in ("quant_a8_runs", "quant4_a8_runs"):
        return runs_for(p)(p, x, gate_idx, act_quant=True)
    if impl in ("quant4_pallas", "quant4_a8"):
        return q4_kernel(p, x, gate_idx, act_quant=impl == "quant4_a8")
    raise NotImplementedError(
        f"moe impl {impl!r} is not ported yet (ROADMAP Queue 1 item 6b "
        "brings the tiled, ragged, capacity and streamer impls)")


def moe_ffn(p, x: torch.Tensor, embed: Optional[torch.Tensor],
            lengths: Optional[torch.Tensor],
            impl: str = "dense") -> torch.Tensor:
    """catEmbed top-1 MoE FFN: router(cat[embed, x]) -> gate -> expert
    FFN -> * gate value."""
    router_inputs = x if embed is None else torch.cat([embed, x], dim=-1)
    gate_value, gate_idx = softmax_top1_gate(p["router"], router_inputs,
                                             lengths)
    return _dispatch(p, x, gate_idx, impl) * gate_value
