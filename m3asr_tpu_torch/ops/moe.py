"""catEmbed MoE FFN (port of ``m3asr_tpu/ops/moe.py``): the deployed
top-1 softmax gate, and fastmoe's top-k gates (:func:`naive_topk_gate`,
:func:`noisy_topk_gate`) for ``moe_ffn(top_k > 1)``.

Expert weights: w1 ``(E, d, h)``, w2 ``(E, h, d)`` (or their int8 /
packed int4 forms, ``ops/quant.py``); expert math
``y_e(x) = act(x w1_e + b1_e) w2_e + b2_e``, ``act`` SiLU for the
conformer experts and ReLU clamped at ``upper_bound`` for the DFSMN
experts (``activation``, ``upper_bound``). Expert stages (``impl``),
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

import math
from typing import List, Optional, Tuple

import torch

from m3asr_tpu_torch.ops.common import activation_fn, activation_name, swish
from m3asr_tpu_torch.ops.masking import make_valid_mask
from m3asr_tpu_torch.ops import quant
from m3asr_tpu_torch.ops.moe_q4 import q4_kernel, q4_tiled_kernel
from m3asr_tpu_torch.ops.moe_runs import (_pad_tokens, _unpad, runs_for,
                                          runs_layout)
from m3asr_tpu_torch.ops.moe_stream import stream_kernel
from m3asr_tpu_torch.parallel import mesh as pmesh

# The stages that read group sizes on the host (a device sync), which a
# CUDA graph cannot capture: ``ragged`` and ``ragged_padded`` size each
# expert's product from counts read with ``.tolist()``; ``capacity`` and
# ``quant_capacity`` (capacity on dequantized weights) branch to the
# dense stage on ``counts.max() > C``. Engines run these eager and do not
# export them.
HOST_SYNC_STAGES = frozenset({"ragged", "ragged_padded", "capacity",
                              "quant_capacity"})


def _router_logits(p, router_inputs: torch.Tensor) -> torch.Tensor:
    """float32 router logits; the kernel is cast to the input dtype
    first, as the JAX package casts it."""
    kern = p["kernel"].to(router_inputs.dtype)
    logits = torch.matmul(router_inputs.float(), kern.float())
    if p.get("bias") is not None:
        logits = logits + p["bias"].float()
    return logits


def router_probs(p, router_inputs: torch.Tensor) -> torch.Tensor:
    """The router's full softmax over the experts, float32 (E last)."""
    return torch.softmax(_router_logits(p, router_inputs), dim=-1)


def softmax_top1_gate(p, router_inputs: torch.Tensor,
                      lengths: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 router gate over ``cat([embed, x])`` features.

    Logits are float32 (the kernel cast to the input dtype first, as the
    JAX package does). gate value = softmax prob of the argmax =
    1 / sum(exp(logits - max)); idx = first argmax. Positions past the
    valid length get gate 0 / idx 0. Returns (gate (B,T,1) in the input
    dtype, idx int32 (B,T))."""
    logits = _router_logits(p, router_inputs)
    m = logits.amax(dim=-1, keepdim=True)
    denom = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    gate_value = (1.0 / denom).to(router_inputs.dtype)
    gate_idx = torch.argmax(logits, dim=-1).to(torch.int32)
    if lengths is not None:
        valid = make_valid_mask(lengths, router_inputs.shape[1])
        gate_value = gate_value.masked_fill(~valid[..., None], 0.0)
        gate_idx = gate_idx.masked_fill(~valid, 0)
    return gate_value, gate_idx


def naive_topk_gate(p, x: torch.Tensor, top_k: int,
                    lengths: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fastmoe's NaiveGate: float32 logits -> top-k -> softmax over the k
    chosen, in x's dtype. Positions past the valid length get gate 0 and
    index 0. Returns (gate (B, T, k), idx int32 (B, T, k))."""
    vals, idx = _topk(_router_logits(p, x), top_k)
    gate = torch.softmax(vals, dim=-1).to(x.dtype)
    return _mask_topk(gate, idx, lengths)


def noisy_topk_gate(p, x: torch.Tensor, top_k: int,
                    generator: Optional[torch.Generator] = None,
                    lengths: Optional[torch.Tensor] = None,
                    train: bool = True, noise: Optional[torch.Tensor] = None):
    """fastmoe's NoisyGate: clean logits plus gaussian noise scaled by
    ``softplus(x noise_kernel) + 1e-2`` (train only) -> top-k -> softmax
    over the k chosen. The noise is drawn from ``generator`` (where the
    JAX package takes a key), or given as ``noise`` (B, T, E). Returns
    (gate (B, T, k), idx int32 (B, T, k), cv2): cv2 is the CV^2 of each
    expert's summed gate over the valid tokens, the load-balance aux
    loss. In eval mode the gate equals :func:`naive_topk_gate` (without
    a router bias)."""
    clean = _router_logits({"kernel": p["kernel"]}, x)
    logits = clean
    if train:
        raw = _router_logits({"kernel": p["noise_kernel"]}, x)
        std = torch.nn.functional.softplus(raw) + 1e-2
        if noise is None:
            noise = torch.randn(clean.shape, generator=generator,
                                device=clean.device)
        logits = clean + noise.float() * std
    vals, idx = _topk(logits, top_k)
    gate = torch.softmax(vals, dim=-1).to(x.dtype)
    gate, idx = _mask_topk(gate, idx, lengths)
    E = clean.shape[-1]
    onehot = torch.nn.functional.one_hot(idx.long(), E).float()
    if lengths is not None:
        valid = make_valid_mask(lengths, x.shape[1])
        onehot = onehot * valid[..., None, None]
    importance = (onehot * gate.float()[..., None]).sum(dim=(0, 1, 2))
    cv2 = importance.var(unbiased=False) / (importance.mean() ** 2 + 1e-10)
    return gate, idx, cv2


def _topk(logits: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort: torch.topk leaves the order of ties open), idx
    int32."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _mask_topk(gate, idx, lengths):
    if lengths is None:
        return gate, idx
    valid = make_valid_mask(lengths, gate.shape[1])[..., None]
    return gate.masked_fill(~valid, 0.0), idx.masked_fill(~valid, 0)


def moe_experts_dense(p, x: torch.Tensor, gate_idx: torch.Tensor,
                      activation=swish,
                      upper_bound: Optional[float] = None) -> torch.Tensor:
    """Every expert computes every token; the gate index selects.
    x: (B, T, d); gate_idx: (B, T). The oracle for every expert kernel.

    Float32 arithmetic with the hidden and the output rounded to x's
    dtype: the rounding points of K1, so in bf16 the two differ only by
    summation order (bf16 products are exact in float32). The activation
    and the clamp at ``upper_bound`` run in float32, before the hidden is
    rounded, as in K1."""
    cdt = x.dtype

    def f32(t):
        return t.to(cdt).float()

    h = torch.einsum("btd,edh->beth", x.float(), f32(p["w1"]))
    if p.get("b1") is not None:
        h = h + f32(p["b1"])[None, :, None, :]
    h = activation_fn(activation)(h)
    if upper_bound is not None:
        h = torch.clamp(h, max=upper_bound)
    h = f32(h)
    y = torch.einsum("beth,ehd->betd", h, f32(p["w2"]))
    if p.get("b2") is not None:
        y = y + f32(p["b2"])[None, :, None, :]
    idx = gate_idx.long()[:, None, :, None].expand(-1, 1, -1, y.shape[-1])
    return torch.gather(y, 1, idx)[:, 0].to(cdt)


# ---------------------------------------------------------------------------
# the XLA-path stages: plain PyTorch in x's dtype
# ---------------------------------------------------------------------------

def _hidden_act(h: torch.Tensor, activation, upper_bound) -> torch.Tensor:
    h = activation_fn(activation)(h)
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


# The stages a sharded engine runs (the JAX engine's mesh policy: the
# dense einsums split cleanly over the expert and hidden axes)
MESH_STAGES = ("dense", "quant", "quant_a8")


def _num_experts(p) -> int:
    return next(p[k] for k in ("w1", "w1_q", "w1_q4", "w1_q4c")
                if k in p).shape[0]


def _dispatch_on_mesh(mesh, p, x: torch.Tensor, gate_idx: torch.Tensor,
                      impl: str, act) -> torch.Tensor:
    """Stage ``impl`` on this rank's shard of the experts (the
    ``param_sharding`` layout), summed over the ep x tp ranks: over "ep"
    the rank holds experts [r*E_local, (r+1)*E_local), maps the global
    ids into its slice and gives the other tokens 0; over "tp" it holds
    a slice of each expert's hidden (w1/b1 columns, w2 rows) and only
    tp rank 0 adds b2, so the sum adds it once."""
    if impl not in MESH_STAGES:
        raise ValueError(f"moe impl {impl!r} has no sharded form: a "
                         f"sharded engine runs {MESH_STAGES}")
    idx, keep = gate_idx, None
    if mesh.axis_size("ep") > 1:
        E_local = _num_experts(p)
        local = gate_idx - mesh.coord("ep") * E_local
        keep = (local >= 0) & (local < E_local)
        idx = torch.where(keep, local, torch.zeros_like(local))
    if mesh.axis_size("tp") > 1 and mesh.coord("tp") != 0:
        p = dict(p, b2=None)
    y = _stage(p, x, idx, impl, **act)
    if keep is not None:
        y = torch.where(keep[..., None], y, torch.zeros_like(y))
    return mesh.all_reduce(y, ("ep", "tp"))


def _dispatch_train(mesh, p, x: torch.Tensor, gate_idx: torch.Tensor,
                    impl: str, act) -> torch.Tensor:
    """The training form of :func:`_dispatch_on_mesh`, which autograd
    differentiates: x enters the ep x tp region through
    ``collectives.copy_to`` (its cotangent summed over the ranks), the
    rank's experts run on every token of its slice, and the output
    leaves through ``collectives.reduce_from``. b2 is counted once: on tp
    ranks past the first its value is taken out (``b2 - b2.detach()``, an
    exact 0) while its gradient stays, so every tp rank holds b2's whole
    gradient, as every rank holds the other replicated leaves'."""
    from m3asr_tpu_torch.parallel.collectives import copy_to, reduce_from
    axes = ("ep", "tp")
    x = copy_to(mesh, x, axes)
    idx, keep = gate_idx, None
    if mesh.axis_size("ep") > 1:
        E_local = _num_experts(p)
        local = gate_idx - mesh.coord("ep") * E_local
        keep = (local >= 0) & (local < E_local)
        idx = torch.where(keep, local, torch.zeros_like(local))
    if mesh.axis_size("tp") > 1 and mesh.coord("tp") != 0 \
            and p.get("b2") is not None:
        p = dict(p, b2=p["b2"] - p["b2"].detach())
    y = _stage(p, x, idx, impl, **act)
    if keep is not None:
        y = torch.where(keep[..., None], y, torch.zeros_like(y))
    return reduce_from(mesh, y, axes)


def _dispatch(p, x: torch.Tensor, gate_idx: torch.Tensor, impl: str,
              activation="swish",
              upper_bound: Optional[float] = None) -> torch.Tensor:
    """Stage ``impl`` on (p, x, gate_idx) with the experts' activation
    (``"swish"`` or ``"relu"``) and clamp (:func:`_stage`). Under an ep or
    tp mesh (``parallel/mesh.sharded``) the stage runs on this rank's
    expert shard and the ranks' outputs are summed
    (:func:`_dispatch_on_mesh`; :func:`_dispatch_train` under
    autograd)."""
    act = dict(activation=activation, upper_bound=upper_bound)
    mesh = pmesh.active_mesh()
    if mesh is not None and mesh.axis_size(("ep", "tp")) > 1:
        if torch.is_grad_enabled() and (x.requires_grad or any(
                torch.is_tensor(v) and v.requires_grad
                for v in p.values())):
            return _dispatch_train(mesh, p, x, gate_idx, impl, act)
        return _dispatch_on_mesh(mesh, p, x, gate_idx, impl, act)
    return _stage(p, x, gate_idx, impl, **act)


def _stage(p, x: torch.Tensor, gate_idx: torch.Tensor, impl: str,
           activation="swish",
           upper_bound: Optional[float] = None) -> torch.Tensor:
    """Stage ``impl`` on (p, x, gate_idx). K8 (``pallas``, and
    ``quant_pallas`` on int8 weights) and ``quant_capacity`` run the
    conformer experts' SiLU only, as their JAX callers do, and raise for
    anything else."""
    act = dict(activation=activation, upper_bound=upper_bound)
    if impl in ("pallas", "quant_capacity") or (
            impl == "quant_pallas" and "w1_q4" not in p):
        if activation_name(activation) != "swish" or upper_bound is not None:
            raise ValueError(f"moe impl {impl!r} runs the SiLU experts only")
    if impl == "dense":
        return moe_experts_dense(p, x, gate_idx, **act)
    if impl == "ragged":
        return moe_experts_ragged(p, x, gate_idx, **act)
    if impl == "tiled":
        return moe_experts_tiled(p, x, gate_idx, **act)
    if impl == "ragged_padded":
        return moe_experts_ragged_padded(p, x, gate_idx, **act)
    if impl == "capacity":
        return moe_experts_capacity(p, x, gate_idx, **act)
    if impl == "pallas":
        return stream_kernel(p, x, gate_idx)
    if impl == "quant":
        return quant.moe_experts_dense_q(p, x, gate_idx, **act)
    if impl == "quant_tiled":
        return quant.moe_experts_tiled_q(p, x, gate_idx, **act)
    if impl == "quant_capacity":
        return quant.moe_experts_capacity_q(p, x, gate_idx)
    if impl == "quant_a8":
        return quant.moe_experts_dense_w8a8(p, x, gate_idx, **act)
    if impl == "quant_a8_tiled":
        return quant.moe_experts_tiled_w8a8(p, x, gate_idx, **act)
    if impl == "quant_pallas":
        if "w1_q4" in p:
            return q4_kernel(p, x, gate_idx, **act)
        return stream_kernel(p, x, gate_idx)
    if impl in ("quant4_pallas", "quant4_a8"):
        return q4_kernel(p, x, gate_idx, act_quant=impl == "quant4_a8",
                         **act)
    if impl in ("quant4_tiled", "quant4_a8_tiled"):
        return q4_tiled_kernel(p, x, gate_idx,
                               act_quant=impl == "quant4_a8_tiled", **act)
    if impl in ("runs_f", "quant_runs", "quant4_runs"):
        return runs_for(p)(p, x, gate_idx, **act)
    if impl in ("quant_a8_runs", "quant4_a8_runs"):
        return runs_for(p)(p, x, gate_idx, act_quant=True, **act)
    raise ValueError(f"unknown moe impl: {impl}")


def moe_ffn(p, x: torch.Tensor, embed: Optional[torch.Tensor],
            lengths: Optional[torch.Tensor], impl: str = "dense",
            keep_expert_output: bool = False, top_k: int = 1,
            return_router_probs: bool = False):
    """catEmbed MoE FFN: router(cat[embed, x]) -> gate -> expert FFN ->
    * gate value. ``top_k=1`` is the deployed softmax top-1 gate
    (``keep_expert_output`` skips the gate product; ``return_router_probs``
    also returns the router's full softmax, float32 (B, T, E)); ``top_k >
    1`` is fastmoe's NaiveGate path: the gate-weighted sum of one stage
    call per k, each of which launches its kernel (padded rows: gate 0,
    expert 0)."""
    router_inputs = x if embed is None else torch.cat([embed, x], dim=-1)
    if top_k == 1:
        gate_value, gate_idx = softmax_top1_gate(p["router"], router_inputs,
                                                 lengths)
        y = _dispatch(p, x, gate_idx, impl)
        if not keep_expert_output:
            y = y * gate_value
        if return_router_probs:
            return y, router_probs(p["router"], router_inputs)
        return y
    gate, idx = naive_topk_gate(p["router"], router_inputs, top_k, lengths)
    y = torch.zeros_like(x)
    for k in range(top_k):
        y = y + _dispatch(p, x, idx[..., k], impl) * gate[..., k:k + 1]
    return y


def init_moe_ffn(g: torch.Generator, d_model: int, embed_dim: int,
                 num_experts: int, hidden_units: int,
                 router_with_bias: bool = False, dtype=torch.float32):
    """A catEmbed MoE FFN's seeded parameters, drawn on ``g``'s device:
    FMoELinear's xavier-uniform (gain 0.5) experts, zero biases and a
    zero router, as the reference initialises them (every token then
    goes to expert 0: randomise the router for real dispatch)."""
    dev = g.device
    xb = 0.5 * math.sqrt(6.0 / (d_model + hidden_units))

    def uniform(shape):
        u = torch.rand(shape, generator=g, device=dev)
        return ((u * 2 - 1) * xb).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)
    p = {"router": {"kernel": zeros(d_model + embed_dim, num_experts)},
         "w1": uniform((num_experts, d_model, hidden_units)),
         "b1": zeros(num_experts, hidden_units),
         "w2": uniform((num_experts, hidden_units, d_model)),
         "b2": zeros(num_experts, d_model)}
    if router_with_bias:
        p["router"]["bias"] = zeros(num_experts)
    return p
