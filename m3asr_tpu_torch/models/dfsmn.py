"""The DFSMN model families (port of ``m3asr_tpu/models/dfsmn.py``):

* ``dfsmn_base_res``: a plain stack of compact-FSMN (cFSMN) layers;
* ``dfsmn_san_res`` (and ``_embed``, ``_embed_domain_acc``): blocks of
  cFSMN layers, each block closed by self-attention with learned memory
  slots, the domain/accent variant with pooled heads;
* ``dfsmn_{base,san}_fmoe_localComm_catEmbed``: the same blocks with
  top-1 MoE cFSMN layers whose router reads ``cat[embed, x]``, the embed
  from a dfsmn_san sub-net.

A cFSMN layer's memory is a FIR filter over time with strided taps: a
depthwise ``F.conv1d`` over an asymmetric pad (``lctx`` frames on the
left, ``rctx`` on the right) with the taps scattered into a dense (K, D)
kernel. Padded frames are zeroed before the FIR, so a bucket's padding
never leaks into the valid frames through its look-ahead tap.

The MoE layer's experts are ``relu(x w1 + b1)``, clamped at 1.0, times
w2 (no bias): the expert stages of ``ops/moe.py`` with
``activation="relu"`` and ``upper_bound``, restricted to the JAX layer's
table (:data:`DFSMN_MOE_STAGES`). DFSMN runs unsubsampled, so an
engine's bucket of B x T frames is B x T expert tokens.

Parameters are the JAX package's trees (per-layer lists, not stacked);
the ``init_*`` functions draw them from a ``torch.Generator`` on its
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.ops import moe as moe_ops
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear, scale_shift)
from m3asr_tpu_torch.ops.masking import make_valid_mask
from m3asr_tpu_torch.ops.positional import MAX_LEN, sinusoid_table

# LayerNorm epsilon of the DFSMN nets (torch.nn.LayerNorm's default)
DFSMN_LN_EPS = 1e-5
_NEG_INF = -1e30

# The expert stages the DFSMN-MoE layer takes, as the JAX layer's tables
# list them (m3asr_tpu/models/dfsmn.py cfsmn_moe_layer); any other name
# raises ValueError there and here.
DFSMN_FLOAT_STAGES = ("dense", "ragged", "runs_f", "tiled")
DFSMN_QUANT_STAGES = ("quant", "quant_tiled", "quant_a8", "quant_a8_tiled",
                      "quant4_pallas", "quant4_tiled", "quant4_a8",
                      "quant4_a8_tiled", "quant_runs", "quant4_runs",
                      "quant_a8_runs", "quant4_a8_runs")
DFSMN_MOE_STAGES = DFSMN_FLOAT_STAGES + DFSMN_QUANT_STAGES


def check_moe_stage(moe_impl: str) -> None:
    """Raise ValueError for a stage outside the DFSMN-MoE layer's table,
    with the JAX layer's message."""
    if moe_impl not in DFSMN_MOE_STAGES:
        raise ValueError(
            f"moe_impl={moe_impl!r} is not supported for the DFSMN-MoE "
            f"layer; choose one of "
            f"{sorted(DFSMN_FLOAT_STAGES) + list(DFSMN_QUANT_STAGES)}")


@dataclasses.dataclass
class FsmnConfig:
    look_back: int = 4
    look_ahead: int = 1
    stride_left: int = 2
    stride_right: int = 1
    upper_bound: Optional[float] = None
    skip_connect: bool = False


_PE_TABLES = {}
# Tables a longer one replaced. They stay alive: a captured CUDA graph (an
# offline bucket, a stream's chunk program) reads the table it was
# captured with by address, so freeing one would hand its memory to the
# caching allocator while graphs still replay reads of it.
_PE_SUPERSEDED = []


def position_table(d: int, T: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """The sinusoid table's first T rows in ``dtype`` on ``device``,
    built once per (d, dtype, device) and kept, so that a CUDA graph's
    capture copies nothing from the host (its warm-up runs build it).
    The JAX package's table has MAX_LEN (5000) rows, which its DFSMN
    forward cannot add to more than 5000 frames; here the table grows to
    T, with the same formula, so the 6144-frame buckets run."""
    n = max(MAX_LEN, T)
    key = (d, dtype, str(device))
    pe = _PE_TABLES.get(key)
    if pe is None or pe.shape[0] < n:
        if pe is not None:
            _PE_SUPERSEDED.append(pe)
        pe = sinusoid_table(d, n, dtype=dtype, device=device)
        _PE_TABLES[key] = pe
    return pe[:T]


def fir_kernel(p, cfg: FsmnConfig, mem_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Dense (K, mem_dim) FIR kernel with the strided taps scattered at
    static indices (K = lctx + 1 + rctx)."""
    lctx = cfg.look_back * cfg.stride_left
    rctx = cfg.look_ahead * cfg.stride_right
    dev = p["cur_factor"].device
    f = torch.zeros((lctx + 1 + rctx, mem_dim), dtype=dtype, device=dev)
    if cfg.look_back:
        f[0:lctx:cfg.stride_left] = p["left_factor"].to(dtype)
    f[lctx] = p["cur_factor"][0].to(dtype)
    if cfg.look_ahead:
        f[lctx + cfg.stride_right::cfg.stride_right] = \
            p["right_factor"].to(dtype)
    return f


def _memory(p, pp: torch.Tensor, lengths: Optional[torch.Tensor],
            cfg: FsmnConfig) -> torch.Tensor:
    """``FIR(pp) + pp`` with pp's padded frames zeroed first: a depthwise
    conv1d over (lctx, rctx) frames of zero padding."""
    if lengths is not None:
        valid = make_valid_mask(lengths, pp.shape[1])
        pp = pp * valid[..., None].to(pp.dtype)
    D = pp.shape[-1]
    lctx = cfg.look_back * cfg.stride_left
    rctx = cfg.look_ahead * cfg.stride_right
    f = fir_kernel(p, cfg, D, pp.dtype)
    conv = F.conv1d(F.pad(pp.transpose(1, 2), (lctx, rctx)),
                    f.t().unsqueeze(1), groups=D)
    return conv.transpose(1, 2) + pp


def cfsmn_layer(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                cfg: FsmnConfig) -> torch.Tensor:
    """Compact FSMN layer: hid = relu(hid_proj(x)) [clamped];
    p = mem_proj(hid) [+ x]; mem = FIR(p) + p."""
    hid = torch.relu(linear(p["hid_proj"], x))
    if cfg.upper_bound is not None:
        hid = torch.clamp(hid, max=cfg.upper_bound)
    pp = linear(p["mem_proj"], hid)
    if cfg.skip_connect:
        pp = pp + x
    return _memory(p, pp, lengths, cfg)


def attn_mem_layer(p, x: torch.Tensor, lengths: Optional[torch.Tensor],
                   num_heads: int, memory_num: int,
                   attn_mask: Optional[torch.Tensor] = None,
                   attn_impl: str = "xla") -> torch.Tensor:
    """Multi-head attention with ``memory_num`` learned key/value slots
    per head, always attendable. x: (B, T, D); attn_mask: optional
    (T, T) bool, True = attend. ``attn_impl="flash"`` runs K2 through
    ``ops/flash_attention.flash_attn_mem``. The plain path takes the
    scores and the softmax in float32 and both products with the
    probabilities in x's dtype, as the JAX package's XLA path does."""
    if attn_impl == "flash":
        from m3asr_tpu_torch.ops.flash_attention import flash_attn_mem
        return flash_attn_mem(p, x, lengths, num_heads, memory_num,
                              attn_mask=attn_mask)
    if attn_impl != "xla":
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, T, D = x.shape
    dk = D // num_heads

    def heads(t):                                   # (B,T,D) -> (B,H,T,dk)
        return t.reshape(B, T, num_heads, dk).transpose(1, 2)

    q = heads(linear(p["linear_query"], x))
    k = heads(linear(p["linear_key"], x))
    v = heads(linear(p["linear_value"], x))
    keys = k
    if memory_num > 0:
        km = p["key_memory"].to(x.dtype)                        # (H, M, dk)
        keys = torch.cat([k, km[None].expand(B, -1, -1, -1)], dim=2)
    scores = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    scores.mul_(dk ** -0.5)                                 # (B,H,T,T+M)
    if attn_mask is not None:
        full = attn_mask.to(torch.bool)
        if memory_num > 0:
            full = torch.cat([full, full.new_ones((T, memory_num))], dim=1)
        scores.masked_fill_(~full, _NEG_INF)
    if lengths is not None:
        valid = make_valid_mask(lengths, T)
        if memory_num > 0:
            valid = torch.cat([valid, valid.new_ones((B, memory_num))],
                              dim=1)
        scores.masked_fill_(~valid[:, None, None, :], _NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    del scores
    ctx = torch.matmul(attn[..., :T], v)
    if memory_num > 0:
        vm = p["value_memory"].to(x.dtype)
        ctx = ctx + torch.matmul(attn[..., T:], vm[None])
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, D))


def self_attn_mem_layer(p, x: torch.Tensor, lengths, num_heads: int,
                        memory_num: int, norm_type: str = "LN",
                        attn_mask: Optional[torch.Tensor] = None,
                        attn_impl: str = "xla") -> torch.Tensor:
    """x = Norm(x + attn(x)): LayerNorm, or the folded MaskBatchNorm
    (``scale_shift``) of the BN norm type."""
    h = attn_mem_layer(p["attn_layer"], x, lengths, num_heads, memory_num,
                       attn_mask=attn_mask, attn_impl=attn_impl)
    x = x + h
    if norm_type == "LN":
        return layer_norm(p["ln_layer"], x, eps=DFSMN_LN_EPS)
    return scale_shift(p["bn_layer"], x)


@dataclasses.dataclass
class DfsmnSanConfig:
    num_block: int = 3
    fsmn_each_block: int = 10
    hidden_dim: int = 1024
    memory_dim: int = 512
    look_back: int = 4
    look_ahead: int = 1
    stride_left: int = 2
    stride_right: int = 1
    num_head: int = 8
    num_memory: int = 64
    norm_type: str = "LN"


def _fsmn_cfg(cfg, first: bool) -> FsmnConfig:
    """Layer (0, 0) takes the input width with no clamp and no skip;
    every later layer clamps at 1.0 and adds its input."""
    return FsmnConfig(cfg.look_back, cfg.look_ahead, cfg.stride_left,
                      cfg.stride_right, upper_bound=None if first else 1.0,
                      skip_connect=not first)


def _add_position(x: torch.Tensor, memory_dim: int) -> torch.Tensor:
    return x + position_table(memory_dim, x.shape[1], x.dtype,
                              x.device)[None]


def dfsmn_san_forward(params, cfg: DfsmnSanConfig, x: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      output_embed: bool = False, attn_mask=None,
                      attn_impl: str = "xla"):
    """Blocks of (N x cFSMN -> [positions on block 0] -> self-attention
    with memory), then out_linear. Returns (out, lengths), or with
    ``output_embed`` (out, pre-out_linear hidden, lengths)."""
    for i in range(cfg.num_block):
        bp = params["blocks"][i]
        for j in range(cfg.fsmn_each_block):
            x = cfsmn_layer(bp["fsmn_layers"][j], x, lengths,
                            _fsmn_cfg(cfg, i == 0 and j == 0))
        if i == 0:
            x = _add_position(x, cfg.memory_dim)
        x = self_attn_mem_layer(bp["attn_layer"], x, lengths, cfg.num_head,
                                cfg.num_memory, cfg.norm_type,
                                attn_mask=attn_mask, attn_impl=attn_impl)
    out = linear(params["out_linear"], x)
    if output_embed:
        return out, x, lengths
    return out, lengths


def dfsmn_san_domain_acc_forward(params, cfg: DfsmnSanConfig,
                                 x: torch.Tensor,
                                 lengths: Optional[torch.Tensor],
                                 output_embed: bool = False,
                                 attn_mask=None, attn_impl: str = "xla"):
    """The san stack plus per-utterance domain/accent heads:
    out_linear_{domain,accent}_embed(hidden), mean-pooled over the valid
    frames (a deliberate deviation of the JAX package from the
    reference's mean over the padded frames, which makes the heads
    padding-invariant), then out_linear_{domain,accent}.

    Returns (out, out_pool, out_pool_acc, lengths); with ``output_embed``
    (out, out_pool, out_pool_acc, x_cat_2, lengths), x_cat_2 =
    cat[hidden, pooled domain embed, pooled accent embed] over T."""
    out, h, lengths = dfsmn_san_forward(params, cfg, x, lengths,
                                        output_embed=True,
                                        attn_mask=attn_mask,
                                        attn_impl=attn_impl)
    x_domain = linear(params["out_linear_domain_embed"], h)
    x_acc = linear(params["out_linear_accent_embed"], h)
    if lengths is not None:
        valid = make_valid_mask(lengths, h.shape[1])[..., None].to(h.dtype)
        denom = torch.clamp(lengths, min=1).to(h.dtype)[:, None, None]
        pool_domain = (x_domain * valid).sum(dim=1, keepdim=True) / denom
        pool_acc = (x_acc * valid).sum(dim=1, keepdim=True) / denom
    else:
        pool_domain = x_domain.mean(dim=1, keepdim=True)
        pool_acc = x_acc.mean(dim=1, keepdim=True)
    out_pool = linear(params["out_linear_domain"], pool_domain)
    out_pool_acc = linear(params["out_linear_accent"], pool_acc)
    if output_embed:
        B, T = h.shape[:2]
        x_cat_2 = torch.cat([h, pool_domain.expand(B, T, -1),
                             pool_acc.expand(B, T, -1)], dim=-1)
        return out, out_pool, out_pool_acc, x_cat_2, lengths
    return out, out_pool, out_pool_acc, lengths


# ---------------------------------------------------------------------------
# MoE-DFSMN (dfsmn_{base,san}_fmoe_localComm_catEmbed)
# ---------------------------------------------------------------------------

def cfsmn_moe_layer(p, x: torch.Tensor, embed: torch.Tensor,
                    lengths: Optional[torch.Tensor], cfg: FsmnConfig,
                    moe_impl: str = "dense", ln_before_router: bool = False,
                    keep_expert_output: bool = False) -> torch.Tensor:
    """MoE compact-FSMN layer (skip form): gate(cat[embed, x]) -> expert
    {relu(x w1 + b1) clamped at upper_bound, times w2} [* gate value
    unless keep_expert_output] -> + x -> mask -> FIR + p.
    ``ln_before_router`` normalises the router input first."""
    check_moe_stage(moe_impl)
    router_in = torch.cat([embed, x], dim=-1)
    if ln_before_router:
        router_in = layer_norm(p["ln_for_router"], router_in,
                               eps=DFSMN_LN_EPS)
    gate_value, gate_idx = moe_ops.softmax_top1_gate(p["router"], router_in,
                                                     lengths)
    y = moe_ops._dispatch(p, x, gate_idx, moe_impl, activation="relu",
                          upper_bound=cfg.upper_bound)
    if not keep_expert_output:
        y = y * gate_value
    return _memory(p, y + x, lengths, cfg)


@dataclasses.dataclass
class DfsmnSanMoEConfig(DfsmnSanConfig):
    """dfsmn_san_fmoe_localComm_catEmbed Net conf (its embed sub-net is a
    dfsmn_san_res_embed with embed_conf)."""
    num_experts: int = 4
    embed_dim: int = 512
    ln_before_router: bool = False
    keep_expert_output: bool = False
    embed_conf: Optional[DfsmnSanConfig] = None


def dfsmn_san_moe_forward(params, cfg: DfsmnSanMoEConfig, x: torch.Tensor,
                          lengths: Optional[torch.Tensor],
                          moe_impl: str = "dense", attn_mask=None,
                          attn_impl: str = "xla",
                          return_hidden: bool = False):
    """The embed sub-net (detached) feeds every MoE cFSMN router; blocks
    of (cFSMN layers, MoE from layer (0, 1) on -> [positions on block 0]
    -> attention), then out_linear_sw. Returns (out, embed_out, lengths),
    with ``return_hidden`` also the pre-out_linear hidden."""
    check_moe_stage(moe_impl)
    embed_cfg = cfg.embed_conf or DfsmnSanConfig()
    embed_out, embed, _ = dfsmn_san_forward(params["embed"], embed_cfg, x,
                                            lengths, output_embed=True,
                                            attn_mask=attn_mask,
                                            attn_impl=attn_impl)
    embed = embed.detach()
    h = x
    for i in range(cfg.num_block):
        bp = params["blocks_sw"][i]
        for j in range(cfg.fsmn_each_block):
            first = i == 0 and j == 0
            fcfg = _fsmn_cfg(cfg, first)
            if first:
                h = cfsmn_layer(bp["fsmn_layers"][j], h, lengths, fcfg)
            else:
                h = cfsmn_moe_layer(
                    bp["fsmn_layers"][j], h, embed, lengths, fcfg,
                    moe_impl=moe_impl,
                    ln_before_router=cfg.ln_before_router,
                    keep_expert_output=cfg.keep_expert_output)
        if i == 0:
            h = _add_position(h, cfg.memory_dim)
        h = self_attn_mem_layer(bp["attn_layer"], h, lengths, cfg.num_head,
                                cfg.num_memory, cfg.norm_type,
                                attn_mask=attn_mask, attn_impl=attn_impl)
    out = linear(params["out_linear_sw"], h)
    if return_hidden:
        return out, embed_out, lengths, h
    return out, embed_out, lengths


@dataclasses.dataclass
class DfsmnBaseConfig:
    fsmn_layers: int = 30
    hidden_dim: int = 1024
    memory_dim: int = 512
    look_back: int = 4
    look_ahead: int = 1
    stride_left: int = 2
    stride_right: int = 1


def dfsmn_base_forward(params, cfg: DfsmnBaseConfig, x: torch.Tensor,
                       lengths: Optional[torch.Tensor]):
    """The plain cFSMN stack, then out_linear: (out, lengths)."""
    for i in range(cfg.fsmn_layers):
        x = cfsmn_layer(params["fsmn_layers"][i], x, lengths,
                        _fsmn_cfg(cfg, i == 0))
    return linear(params["out_linear"], x), lengths


# ---------------------------------------------------------------------------
# Initialization: the reference's init semantics (FIR factors and experts
# xavier-uniform with gain 0.5, memory slots gain 1, nn.Linear defaults,
# routers zero unless rand_init_router), drawn from a torch.Generator on
# its device.
# ---------------------------------------------------------------------------

def _xavier_uniform(g: torch.Generator, shape, fan_out: int, fan_in: int,
                    gain: float, dtype):
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=g, device=g.device)
    return ((u * 2 - 1) * bound).to(dtype)


def _fir_factors(g, mem_dim, look_back, look_ahead, dtype):
    return {
        "left_factor": _xavier_uniform(g, (look_back, mem_dim), look_back,
                                       mem_dim, 0.5, dtype),
        "cur_factor": _xavier_uniform(g, (1, mem_dim), 1, mem_dim, 0.5,
                                      dtype),
        "right_factor": _xavier_uniform(g, (look_ahead, mem_dim),
                                        look_ahead, mem_dim, 0.5, dtype)}


def init_cfsmn(g: torch.Generator, in_dim: int, hid_dim: int, mem_dim: int,
               look_back: int, look_ahead: int, dtype=torch.float32):
    p = _fir_factors(g, mem_dim, look_back, look_ahead, dtype)
    p["hid_proj"] = init_linear(g, in_dim, hid_dim, dtype=dtype)
    p["mem_proj"] = init_linear(g, hid_dim, mem_dim, bias=False, dtype=dtype)
    return p


def init_attn_mem(g: torch.Generator, model_dim: int, num_head: int,
                  memory_num: int, dtype=torch.float32):
    dk = model_dim // num_head
    p = {name: init_linear(g, model_dim, model_dim, bias=False, dtype=dtype)
         for name in ("linear_query", "linear_key", "linear_value",
                      "linear_out")}
    if memory_num > 0:
        # torch xavier on a (H, M, dk) tensor: fan_in = M dk, fan_out = H dk
        for name in ("key_memory", "value_memory"):
            p[name] = _xavier_uniform(g, (num_head, memory_num, dk),
                                      num_head * dk, memory_num * dk, 1.0,
                                      dtype)
    return p


def init_self_attn_mem(g: torch.Generator, model_dim: int, num_head: int,
                       memory_num: int, norm_type: str = "LN",
                       dtype=torch.float32):
    p = {"attn_layer": init_attn_mem(g, model_dim, num_head, memory_num,
                                     dtype)}
    norm = init_layer_norm(model_dim, g.device, dtype)
    p["ln_layer" if norm_type == "LN" else "bn_layer"] = norm
    return p


def _san_blocks(g, cfg: DfsmnSanConfig, input_dim: int, layer, dtype):
    blocks = []
    for i in range(cfg.num_block):
        fsmn = [layer(i, j) if not (i == 0 and j == 0)
                else init_cfsmn(g, input_dim, cfg.hidden_dim, cfg.memory_dim,
                                cfg.look_back, cfg.look_ahead, dtype)
                for j in range(cfg.fsmn_each_block)]
        blocks.append({"fsmn_layers": fsmn,
                       "attn_layer": init_self_attn_mem(
                           g, cfg.memory_dim, cfg.num_head, cfg.num_memory,
                           cfg.norm_type, dtype)})
    return blocks


def init_dfsmn_san(g: torch.Generator, cfg: DfsmnSanConfig, input_dim: int,
                   output_dim: int, dtype=torch.float32):
    """dfsmn_san_res Net: layer (0, 0) takes input_dim, everything after
    runs at memory_dim; out_linear on top."""
    blocks = _san_blocks(g, cfg, input_dim, lambda i, j: init_cfsmn(
        g, cfg.memory_dim, cfg.hidden_dim, cfg.memory_dim, cfg.look_back,
        cfg.look_ahead, dtype), dtype)
    return {"blocks": blocks,
            "out_linear": init_linear(g, cfg.memory_dim, output_dim,
                                      dtype=dtype)}


def init_dfsmn_san_domain_acc(g: torch.Generator, cfg: DfsmnSanConfig,
                              input_dim: int, output_dim: int,
                              output_dim_domain: int = 6,
                              output_dim_acc: int = 8, dtype=torch.float32):
    p = init_dfsmn_san(g, cfg, input_dim, output_dim, dtype)
    d = cfg.memory_dim
    p["out_linear_domain"] = init_linear(g, d, output_dim_domain, dtype=dtype)
    p["out_linear_accent"] = init_linear(g, d, output_dim_acc, dtype=dtype)
    p["out_linear_domain_embed"] = init_linear(g, d, d, dtype=dtype)
    p["out_linear_accent_embed"] = init_linear(g, d, d, dtype=dtype)
    return p


def init_dfsmn_base(g: torch.Generator, cfg: DfsmnBaseConfig,
                    input_dim: int, output_dim: int, dtype=torch.float32):
    layers = [init_cfsmn(g, input_dim if i == 0 else cfg.memory_dim,
                         cfg.hidden_dim, cfg.memory_dim, cfg.look_back,
                         cfg.look_ahead, dtype)
              for i in range(cfg.fsmn_layers)]
    return {"fsmn_layers": layers,
            "out_linear": init_linear(g, cfg.memory_dim, output_dim,
                                      dtype=dtype)}


def init_cfsmn_moe(g: torch.Generator, mem_dim: int, hid_dim: int,
                   embed_dim: int, num_experts: int, look_back: int,
                   look_ahead: int, ln_before_router: bool = False,
                   rand_init_router: bool = False, dtype=torch.float32):
    """MoE cFSMN layer: experts' hid_proj (bias, zero) and mem_proj (no
    bias) xavier gain 0.5 per expert slice; the router zero, as the
    reference's deployed conf has it (every token on expert 0), unless
    ``rand_init_router`` (xavier gain 0.5)."""
    p = _fir_factors(g, mem_dim, look_back, look_ahead, dtype)
    dev = g.device
    p["w1"] = _xavier_uniform(g, (num_experts, mem_dim, hid_dim), hid_dim,
                              mem_dim, 0.5, dtype)
    p["b1"] = torch.zeros((num_experts, hid_dim), dtype=dtype, device=dev)
    p["w2"] = _xavier_uniform(g, (num_experts, hid_dim, mem_dim), mem_dim,
                              hid_dim, 0.5, dtype)
    p["b2"] = None
    shape = (embed_dim + mem_dim, num_experts)
    p["router"] = {"kernel": (
        _xavier_uniform(g, shape, num_experts, embed_dim + mem_dim, 0.5,
                        dtype)
        if rand_init_router
        else torch.zeros(shape, dtype=dtype, device=dev))}
    if ln_before_router:
        p["ln_for_router"] = init_layer_norm(embed_dim + mem_dim, dev, dtype)
    return p


def init_dfsmn_san_moe(g: torch.Generator, cfg: DfsmnSanMoEConfig,
                       input_dim: int, output_dim: int,
                       rand_init_router: bool = False, dtype=torch.float32):
    """dfsmn_san_fmoe_localComm_catEmbed Net: the dfsmn_san embed sub-net
    (its own out_linear is the embed CTC head) and the MoE main stack,
    whose layer (0, 0) is a plain cFSMN from input_dim."""
    embed_cfg = cfg.embed_conf or DfsmnSanConfig()
    p = {"embed": init_dfsmn_san(g, embed_cfg, input_dim, output_dim,
                                 dtype)}
    p["blocks_sw"] = _san_blocks(g, cfg, input_dim, lambda i, j:
                                 init_cfsmn_moe(
                                     g, cfg.memory_dim, cfg.hidden_dim,
                                     cfg.embed_dim, cfg.num_experts,
                                     cfg.look_back, cfg.look_ahead,
                                     cfg.ln_before_router, rand_init_router,
                                     dtype), dtype)
    p["out_linear_sw"] = init_linear(g, cfg.memory_dim, output_dim,
                                     dtype=dtype)
    return p
