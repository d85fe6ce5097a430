"""Chunk-by-chunk streaming of the DFSMN families (port of
``m3asr_tpu/models/dfsmn_streaming.py``).

A cFSMN layer's memory is a finite FIR filter, so an exact stream needs
only:

* per cFSMN layer, a cache of the last ``lctx + rctx`` pre-FIR frames. A
  chunk of C frames gives C FIR outputs for positions rctx frames back:
  a stack of F layers with look-ahead lags F * rctx frames behind its
  input (:func:`stream_delay`). The zero initial cache is the offline
  forward's zero padding;
* per block, a window cache of the last ``cache_T`` attention inputs;
  the chunk's queries attend over [cache, chunk] and the memory slots.
  With ``look_ahead=0`` and a window covering the utterance a stream
  equals the offline forward under a chunk-causal attention mask.

The MoE net (``dfsmn_san_fmoe_localComm_catEmbed``) streams its embed
sub-net alongside: the main path is fed through an input delay buffer,
the matured embed frames ride a ring, and each MoE layer reads its
aligned embed window at a static offset (:func:`forward_chunk_moe`).

Every state tensor has a fixed shape, so one chunk program (a CUDA graph
on the card, ``runtime/streaming_session.py``) serves a stream's whole
life. The offsets live on the device: the positional gather index, the
key validity and the pre-stream mask come from them there, with no host
read inside a step. :func:`write_state` writes a step's new state into
the old state's tensors in place, only in the mask's slots when one is
given.

Activations and caches take the chunk's dtype (float32, or bfloat16 for
bf16 and quantized engines; the JAX package keeps float32 caches); the
attention scores and the softmax run in float32. The positional rows are
the 5000-row sinusoid table's, each frame's index clipped to the table
as the JAX stream clips it: past 50 s of audio every frame takes the
last row, where the port's offline forward grows its table.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from m3asr_tpu_torch.models.dfsmn import (DFSMN_LN_EPS, DfsmnSanConfig,
                                          FsmnConfig, _fsmn_cfg,
                                          check_moe_stage, fir_kernel,
                                          position_table)
from m3asr_tpu_torch.ops import moe as moe_ops
from m3asr_tpu_torch.ops.common import layer_norm, linear, scale_shift
from m3asr_tpu_torch.ops.positional import MAX_LEN

_NEG_INF = -1e30


@dataclasses.dataclass
class DfsmnStreamState:
    offset: torch.Tensor              # () or (B,) int32: frames consumed
    fsmn_caches: List[torch.Tensor]   # per cFSMN layer (B, lctx+rctx, M)
    att_caches: List[torch.Tensor]    # per block (B, cache_T, M)


@dataclasses.dataclass
class DfsmnMoeStreamState:
    offset: torch.Tensor              # () or (B,) int32: raw frames
    in_buf: torch.Tensor              # (B, delay_B, input_dim)
    embed_state: DfsmnStreamState     # the embed sub-stream
    embed_buf: torch.Tensor           # (B, ring, embed_dim) matured ring
    fsmn_caches: List[torch.Tensor]
    att_caches: List[torch.Tensor]


def state_tensors(state) -> tuple:
    """A state's tensors, flat, in field order (nested states and lists
    in place): a chunk program's static inputs."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out += state_tensors(v)
        elif isinstance(v, list):
            out += v
        else:
            out.append(v)
    return tuple(out)


def state_like(template, tensors):
    """A state of ``template``'s structure over the flat ``tensors``
    (:func:`state_tensors`' order)."""
    it = iter(tensors)

    def build(t):
        kw = {}
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if dataclasses.is_dataclass(v):
                kw[f.name] = build(v)
            elif isinstance(v, list):
                kw[f.name] = [next(it) for _ in v]
            else:
                kw[f.name] = next(it)
        return type(t)(**kw)
    return build(template)


def write_state(dst, new, mask: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` into ``dst``'s tensors in place; with a slot mask
    (B,) only the mask's slots (idle slots of a batched step keep their
    state). Every state tensor has the batch first."""
    for d, n in zip(state_tensors(dst), state_tensors(new)):
        if mask is not None:
            n = torch.where(mask.view((-1,) + (1,) * (d.dim() - 1)), n, d)
        d.copy_(n)


def select_state(mask: torch.Tensor, new, old):
    """Per-slot selection: ``new`` where mask (B,) is True, ``old``
    elsewhere (either state type)."""
    out = [torch.where(mask.view((-1,) + (1,) * (o.dim() - 1)), n, o)
           if o.dim() else n
           for n, o in zip(state_tensors(new), state_tensors(old))]
    return state_like(old, out)


def _contexts(cfg):
    return (cfg.look_back * cfg.stride_left,
            cfg.look_ahead * cfg.stride_right)


def init_state(cfg: DfsmnSanConfig, batch: int, cache_T: int,
               per_slot: bool = False, dtype: torch.dtype = torch.float32,
               device=None) -> DfsmnStreamState:
    """Zero state. ``per_slot=True`` gives every batch row its own offset
    (the batched multi-stream mode, ``runtime/streaming_batch.py``)."""
    lctx, rctx = _contexts(cfg)
    n_fsmn = cfg.num_block * cfg.fsmn_each_block

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return DfsmnStreamState(
        offset=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
        fsmn_caches=[zeros(batch, lctx + rctx, cfg.memory_dim)
                     for _ in range(n_fsmn)],
        att_caches=[zeros(batch, cache_T, cfg.memory_dim)
                    for _ in range(cfg.num_block)])


def stream_delay(cfg: DfsmnSanConfig) -> int:
    """Output latency in frames: every cFSMN layer adds rctx."""
    return (cfg.num_block * cfg.fsmn_each_block
            * cfg.look_ahead * cfg.stride_right)


def _fir_stream(p, pp: torch.Tensor, cache: torch.Tensor,
                fcfg: FsmnConfig):
    """The cached FIR and residual centre over the pre-FIR chunk pp
    (B, C, M): a depthwise conv1d with no padding over [cache, pp]."""
    lctx, rctx = _contexts(fcfg)
    M, C = pp.shape[-1], pp.shape[1]
    ext = torch.cat([cache.to(pp.dtype), pp], dim=1)
    new_cache = ext[:, ext.shape[1] - (lctx + rctx):]
    f = fir_kernel(p, fcfg, M, pp.dtype)
    conv = F.conv1d(ext.transpose(1, 2), f.t().unsqueeze(1),
                    groups=M).transpose(1, 2)
    # output j is the FIR at position offset - rctx + j, whose residual
    # centre is ext[:, lctx + j]
    return conv + ext[:, lctx:lctx + C], new_cache


def _stream_cfsmn(p, x: torch.Tensor, cache: torch.Tensor,
                  fcfg: FsmnConfig, pos_mask=None):
    """One cFSMN layer on a chunk x (B, C, d_in). Returns (out (B, C, M)
    for positions rctx frames back, new cache). ``pos_mask`` (B|1, C, 1)
    zeroes the pre-stream frames of a delayed input, as the offline
    forward's zero padding."""
    hid = torch.relu(linear(p["hid_proj"], x))
    if fcfg.upper_bound is not None:
        hid = torch.clamp(hid, max=fcfg.upper_bound)
    pp = linear(p["mem_proj"], hid)
    if fcfg.skip_connect:
        pp = pp + x
    if pos_mask is not None:
        pp = pp * pos_mask
    return _fir_stream(p, pp, cache, fcfg)


def _stream_cfsmn_moe(p, x: torch.Tensor, embed: torch.Tensor,
                      cache: torch.Tensor, fcfg: FsmnConfig, pos_mask=None,
                      ln_before_router: bool = False,
                      keep_expert_output: bool = False,
                      moe_impl: str = "dense"):
    """The MoE cFSMN layer on a chunk (``models/dfsmn.cfsmn_moe_layer``'s
    stream twin): the router reads cat[embed, x], ``embed`` the embed
    sub-net's hidden at the same positions as x; the experts run the
    stage ``moe_impl`` of the DFSMN-MoE table. Only the FIR has a
    cache."""
    check_moe_stage(moe_impl)
    router_in = torch.cat([embed.to(x.dtype), x], dim=-1)
    if ln_before_router:
        router_in = layer_norm(p["ln_for_router"], router_in,
                               eps=DFSMN_LN_EPS)
    gate_value, gate_idx = moe_ops.softmax_top1_gate(p["router"], router_in,
                                                     None)
    y = moe_ops._dispatch(p, x, gate_idx, moe_impl, activation="relu",
                          upper_bound=fcfg.upper_bound)
    if not keep_expert_output:
        y = y * gate_value
    pp = y + x
    if pos_mask is not None:
        pp = pp * pos_mask
    return _fir_stream(p, pp, cache, fcfg)


def _stream_attn_mem(p, x: torch.Tensor, cache: torch.Tensor,
                     key_valid: torch.Tensor, num_heads: int,
                     memory_num: int, norm_type: str):
    """The memory-slot attention of the chunk's queries over [cache,
    chunk] keys and the memory slots, then the residual and the norm.
    x: (B, C, M); cache: (B, Tc, M) raw attention inputs; key_valid:
    (Tc + C,) or per slot (B, Tc + C). Returns (out, new cache)."""
    B, C, D = x.shape
    dk = D // num_heads
    ap = p["attn_layer"]
    Tc = cache.shape[1]
    ext = torch.cat([cache.to(x.dtype), x], dim=1)
    new_cache = ext[:, ext.shape[1] - Tc:] if Tc > 0 else cache

    def heads(name, t):                        # -> (B, H, T, dk)
        return linear(ap[name], t).reshape(B, -1, num_heads, dk) \
            .transpose(1, 2)

    q = heads("linear_query", x)
    k = heads("linear_key", ext)
    v = heads("linear_value", ext)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    kv = (key_valid[:, None, None, :] if key_valid.dim() == 2
          else key_valid[None, None, None, :])
    scores = scores.masked_fill(~kv, _NEG_INF)
    if memory_num > 0:
        km = ap["key_memory"].to(x.dtype)                    # (H, M, dk)
        mem = torch.matmul(q.float(), km.float().transpose(-1, -2)[None])
        scores = torch.cat([scores, mem], dim=-1)
    attn = torch.softmax(scores * (dk ** -0.5), dim=-1).to(x.dtype)
    ctx = torch.matmul(attn[..., :Tc + C], v)
    if memory_num > 0:
        ctx = ctx + torch.matmul(attn[..., Tc + C:],
                                 ap["value_memory"].to(x.dtype)[None])
    x = x + linear(ap["linear_out"], ctx.transpose(1, 2).reshape(B, C, D))
    if norm_type == "LN":
        x = layer_norm(p["ln_layer"], x, eps=DFSMN_LN_EPS)
    else:
        x = scale_shift(p["bn_layer"], x)
    return x, new_cache


def _frame_index(offset: torch.Tensor, start: int, C: int) -> torch.Tensor:
    """offset - start + j for the chunk's frames j: (C,), or (B, C) per
    slot, on the offset's device."""
    idx = torch.arange(C, device=offset.device)
    if offset.dim():
        return offset.long()[:, None] - start + idx[None, :]
    return offset.long() - start + idx


def _add_positions(x: torch.Tensor, offset: torch.Tensor, shift: int,
                   memory_dim: int) -> torch.Tensor:
    """x plus the sinusoid rows of its frames' positions (offset - shift
    + j), each clipped to the 5000-row table as the JAX stream clips it;
    warm-up frames (negative positions) take row 0."""
    pe = position_table(memory_dim, MAX_LEN, x.dtype, x.device)
    idx = torch.clamp(_frame_index(offset, shift, x.shape[1]), 0,
                      MAX_LEN - 1)
    rows = pe[idx]
    return x + (rows if offset.dim() else rows[None])


def _key_valid(offset: torch.Tensor, Tc: int, C: int,
               delay: int) -> torch.Tensor:
    """A key slot of [cache, chunk] holds the block's output frame
    offset - Tc + i; frames below the block's cumulative delay are
    warm-up and must not reach matured queries."""
    return _frame_index(offset, Tc, Tc + C) >= delay


def _stream_hidden(params, cfg: DfsmnSanConfig, chunk: torch.Tensor,
                   state: DfsmnStreamState):
    """:func:`forward_chunk` without the output projection: the hidden
    stream (the embed feature the MoE net routes on)."""
    x = chunk
    C = chunk.shape[1]
    _, rctx = _contexts(cfg)
    new_fsmn, new_att = [], []
    li = 0
    for i in range(cfg.num_block):
        bp = params["blocks"][i]
        for j in range(cfg.fsmn_each_block):
            x, nc = _stream_cfsmn(bp["fsmn_layers"][j], x,
                                  state.fsmn_caches[li],
                                  _fsmn_cfg(cfg, i == 0 and j == 0))
            new_fsmn.append(nc)
            li += 1
        if i == 0:
            # the block's output frame j sits at offset - delay0 + j
            x = _add_positions(x, state.offset,
                               cfg.fsmn_each_block * rctx, cfg.memory_dim)
        cache = state.att_caches[i]
        key_valid = _key_valid(state.offset, cache.shape[1], C,
                               (i + 1) * cfg.fsmn_each_block * rctx)
        x, na = _stream_attn_mem(bp["attn_layer"], x, cache, key_valid,
                                 cfg.num_head, cfg.num_memory,
                                 cfg.norm_type)
        new_att.append(na)
    return x, DfsmnStreamState(state.offset + C, new_fsmn, new_att)


def forward_chunk(params, cfg: DfsmnSanConfig, chunk: torch.Tensor,
                  state: DfsmnStreamState):
    """One streaming step of the dfsmn_san net. chunk: (B, C, input_dim)
    raw feature frames. Returns (logits (B, C, V), new state). Output
    frame j of chunk k is input frame k * C + j - stream_delay(cfg); the
    first stream_delay(cfg) frames a stream emits are warm-up, which the
    sessions drop."""
    x, new_state = _stream_hidden(params, cfg, chunk, state)
    return linear(params["out_linear"], x), new_state


# ---------------------------------------------------------------------------
# MoE-DFSMN (dfsmn_san_fmoe_localComm_catEmbed)
# ---------------------------------------------------------------------------
#
# The router of MoE layer l reads frames whose input position lags the
# raw stream by l * rctx, and needs the embed sub-net's hidden at the same
# position; the embed sub-net is itself a stream of delay D_e. So the main
# path reads its input through a delay buffer of max(0, D_e - rctx)
# frames, the matured embed frames ride a ring, and each layer slices its
# window at a static offset. The pre-stream frames the delay adds are
# zeroed before each layer's FIR (pos_mask), as the offline zero padding:
# a causal net (look_ahead = 0) streams exactly.

def _moe_consts(cfg, chunk_size: int):
    ecfg = cfg.embed_conf or DfsmnSanConfig()
    _, rctx = _contexts(cfg)
    d_e = stream_delay(ecfg)
    b_delay = max(0, d_e - rctx)
    n_layers = cfg.num_block * cfg.fsmn_each_block
    # the deepest layer's embed window must fit the ring:
    # ring - C + D_e - B - l * rctx >= 0 for l <= n_layers - 1
    ring = max(chunk_size,
               chunk_size - d_e + b_delay + (n_layers - 1) * rctx)
    return ecfg, rctx, d_e, b_delay, n_layers, ring


def moe_stream_delay(cfg, chunk_size: int = 16) -> int:
    """Output latency: the input delay buffer plus the main FIR
    look-aheads."""
    return _moe_consts(cfg, chunk_size)[3] + stream_delay(cfg)


def init_moe_state(cfg, batch: int, cache_T: int, chunk_size: int,
                   input_dim: int, per_slot: bool = False,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> DfsmnMoeStreamState:
    ecfg, _, _, b_delay, n_layers, ring = _moe_consts(cfg, chunk_size)
    lctx, rctx = _contexts(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return DfsmnMoeStreamState(
        offset=torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
        in_buf=zeros(batch, b_delay, input_dim),
        embed_state=init_state(ecfg, batch, cache_T, per_slot, dtype,
                               device),
        embed_buf=zeros(batch, ring, cfg.embed_dim),
        fsmn_caches=[zeros(batch, lctx + rctx, cfg.memory_dim)
                     for _ in range(n_layers)],
        att_caches=[zeros(batch, cache_T, cfg.memory_dim)
                    for _ in range(cfg.num_block)])


def select_moe_state(mask: torch.Tensor, new: DfsmnMoeStreamState,
                     old: DfsmnMoeStreamState) -> DfsmnMoeStreamState:
    """Per-slot hold-back of idle slots (the batched mode)."""
    return select_state(mask, new, old)


def forward_chunk_moe(params, cfg, chunk: torch.Tensor,
                      state: DfsmnMoeStreamState, moe_impl: str = "dense"):
    """One MoE-DFSMN streaming step. chunk: (B, C, input_dim). Output
    frame j of this chunk is input frame offset + j -
    moe_stream_delay(cfg); the warm-up frames are dropped by the session.
    ``moe_impl`` is any stage of the DFSMN-MoE table (``runs_f`` K1,
    ``quant4_pallas`` / ``quant4_a8`` K6, ``quant``, ...), as the offline
    layer takes it."""
    check_moe_stage(moe_impl)
    C = chunk.shape[1]
    ecfg, rctx, d_e, b_delay, n_layers, ring = _moe_consts(cfg, C)

    # 1. the embed sub-stream: its matured hidden of positions
    #    [offset - D_e, offset + C - D_e) joins the ring
    emb_h, new_est = _stream_hidden(params["embed"], ecfg, chunk,
                                    state.embed_state)
    ebuf = torch.cat([state.embed_buf, emb_h.to(state.embed_buf.dtype)],
                     dim=1)
    new_ebuf = ebuf[:, ebuf.shape[1] - ring:]

    # 2. the delayed main input
    if b_delay > 0:
        ext_in = torch.cat([state.in_buf, chunk], dim=1)
        x, new_inbuf = ext_in[:, :C], ext_in[:, C:]
    else:
        x, new_inbuf = chunk, state.in_buf

    new_fsmn, new_att = [], []
    li = 0
    for i in range(cfg.num_block):
        bp = params["blocks_sw"][i]
        for j in range(cfg.fsmn_each_block):
            first = i == 0 and j == 0
            fcfg = _fsmn_cfg(cfg, first)
            pos_mask = None
            if b_delay > 0:
                pos = _frame_index(state.offset, b_delay + li * rctx, C)
                pos_mask = (pos >= 0).to(x.dtype)[..., None]
                if not state.offset.dim():
                    pos_mask = pos_mask[None]
            if first:
                x, nc = _stream_cfsmn(bp["fsmn_layers"][j], x,
                                      state.fsmn_caches[li], fcfg, pos_mask)
            else:
                start = ring - C + d_e - b_delay - li * rctx
                x, nc = _stream_cfsmn_moe(
                    bp["fsmn_layers"][j], x, new_ebuf[:, start:start + C],
                    state.fsmn_caches[li], fcfg, pos_mask,
                    cfg.ln_before_router, cfg.keep_expert_output,
                    moe_impl=moe_impl)
            new_fsmn.append(nc)
            li += 1
        if i == 0:
            x = _add_positions(x, state.offset,
                               b_delay + cfg.fsmn_each_block * rctx,
                               cfg.memory_dim)
        cache = state.att_caches[i]
        key_valid = _key_valid(state.offset, cache.shape[1], C,
                               (i + 1) * cfg.fsmn_each_block * rctx
                               + b_delay)
        x, na = _stream_attn_mem(bp["attn_layer"], x, cache, key_valid,
                                 cfg.num_head, cfg.num_memory,
                                 cfg.norm_type)
        new_att.append(na)
    out = linear(params["out_linear_sw"], x)
    return out, DfsmnMoeStreamState(
        offset=state.offset + C, in_buf=new_inbuf, embed_state=new_est,
        embed_buf=new_ebuf, fsmn_caches=new_fsmn, att_caches=new_att)
