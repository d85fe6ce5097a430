"""AED transformer decoders and attention rescoring (port of
``m3asr_tpu/models/aed.py``).

The decoder blocks are pre-norm: self-attention under a causal and
padding mask, cross-attention on the encoder memory, a ReLU FFN. The
token embedding is ``Embedding * sqrt(d)`` plus the absolute sinusoid
table. Parameters are the JAX tree's (``decoders`` stacked over blocks,
linear kernels stored (in, out)); a ``BiTransformerDecoder`` holds
``left_decoder`` and ``right_decoder``.

The decoders run on their parameters' device and in their dtype (the
recognizer loads them in float32); memories are cast to it. Rescoring
takes the log-softmax and the gather of each hypothesis' tokens on the
device and copies back only the ``(n, U+1)`` token scores; their sums are
float64 on the host, as in the JAX package. The beam search ranks with a
stable descending sort, so ties go to the lower index as
``jax.lax.top_k`` breaks them, on every device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from m3asr_tpu_torch.config import DecoderConfig
from m3asr_tpu_torch.models.conformer import layer_view, num_layers
from m3asr_tpu_torch.ops import positional
from m3asr_tpu_torch.ops.attention import (attend, init_mha, mha,
                                          project_kv)
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear)
from m3asr_tpu_torch.ops.masking import (make_valid_mask, mask_finished_preds,
                                         mask_finished_scores, subsequent_mask)


def add_sos_eos(ys_pad: np.ndarray, ys_lens: np.ndarray, sos: int, eos: int,
                ignore_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Prepend sos / append eos per utterance (host numpy)."""
    B, U = ys_pad.shape
    ys_in = np.full((B, U + 1), ignore_id, ys_pad.dtype)
    ys_out = np.full((B, U + 1), ignore_id, ys_pad.dtype)
    ys_in[:, 0] = sos
    for b in range(B):
        n = int(ys_lens[b])
        ys_in[b, 1:n + 1] = ys_pad[b, :n]
        ys_out[b, :n] = ys_pad[b, :n]
        ys_out[b, n] = eos
    return ys_in, ys_out


def reverse_pad_list(ys_pad: np.ndarray, ys_lens: np.ndarray,
                     pad_value: int) -> np.ndarray:
    """Reverse each sequence within its valid length."""
    out = np.full_like(ys_pad, pad_value)
    for b in range(ys_pad.shape[0]):
        n = int(ys_lens[b])
        out[b, :n] = ys_pad[b, :n][::-1]
    return out


def _param(p) -> torch.Tensor:
    return p["embed"]["weight"]


def _as_memory(p, memory) -> torch.Tensor:
    """A memory (numpy or tensor) on the decoder's device, in its dtype."""
    w = _param(p)
    return torch.as_tensor(memory).to(device=w.device, dtype=w.dtype)


def _as_lens(p, lens) -> torch.Tensor:
    """Lengths (a list, numpy or a tensor) as int64 (B,) on the decoder's
    device."""
    if not torch.is_tensor(lens):
        lens = torch.from_numpy(np.asarray(lens, np.int64).reshape(-1))
    return lens.to(device=_param(p).device, dtype=torch.int64)


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["w_2"], torch.relu(linear(p["w_1"], x)))


def _decoder_layer(p, x, tgt_mask, memory, memory_lens, num_heads):
    """One pre-norm decoder block."""
    h = layer_norm(p["norm1"], x)
    x = x + mha(p["self_attn"], h, h, h, None, num_heads, mask=tgt_mask)
    h = layer_norm(p["norm2"], x)
    x = x + mha(p["src_attn"], h, memory, memory, memory_lens, num_heads)
    return x + _ffn(p["feed_forward"], layer_norm(p["norm3"], x))


def forward(p, cfg: DecoderConfig, memory: torch.Tensor,
            memory_lens: torch.Tensor, ys_in: torch.Tensor,
            ys_in_lens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, U, V) of ``ys_in`` (B, U) on
    ``memory`` (B, T, d)."""
    memory = _as_memory(p, memory)
    memory_lens = _as_lens(p, memory_lens)
    ys_in = torch.as_tensor(ys_in).to(memory.device, torch.int64)
    ys_in_lens = torch.as_tensor(ys_in_lens).to(memory.device)
    U = ys_in.shape[1]
    x, _ = positional.abs_positional_encoding(p["pos_enc"]["pe"],
                                              _param(p)[ys_in])
    tgt_mask = (subsequent_mask(U, memory.device)[None, None]
                & make_valid_mask(ys_in_lens, U)[:, None, None, :])
    for i in range(num_layers(p["decoders"])):
        x = _decoder_layer(layer_view(p["decoders"], i), x, tgt_mask,
                           memory, memory_lens, cfg.attention_heads)
    return linear(p["output_layer"], layer_norm(p["after_norm"], x))


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, d_model: int,
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """The decode cache of :func:`forward_one_step`: every block's INPUT
    hidden at every emitted position, (L, B, max_len, d)."""
    return torch.zeros((cfg.num_blocks, batch, max_len, d_model),
                       dtype=dtype, device=device)


def memory_kv(p, cfg: DecoderConfig, memory: torch.Tensor):
    """Every block's source-attention key and value heads of ``memory``:
    :func:`forward_one_step` takes them to attend the memory without
    projecting it again at each step."""
    return [project_kv(layer_view(p["decoders"], i)["src_attn"], memory,
                       memory, cfg.attention_heads)
            for i in range(num_layers(p["decoders"]))]


def forward_one_step(p, cfg: DecoderConfig, memory: torch.Tensor,
                     memory_lens: torch.Tensor, tgt: torch.Tensor, pos: int,
                     cache: torch.Tensor, mem_kv=None):
    """One incremental decode step: the log-probs (B, V) of the token after
    position ``pos`` given the cached prefix, recomputing only the
    position's query in each block.

    tgt: (B,) token ids at ``pos``; cache: :func:`init_cache`'s buffer,
    into which each block's input at ``pos`` is written in place (the JAX
    package returns a new buffer; the values are the same). Keys run
    over positions 0..pos only: the JAX package's masked keys past
    ``pos`` weigh exactly 0. ``mem_kv``: :func:`memory_kv` of ``memory``,
    else each block projects the memory itself. Returns
    (log_probs, cache)."""
    d = memory.shape[-1]
    heads = cfg.attention_heads
    pe = p["pos_enc"]["pe"]
    emb = _param(p)[tgt]                                         # (B, d)
    # the table's last row past its end, as jax dynamic_slice clamps
    row = pe[min(int(pos), pe.shape[0] - 1)]
    x = emb * torch.full((), math.sqrt(d), dtype=emb.dtype,
                         device=emb.device) + row.to(emb.dtype)
    for i in range(num_layers(p["decoders"])):
        lp = layer_view(p["decoders"], i)
        cache[i, :, pos] = x
        kv = layer_norm(lp["norm1"], cache[i, :, :pos + 1])
        q = layer_norm(lp["norm1"], x[:, None, :])
        xq = x[:, None, :] + mha(lp["self_attn"], q, kv, kv, None, heads)
        h = layer_norm(lp["norm2"], xq)
        if mem_kv is None:
            xq = xq + mha(lp["src_attn"], h, memory, memory, memory_lens,
                          heads)
        else:
            xq = xq + attend(lp["src_attn"], h, *mem_kv[i], memory_lens,
                             heads)
        xq = xq + _ffn(lp["feed_forward"], layer_norm(lp["norm3"], xq))
        x = xq[:, 0, :]
    y = linear(p["output_layer"], layer_norm(p["after_norm"], x))
    return torch.log_softmax(y, dim=-1), cache


def score_hyps(p, cfg: DecoderConfig, memory, memory_lens,
               hyps: Sequence[Sequence[int]], sos: int, eos: int,
               ignore_id: int, reverse: bool = False) -> np.ndarray:
    """Attention-rescoring scores: per hypothesis, the sum of its
    teacher-forced log-probs including the final eos. memory: (1, T, d)
    of one utterance (numpy or tensor); hyps: the n-best token lists.
    Returns (n,) float64 scores."""
    n = len(hyps)
    U = max((len(h) for h in hyps), default=0)
    ys = np.full((n, U), ignore_id, np.int32)
    lens = np.zeros((n,), np.int32)
    for i, h in enumerate(hyps):
        seq = list(h)[::-1] if reverse else list(h)
        ys[i, :len(seq)] = seq
        lens[i] = len(seq)
    ys_in, ys_out = add_sos_eos(ys, lens, sos, eos, ignore_id)
    memory = _as_memory(p, memory)
    mem = memory.expand((n,) + tuple(memory.shape[1:]))
    mlens = _as_lens(p, memory_lens).expand(n)
    logits = forward(p, cfg, mem, mlens, torch.from_numpy(ys_in),
                     torch.from_numpy(lens + 1))
    tok = torch.from_numpy(ys_out.astype(np.int64)).to(logits.device)
    picked = torch.log_softmax(logits.float(), dim=-1).gather(
        -1, tok[..., None])[..., 0]                              # (n, U+1)
    picked = picked.cpu().numpy().astype(np.float64)
    return np.array([np.cumsum(picked[i, :int(lens[i]) + 1])[-1]
                     for i in range(n)], np.float64)


def _directional_scores(p, cfg, memory, mlens, hyps, sos, eos, ignore_id,
                        reverse_weight):
    left = p.get("left_decoder", p)
    att = score_hyps(left, cfg, memory, mlens, hyps, sos, eos, ignore_id)
    if reverse_weight > 0.0 and "right_decoder" in p:
        r = score_hyps(p["right_decoder"], cfg, memory, mlens, hyps, sos,
                       eos, ignore_id, reverse=True)
        att = (1.0 - reverse_weight) * att + reverse_weight * r
    return att


def attention_rescoring(decoder_params, cfg: DecoderConfig,
                        nbest: List[Tuple[Tuple[int, ...], float]],
                        encoder_out, encoder_len: int,
                        sos: int, eos: int, ignore_id: int,
                        ctc_weight: float = 0.5,
                        reverse_weight: float = 0.0
                        ) -> Tuple[List[int], float]:
    """The CTC n-best hypothesis of the best decoder score + ctc_weight x
    CTC score. encoder_out: (1, T, d) of one utterance."""
    hyps = [list(h) for h, _ in nbest]
    ctc_scores = np.array([s for _, s in nbest])
    att = _directional_scores(decoder_params, cfg, encoder_out,
                              [encoder_len], hyps, sos, eos, ignore_id,
                              reverse_weight)
    total = att + ctc_weight * ctc_scores
    best = int(np.argmax(total))
    return hyps[best], float(total[best])


HIER_MEMORY = {"decoder": 2, "decoder_1": 0, "decoder_2": 1}


def hier_scores(decoder_params, cfg: DecoderConfig, hyps, taps,
                encoder_len: int, sos: int, eos: int, ignore_id: int,
                reverse_weight: float = 0.0) -> np.ndarray:
    """The hier decoders' mean score of each hypothesis: ``decoder``,
    ``decoder_1`` and ``decoder_2`` (those present) each attend their own
    tap of ``taps`` = (h6, h12, h_final), the engine's return_taps
    order."""
    scores = [_directional_scores(decoder_params[name], cfg,
                                  taps[HIER_MEMORY[name]], [encoder_len],
                                  hyps, sos, eos, ignore_id, reverse_weight)
              for name in ("decoder", "decoder_1", "decoder_2")
              if name in decoder_params]
    return np.mean(scores, axis=0)


def hier_attention_rescoring(decoder_params, cfg: DecoderConfig,
                             nbest: List[Tuple[Tuple[int, ...], float]],
                             taps, encoder_len: int,
                             sos: int, eos: int, ignore_id: int,
                             ctc_weight: float = 0.5,
                             reverse_weight: float = 0.0
                             ) -> Tuple[List[int], float]:
    """Attention rescoring with the hier net's three decoders, their
    scores averaged (:func:`hier_scores`), plus ctc_weight x the CTC
    score. taps: (h6, h12, h_final), each (1, T', d) of one utterance;
    decoder_params: {"decoder": tree [, "decoder_1", "decoder_2"]}."""
    hyps = [list(h) for h, _ in nbest]
    ctc_scores = np.array([s for _, s in nbest])
    att = hier_scores(decoder_params, cfg, hyps, taps, encoder_len, sos,
                      eos, ignore_id, reverse_weight)
    total = att + ctc_weight * ctc_scores
    best = int(np.argmax(total))
    return hyps[best], float(total[best])


def topk_stable(x: torch.Tensor, k: int):
    """The k largest entries of each row, best first, equal values in
    ascending index order (``jax.lax.top_k``'s tie rule): a stable
    descending sort, the same order on every device."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def attention_beam_search(p, cfg: DecoderConfig, memory: torch.Tensor,
                          memory_lens: torch.Tensor, beam_size: int,
                          max_len: int, sos: int, eos: int,
                          stats: Optional[dict] = None):
    """Batched AED beam search over encoder memories (B, T, d): up to
    ``max_len`` steps of :func:`forward_one_step` on a fixed cache, the
    beams reordered by a gather on their parents, finished hypotheses
    riding along under mask_finished_scores / _preds. The loop ends once
    every hypothesis has emitted eos (the remaining steps of the JAX
    package's fixed scan leave them as they are). ``stats``, when given,
    gets ``steps``. Returns (hyps (B, beam, max_len) int64, eos-padded,
    best first; scores (B, beam) float32), on the decoder's device."""
    memory = _as_memory(p, memory)
    memory_lens = _as_lens(p, memory_lens)
    dev = memory.device
    B, _, d = memory.shape
    N = B * beam_size
    mem = memory.repeat_interleave(beam_size, dim=0)
    mlens = memory_lens.repeat_interleave(beam_size)
    cache = init_cache(cfg, N, max_len, d, memory.dtype, dev)
    # the memory's key/value heads, projected once for all the steps
    mem_kv = [(k.repeat_interleave(beam_size, dim=0),
               v.repeat_interleave(beam_size, dim=0))
              for k, v in memory_kv(p, cfg, memory)]
    # only beam 0 is alive at step 0 (every beam starts at sos)
    scores = torch.full((B, beam_size), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    hyps = torch.full((N, max_len), eos, dtype=torch.int64, device=dev)
    end_flag = torch.zeros((N, 1), dtype=torch.bool, device=dev)
    tokens = torch.full((N,), sos, dtype=torch.int64, device=dev)
    base = (torch.arange(B, device=dev) * beam_size)[:, None]
    steps = 0
    for pos in range(max_len):
        logp, cache = forward_one_step(p, cfg, mem, mlens, tokens, pos,
                                       cache, mem_kv)
        steps += 1
        top_logp, top_idx = topk_stable(logp.float(), beam_size)
        top_logp = mask_finished_scores(top_logp, end_flag)
        top_idx = mask_finished_preds(top_idx, end_flag, eos)
        cand = (scores.reshape(N, 1) + top_logp).reshape(
            B, beam_size * beam_size)
        scores, offset = topk_stable(cand, beam_size)
        parent = (base + offset // beam_size).reshape(N)
        best_pred = torch.gather(top_idx.reshape(B, -1), 1,
                                 offset).reshape(N)
        hyps = hyps[parent]
        cache[:, :, :pos + 1] = cache[:, parent, :pos + 1]
        end_flag = end_flag[parent] | (best_pred == eos)[:, None]
        hyps[:, pos] = best_pred
        tokens = best_pred
        if bool(end_flag.all()):
            break
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
    return hyps.reshape(B, beam_size, max_len), scores


def attention_search_decode(p, cfg: DecoderConfig, memory, memory_lens,
                            beam_size: int, sos: int, eos: int,
                            max_len: int = 0,
                            stats: Optional[dict] = None) -> List[List[int]]:
    """Run :func:`attention_beam_search` and cut each utterance's best
    hypothesis at its first eos. memory: (B, T, d), numpy or tensor;
    max_len defaults to the memory length (one token per encoder frame
    bounds an AED hypothesis)."""
    memory = _as_memory(p, memory)
    if max_len <= 0:
        max_len = int(memory.shape[1])
    with torch.inference_mode():
        hyps, _ = attention_beam_search(p, cfg, memory, memory_lens,
                                        beam_size, max_len, sos, eos, stats)
    hyps = hyps[:, 0].cpu().numpy()
    out = []
    for best in hyps:
        toks = []
        for t in best:
            if int(t) == eos:
                break
            toks.append(int(t))
        out.append(toks)
    return out


def init(cfg: DecoderConfig, vocab_size: int, d_model: int,
         generator: torch.Generator, dtype: torch.dtype = torch.float32):
    """Random decoder parameters (the JAX tree's paths and shapes), drawn
    on ``generator``'s device: a normal embedding, torch.nn.Linear's init
    for every linear, unit layer norms."""
    dev = generator.device
    g = generator

    def one_layer():
        return {
            "norm1": init_layer_norm(d_model, dev, dtype),
            "norm2": init_layer_norm(d_model, dev, dtype),
            "norm3": init_layer_norm(d_model, dev, dtype),
            "self_attn": init_mha(g, d_model, dtype),
            "src_attn": init_mha(g, d_model, dtype),
            "feed_forward": {
                "w_1": init_linear(g, d_model, cfg.linear_units, dtype=dtype),
                "w_2": init_linear(g, cfg.linear_units, d_model,
                                   dtype=dtype)},
        }

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    return {
        "embed": {"weight": torch.randn((vocab_size, d_model), generator=g,
                                        device=dev).to(dtype)},
        "pos_enc": {"pe": positional.sinusoid_table(d_model, dtype=dtype,
                                                    device=dev)},
        "after_norm": init_layer_norm(d_model, dev, dtype),
        "output_layer": init_linear(g, d_model, vocab_size, dtype=dtype),
        "decoders": stack(*[one_layer() for _ in range(cfg.num_blocks)]),
    }
