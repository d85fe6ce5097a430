"""Batched CTC prefix beam search in device tensors (port of
``m3asr_tpu/decode/device.py``).

The search runs where its input lies, in fixed shapes: a Python loop
over frames (``lax.scan`` in the JAX package), every frame batched over
the utterances (``vmap`` there). The engine runs it inside its forward
for ``decode_output="beam"``, so a CUDA graph captures the encoder and
the whole search, and only the n-best ids and scores cross to the host.

A beam entry is (tokens, len, pb, pnb, h1, h2, last): the prefix buffer,
its blank- and nonblank-ending log-probs, two independent 32-bit rolling
hashes of the prefix, and its last token. Each frame expands beam x K
candidates into "stay" and "extend" entries keyed by the hash of their
target prefix, sorts them by (h1, h2), merges runs of equal hashes with a
segment log-sum-exp (pb and pnb apart, the cases of the host search) and
keeps the best ``beam`` distinct prefixes. Frames at t >= out_len leave
the state as it is.

The hashes wrap as the JAX package's uint32 arithmetic wraps: torch has
no general uint32 arithmetic, so they are held in int64, masked to 32
bits, and each product is split so that it never leaves int64. Every
top-k here is a stable descending sort, so equal scores keep the lower
index first, as ``lax.top_k`` keeps them.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = float("-inf")

# rolling-hash multipliers and offsets of the two lanes (the JAX
# package's, so that both merge the same prefixes)
_M1, _A1 = 1000003, 1
_M2, _A2 = 0x85EBCA6B, 0x9E3779B9
_EMPTY_H1 = 2166136261
_EMPTY_H2 = 0x27D4EB2F
_MASK = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32) and m < 2^32, with every
    partial product below 2^48."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK


def _hash_extend(h1, h2, tok):
    """Extend both rolling hashes of a prefix by one token."""
    t = tok.long()
    return ((_mul32(h1, _M1) + t + _A1) & _MASK,
            (_mul32(h2, _M2) + t + _A2) & _MASK)


def _junk_hashes(beam: int, device):
    """Distinct filler hashes for dead beam slots (their mass is -inf,
    so a merge with a live prefix changes nothing)."""
    j = torch.arange(beam, dtype=torch.long, device=device)
    return (0xDEADBEEF ^ ((j * 2654435761) & _MASK),
            0x00C0FFEE ^ ((j * 40503) & _MASK))


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, best
    first, ties lower index first (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _segment_lse(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per row, log-sum-exp of x (B, E) over its sorted segment ids seg
    (B, E), at each segment id; empty segments are -inf."""
    m = torch.full_like(x, NEG_INF).scatter_reduce(1, seg, x, "amax")
    mg = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    terms = torch.where(torch.isfinite(x), torch.exp(x - mg.gather(1, seg)),
                        torch.zeros_like(x))
    sums = torch.zeros_like(x).scatter_add(1, seg, terms)
    return torch.where(sums > 0, mg + torch.log(sums),
                       torch.full_like(sums, NEG_INF))


def _beam_step(state, vals, idx, valid, beam: int, blank_idx: int):
    """One frame of the prefix recursion over (B, K) candidates:

      s == blank        : stay,   pb  += lse(pb, pnb) + ps
      s == last (!=bl)  : stay,   pnb += pnb + ps
                          extend, pnb += pb + ps   (after a blank)
      else              : extend, pnb += lse(pb, pnb) + ps
    """
    tokens, lens, pb, pnb, h1, h2, last = state
    B, K = vals.shape
    dev = vals.device
    s = idx[:, None, :].expand(B, beam, K)
    ps = vals[:, None, :]
    pb_i, pnb_i = pb[:, :, None], pnb[:, :, None]
    lse_i = torch.logaddexp(pb_i, pnb_i)
    ninf = torch.full((), NEG_INF, dtype=vals.dtype, device=dev)
    is_blank = s == blank_idx
    is_rep = (s == last[:, :, None]) & ~is_blank
    parent = torch.arange(beam, device=dev)[None, :, None].expand(B, beam, K)

    # stay entries keep the parent prefix; extend entries append s (a
    # blank extend carries -inf and a hash no live prefix has)
    stay_pb = torch.where(is_blank, lse_i + ps, ninf)
    stay_pnb = torch.where(is_rep, pnb_i + ps, ninf)
    sh1 = h1[:, :, None].expand(B, beam, K)
    sh2 = h2[:, :, None].expand(B, beam, K)
    ext_pnb = torch.where(is_blank, ninf,
                          torch.where(is_rep, pb_i + ps, lse_i + ps))
    eh1, eh2 = _hash_extend(sh1, sh2, s)

    def cat(a, b):
        return torch.cat([a.reshape(B, -1), b.reshape(B, -1)], dim=1)
    e_h1, e_h2 = cat(sh1, eh1), cat(sh2, eh2)
    e_pb = cat(stay_pb, torch.full_like(ext_pnb, NEG_INF))
    e_pnb = cat(stay_pnb, ext_pnb)
    e_parent = cat(parent, parent)
    e_append = cat(torch.full_like(s, -1), s)

    # merge equal prefixes: sort by (h1, h2) as one signed int64 key,
    # then a segment log-sum-exp over runs of equal keys
    key = (e_h1 - (1 << 31)) * (1 << 32) + e_h2
    key, order = torch.sort(key, dim=1, stable=True)
    start = torch.ones_like(key, dtype=torch.bool)
    start[:, 1:] = key[:, 1:] != key[:, :-1]
    seg = torch.cumsum(start, dim=1) - 1
    m_pb = _segment_lse(e_pb.gather(1, order), seg)
    m_pnb = _segment_lse(e_pnb.gather(1, order), seg)
    score = torch.logaddexp(m_pb, m_pnb)
    # one representative per segment: any of its entries rebuilds the
    # same prefix
    pos_score = torch.where(start, score.gather(1, seg), ninf)
    win_score, win_pos = _top_k(pos_score, beam)
    wseg = seg.gather(1, win_pos)
    wvalid = win_score > NEG_INF
    src = order.gather(1, win_pos)
    wparent = e_parent.gather(1, src)
    wappend = e_append.gather(1, src)

    do_app = (wappend >= 0) & wvalid
    L = tokens.shape[2]
    ptoks = tokens.gather(1, wparent[:, :, None].expand(B, beam, L))
    plen = lens.gather(1, wparent)
    at_end = torch.arange(L, device=dev)[None, None, :] == plen[:, :, None]
    ntoks = torch.where(at_end & do_app[:, :, None],
                        wappend[:, :, None].to(tokens.dtype), ptoks)
    nlen = torch.where(wvalid, plen + do_app.to(lens.dtype),
                       torch.zeros_like(plen))
    nlast = torch.where(do_app, wappend.to(last.dtype),
                        last.gather(1, wparent))
    jh1, jh2 = _junk_hashes(beam, dev)
    h1s, h2s = e_h1.gather(1, src), e_h2.gather(1, src)
    new = (ntoks, nlen,
           torch.where(wvalid, m_pb.gather(1, wseg), ninf),
           torch.where(wvalid, m_pnb.gather(1, wseg), ninf),
           torch.where(wvalid, h1s, jh1[None]),
           torch.where(wvalid, h2s, jh2[None]),
           torch.where(wvalid, nlast, torch.full_like(nlast, -1)))
    # frames past an utterance's length leave its state as it is
    return tuple(torch.where(valid.reshape((B,) + (1,) * (n.dim() - 1)),
                             n, o) for n, o in zip(new, state))


def ctc_beam_search_sparse_device(
        values: torch.Tensor, indices: torch.Tensor, out_lens: torch.Tensor,
        beam_size: int, blank_idx: int = 0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefix beam search over per-frame top-K candidates:
    values / indices (B, T, K), log-softmax scores and token ids in any
    order; out_lens (B,). With K > beam_size the first prune keeps the
    top ``beam_size`` of them, as the host search does.

    Returns (tokens (B, beam, T) int32 padded with -1, lens (B, beam)
    int32, scores (B, beam) float32), best first."""
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    if values.shape[-1] > beam_size:
        values, top = _top_k(values, beam_size)
        indices = indices.gather(-1, top)
    values = values.float()
    indices = indices.to(torch.int32)
    B, T, _ = values.shape
    dev = values.device
    beam = beam_size
    jh1, jh2 = _junk_hashes(beam, dev)
    live0 = (torch.arange(beam, device=dev) == 0)[None].expand(B, beam)
    state = (
        torch.full((B, beam, T), -1, dtype=torch.int32, device=dev),
        torch.zeros((B, beam), dtype=torch.int32, device=dev),
        torch.where(live0, 0.0, NEG_INF).float(),
        torch.full((B, beam), NEG_INF, device=dev),
        torch.where(live0, _EMPTY_H1, jh1[None]),
        torch.where(live0, _EMPTY_H2, jh2[None]),
        torch.full((B, beam), -1, dtype=torch.int32, device=dev),
    )
    valid = torch.arange(T, device=dev)[None, :] < out_lens.to(dev)[:, None]
    for t in range(T):
        state = _beam_step(state, values[:, t], indices[:, t], valid[:, t],
                           beam, blank_idx)
    tokens, lens, pb, pnb = state[:4]
    scores, order = _top_k(torch.logaddexp(pb, pnb), beam)
    tokens = tokens.gather(1, order[:, :, None].expand(B, beam, T))
    return tokens, lens.gather(1, order), scores


def ctc_beam_search_device(
        log_probs: torch.Tensor, out_lens: torch.Tensor, beam_size: int,
        blank_idx: int = 0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search over dense (B, T, V) log-softmax rows: the per-frame
    top-``beam_size`` prune, then :func:`ctc_beam_search_sparse_device`
    (same return contract)."""
    vals, idx = _top_k(log_probs, min(beam_size, log_probs.shape[-1]))
    return ctc_beam_search_sparse_device(vals, idx, out_lens, beam_size,
                                         blank_idx)
