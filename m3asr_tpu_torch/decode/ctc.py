"""Host-side CTC decoding in numpy (the port's copy of the greedy and
prefix-beam searches of ``m3asr_tpu/decode/ctc.py``, over dense logits
and over the engine's on-device outputs: ``argmax`` ids with their
log-probs, ``topk`` candidates)."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

NEG_INF = -float("inf")


class Hyp(NamedTuple):
    """One hypothesis: token ids, its summed log score, and the emission
    frame of each token (post-subsampling frame index)."""
    tokens: Tuple[int, ...]
    score: float
    times: Tuple[int, ...]


def log_add(args: Sequence[float]) -> float:
    """log(sum(exp(a_i))), stable."""
    if all(a == NEG_INF for a in args):
        return NEG_INF
    a_max = max(args)
    return a_max + math.log(sum(math.exp(a - a_max) for a in args))


def _collapse(ids: np.ndarray, blank_idx: int) -> List[int]:
    """Collapse repeats, then drop blanks."""
    keep = np.ones(len(ids), dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]
    return [int(t) for t in ids[keep] if t != blank_idx]


def ctc_greedy_search(logits: np.ndarray, out_lens: np.ndarray,
                      blank_idx: int = 0) -> List[List[int]]:
    """argmax -> collapse repeats -> drop blanks. logits: (B, T, V)."""
    return ctc_greedy_from_ids(np.asarray(logits).argmax(axis=-1), out_lens,
                               blank_idx)


def ctc_greedy_from_ids(ids: np.ndarray, out_lens: np.ndarray,
                        blank_idx: int = 0) -> List[List[int]]:
    """Greedy CTC over per-frame argmax ids (B, T), such as the engine's
    ``decode_output="argmax"`` output: the hypotheses of
    :func:`ctc_greedy_search` on the logits the ids came from."""
    ids = np.asarray(ids)
    out_lens = np.asarray(out_lens)
    return [_collapse(ids[b, :int(out_lens[b])], blank_idx)
            for b in range(ids.shape[0])]


def ctc_greedy_times_from_ids(ids: np.ndarray, best_logp: np.ndarray,
                              out_lens: np.ndarray,
                              blank_idx: int = 0) -> List[Hyp]:
    """Greedy CTC with emission frames over argmax ids and their
    log-probs (B, T): each token's time is the first frame of its argmax
    run; the score sums the per-frame best log-probs."""
    ids = np.asarray(ids)
    best_logp = np.asarray(best_logp)
    out_lens = np.asarray(out_lens)
    hyps = []
    for b in range(ids.shape[0]):
        toks, times = [], []
        prev, total = -1, 0.0
        for t in range(int(out_lens[b])):
            s = int(ids[b, t])
            total += float(best_logp[b, t])
            if s != prev and s != blank_idx:
                toks.append(s)
                times.append(t)
            prev = s
        hyps.append(Hyp(tuple(toks), total, tuple(times)))
    return hyps


def ctc_greedy_search_times(logits: np.ndarray, out_lens: np.ndarray,
                            blank_idx: int = 0) -> List[Hyp]:
    """:func:`ctc_greedy_times_from_ids` on dense (B, T, V) logits."""
    logits = np.asarray(logits)
    return ctc_greedy_times_from_ids(logits.argmax(axis=-1),
                                     logits.max(axis=-1), out_lens,
                                     blank_idx)


def token_confidence(log_probs: np.ndarray, tokens: Sequence[int],
                     times: Sequence[int]) -> List[float]:
    """Each token's posterior at its emission frame; log_probs (T, V)."""
    log_probs = np.asarray(log_probs)
    return [float(np.exp(log_probs[t, tok])) for tok, t in zip(tokens, times)]


def token_confidence_sparse(values: np.ndarray, indices: np.ndarray,
                            tokens: Sequence[int],
                            times: Sequence[int]) -> List[float]:
    """:func:`token_confidence` over (T, K) top-K candidates; a token not
    among its frame's candidates gets 0."""
    values = np.asarray(values)
    indices = np.asarray(indices)
    out = []
    for tok, t in zip(tokens, times):
        hit = np.nonzero(indices[t] == tok)[0]
        out.append(float(np.exp(values[t, hit[0]])) if hit.size else 0.0)
    return out


def ctc_prefix_beam_search(
        log_probs: np.ndarray, out_len: int, beam_size: int,
        blank_idx: int = 0) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search for one utterance. log_probs: (T, V)
    log-softmax scores. Returns the n-best [(prefix, log_prob)],
    best first."""
    log_probs = np.asarray(log_probs)

    def frames():
        for t in range(int(out_len)):
            logp = log_probs[t]
            k = min(beam_size, logp.shape[-1])
            yield [(int(s), float(logp[s]))
                   for s in np.argpartition(logp, -k)[-k:]]

    return _prefix_beam_over_frames(frames(), beam_size, blank_idx)


def ctc_prefix_beam_search_sparse(
        values: np.ndarray, indices: np.ndarray, out_len: int,
        beam_size: int, blank_idx: int = 0
        ) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search over per-frame top-K candidates (T, K), sorted
    best-first (the engine's ``decode_output="topk"``): the hypotheses of
    :func:`ctc_prefix_beam_search` on the dense rows when K >= beam_size,
    whose first prune is the same top-k."""
    values = np.asarray(values)
    indices = np.asarray(indices)
    k = min(beam_size, values.shape[-1])

    def frames():
        for t in range(int(out_len)):
            yield [(int(indices[t, i]), float(values[t, i]))
                   for i in range(k)]

    return _prefix_beam_over_frames(frames(), beam_size, blank_idx)


def _prefix_beam_over_frames(frames, beam_size: int, blank_idx: int
                             ) -> List[Tuple[Tuple[int, ...], float]]:
    """The (pb, pnb) prefix recursion over per-frame [(token, logp)]
    candidate lists, shared by the dense and sparse searches."""
    cur_hyps: List[Tuple[Tuple[int, ...], Tuple[float, float]]] = [
        (tuple(), (0.0, NEG_INF))]
    for cands in frames:
        next_hyps = defaultdict(lambda: (NEG_INF, NEG_INF))
        for s, ps in cands:
            for prefix, (pb, pnb) in cur_hyps:
                last = prefix[-1] if prefix else None
                if s == blank_idx:
                    n_pb, n_pnb = next_hyps[prefix]
                    next_hyps[prefix] = (log_add([n_pb, pb + ps, pnb + ps]),
                                         n_pnb)
                elif s == last:
                    n_pb, n_pnb = next_hyps[prefix]          # *ss -> *s
                    next_hyps[prefix] = (n_pb, log_add([n_pnb, pnb + ps]))
                    n_prefix = prefix + (s,)                 # *s-s -> *ss
                    n_pb, n_pnb = next_hyps[n_prefix]
                    next_hyps[n_prefix] = (n_pb, log_add([n_pnb, pb + ps]))
                else:
                    n_prefix = prefix + (s,)
                    n_pb, n_pnb = next_hyps[n_prefix]
                    next_hyps[n_prefix] = (
                        n_pb, log_add([n_pnb, pb + ps, pnb + ps]))
        cur_hyps = sorted(next_hyps.items(),
                          key=lambda x: log_add(list(x[1])),
                          reverse=True)[:beam_size]
    return [(p, log_add(list(v))) for p, v in cur_hyps]
