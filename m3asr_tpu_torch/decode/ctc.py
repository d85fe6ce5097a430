"""Host-side CTC decoding in numpy (the port's copy of the greedy and
prefix-beam searches of ``m3asr_tpu/decode/ctc.py``)."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np

NEG_INF = -float("inf")


def log_add(args: Sequence[float]) -> float:
    """log(sum(exp(a_i))), stable."""
    if all(a == NEG_INF for a in args):
        return NEG_INF
    a_max = max(args)
    return a_max + math.log(sum(math.exp(a - a_max) for a in args))


def ctc_greedy_search(logits: np.ndarray, out_lens: np.ndarray,
                      blank_idx: int = 0) -> List[List[int]]:
    """argmax -> collapse repeats -> drop blanks. logits: (B, T, V)."""
    argmax = np.asarray(logits).argmax(axis=-1)
    out_lens = np.asarray(out_lens)
    hyps = []
    for b in range(argmax.shape[0]):
        ids = argmax[b, : int(out_lens[b])]
        keep = np.ones(len(ids), dtype=bool)
        keep[1:] = ids[1:] != ids[:-1]
        hyps.append([int(t) for t in ids[keep] if t != blank_idx])
    return hyps


def ctc_prefix_beam_search(
        log_probs: np.ndarray, out_len: int, beam_size: int,
        blank_idx: int = 0) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search for one utterance. log_probs: (T, V)
    log-softmax scores. Returns the n-best [(prefix, log_prob)],
    best first."""
    log_probs = np.asarray(log_probs)
    cur_hyps: List[Tuple[Tuple[int, ...], Tuple[float, float]]] = [
        (tuple(), (0.0, NEG_INF))]
    for t in range(int(out_len)):
        logp = log_probs[t]
        k = min(beam_size, logp.shape[-1])
        cands = [(int(s), float(logp[s]))
                 for s in np.argpartition(logp, -k)[-k:]]
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
