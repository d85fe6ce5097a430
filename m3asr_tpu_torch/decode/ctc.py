"""Host-side CTC decoding in numpy: the port's copy of
``m3asr_tpu/decode/ctc.py``. Greedy and prefix-beam searches over dense
logits and over the engine's on-device outputs (``argmax`` ids with
their log-probs, ``topk`` candidates); the extended prefix beam
(:class:`PrefixBeamState`, ``ctc_prefix_beam_search[_sparse]_ext``) with
per-token emission frames, :class:`ContextTrie` hotword biasing and
n-gram LM shallow fusion (``decode/lm.py``). The extended searches keep
the JAX package's dict iteration and sort order, so their n-best lists
are equal entry for entry, ties included."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -float("inf")


class Hyp(NamedTuple):
    """One hypothesis: token ids, its summed log score, and the emission
    frame of each token (post-subsampling frame index)."""
    tokens: Tuple[int, ...]
    score: float
    times: Tuple[int, ...]


class ContextTrie:
    """Prefix trie over token sequences for context biasing (hotwords).

    Each decoding prefix carries a trie state; advancing along a phrase
    adds ``bonus`` per matched token, and diverging refunds the bonus of
    the unfinished suffix (completed phrases along the path keep
    theirs). On a mismatch the token is retried from the root (no
    Aho-Corasick fail links), which is exact for phrase sets without
    overlapping suffix/prefix structure."""

    def __init__(self, phrases: Sequence[Sequence[int]],
                 bonus: float = 3.0):
        self.bonus = float(bonus)
        self.children: List[dict] = [{}]
        self.depth: List[int] = [0]
        self.is_end: List[bool] = [False]
        for ph in phrases:
            node = 0
            for tok in ph:
                tok = int(tok)
                nxt = self.children[node].get(tok)
                if nxt is None:
                    nxt = len(self.children)
                    self.children.append({})
                    self.depth.append(self.depth[node] + 1)
                    self.is_end.append(False)
                    self.children[node][tok] = nxt
                node = nxt
            if node != 0:
                self.is_end[node] = True
        # refund[n] = tokens matched since the last completed phrase on
        # the path to n (what a mismatch or finalize at n pays back)
        self.refund: List[int] = [0] * len(self.children)
        stack = [0]
        while stack:
            node = stack.pop()
            for child in self.children[node].values():
                self.refund[child] = (0 if self.is_end[child]
                                      else self.refund[node] + 1)
                stack.append(child)

    def advance(self, state: int, token: int) -> Tuple[int, float]:
        """Consume ``token`` from ``state``; returns (new_state,
        score_delta)."""
        child = self.children[state].get(token)
        delta = 0.0
        if child is None:
            # diverged: refund the unfinished partial match, then retry
            # this token from the root
            delta -= self.bonus * self.refund[state]
            child = self.children[0].get(token)
            if child is None:
                return 0, delta
        delta += self.bonus
        if not self.children[child]:
            return 0, delta  # leaf: phrase complete, back to the root
        return child, delta

    def finalize(self, state: int) -> float:
        """Score delta for ending the utterance at ``state`` (refunds any
        unfinished partial match)."""
        return -self.bonus * self.refund[state]


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


class PrefixBeamState:
    """The extended prefix beam as a stateful object: streaming decoders
    :meth:`advance` chunk by chunk and read :meth:`nbest` at any point.
    Carries per-prefix emission frames (absolute, across chunks), context
    trie states and LM fusion states."""

    def __init__(self, beam_size: int, blank_idx: int = 0,
                 context: Optional[ContextTrie] = None,
                 lm=None, lm_weight: float = 0.5):
        self.beam_size = beam_size
        self.blank_idx = blank_idx
        self.context = context
        self.lm = lm
        self.lm_weight = lm_weight
        self.t = 0  # absolute frame counter
        lm0 = lm.start() if lm is not None else None
        # prefix -> [pb, pnb, times, last_prob, best_nb, ctx_state,
        #            ctx_score, lm_state, lm_score]
        #   times:     emission frame per token (tuple)
        #   last_prob: frame log-prob that set times[-1] (peak tracking)
        #   best_nb:   strongest single contribution seen this frame; its
        #              path's times win on prefix merges
        self.cur = {(): [0.0, NEG_INF, (), NEG_INF, NEG_INF, 0, 0.0,
                         lm0, 0.0]}

    def advance(self, log_probs: np.ndarray) -> None:
        """Consume (T, V) log-softmax frames."""
        for row in np.asarray(log_probs):
            k = min(self.beam_size, row.shape[-1])
            self._advance_frame_cands(
                [(int(s), float(row[s]))
                 for s in np.argpartition(row, -k)[-k:]])

    def advance_sparse(self, values: np.ndarray,
                       indices: np.ndarray) -> None:
        """Consume (T, K) per-frame top-K log-softmax values and token ids
        (the engine's ``decode_output="topk"``, best first): the
        hypotheses of :meth:`advance` on the dense rows when
        K >= beam_size, whose first prune is the same top-k."""
        values = np.asarray(values)
        indices = np.asarray(indices)
        k = min(self.beam_size, values.shape[-1])
        for vrow, irow in zip(values, indices):
            self._advance_frame_cands(
                [(int(irow[i]), float(vrow[i])) for i in range(k)])

    def _advance_frame_cands(self, cands) -> None:
        """One frame of the prefix recursion over a [(token, log_prob)]
        candidate list."""
        context, lm, lm_weight = self.context, self.lm, self.lm_weight
        t = self.t
        next_hyps: dict = {}

        def entry(prefix, parent, s=None):
            """The accumulator of ``prefix``, created on first use. Context
            and LM states are functions of the tokens, computed once, from
            the source entry ``parent`` (extended by ``s`` when the source
            is prefix[:-1])."""
            e = next_hyps.get(prefix)
            if e is None:
                cstate, cscore = parent[5], parent[6]
                lstate, lscore = parent[7], parent[8]
                if s is None:  # same-prefix source: inherit ctx and times
                    times0, lp0 = parent[2], parent[3]
                else:
                    times0, lp0 = parent[2] + (t,), NEG_INF
                    if context is not None:
                        cstate, d = context.advance(cstate, s)
                        cscore = parent[6] + d
                    if lm is not None:
                        lstate, lp_lm = lm.score(lstate, s)
                        lscore = parent[8] + lm_weight * lp_lm
                e = [NEG_INF, NEG_INF, times0, lp0, NEG_INF,
                     cstate, cscore, lstate, lscore]
                next_hyps[prefix] = e
            return e

        def offer_times(e, contrib, times, last_prob):
            """Keep the times of the strongest contribution."""
            if contrib > e[4]:
                e[4] = contrib
                e[2] = times
                e[3] = last_prob

        for s, ps in cands:
            for prefix, src in self.cur.items():
                pb, pnb, times, last_prob = src[0], src[1], src[2], src[3]
                last = prefix[-1] if prefix else None
                if s == self.blank_idx:
                    e = entry(prefix, src)
                    e[0] = log_add([e[0], pb + ps, pnb + ps])
                    offer_times(e, log_add([pb + ps, pnb + ps]), times,
                                last_prob)
                elif s == last:
                    # stay: *ss -> *s; the last token's peak frame may
                    # move to t
                    e = entry(prefix, src)
                    if ps > last_prob:
                        st, sl = times[:-1] + (t,), ps
                    else:
                        st, sl = times, last_prob
                    e[1] = log_add([e[1], pnb + ps])
                    offer_times(e, pnb + ps, st, sl)
                    # extend via blank: *s-s -> *ss
                    e = entry(prefix + (s,), src, s)
                    e[1] = log_add([e[1], pb + ps])
                    offer_times(e, pb + ps, times + (t,), ps)
                else:
                    e = entry(prefix + (s,), src, s)
                    contrib = log_add([pb + ps, pnb + ps])
                    e[1] = log_add([e[1], contrib])
                    offer_times(e, contrib, times + (t,), ps)
        pruned = sorted(
            next_hyps.items(),
            key=lambda x: log_add([x[1][0], x[1][1]]) + x[1][6] + x[1][8],
            reverse=True)
        self.cur = dict(pruned[:self.beam_size])
        self.t = t + 1

    def nbest(self) -> List[Hyp]:
        """Current hypotheses, best first; final scores apply the context
        refunds as if the utterance ended here."""
        out = []
        for prefix, e in self.cur.items():
            score = log_add([e[0], e[1]]) + e[6] + e[8]
            if self.context is not None:
                score += self.context.finalize(e[5])
            out.append(Hyp(prefix, score, e[2]))
        out.sort(key=lambda h: h.score, reverse=True)
        return out


def ctc_prefix_beam_search_ext(
        log_probs: np.ndarray, out_len: int, beam_size: int,
        blank_idx: int = 0, context: Optional[ContextTrie] = None,
        lm=None, lm_weight: float = 0.5) -> List[Hyp]:
    """Prefix beam search with per-token emission frames (the frame of
    each token's probability peak; the strongest path wins on prefix
    merges), optional context biasing (``context``; unfinished partial
    matches are refunded at the end) and optional n-gram shallow fusion
    (``lm``, adding ``lm_weight * ln P_lm(tok | state)`` per emitted
    token). log_probs: (T, V) log-softmax scores. Returns Hyps, best
    first."""
    state = PrefixBeamState(beam_size, blank_idx, context, lm, lm_weight)
    state.advance(np.asarray(log_probs)[:int(out_len)])
    return state.nbest()


def ctc_prefix_beam_search_sparse_ext(
        values: np.ndarray, indices: np.ndarray, out_len: int,
        beam_size: int, blank_idx: int = 0,
        context: Optional[ContextTrie] = None,
        lm=None, lm_weight: float = 0.5) -> List[Hyp]:
    """:func:`ctc_prefix_beam_search_ext` over the engine's (T, K) top-K
    output (``decode_output="topk"``); the same hypotheses when
    K >= beam_size."""
    state = PrefixBeamState(beam_size, blank_idx, context, lm, lm_weight)
    state.advance_sparse(np.asarray(values)[:int(out_len)],
                         np.asarray(indices)[:int(out_len)])
    return state.nbest()
