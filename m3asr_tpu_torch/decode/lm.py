"""ARPA n-gram language model for shallow fusion in the CTC prefix beam
(the port's copy of ``m3asr_tpu/decode/lm.py``): an ARPA backoff reader
and an incremental scorer whose state is the longest matching context
suffix, fused into ``decode/ctc.py``'s extended searches as
``score += lm_weight * ln P(tok | state)`` per emitted token, on the
host.

Token vocabulary: ARPA "words" map to the model's output-unit ids
through an optional symbol table (Kaldi ``units.txt`` convention:
``symbol id`` per line); without a table the ARPA words must themselves
be integer ids.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

LOG10 = math.log(10.0)


def read_symbol_table(path: str) -> Dict[str, int]:
    """Kaldi-style symbol table: ``symbol id`` per line."""
    sym = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                sym[parts[0]] = int(parts[1])
    return sym


class NgramLM:
    """ARPA backoff n-gram over token ids.

    Internally: ngram tables ``logp[(h..., w)] -> natural-log prob`` and
    ``backoff[(h...,)] -> natural-log backoff weight`` (absent = 0).
    Scoring follows the standard Katz backoff recursion:

        P(w | h) = P_table(w | h)                  if (h, w) listed
                 = b(h) * P(w | h[1:])             otherwise
    """

    BOS = -1   # sentinel ids for <s> / </s> (never valid output units)
    EOS = -2
    UNK = -3

    def __init__(self, arpa_path: str,
                 symbol_table: Optional[Dict[str, int]] = None):
        self.logp: Dict[Tuple[int, ...], float] = {}
        self.backoff: Dict[Tuple[int, ...], float] = {}
        self.order = 0
        special = {"<s>": self.BOS, "</s>": self.EOS, "<unk>": self.UNK,
                   "<UNK>": self.UNK}

        def to_id(word: str) -> Optional[int]:
            if word in special:
                return special[word]
            if symbol_table is not None:
                return symbol_table.get(word)
            try:
                return int(word)
            except ValueError:
                return None

        with open(arpa_path) as fh:
            section = 0  # current n of the \n-grams: block (0 = header)
            for line in fh:
                line = line.strip()
                if not line or line.startswith("ngram "):
                    continue
                if line == "\\data\\":
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if section == 0:
                    continue
                parts = line.split()
                # logp w1 ... wn [backoff]
                if len(parts) < section + 1:
                    continue
                lp = float(parts[0]) * LOG10
                ids = tuple(to_id(w) for w in parts[1:section + 1])
                if any(i is None for i in ids):
                    continue  # word outside the unit vocabulary
                self.logp[ids] = lp
                if len(parts) > section + 1:
                    self.backoff[ids] = float(parts[section + 1]) * LOG10

    def start(self) -> Tuple[int, ...]:
        """Initial state: the <s> context."""
        return self._shrink((self.BOS,))

    def _shrink(self, hist: Tuple[int, ...]) -> Tuple[int, ...]:
        """Longest suffix of ``hist`` that exists as a context (can
        extend some listed ngram); everything longer backs off anyway."""
        hist = hist[-(self.order - 1):] if self.order > 1 else ()
        while hist and hist not in self.backoff and hist not in self.logp:
            hist = hist[1:]
        return hist

    def _logp_backoff(self, hist: Tuple[int, ...], w: int) -> float:
        p = self.logp.get(hist + (w,))
        if p is not None:
            return p
        if not hist:
            # unigram fallback: <unk> if listed, else a hard floor
            p = self.logp.get((self.UNK,))
            return p if p is not None else -20.0 * LOG10
        return self.backoff.get(hist, 0.0) + self._logp_backoff(hist[1:], w)

    def score(self, state: Tuple[int, ...], token: int
              ) -> Tuple[Tuple[int, ...], float]:
        """Consume ``token`` from ``state``; returns (new_state, ln P)."""
        lp = self._logp_backoff(state, token)
        return self._shrink(state + (token,)), lp

    def score_eos(self, state: Tuple[int, ...]) -> float:
        """ln P(</s> | state) — optional end-of-utterance term."""
        return self._logp_backoff(state, self.EOS)

    def to_arrays(self):
        """Flatten the tables for the native (C++) twin: (ids, offsets,
        logps, backoffs): concatenated ngram ids, (n+1) prefix offsets,
        and per-ngram natural-log prob and backoff (0 when unlisted)."""
        items = list(self.logp.items())
        if items:
            ids = np.concatenate([np.asarray(k, np.int32)
                                  for k, _ in items])
        else:
            ids = np.zeros(0, np.int32)
        offsets = np.cumsum([0] + [len(k) for k, _ in items]).astype(
            np.int32)
        logps = np.asarray([v for _, v in items], np.float32)
        backoffs = np.asarray([self.backoff.get(k, 0.0) for k, _ in items],
                              np.float32)
        return ids, offsets, logps, backoffs
