"""Text metrics: edit distance, CER/WER.

The reference publishes no CER tooling (BASELINE.md: accuracy standard
is logits allclose); serving parity ultimately needs CER, so the
framework ships it.

The port's numpy copy of ``m3asr_tpu/utils/text.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein distance with S/D/I breakdown."""
    R, H = len(ref), len(hyp)
    d = np.zeros((R + 1, H + 1), np.int32)
    d[:, 0] = np.arange(R + 1)
    d[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            sub = d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    # backtrace for S/D/I counts
    i, j = R, H
    counts = {"sub": 0, "del": 0, "ins": 0}
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] and \
                ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            counts["sub"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            counts["del"] += 1
            i -= 1
        else:
            counts["ins"] += 1
            j -= 1
    return int(d[R, H]), counts


def cer(refs: List[Sequence], hyps: List[Sequence]) -> float:
    """Token error rate over a corpus (CER when tokens are chars)."""
    errs = 0
    total = 0
    for r, h in zip(refs, hyps):
        e, _ = edit_distance(list(r), list(h))
        errs += e
        total += len(r)
    return errs / max(total, 1)
