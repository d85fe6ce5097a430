"""Data-driven bucket-ladder tuning (port of
``m3asr_tpu/runtime/bucket_tuner.py``).

Variable length is served by padding to a static bucket ladder
(``runtime/buckets.py``), so the ladder is the performance policy: every
utterance pays the cost of the smallest bucket that covers it. Given a
corpus length histogram, :func:`tune_lengths` picks the K-bucket ladder
that minimises the expected per-utterance cost: an exact O(C^2 K)
dynamic program over aligned candidate boundaries.

Cost model: per serving mode, a quadratic in input frames through the
card's own points (:data:`MODE_POINTS`): the graph replay time of the
flagship's 1x206, 1x2048 and 1x6144 buckets, by CUDA events, from a
``chip_smoke.py`` run. Pass ``cost_table`` (frames -> ms) to tune for
another card or model, or ``mode`` to pick a serving mode's curve.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from m3asr_tpu_torch.runtime.buckets import DEFAULT_LENGTHS

# Graph replay ms (median of 5, CUDA events) of the flagship's auto
# engines at 1x206, 1x2048 and the largest bucket, 1x6144: chip_smoke.py
# phase 8 ("graphs <mode> tuner points") on an NVIDIA H100 80GB HBM3 at
# 700.00 W (run 11b of PERF.md). int8 and w8a8 cost more at 1x206 (63
# tokens: the plain quant stage dequantizes every expert) than their
# quadratic's minimum near 656 / 1920 frames (K4).
MODE_POINTS: Dict[str, Dict[int, float]] = {
    "float32": {206: 10.879, 2048: 19.089, 6144: 38.948},
    "bfloat16": {206: 10.512, 2048: 15.247, 6144: 28.679},
    "int8": {206: 14.711, 2048: 15.507, 6144: 28.546},
    "w8a8": {206: 16.509, 2048: 14.403, 6144: 27.322},
    "int4": {206: 10.881, 2048: 15.580, 6144: 28.522},
    "w4a8": {206: 11.203, 2048: 13.943, 6144: 27.073},
}


def _fit_mode(points: Dict[int, float]) -> Tuple[float, float, float]:
    x = np.array(sorted(points), np.float64)
    y = np.array([points[int(t)] for t in sorted(points)], np.float64)
    a, b, c = np.polyfit(x, y, 2)[::-1]
    return float(a), float(b), float(c)


MODE_FITS = {m: _fit_mode(p) for m, p in MODE_POINTS.items()}


def default_cost(length, mode: str = "float32") -> np.ndarray:
    """The fitted replay time (ms) at ``length`` input frames for the
    serving mode (float32|bfloat16|int8|w8a8|int4|w4a8)."""
    a, b, c = MODE_FITS[mode]
    t = np.asarray(length, np.float64)
    return a + b * t + c * t * t


def _cost_fn(cost_table: Optional[Dict[int, float]], mode: str = "float32"):
    if cost_table is None:
        return functools.partial(default_cost, mode=mode)
    xs = np.array(sorted(cost_table), np.float64)
    ys = np.array([cost_table[int(x)] for x in xs], np.float64)

    def interp(length):
        t = np.asarray(length, np.float64)
        # linear interpolation, linear extrapolation on the last slope
        out = np.interp(t, xs, ys)
        if xs.size >= 2:
            slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
            out = np.where(t > xs[-1], ys[-1] + (t - xs[-1]) * slope, out)
        return out

    return interp


def expected_cost(lengths: Sequence[int], ladder: Sequence[int],
                  cost_table: Optional[Dict[int, float]] = None,
                  mode: str = "float32") -> float:
    """Mean per-utterance cost (ms) of ``ladder`` on ``lengths``. Raises
    if the ladder does not cover the longest utterance (the engine would
    reject it too, ``BucketSpec.pick``)."""
    lengths = np.asarray(lengths)
    ladder = np.sort(np.asarray(ladder))
    if lengths.max() > ladder[-1]:
        raise ValueError(f"max length {lengths.max()} exceeds ladder "
                         f"top {ladder[-1]}")
    cost = _cost_fn(cost_table, mode)
    idx = np.searchsorted(ladder, lengths, side="left")
    return float(np.mean(cost(ladder[idx])))


def tune_lengths(lengths: Iterable[int], k: int, align: int = 128,
                 cost_table: Optional[Dict[int, float]] = None,
                 max_candidates: int = 512,
                 mode: str = "float32") -> Tuple[int, ...]:
    """The K-length ladder minimising the expected cost.

    Candidates are multiples of ``align`` covering the data. Exact DP:
    dp[j][i] is the best cost of covering every utterance <= cand[i] with
    j buckets whose top is cand[i]; a transition adds cand[i]'s cost for
    every utterance in (cand[i'], cand[i]]."""
    lengths = np.asarray(sorted(int(x) for x in lengths))
    if not lengths.size or k < 1:
        raise ValueError("need lengths and k >= 1")
    cost = _cost_fn(cost_table, mode)
    top = int(-(-int(lengths[-1]) // align) * align)
    cands = np.arange(align, top + 1, align, dtype=np.int64)
    if cands.size > max_candidates:  # coarsen, keep the exact top
        step = -(-cands.size // max_candidates)
        cands = np.unique(np.concatenate([cands[::step], cands[-1:]]))
    C = cands.size
    n_le = np.searchsorted(lengths, cands, side="right")  # <= cands[i]
    bucket_cost = cost(cands)

    dp = np.full((k + 1, C), np.inf)
    parent = np.full((k + 1, C), -1, np.int64)
    dp[1] = bucket_cost * n_le   # one bucket at cands[i] covers n_le[i]
    for j in range(2, k + 1):
        for i in range(C):
            prev = dp[j - 1, :i] + bucket_cost[i] * (n_le[i] - n_le[:i])
            if prev.size:
                best = int(np.argmin(prev))
                dp[j, i] = prev[best]
                parent[j, i] = best

    # the ladder must cover the longest utterance: its top is cands[-1]
    ladder = [int(cands[-1])]
    j, i = k, C - 1
    while j > 1 and parent[j, i] >= 0:
        i = int(parent[j, i])
        j -= 1
        ladder.append(int(cands[i]))
    return tuple(sorted(set(ladder)))


def tune_report(lengths: Sequence[int], k: int, align: int = 128,
                cost_table: Optional[Dict[int, float]] = None,
                baseline: Optional[Sequence[int]] = None,
                mode: str = "float32") -> Dict:
    """Tune and compare with a baseline ladder (default: DEFAULT_LENGTHS,
    doubled until it covers the data)."""
    lengths = np.asarray(sorted(int(x) for x in lengths))
    ladder = tune_lengths(lengths, k, align=align, cost_table=cost_table,
                          mode=mode)
    tuned = expected_cost(lengths, ladder, cost_table, mode=mode)
    if baseline is None:
        baseline = list(DEFAULT_LENGTHS)
        while baseline[-1] < lengths[-1]:
            baseline.append(baseline[-1] * 2)
    base = expected_cost(lengths, baseline, cost_table, mode=mode)
    ideal = float(np.mean(_cost_fn(cost_table, mode)(lengths)))
    return {
        "mode": mode,
        "ladder": list(ladder),
        "expected_ms_per_utt": round(tuned, 3),
        "baseline_ladder": list(baseline),
        "baseline_ms_per_utt": round(base, 3),
        "ideal_ms_per_utt": round(ideal, 3),  # zero-padding lower bound
        "saving_vs_baseline_pct": round(100 * (1 - tuned / base), 1),
        "padding_overhead_pct": round(100 * (tuned / ideal - 1), 1),
        "n_utts": int(lengths.size),
    }
