"""The comparison that decides ``correct``.

Each answer the program served in the window and the sample holds is
compared, frame by frame, with the reference's logits for the same
input, computed here after the window. Four numbers, each over the
whole sample:

* ``rel_err``: the worst answer's ||program - reference|| /
  ||reference|| (Frobenius, over its valid frames);
* ``gap_mean``: the mean over all frames of the amount by which the
  reference's logit of the program's best token lies below the
  reference's best logit (0 where they pick the same token);
* ``gap_max``: the largest such amount at any frame;
* ``flip_share``: the share of frames whose best token differs.

A number passes where it is at most its limit (the configuration's
``limits``). The limits and the readings they were set from are in
``PERF.md``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("rel_err", "gap_mean", "gap_max", "flip_share")


def compare(pairs, device) -> dict:
    """pairs: (program logits (T, V) numpy, reference logits (T, V)
    tensor). Returns the four numbers (NaN where the program's logits
    are not finite: a failure)."""
    rel, gap_sum, gap_max, flips, frames = 0.0, 0.0, 0.0, 0, 0
    for got, ref in pairs:
        g = torch.as_tensor(np.asarray(got), dtype=torch.float32,
                            device=device)
        r = ref.to(device=device, dtype=torch.float32)
        if g.shape != r.shape:
            return {k: math.inf for k in NUMBERS}
        if not torch.isfinite(g).all():
            return {k: math.nan for k in NUMBERS}
        rel = max(rel, float((g - r).norm() / r.norm().clamp(min=1e-30)))
        pick = g.argmax(-1)
        best = r.max(-1).values
        gap = best - r.gather(-1, pick[:, None])[:, 0]
        gap_sum += float(gap.sum())
        gap_max = max(gap_max, float(gap.max()))
        flips += int((pick != r.argmax(-1)).sum())
        frames += g.shape[0]
    frames = max(frames, 1)
    return {"rel_err": rel, "gap_mean": gap_sum / frames,
            "gap_max": gap_max, "flip_share": flips / frames}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def lines(numbers: dict, limits: dict, prefix: str = "") -> list:
    return [f"{prefix}{k} {numbers[k]!r} limit {limits[k]!r}"
            for k in limits]
