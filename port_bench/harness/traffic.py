"""The one traffic generator: every mix is a JSON file of parameters
under ``port_bench/mixes/`` that this module reads.

Lengths are drawn as quantiles of their distribution, so that every
seed gets the same set of lengths in another order: the seed changes
which utterance comes when, and the features, not the amount of work.
The offline batches are even the same for every seed, in another order.
Features are fbank-like: a seeded pool of standard normal frames, each
utterance a slice of it with a mean and a scale of its own per feature
bin.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

FRAME_S = 0.01          # one feature frame: 10 ms of audio
POOL_FRAMES = 1 << 15   # the feature pool


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a salt."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths in frames at the mid-quantiles (i + 0.5) / n of the
    mix's length law, clipped to [min, max] and rounded: ``lognormal``
    (``median``, ``sigma``)."""
    if spec["law"] != "lognormal":
        raise ValueError(f"unknown length law {spec['law']!r}")
    u = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(x) for x in u])
    v = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.round(v), spec["min"], spec["max"]).astype(np.int64)


class Features:
    """Seeded fbank-like features: utterance i is ``pool[o_i : o_i + T]``
    times a per-bin scale plus a per-bin mean, both of its own."""

    def __init__(self, seed: int, dim: int):
        r = rng(seed, 1)
        self.dim = dim
        self.pool = r.standard_normal((POOL_FRAMES, dim)).astype(np.float32)
        self.seed = seed

    def utterance(self, i: int, T: int) -> np.ndarray:
        r = rng(self.seed, 2, i)
        o = int(r.integers(0, POOL_FRAMES - T))
        mean = r.normal(0.0, 1.0, self.dim).astype(np.float32)
        scale = r.uniform(0.5, 1.5, self.dim).astype(np.float32)
        return self.pool[o:o + T] * scale + mean


def offline_corpus(mix: dict, seed: int):
    """The offline mixes' corpus: (lengths, batches as lists of corpus
    indices, in serving order). ``corpus`` utterances at the quantile
    lengths are dealt into shards of ``shard`` and sorted by length
    inside each shard (as a recognizer's loader sorts), then cut into
    batches of ``batch``. The dealing is the same for every seed, so
    every seed serves the same batches; the seed orders them (and makes
    the features)."""
    n, shard, batch = mix["corpus"], mix["shard"], mix["batch"]
    lengths = rng(0, 3).permutation(quantile_lengths(mix["lengths"], n))
    order = []
    for s in range(0, n, shard):
        idx = np.arange(s, min(n, s + shard))
        order += list(idx[np.argsort(-lengths[idx], kind="stable")])
    batches = [order[b:b + batch] for b in range(0, n, batch)]
    return lengths, [batches[i] for i in
                     rng(seed, 3).permutation(len(batches))]
