"""Shape bucketing (port of ``m3asr_tpu/runtime/buckets.py``).

Inputs pad up to the smallest bucket that covers them, as the JAX engine
pads, so both engines see the same padded shapes; inputs beyond the top
bucket are rejected.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

DEFAULT_LENGTHS = (256, 512, 1024, 2048, 4096, 6144)
DEFAULT_BATCHES = (1, 2, 4, 8)


@dataclass(frozen=True)
class BucketSpec:
    lengths: Tuple[int, ...] = DEFAULT_LENGTHS
    batches: Tuple[int, ...] = DEFAULT_BATCHES

    def pick(self, batch: int, length: int) -> Tuple[int, int]:
        """Smallest (batch, length) bucket covering the input; raises
        ValueError beyond the top bucket."""
        b = next((x for x in self.batches if x >= batch), None)
        t = next((x for x in self.lengths if x >= length), None)
        if b is None:
            raise ValueError(
                f"batch {batch} exceeds max bucket {self.batches[-1]}")
        if t is None:
            raise ValueError(
                f"length {length} exceeds max bucket {self.lengths[-1]}")
        return b, t

    def all_buckets(self) -> List[Tuple[int, int]]:
        return [(b, t) for b in self.batches for t in self.lengths]
