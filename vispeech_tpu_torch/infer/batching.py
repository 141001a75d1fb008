"""Bucketed batch planning for bulk serving (``vispeech_tpu/infer/batching.py``).

Requests are grouped by predicted frame bucket and each bucket's queue is
cut into batch tiers: full batches of the largest tier that fits, the
remainder in the smallest tier that covers it.  Host-side only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# 64-frame spacing through the request-mass region, coarser above
SERVING_BUCKETS: Tuple[int, ...] = (
    64, 128, 192, 256, 320, 384, 448, 512, 576, 640, 704, 768,
    896, 1024, 1152, 1280, 1400,
)

DEFAULT_TIERS: Tuple[int, ...] = (16, 8, 4, 2, 1)


def pick_bucket(n_frames: int, buckets: Sequence[int] = SERVING_BUCKETS) -> int:
    for b in buckets:
        if n_frames <= b:
            return b
    # above the table: a 256-frame granule, not a multiple of the last bucket
    return ((n_frames + 255) // 256) * 256


@dataclass(frozen=True)
class BatchPlan:
    """One dispatch: ``indices`` are request positions (≤ ``tier``; missing
    rows are padding)."""

    bucket: int
    tier: int
    indices: Tuple[int, ...]


def plan_batches(frame_counts: Sequence[int],
                 buckets: Sequence[int] = SERVING_BUCKETS,
                 tiers: Sequence[int] = DEFAULT_TIERS) -> List[BatchPlan]:
    """Every request index lands in exactly one plan."""
    tiers = sorted(tiers, reverse=True)
    by_bucket: Dict[int, List[int]] = {}
    for i, f in enumerate(frame_counts):
        by_bucket.setdefault(pick_bucket(int(f), buckets), []).append(i)
    plans: List[BatchPlan] = []
    for b in sorted(by_bucket):
        idxs = by_bucket[b]
        pos = 0
        while pos < len(idxs):
            rem = len(idxs) - pos
            tier = next((t for t in tiers if t <= rem), tiers[-1])
            take = min(tier, rem)
            plans.append(BatchPlan(b, tier, tuple(idxs[pos:pos + take])))
            pos += take
    return plans
