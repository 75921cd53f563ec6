"""Capacity ladder of the forest's padded counts (port of
``cup3d_tpu/grid/bucket.py``: ``RATIO`` and ``count_capacity`` only).

The block-sharded forest (parallel/forest.py) rounds its per-shard block
count up this ladder, so its padded block count, its shard cuts and
every exchange table are the JAX package's own.  The bucketed
single-device forest's capacity padding (``capacity``, ``pad_rows``,
``pad_field``) waits for ROADMAP A4.
"""

from __future__ import annotations

import math

#: default geometric growth of the capacity ladder (~25% max padding)
RATIO = 1.25


def count_capacity(n: int, ratio: float = RATIO, base: int = 8) -> int:
    """Ladder rung >= ``n`` (0 stays 0)."""
    if n <= 0:
        return 0
    c = base
    while c < n:
        c = max(c + 1, int(math.ceil(c * ratio)))
    return c
