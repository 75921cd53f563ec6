"""3-D Hilbert space-filling curve (Skilling's transpose algorithm) over the
block index space of every AMR level, plus the cross-level global ordering
key (reference SpaceFillingCurve, main.cpp:95-319).  A numpy copy of
``cup3d_tpu/grid/sfc.py``: the port imports nothing of the JAX package.

The curve serves one purpose on TPU: a locality-preserving *ordering* of
leaf blocks, so that slicing the block axis into contiguous device shards
puts spatially-adjacent blocks on the same device and halo gathers mostly
stay local.  All functions are host-side NumPy; results feed the gather
tables, never the jitted graph.
"""

from __future__ import annotations

import numpy as np


def _axes_to_transpose(x: np.ndarray, bits: int) -> np.ndarray:
    """Map 3-D coordinates to the Hilbert 'transpose' form, vectorized over
    the leading axis of ``x`` (shape (..., 3), values < 2**bits)."""
    x = np.array(x, dtype=np.uint32, copy=True)
    n = 3
    # Gray decode: inverse undo excess work
    m = np.uint32(1) << np.uint32(bits - 1)
    q = np.uint32(m)
    while q > 1:
        p = np.uint32(q - 1)
        for i in range(n):
            hit = (x[..., i] & q) != 0
            # invert low bits of x[0] where hit
            x[..., 0] = np.where(hit, x[..., 0] ^ p, x[..., 0])
            # exchange low bits of x[i] and x[0] where not hit
            t = (x[..., 0] ^ x[..., i]) & p
            x[..., 0] = np.where(hit, x[..., 0], x[..., 0] ^ t)
            x[..., i] = np.where(hit, x[..., i], x[..., i] ^ t)
        q >>= 1
    # Gray encode
    for i in range(1, n):
        x[..., i] ^= x[..., i - 1]
    t = np.zeros_like(x[..., 0])
    q = np.uint32(m)
    while q > 1:
        t = np.where((x[..., n - 1] & q) != 0, t ^ np.uint32(q - 1), t)
        q >>= 1
    for i in range(n):
        x[..., i] ^= t
    return x


def hilbert_index(ijk, bits: int) -> np.ndarray:
    """Hilbert distance of 3-D block coords (..., 3) on a 2**bits cube."""
    ijk = np.atleast_2d(np.asarray(ijk, dtype=np.uint32))
    tr = _axes_to_transpose(ijk, bits)
    # interleave: bit b of axis a -> output bit (bits-1-b)*3 + (2-a)... the
    # transpose form stores the index bit-planes across the 3 coordinates.
    d = np.zeros(tr.shape[:-1], dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for a in range(3):
            d = (d << np.uint64(1)) | ((tr[..., a] >> np.uint32(b)) & 1).astype(
                np.uint64
            )
    return d


def global_order_key(level, ijk, level_max: int, bpd) -> np.ndarray:
    """Cross-level ordering key (reference Encode, main.cpp:287-318): a
    block's key equals the Hilbert index its region's first finest-level
    descendant would have, so children sort inside their parent's range and
    leaf order is a depth-first traversal of the forest.

    bpd: base (level-0) blocks per dimension, used only to size the
    enclosing power-of-two cube.
    """
    level = np.asarray(level)
    ijk = np.atleast_2d(np.asarray(ijk, dtype=np.uint64))
    max_bpd = int(max(bpd)) << (level_max - 1)
    bits = max(1, int(np.ceil(np.log2(max_bpd))))
    shift = (level_max - 1 - level).astype(np.uint64)
    fine_ijk = (ijk << shift[..., None]).astype(np.uint32)
    d = hilbert_index(fine_ijk, bits)
    # pad so distinct levels of the same region stay distinct & ordered
    return d * np.uint64(level_max) + level.astype(np.uint64)
