"""The collectives of the sharded megaloop on one device (port of
``cup3d_tpu/parallel/collectives.py``).

The JAX package's wrappers run inside ``shard_map``, where each shard
holds its own block.  Here the D shards are the leading axis of one
tensor on one device (parallel/compat.py), so every collective is an
operation over that axis:

- :func:`all_gather_tiled` -- the shards' blocks concatenated along a
  per-shard axis: on one device the unsharded VIEW of the stacked
  tensor, not D copies;
- :func:`pmax_axis` -- ``amax`` over the shard axis (fp max is exactly
  associative: bitwise the unsharded max);
- :func:`psum_axis` -- the sum over the shard axis in the fixed shard
  order 0, 1, ..., D-1; bf16 or f16 operands accumulate in f32 first
  (the JAX package's precision policy for sum-reductions over bf16
  storage).
"""

from __future__ import annotations

import torch


def all_gather_tiled(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """x (D, ...) stacked shard blocks -> the blocks concatenated along
    their ``axis``: (D * n, ...) for ``axis`` 0, a view of ``x`` (a copy
    only where ``axis`` > 0 makes the merged axes non-adjacent in
    memory)."""
    if axis:
        x = x.movedim(0, axis)
    shape = tuple(x.shape)
    return x.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],)
                     + shape[axis + 2:])


def pmax_axis(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the shard axis of x (D, ...)."""
    return torch.amax(x, dim=0)


def psum_axis(x: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the shard axis of x (D, ...), shard by shard
    in shard order; half-precision operands sum in f32 (and stay f32)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    acc = x[0]
    for s in range(1, x.shape[0]):
        acc = acc + x[s]
    return acc
