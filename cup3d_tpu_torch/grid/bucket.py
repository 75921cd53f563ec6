"""Capacity bucketing of the AMR forest (port of
``cup3d_tpu/grid/bucket.py``).

Every mesh adaptation changes the leaf count ``nb``.  Bucketing rounds
the padded block count up a geometric capacity ladder, so a regrid that
stays within a bucket keeps every tensor shape: the caching allocator
reuses its blocks, and the padded tables of a topology are memoised by
octree signature (sim/amr.py).  The JAX package buckets to keep its
compiled executables; eager PyTorch compiles nothing, and the fixed
shapes are what a CUDA graph of the forest step would need.

The padding contract (shared with parallel/forest.py's sharded padding):

- padding rows of all state/geometry tensors stay 0;
- padding-block cell volume is 0, so volume-weighted reductions ignore
  them; per-block spacing ``h`` is 1 on padding (never divides by 0);
- gather tables route padding-block halos to the zero sentinel, so labs
  of padding blocks assemble to 0 and operators output 0 there;
- ``capacity`` is STRICTLY greater than ``nb``, so at least one padding
  block always exists: the inert dump target for padded scatter rows
  (coarse-face writes, flux corrections, fallback rows).

The ladder is per-quantity: block count, per-level shadow counts, coarse
face counts and flux-correction counts each round up independently, so a
bucket is a level-signature class (sim/amr.py keys its operator bundle
on capacity plus the padded geometry's shapes).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

#: default geometric growth of the capacity ladder (~25% max padding)
RATIO = 1.25


def capacity(n: int, ratio: float = RATIO, base: int = 8) -> int:
    """Smallest ladder rung STRICTLY greater than ``n`` (a bucketed forest
    always owns >= 1 padding block: the dump target above)."""
    c = base
    while c <= n:
        c = max(c + 1, int(math.ceil(c * ratio)))
    return c


def count_capacity(n: int, ratio: float = RATIO, base: int = 8) -> int:
    """Ladder rung >= ``n`` for auxiliary row counts (shadow entries,
    coarse-face rows, flux corrections).  0 stays 0: a topology class
    with none of a feature is its own bucket dimension."""
    if n <= 0:
        return 0
    c = base
    while c < n:
        c = max(c + 1, int(math.ceil(c * ratio)))
    return c


def pad_rows(arr, cap: int, fill=0) -> np.ndarray:
    """Pad a host array's leading axis to ``cap`` rows with ``fill``."""
    a = np.asarray(arr)
    if a.shape[0] >= cap:
        return a
    pad = np.full((cap - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def pad_field(field: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-pad a field's block axis to ``cap`` (identity when already
    there)."""
    extra = cap - field.shape[0]
    if extra <= 0:
        return field
    return torch.cat(
        [field, field.new_zeros((extra,) + tuple(field.shape[1:]))])


class PaddedGeom:
    """Duck-typed BlockGrid view over a padded block axis: exactly the
    attributes ops/amr_ops.py and the fused forest driver touch (nb, bs,
    h, ijk, h_column, extent; the JAX package's ``_ArgGeom``).  ``nb`` is
    the padded count; padding blocks get h = 1 (their fields are zero, so
    every operator output on them is 0) and sort after every real block
    in ``ijk`` (the pinned-row corner).  It carries no tree."""

    def __init__(self, grid, nb_pad: int):
        self.bs = grid.bs
        self.nb = nb_pad
        self.extent = grid.extent
        self.h = np.concatenate(
            [grid.h, np.ones(nb_pad - grid.nb, grid.h.dtype)])
        self.ijk = np.concatenate(
            [grid.ijk, np.full((nb_pad - grid.nb, 3),
                               np.iinfo(grid.ijk.dtype).max, grid.ijk.dtype)])
        self._hcol: Dict[tuple, torch.Tensor] = {}

    def h_column(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        key = (str(dtype), str(torch.device(device)))
        if key not in self._hcol:
            self._hcol[key] = torch.as_tensor(
                self.h.reshape(self.nb, 1, 1, 1), dtype=dtype, device=device)
        return self._hcol[key]
