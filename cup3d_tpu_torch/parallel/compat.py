"""The port's counterpart of ``shard_map`` (``cup3d_tpu/parallel/compat.py``).

The JAX package runs each forest kernel inside ``shard_map`` over a 1-D
mesh ``("b",)`` of D devices: every shard sees its ``(nbs, ...)`` slice
of an ``(nb_pad, ...)`` field and its own row of each ``(D, ...)`` table.
The port keeps that layout with the shard axis as a leading batch axis
on one device: a sharded field is the same ``(nb_pad, ...)`` tensor,
viewed as ``(D, nbs, ...)``, and one launch covers every shard.

- A shard-local row index ``idx[s, ...]`` into a per-shard buffer of
  ``n`` rows becomes the row ``s * n + idx[s, ...]`` of the stacked
  ``(D * n, ...)`` buffer (:func:`stacked_rows`, built once on the host
  with the tables); gathers and scatters then run over all shards at
  once (:func:`take_rows`, :func:`put_rows`).
- ``lax.all_to_all(split_axis=0, concat_axis=0)`` of a ``(D, M, ...)``
  send buffer on every shard is, on the stacked ``(D_src, D_dst, M,
  ...)`` tensor, the swap of its first two axes (:func:`all_to_all`).
- ``ppermute`` / ``ring_shift`` by k is the rotation of the shard axis
  by k (parallel/ring.py, kernel B14).
- ``psum`` reductions are plain sums over the padded field: padding
  rows hold zeros and weigh zero.
"""

from __future__ import annotations

import numpy as np
import torch


def shard_view(field: torch.Tensor, D: int) -> torch.Tensor:
    """(nb_pad, ...) -> (D, nbs, ...) view."""
    return field.reshape((D, -1) + tuple(field.shape[1:]))


def unshard_view(x: torch.Tensor) -> torch.Tensor:
    """(D, nbs, ...) -> (D * nbs, ...) view."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def stacked_rows(idx: np.ndarray, n: int) -> np.ndarray:
    """Shard-local rows ``idx`` (D, ...) of per-shard buffers of ``n``
    rows -> rows of the stacked (D * n, ...) buffer (int64)."""
    idx = np.asarray(idx, np.int64)
    D = idx.shape[0]
    off = np.arange(D, dtype=np.int64).reshape((D,) + (1,) * (idx.ndim - 1))
    return idx + off * n


def take_rows(buf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """buf (D, n, ...) stacked per-shard buffers, rows (D, ...) from
    :func:`stacked_rows` -> (D, ..., *buf.shape[2:]): each shard's
    gather from its own buffer."""
    flat = buf.reshape((-1,) + tuple(buf.shape[2:]))
    out = flat.index_select(0, rows.reshape(-1))
    return out.reshape(tuple(rows.shape) + tuple(buf.shape[2:]))


def put_rows(buf: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> None:
    """Each shard's scatter into its own buffer, in place (``rows`` from
    :func:`stacked_rows`; a row written twice must be a scratch row)."""
    flat = buf.view((-1,) + tuple(buf.shape[2:]))
    flat.index_copy_(0, rows.reshape(-1),
                     vals.reshape((-1,) + tuple(buf.shape[2:])))


def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` on every shard:
    send (D_src, D_dst, M, ...) -> recv (D_dst, D_src, M, ...), the chunk
    shard t sent to shard s landing at recv[s, t]."""
    return send.transpose(0, 1).contiguous()
