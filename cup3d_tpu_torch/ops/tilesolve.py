"""Exact 8^3-tile Poisson solve by fast diagonalization — the getZ
preconditioner (port of ``cup3d_tpu/ops/tilesolve.py``).

The zero-Dirichlet 7-point Laplacian on a fixed bs^3 tile is
diagonalized by the bs-point DST-I, so the exact tile inverse is
``S3 diag(1/lam) S3`` with ``S3 = S1 (x) S1 (x) S1`` (S1 symmetric and
orthogonal).  The plain versions here apply it as two (512, 512) f32
matmuls, on the lanes layout (uniform grid) or on blocks (the AMR
forest); the CUDA getZ kernels (csrc/fused_bicgstab.cu) apply the same
operator as three 8-point axis transforms each way.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import upload
from cup3d_tpu_torch.ops import precision


@lru_cache(maxsize=None)
def _basis_np(bs: int, np_dtype: str):
    """(S3, lam512, W) for the bs^3 zero-Dirichlet tile, built in f64 and
    cast to ``np_dtype`` — the JAX package's construction."""
    i = np.arange(1, bs + 1)
    S1 = np.sqrt(2.0 / (bs + 1)) * np.sin(np.pi * np.outer(i, i) / (bs + 1))
    lam1 = 4.0 * np.sin(np.pi * i / (2 * (bs + 1))) ** 2  # eig of -[1,-2,1]
    lam3 = (lam1[:, None, None] + lam1[None, :, None]
            + lam1[None, None, :]).reshape(bs ** 3)
    S3 = np.einsum("ai,bj,ck->abcijk", S1, S1, S1).reshape(bs ** 3, bs ** 3)
    W = (S3 * (1.0 / lam3)) @ S3.T
    dt = np.dtype(np_dtype)
    return (S3.astype(dt), lam3.astype(dt), W.astype(dt))


@lru_cache(maxsize=None)
def basis(bs: int, dtype: torch.dtype, device: str):
    """(S3 (bs^3, bs^3), lam3 (bs^3,), S1 (bs, bs)) as tensors of
    ``dtype`` on ``device``, uploaded once per device (at the first
    preconditioned iteration: through pinned memory, no wait)."""
    S3, lam3, _ = _basis_np(bs, str(dtype).replace("torch.", ""))
    i = np.arange(1, bs + 1)
    S1 = np.sqrt(2.0 / (bs + 1)) * np.sin(np.pi * np.outer(i, i) / (bs + 1))
    return tuple(upload(a, dtype, device, tag="table-upload")
                 for a in (S3, lam3, S1))


def dense_operator(bs: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The exact tile inverse ``S3 diag(1/lam) S3`` as one dense (bs^3,
    bs^3) matrix (symmetric): a row of tile values times it is the tile
    solve, so one ``torch.matmul`` computes the tile-only getZ's function
    (the library yardstick of chip_smoke.py and tools/kernel_ab.py)."""
    W = _basis_np(bs, str(dtype).replace("torch.", ""))[2]
    return torch.as_tensor(W, dtype=dtype, device=device)


def _on_device(shift, dtype, device) -> torch.Tensor:
    """A shift on the device: a host scalar written by a fill kernel (an
    upload from pageable memory would wait for the device)."""
    if isinstance(shift, (int, float, np.floating)):
        return torch.full((), float(shift), dtype=dtype, device=device)
    return torch.as_tensor(shift, dtype=dtype, device=device)


def tile_solve_blocks(b: torch.Tensor, shift=None) -> torch.Tensor:
    """Solve (-lap_tile + shift) z = b exactly on every trailing bs^3 tile
    of ``b`` (shape (..., bs, bs, bs)).  ``shift``: None (the Poisson
    getZ), a scalar, or a tensor broadcastable over the leading dims (the
    forest Helmholtz's per-block h^2/(nu dt), (nb, 1, 1, 1))."""
    bs = b.shape[-1]
    lead = tuple(b.shape[:-3])
    n = int(np.prod(lead)) if lead else 1
    acc = precision.accum_dtype(b.dtype)
    S3, lam3, _ = basis(bs, acc, str(b.device))
    b2 = b.reshape(n, bs ** 3).to(acc)
    if b.is_cuda:
        precision.check_fp32_matmul()
    t = b2 @ S3  # S3 symmetric: rows @ S3
    if shift is None:
        t = t / lam3[None, :]
    else:
        sh = torch.broadcast_to(_on_device(shift, acc, b.device),
                                lead + (1, 1, 1)).reshape(n, 1)
        t = t / (lam3[None, :] + sh)
    z = t @ S3
    return z.reshape(b.shape).to(b.dtype)


def tile_solve_lanes(bt: torch.Tensor, shift=None) -> torch.Tensor:
    """Solve (-lap_tile + shift) z = b exactly on every tile of the lanes
    layout (bs, bs, bs, T).  ``shift``: None, scalar, or (T,) lanes."""
    bs = bt.shape[0]
    T = bt.shape[-1]
    acc = precision.accum_dtype(bt.dtype)
    S3, lam3, _ = basis(bs, acc, str(bt.device))
    b2 = bt.reshape(bs ** 3, T).to(acc)
    if shift is None:
        sh = torch.zeros((1, T), dtype=acc, device=bt.device)
    else:
        sh = torch.broadcast_to(_on_device(shift, acc, bt.device), (1, T))
    if bt.is_cuda:
        precision.check_fp32_matmul()
    t = S3 @ b2
    t = t / (lam3[:, None] + sh)
    z = S3 @ t
    return z.reshape(bt.shape).to(bt.dtype)
