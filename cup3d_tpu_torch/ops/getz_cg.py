"""The CG getZ: ``iters`` conjugate-gradient sweeps on every 8^3 tile of
(-lap_tile + shift) z = b with a zero-Dirichlet halo, the
``CUP3D_GETZ=cg`` preconditioner (port of ``cup3d_tpu/ops/getz_pallas.py``;
kernel B7 in ``csrc/getz_cg.cu``).

Two layouts, one kernel, no transpose: :func:`cg_tiles_lanes` takes the
lanes layout (bs, bs, bs, T) of the uniform legacy solve and
:func:`cg_tiles_blocks` the blocks layout (..., bs, bs, bs) of the
forest.  The kernel addresses cell c of tile t at ``t*ts + c*cs`` (lanes:
cs = T, ts = 1; blocks: cs = 1, ts = 512).  ``shift`` is a scalar (0 for
the Poisson getZ) or one value per tile.

Dispatch follows ops/fused_bicgstab.py: ``kernels=None`` launches the
kernel for a CUDA tensor and runs the plain version
(:func:`block_cg_tiles_reference`) for a CPU tensor; ``kernels=False``
runs the plain version anywhere; ``kernels=True`` on a CPU tensor
raises.  A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from cup3d_tpu_torch.analysis import runtime
from cup3d_tpu_torch.ops import fused_bicgstab as fb
from cup3d_tpu_torch.ops import cuda_lib, precision

_F32 = torch.float32
BS = 8

#: kernel launches, counted by the wrapper where it launches
launches = {"getz_cg": 0}


def reset_launches() -> None:
    launches["getz_cg"] = 0


def _block_lap(t: torch.Tensor) -> torch.Tensor:
    """Per-tile 7-point Laplacian (h^2 scaled out) with an implicit
    zero-Dirichlet halo, on the trailing bs^3 axes."""
    z = torch.nn.functional.pad(t, (1, 1, 1, 1, 1, 1))
    c = z[..., 1:-1, 1:-1, 1:-1]
    return (z[..., 2:, 1:-1, 1:-1] + z[..., :-2, 1:-1, 1:-1]
            + z[..., 1:-1, 2:, 1:-1] + z[..., 1:-1, :-2, 1:-1]
            + z[..., 1:-1, 1:-1, 2:] + z[..., 1:-1, 1:-1, :-2]
            - 6.0 * c)


def block_cg_tiles_reference(b: torch.Tensor, iters: int,
                             shift=0.0) -> torch.Tensor:
    """The plain version of B7 (the JAX package's jnp reference): the
    tile operator with its zero-Dirichlet halo is SPD for shift >= 0, so
    plain CG applies; alpha = 0 when |p.Ap| <= 1e-30 and beta = 0 when
    r.r <= 1e-30.  ``shift``: scalar or an array broadcastable to ``b``
    (one value per tile)."""
    acc = precision.accum_dtype(b.dtype)

    def bdot(a, c):
        return torch.sum(a * c, dim=(-1, -2, -3), keepdim=True, dtype=acc)

    z = torch.zeros_like(b)
    res, p = b, b
    rs = bdot(b, b)
    for _ in range(iters):
        ap = -_block_lap(p) + shift * p
        denom = bdot(p, ap)
        ok = torch.abs(denom) > 1e-30
        alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
        z = z + alpha * p
        res = res - alpha * ap
        rs_new = bdot(res, res)
        okr = rs > 1e-30
        beta = torch.where(okr, rs_new / torch.where(okr, rs, 1.0), 0.0)
        p = res + beta * p
        rs = rs_new
    return z


def _launch(b: torch.Tensor, iters: int, shift, n: int, cs: int,
            ts: int) -> torch.Tensor:
    if b.dtype != _F32 or not b.is_contiguous():
        raise ValueError(f"getz_cg takes contiguous f32 tiles; got "
                         f"{tuple(b.shape)} {b.dtype} "
                         f"contiguous={b.is_contiguous()}")
    if n < 1 or iters < 0:
        raise ValueError(f"getz_cg: {n} tiles, {iters} sweeps")
    col, val = None, 0.0
    if isinstance(shift, torch.Tensor) and shift.dim() > 0:
        col = torch.broadcast_to(shift.to(device=b.device, dtype=_F32),
                                 (n,)).contiguous()
    else:
        val = float(shift)
    z = torch.empty_like(b)
    fb._lib().call("cup3d_getz_cg", b.data_ptr(),
                   None if col is None else col.data_ptr(), val,
                   z.data_ptr(), n, cs, ts, int(iters),
                   cuda_lib.stream(b.device))
    launches["getz_cg"] += 1
    if runtime.NAN_CHECKS[0]:
        runtime.check_kernel_outputs("B7 (cup3d_getz_cg)", z)
    return z


def cg_tiles_blocks(b: torch.Tensor, iters: int, shift=0.0,
                    kernels: Optional[bool] = None) -> torch.Tensor:
    """B7 on the blocks layout (..., bs, bs, bs): every trailing 8^3 tile
    solved independently.  ``shift``: scalar, or an array with one value
    per tile (e.g. (nb,1,1,1)).  The counterpart of the JAX package's
    ``block_cg_tiles_pallas``."""
    if not fb._use_kernel(b, kernels):
        return block_cg_tiles_reference(b, iters, shift)
    if tuple(b.shape[-3:]) != (BS, BS, BS):
        raise ValueError(f"blocks must end in (8,8,8); got {tuple(b.shape)}")
    n = b.numel() // BS ** 3
    if isinstance(shift, torch.Tensor) and shift.dim() > 0:
        shift = torch.broadcast_to(shift, b.shape[:-3] + (1, 1, 1)).reshape(n)
    return _launch(b.contiguous(), iters, shift, n, 1, BS ** 3)


def cg_tiles_lanes(bt: torch.Tensor, iters: int, shift=0.0,
                   kernels: Optional[bool] = None) -> torch.Tensor:
    """B7 on the lanes layout (bs, bs, bs, T), the uniform legacy solve's;
    ``shift``: scalar or (T,)."""
    T = bt.shape[-1]
    if not fb._use_kernel(bt, kernels):
        if isinstance(shift, torch.Tensor) and shift.dim() > 0:
            shift = shift.reshape(T, 1, 1, 1)
        z = block_cg_tiles_reference(bt.permute(3, 0, 1, 2), iters, shift)
        return z.permute(1, 2, 3, 0)
    if tuple(bt.shape[:3]) != (BS, BS, BS):
        raise ValueError(f"lanes tiles must be (8,8,8,T); got "
                         f"{tuple(bt.shape)}")
    return _launch(bt.contiguous(), iters, shift, T, T, 1)
