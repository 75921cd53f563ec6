"""Ring-permute halo transport of the sharded forest (port of
``cup3d_tpu/parallel/ring.py``; kernel B14 in ``csrc/ring.cu``).

The shards are a leading axis of one tensor (parallel/compat.py), so a
ring permute by k is the rotation of that axis by k: shard s's array
lands on shard (s + k) mod D.

- :func:`ring_shift` -- one ring step.  CUDA shards (CUP3D_RING_DMA
  ``auto`` or ``1``): kernel B14, one launch for every shard's chunk;
  CPU shards, or ``CUP3D_RING_DMA=0``: the plain per-shard copy
  (:func:`ring_shift_plain`).  ``CUP3D_RING_DMA=1`` on CPU shards
  raises.  A kernel that fails to build or launch raises: no fallback.
- :func:`ring_all_to_all` -- the halo exchange's ``all_to_all`` built
  from D-1 ring steps, each chunk chosen and landed outside the kernel
  as the JAX package does; bitwise equal to the axis swap
  (``compat.all_to_all``).  parallel/faces.py takes it under
  ``CUP3D_RING_HALO=1``.
- :func:`pad_slab_scalar` / :func:`pad_slab_vector` -- the uniform
  grid's ghost padding of x-slabs, the cross-shard x-ghosts from ring
  steps, elementwise equal to slicing the unsharded padded field.
- :func:`make_laplacian_lanes_sharded` -- the lanes-layout 7-point
  Laplacian (krylov.make_laplacian_lanes) on x-slabs of the lane axis,
  the boundary planes exchanged by ring steps.

Lane order is x-major (krylov.to_lanes: t = (tx*NBy + ty)*NBz + tz), so
cutting the lane axis into D equal runs IS an x-slab decomposition and
each shard's boundary is one contiguous run of NBy*NBz lanes.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.grid.uniform import BC, UniformGrid

__all__ = [
    "use_ring_dma",
    "use_ring_halo",
    "ring_shift",
    "ring_shift_plain",
    "ring_all_to_all",
    "pad_slab_scalar",
    "pad_slab_vector",
    "make_laplacian_lanes_sharded",
]

#: kernel launches, counted by the wrapper where it launches
launches = {"ring_shift": 0}


def reset_launches() -> None:
    launches["ring_shift"] = 0


def _dma_mode() -> str:
    v = os.environ.get("CUP3D_RING_DMA", "auto").strip().lower()
    if v in ("0", "false", "no"):
        return "off"
    if v in ("1", "true", "yes"):
        return "on"
    return "auto"


def use_ring_dma(device) -> bool:
    """Whether :func:`ring_shift` launches kernel B14 for shards on
    ``device``.  CUP3D_RING_DMA: ``auto`` (default) = on for CUDA, the
    plain per-shard copy on the CPU; ``1`` forces the kernel (raising
    for CPU shards); ``0`` takes the plain transport everywhere."""
    mode = _dma_mode()
    is_cuda = torch.device(device).type == "cuda"
    if mode == "on" and not is_cuda:
        raise RuntimeError("CUP3D_RING_DMA=1: kernel B14 moves CUDA "
                           "shards; these are on the CPU")
    return is_cuda if mode == "auto" else mode == "on"


def use_ring_halo() -> bool:
    """Whether faces.py's entry exchange rides ring steps instead of the
    axis swap (CUP3D_RING_HALO=1; default off, as in the JAX package)."""
    return os.environ.get("CUP3D_RING_HALO", "0") in ("1", "true", "yes")


def ring_shift_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The plain version of B14: out[(s + shift) mod D] = x[s], one copy
    per shard."""
    D = x.shape[0]
    out = torch.empty_like(x)
    for s in range(D):
        out[(s + shift) % D] = x[s]
    return out


def ring_shift_kernel(x: torch.Tensor, shift: int,
                      out: torch.Tensor = None) -> torch.Tensor:
    """Kernel B14 on CUDA shards: x (D, ...) contiguous, any dtype; the
    result in ``out`` (a new tensor by default; any contiguous tensor of
    x's shape and dtype that does not overlap x)."""
    from cup3d_tpu_torch.ops import cuda_lib

    if not x.is_cuda:
        raise ValueError("ring_shift_kernel needs CUDA shards")
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"ring_shift_kernel takes contiguous (D, ...) "
                         f"shards; got {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("ring_shift_kernel: out must be contiguous, of "
                         "x's shape, dtype and device")
    D = x.shape[0]
    nbytes = x[0].numel() * x.element_size() if D else 0
    if D == 0 or nbytes == 0:
        return out
    lo, hi = x.data_ptr(), out.data_ptr()
    if lo < hi + D * nbytes and hi < lo + D * nbytes:
        raise ValueError("ring_shift_kernel: out overlaps x")
    src = (ctypes.c_uint64 * D)(*(lo + s * nbytes for s in range(D)))
    dst = (ctypes.c_uint64 * D)(*(hi + s * nbytes for s in range(D)))
    cuda_lib.load().call(
        "cup3d_ring_shift", ctypes.cast(src, ctypes.c_void_p),
        ctypes.cast(dst, ctypes.c_void_p), D, nbytes, int(shift),
        torch.cuda.current_stream(x.device).cuda_stream)
    launches["ring_shift"] += 1
    return out


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate the shard axis of ``x`` (D, ...) by ``shift``: each shard
    receives the array of shard (me - shift) mod D."""
    if use_ring_dma(x.device):
        return ring_shift_kernel(x.contiguous(), shift)
    return ring_shift_plain(x, shift)


_AR: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}


def _shard_index(D: int, device) -> Tuple[torch.Tensor, ...]:
    """(arange(D), and per ring step k the rows (s+k) mod D and
    (s-k) mod D) on ``device``, uploaded once."""
    key = (D, str(device))
    if key not in _AR:
        ar = np.arange(D)
        rows = [ar] + [(ar + k) % D for k in range(1, D)] \
            + [(ar - k) % D for k in range(1, D)]
        _AR[key] = tuple(torch.as_tensor(r, device=device) for r in rows)
    return _AR[key]


def ring_all_to_all(send: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``compat.all_to_all`` on send (D_src, D_dst, M, ...):
    D-1 ring steps, each carrying one shard-to-shard chunk; the diagonal
    (own) chunk never leaves its shard."""
    D = send.shape[0]
    idx = _shard_index(D, send.device)
    ar, fwd, back = idx[0], idx[1:D], idx[D:]
    out = torch.empty_like(send)
    out[ar, ar] = send[ar, ar]
    for k in range(1, D):
        # shard s sends its chunk for shard s+k; the chunk from shard
        # s-k arrives and lands at its source row
        got = ring_shift(send[ar, fwd[k - 1]], shift=k)
        out[ar, back[k - 1]] = got
    return out


# ---------------------------------------------------------------------------
# x-slab padding of the uniform grid
# ---------------------------------------------------------------------------


def _pad_slab_x(grid: UniformGrid, f: torch.Tensor, width: int, comp):
    """x-ghosts of D (sx, ny, nz) slabs, f (D, sx, ny, nz): the
    cross-shard halo by ring steps, the GLOBAL x boundary as
    grid/uniform._pad builds it (periodic is the ring's wrap;
    zero-gradient edge copies, with the wall / normal-component sign
    flip, only on shards 0 and D-1)."""
    D, sx = f.shape[0], f.shape[1]
    recv_lo = ring_shift(f[:, sx - width:], shift=+1)
    recv_hi = ring_shift(f[:, :width], shift=-1)
    bc = grid.bc[0]
    if bc == BC.periodic:
        lo, hi = recv_lo, recv_hi
    else:
        edge_lo = f[0, :1].expand((width,) + tuple(f.shape[2:]))
        edge_hi = f[D - 1, sx - 1:].expand(edge_lo.shape)
        if comp is not None and (bc == BC.wall or comp == 0):
            edge_lo, edge_hi = -edge_lo, -edge_hi
        lo, hi = recv_lo.clone(), recv_hi.clone()
        lo[0] = edge_lo
        hi[D - 1] = edge_hi
    return torch.cat([lo, f, hi], dim=1)


def _pad_slab_yz(grid: UniformGrid, f: torch.Tensor, width: int, comp):
    """y/z ghosts of x-padded slabs (D, sx', ny, nz): the unsharded axes,
    padded one after the other as grid/uniform._pad pads them, so the
    ghost corners equal the unsharded field's."""
    for axis in (1, 2):
        dim = axis + 1
        n = f.shape[dim]
        bc = grid.bc[axis]
        if bc == BC.periodic:
            lo = f.narrow(dim, n - width, width)
            hi = f.narrow(dim, 0, width)
        else:
            lo = f.narrow(dim, 0, 1).expand_as(f.narrow(dim, 0, width))
            hi = f.narrow(dim, n - 1, 1).expand_as(lo)
            if comp is not None and (bc == BC.wall or comp == axis):
                lo, hi = -lo, -hi
        f = torch.cat([lo, f, hi], dim=dim)
    return f


def pad_slab_scalar(grid: UniformGrid, f: torch.Tensor,
                    width: int) -> torch.Tensor:
    """grid.pad_scalar for D x-slabs f (D, sx, ny, nz) -> (D, sx+2w,
    ny+2w, nz+2w): slab s equals rows [s*sx, s*sx + sx + 2w) of the
    unsharded padded field."""
    return _pad_slab_yz(grid, _pad_slab_x(grid, f, width, None), width,
                        None)


def pad_slab_vector(grid: UniformGrid, u: torch.Tensor,
                    width: int) -> torch.Tensor:
    """grid.pad_vector for D x-slabs u (D, sx, ny, nz, 3): per-component
    ghosts with the unsharded path's BC sign flips."""
    return torch.stack(
        [_pad_slab_yz(grid, _pad_slab_x(grid, u[..., c], width, c), width, c)
         for c in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# the lanes Laplacian on x-slabs
# ---------------------------------------------------------------------------


def make_laplacian_lanes_sharded(grid: UniformGrid, mesh,
                                 bs: int = 8) -> Callable:
    """The lanes-layout 7-point Laplacian (krylov.make_laplacian_lanes)
    on ``mesh.D`` x-slabs of the lane axis, the cross-shard planes
    exchanged by ring steps.  Takes and returns the unsharded lanes
    tensor (bs, bs, bs, T); inside, the shards are a leading axis.

    Per shard the two boundary messages (the lowest tile column's low
    planes to the left neighbour, the highest's high planes to the
    right) go first; the intra-shard stencil (the -6 diagonal, both y/z
    axes, interior-x planes) follows; the received planes enter only in
    the final edge concatenation.  Global x BCs fall out of the ring:
    periodic is its wrap, zero-gradient clamps shards 0 and D-1 to their
    own planes.  The mesh size must divide the x tile count."""
    D = int(mesh.D)
    nb = tuple(s // bs for s in grid.shape)
    if any(s % bs for s in grid.shape):
        raise ValueError(f"grid {grid.shape} not divisible by bs={bs}")
    if nb[0] % D:
        raise ValueError(
            f"{D} shards cannot x-slab {nb[0]} tile columns (grid "
            f"{grid.shape}, bs={bs}): choose a shard count dividing nx/bs")
    nbyz = nb[1] * nb[2]
    T_loc = nb[0] // D * nbyz
    strides = (nbyz, nb[2], 1)
    lanes = np.arange(T_loc)
    tco = (lanes // nbyz, lanes // nb[2] % nb[1], lanes % nb[2])
    inv_h2 = 1.0 / (grid.h * grid.h)
    periodic0 = grid.bc[0] == BC.periodic
    masks: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def edge_masks(device):
        key = str(device)
        if key not in masks:
            masks[key] = tuple(
                (torch.as_tensor(tco[ax] == nb[ax] - 1, device=device),
                 torch.as_tensor(tco[ax] == 0, device=device))
                for ax in (1, 2))
        return masks[key]

    def neighbour_local(t, ax, sign, mask):
        # axes 1/2 (dims 2/3 here) are unsharded: the mask and wrap logic
        # of the JAX package's make_laplacian_lanes on the local lanes
        periodic = grid.bc[ax] == BC.periodic
        dim = ax + 1
        n = t.shape[dim]
        st, nba = strides[ax], nb[ax]
        if sign > 0:
            inner = t.narrow(dim, 1, n - 1)
            edge = t.narrow(dim, n - 1, 1)
            src = t.narrow(dim, 0, 1)
            plane = torch.roll(src, -st, dims=-1)
            wrap = torch.roll(src, (nba - 1) * st, dims=-1)
        else:
            inner = t.narrow(dim, 0, n - 1)
            edge = t.narrow(dim, 0, 1)
            src = t.narrow(dim, n - 1, 1)
            plane = torch.roll(src, st, dims=-1)
            wrap = torch.roll(src, -(nba - 1) * st, dims=-1)
        plane = torch.where(mask, wrap if periodic else edge, plane)
        parts = (inner, plane) if sign > 0 else (plane, inner)
        return torch.cat(parts, dim=dim)

    def apply(t_all: torch.Tensor) -> torch.Tensor:
        T = t_all.shape[-1]
        # (bs,bs,bs,T) -> (D, bs,bs,bs, T_loc): shard s owns lanes
        # [s*T_loc, (s+1)*T_loc), one x-slab
        t = t_all.reshape(bs, bs, bs, D, T_loc).permute(3, 0, 1, 2, 4)
        t = t.contiguous()
        em = edge_masks(t.device)
        # -- the halo ring steps first ---------------------------------
        p0 = t[:, 0:1]          # own low planes
        p1 = t[:, bs - 1:bs]    # own high planes
        recv_lo = ring_shift(p1[..., T_loc - nbyz:], shift=+1)
        recv_hi = ring_shift(p0[..., :nbyz], shift=-1)
        # -- the intra-shard stencil -----------------------------------
        out = -6.0 * t
        for i, ax in enumerate((1, 2)):
            out = (out + neighbour_local(t, ax, +1, em[i][0])
                   + neighbour_local(t, ax, -1, em[i][1]))
        # -- boundary tiles: the received planes -------------------------
        if periodic0:
            edge_lo, edge_hi = recv_lo, recv_hi
        else:
            edge_lo, edge_hi = recv_lo.clone(), recv_hi.clone()
            edge_lo[0] = p0[0, ..., :nbyz]
            edge_hi[D - 1] = p1[D - 1, ..., T_loc - nbyz:]
        hi = torch.cat([p0[..., nbyz:], edge_hi], dim=-1)
        lo = torch.cat([edge_lo, p1[..., :T_loc - nbyz]], dim=-1)
        out = out + torch.cat([t[:, 1:], hi], dim=1)
        out = out + torch.cat([lo, t[:, :-1]], dim=1)
        out = out * inv_h2
        return out.permute(1, 2, 3, 0, 4).reshape(bs, bs, bs, T)

    return apply
