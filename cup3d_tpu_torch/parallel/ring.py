"""Ring-permute halo transport of the sharded forest (port of
``cup3d_tpu/parallel/ring.py``; kernel B14 in ``csrc/ring.cu``).

The shards are a leading axis of one tensor (parallel/compat.py), so a
ring permute by k is the rotation of that axis by k: shard s's array
lands on shard (s + k) mod D.

- :func:`ring_shift` -- one ring step.  CUDA shards (CUP3D_RING_DMA
  ``auto`` or ``1``): kernel B14 (:func:`ring_steps_kernel`), one
  launch for every shard, the source read through its strides; CPU
  shards, or ``CUP3D_RING_DMA=0``: the plain indexed copy
  (:func:`ring_steps_plain`).  ``CUP3D_RING_DMA=1`` on CPU shards
  raises.  A kernel that fails to build or launch raises: no fallback.
- :func:`ring_all_to_all` -- the halo exchange's ``all_to_all`` as
  ring steps 0 .. D-1, step k carrying shard s's chunk for shard
  (s+k) mod D: on CUDA shards ONE launch of B14, which reads each chunk
  from the send buffer and lands it in the receiver's row through their
  strides (the JAX package's gather before a step and landing after it
  are the kernel's own reads and writes); bitwise equal to the axis swap
  (``compat.all_to_all``).  parallel/faces.py takes it under
  ``CUP3D_RING_HALO=1``, landing straight in the recv region.
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
import threading
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.analysis import runtime
from cup3d_tpu_torch.grid.uniform import BC, UniformGrid
from cup3d_tpu_torch.ops import cuda_lib

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


def ring_steps_plain(src: torch.Tensor, out: torch.Tensor, k0: int,
                     nsteps: int = 1, chunked: bool = False) -> torch.Tensor:
    """The plain version of B14: ring steps k0 .. k0+nsteps-1 of the D
    shards of ``src`` into ``out``, one indexed copy a step.  A ring
    shift (``chunked=False``, src (D, ...)): out[(s+k) mod D] = src[s].
    A step of the all-to-all (``chunked=True``, src (D, D, ...)):
    out[(s+k) mod D, s] = src[s, (s+k) mod D], shard s's chunk for shard
    (s+k) mod D landing at its source row there."""
    D = src.shape[0]
    ar = torch.arange(D, device=src.device)
    for k in range(k0, k0 + nsteps):
        to = (ar + k) % D
        if chunked:
            out[to, ar] = src[ar, to]
        else:
            out[to] = src
    return out


def ring_shift_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """out[(s + shift) mod D] = x[s] by the plain version of B14."""
    return ring_steps_plain(x, torch.empty_like(x), shift % x.shape[0])


def _row_layout(shape, strides):
    """A chunk of ``shape`` in each of the tensors of element ``strides``
    as rows: (rows, row length, each tensor's row stride), every row
    contiguous in every tensor; None when the strides give no such
    form."""
    dims = []
    for i, n in enumerate(shape):
        if n == 1:
            continue
        st = [t[i] for t in strides]
        if dims and all(p == q * n for p, q in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if not dims:
        return 1, 1, [1] * len(strides)
    if len(dims) == 1:
        n, st = dims[0]
        return (1, n, [n] * len(strides)) if all(q == 1 for q in st) \
            else (n, 1, st)
    if len(dims) == 2 and all(q == 1 for q in dims[1][1]):
        return dims[0][0], dims[1][0], dims[0][1]
    return None


def _last_byte(t: torch.Tensor) -> int:
    """Offset of the last byte of t's elements from its first."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return (last + 1) * t.element_size() - 1


def _layout(src: torch.Tensor, out: torch.Tensor, chunked: bool) -> tuple:
    """The checked layout of a ring step of src into out: (the C side's
    RingArgs as a ctypes array, src's and out's last byte, empty)."""
    lead = 2 if chunked else 1
    D = src.shape[0] if src.dim() else 0
    if (src.dim() < lead or out.shape != src.shape or out.dtype != src.dtype
            or (chunked and src.shape[1] != D) or not 1 <= D <= 64):
        raise ValueError(f"ring step: src {tuple(src.shape)} {src.dtype} "
                         f"and out {tuple(out.shape)} {out.dtype} must be "
                         f"(D, {'D, ' if chunked else ''}...) of one dtype, "
                         "1 <= D <= 64")
    if any(n > 1 and st == 0 for n, st in zip(out.shape, out.stride())):
        raise ValueError("ring step: out repeats elements (a zero stride)")
    rows = _row_layout(src.shape[lead:], (src.stride()[lead:],
                                          out.stride()[lead:]))
    if rows is None:
        raise ValueError(
            f"ring step: a chunk of strides {src.stride()[lead:]} -> "
            f"{out.stride()[lead:]} is not rows of contiguous elements")
    es = src.element_size()
    n_rows, row_len, (s_row, d_row) = rows
    args = (ctypes.c_longlong * 9)(
        src.stride(0) * es, src.stride(1) * es if chunked else 0, s_row * es,
        out.stride(0) * es, out.stride(1) * es if chunked else 0, d_row * es,
        n_rows, row_len * es, D)
    empty = src.numel() == 0
    return (args, -1 if empty else _last_byte(src),
            -1 if empty else _last_byte(out), empty)


#: checked layouts by (src shape, strides, dtype, chunked) and, for a
#: given out, out's (shape, strides, dtype); an out of
#: torch.empty_like(src) has strides that follow from src's (_NEW; a
#: contiguous src keyed without its strides).  A run has few layouts, so
#: a call after the first does no Python loop.
_LAYOUT: Dict[tuple, tuple] = {}
_NEW: Dict[tuple, tuple] = {}
_TLS = threading.local()  # a thread's per-call argument block
_STEPS = None  # the bound C entry point, at first launch


def _bind():
    global _STEPS
    _STEPS = cuda_lib.load().fast("cup3d_ring_steps")
    return _STEPS


def ring_steps_kernel(src: torch.Tensor, out: torch.Tensor = None,
                      k0: int = 1, nsteps: int = 1,
                      chunked: bool = False) -> torch.Tensor:
    """Kernel B14: :func:`ring_steps_plain`'s function in one launch, on
    CUDA shards of any dtype (k0 taken mod D).  src and out are read and
    written through their strides: a chunk (a shard's array, or one of
    its D chunks when ``chunked``) must be rows of contiguous elements in
    both, and out may not overlap src.  ``out=None``: a new tensor (of
    src's layout where src is dense).

    The launch takes two int64 blocks, the cached layout and this call's
    (src, dst, k0, nsteps, stream): ctypes passes arrays by pointer with
    no per-argument conversion, which is most of a small call's host
    time."""
    dev = src.get_device()
    if out is None:
        if dev < 0:
            raise ValueError("ring_steps_kernel needs CUDA shards")
        out = torch.empty_like(src)
        # a contiguous src's layout follows from its shape
        key = (src.shape, src.dtype, chunked) if src.is_contiguous() else (
            src.shape, src.stride(), src.dtype, chunked)
        lay = _NEW.get(key)
        if lay is None:
            lay = _NEW[key] = _layout(src, out, chunked)
    else:
        key = (src.shape, src.stride(), src.dtype, chunked, out.shape,
               out.stride(), out.dtype)
        lay = _LAYOUT.get(key)
        if lay is None:
            lay = _LAYOUT[key] = _layout(src, out, chunked)
        s0, o0 = src.data_ptr(), out.data_ptr()
        if not lay[3] and s0 <= o0 + lay[2] and o0 <= s0 + lay[1]:
            raise ValueError("ring step: out overlaps src")
        if dev < 0 or out.get_device() != dev:
            raise ValueError("ring_steps_kernel needs CUDA shards (src and "
                             "out on one card)")
    if lay[3]:
        return out
    blk = getattr(_TLS, "blk", None)
    if blk is None:
        blk = _TLS.blk = (ctypes.c_longlong * 5)()
    blk[0] = src.data_ptr()
    blk[1] = out.data_ptr()
    blk[2] = k0
    blk[3] = nsteps
    blk[4] = cuda_lib.stream(dev)
    err = (_STEPS or _bind())(lay[0], blk)
    if err:
        raise RuntimeError(f"cup3d_ring_steps: CUDA error {err} at launch")
    launches["ring_shift"] += 1
    if runtime.NAN_CHECKS[0]:
        runtime.check_kernel_outputs("B14 (cup3d_ring_steps)", out)
    return out


def ring_shift_kernel(x: torch.Tensor, shift: int,
                      out: torch.Tensor = None) -> torch.Tensor:
    """Kernel B14 as a ring shift: out[(s + shift) mod D] = x[s], x (D,
    ...) read through its strides; ``out`` a new tensor by default."""
    return ring_steps_kernel(x, out, shift)


def _ring_steps(src, out, k0, nsteps, chunked):
    if use_ring_dma(src.device):
        return ring_steps_kernel(src, out, k0, nsteps, chunked)
    if out is None:
        out = torch.empty_like(src)
    return ring_steps_plain(src, out, k0, nsteps, chunked)


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate the shard axis of ``x`` (D, ...) by ``shift``: each shard
    receives the array of shard (me - shift) mod D (a new tensor; x is
    read through its strides)."""
    return _ring_steps(x, None, shift % x.shape[0], 1, False)


def ring_all_to_all(send: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """Drop-in for ``compat.all_to_all`` on send (D_src, D_dst, M, ...):
    ring steps 0 .. D-1, step k carrying shard s's chunk for shard
    (s+k) mod D into its row s there (step 0 the diagonal, which stays
    on its shard).  On CUDA shards the whole exchange is one launch of
    B14, reading send and writing ``out`` (a new tensor by default, or
    a view of the caller's buffer) through their strides."""
    return _ring_steps(send, out, 0, send.shape[0], True)


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
