"""Cell-level finite-difference stencils on ghost-padded tensors (port of
``cup3d_tpu/ops/stencils.py``).

Every function takes a tensor already padded with ``w`` ghost cells on
each face of its three spatial axes and returns interior-shaped results.
A scalar's spatial axes are its last three (a leading shard axis rides
along); a vector field's component is its last axis, which ``grad``,
``divergence``, ``curl`` and ``vector_laplacian`` index or stack.
Same arithmetic, in the same order, as the JAX package.

Math sources in the reference (not code): 7-point Laplacian and
2nd-order centered first derivatives (KernelLHSPoisson main.cpp:9197,
KernelDissipation main.cpp:10347); 5th-order 6-point biased-upwind
advection derivatives (KernelAdvectDiffuse, main.cpp:9474-9548).
"""

from __future__ import annotations

import torch


def shift(ap: torch.Tensor, w: int, ox: int = 0, oy: int = 0, oz: int = 0):
    """Interior view of padded tensor `ap`, shifted by (ox,oy,oz) cells.
    The spatial axes are the LAST three, so a leading shard axis (D x-slabs
    ``(D, sx+2w, ny+2w, nz+2w)``, parallel/ring.pad_slab_scalar) rides
    along: one launch set covers every shard."""
    nx = ap.shape[-3] - 2 * w
    ny = ap.shape[-2] - 2 * w
    nz = ap.shape[-1] - 2 * w
    return ap[
        ...,
        w + ox : w + ox + nx,
        w + oy : w + oy + ny,
        w + oz : w + oz + nz,
    ]


def _offsets(axis: int, k: int):
    o = [0, 0, 0]
    o[axis] = k
    return tuple(o)


def d1_central(ap, w, axis, h):
    """2nd-order centered first derivative along `axis`."""
    return (shift(ap, w, *_offsets(axis, 1))
            - shift(ap, w, *_offsets(axis, -1))) / (2.0 * h)


def d1_upwind5(ap, w, axis, vel, h):
    """5th-order 6-point biased-upwind first derivative, selected by the
    sign of `vel` (strictly ``vel > 0`` picks the plus stencil, as in the
    JAX package and the reference, main.cpp:9474-9483).  Requires w >= 3.
    """
    qm3 = shift(ap, w, *_offsets(axis, -3))
    qm2 = shift(ap, w, *_offsets(axis, -2))
    qm1 = shift(ap, w, *_offsets(axis, -1))
    q0 = shift(ap, w)
    qp1 = shift(ap, w, *_offsets(axis, 1))
    qp2 = shift(ap, w, *_offsets(axis, 2))
    qp3 = shift(ap, w, *_offsets(axis, 3))
    inv60h = 1.0 / (60.0 * h)
    dplus = (
        -2.0 * qm3 + 15.0 * qm2 - 60.0 * qm1 + 20.0 * q0 + 30.0 * qp1 - 3.0 * qp2
    ) * inv60h
    dminus = (
        2.0 * qp3 - 15.0 * qp2 + 60.0 * qp1 - 20.0 * q0 - 30.0 * qm1 + 3.0 * qm2
    ) * inv60h
    return torch.where(vel > 0, dplus, dminus)


def laplacian(ap, w, h):
    """7-point Laplacian of a padded scalar (w >= 1)."""
    out = -6.0 * shift(ap, w)
    for axis in range(3):
        out = out + shift(ap, w, *_offsets(axis, 1)) + shift(ap, w, *_offsets(axis, -1))
    return out / (h * h)


def grad(ap, w, h):
    """(nx,ny,nz,3) centered gradient of a padded scalar."""
    return torch.stack([d1_central(ap, w, a, h) for a in range(3)], dim=-1)


def divergence(up, w, h):
    """Centered divergence of a padded (.., 3) vector field."""
    return sum(d1_central(up[..., a], w, a, h) for a in range(3))


def curl(up, w, h):
    """Centered curl (vorticity) of a padded (.., 3) vector field."""
    d = lambda c, a: d1_central(up[..., c], w, a, h)
    wx = d(2, 1) - d(1, 2)
    wy = d(0, 2) - d(2, 0)
    wz = d(1, 0) - d(0, 1)
    return torch.stack([wx, wy, wz], dim=-1)


def vector_laplacian(up, w, h):
    return torch.stack([laplacian(up[..., c], w, h) for c in range(3)], dim=-1)


def laplacian_faces(t: torch.Tensor, faces, inv_h2, first: int):
    """7-point Laplacian of 8^3 tiles whose cross-tile neighbour values
    arrive as 6 face planes ``faces[k]`` (k = lo0, hi0, lo1, hi1, lo2,
    hi2), each shaped like ``t`` without the in-tile axis it faces.
    ``first`` is the dim of the first in-tile axis: 0 for the JAX lanes
    layout (bs,bs,bs,T), 1 for the port's tile-major (T,bs,bs,bs)."""
    out = -6.0 * t
    for ax in range(3):
        d = first + ax
        n = t.shape[d]
        lo = faces[2 * ax].unsqueeze(d)
        hi = faces[2 * ax + 1].unsqueeze(d)
        out = out + torch.cat([t.narrow(d, 1, n - 1), hi], dim=d)
        out = out + torch.cat([lo, t.narrow(d, 0, n - 1)], dim=d)
    return out * inv_h2


def laplacian_lanes_chunk(t: torch.Tensor, planes: torch.Tensor,
                          inv_h2) -> torch.Tensor:
    """7-point Laplacian on a lanes chunk (bs, bs, bs, T) whose cross-tile
    boundary values arrive as 6 face planes (6, bs, bs, T), rows
    [lo0, hi0, lo1, hi1, lo2, hi2] (krylov.make_lane_planes)."""
    return laplacian_faces(t, [planes[k] for k in range(6)], inv_h2, first=0)
