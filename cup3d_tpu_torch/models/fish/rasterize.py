"""Midline -> (SDF, udef) rasterization, the device half of the fish
(port of ``cup3d_tpu/models/fish/rasterize.py``; the reference's
PutFishOnBlocks, main.cpp:8212-8291, 11350-11739).

The body is a tube of elliptical cross-sections along the midline
(semi-axis ``width`` along the normal, ``height`` along the binormal).
Every cell of a dense window takes its signed distance to each midline
segment and keeps the smallest; its deformation velocity is the
reference's udef = v + u vNor + w vBin at the plane offsets (u, w) of the
cell in the closest section (clamped to the surface outside,
main.cpp:11476-11487, 11677-11680).  Sign: sdf > 0 inside.

The JAX package loops over the Nm - 1 segments one at a time.  Here a
chunk of segments is evaluated at once (window x chunk elements, sized by
``CHUNK_ELEMS``), the minimum taken over the chunk with ``torch.min``
(first index on a tie), then merged into the running minimum with a
strict ``<``: on a tie the earlier segment wins, as in the reference's
loop.  Rotations are written as explicit products (no matmul, so no
TF32 question: a bf16-grade rotation loses the thin section's interior).
"""

from __future__ import annotations

import torch

_WEPS = 1e-10  # degenerate-section guard (reference: width,height >= 1e-10)
#: window cells x segments evaluated at once (about 64 MB per f32 scalar
#: temporary)
CHUNK_ELEMS = 1 << 24


def _rotate(p, rot, transpose: bool):
    """p (..., 3) -> p R (``transpose`` False: x_body = R^T x) or p R^T,
    as three explicit products per component."""
    if transpose:
        rot = rot.t()
    return (p[..., 0:1] * rot[0] + p[..., 1:2] * rot[1]
            + p[..., 2:3] * rot[2])


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _segment_terms(p, r0, r1, nor0, nor1, bin0, bin1, w0, w1, h0, h1):
    """Signed distance (+outside) of points p (N, 1, 3) to C segments
    (endpoint arrays (C, 3) / (C,)), and the (t, u, v, q) the
    deformation velocity needs; each (N, C).  The formulas are the JAX
    package's ``_segment_distance``."""
    a = r1 - r0
    alen2 = torch.clamp_min(_dot3(a, a), 1e-30)
    delta = p - r0
    t_raw = _dot3(delta, a) / alen2
    t = torch.clamp(t_raw, 0.0, 1.0)
    ax = (t_raw - t) * torch.sqrt(alen2)
    tt = t[..., None]
    rm = r0 + tt * (r1 - r0)
    nor = nor0 + tt * (nor1 - nor0)
    bn = bin0 + tt * (bin1 - bin0)
    w = torch.clamp_min(w0 + t * (w1 - w0), _WEPS)
    hh = torch.clamp_min(h0 + t * (h1 - h0), _WEPS)
    d2 = p - rm
    u = _dot3(d2, nor)
    v = _dot3(d2, bn)
    q = torch.sqrt((u / w) ** 2 + (v / hh) ** 2 + 1e-30)
    # first-order distance f/|grad f| via the unit direction, so nothing
    # divides by w^2 at the degenerate tips (overflow to inf there)
    t1 = (u / w) / q
    t2 = (v / hh) / q
    inv_ratio = torch.sqrt((t1 / w) ** 2 + (t2 / hh) ** 2 + 1e-30)
    inv_ratio = torch.maximum(inv_ratio, 1.0 / torch.maximum(w, hh))
    # the bounding-circle distance is a rigorous lower bound, exact far out
    d_plane = torch.maximum((q - 1.0) / inv_ratio,
                            torch.hypot(u, v) - torch.maximum(w, hh))
    ax_abs = torch.abs(ax)
    d = torch.where(ax_abs > 0.0,
                    torch.hypot(torch.clamp_min(d_plane, 0.0), ax_abs),
                    d_plane)
    return d, t, u, v, q


def rasterize_points(points, midline, position, rot, chunk: int = 0):
    """Rasterize a midline tube at arbitrary cell centres.

    points: (..., 3) computational-frame coordinates; midline: dict of
    device tensors r, v, nor, vnor, bin, vbin (Nm, 3) and width, height
    (Nm,), body frame; position (3,); rot (3, 3) body -> computational.
    ``chunk``: segments a pass (0: from ``CHUNK_ELEMS``).  Returns (sdf,
    udef): points.shape[:-1] with sdf > 0 inside, and (..., 3)
    deformation velocity in the computational frame."""
    dtype = midline["r"].dtype
    shape = points.shape[:-1]
    p = _rotate((points - position).reshape(-1, 3), rot, transpose=False)
    n = p.shape[0]
    nseg = midline["r"].shape[0] - 1
    if chunk <= 0:
        chunk = max(1, min(nseg, CHUNK_ELEMS // max(n, 1)))
    pc = p[:, None, :]
    big = torch.full((n,), 1e10, dtype=dtype, device=p.device)
    dmin = big
    seg = torch.zeros(n, dtype=torch.long, device=p.device)
    tb = torch.zeros(n, dtype=dtype, device=p.device)
    ub, vb, qb = tb, tb, torch.ones_like(tb)
    r, nor, bn = midline["r"], midline["nor"], midline["bin"]
    wd, ht = midline["width"], midline["height"]
    for s0 in range(0, nseg, chunk):
        s1 = min(s0 + chunk, nseg)
        d, t, u, v, q = _segment_terms(
            pc, r[s0:s1], r[s0 + 1:s1 + 1], nor[s0:s1], nor[s0 + 1:s1 + 1],
            bn[s0:s1], bn[s0 + 1:s1 + 1], wd[s0:s1], wd[s0 + 1:s1 + 1],
            ht[s0:s1], ht[s0 + 1:s1 + 1])
        dc, ic = torch.min(d, dim=1)
        closer = dc < dmin
        col = ic[:, None]
        dmin = torch.minimum(dc, dmin)
        seg = torch.where(closer, ic + s0, seg)
        tb = torch.where(closer, torch.gather(t, 1, col)[:, 0], tb)
        ub = torch.where(closer, torch.gather(u, 1, col)[:, 0], ub)
        vb = torch.where(closer, torch.gather(v, 1, col)[:, 0], vb)
        qb = torch.where(closer, torch.gather(q, 1, col)[:, 0], qb)
    # the closest section's deformation velocity (plane offsets clamped
    # to the surface outside)
    tt = tb[:, None]

    def lerp(key):
        a = midline[key]
        x0, x1 = a[seg], a[seg + 1]
        return x0 + tt * (x1 - x0)

    scale = torch.clamp_max(1.0 / qb, 1.0)[:, None]
    udef = lerp("v") + scale * (ub[:, None] * lerp("vnor")
                                + vb[:, None] * lerp("vbin"))
    udef = torch.where((dmin < big)[:, None], udef, torch.zeros_like(udef))
    sdf = -dmin
    udef_comp = _rotate(udef, rot, transpose=True)
    return sdf.reshape(shape), udef_comp.reshape(shape + (3,))


def rasterize_midline(origin, h, window_shape, midline, position, rot,
                      chunk: int = 0):
    """Rasterize a midline tube over a dense uniform window: ``origin``
    (3,) the window corner, ``h`` the spacing, ``window_shape`` (nx, ny,
    nz).  Returns (sdf, udef): (nx,ny,nz) and (nx,ny,nz,3)."""
    nx, ny, nz = window_shape
    dtype, dev = midline["r"].dtype, midline["r"].device
    axes = [torch.arange(m, dtype=dtype, device=dev) for m in (nx, ny, nz)]
    X = origin[0] + (axes[0][:, None, None] + 0.5) * h
    Y = origin[1] + (axes[1][None, :, None] + 0.5) * h
    Z = origin[2] + (axes[2][None, None, :] + 0.5) * h
    p = torch.stack(torch.broadcast_tensors(X, Y, Z), dim=-1)
    return rasterize_points(p, midline, position, rot, chunk=chunk)
