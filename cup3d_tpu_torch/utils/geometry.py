"""Triangle geometry helpers (port of ``cup3d_tpu/utils/geometry.py``;
reference main.cpp:8341-8463: Moller-Trumbore rayIntersectsTriangle,
pointTriangleSqrDistance).

The reference carries these for externally meshed obstacles (its
factory builds none); here they are elementwise tensor functions over a
batch of rays or points against a batch of triangles, every argument
broadcasting over the leading axes.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ray_intersects_triangle(origin, direction, v0, v1, v2):
    """Moller-Trumbore: (hit mask, t) for rays against triangles; t is the
    ray parameter (inf where no hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = _cross(direction, e2)
    a = _dot(e1, h)
    parallel = torch.abs(a) < _EPS
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = origin - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(direction, q)
    t = f * _dot(e2, q)
    hit = ((~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > _EPS))
    return hit, torch.where(hit, t, torch.full_like(t, math.inf))


def point_triangle_sqr_distance(p, v0, v1, v2):
    """Squared distance from points p (..., 3) to triangles (v0, v1, v2)
    (..., 3): the region-based closest-point classification
    (main.cpp:8395-8463)."""
    e0 = v1 - v0
    e1 = v2 - v0
    d = v0 - p
    a = _dot(e0, e0)
    b = _dot(e0, e1)
    c = _dot(e1, e1)
    dd = _dot(e0, d)
    e = _dot(e1, d)
    det = torch.clamp_min(a * c - b * b, _EPS)
    s = b * e - c * dd
    t = b * dd - a * e

    # barycentric clamping: project onto edges/vertices outside the face
    inside = (s + t <= det) & (s >= 0) & (t >= 0)
    s_in = s / det
    t_in = t / det

    zero = torch.zeros_like(a)
    # edge v0-v1 (t = 0)
    s01 = torch.clamp(torch.where(a > _EPS, -dd / torch.clamp_min(a, _EPS),
                                  zero), 0, 1)
    # edge v0-v2 (s = 0)
    t02 = torch.clamp(torch.where(c > _EPS, -e / torch.clamp_min(c, _EPS),
                                  zero), 0, 1)
    # edge v1-v2 (s + t = 1): q = v1 + w (v2 - v1)
    e12 = v2 - v1
    w12 = torch.clamp(_dot(p - v1, e12)
                      / torch.clamp_min(_dot(e12, e12), _EPS), 0, 1)

    def dist2(ss, tt):
        q = v0 + ss[..., None] * e0 + tt[..., None] * e1
        r = p - q
        return _dot(r, r)

    d_face = dist2(s_in, t_in)
    d01 = dist2(s01, torch.zeros_like(s01))
    d02 = dist2(torch.zeros_like(t02), t02)
    q12 = v1 + w12[..., None] * e12
    d12 = torch.sum((p - q12) ** 2, dim=-1)
    d_border = torch.minimum(torch.minimum(d01, d02), d12)
    return torch.where(inside, d_face, d_border)
