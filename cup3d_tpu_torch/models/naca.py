"""Naca obstacle: a rigid extruded NACA airfoil (port of
``cup3d_tpu/models/naca.py``).

Reference: ``NacaMidlineData`` (main.cpp:12749-12810), a straight
midline along body-x with ``naca_width`` as the width profile and a
constant half-height ``L*HoverL/2``, rasterized by ``PutNacaOnBlocks``
(main.cpp:11740-11926), whose SDF is the minimum of the signed 2-D
profile distance in the (x, y) plane and the flat z-slab distance
``height - |z - z0|``.

Every cell of the dense grid takes its distance to the profile polyline
in the (x, |y|) half-plane (the profile's y-symmetry covers both
surfaces).  The JAX package loops over the polyline's segments; here a
chunk of cells meets every segment in one elementwise pass and the
minimum reduces over segments, which gives the same minimum.
"""

from __future__ import annotations

import numpy as np
import torch

from cup3d_tpu_torch.models.base import Obstacle
from cup3d_tpu_torch.models.fish.midline import midline_arc_grid
from cup3d_tpu_torch.models.fish.shapes import naca_width

#: cells a chunk of the segment pass ((chunk, nseg) temporaries)
NACA_CHUNK = 1 << 16


def _interp(x, xp, fp, left: float, right: float):
    """``jnp.interp(x, xp, fp, left, right)`` for ascending 1-D ``xp``,
    the same arithmetic."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], torch.full_like(f, left), f)
    return torch.where(x > xp[-1], torch.full_like(f, right), f)


def _naca_sdf(points, position, rot, xs, ws, half_height: float,
              chunk: int = NACA_CHUNK):
    """Signed distance (> 0 inside) of computational-frame ``points``
    (..., 3) to the extruded airfoil: min(signed 2-D profile distance,
    z-slab distance)."""
    flat = points.reshape(-1, 3)
    d = flat - position
    # body frame: p_d = sum_c (x - pos)_c rot_cd
    p = (d[:, 0:1] * rot[0] + d[:, 1:2] * rot[1] + d[:, 2:3] * rot[2])
    xb, yb, zb = p[:, 0], torch.abs(p[:, 1]), p[:, 2]

    # inside test in the (x, |y|) half-plane: under the width graph
    w_at = _interp(xb, xs, ws, 0.0, 0.0)
    inside2d = (xb >= xs[0]) & (xb <= xs[-1]) & (yb <= w_at)

    # distance to the profile polyline (x_i, w_i) -- (x_{i+1}, w_{i+1})
    x0, x1, w0, w1 = xs[:-1], xs[1:], ws[:-1], ws[1:]
    ax, ay = x1 - x0, w1 - w0
    alen2 = torch.clamp_min(ax * ax + ay * ay, 1e-30)
    dist = torch.empty_like(xb)
    for a in range(0, xb.shape[0], chunk):
        xc = xb[a:a + chunk, None]
        yc = yb[a:a + chunk, None]
        t = torch.clamp(((xc - x0) * ax + (yc - w0) * ay) / alen2, 0.0, 1.0)
        dx = xc - (x0 + t * ax)
        dy = yc - (w0 + t * ay)
        dmin = torch.amin(torch.sqrt(dx * dx + dy * dy + 1e-30), dim=1)
        dist[a:a + chunk] = torch.clamp_max(dmin, 1e10)
    d2d = torch.where(inside2d, dist, -dist)
    dz = half_height - torch.abs(zb)
    return torch.minimum(d2d, dz).reshape(points.shape[:-1])


class Naca(Obstacle):
    def __init__(self, sim, spec):
        super().__init__(sim, spec)
        self.t_ratio = float(spec.get("tRatio", 0.12))
        self.HoverL = float(spec.get("HoverL", 1.0))
        self.half_height = 0.5 * self.length * self.HoverL
        h = float(np.min(np.asarray(sim.grid.h)))
        rs = midline_arc_grid(self.length, h)
        ws = naca_width(self.t_ratio, self.length, rs)
        # chord centred on the body origin, as the midline-frame fish
        self._xs_np = np.asarray(rs - 0.5 * self.length)
        self._ws_np = np.asarray(ws)

    def rasterize(self, t: float):
        s = self.sim
        if getattr(self, "_profile_cache", None) is None:
            # uploaded once (``*_cache`` attributes are not pickled)
            self._profile_cache = tuple(
                torch.as_tensor(a, dtype=s.dtype, device=s.device)
                for a in (self._xs_np, self._ws_np))
        xs, ws = self._profile_cache
        pos, rot = self.pos_rot_device(s.dtype)
        return _naca_sdf(s.xc, pos, rot, xs, ws, self.half_height), None
