"""Sphere obstacle (port of ``cup3d_tpu/models/sphere.py``): the simplest
concrete body, an analytic SDF through the full chi -> penalization ->
6-DOF -> forces pipeline.  Not in the condensed reference's factory
(main.cpp:13235-13246) but part of upstream CubismUP_3D's obstacle
family."""

from __future__ import annotations

import torch

from cup3d_tpu_torch.models.base import Obstacle


class Sphere(Obstacle):
    def __init__(self, sim, spec):
        super().__init__(sim, spec)
        self.radius = float(spec.get("radius", self.length / 2))
        # the force probe's window is sized from self.length
        # (ops/surface.probe_margin): keep it the body's real extent
        self.length = max(self.length, 2.0 * self.radius)

    def rasterize(self, t: float):
        s = self.sim
        pos, _ = self.pos_rot_device(s.dtype)
        d = torch.linalg.vector_norm(s.xc - pos, dim=-1)
        return self.radius - d, None  # > 0 inside
