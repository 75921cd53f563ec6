"""Obstacle factory (port of ``cup3d_tpu/models/factory.py``; the
reference's ObstacleFactory, main.cpp:13247-13289): factory-content
lines -> obstacle instances.  Only the StefanFish is ported; the sphere
and the NACA foil wait for ROADMAP A5."""

from __future__ import annotations

from typing import Dict, List


def make_obstacles(sim, specs: List[Dict[str, str]]) -> List:
    obstacles = []
    for spec in specs:
        kind = spec["type"].lower()
        if kind == "stefanfish":
            from cup3d_tpu_torch.models.fish import StefanFish

            obstacles.append(StefanFish(sim, spec))
        elif kind in ("sphere", "naca"):
            raise NotImplementedError(
                f"obstacle type {spec['type']!r} is not ported yet "
                "(ROADMAP A5)")
        else:
            raise ValueError(f"unknown obstacle type {spec['type']!r}")
    return obstacles
