"""Obstacle factory (port of ``cup3d_tpu/models/factory.py``; the
reference's ObstacleFactory, main.cpp:13247-13289): factory-content
lines -> obstacle instances (sphere, StefanFish, NACA foil)."""

from __future__ import annotations

from typing import Dict, List


def make_obstacles(sim, specs: List[Dict[str, str]]) -> List:
    obstacles = []
    for spec in specs:
        kind = spec["type"].lower()
        if kind == "sphere":
            from cup3d_tpu_torch.models.sphere import Sphere

            obstacles.append(Sphere(sim, spec))
        elif kind == "stefanfish":
            from cup3d_tpu_torch.models.fish import StefanFish

            obstacles.append(StefanFish(sim, spec))
        elif kind == "naca":
            from cup3d_tpu_torch.models.naca import Naca

            obstacles.append(Naca(sim, spec))
        else:
            raise ValueError(f"unknown obstacle type {spec['type']!r}")
    return obstacles
