"""Signed distance -> characteristic function chi and surface measure
(port of ``cup3d_tpu/ops/chi.py``; the reference's
KernelCharacteristicFunction, main.cpp:13291-13404, Towers-style).

chi is a discrete Heaviside of the SDF over a +-1h band, the surface
delta is |grad chi|; every surface integral is a masked reduction over
dense fields.  Convention: sdf > 0 inside the body.
"""

from __future__ import annotations

import math

import torch

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops import stencils as st


def heaviside(sdf: torch.Tensor, h: float) -> torch.Tensor:
    """C^1 mollified Heaviside over the band |sdf| <= 2h:
    chi = (1 + t + sin(pi t)/pi) / 2 with t = clip(sdf/2h, -1, 1).
    The production chi is :func:`towers_chi`."""
    t = torch.clamp(sdf / (2.0 * h), -1.0, 1.0)
    return 0.5 * (1.0 + t + torch.sin(math.pi * t) / math.pi)


def towers_chi(sdf_lab: torch.Tensor, h) -> torch.Tensor:
    """The reference's discrete Heaviside (Towers construction;
    main.cpp:13312-13346): the sharp indicator outside the +-1h band,
    inside it chi = (grad I+ . grad phi) / |grad phi|^2 with I+ =
    max(0, phi) and centered differences.  ``sdf_lab``: the SDF with one
    ghost cell on each face of its last three axes, phi > 0 inside."""
    c = sdf_lab[..., 1:-1, 1:-1, 1:-1]
    gU2 = 0.0
    num = 0.0
    for a in range(3):
        lo = [slice(1, -1)] * 3
        hi = [slice(1, -1)] * 3
        lo[a] = slice(0, -2)
        hi[a] = slice(2, None)
        p = sdf_lab[(Ellipsis,) + tuple(hi)]
        m = sdf_lab[(Ellipsis,) + tuple(lo)]
        gU = p - m
        gI = torch.clamp_min(p, 0.0) - torch.clamp_min(m, 0.0)
        gU2 = gU2 + gU * gU
        num = num + gI * gU
    band = num / (gU2 + 1e-30)
    one = torch.ones((), dtype=c.dtype, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    return torch.where(c > h, one, torch.where(c < -h, zero, band))


def grad_chi(grid: UniformGrid, chi: torch.Tensor) -> torch.Tensor:
    """Centered grad chi (nx,ny,nz,3); points into the body."""
    return st.grad(grid.pad_scalar(chi, 1), 1, grid.h)


def surface_delta(grid: UniformGrid, chi: torch.Tensor) -> torch.Tensor:
    """|grad chi|, the surface delta-function weight per cell."""
    g = grad_chi(grid, chi)
    return torch.sqrt(torch.sum(g * g, dim=-1))
