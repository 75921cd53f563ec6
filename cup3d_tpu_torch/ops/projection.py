"""Pressure projection (port of ``cup3d_tpu/ops/projection.py``; the
reference's ``PressureProjection``, main.cpp:15061-15160).

rhs = (div u - chi * div u_def) / dt; solve lap p = rhs; u -= dt grad p.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops import stencils as st


def pressure_rhs(grid: UniformGrid, u: torch.Tensor, dt,
                 chi: Optional[torch.Tensor] = None,
                 udef: Optional[torch.Tensor] = None) -> torch.Tensor:
    w = 1
    div_u = st.divergence(grid.pad_vector(u, w), w, grid.h)
    if chi is not None and udef is not None:
        div_udef = st.divergence(grid.pad_vector(udef, w), w, grid.h)
        div_u = div_u - chi * div_udef
    return div_u / dt


def project(grid: UniformGrid, u: torch.Tensor, dt, solver: Callable,
            chi: Optional[torch.Tensor] = None,
            udef: Optional[torch.Tensor] = None,
            p_init: Optional[torch.Tensor] = None,
            with_stats: bool = False):
    """Returns (projected velocity, pressure[, stats]).  ``p_init``
    warm-starts an iterative solver (ignored by the spectral one);
    ``with_stats`` adds the iterative solver's (2,) [residual,
    iterations] device vector (None for a solver without stats)."""
    rhs = pressure_rhs(grid, u, dt, chi, udef)
    if with_stats and getattr(solver, "supports_stats", False):
        p, stats = solver(rhs, p_init, with_stats=True)
    else:
        p = solver(rhs, p_init)
        stats = None
    gradp = st.grad(grid.pad_scalar(p, 1), 1, grid.h)
    if with_stats:
        return u - dt * gradp, p, stats
    return u - dt * gradp, p
