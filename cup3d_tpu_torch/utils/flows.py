"""Canonical analytic flow fields (port of ``cup3d_tpu/utils/flows.py``,
the Taylor-Green part).  ``grid`` is a UniformGrid or an AMR BlockGrid:
both give ``cell_centers(dtype, device)``."""

from __future__ import annotations

import numpy as np
import torch


def taylor_green_2d(grid, t: float = 0.0, nu: float = 0.0,
                    dtype=torch.float32, device="cpu") -> torch.Tensor:
    """z-invariant Taylor-Green vortex — an *exact* unsteady NS solution
    (velocity decays as exp(-2 nu k^2 t))."""
    x = grid.cell_centers(dtype, device)
    k = 2.0 * np.pi / grid.extent[0]
    decay = float(np.exp(-2.0 * nu * k * k * t))
    u = torch.sin(k * x[..., 0]) * torch.cos(k * x[..., 1]) * decay
    v = -torch.cos(k * x[..., 0]) * torch.sin(k * x[..., 1]) * decay
    return torch.stack([u, v, torch.zeros_like(u)], dim=-1)


def taylor_green_3d(grid, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Classic 3-D Taylor-Green initial condition — the reference's
    `-initCond taylorGreen` (main.cpp:12722)."""
    x = grid.cell_centers(dtype, device)
    k = 2.0 * np.pi / grid.extent[0]
    u = (torch.sin(k * x[..., 0]) * torch.cos(k * x[..., 1])
         * torch.cos(k * x[..., 2]))
    v = (-torch.cos(k * x[..., 0]) * torch.sin(k * x[..., 1])
         * torch.cos(k * x[..., 2]))
    return torch.stack([u, v, torch.zeros_like(u)], dim=-1)
