"""Diagnostic reductions (port of ``cup3d_tpu/ops/diagnostics.py``):
vorticity, divergence norms, dissipation, max velocity, the fluid's
divergence away from the bodies on both layouts (the reference's ComputeVorticity main.cpp:8624-8745,
ComputeDivergence 8789-8919, KernelDissipation 10347-10435, findMaxU
8603-8623).  Results stay on the device; callers read them."""

from __future__ import annotations

from typing import Dict

import torch

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops import stencils as st


def vorticity(grid: UniformGrid, u: torch.Tensor) -> torch.Tensor:
    return st.curl(grid.pad_vector(u, 1), 1, grid.h)


def vorticity_magnitude(grid: UniformGrid, u: torch.Tensor) -> torch.Tensor:
    """|curl u| per cell (the dumps' omega field)."""
    om = vorticity(grid, u)
    return torch.sqrt(torch.sum(om * om, dim=-1))


def divergence_field(grid: UniformGrid, u: torch.Tensor) -> torch.Tensor:
    return st.divergence(grid.pad_vector(u, 1), 1, grid.h)


def divergence_norms(grid: UniformGrid, u: torch.Tensor):
    """(sum |div u| h^3, max |div u|)."""
    d = divergence_field(grid, u)
    vol = grid.h ** 3
    return torch.sum(torch.abs(d)) * vol, torch.max(torch.abs(d))


def max_velocity(u: torch.Tensor, uinf: torch.Tensor) -> torch.Tensor:
    """max over cells of max-norm of lab-frame velocity (findMaxU)."""
    return torch.max(torch.abs(u + uinf))


def dissipation(grid: UniformGrid, u: torch.Tensor,
                nu: float) -> Dict[str, torch.Tensor]:
    """Kinetic energy 0.5 |u|^2, enstrophy 0.5 |omega|^2 and viscous
    dissipation rate 2 nu S:S, each integrated with cell volume h^3."""
    up = grid.pad_vector(u, 1)
    h = grid.h
    g = [[st.d1_central(up[..., c], 1, a, h) for a in range(3)]
         for c in range(3)]
    ss = torch.zeros_like(g[0][0])
    for c in range(3):
        for a in range(3):
            s = 0.5 * (g[c][a] + g[a][c])
            ss = ss + s * s
    w = st.curl(up, 1, h)
    vol = h ** 3
    return {
        "kinetic_energy": 0.5 * torch.sum(torch.sum(u * u, dim=-1)) * vol,
        "enstrophy": 0.5 * torch.sum(torch.sum(w * w, dim=-1)) * vol,
        "dissipation_rate": 2.0 * nu * torch.sum(ss) * vol,
    }


def fluid_divergence_max(grid: UniformGrid, u: torch.Tensor,
                         chi: torch.Tensor, halo: int = 3) -> torch.Tensor:
    """max |div u| over cells at least ``halo`` cells (Chebyshev distance)
    away from the mollified chi band: inside it the Brinkman forcing is a
    momentum source and the deforming body's div u_def is imposed, so
    this is the incompressibility gate of a flow with bodies (the JAX
    package's bench gates the 128^3 fish here at 0.04, bench.py:52-59).
    The band mask is dilated axis by axis, wrapping only across periodic
    boundaries."""
    from cup3d_tpu_torch.grid.uniform import BC

    def shift(m, sh, ax):
        if grid.bc[ax] == BC.periodic:
            return torch.roll(m, sh, dims=ax)
        z = torch.zeros_like(m)
        n = m.shape[ax]
        if sh > 0:
            z.narrow(ax, sh, n - sh).copy_(m.narrow(ax, 0, n - sh))
        else:
            z.narrow(ax, 0, n + sh).copy_(m.narrow(ax, -sh, n + sh))
        return z

    grow = chi > 1e-6
    for ax in range(3):
        g = grow
        for sh in range(1, halo + 1):
            g = g | shift(grow, sh, ax) | shift(grow, -sh, ax)
        grow = g
    d = divergence_field(grid, u)
    return torch.max(torch.where(grow, torch.zeros_like(d), torch.abs(d)))


def fluid_divergence_max_blocks(grid, vel: torch.Tensor, chi: torch.Tensor,
                                tab) -> torch.Tensor:
    """The forest's twin of :func:`fluid_divergence_max`: max |div u| over
    the blocks whose chi lab (the block and its ghost halo) vanishes
    everywhere, so at least a stencil's width from the band (the JAX
    package's bench gate of BASELINE config #4, bench.py:1492-1502)."""
    from cup3d_tpu_torch.ops import amr_ops

    vlab = tab.assemble_vector(vel, grid.bs)
    d = amr_ops.div_blocks(grid, vlab, tab.width)
    clab = tab.assemble_scalar(chi, grid.bs)
    fluid = torch.amax(clab.reshape(grid.nb, -1), dim=1) < 1e-6
    return torch.max(torch.where(fluid[:, None, None, None], torch.abs(d),
                                 torch.zeros_like(d)))
