"""Explicit advection-diffusion (port of ``cup3d_tpu/ops/advection.py``;
the reference's ``AdvectionDiffusion``, main.cpp:9461-9728).

RHS(u) = -((u + uinf) . grad) u + nu lap(u), with 5th-order 6-point
biased-upwind advective derivatives and a 7-point viscous Laplacian,
advanced by low-storage RK3 (main.cpp:9640-9728).
"""

from __future__ import annotations

import torch

from cup3d_tpu_torch.grid.uniform import UniformGrid
from cup3d_tpu_torch.ops import stencils as st

GHOSTS = 3  # 5th-order upwind needs 3 ghost cells

# Low-storage RK3 (Williamson) — the reference's coefficients.
RK3_A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)


def advection_diffusion_rhs(grid: UniformGrid, u: torch.Tensor, nu: float,
                            uinf: torch.Tensor, pad=None) -> torch.Tensor:
    """du/dt from advection + diffusion; u (nx,ny,nz,3), uinf (3,) frame
    velocity added to the advecting field only.  ``pad``: a ``(u, width)
    -> padded`` ghost supplier in place of ``grid.pad_vector``; the x-slab
    megaloop passes parallel/ring.pad_slab_vector with u as D slabs
    (D, sx, ny, nz, 3), so the stencils run on every slab at once."""
    h = grid.h
    up = grid.pad_vector(u, GHOSTS) if pad is None else pad(u, GHOSTS)
    uadv = [u[..., c] + uinf[c] for c in range(3)]
    out = []
    for c in range(3):
        comp = up[..., c]
        adv = sum(
            uadv[a] * st.d1_upwind5(comp, GHOSTS, a, uadv[a], h) for a in range(3)
        )
        dif = st.laplacian(comp, GHOSTS, h) * nu
        out.append(dif - adv)
    return torch.stack(out, dim=-1)


def rk3_step(grid: UniformGrid, u: torch.Tensor, dt, nu: float,
             uinf: torch.Tensor, pad=None) -> torch.Tensor:
    """One explicit low-storage RK3 advection-diffusion step (``pad`` as
    in :func:`advection_diffusion_rhs`)."""
    k = torch.zeros_like(u)
    for a, b in zip(RK3_A, RK3_B):
        k = a * k + dt * advection_diffusion_rhs(grid, u, nu, uinf, pad=pad)
        u = u + b * k
    return u
