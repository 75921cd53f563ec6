"""Canonical analytic flow fields (port of ``cup3d_tpu/utils/flows.py``):
the Taylor-Green vortices and the coiled-vorticity initial condition.
``grid`` is a UniformGrid or an AMR BlockGrid for the Taylor-Green
fields (both give ``cell_centers(dtype, device)``); the coil's velocity
is the uniform grid's."""

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


#: cells a chunk of the nearest-coil-point search: (chunk, 90) f32
#: distances are 47 MB (the whole 128^3 grid at once would be 755 MB)
COIL_CHUNK = 1 << 17


def _coil_points():
    """The reference's 90-point coil (IC_vorticity, main.cpp:12537-12614):
    points at radius R(phi) = 0.05 sin(2 phi) about (1,1,1) and their unit
    tangents, built in float64."""
    ncoil, m = 90, 2
    phi = np.arange(ncoil) * (2.0 * np.pi / ncoil)
    R = 0.05 * np.sin(m * phi)
    pts = np.stack([R * np.cos(phi) + 1.0, R * np.sin(phi) + 1.0,
                    R * np.cos(m * phi) + 1.0], axis=-1)
    dR = 0.05 * m * np.cos(m * phi)
    tang = np.stack([dR * np.cos(phi) - R * np.sin(phi),
                     dR * np.sin(phi) + R * np.cos(phi),
                     dR * np.cos(m * phi) - m * R * np.sin(m * phi)], axis=-1)
    tang /= np.sqrt((tang ** 2).sum(-1) + 1e-21)[:, None]
    return pts, tang


def coil_vorticity(xc: torch.Tensor, chunk: int = COIL_CHUNK) -> torch.Tensor:
    """The reference's coiled-vorticity field: each cell takes the unit
    tangent of the NEAREST coil point scaled by 1/(r^2+1)^2.  xc: (..., 3)
    cell centres; returns omega (..., 3).  The nearest point is searched
    ``chunk`` cells at a time; ``torch.argmin`` keeps the first of equal
    distances, as ``jnp.argmin`` does."""
    pts, tang = _coil_points()
    p = torch.as_tensor(pts, dtype=xc.dtype, device=xc.device)
    t = torch.as_tensor(tang, dtype=xc.dtype, device=xc.device)
    flat = xc.reshape(-1, 3)
    out = torch.empty_like(flat)
    for a in range(0, flat.shape[0], chunk):
        d = flat[a:a + chunk, None, :] - p  # (c, ncoil, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        idx = torch.argmin(d2, dim=-1)
        r2 = torch.gather(d2, 1, idx[:, None])[:, 0]
        mag = 1.0 / (r2 + 1.0) ** 2
        out[a:a + chunk] = mag[:, None] * t[idx]
    return out.reshape(xc.shape)


def coil_velocity_uniform(grid, dtype=torch.float32,
                          device="cpu") -> torch.Tensor:
    """Velocity recovered from the coiled vorticity: u_d = lap^-1 of
    -(curl omega)_d, component by component (the reference solves the
    same three Poisson problems with its pressure solver,
    main.cpp:12614-12668), by the exact spectral inverse."""
    from cup3d_tpu_torch.ops import stencils as st
    from cup3d_tpu_torch.ops.poisson import build_spectral_solver

    om = coil_vorticity(grid.cell_centers(dtype, device))
    curl = st.curl(grid.pad_vector(om, 1), 1, grid.h)
    solver = build_spectral_solver(grid, dtype)
    return torch.stack([solver(-curl[..., d]) for d in range(3)], dim=-1)
