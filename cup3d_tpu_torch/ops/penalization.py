"""Brinkman penalization (port of ``cup3d_tpu/ops/penalization.py``; the
reference's Penalization kernel, main.cpp:13841-13912).

Implicit form: u^{n+1} = u + (lambda chi dt / (1 + lambda chi dt))
(u_body - u), with u_body = u_trans + omega x r + u_def.
"""

from __future__ import annotations

import torch


def penalize(vel: torch.Tensor, chi: torch.Tensor, ubody: torch.Tensor,
             lam, dt) -> torch.Tensor:
    """vel, ubody: (...,3); chi in [0,1]; lam, dt scalars or 0-dim."""
    x = lam * dt * chi
    fac = (x / (1.0 + x))[..., None]
    return vel + fac * (ubody - vel)


def penalization_force(vel_new: torch.Tensor, vel_old: torch.Tensor, dt,
                       h: float) -> torch.Tensor:
    """Force density integrand (u^{n+1} - u^n)/dt * h^3
    (main.cpp:13913-13938)."""
    return (vel_new - vel_old) * (h ** 3 / dt)


def per_obstacle_penalization_force(vel_new, vel_old, chis, dt, vol, xc,
                                    cms, eps: float = 1e-6) -> torch.Tensor:
    """Per-obstacle momentum-balance [force(3), torque(3)] from the
    penalization update (the reference's kernelFinalizePenalizationForce,
    main.cpp:13913-13938); overlap cells are attributed by chi fraction.
    ``chis``: per-obstacle chi fields; ``cms``: (n_obs, 3).  Returns
    (n_obs, 6) on the device."""
    df = (vel_new - vel_old) / dt
    den = torch.clamp_min(sum(chis), eps)
    dims = tuple(range(df.ndim - 1))
    out = []
    for i, chi in enumerate(chis):
        wv = (chi / den * vol)[..., None]
        f = torch.sum(df * wv, dim=dims)
        r = xc - cms[i]
        t = torch.sum(torch.linalg.cross(r, df) * wv, dim=dims)
        out.append(torch.cat([f, t]))
    return torch.stack(out)
