"""Timestep policy (port of ``cup3d_tpu/sim/dtpolicy.py``; the
reference's calcMaxTimestep, main.cpp:15268-15292):

  dtDiffusion = (implicitDiffusion && step > 10) ? 0.1
              : (1/6) h^2 / (nu + (1/6) h uMax)
  dtAdvection = h / (uMax + 1e-8)
  CFL_eff     = exp(log(1e-3)(1-x) + log(CFL) x),  x = step/rampup  (ramp)
  dt          = min(dtDiffusion, CFL_eff * dtAdvection)
"""

from __future__ import annotations

import math

import torch

__all__ = ["ramped_cfl", "diffusion_cap", "dt_host", "dt_device",
           "dt_device_implicit"]


def ramped_cfl(cfl: float, step: int, rampup: int) -> float:
    """Log-space CFL ramp from an absolute 1e-3 (main.cpp:15275-15279)."""
    if rampup > 0 and step < rampup:
        x = step / rampup
        return math.exp(math.log(1e-3) * (1.0 - x) + math.log(cfl) * x)
    return cfl


def diffusion_cap(h: float, nu: float, umax: float,
                  implicit: bool, step: int) -> float:
    """Combined advection-diffusion stability cap (main.cpp:15269-15273)."""
    if implicit and step > 10:
        return 0.1
    return (h * h / 6.0) / (nu + (h / 6.0) * umax)


def dt_host(h: float, nu: float, umax: float, cfl: float, step: int,
            rampup: int, implicit: bool) -> float:
    """Full host-side dt = min(dtDiffusion, CFL_eff * dtAdvection)."""
    cfl_eff = ramped_cfl(cfl, step, rampup)
    dt_adv = h / (umax + 1e-8)
    return float(min(diffusion_cap(h, nu, umax, implicit, step),
                     cfl_eff * dt_adv))


def dt_device(umax, cfl_eff, h: float, nu: float):
    """The same dt (explicit diffusion) from a device max|u| tensor, as a
    device tensor: the pipelined driver's dt chain never reads it."""
    cap = (h * h / 6.0) / (nu + (h / 6.0) * umax)
    return torch.minimum(cfl_eff * h / (umax + 1e-8), cap)


def dt_device_implicit(umax, cfl_eff, h: float, nu: float,
                       past_warmup: bool):
    """The device dt under implicit diffusion: the absolute 0.1 cap once
    step > 10 (``past_warmup``; main.cpp:15270-15271), the combined cap
    before that."""
    if past_warmup:
        cap = torch.full_like(umax, 0.1)
    else:
        cap = (h * h / 6.0) / (nu + (h / 6.0) * umax)
    return torch.minimum(cfl_eff * h / (umax + 1e-8), cap)
