"""The operator pipeline (port of ``cup3d_tpu/sim/operators.py``; the
reference's Operator ABC main.cpp:6678-6684, order fixed in
setupOperators, main.cpp:15229-15246).

Operators orchestrate; the math lives in ``cup3d_tpu_torch.ops``.  ``dt``
arrives as a 0-dim device tensor uploaded once per step.
"""

from __future__ import annotations

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer
from cup3d_tpu_torch.ops import diagnostics as diag
from cup3d_tpu_torch.ops import diffusion
from cup3d_tpu_torch.ops.advection import rk3_step
from cup3d_tpu_torch.ops.projection import project
from cup3d_tpu_torch.sim.data import SimulationData


class Operator:
    """Base: stateful wrapper invoked once per step as op(dt)."""

    def __init__(self, sim: SimulationData):
        self.sim = sim

    @property
    def name(self) -> str:
        return type(self).__name__

    def __call__(self, dt) -> None:
        raise NotImplementedError


class AdvectionDiffusion(Operator):
    """Explicit RK3 advection-diffusion (main.cpp:9640-9728)."""

    def __call__(self, dt):
        s = self.sim
        s.state["vel"] = rk3_step(s.grid, s.state["vel"], dt, s.nu,
                                  s.uinf_device())


class AdvectionDiffusionImplicit(Operator):
    """Explicit-advection Euler + implicit diffusion solve
    (main.cpp:9849-10118).  On the uniform grid the Helmholtz system
    (I - nu dt lap) u = u* is diagonalized exactly per component
    (ops/diffusion.py): unconditionally stable, no Krylov iteration."""

    def __init__(self, sim: SimulationData):
        super().__init__(sim)
        self._helm = diffusion.build_spectral_helmholtz(sim.grid, sim.dtype)

    def __call__(self, dt):
        s = self.sim
        s.state["vel"] = diffusion.implicit_step(
            s.grid, s.state["vel"], dt, s.nu, s.uinf_device(), self._helm)


class ExternalForcing(Operator):
    """Constant streamwise acceleration for forced channel-type flows:
    du = 8 nu uMax / H^2 * dt (main.cpp:10581-10596)."""

    def __call__(self, dt):
        s = self.sim
        H = s.grid.extent[1]
        accel = 8.0 * s.nu * s.cfg.uMax_forced / (H * H)
        vel = s.state["vel"]
        s.state["vel"] = torch.cat([vel[..., :1] + accel * dt, vel[..., 1:]],
                                   dim=-1)


def bulk_velocity(vel: torch.Tensor) -> torch.Tensor:
    """Volume average of the streamwise velocity (a pairwise-summed f32
    mean; the JAX package's CPU mean is one sequential f32 sum, which
    drifts from it by up to n * eps * max|u|)."""
    return torch.mean(vel[..., 0])


class FixMassFlux(Operator):
    """Hold a target bulk flux by adding a parabolic streamwise profile
    (reference FixMassFlux, main.cpp:12199-12249): measure the volume
    average of u+uinf and add delta * 6 eta(1-eta) (mean exactly delta).

    The JAX package's documented deviation from the reference, kept: the
    reference's aux = 6*(6*delta)*eta(1-eta) restores SIX times the
    measured deficit per step (amplifying the flux error 5x per
    application); this restores the deficit exactly.  The flux.txt row
    reads the measured bulk velocity on the host every step, as the JAX
    package's does (a designed read)."""

    def __init__(self, sim: SimulationData):
        super().__init__(sim)
        ny = sim.grid.shape[1]
        eta = (np.arange(ny) + 0.5) / ny  # y / y_max at cell centers
        self._profile = torch.as_tensor(6.0 * eta * (1.0 - eta),
                                        dtype=sim.dtype,
                                        device=sim.device)[None, :, None]

    def __call__(self, dt):
        s = self.sim
        u_target = 2.0 / 3.0 * s.cfg.uMax_forced  # bulk of a parabola
        vel = s.state["vel"]
        # the host scalars round to the field dtype inside the ops, as
        # the JAX package's f32 uploads do
        u_msr = bulk_velocity(vel) + float(s.uinf[0])
        delta = u_target - u_msr
        s.state["vel"] = torch.cat(
            [vel[..., :1] + (delta * self._profile)[..., None],
             vel[..., 1:]], dim=-1)
        with sanctioned_transfer("flux-read"):
            u_msr = float(u_msr)
        s.logger.write("flux.txt",
                       f"{s.step} {s.time:.8e} {u_msr:.8e} {u_target:.8e}\n")


class PressureProjection(Operator):
    """RHS -> Poisson solve (warm-started from the previous pressure) ->
    velocity correction (main.cpp:15061-15160).  An iterative solver's
    [residual, iterations] device vector joins the step's end-of-step
    read (``pending_parts``) — no read of its own."""

    def __init__(self, sim: SimulationData):
        super().__init__(sim)
        solver = sim.poisson_solver
        self._with_stats = bool(getattr(solver, "supports_stats", False))
        self.solver_maxiter = getattr(solver, "maxiter", None)

    def __call__(self, dt):
        s = self.sim
        out = project(s.grid, s.state["vel"], dt, s.poisson_solver,
                      s.state["chi"], s.state["udef"], p_init=s.state["p"],
                      with_stats=self._with_stats)
        if self._with_stats:
            vel, p, stats = out
            s.pending_parts.append(("psolve", stats))
        else:
            vel, p = out
        s.state["vel"] = vel
        s.state["p"] = p


class ComputeDissipation(Operator):
    """Energy-budget diagnostics every freqDiagnostics steps
    (main.cpp:10436-10447); appends to energy.txt."""

    def __call__(self, dt):
        s = self.sim
        freq = s.cfg.freqDiagnostics
        if freq <= 0 or s.step % freq:
            return
        d = diag.dissipation(s.grid, s.state["vel"], s.nu)
        with sanctioned_transfer("diagnostics-read"):
            ke, ens, rate = (float(d[k]) for k in (
                "kinetic_energy", "enstrophy", "dissipation_rate"))
        s.logger.write("energy.txt",
                       f"{s.time:.8e} {ke:.8e} {ens:.8e} {rate:.8e}\n")


class ComputeDivergence(Operator):
    """Appends (step, time, sum|div u| h^3, max|div u|) to div.txt
    (main.cpp:8789-8919)."""

    def __call__(self, dt):
        s = self.sim
        freq = s.cfg.freqDiagnostics
        if freq <= 0 or s.step % freq:
            return
        total, peak = diag.divergence_norms(s.grid, s.state["vel"])
        with sanctioned_transfer("diagnostics-read"):
            total, peak = float(total), float(peak)
        s.logger.write("div.txt",
                       f"{s.step} {s.time:.8e} {total:.8e} {peak:.8e}\n")


def initial_conditions(sim: SimulationData) -> None:
    """InitialConditions operator (main.cpp:12506-12748): zero,
    Taylor-Green, the coiled vorticity or the parabolic channel
    profile."""

    cfg, grid = sim.cfg, sim.grid
    kind = cfg.initCond
    if kind == "zero":
        return
    if kind == "taylorGreen":
        from cup3d_tpu_torch.utils.flows import taylor_green_3d

        sim.state["vel"] = taylor_green_3d(grid, sim.dtype, sim.device)
        return
    if kind == "vorticity":
        from cup3d_tpu_torch.utils.flows import coil_velocity_uniform

        sim.state["vel"] = coil_velocity_uniform(grid, sim.dtype, sim.device)
        return
    x = grid.cell_centers(sim.dtype, sim.device)
    if kind == "channel":
        H = grid.extent[1]
        y = x[..., 1] / H
        u = 4.0 * cfg.uMax_forced * y * (1.0 - y)
        sim.state["vel"] = torch.stack(
            [u, torch.zeros_like(u), torch.zeros_like(u)], -1)
    else:
        raise ValueError(f"unknown initCond {kind!r}")
