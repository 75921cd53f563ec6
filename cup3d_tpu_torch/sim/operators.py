"""The operator pipeline (port of ``cup3d_tpu/sim/operators.py``; the
reference's Operator ABC main.cpp:6678-6684, order fixed in
setupOperators, main.cpp:15229-15246).

Operators orchestrate; the math lives in ``cup3d_tpu_torch.ops``.  ``dt``
arrives as a 0-dim device tensor uploaded once per step.  Not ported yet
(ROADMAP A5): implicit diffusion, external forcing, mass-flux fixing and
the vorticity initial condition — they raise.
"""

from __future__ import annotations

from cup3d_tpu_torch.ops import diagnostics as diag
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
        ke, ens, rate = (float(d[k]) for k in
                         ("kinetic_energy", "enstrophy", "dissipation_rate"))
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
        s.logger.write(
            "div.txt",
            f"{s.step} {s.time:.8e} {float(total):.8e} {float(peak):.8e}\n",
        )


def initial_conditions(sim: SimulationData) -> None:
    """InitialConditions operator (main.cpp:12506-12748): zero,
    Taylor-Green or parabolic channel profile."""
    import torch

    cfg, grid = sim.cfg, sim.grid
    kind = cfg.initCond
    if kind == "zero":
        return
    if kind == "taylorGreen":
        from cup3d_tpu_torch.utils.flows import taylor_green_3d

        sim.state["vel"] = taylor_green_3d(grid, sim.dtype, sim.device)
        return
    if kind == "vorticity":
        raise NotImplementedError(
            "initCond vorticity (coil_velocity_uniform) is not ported "
            "(ROADMAP A5)")
    x = grid.cell_centers(sim.dtype, sim.device)
    if kind == "channel":
        H = grid.extent[1]
        y = x[..., 1] / H
        u = 4.0 * cfg.uMax_forced * y * (1.0 - y)
        sim.state["vel"] = torch.stack(
            [u, torch.zeros_like(u), torch.zeros_like(u)], -1)
    else:
        raise ValueError(f"unknown initCond {kind!r}")
