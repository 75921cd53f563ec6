"""Simulation driver: init + timestep loop (port of the per-step,
obstacle-free part of ``cup3d_tpu/sim/simulation.py``; reference
Simulation, main.cpp:15161-15326).

``simulate()`` = loop { calc_max_timestep; advance } until ``tend`` or
``nsteps``.  Each step ends in ONE device-to-host read that brings back
the Poisson solver's [residual, iterations] and max|u| for the next dt.

Runs on CUDA unless the caller asks for the CPU (``device="cpu"``); with
no GPU and no explicit device it raises.  Not ported yet, and raising:
obstacles (ROADMAP A3), pipelined stepping and the scan megaloop (A4),
dumps and checkpoints (A4), implicit diffusion, forcing and mass-flux
fixing (A5), the resilience engine (A5).  ``levelMax > 1`` is the AMR
driver's (sim/amr.py).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.ops import diagnostics as diag
from cup3d_tpu_torch.sim import operators as ops
from cup3d_tpu_torch.sim.data import SimulationData


class SimulationFailure(RuntimeError):
    """A run aborted by its own health checks (runaway velocity, dt
    collapse), with a machine-readable ``reason``."""

    def __init__(self, reason: str, message: str, extra: dict):
        super().__init__(message)
        self.reason = reason
        self.extra = extra


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without a GPU that raises instead of running on
    the CPU.  Pass ``"cpu"`` to run there on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: cup3d_tpu_torch runs on the GPU unless "
                "asked for the CPU (device='cpu', or -device cpu)")
        device = "cuda"
    return torch.device(device)


def _unsupported(cfg: SimulationConfig) -> Optional[str]:
    if cfg.levelMax > 1:
        return "levelMax > 1 (the AMR driver, sim/amr.AMRSimulation)"
    if cfg.factory_content or cfg.factory:
        return "obstacles (ROADMAP A3)"
    if cfg.pipelined:
        return "pipelined stepping (ROADMAP A4)"
    if cfg.scan_k or int(os.environ.get("CUP3D_SCAN_K", "0") or 0) > 1:
        return "the scan megaloop (ROADMAP A4)"
    if cfg.implicitDiffusion:
        return "implicit diffusion (ROADMAP A5)"
    if cfg.uMax_forced > 0 or cfg.bFixMassFlux:
        return "external forcing / mass-flux fixing (ROADMAP A5)"
    if cfg.tdump > 0 or cfg.fdump > 0 or cfg.saveFreq > 0:
        return "field dumps and checkpoints (ROADMAP A4)"
    return None


class Simulation:
    def __init__(self, cfg: SimulationConfig, device=None):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sim = SimulationData(cfg, self.device)
        self.pipeline: List[ops.Operator] = []
        # max|u| from the previous step's end-of-step read
        self._umax_next: Optional[float] = None
        self._last_umax: Optional[float] = None
        #: one dict per finished step: step, time, dt, umax, wall_s and,
        #: for an iterative solver, resid and iters
        self.step_log: List[dict] = []

    # -- setup (reference init(), main.cpp:15163-15178) --------------------

    def init(self) -> None:
        self._setup_operators()
        ops.initial_conditions(self.sim)

    def _setup_operators(self) -> None:
        """Pipeline order is the reference's (main.cpp:15229-15246)."""
        s = self.sim
        self.pipeline = [
            ops.AdvectionDiffusion(s),
            ops.PressureProjection(s),
            ops.ComputeDissipation(s),
            ops.ComputeDivergence(s),
        ]

    # -- time stepping -----------------------------------------------------

    def calc_max_timestep(self) -> float:
        """CFL dt with diffusive cap and log ramp-up (main.cpp:15254-15305),
        from max|u| read at the end of the previous step (or read now)."""
        from cup3d_tpu_torch.sim import dtpolicy

        s, cfg = self.sim, self.cfg
        h = s.grid.h
        if self._umax_next is not None:
            umax = self._umax_next
            self._umax_next = None
        else:
            umax = float(diag.max_velocity(s.state["vel"], s.uinf_device()))
        self._last_umax = umax
        if not np.isfinite(umax) or umax > cfg.uMax_allowed:
            s.logger.flush()
            reason = ("nan-velocity" if not np.isfinite(umax)
                      else "runaway-velocity")
            raise SimulationFailure(
                reason,
                f"runaway velocity: max|u|={umax:.3g} > "
                f"uMax_allowed={cfg.uMax_allowed}",
                {"step": s.step, "umax": umax},
            )
        if cfg.dt > 0:
            s.dt = cfg.dt
        else:
            s.dt = dtpolicy.dt_host(h, s.nu, umax, cfg.CFL, s.step,
                                    cfg.rampup, cfg.implicitDiffusion)
            if cfg.tend > 0:
                s.dt = min(s.dt, cfg.tend - s.time)
        if not np.isfinite(s.dt) or s.dt <= 0:
            raise SimulationFailure(
                "dt-collapse", f"dt policy collapse: dt={s.dt:.3g}",
                {"step": s.step, "dt": s.dt, "umax": umax})
        return s.dt

    def advance(self, dt: float) -> None:
        s = self.sim
        t0 = time.perf_counter()
        # one host->device upload: every operator gets the same dt tensor
        dt_dev = torch.tensor(dt, dtype=s.dtype, device=s.device)
        for op in self.pipeline:
            with s.profiler(op.name):
                op(dt_dev)
        with s.profiler("SyncQoI"):
            row = self._read_step_pack()
        row.update(step=s.step, time=s.time, dt=dt,
                   wall_s=time.perf_counter() - t0)
        self.step_log.append(row)
        s.step += 1
        s.time += dt

    def _read_step_pack(self) -> dict:
        """Concatenate the step's device QoI (solver stats) and max|u| into
        one vector and read it back: the step's single device sync."""
        s = self.sim
        parts = s.pending_parts
        s.pending_parts = []
        umax = diag.max_velocity(s.state["vel"], s.uinf_device())
        parts.append(("umax", umax.reshape(1)))
        vals = torch.cat([v.reshape(-1).to(torch.float64)
                          for _, v in parts]).cpu().tolist()
        row, off = {}, 0
        for name, v in parts:
            seg = vals[off:off + v.numel()]
            off += v.numel()
            if name == "umax":
                self._umax_next = seg[0]
                row["umax"] = seg[0]
            elif name == "psolve":
                row["resid"], row["iters"] = seg[0], seg[1]
        return row

    def simulate(self) -> None:
        s, cfg = self.sim, self.cfg
        while True:
            dt = self.calc_max_timestep()
            if cfg.verbose:
                print(f"cup3d_tpu_torch: step: {s.step}, "
                      f"time: {s.time:f}, dt: {dt:.3e}")
            self.advance(dt)
            done_t = cfg.tend > 0 and s.time >= cfg.tend - 1e-12
            done_n = cfg.nsteps > 0 and s.step >= cfg.nsteps
            if done_t or done_n:
                break
        s.logger.flush()
