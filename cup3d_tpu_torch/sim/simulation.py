"""Simulation driver: init + timestep loop (port of the per-step,
obstacle-free part of ``cup3d_tpu/sim/simulation.py``; reference
Simulation, main.cpp:15161-15326).

``simulate()`` = loop { calc_max_timestep; advance } until ``tend`` or
``nsteps``.  Each step ends in ONE device-to-host read that brings back
the Poisson solver's [residual, iterations] and max|u| for the next dt.

``simulate()`` runs through the RecoveryEngine (resilience/recovery.py)
unless ``CUP3D_RECOVER=0``: health-check failures (NaN or runaway
velocity, dt collapse, a Poisson solve that hits its iteration cap or
returns a NaN residual) roll back to an in-memory snapshot and retry,
walking the Poisson ladder warm-restart -> zero-guess -> tile-only ->
iter-bump.  The flight recorder (obs/flight.py) keeps the recent steps
and writes a postmortem when a failure is not recovered.

One self-propelled StefanFish runs in the reference's pipeline order
(CreateObstacles, advection, UpdateObstacles, Penalization, projection,
ComputeForces, models/pipeline.py); its rigid update, penalization force
and surface forces ride the same end-of-step read.

Runs on CUDA unless the caller asks for the CPU (``device="cpu"``); with
no GPU and no explicit device it raises.  Not ported yet, and raising:
more than one obstacle and obstacles other than the StefanFish (the
collision pass, the sphere and the foil: ROADMAP A5), pipelined stepping
and the scan megaloop (A4), field dumps and periodic checkpoints (A4;
io/checkpoint.py writes and reads checkpoints), implicit diffusion,
forcing and mass-flux fixing (A5).  ``levelMax > 1`` is the AMR driver's
(sim/amr.py).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from cup3d_tpu_torch.config import SimulationConfig, parse_factory
from cup3d_tpu_torch.obs.flight import FlightRecorder
from cup3d_tpu_torch.obs.trace import StepObserver
from cup3d_tpu_torch.ops import diagnostics as diag
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.resilience.recovery import (  # noqa: F401 (re-export)
    RecoveryEngine, SimulationFailure)
from cup3d_tpu_torch.sim import operators as ops
from cup3d_tpu_torch.sim.data import SimulationData


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


def resolve_scan_k(cfg: SimulationConfig) -> int:
    """Effective K of the scan megaloop (the JAX package's
    ``sim/megaloop.resolve_scan_k``): CUP3D_SCAN_K overrides cfg.scan_k,
    a malformed value falls back to cfg.scan_k; K <= 1 is the per-step
    loop."""
    env = os.environ.get("CUP3D_SCAN_K")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return max(0, int(cfg.scan_k))


def _unsupported(cfg: SimulationConfig) -> Optional[str]:
    if cfg.levelMax > 1:
        return "levelMax > 1 (the AMR driver, sim/amr.AMRSimulation)"
    content = cfg.resolved_factory_content()
    if content:
        specs = parse_factory(content)
        if len(specs) > 1:
            return ("more than one obstacle (the collision pass, ROADMAP "
                    "A5: models/collisions.py)")
        kinds = {sp["type"].lower() for sp in specs}
        if kinds - {"stefanfish"}:
            return (f"obstacle type {specs[0]['type']!r} (only the "
                    "StefanFish is ported; the sphere and the foil are "
                    "ROADMAP A5)")
    if cfg.pipelined:
        return "pipelined stepping and the scan megaloop (ROADMAP A4)"
    if cfg.implicitDiffusion:
        return "implicit diffusion (ROADMAP A5)"
    if cfg.uMax_forced > 0 or cfg.bFixMassFlux:
        return "external forcing / mass-flux fixing (ROADMAP A5)"
    if cfg.tdump > 0 or cfg.fdump > 0 or cfg.saveFreq > 0:
        return "field dumps and periodic checkpoints (ROADMAP A4)"
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
        #: for an iterative solver, resid and iters (steps a rollback
        #: abandoned included)
        self.step_log: List[dict] = []
        # the flight recorder's ring runs always; solver stats reach it
        # from the step pack (_read_step_pack), never by a read of their own
        self.flight = FlightRecorder(directory=cfg.path4serialization,
                                     run_config=cfg,
                                     state_probe=self._flight_state)
        self._obs = StepObserver(self.flight, kind="uniform")
        #: the RecoveryEngine while simulate() runs one (None otherwise)
        self._resilience: Optional[RecoveryEngine] = None
        #: K of the scan megaloop, resolved at init(); 0 = the per-step loop
        self._scan_k = 0

    # -- setup (reference init(), main.cpp:15163-15178) --------------------

    def init(self) -> None:
        self._setup_operators()
        self._add_obstacles()
        ops.initial_conditions(self.sim)
        # the megaloop needs pipelined stepping, which _unsupported
        # refuses: as in the JAX package, a run it does not take keeps
        # the per-step loop with K = 0, whatever scan_k asks
        k = resolve_scan_k(self.cfg)
        self._scan_k = k if (k >= 1 and self.cfg.pipelined) else 0

    def _setup_operators(self) -> None:
        """Pipeline order is the reference's (main.cpp:15229-15246)."""
        s, cfg = self.sim, self.cfg
        with_bodies = bool(s.obstacles or cfg.resolved_factory_content())
        if with_bodies:
            from cup3d_tpu_torch.models import pipeline as body_ops
        pipe: List[ops.Operator] = []
        if with_bodies:
            pipe.append(body_ops.CreateObstacles(s))
        pipe.append(ops.AdvectionDiffusion(s))
        if with_bodies:
            pipe.append(body_ops.UpdateObstacles(s))
            pipe.append(body_ops.Penalization(s))
        pipe.append(ops.PressureProjection(s))
        if with_bodies:
            pipe.append(body_ops.ComputeForces(s))
        pipe.append(ops.ComputeDissipation(s))
        pipe.append(ops.ComputeDivergence(s))
        self.pipeline = pipe

    def _add_obstacles(self) -> None:
        content = self.cfg.resolved_factory_content()
        if not content:
            return
        from cup3d_tpu_torch.models.factory import make_obstacles

        self.sim.obstacles = make_obstacles(self.sim, parse_factory(content))

    def _flight_state(self) -> dict:
        """Driver state for a postmortem (called only at dump time)."""
        s = self.sim
        return {"driver": "uniform", "shape": list(s.grid.shape),
                "step": s.step, "time": s.time, "dt": s.dt,
                "uinf": [float(v) for v in s.uinf],
                "obstacles": [type(ob).__name__ for ob in s.obstacles]}

    # -- time stepping -----------------------------------------------------

    def calc_max_timestep(self) -> float:
        """CFL dt with diffusive cap and log ramp-up (main.cpp:15254-15305),
        from max|u| read at the end of the previous step (or read now);
        scaled by a recovering engine; a NaN or runaway max|u| and a
        collapsed dt trigger the flight recorder and raise."""
        from cup3d_tpu_torch.sim import dtpolicy

        s, cfg = self.sim, self.cfg
        h = s.grid.h
        if faults.fire("step.nan_velocity", s.step):
            self._umax_next = float("nan")
        if self._umax_next is not None:
            umax = self._umax_next
            self._umax_next = None
        else:
            # the first step's read (the pack brings it afterwards)
            umax = float(self._umax_device())
        self._last_umax = umax
        if not np.isfinite(umax) or umax > cfg.uMax_allowed:
            s.logger.flush()
            reason = ("nan-velocity" if not np.isfinite(umax)
                      else "runaway-velocity")
            extra = {"step": s.step, "umax": umax}
            self.flight.trigger(reason, extra=extra)
            raise SimulationFailure(
                reason,
                f"runaway velocity: max|u|={umax:.3g} > "
                f"uMax_allowed={cfg.uMax_allowed}", extra)
        if cfg.dt > 0:
            s.dt = cfg.dt
        else:
            s.dt = dtpolicy.dt_host(h, s.nu, umax, cfg.CFL, s.step,
                                    cfg.rampup, cfg.implicitDiffusion)
            if cfg.tend > 0:
                s.dt = min(s.dt, cfg.tend - s.time)
        if self._resilience is not None:
            # the same float at scale 1.0: a fault-free armed run is
            # bitwise the CUP3D_RECOVER=0 one
            s.dt = self._resilience.scale_dt(s.dt)
        if faults.fire("dt.collapse", s.step):
            s.dt = float("nan")
        if not np.isfinite(s.dt) or s.dt <= 0:
            extra = {"step": s.step, "dt": s.dt, "umax": umax}
            self.flight.trigger("dt-collapse", extra=extra)
            raise SimulationFailure(
                "dt-collapse", f"dt policy collapse: dt={s.dt:.3g}", extra)
        # lambda = DLM/dt each step (main.cpp:15302-15303)
        if cfg.DLM > 0:
            s.lambda_penal = cfg.DLM / s.dt
        return s.dt

    def _umax_device(self) -> torch.Tensor:
        """max|u + uinf| on the device, floored with max|udef| when bodies
        swim: at full gait amplitude the tail's deformation velocity
        reaches the advective limit a step before it shows in the fluid."""
        s = self.sim
        umax = diag.max_velocity(s.state["vel"], s.uinf_device())
        if s.obstacles:
            umax = torch.maximum(umax, torch.max(torch.abs(s.state["udef"])))
        return umax

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
        self.flight.record_step({"step": s.step, "t": s.time, "dt": dt,
                                 "umax": self._last_umax,
                                 "wall_s": row["wall_s"],
                                 "solver": self._obs.last_solver})
        s.step += 1
        s.time += dt

    def _read_step_pack(self) -> dict:
        """Concatenate the step's device QoI (the body's rigid state,
        penalization force and surface forces, the solver stats) and max|u|
        into one vector in the solver dtype and read it back: the step's
        single device sync.  The host mirrors are refreshed from it; the
        solver stats go on to the flight recorder (StepObserver)."""
        from cup3d_tpu_torch.models.base import (
            log_forces, store_force_qoi, unpack_forces)

        s = self.sim
        parts = s.pending_parts
        s.pending_parts = []
        parts.append(("umax", self._umax_device().reshape(1)))
        vals = torch.cat([v.reshape(-1).to(s.dtype)
                          for _, v in parts]).cpu().to(torch.float64).numpy()
        ob = s.obstacles[0] if s.obstacles else None
        row, off = {}, 0
        for name, v in parts:
            seg = vals[off:off + v.numel()]
            off += v.numel()
            if name == "rigid":
                ob.apply_rigid_pack(seg)
            elif name == "penal":
                ob.penal_force = seg[:3]
                ob.penal_torque = seg[3:]
            elif name == "forces":
                store_force_qoi(ob, unpack_forces(seg))
                log_forces(s.logger, 0, s.time, ob)
            elif name == "umax":
                self._umax_next = seg[0]
                row["umax"] = seg[0]
            elif name == "psolve":
                row["resid"], row["iters"] = float(seg[0]), float(seg[1])
                self._obs.note_solver(
                    s.step, row["iters"], row["resid"],
                    cap=getattr(s.poisson_solver, "maxiter", None))
        return row

    # -- resilience hooks (resilience/recovery.py driver contract) ---------

    def _resilience_restore(self, payload: dict) -> None:
        """In-place rollback to a ``build_payload``-shaped snapshot.  The
        fields are cloned on the way in, so the snapshot survives repeated
        restores; the obstacles are unpickled from their host state and
        their chi/udef rebuilt by CreateObstacles(0.0)."""
        import pickle

        s = self.sim
        s.state = {k: torch.clone(v) for k, v in payload["fields"].items()}
        s.time = float(payload["time"])
        s.step = int(payload["step"])
        s.dt = float(payload["dt"])
        s.uinf = np.asarray(payload["uinf"], np.float64)
        s.lambda_penal = float(payload["lambda_penal"])
        obstacles = payload.get("obstacles") or []
        if isinstance(obstacles, bytes):
            obstacles = pickle.loads(obstacles)
        s.obstacles = list(obstacles)
        for ob in s.obstacles:
            ob.sim = s
        s.pending_parts = []
        self._umax_next = None
        self._last_umax = None
        if s.obstacles:
            self.pipeline[0](0.0)  # CreateObstacles: rebuild chi/udef

    def _resilience_zero_pressure(self) -> None:
        """Ladder stage 'zero-guess': the next solve starts from p = 0
        (the projection warm-starts from the live pressure)."""
        self.sim.state["p"] = torch.zeros_like(self.sim.state["p"])

    def _resilience_rebuild_poisson(self, two_level=None,
                                    maxiter_mult: int = 1) -> None:
        """Ladder stages 'tile-only' / 'iter-bump': rebuild the Poisson
        solve with the coarse level dropped (under CUP3D_FUSED=1 the fused
        driver then runs the tile-only getZ kernel B3) and/or a bigger
        iteration budget.  The spectral solver is direct and ignores
        both."""
        from cup3d_tpu_torch.ops.poisson import make_poisson_solver

        s, cfg = self.sim, self.cfg
        s.poisson_solver = make_poisson_solver(
            s.grid, cfg.poissonSolver, s.dtype, tol_abs=cfg.poissonTol,
            tol_rel=cfg.poissonTolRel, maxiter=1000 * int(maxiter_mult),
            mean_constraint=cfg.bMeanConstraint, two_level=two_level)
        for i, op in enumerate(self.pipeline):
            if isinstance(op, ops.PressureProjection):
                self.pipeline[i] = ops.PressureProjection(s)

    def simulate(self) -> None:
        """loop { calc_max_timestep; advance } to ``tend`` or ``nsteps``,
        through the RecoveryEngine unless ``CUP3D_RECOVER=0``.  Only
        SimulationFailures of a recoverable reason are retried: any other
        exception (a kernel that fails to build or launch) ends the run."""
        s, cfg = self.sim, self.cfg
        eng = RecoveryEngine.install(self)
        try:
            while True:
                if eng is not None and eng.on_loop_top():
                    continue  # rolled back: restart the iteration
                try:
                    dt = self.calc_max_timestep()
                    if cfg.verbose:
                        print(f"cup3d_tpu_torch: step: {s.step}, "
                              f"time: {s.time:f}, dt: {dt:.3e}")
                    self.advance(dt)
                except Exception as e:
                    if eng is not None and eng.handle_failure(e):
                        continue  # rolled back: retry from the snapshot
                    raise
                done_t = cfg.tend > 0 and s.time >= cfg.tend - 1e-12
                done_n = cfg.nsteps > 0 and s.step >= cfg.nsteps
                if done_t or done_n:
                    break
            s.logger.flush()
        finally:
            if eng is not None:
                eng.uninstall()
