"""Simulation driver: init + timestep loop (port of
``cup3d_tpu/sim/simulation.py``; reference Simulation,
main.cpp:15161-15326).

``simulate()`` = loop { calc_max_timestep; advance } until ``tend`` or
``nsteps``.  Each step's device QoI (the Poisson solver's [residual,
iterations], max|u| for the next dt, the body's rigid state and forces)
is concatenated into ONE pack (``_emit_step_pack``).  Non-pipelined, the
step reads it back at its end.  Pipelined (``cfg.pipelined``), the pack
goes into the QoI stream (stream/qoi.py), whose grouped reads trail the
stepping by a few steps: dt then comes from a stale max|u| (a 1.5x margin
and a 1.03x growth bound), the body's rigid state chains on the device
from step to step (models/base.py), and, for an obstacle-free run stopped
by a step count, the dt itself is computed on the device from the
previous step's device max|u| (the device dt chain, ``cfg.dtDevice``; on
by default on the card), so such a step issues no blocking read at all.
With ``scan_k`` K >= 1 a pipelined run takes K steps at a time from a
device carry (sim/megaloop.py: ``advance_megaloop``), one (K, ROW) block
of QoI rows a megaloop, applied row by row at consumption
(``_consume_scan_rows``); a step budget that K does not divide finishes
on the per-step loop.  ``CUP3D_MESH_X=D`` runs the megaloop on D x-slabs
of the device (``_scan_mesh``; parallel/topology.py, the halos by kernel
B14), bitwise the solo megaloop; a run that cannot slab (an iterative
solver, ``nx % D``, slabs thinner than the three ghost planes) runs
solo, the last two with a warning and a counted fallback.

``simulate()`` runs through the RecoveryEngine (resilience/recovery.py)
unless ``CUP3D_RECOVER=0``: health-check failures (NaN or runaway
velocity, dt collapse, a Poisson solve that hits its iteration cap or
returns a NaN residual) roll back to an in-memory snapshot and retry,
walking the Poisson ladder warm-restart -> zero-guess -> tile-only ->
iter-bump.  The flight recorder (obs/flight.py) keeps the recent steps
and writes a postmortem when a failure is not recovered.

Bodies (StefanFish, sphere, NACA foil) run in the reference's pipeline
order (CreateObstacles, advection, forcing, UpdateObstacles, the
collision pass and Penalization, projection, ComputeForces,
models/pipeline.py); one body's rigid update, penalization force and
surface forces ride the same end-of-step read, several bodies take the
host path.  Forcing (``uMax_forced``) and mass-flux fixing
(``bFixMassFlux``) follow advection, which is explicit RK3 or, with
``implicitDiffusion``, explicit Euler advection and the exact spectral
Helmholtz solve (ops/diffusion.py).

Output runs off the step loop: field dumps every ``tdump`` of simulated
time or ``fdump`` steps go to the sharded writer (stream/dump.py), and a
checkpoint every ``saveFreq`` steps to the async checkpointer
(stream/checkpoint.py); ``drain_streams()`` joins both at the run's end.

Runs on CUDA unless the caller asks for the CPU (``device="cpu"``); with
no GPU and no explicit device it raises.  ``levelMax > 1`` is the AMR
driver's (sim/amr.py); pipelined stepping with more than one body is
refused at ``init()``, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import device_scalar, sanctioned_transfer
from cup3d_tpu_torch.config import SimulationConfig, parse_factory
from cup3d_tpu_torch.obs.flight import FlightRecorder
from cup3d_tpu_torch.obs import export as obs_export
from cup3d_tpu_torch.obs import profile as obs_profile
from cup3d_tpu_torch.obs.trace import StepObserver
from cup3d_tpu_torch.ops import diagnostics as diag
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.resilience.recovery import (  # noqa: F401 (re-export)
    RecoveryEngine, SimulationFailure)
from cup3d_tpu_torch.sim import operators as ops
from cup3d_tpu_torch.sim.data import SimulationData
from cup3d_tpu_torch.stream.qoi import PackPolicy, QoIStream
from cup3d_tpu_torch.obs.trace import now as obs_now


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
        # torch-lint: allow(JX009, a malformed CUP3D_SCAN_K falls back to
        # cfg.scan_k, as documented)
        except ValueError:
            pass
    return max(0, int(cfg.scan_k))


def _unsupported(cfg: SimulationConfig) -> Optional[str]:
    if cfg.levelMax > 1:
        return "levelMax > 1 (the AMR driver, sim/amr.AMRSimulation)"
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
        # max|u| from the last consumed step pack
        self._umax_next: Optional[float] = None
        self._last_umax: Optional[float] = None
        #: one dict per consumed step: step, time, dt, umax, wall_s and,
        #: for an iterative solver, resid and iters (steps a rollback
        #: abandoned included; megaloop rows carry scan=True)
        self.step_log: List[dict] = []
        # the step packs' reader: read at once by a non-pipelined step,
        # grouped and deferred when pipelined; scalars only at 256^3
        ncells = int(np.prod(self.sim.grid.shape))
        self._pack_reader = QoIStream(
            self._consume_pack, policy=PackPolicy.for_cells(ncells),
            profiler=self.sim.profiler)
        # the flight recorder's ring runs always; solver stats reach it
        # from the step pack (_consume_pack), never by a read of their own
        self.flight = FlightRecorder(directory=cfg.path4serialization,
                                     run_config=cfg,
                                     state_probe=self._flight_state)
        self._obs = StepObserver(self.flight, kind="uniform")
        # device-time capture windows at the loop top (CUP3D_PROFILE)
        # and the /metrics exporter (CUP3D_METRICS_PORT): both off by
        # default, and neither reads a device value on the step loop
        obs_profile.CONTROLLER.default_directory(cfg.path4serialization,
                                                 device=self.device)
        self._obs_profile = obs_profile.CONTROLLER
        obs_export.ensure_exporter()
        #: the RecoveryEngine while simulate() runs one (None otherwise)
        self._resilience: Optional[RecoveryEngine] = None
        # the device dt chain (pipelined, obstacle-free): this step's
        # device max|u| and time, resolved at init()
        self._dt_chain = False
        self._umax_dev: Optional[torch.Tensor] = None
        self._time_dev: Optional[torch.Tensor] = None
        #: K of the megaloop, resolved at init(); 0 = the per-step loop
        self._scan_k = 0
        self._megaloop = None  # (megaloop fn, row width) once built
        #: the x-slab mesh of a sharded megaloop (CUP3D_MESH_X), else None
        self._scan_mesh = None
        self._scan_carry = None  # the device carry between megaloops
        # off-critical-path output (stream/dump.py, stream/checkpoint.py)
        from cup3d_tpu_torch.stream.checkpoint import AsyncCheckpointer
        from cup3d_tpu_torch.stream.dump import AsyncDumper

        self._dumper = AsyncDumper()
        self._checkpointer = AsyncCheckpointer()

    # -- setup (reference init(), main.cpp:15163-15178) --------------------

    def init(self) -> None:
        self._setup_operators()
        self._add_obstacles()
        if self.cfg.pipelined:
            if len(self.sim.obstacles) > 1:
                raise ValueError(
                    "pipelined mode requires a single obstacle (the device "
                    "rigid chain has no multi-body collision path) — run "
                    "without -pipelined")
            for ob in self.sim.obstacles:
                # position/depth controllers read trailing host mirrors
                # (gentle, clipped: they tolerate the lag); roll
                # correction MUTATES angVel on the host right after the
                # 6x6 solve and cannot ride the device rigid chain
                if getattr(ob, "bCorrectRoll", False):
                    raise ValueError(
                        "pipelined mode cannot run roll-corrected "
                        "obstacles (host-side angVel mutation): run "
                        "without -pipelined")
        ops.initial_conditions(self.sim)
        self._dt_chain = self._use_device_dt()
        k = resolve_scan_k(self.cfg)
        self._scan_k = k if (k >= 1 and self._megaloop_eligible()) else 0

    def _use_device_dt(self) -> bool:
        """The device dt chain: pipelined obstacle-free runs stopped by a
        step count (the fish's host midline needs the host time), with no
        fixed dt, no per-step diagnostics or flux.txt rows and no dump
        cadence by time.  ``dtDevice`` -1 turns it on for the card, 1
        everywhere, 0 nowhere."""
        cfg = self.cfg
        if not cfg.pipelined or self.sim.obstacles:
            return False
        if cfg.dt > 0 or cfg.tend > 0 or cfg.nsteps <= 0:
            return False
        if cfg.tdump > 0 or cfg.bFixMassFlux:
            return False
        if cfg.freqDiagnostics > 0 or cfg.dtDevice == 0:
            return False
        return cfg.dtDevice == 1 or self.device.type == "cuda"

    def _megaloop_eligible(self) -> bool:
        """Static gate of the megaloop (config and obstacle shape); the
        dynamic parts are re-checked each iteration by _scan_ready."""
        cfg, s = self.cfg, self.sim
        if not cfg.pipelined or cfg.dt > 0 or cfg.implicitDiffusion:
            return False
        if cfg.tend > 0 or cfg.nsteps <= 0:
            # done-by-time needs a fresh time every step
            return False
        if cfg.uMax_forced > 0 or cfg.bFixMassFlux or cfg.freqDiagnostics:
            return False  # forcing/diagnostics operators are per-step
        if not s.obstacles:
            return True
        if len(s.obstacles) != 1:
            return False
        from cup3d_tpu_torch.models.fish.device_midline import (
            device_midline_eligible)

        return device_midline_eligible(s.obstacles[0])

    def _scan_ready(self) -> bool:
        """True when the next iteration runs as one K-step megaloop: scan
        on, the loop buildable (fish gait freezable), a full K inside the
        step budget, and no recovery retreat in progress (the per-step
        path owns the halved-dt re-advance)."""
        K = self._scan_k
        if K < 1:
            return False
        s = self.sim
        if s.step + K > self.cfg.nsteps:
            return False  # the per-step tail keeps nsteps exact
        if (self._resilience is not None
                and self._resilience.dt_scale != 1.0):
            return False
        if self._megaloop is None:
            from cup3d_tpu_torch.parallel import topology as topo
            from cup3d_tpu_torch.sim import megaloop as ml

            # CUP3D_MESH_X asks for the x-slab sharded megaloop; its
            # builders return None where the run cannot slab (solver
            # stats, nx % D, thin slabs) and the solo loop runs
            mesh = topo.megaloop_mesh(s.device)
            fn = None
            if s.obstacles:
                if mesh is not None:
                    fn = ml.build_fish_megaloop_sharded(
                        s, s.obstacles[0], mesh)
                self._scan_mesh = mesh if fn is not None else None
                if fn is None:
                    fn = ml.build_fish_megaloop(s, s.obstacles[0])
                row_w = ml.FISH_ROW
            else:
                if mesh is not None:
                    fn = ml.build_tgv_megaloop_sharded(s, mesh)
                self._scan_mesh = mesh if fn is not None else None
                if fn is None:
                    fn = ml.build_tgv_megaloop(s)
                row_w = ml.TGV_ROW
            if fn is None:
                # gait not freezable after all: scan off for the run
                self._scan_k = 0
                return False
            self._megaloop = (fn, row_w)
        return True

    def _setup_operators(self) -> None:
        """Pipeline order is the reference's (main.cpp:15229-15246)."""
        s, cfg = self.sim, self.cfg
        with_bodies = bool(s.obstacles or cfg.resolved_factory_content())
        if with_bodies:
            from cup3d_tpu_torch.models import pipeline as body_ops
        pipe: List[ops.Operator] = []
        if with_bodies:
            pipe.append(body_ops.CreateObstacles(s))
        if cfg.implicitDiffusion:
            pipe.append(ops.AdvectionDiffusionImplicit(s))
        else:
            pipe.append(ops.AdvectionDiffusion(s))
        if cfg.uMax_forced > 0 and not cfg.bFixMassFlux:
            pipe.append(ops.ExternalForcing(s))
        if cfg.bFixMassFlux:
            pipe.append(ops.FixMassFlux(s))
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
                "obstacles": [type(ob).__name__ for ob in s.obstacles],
                "stream": self._pack_reader.snapshot(),
                "checkpointer": self._checkpointer.health(),
                "dumper": self._dumper.health()}

    # -- time stepping -----------------------------------------------------

    def _runaway(self, step: int, umax: float, **extra) -> None:
        """A NaN or runaway max|u|: trigger the flight recorder and raise
        the recoverable failure."""
        cfg = self.cfg
        self.sim.logger.flush()
        reason = ("nan-velocity" if not np.isfinite(umax)
                  else "runaway-velocity")
        extra = {"step": step, "umax": umax, **extra}
        self.flight.trigger(reason, extra=extra)
        raise SimulationFailure(
            reason, f"runaway velocity: max|u|={umax:.3g} > "
            f"uMax_allowed={cfg.uMax_allowed}", extra)

    def _dt_collapse(self, step: int, dt: float, umax: float,
                     **extra) -> None:
        extra = {"step": step, "dt": dt, "umax": umax, **extra}
        self.flight.trigger("dt-collapse", extra=extra)
        raise SimulationFailure(
            "dt-collapse", f"dt policy collapse: dt={dt:.3g}", extra)

    def calc_max_timestep(self):
        """CFL dt with diffusive cap and log ramp-up (main.cpp:15254-15305),
        from max|u| of the last consumed pack (or read now); scaled by a
        recovering engine; a NaN or runaway max|u| and a collapsed dt
        trigger the flight recorder and raise.  On the device dt chain it
        returns the dt as a device tensor (no read)."""
        from cup3d_tpu_torch.sim import dtpolicy

        s, cfg = self.sim, self.cfg
        if self._dt_chain:
            return self._calc_dt_device()
        h = s.grid.h
        if faults.fire("step.nan_velocity", s.step):
            self._umax_next = float("nan")
        if self._umax_next is not None:
            umax = self._umax_next
            if not cfg.pipelined:
                self._umax_next = None
            else:
                # pipelined: keep the latest consumed max|u| and FLOOR it
                # with the fresh host body speed (a gait spin-up outruns
                # the stale mirror)
                for ob in s.obstacles:
                    umax = max(umax, ob.max_body_speed(s.uinf))
        else:
            # the first step's read (the packs bring it afterwards)
            with sanctioned_transfer("umax-read"):
                umax = float(self._umax_device())
        self._last_umax = umax
        if not np.isfinite(umax) or umax > cfg.uMax_allowed:
            self._runaway(s.step, umax)
        if cfg.dt > 0:
            s.dt = cfg.dt
        else:
            prev_dt = s.dt
            if cfg.pipelined:
                # max|u| may be ~(1 + max_inflight) * read_every steps
                # stale: assume it has grown 1.5x since measured (the 1.03
                # growth bound below limits that to 1.03^12 ~ 1.43), so
                # the effective CFL never exceeds the configured one
                umax = 1.5 * umax
            s.dt = dtpolicy.dt_host(h, s.nu, umax, cfg.CFL, s.step,
                                    cfg.rampup, cfg.implicitDiffusion)
            if cfg.pipelined and prev_dt > 0:
                s.dt = min(s.dt, 1.03 * prev_dt)
            if cfg.tend > 0:
                s.dt = min(s.dt, cfg.tend - s.time)
        if self._resilience is not None:
            # the same float at scale 1.0: a fault-free armed run is
            # bitwise the CUP3D_RECOVER=0 one
            s.dt = self._resilience.scale_dt(s.dt)
        if faults.fire("dt.collapse", s.step):
            s.dt = float("nan")
        if not np.isfinite(s.dt) or s.dt <= 0:
            self._dt_collapse(s.step, s.dt, umax)
        # lambda = DLM/dt each step (main.cpp:15302-15303)
        if cfg.DLM > 0:
            s.lambda_penal = cfg.DLM / s.dt
        return s.dt

    def _calc_dt_device(self) -> torch.Tensor:
        """The device dt chain: the CFL dt from the previous step's DEVICE
        max|u|, exactly the non-pipelined one-step-lag policy (no margin,
        no growth bound), with no read.  The runaway abort checks the
        freshest consumed host mirror (an abort tolerates lag; the dt
        does not)."""
        from cup3d_tpu_torch.sim import dtpolicy

        s, cfg = self.sim, self.cfg
        if faults.fire("step.nan_velocity", s.step):
            self._umax_next = float("nan")
        um = self._umax_next
        if um is not None and (not np.isfinite(um) or um > cfg.uMax_allowed):
            self._runaway(s.step, um)
        if self._umax_dev is None:
            self._umax_dev = self._umax_device()
        if self._time_dev is None:
            from cup3d_tpu_torch.analysis.runtime import upload

            self._time_dev = upload(np.float64(s.time), s.dtype, s.device)
        h = float(s.grid.h)
        cfl = dtpolicy.ramped_cfl(cfg.CFL, s.step, cfg.rampup)
        dt = dtpolicy.dt_device(self._umax_dev, cfl, h, s.nu)
        eng = self._resilience
        if eng is not None and eng.dt_scale != 1.0:
            # retry halving on the device, floored as scale_dt floors
            dt = torch.maximum(dt * eng.dt_scale,
                               torch.clamp_max(dt, eng.dt_floor))
        self._last_umax = um
        return dt

    def _umax_device(self) -> torch.Tensor:
        """max|u + uinf| on the device, floored with max|udef| when bodies
        swim: at full gait amplitude the tail's deformation velocity
        reaches the advective limit a step before it shows in the fluid."""
        s = self.sim
        umax = diag.max_velocity(s.state["vel"], s.uinf_device())
        if s.obstacles:
            umax = torch.maximum(umax, torch.max(torch.abs(s.state["udef"])))
        return umax

    # -- output ------------------------------------------------------------

    def _maybe_dump_save(self) -> None:
        s = self.sim
        if s.cadence.dump_due(s.time, s.step):
            self.flush_packs()  # host mirrors current before output
            self.dump_fields()
        if s.cadence.save_due(s.step):
            self.flush_packs()
            with s.profiler("Checkpoint"):
                self._save_checkpoint_guarded()

    def _save_checkpoint_guarded(self) -> None:
        """Async checkpoint; under recovery a failed write falls back to
        one synchronous write, then drops and counts
        (stream/checkpoint.py ``save_guarded``)."""
        from cup3d_tpu_torch.stream.checkpoint import save_guarded

        save_guarded(self._checkpointer, self)

    def dump_fields(self) -> None:
        """Stage this step's dump fields (chi, velocity components, |omega|
        by the dump flags) for the sharded writer; no blocking read."""
        from functools import partial

        from cup3d_tpu_torch.io import dump as dmp

        s, cfg = self.sim, self.cfg
        fields = dmp.collect_dump_fields_device(
            cfg, s.state, partial(diag.vorticity_magnitude, s.grid))
        if fields:
            prefix = os.path.join(cfg.path4serialization,
                                  f"dump_{s.step:07d}")
            with s.profiler("Dump"):
                self._dumper.submit(prefix, s.time, s.grid, fields,
                                    step=s.step)

    def drain_streams(self) -> None:
        """Join all off-critical-path output (pending dumps and
        checkpoints): at the run's end, and before anything that must
        observe the files on disk."""
        from cup3d_tpu_torch.stream.checkpoint import drain

        drain(self._dumper, self._checkpointer, self)

    # -- the step ----------------------------------------------------------

    def advance(self, dt) -> None:
        """One step of the pipeline.  ``dt`` a host float, or the device
        dt of the dt chain."""
        s = self.sim
        t0 = obs_now()
        self._maybe_dump_save()
        if isinstance(dt, torch.Tensor):
            dt_dev = dt
        else:
            # one host->device upload: every operator gets the same tensor
            dt_dev = device_scalar(dt, s.dtype, s.device, tag="dt-upload")
        for op in self.pipeline:
            with s.profiler(op.name):
                op(dt_dev)
        self.end_step(dt, dt_dev, t0)

    def end_step(self, dt, dt_dev, t0: float) -> None:
        """The step's end after its operators ran: its QoI pack read now
        (non-pipelined) or handed to the stream, then the step counter and
        the host time advanced.  ``t0`` the host clock at the step's
        start (its ``wall_s``)."""
        s = self.sim
        with s.profiler("SyncQoI"):
            entry = self._emit_step_pack(dt_dev)
            entry["dt"] = dt if not isinstance(dt, torch.Tensor) else None
            entry["umax_dt"] = self._last_umax  # the max|u| dt came from
            if self.cfg.pipelined:
                entry["wall_s"] = obs_now() - t0
                self._pack_reader.emit(entry)
            else:
                self._consume_pack(entry)
                self.step_log[-1]["wall_s"] = obs_now() - t0
        s.step += 1
        if not isinstance(dt, torch.Tensor):
            s.time += dt

    def _emit_step_pack(self, dt_dev) -> dict:
        """Concatenate the step's device QoI (the body's rigid state,
        penalization force and surface forces, the solver stats) and max|u|
        for the next dt into ONE vector in the solver dtype; on the dt
        chain also the step's dt and the time after it."""
        s = self.sim
        parts = s.pending_parts
        s.pending_parts = []
        umax = self._umax_device()
        parts.append(("umax", umax.reshape(1)))
        if self._dt_chain:
            self._time_dev = self._time_dev + dt_dev
            self._umax_dev = umax
            parts.append(("dt", dt_dev.reshape(1)))
            parts.append(("time", self._time_dev.reshape(1)))
        return self._pack_reader.pack_parts(parts, s.dtype, time=s.time,
                                            step=s.step)

    def _consume_pack(self, entry: dict) -> None:
        """Apply one step's pack (read now unless the stream read it):
        refresh the host mirrors, log the forces, hand the solver stats to
        the flight recorder, and append the step's ``step_log`` row."""
        from cup3d_tpu_torch.models.base import (
            log_forces, store_force_qoi, unpack_forces)

        s = self.sim
        vals = entry.get("vals")
        if vals is None:
            # the non-pipelined step's one end-of-step read
            with sanctioned_transfer("qoi-read"):
                vals = entry["pack"].cpu().to(torch.float64).numpy()
        ob = s.obstacles[0] if s.obstacles else None
        step = int(entry["step"])
        row = {"step": step, "time": entry["time"], "dt": entry["dt"],
               "wall_s": entry.get("wall_s")}
        off = 0
        for name, size in entry["layout"]:
            seg = vals[off:off + size]
            off += size
            if name == "rigid":
                # pipelined stepping chains the rigid state on the device:
                # the trailing mirrors must not clobber it
                ob.apply_rigid_pack(seg, clear_dev=not self.cfg.pipelined)
            elif name == "penal":
                ob.penal_force = seg[:3]
                ob.penal_torque = seg[3:]
            elif name == "forces":
                store_force_qoi(ob, unpack_forces(seg))
                log_forces(s.logger, 0, entry["time"], ob)
            elif name == "umax":
                self._umax_next = float(seg[0])
                row["umax"] = float(seg[0])
            elif name == "dt":
                s.dt = row["dt"] = float(seg[0])
            elif name == "time":
                s.time = float(seg[0])
                row["time"] = s.time - row["dt"]
            elif name == "psolve":
                row["resid"], row["iters"] = float(seg[0]), float(seg[1])
                self._obs.note_solver(
                    step, row["iters"], row["resid"],
                    cap=getattr(s.poisson_solver, "maxiter", None))
            elif name == "scan":
                self._consume_scan_rows(entry, seg)
                return
        self.step_log.append(row)
        self.flight.record_step({"step": step, "t": row["time"],
                                 "dt": row["dt"], "umax": entry["umax_dt"],
                                 "wall_s": row["wall_s"],
                                 "solver": self._obs.last_solver})

    def advance_megaloop(self) -> None:
        """One K-step megaloop (sim/megaloop.py): the host computes the CFL
        ramp, runs the K steps from the device carry and emits the (K,
        ROW) QoI block into the stream.  Host mirrors, logs and failure
        detection are applied row by row at consumption, so the loop's
        visible sequence is the per-step one, K steps late."""
        from cup3d_tpu_torch.analysis.runtime import upload
        from cup3d_tpu_torch.sim import dtpolicy
        from cup3d_tpu_torch.sim import megaloop as ml

        s, cfg = self.sim, self.cfg
        K = self._scan_k
        fn, row_w = self._megaloop
        base_step = s.step
        t0 = obs_now()
        self._maybe_dump_save()
        if self._scan_carry is None:
            # carry (re)seed from the host mirrors: cold start, after a
            # rollback or a per-step tail, never per step.  Pipelined
            # per-step stepping leaves the mirrors trailing the device
            # rigid chain: drain the stream first, and end the chain (the
            # megaloop's rows refresh the mirrors from here on)
            self.flush_packs()
            for ob in s.obstacles:
                ob._dev_rigid = None
            with sanctioned_transfer("scan-carry-upload"):
                self._scan_carry = (ml.init_fish_carry(s, s.obstacles[0])
                                    if s.obstacles else ml.init_tgv_carry(s))
            if self._scan_mesh is not None:
                from cup3d_tpu_torch.parallel import topology as topo

                self._scan_carry = topo.shard_carry(self._scan_carry,
                                                    self._scan_mesh)
            self._umax_dev = self._time_dev = None
        # the ramp is a function of the step index: host, once a megaloop
        cfl = [dtpolicy.ramped_cfl(cfg.CFL, base_step + k, cfg.rampup)
               for k in range(K)]
        cfl_dev = upload(np.asarray(cfl, np.float64), s.dtype, s.device,
                         tag="scan-carry-upload")
        with s.profiler("Megaloop"):
            carry, rows = fn(self._scan_carry, cfl_dev)
        self._scan_carry = carry
        s.state["vel"] = carry["vel"]
        s.state["p"] = carry["p"]
        if "chi" in carry:
            s.state["chi"] = carry["chi"]
            s.state["udef"] = carry["udef"]
        with s.profiler("SyncQoI"):
            entry = self._pack_reader.pack_parts(
                [("scan", rows.reshape(K * row_w))], s.dtype, time=s.time,
                step=base_step, scan_k=K, dt=None,
                wall_s=(obs_now() - t0) / K)
            self._pack_reader.emit(entry)
        s.step += K

    def _consume_scan_rows(self, entry: dict, seg: np.ndarray) -> None:
        """Apply one megaloop's (K, ROW) block row by row: each row is one
        step's QoI, so the host mirrors, force logs, flight ring and
        failure detection see the per-step sequence, K steps late (row
        layouts: sim/megaloop.py FISH_ROW / TGV_ROW)."""
        from cup3d_tpu_torch.models.base import (
            log_forces, store_force_qoi, unpack_forces)
        from cup3d_tpu_torch.sim import megaloop as ml

        s, cfg = self.sim, self.cfg
        ob = s.obstacles[0] if s.obstacles else None
        rows = seg.reshape(-1, ml.FISH_ROW if ob is not None else ml.TGV_ROW)
        base_step = int(entry["step"])
        K = rows.shape[0]
        for k in range(K):
            row = rows[k]
            step_k = base_step + k
            if ob is not None:
                resid, iters = float(row[52]), float(row[53])
                umax, dt_k, t_k = (float(row[58]), float(row[59]),
                                   float(row[60]))
            else:
                resid, iters = float(row[0]), float(row[1])
                umax, dt_k, t_k = (float(row[2]), float(row[3]),
                                   float(row[4]))
            # the fault seams replay PER STEP here, on the host copies, so
            # detection -> trigger -> rollback runs as on a real
            # mid-megaloop failure
            if faults.fire("step.nan_velocity", step_k):
                umax = float("nan")
            if not np.isfinite(umax) or umax > cfg.uMax_allowed:
                self._runaway(step_k, umax, scan_k=K)
            if faults.fire("dt.collapse", step_k):
                dt_k = float("nan")
            if not np.isfinite(dt_k) or dt_k <= 0:
                self._dt_collapse(step_k, dt_k, umax, scan_k=K)
            if ob is not None:
                ob.apply_rigid_pack(row[0:29])
                ob.myFish.quaternion_internal = np.asarray(row[54:58],
                                                           np.float64)
                ob.penal_force = row[29:32]
                ob.penal_torque = row[32:35]
                store_force_qoi(ob, unpack_forces(row[35:52]))
                log_forces(s.logger, 0, t_k, ob)
                if ob.bFixFrameOfRef:
                    # torch-lint: allow(JX010, a host-mirror copy: transVel
                    # was just set from the row read above)
                    s.uinf = -np.asarray(ob.transVel, np.float64)
            log_row = {"step": step_k, "time": t_k - dt_k, "dt": dt_k,
                       "umax": umax, "wall_s": entry.get("wall_s"),
                       "scan": True}
            if iters >= 0:  # -1: the solver has no stats
                log_row["resid"], log_row["iters"] = resid, iters
                self._obs.note_solver(
                    step_k, iters, resid,
                    cap=getattr(s.poisson_solver, "maxiter", None))
            self.step_log.append(log_row)
            self.flight.record_step({"step": step_k, "t": t_k, "dt": dt_k,
                                     "umax": umax, "wall_s": 0.0,
                                     "scan": True})
            s.time = t_k
            s.dt = dt_k
            if cfg.DLM > 0:
                s.lambda_penal = cfg.DLM / dt_k
            self._umax_next = umax
            self._last_umax = umax

    def flush_packs(self) -> None:
        """Drain pending QoI packs so the host mirrors are current (run
        end, snapshots of the device chains, leaving the megaloop)."""
        self._pack_reader.flush()

    # -- resilience hooks (resilience/recovery.py driver contract) ---------

    def _resilience_restore(self, payload: dict) -> None:
        """In-place rollback to a ``build_payload``-shaped snapshot.  The
        fields are cloned on the way in, so the snapshot survives repeated
        restores; the obstacles are unpickled from their host state and
        their chi/udef rebuilt by CreateObstacles(0.0); the stream's
        packs from the abandoned trajectory are dropped unread."""
        import pickle

        s = self.sim
        s.state = {k: torch.clone(v) for k, v in payload["fields"].items()}
        s.time = float(payload["time"])
        s.step = int(payload["step"])
        s.dt = float(payload["dt"])
        s.uinf = np.asarray(payload["uinf"], np.float64)
        s.lambda_penal = float(payload["lambda_penal"])
        s.cadence.next_dump = float(payload["next_dump"])
        obstacles = payload.get("obstacles") or []
        if isinstance(obstacles, bytes):
            obstacles = pickle.loads(obstacles)
        s.obstacles = list(obstacles)
        for ob in s.obstacles:
            ob.sim = s
        s.pending_parts = []
        self._umax_next = None
        self._last_umax = None
        self._umax_dev = self._time_dev = None
        self._scan_carry = None
        self._pack_reader.abandon()
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
        iteration budget; the megaloop, built over the old solver, is
        rebuilt too.  The spectral solver is direct and ignores both."""
        from cup3d_tpu_torch.ops.poisson import make_poisson_solver

        s, cfg = self.sim, self.cfg
        s.poisson_solver = make_poisson_solver(
            s.grid, cfg.poissonSolver, s.dtype, tol_abs=cfg.poissonTol,
            tol_rel=cfg.poissonTolRel, maxiter=1000 * int(maxiter_mult),
            mean_constraint=cfg.bMeanConstraint, two_level=two_level)
        for i, op in enumerate(self.pipeline):
            if isinstance(op, ops.PressureProjection):
                self.pipeline[i] = ops.PressureProjection(s)
        self._megaloop = None
        self._scan_carry = None

    def simulate(self) -> None:
        """loop { calc_max_timestep; advance } (or, when ready, one
        megaloop) to ``tend`` or ``nsteps``, through the RecoveryEngine
        unless ``CUP3D_RECOVER=0``.  Only SimulationFailures of a
        recoverable reason are retried: any other exception (a kernel
        that fails to build or launch) ends the run."""
        s, cfg = self.sim, self.cfg
        eng = RecoveryEngine.install(self)
        try:
            while True:
                # the capture-window hook: for the megaloop a K boundary
                # (disarmed: one branch)
                self._obs_profile.on_step(s.step)
                try:
                    scan_now = self._scan_ready()
                    if scan_now or self._dt_chain:
                        if eng is not None and eng.snapshot_due(s.step):
                            # the snapshot pickles the host mirrors: they
                            # must equal the device chain's state first
                            self.flush_packs()
                    if not scan_now and self._scan_carry is not None:
                        # leaving the megaloop (the step-budget tail, a
                        # recovery retreat): the per-step path needs
                        # current mirrors, time and dt
                        self.flush_packs()
                        self._scan_carry = None
                except Exception as e:
                    # a flush consumes queued rows and can surface a
                    # failure: the same recovery path
                    if eng is not None and eng.handle_failure(e):
                        continue
                    raise
                if eng is not None and eng.on_loop_top():
                    continue  # rolled back: restart the iteration
                try:
                    if scan_now:
                        if cfg.verbose:
                            print(f"cup3d_tpu_torch: steps {s.step}.."
                                  f"{s.step + self._scan_k - 1} "
                                  f"(scan K={self._scan_k}), "
                                  f"time: {s.time:f}")
                        with self._obs.step(s.step, s.time, -1.0,
                                            scan=True):
                            self.advance_megaloop()
                    else:
                        dt = self.calc_max_timestep()
                        if cfg.verbose:
                            print(f"cup3d_tpu_torch: step: {s.step}, "
                                  f"time: {s.time:f}, dt: {dt:.3e}")
                        with self._obs.step(s.step, s.time, dt):
                            self.advance(dt)
                except Exception as e:
                    if eng is not None and eng.handle_failure(e):
                        continue  # rolled back: retry from the snapshot
                    raise
                done_t = cfg.tend > 0 and s.time >= cfg.tend - 1e-12
                done_n = cfg.nsteps > 0 and s.step >= cfg.nsteps
                if done_t or done_n:
                    break
            self.flush_packs()
            self.drain_streams()
            s.logger.flush()
        finally:
            if eng is not None:
                eng.uninstall()
