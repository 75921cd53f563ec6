"""Multi-tenant fleet server: job queue -> bucketed batches -> dispatch
(port of ``cup3d_tpu/fleet/server.py``).

The serving pipeline, one layer per concern:

1. **Queue**: ``submit(tenant, spec)`` validates a scenario spec and
   enqueues a :class:`FleetJob`; ``poll``/``cancel`` give tenants the
   usual lifecycle, ``drain`` runs the dispatch loop to completion.
2. **Capacity-bucketed assembly**: queued jobs group by their *static
   signature* (grid shape, dtype, solver, fish geometry, the forest's
   capacity and topology: everything that changes the lane step) plus a
   x1.25 ladder rung of their step budget, and each group is padded up
   the lane ladder, so mixed workloads share a small, bounded set of
   batched advances (an LRU of ``CUP3D_FLEET_BUCKETS``).
3. **Dispatch loop**: each batch advances all its lanes K steps per
   dispatch through the lane-batched advance (fleet/batch.py), emitting
   one (L, K, ROW) QoI block per dispatch into a stream/qoi.py
   :class:`QoIStream` (async copy, bounded in-flight window).
4. **Fan-out**: the stream consumer splits rows per lane, runs the
   per-lane failure detection (fleet/isolate.py), and appends each
   tenant's rows in step order into that job's QoI buffer: a
   deterministic, byte-stable ordering per tenant.

The job observatory: every job carries a monotonic span timeline
(``obs.trace.now()`` marks at the lifecycle seams: submitted -> queued ->
bucketed -> running -> dispatched -> fanout -> rollback*/retire ->
done/failed/cancelled), taken at seam transitions only: the dispatch
loop takes no clock mark per step and reads no device value outside the
QoI stream.  At a job's terminal transition the server observes the
queue-wait / execution / end-to-end durations into per-tenant,
per-bucket ``fleet.job_*_s`` histograms (p50/p95/p99), the exact phase
decomposition into ``fleet.latency_phase_s``, tracks the per-tenant SLO
window (target p99 + rolling breach window -> burn rate in
``health()``), notes the job in the flight recorders, and with tracing
on emits one ``kind="job"`` record and a pid-3 lane-occupancy span.

Continuous batching (``CUP3D_FLEET_CONTINUOUS``, on by default): at
K-boundaries a lane that retires is reseeded with a compatible queued
job (same static signature, so the cached advance is reused) by a
per-lane carry upload plus a gait-row swap that leaves every other lane
bitwise untouched.  ``serve(feed)`` accepts submits in flight with
admission control (per-tenant quota + queue-depth backpressure), the
``fifo``/``srb`` policies pick the reseed order, and lane occupancy
lands in the ``fleet.lane_occupancy`` gauge.
``CUP3D_FLEET_CONTINUOUS=0`` keeps the generation drain.

Durability (``CUP3D_FLEET_JOURNAL``, on by default): every lifecycle
transition and a periodic settled K-boundary carry snapshot per lane
land in a write-ahead journal (fleet/journal.py) under the workdir;
:meth:`FleetServer.recover` replays it: terminal jobs remembered, queued
jobs re-admitted, RUNNING jobs resumed from their snapshot in a batch
rebuilt at the recorded (cap, K), which reproduces the never-crashed
bytes.  fleet/migrate.py rides the same seams.

Env knobs, with the JAX package's defaults: ``CUP3D_FLEET_LANES`` (64),
``CUP3D_FLEET_BUCKETS`` (8),
``CUP3D_FLEET_SLO_P99`` (60 s) / ``CUP3D_FLEET_SLO_WINDOW`` (100),
``CUP3D_SNAP_EVERY`` (16) / ``CUP3D_MAX_RETRIES`` (4),
``CUP3D_FLEET_CONTINUOUS`` (1), ``CUP3D_FLEET_POLICY`` (fifo),
``CUP3D_FLEET_QUEUE_DEPTH`` (1024), ``CUP3D_FLEET_TENANT_QUOTA`` (0 =
unlimited), ``CUP3D_FLEET_PROVENANCE`` (1), ``CUP3D_FLEET_JOURNAL`` (1).
``CUP3D_FLEET_MESH=1`` (the fleet's lanes cut into shards across cards)
raises: ROADMAP A8b.

The compiled store (``CUP3D_AOT_STORE``, aot/store.py; off by default,
and then every seam returns what it returned before): a cold ``amr_tgv``
job's initial forest tables are built by the background compile service
(aot/compiler.py, in its helper process; put into the store) while the
job waits in ``compile_wait`` and the other jobs dispatch; its driver
then loads them.  A server on a warm store builds no table and runs no
nvcc (the ``tables`` and ``kernels`` records).  The lane-batched advance
is bound inline as without a store (a bind builds nothing; every bind
counts in ``fleet.executable_builds``).

``FleetServer(device=None)`` runs its lanes on the card (no card:
raise); ``device="cpu"`` runs them on the CPU, where every kernel takes
its plain version.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer
from cup3d_tpu_torch.config import SimulationConfig
from cup3d_tpu_torch.fleet import batch as FB
from cup3d_tpu_torch.fleet import isolate as ISO
from cup3d_tpu_torch.fleet.journal import JobJournal
from cup3d_tpu_torch.grid.bucket import count_capacity
from cup3d_tpu_torch.obs import federate as FEDERATE
from cup3d_tpu_torch.obs import flight as _flight
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.obs import trace as OT
from cup3d_tpu_torch.parallel import topology as topo
from cup3d_tpu_torch.resilience import faults
from cup3d_tpu_torch.sim.dtpolicy import ramped_cfl
from cup3d_tpu_torch.sim.megaloop import DEFAULT_SCAN_K, FISH_ROW, TGV_ROW
from cup3d_tpu_torch.sim.simulation import resolve_device, resolve_scan_k
from cup3d_tpu_torch.stream.qoi import QoIStream

# job lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
#: checkpointed off this server by fleet/migrate.py; the
#: receiving server finishes the job under the same id
MIGRATED = "migrated"

#: terminal statuses (the journal replays these verbatim; mirrored as
#: literals in fleet/journal.py TERMINAL_STATUSES)
TERMINALS = (DONE, FAILED, CANCELLED, MIGRATED)

#: lane-count ladder base: fleet batches start amortizing at 2 lanes
LANE_LADDER_BASE = 2

#: scheduler policies: FIFO (submit order) and shortest-remaining-budget
#: (smallest nsteps first, cutting p99 under skewed job lengths)
POLICIES = ("fifo", "srb")

class FleetAdmissionError(RuntimeError):
    """submit() rejected by admission control: the queue is at its
    backpressure depth, or the tenant is at its live-job quota.  The
    ``reason`` ("queue-full" / "quota") matches the
    ``fleet.admission_rejects`` counter label and the backpressure
    field in ``health()["admission"]``."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        # a malformed knob falls back to the default (health()["knobs"])
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        # a malformed knob falls back to the default (health()["slo"])
        return default


@dataclass
class FleetJob:
    """One tenant scenario: spec in, per-step QoI rows + final lane
    state out."""

    job_id: str
    tenant: str
    spec: dict
    status: str = QUEUED
    nsteps: int = 0
    steps_done: int = 0
    time: float = 0.0
    error: Optional[str] = None
    rows: Optional[np.ndarray] = None  # (nsteps, ROW) float64, step order
    lane: int = -1
    batch: Optional["FleetBatch"] = None
    cfg: Optional[SimulationConfig] = None
    #: bucket-signature label for the SLO histograms (set at assembly)
    sig_label: str = ""
    #: the monotonic span timeline: (event, obs.trace.now()) appends at
    #: lifecycle seams — never inside the per-step hot loop
    events: List[Tuple[str, float]] = field(default_factory=list)
    _seen: Set[str] = field(default_factory=set, repr=False)
    #: _job_terminal ran for this job (idempotence guard:
    #: cancel of a mid-migration or journal-replayed job must resolve
    #: to exactly one terminal, never a double fold into the SLO state)
    _terminal_done: bool = field(default=False, repr=False)

    def mark(self, event: str, once: bool = False,
             collapse: bool = False) -> None:
        """Append one lifecycle event at the current monotonic time.
        ``once`` drops repeats (dispatched/fanout fire per dispatch
        otherwise); ``collapse`` drops a repeat only when it would
        IMMEDIATELY follow itself (compile_wait/reseed_wait re-fire
        every scheduling pass while the job stays parked — one event
        per parked stretch is the provenance-correct timeline).  The
        timestamp is clamped non-decreasing: marks may arrive from the
        dispatch thread and the QoI consumer thread, and the timeline
        is validated monotone (obs/trace.py)."""
        if once and event in self._seen:
            return
        if collapse and self.events and self.events[-1][0] == event:
            return
        self._seen.add(event)
        t = OT.now()
        if self.events and t < self.events[-1][1]:
            t = self.events[-1][1]
        self.events.append((event, t))

    def event_time(self, event: str) -> Optional[float]:
        """First occurrence time of ``event`` (None when absent)."""
        for n, t in self.events:
            if n == event:
                return t
        return None

    def durations(self) -> Dict[str, float]:
        """The SLO-relevant durations derivable from the timeline:
        queue-wait (queued -> running), execution (running -> terminal)
        and end-to-end (submitted -> terminal) — all on the monotonic
        clock, present only when both endpoints were marked.

        CAVEAT: ``queue_wait_s`` is kept for schema
        compatibility, but it CONFLATES two
        remediable-by-different-means waits — capacity wait (fix:
        scale out) and background compile wait (fix: warm the store).
        The split rides alongside as ``capacity_wait_s`` +
        ``compile_wait_s`` (from :meth:`phases`); prefer those and the
        full :meth:`phases` decomposition for attribution."""
        out: Dict[str, float] = {}
        if not self.events:
            return out
        t_end = self.events[-1][1]
        t_q = self.event_time("queued")
        t_run = self.event_time("running")
        t_sub = self.event_time("submitted")
        if t_q is not None and t_run is not None:
            out["queue_wait_s"] = t_run - t_q
            ph = self.phases()
            out["capacity_wait_s"] = ph.get("capacity_wait", 0.0)
            out["compile_wait_s"] = ph.get("compile_wait", 0.0)
        if t_run is not None:
            out["exec_s"] = t_end - t_run
        if t_sub is not None:
            out["e2e_s"] = t_end - t_sub
        return out

    def phases(self) -> Dict[str, float]:
        """Exact latency-provenance decomposition of the timeline
        (:func:`cup3d_tpu_torch.obs.trace.phase_decomposition`): exclusive
        per-phase seconds that sum to end-to-end by construction."""
        return OT.phase_decomposition(self.events)

    def record(self, step: int, row: np.ndarray, t: float) -> None:
        """Append (or re-apply, after a lane rollback replay) the QoI
        row for ``step``; keyed by step index, so the final buffer is a
        clean, gap-free, byte-stable sequence per tenant."""
        if 0 <= step < self.nsteps:
            self.rows[step] = row
            self.steps_done = max(self.steps_done, step + 1)
            self.time = t

    def summary(self) -> dict:
        return {
            "job_id": self.job_id,
            "tenant": self.tenant,
            "status": self.status,
            "steps_done": int(self.steps_done),
            "nsteps": int(self.nsteps),
            "time": float(self.time),
            "error": self.error,
        }

    def qoi_bytes(self) -> bytes:
        """The tenant's QoI block as bytes (ordering-stability tests)."""
        return b"" if self.rows is None else self.rows.tobytes()


def _job_config(spec: dict, workdir: str) -> Tuple[str, SimulationConfig]:
    """Scenario spec -> (kind, SimulationConfig) for one pipelined
    lane.  Only scan-eligible configs are expressible: free dt,
    step-budget termination, <= 1 frozen-gait obstacle; "amr_tgv"
    lanes run the bucketed block-forest body on a topology frozen
    after init (see _AMRLaneDriver)."""
    kind = str(spec.get("kind", "fish"))
    nsteps = int(spec.get("nsteps", 0))
    if nsteps <= 0:
        raise ValueError("fleet scenario needs nsteps > 0")
    n = int(spec.get("n", 32))
    common = dict(
        nsteps=nsteps, tend=0.0,
        CFL=float(spec.get("cfl", 0.3)),
        rampup=int(spec.get("rampup", 0)),
        dtype=str(spec.get("dtype", "float32")),
        pipelined=True, verbose=False, freqDiagnostics=0,
        path4serialization=workdir,
    )
    uniform = dict(
        bpdx=1, bpdy=1, bpdz=1, block_size=n,
        levelMax=1, levelStart=0,
    )
    if kind == "tgv":
        cfg = SimulationConfig(
            extent=float(spec.get("extent", 2.0 * np.pi)),
            nu=float(spec.get("nu", 0.02)),
            initCond=str(spec.get("initCond", "taylorGreen")),
            **uniform, **common,
        )
    elif kind == "amr_tgv":
        bpd = int(spec.get("bpd", 2))
        lm = int(spec.get("levelMax", 2))
        cfg = SimulationConfig(
            bpdx=bpd, bpdy=bpd, bpdz=bpd,
            levelMax=lm, levelStart=int(spec.get("levelStart", lm - 1)),
            Rtol=float(spec.get("rtol", 1e9)),
            Ctol=float(spec.get("ctol", -1.0)),
            extent=float(spec.get("extent", 2.0 * np.pi)),
            nu=float(spec.get("nu", 0.02)),
            initCond=str(spec.get("initCond", "taylorGreen")),
            step_2nd_start=int(spec.get("step_2nd_start", 0)),
            **common,
        )
    elif kind == "fish":
        L = float(spec.get("L", 0.3))
        T = float(spec.get("T", 1.0))
        xpos = float(spec.get("xpos", 0.5))
        factory = f"stefanfish L={L} T={T} xpos={xpos}"
        for k in ("ypos", "zpos"):
            if k in spec:
                factory += f" {k}={float(spec[k])}"
        cfg = SimulationConfig(
            extent=float(spec.get("extent", 1.0)),
            nu=float(spec.get("nu", 1e-4)),
            factory_content=factory,
            **uniform, **common,
        )
    else:
        raise ValueError(f"unknown fleet scenario kind {kind!r}")
    return kind, cfg


class _AMRLaneDriver:
    """Adapter giving an obstacle-free AMRSimulation the driver surface
    assemble()/FleetBatch expect (.sim/.cfg/init/_megaloop_eligible).
    init runs the usual 3*levelMax adaptation rounds, then FREEZES the
    topology: the fleet scan body never regrids, so every lane keeps
    the (capacity, topology-signature) it bucketed on for the whole
    drain — the zero-retrace contract inside a bucket."""

    def __init__(self, sim):
        self.sim = sim
        self.cfg = sim.cfg

    def init(self):
        self.sim.init()
        self.sim.adapt_enabled = False

    def _megaloop_eligible(self) -> bool:
        s, cfg = self.sim, self.cfg
        return (not s.obstacles and s.forest is None and s._bucketing
                and not cfg.implicitDiffusion and not cfg.bFixMassFlux
                and cfg.uMax_forced <= 0)


def _dtype_name(dtype) -> str:
    """The numpy name of a torch dtype ("float32"), the JAX package's
    signature spelling."""
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _static_signature(drv, kind: str) -> tuple:
    """Everything that changes the compiled lane body: jobs sharing a
    signature (and a lane/step rung) share one executable.  Adaptive
    tenants key on (capacity, octree topology-signature): equal keys
    <=> the vmapped bucketed step's compiled shapes AND its frozen
    padded tables match, so lanes can share the closure-captured
    geometry bundle without retracing."""
    s = drv.sim
    if kind == "amr_tgv":
        return (
            kind,
            int(s.grid.bs),
            int(s._cap),
            s.grid.signature,
            _dtype_name(s.dtype),
            float(s.nu),
            tuple(float(v) for v in s.grid.extent),
            int(drv.cfg.step_2nd_start),
        )
    sig = (
        kind,
        tuple(int(v) for v in np.asarray(s.grid.shape)),
        _dtype_name(s.dtype),
        float(s.grid.h),
        float(s.nu),
        type(s.poisson_solver).__name__,
    )
    if s.obstacles:
        ob = s.obstacles[0]
        sig += (
            float(ob.length),
            bool(ob.bFixFrameOfRef),
            tuple(int(v) for v in ob._window_shape),
            # the host attributes the device masks are uploaded from
            tuple(np.asarray(ob.bForcedInSimFrame, bool).astype(float)
                  .tolist()),
            tuple(np.asarray(ob.bBlockRotation, bool).astype(float)
                  .tolist()),
            float(drv.cfg.DLM),
            float(drv.cfg.lambda_penalization),
        )
    return sig


def _lane_payload(kind: str, drv, label: str):
    """One lane's device payload from an initialized driver: the solo
    carry plus the frozen gait (fish only) — shared by first assembly
    (stacked into the batched carry) and reseeding (per-lane upload)."""
    if kind == "fish":
        ob = drv.sim.obstacles[0]
        from cup3d_tpu_torch.models.fish.device_midline import freeze_gait

        gait = freeze_gait(ob, drv.sim.time, drv.sim.dtype, drv.sim.device)
        if gait is None:
            raise ValueError(f"{label}: gait not freezable for fleet")
        return FB.init_fish_carry(drv.sim, ob), gait
    if kind == "amr_tgv":
        return FB.init_amr_carry(drv.sim), None
    return FB.init_tgv_carry(drv.sim), None


class FleetBatch:
    """B lanes sharing one compiled executable: the batched carry, the
    host step/budget mirrors, the lane guard, and the QoI stream."""

    def __init__(self, server: "FleetServer", batch_id: int, kind: str,
                 jobs: List[FleetJob], drivers: list, K: int, cap: int):
        self.server = server
        self.batch_id = batch_id
        #: cross-restart-unique batch id for journal place/snapshot
        #: records — a restarted server reuses small batch_ids, and a
        #: replayed record must never alias a live batch's lanes
        self.uid = f"{os.getpid():x}.{batch_id}"
        self.kind = kind
        self.K = int(K)
        self.B = int(cap)
        self.row_w = FISH_ROW if kind == "fish" else TGV_ROW
        # row offsets of the per-lane (umax, dt, time) chain
        self.off_umax = self.row_w - 3
        self.off_dt = self.row_w - 2
        self.off_time = self.row_w - 1

        template = drivers[0]
        self.template = template
        s = template.sim
        self.np_dtype = np.dtype(_dtype_name(s.dtype))

        # lane assembly: per-job solo carries + frozen gaits, padded up
        # the lane ladder with inert clones of lane 0 (left = 0 from
        # step 0, so the gated body freezes them; they are never
        # consumed because jobs[lane] is None there)
        carries, gaits, targets = [], [], []
        for job, drv in zip(jobs, drivers):
            carry, gait = _lane_payload(kind, drv, job.job_id)
            carries.append(carry)
            if gait is not None:
                gaits.append(gait)
            targets.append(job.nsteps)
        while len(carries) < self.B:
            carries.append(carries[0])
            targets.append(0)
            if gaits:
                gaits.append(gaits[0])
        self.jobs: List[Optional[FleetJob]] = list(jobs) + [None] * (
            self.B - len(jobs))
        for lane, job in enumerate(jobs):
            job.lane = lane
            job.batch = self
            job.status = RUNNING
            job.mark("running")
            job.rows = np.zeros((job.nsteps, self.row_w), np.float64)
            # torch-lint: allow(JX013, the journal append is a host file
            # write: no device work)
            server._journal(
                "place", job_id=job.job_id, batch_uid=self.uid,
                lane=lane, cap=self.B, K=self.K, kind=kind)
        #: lanes whose job has not had its first dispatch marked yet —
        #: steady-state dispatch() pays one empty-set truth test
        self._undispatched: Set[int] = {
            lane for lane, j in enumerate(self.jobs) if j is not None}

        self.carry = FB.stack_carries(carries, targets)
        self.gaits = (FB.stack_gaits(gaits, s.dtype, s.device) if gaits
                      else None)
        ob = s.obstacles[0] if kind == "fish" else None
        #: the static bucket signature — reseed compatibility is THIS
        #: (the step-budget rung only shapes first assembly; it does
        #: not enter the executable key, so cross-rung reseeds still
        #: hit the compiled-advance cache)
        self.sig = _static_signature(template, kind)
        self.advance = server.executable(
            self.sig, s, ob, self.B, self.K, kind=kind)

        self.step_h = np.zeros(self.B, np.int64)
        self.left_h = np.asarray(targets, np.int64)
        self.snap_dispatches = max(1, server.snap_steps // self.K)
        self.guard = ISO.LaneGuard(self.B, server.max_retries)
        self.guard.snapshot(self.carry, self.step_h, self.left_h)
        self._since_snap = 0
        self.dispatches = 0
        # lane-occupancy accounting: busy = budget-gated lane-steps
        # actually advanced, total = B*K per dispatch (frozen and
        # padding lanes count against the denominator — that is the
        # waste continuous batching reclaims)
        self.busy_steps = 0
        self.total_steps = 0
        #: monotonic time each idle lane last went free (padding lanes
        #: at construction, retired lanes at their terminal mark) —
        #: the start of the pid-3 idle span the next reseed closes
        self._lane_free_since: Dict[int, float] = {
            lane: OT.now() for lane in range(self.B)
            if self.jobs[lane] is None}
        self.stream = QoIStream(
            self._consume, read_every=1, max_inflight=2,
            name=f"fleet-b{batch_id}")
        M.counter("fleet.batches").inc()
        M.counter("fleet.lanes", kind=kind).inc(len(jobs))

    # -- dispatch ----------------------------------------------------------

    def active(self) -> bool:
        return bool(
            (self.left_h > 0).any()
            or self.stream
            or any(j is not None and j.status == RUNNING for j in self.jobs)
        )

    def _cfl_block(self) -> np.ndarray:
        """Host-precomputed per-lane CFL ramp for the next K steps —
        the same dtpolicy.ramped_cfl chain the solo megaloop feeds, per
        lane (host fan-out loop: no device work here)."""
        cfl = np.empty((self.B, self.K), self.np_dtype)
        for lane in range(self.B):
            job = self.jobs[lane]
            base = float(job.cfg.CFL) if job is not None else 0.1
            ramp = int(job.cfg.rampup) if job is not None else 0
            step0 = int(self.step_h[lane])
            for k in range(self.K):
                cfl[lane, k] = ramped_cfl(base, step0 + k, ramp)
        return cfl

    def dispatch(self) -> None:
        """One batched advance: every live lane moves K steps, one QoI
        block goes onto the stream."""
        valid = np.minimum(self.left_h, self.K).astype(np.int64)
        if self._undispatched:
            for lane in sorted(self._undispatched):
                if valid[lane] > 0:
                    job = self.jobs[lane]
                    if job is not None:
                        job.mark("dispatched", once=True)
                    self._undispatched.discard(lane)
        carry, rows = self.advance(self.carry, self._cfl_block(), self.gaits)
        self.carry = carry
        entry = self.stream.pack_parts(
            [("scan", rows.reshape(self.B * self.K * self.row_w))],
            self.template.sim.dtype,
            step0=self.step_h.copy(), valid=valid,
            epochs=self.guard.epochs.copy(),
            step=int(self.dispatches),
        )
        self.stream.emit(entry)
        self.step_h += valid
        self.left_h -= valid
        self.dispatches += 1
        self._since_snap += 1
        busy = int(valid.sum())
        self.busy_steps += busy
        self.total_steps += self.B * self.K
        M.counter("fleet.dispatches").inc()
        M.counter("fleet.busy_lane_steps").inc(busy)
        M.counter("fleet.total_lane_steps").inc(self.B * self.K)
        # the federation snapshot refresh: one bool test when it is
        # not armed
        FEDERATE.FED.on_k_boundary()
        if self._since_snap >= self.snap_dispatches:
            self.settle()
            self.guard.snapshot(self.carry, self.step_h, self.left_h)
            self.journal_snapshots()
            self._since_snap = 0
        # the crash drill's kill switch: hard process death
        # at a K-boundary, armed with the dispatch count in the step
        # slot — recovery may lose at most the work since the last
        # journaled snapshot, never a job
        if faults.fire("server.crash", step=int(self.dispatches)):
            os._exit(23)

    def settle(self) -> None:
        """Drain the stream: every emitted row is consumed (and every
        lane fault handled) before the caller proceeds.  Required
        before snapshots — only a validated state may become a rollback
        target."""
        self.stream.flush()

    def tick(self) -> None:
        """One dispatch-loop turn: advance if any lane has budget, else
        drain the stream (which may resurrect budget via rollback)."""
        if (self.left_h > 0).any():
            self.dispatch()
        else:
            self.settle()

    # -- fan-out + isolation ----------------------------------------------

    def _consume(self, entry: dict) -> None:
        vals = entry.get("vals")
        if vals is None:
            with sanctioned_transfer("fleet-read"):
                vals = (entry["pack"].detach().cpu().numpy()
                        .astype(np.float64))
        rows = np.asarray(vals, np.float64).reshape(
            self.B, self.K, self.row_w)
        step0, valid = entry["step0"], entry["valid"]
        epochs = entry["epochs"]
        for lane in range(self.B):
            job = self.jobs[lane]
            if job is None or job.status != RUNNING:
                continue
            if epochs[lane] != self.guard.epochs[lane]:
                continue  # stale rows from an abandoned lane trajectory
            if valid[lane] > 0:
                job.mark("fanout", once=True)
            for k in range(int(valid[lane])):
                step = int(step0[lane]) + k
                row = rows[lane, k]
                reason = self.guard.check_row(
                    lane, step, float(row[self.off_umax]),
                    float(row[self.off_dt]))
                if reason is not None:
                    self.lane_fault(lane, step, reason)
                    break
                self.guard.note_progress(lane, step)
                job.record(step, row, float(row[self.off_time]))
                if job.steps_done >= job.nsteps:
                    self.retire(lane, DONE, "done")
                    break

    def lane_fault(self, lane: int, step: int, reason: str) -> None:
        """Contain one lane's failure: rollback with dt-halving while
        the retry budget lasts, retire the lane after."""
        M.counter("fleet.lane_faults", reason=reason).inc()
        if self.guard.exhausted(lane):
            self.carry = self.guard.give_up(self.carry, lane, reason)
            self.left_h[lane] = 0
            job = self.jobs[lane]
            job.error = reason
            self.retire(lane, FAILED, "failed")
            return
        job = self.jobs[lane]
        if job is not None:
            job.mark("rollback")
        self.carry, snap_step, snap_left = self.guard.rollback(
            self.carry, lane, step, reason)
        self.step_h[lane] = snap_step
        self.left_h[lane] = snap_left

    def retire(self, lane: int, status: str, reason: str) -> None:
        job = self.jobs[lane]
        if job is None or job.status not in (RUNNING,):
            return
        job.status = status
        job.mark("retire")
        job.mark(status)
        M.counter("fleet.lane_retires", reason=reason).inc()
        self.server.update_lane_gauge()
        # the lane goes idle exactly where the job's occupancy span
        # ends (the terminal mark), so the idle span a later reseed
        # emits touches it without overlapping
        self._lane_free_since[lane] = job.events[-1][1]
        self.server._job_terminal(job, batch=self, lane=lane)

    def cancel_lane(self, lane: int) -> None:
        """Freeze the lane (bits of every other lane untouched) and
        drop its in-flight rows."""
        self.carry = ISO.retire_lanes(
            self.carry, np.arange(self.B) == lane)
        self.left_h[lane] = 0
        self.guard.epochs[lane] += 1
        self.retire(lane, CANCELLED, "cancelled")

    def free_lanes(self) -> List[int]:
        """Lanes holding no RUNNING job — padding or retired — i.e.
        reseed targets for the continuous scheduler.  Callers settle
        the stream first so pending retirements are visible."""
        return [lane for lane in range(self.B)
                if self.jobs[lane] is None
                or self.jobs[lane].status != RUNNING]

    def reseed_lane(self, lane: int, job: FleetJob, drv) -> None:
        """Splice a queued job into a freed lane at a K-boundary: a
        per-lane carry upload + gait-row swap (fleet/batch.py), fresh
        host mirrors, and a guard reset (epoch bump + full retry budget
        + snapshot-row refresh, fleet/isolate.py).  Every other lane's
        carry bits are untouched, and the previous occupant's in-flight
        rows drop on the epoch bump."""
        solo, gait = _lane_payload(self.kind, drv, job.job_id)
        self.carry = FB.reseed_lane_carry(
            self.carry, lane, solo, job.nsteps)
        if self.gaits is not None:
            self.gaits = FB.reseed_lane_gaits(self.gaits, lane, gait)
        self.step_h[lane] = 0
        self.left_h[lane] = job.nsteps
        self.guard.reseed(self.carry, lane, job.nsteps)
        self.jobs[lane] = job
        job.lane = lane
        job.batch = self
        job.status = RUNNING
        job.mark("reseeded")
        job.mark("running")
        job.rows = np.zeros((job.nsteps, self.row_w), np.float64)
        self._undispatched.add(lane)
        self.server._journal(
            "place", job_id=job.job_id, batch_uid=self.uid,
            lane=lane, cap=self.B, K=self.K, kind=self.kind)
        M.counter("fleet.reseeds", kind=self.kind).inc()
        M.counter("fleet.lanes", kind=self.kind).inc()
        self.server.update_lane_gauge()
        t_free = self._lane_free_since.pop(lane, None)
        sink = OT.TRACE
        if sink.enabled and t_free is not None:
            t_run = job.event_time("running")
            if t_run is not None and t_run > t_free:
                sink.lane_span(
                    FB.lane_track_id(self.batch_id, lane), "idle",
                    t_free, t_run - t_free, args={"job_id": "<idle>"})

    # -- durability ---------------------------------------------

    def journal_snapshots(self) -> None:
        """Journal one carry snapshot per RUNNING lane.  Called at the
        same settled K-boundary as the rollback snapshot, so the
        recorded state is always validated: every row up to it consumed
        clean, ``steps_done == step_h`` per lane.  The recorded (cap,
        K) let recovery rebuild the SAME compiled executable, which is
        what makes a resumed trajectory bitwise."""
        if self.server.journal is None:
            return
        for lane in range(self.B):
            job = self.jobs[lane]
            if job is None or job.status != RUNNING:
                continue
            steps = int(job.steps_done)
            self.server._journal(
                "snapshot", job_id=job.job_id, batch_uid=self.uid,
                cap=self.B, K=self.K, kind=self.kind, lane=lane,
                step=int(self.step_h[lane]),
                left=int(self.left_h[lane]),
                steps_done=steps, time=float(job.time),
                rows=job.rows[:steps].copy(),
                carry=FB.lane_carry_host(self.carry, lane))

    def resume_lane(self, lane: int, job: FleetJob, snap: dict) -> None:
        """Upload one journaled/migrated lane checkpoint into ``lane``:
        the resume splice.  The batch was just built with the
        checkpoint's recorded (cap, K) and ``job`` occupies ``lane``
        from first assembly (RUNNING, zeroed rows); this re-enters the
        checkpointed carry through the same per-lane upload as a
        reseed, restores the recorded rows, and points the guard's host
        mirrors at the resumed position."""
        solo = {k: np.asarray(v) for k, v in snap["carry"].items()}
        step, left = int(snap["step"]), int(snap["left"])
        self.carry = FB.reseed_lane_carry(
            self.carry, lane, solo, left)
        self.step_h[lane] = step
        self.left_h[lane] = left
        self.guard.resume(self.carry, lane, step, left)
        rows = snap.get("rows")
        if rows is not None and len(rows):
            rows = np.asarray(rows, np.float64)
            job.rows[:rows.shape[0]] = rows
        job.steps_done = int(snap.get("steps_done", step))
        job.time = float(snap.get("time", 0.0))
        M.counter("fleet.lane_resumes", kind=self.kind).inc()

    def release_for_migration(self, lane: int) -> dict:
        """Checkpoint one RUNNING lane off this batch for live
        migration (fleet/migrate.py): settle so the lane state is
        validated, host-serialize the carry + rows, then freeze the
        lane and retire its job MIGRATED.  Every other lane's bits are
        untouched (the same lane-wise selects as a cancel).  The
        returned payload is exactly a journal snapshot view, so the
        receiving server resumes it through ``resume_lane``."""
        self.settle()
        job = self.jobs[lane]
        if job is None or job.status != RUNNING:
            raise ValueError(f"lane {lane} holds no RUNNING job")
        steps = int(job.steps_done)
        ckpt = {
            "job_id": job.job_id, "tenant": job.tenant,
            "spec": dict(job.spec), "nsteps": int(job.nsteps),
            "kind": self.kind, "cap": self.B, "K": self.K,
            "step": int(self.step_h[lane]),
            "left": int(self.left_h[lane]),
            "steps_done": steps, "time": float(job.time),
            "rows": job.rows[:steps].copy(),
            "carry": FB.lane_carry_host(self.carry, lane),
        }
        self.carry = ISO.retire_lanes(
            self.carry, np.arange(self.B) == lane)
        self.left_h[lane] = 0
        self.guard.epochs[lane] += 1
        self.retire(lane, MIGRATED, "migrated")
        return ckpt

    def lane_state(self, lane: int) -> Dict[str, np.ndarray]:
        """Host copies of one lane's carry leaves (tests, summaries)."""
        with sanctioned_transfer("fleet-read"):
            return {k: v[lane].detach().cpu().numpy()
                    for k, v in self.carry.items()}

    def running_lanes(self) -> int:
        return sum(
            1 for j in self.jobs if j is not None and j.status == RUNNING)


#: weakrefs of live servers, for the obs /health payload
_LIVE: List["weakref.ReferenceType[FleetServer]"] = []


def live_servers() -> List["FleetServer"]:
    out = []
    for ref in list(_LIVE):
        srv = ref()
        if srv is None:
            _LIVE.remove(ref)
        else:
            out.append(srv)
    return out


class FleetServer:
    """The multi-tenant front door: queue, assembly, dispatch, fan-out."""

    #: SLO error budget matching a p99 target: 1% of jobs may breach
    SLO_ERROR_BUDGET = 0.01

    def __init__(self, max_lanes: Optional[int] = None,
                 max_buckets: Optional[int] = None,
                 snap_every: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 workdir: Optional[str] = None,
                 slo_p99_s: Optional[float] = None,
                 slo_window: Optional[int] = None,
                 continuous: Optional[bool] = None,
                 policy: Optional[str] = None,
                 max_queue_depth: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 provenance: Optional[bool] = None,
                 journal: Optional[bool] = None,
                 device=None):
        # the chaos sites (server.crash, journal.write_fail, ...) are
        # armable from the environment in drill subprocesses
        # (tools/chaosdrill.py); the solo path loads CUP3D_FAULT at
        # RecoveryEngine.install, the fleet path loads it here
        faults.load_env()
        #: the lanes' device: the card unless the caller asks for the CPU
        #: (device="cpu", as the tests do)
        self.device = resolve_device(device)
        self.max_lanes = int(
            max_lanes if max_lanes is not None
            else _env_int("CUP3D_FLEET_LANES", 64))
        self.max_buckets = int(
            max_buckets if max_buckets is not None
            else _env_int("CUP3D_FLEET_BUCKETS", 8))
        snap_steps = (
            snap_every if snap_every is not None
            else _env_int("CUP3D_SNAP_EVERY", 16))
        self.snap_steps = max(1, int(snap_steps))
        self.max_retries = max_retries
        self.workdir = workdir or tempfile.mkdtemp(prefix="cup3d-fleet-")
        self._jobs: "OrderedDict[str, FleetJob]" = OrderedDict()
        self._execs: "OrderedDict[tuple, object]" = OrderedDict()
        self.batches: List[FleetBatch] = []
        self._next_job = 0
        self._next_batch = 0
        # the fleet's lanes cut across cards (CUP3D_FLEET_MESH=1) raise:
        # ROADMAP A8b.  On one card the batch is one lane axis.
        FB.fleet_mesh()
        # completion SLO: target p99 end-to-end seconds + rolling
        # per-tenant breach window (health()["slo"], fleet slo CLI)
        self.slo_p99_s = float(
            slo_p99_s if slo_p99_s is not None
            else _env_float("CUP3D_FLEET_SLO_P99", 60.0))
        self.slo_window = max(1, int(
            slo_window if slo_window is not None
            else _env_int("CUP3D_FLEET_SLO_WINDOW", 100)))
        self._slo_windows: Dict[str, deque] = {}
        # continuous-batching knobs + scheduler state
        self.continuous = bool(
            continuous if continuous is not None
            else _env_int("CUP3D_FLEET_CONTINUOUS", 1))
        self.policy = str(
            policy if policy is not None
            else os.environ.get("CUP3D_FLEET_POLICY", "fifo"))
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown scheduler policy {self.policy!r} "
                f"(expected one of {POLICIES})")
        self.max_queue_depth = max(1, int(
            max_queue_depth if max_queue_depth is not None
            else _env_int("CUP3D_FLEET_QUEUE_DEPTH", 1024)))
        self.tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else _env_int("CUP3D_FLEET_TENANT_QUOTA", 0))
        self.reseeds = 0
        self.last_occupancy: Optional[float] = None
        #: prepared-but-waiting queued jobs: job_id -> (kind, driver,
        #: sig, bucket key) — a job waiting for a compatible lane is
        #: not re-inited at every K-boundary
        self._prepared: Dict[str, tuple] = {}
        #: the background compile service (aot/compiler.py), created
        #: lazily iff the compiled store is active; with CUP3D_AOT_STORE
        #: unset the whole path is inert
        self._aot_service = None
        #: amr_tgv job id -> its initial forest's tables key and config
        self._tables_keys: Dict[str, tuple] = {}
        #: tables build key -> whether it was ready, read once a
        #: scheduling pass (``_tables_wait``)
        self._pass_ready: Dict[tuple, bool] = {}
        # latency provenance: per-job phase decomposition,
        # fleet.latency_phase_s histograms, and SLO burn
        # attribution.  CUP3D_FLEET_PROVENANCE=0 reverts _job_terminal
        # to the aggregate-only bookkeeping.
        self.provenance = bool(
            provenance if provenance is not None
            else _env_int("CUP3D_FLEET_PROVENANCE", 1))
        #: per-tenant rolling history of per-job phase SHARES (phase
        #: seconds / e2e), newest last — the burn-attribution baseline
        self._phase_share_history: Dict[str, deque] = {}
        # write-ahead durability.  CUP3D_FLEET_JOURNAL=0
        # keeps the serve loop bitwise-legacy: no journal instance, no
        # appends, no recovery — every _journal call is one None test.
        use_journal = bool(
            journal if journal is not None
            else _env_int("CUP3D_FLEET_JOURNAL", 1))
        self.journal = (
            JobJournal(os.path.join(self.workdir, "journal"))
            if use_journal else None)
        #: admission closed for drain_for_shutdown (fleet/migrate.py)
        self.draining = False
        #: the last recover() outcome (health()["durability"])
        self.last_recovery: Optional[dict] = None
        self.migrations = 0
        _LIVE.append(weakref.ref(self))

    # -- the compiled store and the background compile service -----------

    def _aot(self):
        """(store, compile service) when ``CUP3D_AOT_STORE`` is set, else
        (None, None): the whole machinery keys off the active store.  The
        environment's fingerprint is taken here, on the dispatch thread
        (it initialises CUDA), so that the service's worker makes no CUDA
        call."""
        from cup3d_tpu_torch.aot import store as aot_store

        st = aot_store.active_store()
        if st is None:
            return None, None
        if self._aot_service is None:
            from cup3d_tpu_torch.aot.compiler import CompileService

            aot_store.fingerprint()
            self._aot_service = CompileService()
        return st, self._aot_service

    def _tables_wait(self, job: FleetJob) -> bool:
        """With the service active, an ``amr_tgv`` job whose initial
        forest's ``tables`` record is not in the store parks in
        ``compile_wait`` on a background table build (on the CPU, in the
        service's helper process so that it holds no GIL against the
        dispatch thread, put into the store) instead of building the
        tables on the dispatch thread at its driver's init; other jobs
        dispatch meanwhile.  True while it waits; the pass that finds the
        build finished closes the wait (``compile_ready``).  A pass reads
        a build's readiness once, so the jobs waiting on one build leave
        their wait in the same pass and batch together: a build that ends
        between two of them would split them into batches that depend on
        its timing (a lane's rows depend on its batch's other lanes)."""
        if job.job_id in self._prepared or job.spec.get("kind") != "amr_tgv":
            return False
        if os.environ.get("CUP3D_BUCKET", "1") == "0":
            return False
        st, svc = self._aot()
        if svc is None:
            return False
        from cup3d_tpu_torch.aot.compiler import BUILD_TIMEOUT_S
        from cup3d_tpu_torch.sim import amr as amr_mod

        tkey = self._tables_keys.get(job.job_id)
        if tkey is None:
            _, cfg = _job_config(job.spec, self.workdir)
            tkey = self._tables_keys[job.job_id] = (
                amr_mod.initial_tables_sig(cfg), cfg)
        sig, cfg = tkey
        bkey = ("tables",) + tuple(sig)
        ready = self._pass_ready.get(bkey)
        if ready is None:
            ready = self._pass_ready[bkey] = (
                st.contains(sig) or svc.status(bkey) in ("done", "failed"))
        if ready:
            # built (a failed build, or a refused write: the init builds)
            if job.events and job.events[-1][0] == "compile_wait":
                job.mark("compile_ready")
            return False
        status = svc.status(bkey)
        if status is None:
            svc.submit(bkey, lambda cfg=cfg: amr_mod.host_tables_build_child(
                cfg, svc.host, timeout=BUILD_TIMEOUT_S),
                name="forest.tables", jobs=[job.job_id])
        else:
            svc.attach(bkey, [job.job_id])
        job.mark("compile_wait", collapse=True)
        return True

    def _neighbor_rungs(self, cap: int) -> List[int]:
        """The +-1 rungs of the x1.25 lane ladder around ``cap``
        (max-lanes-clamped, deduplicated): the JAX package's speculative
        compile targets.  The port binds no rung ahead of its use (a bind
        builds nothing a rung could share), so the serve path does not
        call this."""
        rungs = []
        down = None
        c = LANE_LADDER_BASE
        while c < cap:
            down = c
            c = max(c + 1, int(np.ceil(c * 1.25)))
        if down is not None:
            down = self.lane_capacity(down)
            if 0 < down != cap:
                rungs.append(down)
        up = self.lane_capacity(cap + 1)
        if cap < up <= self.max_lanes and up not in rungs:
            rungs.append(up)
        return rungs

    # -- tenant lifecycle --------------------------------------------------

    def submit(self, tenant: str, spec: dict) -> str:
        """Validate + enqueue one scenario; returns the job id.
        Admission control: a queue at its backpressure
        depth, or a tenant at its live-job quota, raises
        :class:`FleetAdmissionError` instead of enqueueing — both
        rejection counts and the backpressure flag surface in
        ``health()["admission"]``."""
        kind = str(spec.get("kind", "fish"))
        if kind not in ("fish", "tgv", "amr_tgv"):
            raise ValueError(f"unknown fleet scenario kind {kind!r}")
        if int(spec.get("nsteps", 0)) <= 0:
            raise ValueError("fleet scenario needs nsteps > 0")
        if self.draining:
            M.counter("fleet.admission_rejects", reason="draining").inc()
            raise FleetAdmissionError(
                "draining", "server is draining for shutdown")
        depth = self.queue_depth()
        if depth >= self.max_queue_depth:
            M.counter("fleet.admission_rejects", reason="queue-full").inc()
            raise FleetAdmissionError(
                "queue-full",
                f"queue depth {depth} at backpressure threshold "
                f"{self.max_queue_depth}")
        if self.tenant_quota > 0:
            live = sum(
                1 for j in self._jobs.values()
                if j.tenant == str(tenant)
                and j.status in (QUEUED, RUNNING))
            if live >= self.tenant_quota:
                M.counter("fleet.admission_rejects", reason="quota").inc()
                raise FleetAdmissionError(
                    "quota",
                    f"tenant {tenant!r} at live-job quota "
                    f"{self.tenant_quota}")
        job_id = f"job-{self._next_job:04d}"
        self._next_job += 1
        job = FleetJob(job_id=job_id, tenant=str(tenant), spec=dict(spec),
                       nsteps=int(spec["nsteps"]))
        job.mark("submitted")
        job.mark("queued")
        self._jobs[job_id] = job
        self._journal("submit", job_id=job_id, tenant=job.tenant,
                      spec=dict(spec), nsteps=job.nsteps)
        M.counter("fleet.submits").inc()
        return job_id

    def poll(self, job_id: str) -> dict:
        return self._jobs[job_id].summary()

    def cancel(self, job_id: str) -> bool:
        """Cancel a queued or running job; terminal jobs are left
        alone.  Returns True when the job state changed."""
        job = self._jobs[job_id]
        if job.status == QUEUED:
            job.status = CANCELLED
            job.mark("cancelled")
            self._prepared.pop(job_id, None)
            M.counter("fleet.lane_retires", reason="cancelled").inc()
            self._job_terminal(job)
            return True
        if job.status == RUNNING and job.batch is not None:
            job.batch.cancel_lane(job.lane)
            # cancel_lane retires through the batch's guarded retire()
            # — a lane already swapped or terminal in the batch is a
            # no-op there, so verify the state actually changed rather
            # than reporting success unconditionally
            return job.status == CANCELLED
        return False

    def drain(self) -> Dict[str, dict]:
        """Run everything queued to completion and return the per-
        tenant summary.  Continuous mode (the default) runs the work-
        conserving serve() loop with admission closed;
        ``CUP3D_FLEET_CONTINUOUS=0`` keeps the legacy generation-drain
        (assemble the queue once, run every batch to completion)
        bitwise-unchanged as the occupancy baseline."""
        if self.continuous:
            return self.serve()
        busy0, total0 = self._occupancy_totals()
        self.assemble()
        while True:
            live = [b for b in self.batches if b.active()]
            if not live:
                break
            for b in live:
                b.tick()
        for b in self.batches:
            b.settle()
        self._aot_quiesce()
        self._close_occupancy_window(busy0, total0)
        self.update_lane_gauge()
        return self.tenant_summary()

    def serve(self, feed=None) -> Dict[str, dict]:
        """The continuous-batching dispatch loop: one scheduling pass
        (reseed freed lanes, assemble what cannot wait) plus one round-
        robin tick per K-boundary.  ``feed(server, tick)``, when given,
        is called at each boundary and may ``submit()`` in-flight
        (admission control applies); it returns False to close
        admission.  The loop ends when admission is closed and every
        admitted job is terminal.  Returns the tenant summary."""
        busy0, total0 = self._occupancy_totals()
        admitting = feed is not None
        tick = 0
        while True:
            if admitting:
                # settle first so pending retirements are visible to
                # the feed's poll()-driven admission decisions; with no
                # feed there is nothing to decide and the dispatch
                # pipeline keeps its full in-flight overlap
                for b in self.batches:
                    if b.active():
                        b.settle()
                admitting = bool(feed(self, tick))
            self._schedule()
            live = [b for b in self.batches if b.active()]
            for b in live:
                b.tick()
            tick += 1
            queued = any(
                j.status == QUEUED for j in self._jobs.values())
            svc = self._aot_service
            if svc is not None and svc.depth() > 0:
                # a dead worker's orphans, or a build past its deadline,
                # are failed (aot.service_fallbacks) so that their jobs
                # build inline at the next pass; when nothing is live and
                # every queued job waits on a build, park on the service,
                # in slices, instead of busy-spinning the scheduler
                reaped = svc.fail_orphans() or svc.fail_stale()
                if not live and queued and not reaped:
                    svc.wait(0.05)
            if not admitting and not live and not queued:
                break
        for b in self.batches:
            b.settle()
        self._aot_quiesce()
        self._close_occupancy_window(busy0, total0)
        self.update_lane_gauge()
        return self.tenant_summary()

    def _aot_quiesce(self) -> None:
        """Let in-flight background builds finish before the serve/drain
        window closes (their records land in the store, warm for the next
        boot), for at most the service's build deadline.  The helper
        process stays up for the next drain."""
        if self._aot_service is not None:
            from cup3d_tpu_torch.aot.compiler import BUILD_TIMEOUT_S

            self._aot_service.drain(timeout=BUILD_TIMEOUT_S)

    def queue_depth(self) -> int:
        return sum(1 for j in self._jobs.values() if j.status == QUEUED)

    # -- durability ---------------------------------------------

    def _journal(self, rtype: str, **fields) -> None:
        """Best-effort journal append (no-op with the journal off)."""
        if self.journal is not None:
            self.journal.append(rtype, **fields)

    def close_admission(self) -> None:
        """Stop accepting new jobs (drain-for-shutdown seam,
        fleet/migrate.py): submit() rejects with reason "draining"."""
        self.draining = True

    def _note_job_id(self, job_id: str) -> None:
        """Keep the job-id counter ahead of a replayed id so a
        recovered server never mints a colliding fresh id."""
        try:
            n = int(job_id.rsplit("-", 1)[-1])
        except ValueError:
            return
        self._next_job = max(self._next_job, n + 1)

    def recover(self) -> dict:
        """Replay the write-ahead journal into this server (boot-time;
        idempotent — job ids already known are skipped, so replaying
        twice, or a journal extended by this server's own appends, is a
        no-op).  Terminal jobs are remembered with their recorded rows
        (QoI bytes intact, nothing re-runs); queued jobs re-enter the
        queue; RUNNING jobs with a snapshot resume mid-flight in a
        batch rebuilt at the recorded (cap, K) — same executable, same
        bytes; RUNNING jobs that never reached a snapshot restart from
        step 0, which recomputes the identical trajectory.  Returns
        ``{replayed, remembered, requeued, resumed}``."""
        stats = {"replayed": 0, "remembered": 0, "requeued": 0,
                 "resumed": 0}
        if self.journal is None:
            self.last_recovery = dict(stats)
            return self.last_recovery
        pending: List[Tuple[FleetJob, dict]] = []
        for job_id, view in self.journal.replay().items():
            if job_id in self._jobs:
                continue
            stats["replayed"] += 1
            job = FleetJob(
                job_id=job_id, tenant=str(view["tenant"]),
                spec=dict(view["spec"]), nsteps=int(view["nsteps"]))
            self._note_job_id(job_id)
            self._jobs[job_id] = job
            snap = self._install_replayed_job(job, view)
            if job.status in TERMINALS:
                stats["remembered"] += 1
            elif snap is not None:
                pending.append((job, snap))
                stats["resumed"] += 1
            else:
                stats["requeued"] += 1
        if pending:
            self._resume_batches(pending)
        self.update_lane_gauge()
        self.last_recovery = dict(stats)
        return self.last_recovery

    def _install_replayed_job(self, job: FleetJob,
                              view: dict) -> Optional[dict]:
        """Install one replayed journal view onto a fresh FleetJob.
        Returns the snapshot record to resume from (RUNNING jobs with a
        journaled snapshot), else None.  Terminal replays keep their
        recorded rows/steps and set the ``_terminal_done`` guard — the
        crashed server already folded them into its SLO bookkeeping, so
        this server only REMEMBERS them (poll/summaries/QoI bytes),
        it does not re-observe them."""
        status = view["status"]
        if status in TERMINALS:
            job.status = status
            job.error = view.get("error")
            job.steps_done = int(view.get("steps_done", 0))
            job.time = float(view.get("time", 0.0))
            rows = view.get("rows")
            if rows is not None:
                job.rows = np.asarray(rows, np.float64).copy()
            job.mark(status)
            job._terminal_done = True
            M.counter("fleet.recovered_jobs", outcome="remembered").inc()
            return None
        job.status = QUEUED
        job.mark("submitted")
        job.mark("queued")
        job.mark("recovered")
        snap = view.get("snapshot") if status == RUNNING else None
        M.counter("fleet.recovered_jobs",
                  outcome="resumed" if snap is not None
                  else "requeued").inc()
        return snap

    def _resume_batches(self, pending) -> int:
        """Rebuild one batch per crashed batch_uid at its RECORDED
        (cap, K) and splice every resumed job back in at its journaled
        position.  Forcing the recorded shape — rather than re-deriving
        the rung from the (smaller) survivor count — is what keeps
        recovery bitwise: the lane count enters the compiled
        executable, and only the crashed server's own executable
        reproduces the control bytes (with a warm AOT store it loads
        from disk, zero recompiles)."""
        groups: "OrderedDict[object, list]" = OrderedDict()
        for job, snap in pending:
            prep = self._prepare(job)
            if prep is None:
                continue
            kind, drv, _sig, _key = prep
            groups.setdefault(snap.get("batch_uid"), []).append(
                (kind, job, drv, snap))
        resumed = 0
        for members in groups.values():
            kind = members[0][0]
            snap0 = members[0][3]
            cap, K = int(snap0["cap"]), int(snap0["K"])
            jobs = [job for _, job, _, _ in members]
            drivers = [drv for _, _, drv, _ in members]
            b = FleetBatch(self, self._next_batch, kind, jobs,
                           drivers, K, cap)
            self._next_batch += 1
            self.batches.append(b)
            for lane, (_, job, _, snap) in enumerate(members):
                b.resume_lane(lane, job, snap)
                resumed += 1
        return resumed

    # -- assembly ----------------------------------------------------------

    def lane_capacity(self, njobs: int) -> int:
        """Lane-count ladder rung for a batch of ``njobs``, clamped to
        the max-lanes knob."""
        cap = min(
            count_capacity(njobs, base=LANE_LADDER_BASE), self.max_lanes)
        return max(cap, njobs)

    def _prepare(self, job: FleetJob) -> Optional[tuple]:
        """Build + init one queued job's lane driver and bucket key,
        consuming the prepared-job cache when the scheduler already did
        the work on an earlier pass.  Returns (kind, driver, sig,
        bucket_key), or None after failing an ineligible job."""
        prep = self._prepared.pop(job.job_id, None)
        if prep is not None:
            return prep
        kind, cfg = _job_config(job.spec, self.workdir)
        job.cfg = cfg
        if kind == "amr_tgv":
            from cup3d_tpu_torch.sim.amr import AMRSimulation

            drv = _AMRLaneDriver(AMRSimulation(cfg, device=self.device))
        else:
            from cup3d_tpu_torch.sim.simulation import Simulation

            drv = Simulation(cfg, device=self.device)
        drv.init()
        if not drv._megaloop_eligible():
            job.status = FAILED
            job.error = "scenario not scan-eligible"
            job.mark("failed")
            M.counter("fleet.lane_retires", reason="ineligible").inc()
            self._job_terminal(job)
            return None
        sig = _static_signature(drv, kind)
        key = (sig, count_capacity(job.nsteps, base=1))
        # deterministic bucket-signature label for the SLO
        # histograms (hash(), being per-process salted, would split
        # one bucket's series across restarts)
        job.sig_label = "{}-{}".format(
            kind,
            hashlib.blake2s(repr(key).encode()).hexdigest()[:8])
        job.mark("bucketed")
        return kind, drv, sig, key

    def _build_batches(self, buckets) -> List[FleetBatch]:
        """Bucketed (kind, job, driver) groups -> FleetBatches: each
        bucket splits into chunks of <= max_lanes and pads up the lane
        ladder."""
        built = []
        for (sig, _rung), members in buckets.items():
            for i in range(0, len(members), self.max_lanes):
                chunk = members[i:i + self.max_lanes]
                kind = chunk[0][0]
                jobs = [job for _, job, _ in chunk]
                drivers = [drv for _, _, drv in chunk]
                K = resolve_scan_k(drivers[0].cfg)
                if K <= 1:
                    K = DEFAULT_SCAN_K
                b = FleetBatch(self, self._next_batch, kind, jobs,
                               drivers, K, self.lane_capacity(len(jobs)))
                self._next_batch += 1
                self.batches.append(b)
                built.append(b)
        return built

    def assemble(self) -> List[FleetBatch]:
        """Queued jobs -> bucketed batches.  Buckets key on the static
        signature plus the ×1.25 step-budget rung; each bucket splits
        into chunks of <= max_lanes and pads up the lane ladder."""
        queued = [j for j in self._jobs.values() if j.status == QUEUED]
        if not queued:
            return []
        buckets: "OrderedDict[tuple, list]" = OrderedDict()
        for job in queued:
            prep = self._prepare(job)
            if prep is None:
                continue
            kind, drv, _sig, key = prep
            buckets.setdefault(key, []).append((kind, job, drv))
        built = self._build_batches(buckets)
        self.update_lane_gauge()
        return built

    def _schedule(self) -> int:
        """One K-boundary scheduling pass (continuous batching): settle
        the live batches so pending retirements are visible, reseed
        freed lanes with compatible queued jobs (same static signature
        -> the cached executable is reused with zero recompiles), and
        assemble fresh batches only for jobs with no compatible live
        batch to wait on.  Returns the number of lanes reseeded."""
        queued = [j for j in self._jobs.values() if j.status == QUEUED]
        if not queued:
            return 0
        self._pass_ready = {}
        for b in self.batches:
            if b.active():
                b.settle()
        if self.policy == "srb":
            # shortest-remaining-budget: stable sort, FIFO within ties
            queued.sort(key=lambda j: j.nsteps)
        reseeded = 0
        leftovers: "OrderedDict[tuple, list]" = OrderedDict()
        waiting: "OrderedDict[tuple, list]" = OrderedDict()
        for job in queued:
            if self._tables_wait(job):
                continue
            prep = self._prepare(job)
            if prep is None:
                continue
            kind, drv, sig, key = prep
            placed = blocked = False
            for b in self.batches:
                # only LIVE batches are reseed targets: once a batch
                # fully drains, fresh assembly (which serves the same
                # executable from the LRU cache) is just as work-
                # conserving and keeps the generation semantics of an
                # idle server unchanged
                if b.kind != kind or b.sig != sig or not b.active():
                    continue
                free = b.free_lanes()
                if free:
                    b.reseed_lane(free[0], job, drv)
                    self.reseeds += 1
                    reseeded += 1
                    placed = True
                    break
                blocked = True
            if placed:
                continue
            if blocked:
                # a live compatible batch will free a lane at a coming
                # K-boundary; waiting beats padding out a fresh batch.
                # The wait is a distinct provenance phase (reseed_wait):
                # neither capacity (lanes exist) nor compile (executable
                # is warm) — collapse keeps one event per parked stretch
                job.mark("reseed_wait", collapse=True)
                self._prepared[job.job_id] = prep
                waiting.setdefault(key, []).append((kind, job, drv))
                continue
            leftovers.setdefault(key, []).append((kind, job, drv))
        for key, members in waiting.items():
            # enough blocked same-rung jobs to FILL a batch beats
            # waiting: zero padding lanes, so assembling now is a
            # strict occupancy win over a reseed slot later
            if (len(members) > 1
                    and self.lane_capacity(len(members)) == len(members)):
                for _, job, _ in members:
                    self._prepared.pop(job.job_id, None)
                leftovers.setdefault(key, []).extend(members)
        if leftovers:
            self._build_batches(leftovers)
        if reseeded or leftovers:
            self.update_lane_gauge()
        return reseeded

    def executable(self, sig: tuple, s, ob, cap: int, K: int,
                   kind: Optional[str] = None):
        """The advance cache, LRU-capped by the buckets knob: one
        lane-batched advance per (signature, lane rung, K).  Every bind
        counts in ``fleet.executable_builds``, with the compiled store or
        without: a bind builds nothing the store could hold (the tables
        and kernels it closes over come through their own records)."""
        key = (sig, int(cap), int(K))
        hit = self._execs.pop(key, None)
        if hit is not None:
            self._execs[key] = hit
            M.counter("fleet.executable_hits").inc()
            return hit
        fn = FB.build_fleet_advance(s, ob, kind=kind)
        self._execs[key] = fn
        M.counter("fleet.executable_builds").inc()
        while len(self._execs) > self.max_buckets:
            self._execs.popitem(last=False)
            M.counter("fleet.executable_evictions").inc()
        return fn

    # -- observability -----------------------------------------------------

    def _occupancy_totals(self) -> Tuple[int, int]:
        return (sum(b.busy_steps for b in self.batches),
                sum(b.total_steps for b in self.batches))

    def _close_occupancy_window(self, busy0: int,
                                total0: int) -> Optional[float]:
        """Fold one drain/serve window into the ``fleet.lane_occupancy``
        gauge: busy-lane-steps / total-lane-steps over the window's
        dispatches.  Frozen and padding lanes count against the
        denominator — that is exactly the waste continuous batching
        reclaims, so the gauge is the bench gate's metric
        (bench.py fleet_skew, gates.fleet_occupancy)."""
        busy, total = self._occupancy_totals()
        dbusy, dtotal = busy - busy0, total - total0
        if dtotal <= 0:
            return None
        occ = dbusy / dtotal
        self.last_occupancy = occ
        M.gauge("fleet.lane_occupancy").set(occ)
        return occ

    def _job_terminal(self, job: FleetJob, batch: Optional[FleetBatch]
                      = None, lane: Optional[int] = None) -> None:
        """One job reached done/failed/cancelled: fold its timeline into
        the SLO histograms + breach window, notify the flight recorders,
        and (tracing on) emit the kind="job" aux record and the pid-3
        lane-occupancy span.  Called exactly once per job — every
        terminal transition funnels through here, and the
        ``_terminal_done`` guard makes a second arrival — a
        cancel racing a migration, or a replayed-from-journal terminal
        — a counted no-op instead of a double SLO fold."""
        if job._terminal_done:
            M.counter("fleet.duplicate_terminals").inc()
            return
        job._terminal_done = True
        self._journal(
            "terminal", job_id=job.job_id, status=job.status,
            error=job.error, steps_done=int(job.steps_done),
            time=float(job.time), nsteps=int(job.nsteps),
            rows=None if job.rows is None else job.rows.copy())
        durs = job.durations()
        bucket = job.sig_label or "unbucketed"
        if "queue_wait_s" in durs:
            M.histogram("fleet.job_queue_wait_s", tenant=job.tenant,
                        bucket=bucket).observe(durs["queue_wait_s"])
        if "exec_s" in durs:
            M.histogram("fleet.job_exec_s", tenant=job.tenant,
                        bucket=bucket).observe(durs["exec_s"])
        # latency provenance: the exact phase decomposition
        # (sums to e2e by construction) feeds the federation-mergeable
        # per-phase histograms and the burn-attribution share history.
        # CUP3D_FLEET_PROVENANCE=0 skips all of it (overhead gate).
        phases = job.phases() if self.provenance else None
        if phases:
            for ph, v in phases.items():
                M.histogram("fleet.latency_phase_s", phase=ph,
                            tenant=job.tenant).observe(v)
            total = sum(phases.values())
            if total > 0:
                self._phase_share_history.setdefault(
                    job.tenant, deque(maxlen=64)).append(
                        {ph: v / total for ph, v in phases.items()})
        e2e = durs.get("e2e_s")
        if e2e is not None:
            M.histogram("fleet.job_e2e_s", tenant=job.tenant,
                        bucket=bucket).observe(e2e)
            wnd = self._slo_windows.setdefault(
                job.tenant, deque(maxlen=self.slo_window))
            breached = e2e > self.slo_p99_s
            wnd.append(bool(breached))
            if breached:
                M.counter("fleet.slo_breaches", tenant=job.tenant).inc()
        for fr in _flight.live_recorders():
            fr.note_job({"job_id": job.job_id, "tenant": job.tenant,
                         "status": job.status,
                         "steps_done": int(job.steps_done),
                         **{k: round(v, 6) for k, v in durs.items()}})
        sink = OT.TRACE
        if not sink.enabled:
            return
        rec = OT.job_record(
            job.job_id, job.tenant, job.status, job.steps_done,
            job.events, bucket=bucket,
            durations={k: round(v, 6) for k, v in durs.items()})
        if phases:
            # unrounded: trace_check asserts the partition invariant to
            # float eps against the event-timeline span
            rec["phases"] = phases
        if batch is not None and lane is not None:
            rec["batch"] = int(batch.batch_id)
            rec["lane"] = int(lane)
        sink.aux(rec)
        t_run = job.event_time("running")
        if batch is not None and lane is not None and t_run is not None:
            tid = FB.lane_track_id(batch.batch_id, lane)
            t_end = job.events[-1][1]
            sink.lane_span(
                tid, job.job_id, t_run, t_end - t_run,
                args={"job_id": job.job_id, "tenant": job.tenant,
                      "status": job.status, "bucket": bucket,
                      "steps_done": int(job.steps_done)})
            for name, t in job.events:
                if name == "rollback":
                    sink.lane_instant(tid, "rollback", t,
                                      args={"job_id": job.job_id})
            if (self.provenance
                    and job.event_time("compile_wait") is not None):
                # the receiving end of the flow arrow the compile service
                # opened: it lands inside this job's lane span
                sink.flow_finish(job.job_id, "compile->lane", t_run,
                                 OT.LANE_PID, tid)

    def latency_quantiles(self, name: str = "fleet.job_e2e_s",
                          tenant: Optional[str] = None,
                          qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
                          ) -> Dict[str, Optional[float]]:
        """Aggregate quantiles over one job-latency histogram family
        (optionally one tenant's slice), merging bucket counts across
        label sets — the PromQL ``histogram_quantile(sum by (le))``
        computed in-process.  Values are None until a first job lands.
        Note the registry is process-global: the family aggregates over
        every server in the process, exactly like a scrape would."""
        hists = [h for h in M.histograms(name)
                 if tenant is None or h.labels.get("tenant") == tenant]
        return {f"p{int(round(q * 100))}": M.merged_quantile(hists, q)
                for q in qs}

    def phase_quantiles(self, tenant: Optional[str] = None,
                        qs: Tuple[float, ...] = (0.5, 0.99)
                        ) -> Dict[str, Dict[str, Optional[float]]]:
        """Per-phase latency quantiles over the
        ``fleet.latency_phase_s`` family (optionally one tenant's
        slice), bucket counts merged across label sets exactly like
        :meth:`latency_quantiles`.  Only phases that observed at least
        one job appear."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        fam = M.histograms("fleet.latency_phase_s")
        for ph in OT.JOB_PHASES:
            hists = [h for h in fam
                     if h.labels.get("phase") == ph
                     and (tenant is None
                          or h.labels.get("tenant") == tenant)]
            if hists:
                out[ph] = {
                    f"p{int(round(q * 100))}": M.merged_quantile(
                        hists, q)
                    for q in qs}
        return out

    def phase_attribution(self, tenant: str) -> Optional[dict]:
        """SLO burn attribution for one tenant: which phase dominates
        the current latency window, and which phase's SHARE of
        end-to-end grew against the rolling baseline (the
        median of :func:`obs.metrics.rolling_baseline`).  Shares are per-job
        phase-seconds / e2e, so they are scale-free: a fleet that got
        uniformly slower shows zero deltas, while a compile storm shows
        compile_wait's share growing.  None until a first job retires
        (or with provenance off)."""
        shares = self._phase_share_history.get(tenant)
        if not shares:
            return None
        recent = list(shares)[-8:]
        quantiles = self.phase_quantiles(tenant=tenant, qs=(0.99,))
        phases: Dict[str, dict] = {}
        dominant = grew = None
        dom_share = grew_delta = 0.0
        for ph in OT.JOB_PHASES:
            series = [s.get(ph, 0.0) for s in shares]
            share = sum(s.get(ph, 0.0) for s in recent) / len(recent)
            base = M.rolling_baseline(series, window=32)
            delta = share - base
            phases[ph] = {
                "p99_s": quantiles.get(ph, {}).get("p99"),
                "share": round(share, 4),
                "baseline_share": round(base, 4),
                "delta": round(delta, 4),
            }
            if dominant is None or share > dom_share:
                dominant, dom_share = ph, share
            if grew is None or delta > grew_delta:
                grew, grew_delta = ph, delta
        return {"dominant_phase": dominant, "grew_phase": grew,
                "phases": phases}

    def slo_status(self) -> dict:
        """The per-tenant SLO view (health()["slo"], fleet slo CLI):
        target, rolling-window breach fraction, and the burn rate —
        breach fraction over the 1% error budget a p99 target implies
        (burn 1.0 = exactly on budget, >1 = burning ahead of it)."""
        tenants = {}
        for tenant, wnd in sorted(self._slo_windows.items()):
            n = len(wnd)
            b = int(sum(wnd))
            frac = (b / n) if n else 0.0
            tenants[tenant] = {
                "jobs": n,
                "breaches": b,
                "breach_fraction": round(frac, 4),
                "burn_rate": round(frac / self.SLO_ERROR_BUDGET, 2),
                "quantiles": self.latency_quantiles(tenant=tenant),
            }
            if frac > self.SLO_ERROR_BUDGET and self.provenance:
                # the budget is burning ahead of plan: attach the
                # phase attribution so /health names the
                # phase to remediate (capacity vs compile vs reseed)
                tenants[tenant]["attribution"] = \
                    self.phase_attribution(tenant)
        return {
            "target_p99_s": self.slo_p99_s,
            "window": self.slo_window,
            "error_budget": self.SLO_ERROR_BUDGET,
            "tenants": tenants,
        }

    def update_lane_gauge(self) -> None:
        M.gauge("fleet.lanes_active").set(
            float(sum(b.running_lanes() for b in self.batches)))

    def jobs_by_status(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for job in self._jobs.values():
            out[job.status] = out.get(job.status, 0) + 1
        return out

    def tenant_summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for job in self._jobs.values():
            t = out.setdefault(
                job.tenant, {"jobs": [], "steps_done": 0, "statuses": {}})
            t["jobs"].append(job.summary())
            t["steps_done"] += int(job.steps_done)
            st = t["statuses"]
            st[job.status] = st.get(job.status, 0) + 1
        return out

    def lane_state(self, job_id: str) -> Dict[str, np.ndarray]:
        job = self._jobs[job_id]
        if job.batch is None:
            raise ValueError(f"{job_id} was never assembled into a batch")
        return job.batch.lane_state(job.lane)

    def _aot_health(self) -> Optional[dict]:
        """Store + compile-service state, or None when inert."""
        from cup3d_tpu_torch.aot import store as aot_store

        st = aot_store.active_store()
        if st is None and self._aot_service is None:
            return None
        return {
            "store": st.state() if st is not None else None,
            "service": (self._aot_service.state()
                        if self._aot_service is not None else None),
        }

    def health(self) -> dict:
        """Fleet state for the obs /health endpoint."""
        depth = self.queue_depth()
        return {
            "jobs": self.jobs_by_status(),
            "lanes_active": int(
                sum(b.running_lanes() for b in self.batches)),
            "batches": len(self.batches),
            "dispatches": int(sum(b.dispatches for b in self.batches)),
            "rollbacks": int(sum(b.guard.rollbacks for b in self.batches)),
            "executables": len(self._execs),
            "aot": self._aot_health(),
            "slo": self.slo_status(),
            "admission": {
                "queue_depth": depth,
                "max_queue_depth": self.max_queue_depth,
                "backpressure": depth >= self.max_queue_depth,
                "tenant_quota": self.tenant_quota,
            },
            "scheduler": {
                "continuous": self.continuous,
                "policy": self.policy,
                "reseeds": int(self.reseeds),
                "lane_occupancy": self.last_occupancy,
            },
            # one card: the batch is one lane axis, unsharded
            "mesh": topo.mesh_state(None),
            "durability": {
                "journal": (None if self.journal is None
                            else self.journal.state()),
                "draining": bool(self.draining),
                "recovered": self.last_recovery,
                "migrations": int(self.migrations),
            },
            "knobs": {
                "max_lanes": self.max_lanes,
                "max_buckets": self.max_buckets,
                "snap_steps": self.snap_steps,
                "mesh": 0,
            },
        }


def summary_json(summary: Dict[str, dict]) -> str:
    return json.dumps(summary, indent=2, sort_keys=True)
