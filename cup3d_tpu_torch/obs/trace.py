"""Span tracing, the per-step and fleet trace records, and the step
observer (port of ``cup3d_tpu/obs/trace.py``).

- :class:`SpanTimer`: the self-time span accumulator (child spans
  excluded, so section totals partition the wall); closed spans go to
  the sink when it is enabled.
- :class:`TraceSink` with the process-global :data:`TRACE`, enabled by
  ``CUP3D_TRACE=1`` (or ``configure()``): a bounded ring of span events,
  per-step and auxiliary records appended to ``trace.jsonl`` by a
  background writer, and the Chrome trace-event export
  (``trace.pfto.json``, Perfetto-loadable) with the pid-3 lane-occupancy
  tracks of the fleet (:data:`LANE_PID`), the pid-5 compile-service
  track (:data:`COMPILE_PID`: one span a background build, and the flow
  arrows from a build to the lane spans of the jobs that waited on it);
  the pid-4 shard number (:data:`SHARD_PID`) is the JAX package's.
  ``CUP3D_TRACE_XLA=1`` wraps every span in
  ``torch.profiler.record_function``.
- The record schemas (:data:`SCHEMA_VERSION` 2: step records, and the
  ``kind="device"``, ``"job"`` and ``"shard"`` auxiliary records) with
  their validators (:func:`validate_step_record`), the job lifecycle
  catalog (:data:`JOB_EVENTS`, :data:`JOB_PHASES`,
  :data:`PHASE_OF_EVENT`, :func:`phase_decomposition`: exclusive phase
  seconds that sum to end-to-end by construction), :func:`job_record`,
  :func:`shard_record`, and the clock seams :func:`now` (monotonic) and
  :func:`wall` (timestamps).  The JAX package's ``tools/trace_check.py``
  reads what this module writes.
- :class:`StepObserver`: the drivers' glue.  ``note_solver`` is the
  consumed [residual, iterations] seam (the ``solver.nan_residual`` and
  ``solver.itercap`` faults, the flight recorder's trips); ``step()``
  wraps one advance in a step span.  The port's drivers record the
  flight recorder's step ring where they consume a step's pack, so
  ``step()`` records the ``sim.steps`` counter, and with tracing on the
  step record and span, but no flight entry.

Nothing here reads a device value: every recorded number is a host
scalar the caller already had (a device dt is written as -1.0).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from cup3d_tpu_torch.obs import metrics as _metrics

#: bump when the step-record keys/meaning change; tools/trace_check.py
#: and the VALIDATION.md contracts pin this.  v2: kind-tagged auxiliary
#: records (kind="device": the capture-window device-time attribution of
#: obs/profile.py; "job"; "shard").
SCHEMA_VERSION = 2

#: required keys of every step record and their types
STEP_REQUIRED = {"schema": int, "step": int, "t": float, "dt": float,
                 "wall_s": float}

#: required keys of a kind="device" auxiliary record (obs/profile.py)
DEVICE_REQUIRED = {"schema": int, "step": int, "total_device_ms": float,
                   "device_sections": dict}

#: required keys of a kind="job" auxiliary record (fleet/server.py)
JOB_REQUIRED = {"schema": int, "step": int, "job_id": str, "tenant": str,
                "status": str, "events": list}

#: the job-lifecycle span catalog (README "Serving observability"):
#: every event name a FleetJob timeline may carry, in nominal order —
#: rollback/retire interleave per lane fault, terminal status last.
#: "reseeded" marks a job spliced into a freed lane of a live batch at
#: a K-boundary (continuous batching) instead of waiting for
#: a fresh assembly; it follows "bucketed" on that path.
#: "compile_wait"/"compile_ready" bracket the interval a job spends
#: parked on a background CompileService build (the AOT path);
#: "reseed_wait" marks a job blocked on a live compatible batch with no
#: free lane (it waits for a K-boundary reseed instead of capacity).
#: "recovered" marks a job replayed from the write-ahead journal on a
#: restarted server — it opens the interval the job spends
#: waiting for its resume placement; "migrated" is the terminal of a
#: job checkpointed off this server by fleet/migrate.py (the receiving
#: server runs it under the same job id with a fresh timeline).
JOB_EVENTS = ("submitted", "queued", "recovered", "bucketed",
              "compile_wait", "compile_ready", "reseed_wait", "reseeded",
              "running", "dispatched", "fanout", "rollback", "retire",
              "done", "failed", "cancelled", "migrated")

#: the exclusive latency-provenance phases.  Every interval
#: between consecutive job events is attributed to exactly one phase —
#: the phase of the event that STARTS the interval (PHASE_OF_EVENT) —
#: so the per-phase sums partition end-to-end latency by construction
#: (the SpanTimer self-time invariant, lifted to whole lifecycles).
JOB_PHASES = ("admission", "capacity_wait", "compile_wait", "assembly",
              "reseed_wait", "dispatch", "rollback_retry", "retire")

#: event name -> the phase of the interval it OPENS.  Terminal events
#: ("done"/"failed"/"cancelled") close the timeline and open nothing;
#: they are mapped defensively so a malformed mid-timeline terminal
#: still attributes rather than KeyErrors.
PHASE_OF_EVENT = {
    "submitted": "admission",
    "queued": "capacity_wait",
    "bucketed": "assembly",
    "compile_wait": "compile_wait",
    "compile_ready": "assembly",
    "reseed_wait": "reseed_wait",
    "reseeded": "reseed_wait",
    "running": "dispatch",
    "dispatched": "dispatch",
    "fanout": "dispatch",
    "rollback": "rollback_retry",
    "shard_lost": "rollback_retry",
    "retire": "retire",
    "done": "retire",
    "failed": "retire",
    "cancelled": "retire",
    # a journal-replayed job waits for capacity on the
    # restarted server; a migrated-away job's timeline ends here
    "recovered": "capacity_wait",
    "migrated": "retire",
}


def phase_decomposition(events) -> Dict[str, float]:
    """Exact per-phase decomposition of one job timeline.

    ``events`` is the (name, t) pair sequence of a ``kind="job"`` record
    (append order, t non-decreasing).  Each consecutive interval
    ``[t_i, t_{i+1})`` is attributed to ``PHASE_OF_EVENT[name_i]``;
    unknown names degrade to "retire" rather than raising so a future
    event name cannot break old tooling.  The values sum to
    ``t_last - t_first`` EXACTLY (same floats, same additions) — the
    partition invariant tools/trace_check.py and the tests
    assert.  Only phases with nonzero mass appear."""
    out: Dict[str, float] = {}
    prev_name = None
    prev_t = None
    for name, t in events:
        if prev_name is not None:
            phase = PHASE_OF_EVENT.get(prev_name, "retire")
            out[phase] = out.get(phase, 0.0) + (float(t) - prev_t)
        prev_name, prev_t = name, float(t)
    return out

#: required keys of a kind="shard" auxiliary record (the JAX
#: package's mesh straggler watch; the port's waits for the fleet across
#: cards, ROADMAP A8b): one per shard per
#: evaluated K-boundary, carrying that shard's last-K wall and the
#: fleet-wide skew ratio it was judged against.
SHARD_REQUIRED = {"schema": int, "step": int, "shard": int,
                  "wall_s": float, "skew_ratio": float,
                  "source": str}

#: Perfetto pid of the per-lane job-occupancy tracks (pid 1 = host
#: spans, pid 2 = obs.profile.DEVICE_PID device sections)
LANE_PID = 3

#: Perfetto pids of the per-shard K-boundary wall tracks (nothing of
#: the port emits on them before the fleet across cards, ROADMAP A8b) and
#: of the background compile-service track (aot/compiler.py), as the JAX
#: package numbers them
SHARD_PID = 4
COMPILE_PID = 5


def now() -> float:
    """Monotonic lifecycle timestamp: ``perf_counter`` seconds on the
    same clock as the trace epoch.  Every duration of the fleet's job
    observatory derives from this clock."""
    return time.perf_counter()


def wall() -> float:
    """Wall-clock timestamp (unix epoch seconds), for labeling records
    with absolute time, never for durations."""
    return time.time()


def job_record(job_id: str, tenant: str, status: str, steps_done: int,
               events, **extra) -> dict:
    """Build one kind="job" aux record (the sink's ``aux()`` stamps the
    schema).  ``events`` is an iterable of (name, t) pairs in append
    order — validation requires t non-decreasing."""
    rec = {"kind": "job", "step": int(steps_done), "job_id": str(job_id),
           "tenant": str(tenant), "status": str(status),
           "events": [[str(n), float(t)] for n, t in events]}
    rec.update(extra)
    return rec


def _validate_job_record(rec: dict) -> List[str]:
    """Schema-check one kind="job" auxiliary record."""
    problems = []
    for k, typ in JOB_REQUIRED.items():
        if k not in rec:
            problems.append(f"missing required key {k!r}")
        elif not isinstance(rec[k], typ) or isinstance(rec[k], bool):
            problems.append(f"{k!r} must be {typ.__name__}")
    if not problems and rec["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema {rec['schema']} != supported {SCHEMA_VERSION}"
        )
    if not problems and rec["step"] < 0:
        problems.append("step must be >= 0")
    if problems:
        return problems
    prev_t = None
    for ev in rec["events"]:
        if (not isinstance(ev, (list, tuple)) or len(ev) != 2
                or not isinstance(ev[0], str)
                or not isinstance(ev[1], (int, float))
                or isinstance(ev[1], bool)):
            problems.append(f"event {ev!r} must be [name, t]")
            break
        if prev_t is not None and ev[1] < prev_t:
            problems.append(
                f"event {ev[0]!r}: t {ev[1]} < previous {prev_t} "
                "(timeline must be non-decreasing)"
            )
            break
        prev_t = ev[1]
    phases = rec.get("phases")
    if phases is not None and not problems:
        problems.extend(_validate_phases_block(phases, rec["events"]))
    return problems


def _validate_phases_block(phases, events) -> List[str]:
    """Checks for an optional ``phases`` block on a job record:
    a dict of known phase names to nonnegative numbers whose sum equals
    the event-timeline span (the partition invariant) to float eps."""
    problems: List[str] = []
    if not isinstance(phases, dict):
        return ["phases must be a dict"]
    for k, v in phases.items():
        if not isinstance(k, str) or k not in JOB_PHASES:
            problems.append(f"phases key {k!r} not in JOB_PHASES")
        elif (not isinstance(v, (int, float)) or isinstance(v, bool)
              or v < 0):
            problems.append(f"phases[{k!r}] must be a number >= 0")
    if problems or not events:
        return problems
    span = float(events[-1][1]) - float(events[0][1])
    total = sum(float(v) for v in phases.values())
    if abs(total - span) > 1e-9 * max(1.0, abs(span)) + 1e-12:
        problems.append(
            f"phases sum {total!r} != event span {span!r} "
            "(phase decomposition must partition e2e)"
        )
    return problems


def shard_record(shard: int, step: int, wall_s: float, skew_ratio: float,
                 straggler: bool = False, source: str = "fleet",
                 **extra) -> dict:
    """Build one kind="shard" aux record (the sink's ``aux()`` stamps
    the schema).  ``wall_s`` is the shard's last K-boundary wall,
    ``skew_ratio`` the slowest/median ratio it was evaluated under."""
    rec = {"kind": "shard", "step": int(step), "shard": int(shard),
           "wall_s": float(wall_s), "skew_ratio": float(skew_ratio),
           "straggler": bool(straggler), "source": str(source)}
    rec.update(extra)
    return rec


def _validate_shard_record(rec: dict) -> List[str]:
    """Schema-check one kind="shard" auxiliary record."""
    problems = []
    for k, typ in SHARD_REQUIRED.items():
        if k not in rec:
            problems.append(f"missing required key {k!r}")
        elif typ is float:
            if not isinstance(rec[k], (int, float)) or isinstance(
                rec[k], bool
            ):
                problems.append(f"{k!r} must be numeric")
        elif not isinstance(rec[k], typ) or isinstance(rec[k], bool):
            problems.append(f"{k!r} must be {typ.__name__}")
    if not problems and rec["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema {rec['schema']} != supported {SCHEMA_VERSION}"
        )
    if not problems and rec["step"] < 0:
        problems.append("step must be >= 0")
    if not problems and rec["shard"] < 0:
        problems.append("shard must be >= 0")
    if not problems and rec["wall_s"] < 0:
        problems.append("wall_s must be >= 0")
    if not problems and rec["skew_ratio"] < 0:
        problems.append("skew_ratio must be >= 0")
    straggler = rec.get("straggler")
    if straggler is not None and not isinstance(straggler, bool):
        problems.append("straggler must be a bool")
    return problems


def _validate_device_record(rec: dict) -> List[str]:
    """Schema-check one kind="device" auxiliary record."""
    problems = []
    for k, typ in DEVICE_REQUIRED.items():
        if k not in rec:
            problems.append(f"missing required key {k!r}")
        elif typ is float:
            if not isinstance(rec[k], (int, float)) or isinstance(
                rec[k], bool
            ):
                problems.append(f"{k!r} must be numeric")
        elif not isinstance(rec[k], typ) or isinstance(rec[k], bool):
            problems.append(f"{k!r} must be {typ.__name__}")
    if not problems and rec["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema {rec['schema']} != supported {SCHEMA_VERSION}"
        )
    if not problems and rec["step"] < 0:
        problems.append("step must be >= 0")
    if not problems and not all(
        isinstance(k, str) and isinstance(v, (int, float))
        and not isinstance(v, bool)
        for k, v in rec["device_sections"].items()
    ):
        problems.append("device_sections must map str -> ms")
    window = rec.get("window")
    if window is not None and not (
        isinstance(window, list) and len(window) == 2
        and all(isinstance(w, int) for w in window)
    ):
        problems.append("window must be [first_step, end_step]")
    return problems


def validate_step_record(rec: dict) -> List[str]:
    """Schema-check one trace record; returns a list of problems (empty
    = valid).  Shared by the sink (debug), tests, and trace_check.
    Dispatches on the v2 ``kind`` tag: absent/"step" is a step record,
    "device" a capture-window attribution record, "job" a fleet
    job-lifecycle record, "shard" a mesh straggler-watch record."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    kind = rec.get("kind", "step")
    if kind == "device":
        return _validate_device_record(rec)
    if kind == "job":
        return _validate_job_record(rec)
    if kind == "shard":
        return _validate_shard_record(rec)
    if kind != "step":
        return [f"unknown record kind {kind!r}"]
    problems = []
    for k, typ in STEP_REQUIRED.items():
        if k not in rec:
            problems.append(f"missing required key {k!r}")
        elif typ is float:
            if not isinstance(rec[k], (int, float)) or isinstance(
                rec[k], bool
            ):
                problems.append(f"{k!r} must be numeric")
        elif not isinstance(rec[k], typ) or isinstance(rec[k], bool):
            problems.append(f"{k!r} must be {typ.__name__}")
    if not problems and rec["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema {rec['schema']} != supported {SCHEMA_VERSION}"
        )
    if not problems and rec["step"] < 0:
        problems.append("step must be >= 0")
    solver = rec.get("solver")
    if solver is not None:
        if not isinstance(solver, dict) or "iters" not in solver:
            problems.append("solver block must be a dict with 'iters'")
    sections = rec.get("sections")
    if sections is not None and not all(
        isinstance(k, str) and isinstance(v, (int, float))
        for k, v in sections.items()
    ):
        problems.append("sections must map str -> seconds")
    return problems


class _AsyncLineWriter:
    """Bounded background appender: the step loop hands lines over and
    never blocks on disk.  Lines buffer in memory and flush to the file
    every ``flush_every`` records on a single writer thread (the
    stream/dump.py one-thread-executor pattern); when ``max_lines`` is
    reached further lines are counted as dropped instead of queued, so a
    runaway trace cannot exhaust the heap."""

    def __init__(self, path: str, flush_every: int = 64,
                 max_lines: int = 1_000_000):
        self.path = path
        self.flush_every = flush_every
        self.max_lines = max_lines
        self.lines_written = 0
        self.dropped = 0
        self._buf: List[str] = []
        self._pool = None
        self._pending: List = []
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # truncate: one trace file per process run
        with open(path, "w"):
            pass

    def write(self, line: str) -> None:
        if self.lines_written + len(self._buf) >= self.max_lines:
            self.dropped += 1
            return
        self._buf.append(line)
        if len(self._buf) >= self.flush_every:
            self._kick()

    def _kick(self) -> None:
        if not self._buf:
            return
        chunk, self._buf = "".join(self._buf), []
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="cup3d-trace"
            )
        # keep at most one pending append beyond the running one: the
        # writer is strictly faster than the producer in practice, and a
        # join here (rare) is disk backpressure, not a device sync
        while len(self._pending) > 1:
            self._pending.pop(0).result()
        try:
            self._pending.append(self._pool.submit(self._append, chunk))
        except RuntimeError:
            # interpreter shutdown already stopped the executor (the
            # atexit close path): write the tail inline
            self._append(chunk)

    def _append(self, chunk: str) -> None:
        with open(self.path, "a") as f:
            f.write(chunk)
        self.lines_written += chunk.count("\n")

    def flush(self) -> None:
        self._kick()
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.flush()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


class TraceSink:
    """Process-global trace collector (span events + step records).

    Construction reads the environment; ``configure()`` overrides it
    (tests and tools pass explicit directories).  All span timestamps
    share one ``perf_counter`` epoch so Perfetto lays every thread on a
    common axis."""

    def __init__(self, enabled: Optional[bool] = None,
                 directory: Optional[str] = None,
                 max_steps: Optional[int] = None,
                 max_events: int = 500_000,
                 xla_annotate: Optional[bool] = None):
        env = os.environ
        self.enabled = (env.get("CUP3D_TRACE", "0") not in ("0", "")
                        if enabled is None else enabled)
        self.directory = directory or env.get("CUP3D_TRACE_DIR") or "."
        self.max_steps = (int(env.get("CUP3D_TRACE_MAX", "100000"))
                          if max_steps is None else max_steps)
        self.xla_annotate = (env.get("CUP3D_TRACE_XLA", "0") != "0"
                             if xla_annotate is None else xla_annotate)
        self.epoch = time.perf_counter()
        self.events: deque = deque(maxlen=max_events)
        self.steps_recorded = 0
        self.steps_dropped = 0
        self._writer: Optional[_AsyncLineWriter] = None
        self._lane_meta_emitted = False
        self._compile_meta_emitted = False
        self._lock = threading.Lock()
        # the annotation class resolves ONCE at
        # construction/configure time, so the span hot path is a single
        # attribute load + None test instead of an import-machinery trip
        # (None = passthrough off)
        self._annotation_cls = self._resolve_annotation()

    # -- configuration -----------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  directory: Optional[str] = None,
                  max_steps: Optional[int] = None,
                  xla_annotate: Optional[bool] = None) -> "TraceSink":
        """Explicit (re)configuration; closes any open writer so the next
        record lands in the new location."""
        self.close()
        if enabled is not None:
            self.enabled = enabled
        if directory is not None:
            self.directory = directory
        if max_steps is not None:
            self.max_steps = max_steps
        if xla_annotate is not None:
            self.xla_annotate = xla_annotate
        self.events.clear()
        self.steps_recorded = 0
        self.steps_dropped = 0
        self._lane_meta_emitted = False
        self._compile_meta_emitted = False
        self._annotation_cls = self._resolve_annotation()
        return self

    def default_directory(self, directory: str) -> None:
        """Driver hint: adopt ``directory`` unless the user pinned one via
        CUP3D_TRACE_DIR or configure(), or records already landed."""
        if (os.environ.get("CUP3D_TRACE_DIR") is None
                and self._writer is None and self.directory == "."):
            self.directory = directory

    @property
    def jsonl_path(self) -> str:
        return os.path.join(self.directory, "trace.jsonl")

    @property
    def perfetto_path(self) -> str:
        return os.path.join(self.directory, "trace.pfto.json")

    # -- recording ---------------------------------------------------------

    def span(self, name: str, t0: float, dur: float,
             depth: int = 0) -> None:
        """One closed span (perf_counter seconds).  Ring-buffered; only
        called when ``enabled`` (SpanTimer checks)."""
        self.events.append({
            "name": name, "ph": "X", "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": (t0 - self.epoch) * 1e6, "dur": dur * 1e6,
            "args": {"depth": depth},
        })

    def step(self, record: dict, t0: float, dur: float) -> None:
        """One per-step structured record: JSONL line (async writer) +
        a step span whose args carry the record (the Perfetto view the
        acceptance criterion reads solver iters / stream wait from)."""
        if not self.enabled:
            return
        if self.steps_recorded >= self.max_steps:
            self.steps_dropped += 1
            return
        record = dict(record)
        record["schema"] = SCHEMA_VERSION
        with self._lock:
            if self._writer is None:
                self._writer = _AsyncLineWriter(self.jsonl_path)
            self._writer.write(json.dumps(record) + "\n")
        self.steps_recorded += 1
        self.events.append({
            "name": "step", "ph": "X", "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": (t0 - self.epoch) * 1e6, "dur": dur * 1e6,
            "args": record,
        })
        _metrics.counter("trace.steps").inc()

    def _ensure_lane_meta(self) -> None:
        if not self._lane_meta_emitted:
            self._lane_meta_emitted = True
            self.events.append({
                "name": "process_name", "ph": "M", "pid": LANE_PID,
                "ts": 0, "args": {"name": "fleet lanes"},
            })

    def lane_span(self, tid: int, name: str, t0: float, dur: float,
                  args: Optional[dict] = None) -> None:
        """One closed per-lane job-occupancy span on the pid-3 track
        (``t0``/``dur`` in :func:`now` seconds).  ``tid`` is the lane's
        stable track id; ``name`` carries the job id so Perfetto labels
        the occupancy bar.  Emits the pid-3 ``process_name`` metadata
        event once per sink."""
        if not self.enabled:
            return
        self._ensure_lane_meta()
        self.events.append({
            "name": name, "ph": "X", "pid": LANE_PID, "tid": int(tid),
            "ts": (t0 - self.epoch) * 1e6, "dur": dur * 1e6,
            "args": dict(args or {}),
        })
        _metrics.counter("trace.lane_spans").inc()

    def lane_instant(self, tid: int, name: str, t: float,
                     args: Optional[dict] = None) -> None:
        """One instant marker on a pid-3 lane track (rollback/retire
        ticks inside a job's occupancy bar)."""
        if not self.enabled:
            return
        self._ensure_lane_meta()
        self.events.append({
            "name": name, "ph": "i", "pid": LANE_PID, "tid": int(tid),
            "ts": (t - self.epoch) * 1e6, "s": "t",
            "args": dict(args or {}),
        })

    def _ensure_compile_meta(self) -> None:
        if not self._compile_meta_emitted:
            self._compile_meta_emitted = True
            self.events.append({
                "name": "process_name", "ph": "M", "pid": COMPILE_PID,
                "ts": 0, "args": {"name": "compile service"},
            })

    def compile_span(self, tid: int, name: str, t0: float, dur: float,
                     args: Optional[dict] = None) -> None:
        """One closed background-build span on the pid-5 track (``t0``/
        ``dur`` in :func:`now` seconds).  ``tid`` is the worker's stable
        track id; ``args`` carries the outcome and the waiting job ids.
        Emits the pid-5 ``process_name`` metadata event once a sink."""
        if not self.enabled:
            return
        self._ensure_compile_meta()
        self.events.append({
            "name": name, "ph": "X", "pid": COMPILE_PID, "tid": int(tid),
            "ts": (t0 - self.epoch) * 1e6, "dur": dur * 1e6,
            "args": dict(args or {}),
        })
        _metrics.counter("trace.compile_spans").inc()

    def flow_start(self, flow_id: str, name: str, t: float, pid: int,
                   tid: int) -> None:
        """Open one Perfetto flow arrow (``ph:"s"``) at (pid, tid, t): a
        build's span (pid 5) to the lane span of each job that waited on
        it.  ``flow_id`` is any stable string (the job id)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "s", "cat": "flow", "id": str(flow_id),
            "pid": int(pid), "tid": int(tid),
            "ts": (t - self.epoch) * 1e6,
        })
        _metrics.counter("trace.flow_events").inc()

    def flow_finish(self, flow_id: str, name: str, t: float, pid: int,
                    tid: int) -> None:
        """Terminate a flow arrow (``ph:"f"``, binding point "e", the
        enclosing slice) at (pid, tid, t): the receiving end of a
        :meth:`flow_start` with the same ``flow_id``."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "f", "bp": "e", "cat": "flow",
            "id": str(flow_id), "pid": int(pid), "tid": int(tid),
            "ts": (t - self.epoch) * 1e6,
        })
        _metrics.counter("trace.flow_events").inc()

    def aux(self, record: dict) -> None:
        """One kind-tagged auxiliary JSONL record interleaved with the
        step stream (schema v2) — obs/profile.py appends the per-window
        device-time attribution this way.  Does not count against
        ``max_steps`` (aux records are rare: one per capture window)."""
        if not self.enabled:
            return
        record = dict(record)
        record["schema"] = SCHEMA_VERSION
        record.setdefault("kind", "device")
        with self._lock:
            if self._writer is None:
                self._writer = _AsyncLineWriter(self.jsonl_path)
            self._writer.write(json.dumps(record) + "\n")
        _metrics.counter("trace.aux_records").inc()

    # -- profiler passthrough ----------------------------------------------

    def _resolve_annotation(self):
        """``torch.profiler.record_function`` when the profiler
        passthrough is armed (enabled + ``CUP3D_TRACE_XLA=1``, the JAX
        package's knob name), else None: host spans then line up with
        the device kernels in a ``torch.profiler`` capture.  Resolved
        once per construction/configure, not on the span path."""
        if not (self.enabled and self.xla_annotate):
            return None
        try:
            from torch.profiler import record_function

            return record_function
        except Exception:  # pragma: no cover - torch-less envs
            _metrics.counter("trace.annotation_unavailable").inc()
            return None

    def annotation(self, name: str):
        """A ``torch.profiler.record_function`` for ``name`` when the
        passthrough is on, else None — the fast no-op path is one
        attribute load + None test (class cached at construction)."""
        cls = self._annotation_cls
        return cls(name) if cls is not None else None

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "metadata": {"schema": SCHEMA_VERSION,
                         "producer": "cup3d_tpu_torch.obs.trace",
                         "steps_recorded": self.steps_recorded,
                         "steps_dropped": self.steps_dropped},
        }

    def export_chrome(self, path: Optional[str] = None) -> str:
        path = path or self.perfetto_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def flush(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.flush()

    def close(self) -> None:
        """Flush the JSONL writer and, if anything was recorded, write
        the Perfetto export next to it.  Idempotent; also runs atexit."""
        with self._lock:
            w, self._writer = self._writer, None
        if w is not None:
            w.close()
        if self.enabled and (self.events or self.steps_recorded):
            self.export_chrome()


#: the process-global sink (env-configured); drivers and profilers
#: forward through it.  atexit close() makes `CUP3D_TRACE=1 python
#: bench.py` leave a complete trace without driver cooperation.
TRACE = TraceSink()

import atexit  # noqa: E402  (registration must follow TRACE)

atexit.register(TRACE.close)


def enabled() -> bool:
    return TRACE.enabled


class SpanTimer:
    """Self-time span accumulator — the engine behind ``io/logging.py``'s
    ``Profiler`` shim (which subclasses this unchanged).

    Sections record SELF time: an inner span's wall is excluded from its
    enclosing span, so section totals partition the measured wall (the
    load-bearing case is the stream's StreamWait opening inside the
    drivers' SyncQoI).  Recursion fix: when a name re-enters
    itself — directly or through other sections — ``counts[name]`` only
    advances on the OUTERMOST entry, so ``totals/counts`` stays "wall
    per logical call" (the old per-entry count halved recursive means);
    self-time attribution is unchanged and still sums to the outer wall.
    """

    def __init__(self, sink: Optional[TraceSink] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[float] = []  # per-open-span child-time sums
        self._active: Dict[str, int] = defaultdict(int)  # recursion depth
        self._sink = sink  # None -> the process-global TRACE

    @property
    def sink(self) -> TraceSink:
        return self._sink if self._sink is not None else TRACE

    def set_sink(self, sink: Optional[TraceSink]) -> None:
        """Redirect span/step forwarding (None -> the global TRACE).
        bench.py points a driver at a private sink to measure tracing
        overhead without disturbing the user's global trace."""
        self._sink = sink

    @contextmanager
    def __call__(self, name: str):
        ann = self.sink.annotation(name)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        self._stack.append(0.0)
        self._active[name] += 1
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            child = self._stack.pop()
            self.totals[name] += elapsed - child
            self._active[name] -= 1
            if self._active[name] == 0:
                # outermost entry only: recursive re-entries are part of
                # the same logical call (the recursion fix)
                self.counts[name] += 1
            if self._stack:
                self._stack[-1] += elapsed
            sink = self.sink
            if sink.enabled:
                sink.span(name, t0, elapsed, depth=len(self._stack))

    def section_totals(self) -> Dict[str, float]:
        """Plain-dict copy (StepObserver delta bookkeeping)."""
        return dict(self.totals)

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'section':<28}{'calls':>8}{'total_s':>12}{'share':>8}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<28}{self.counts[name]:>8}{t:>12.4f}{t / total:>8.1%}"
            )
        return "\n".join(lines)


class StepObserver:
    """Driver glue: one instance per driver.

    :meth:`note_solver` records one consumed (iterations, residual)
    pair; :meth:`step` wraps one advance.  ``profiler`` is the driver's
    span accumulator (None: a private :class:`SpanTimer`), ``stream``
    its QoI stream (its stall seconds over the step land in the step
    record)."""

    def __init__(self, flight=None, kind: str = "uniform",
                 profiler: Optional[SpanTimer] = None, stream=None):
        self.flight = flight
        self.kind = kind
        self.profiler = profiler if profiler is not None else SpanTimer()
        self.stream = stream
        self._steps = _metrics.counter("sim.steps", driver=kind)
        self._g_iters = _metrics.gauge("poisson.iters", driver=kind)
        self._g_resid = _metrics.gauge("poisson.resid", driver=kind)
        self._h_iters = _metrics.histogram("poisson.iters_hist", driver=kind)
        self.last_solver: Optional[dict] = None

    def note_solver(self, step: int, iters: float, resid: float,
                    cap: Optional[int] = None) -> None:
        """Record one consumed (iterations, residual) pair.  The armed
        solver faults corrupt these host copies, so detection, trigger
        and recovery run exactly as on a real solver failure."""
        from cup3d_tpu_torch.resilience import faults

        if faults.fire("solver.nan_residual", step):
            resid = float("nan")
        if cap is not None and faults.fire("solver.itercap", step):
            iters = float(cap)
        self.last_solver = {"iters": float(iters), "resid": float(resid),
                            "at_step": int(step)}
        self._g_iters.set(float(iters))
        self._g_resid.set(float(resid))
        self._h_iters.observe(float(iters))
        if self.flight is not None:
            self.flight.note_solver(step, iters, resid, cap=cap)

    @contextmanager
    def step(self, step: int, t: float, dt, **extra):
        """Wrap one advance in a step span.  ``dt`` a host float, or a
        device scalar on the device dt chain (recorded as -1.0: the span
        never reads the device).  ``extra`` lands in the record verbatim;
        the yielded dict takes late fields from inside the step."""
        sink = self.profiler.sink
        tracing = sink.enabled
        sec0 = self.profiler.section_totals() if tracing else None
        stall0 = (self.stream.stats.get("stall_s", 0.0)
                  if self.stream is not None else 0.0)
        late: dict = {}
        t0 = time.perf_counter()
        try:
            yield late
        finally:
            wall_s = time.perf_counter() - t0
            self._steps.inc()
            if tracing:
                rec = {"step": int(step), "t": float(t),
                       "dt": (float(dt) if isinstance(dt, (int, float))
                              else -1.0),
                       "wall_s": wall_s}
                rec.update(extra)
                rec.update(late)
                if self.stream is not None:
                    rec["stream_wait_s"] = (
                        self.stream.stats.get("stall_s", 0.0) - stall0)
                if self.last_solver is not None:
                    rec["solver"] = dict(self.last_solver)
                sec1 = self.profiler.section_totals()
                rec["sections"] = {
                    k: round(v - sec0.get(k, 0.0), 6)
                    for k, v in sec1.items()
                    if v - sec0.get(k, 0.0) > 0.0
                }
                sink.step(rec, t0, wall_s)
