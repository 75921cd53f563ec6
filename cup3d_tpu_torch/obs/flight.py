"""NaN/divergence flight recorder (port of ``cup3d_tpu/obs/flight.py``).

Both drivers feed a fixed-size ring of per-step records (step, t, dt,
wall, umax, solver residual and iterations) plus a ring of solver
residual samples.  Appending is O(1) host work per step, so the recorder
runs always: history must exist from before anyone knew the run would
die.

``trigger(reason)`` writes one self-contained postmortem JSON,
``flight_<reason>_<step>.json`` in the run's directory:

    {"schema": 1, "reason": ..., "triggered_at_step": ...,
     "last_known_good_step": ..., "config": {...}, "state": {...},
     "extra": {...}, "steps": [...], "residual_history": [...],
     "recovery_events": [...], "metrics": {...}}

Trigger sites (sim/simulation.py and sim/amr.py): a NaN/Inf or runaway
max|u| and a collapsed dt (``calc_max_timestep``), and a Poisson solve
that burned its iteration cap or returned a non-finite residual (when the
step's packed solver stats are consumed, :meth:`note_solver`).  An
installed RecoveryEngine claims recoverable triggers through
``recovery_intercept``; the trigger then records a recovery event instead
of a postmortem.  One dump per recorder by default (``max_dumps``).

The postmortem's ``aot`` block lists the compiled store's state, its
hit, miss and reject counts and the live fleet servers' compile-service
states (aot/).  Not ported: the JAX postmortem's shard block (it waits
for the fleet across cards, ROADMAP A8b).
"""

from __future__ import annotations

import json
import math
import os
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

from cup3d_tpu_torch.obs import metrics as _metrics

SCHEMA_VERSION = 1

#: step-record keys whose non-finiteness marks the step as bad for the
#: last-known-good bookkeeping
_HEALTH_KEYS = ("dt", "umax", "resid", "wall_s", "t")


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return True  # non-numeric fields do not vote on health


def _jsonable(obj, depth: int = 0):
    """Best-effort JSON coercion (config dataclasses, numpy scalars,
    tuples): a postmortem writer must never throw on its payload."""
    if depth > 6:
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v, depth + 1) for v in obj]
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        try:
            return _jsonable(obj.item(), depth + 1)
        except Exception:
            return repr(obj)
    if hasattr(obj, "__dict__") and not callable(obj):
        return {k: _jsonable(v, depth + 1) for k, v in vars(obj).items()
                if not k.startswith("_")}
    return repr(obj)


#: every live recorder, held by weakref: the fleet server notes each
#: terminal job into all of them (fleet/server.py)
_LIVE: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def live_recorders() -> List["FlightRecorder"]:
    """Currently-alive recorders (arbitrary order)."""
    return list(_LIVE)


class FlightRecorder:
    """Ring buffer of recent step records + residual samples with a
    one-shot postmortem dump.  ``state_probe`` (optional, zero-arg) returns
    driver state for the dump and is called only at dump time."""

    def __init__(self, capacity: int = 128, directory: str = ".",
                 run_config=None,
                 state_probe: Optional[Callable[[], dict]] = None,
                 max_dumps: int = 1):
        self.capacity = int(capacity)
        self.directory = directory
        self.run_config = run_config
        self.state_probe = state_probe
        self.max_dumps = max_dumps
        self.steps: deque = deque(maxlen=self.capacity)
        self.residuals: deque = deque(maxlen=self.capacity)
        self.last_known_good_step: Optional[int] = None
        self.dumps_written: List[str] = []
        self._c_dumps = _metrics.counter("flight.dumps")
        #: set by an installed RecoveryEngine: (reason, extra) -> True
        #: when it claims the failure (resilience/recovery.py)
        self.recovery_intercept: Optional[Callable[[str, dict], bool]] = None
        self.recovery_events: deque = deque(maxlen=64)
        self.job_events: deque = deque(maxlen=64)
        _LIVE.add(self)

    @property
    def armed(self) -> bool:
        """True while the postmortem dump budget is unspent (/health)."""
        return len(self.dumps_written) < self.max_dumps

    def note_recovery(self, event: dict) -> None:
        """Append one rollback/retry/give-up event (part of every later
        postmortem)."""
        self.recovery_events.append(dict(event))
        _metrics.counter("flight.recovery_events").inc()

    def note_job(self, event: dict) -> None:
        """Append one terminal fleet-job event (job_id, tenant, status,
        durations; part of every later postmortem)."""
        self.job_events.append(dict(event))
        _metrics.counter("flight.job_events").inc()

    # -- recording (O(1) host appends) -----------------------------------

    def record_step(self, record: dict) -> None:
        self.steps.append(record)
        if all(_finite(record[k]) for k in _HEALTH_KEYS if k in record):
            step = record.get("step")
            if step is not None:
                self.last_known_good_step = int(step)

    def note_solver(self, step: int, iters: float, resid: float,
                    cap: Optional[int] = None) -> None:
        """Append one (step, iters, resid) sample; a solve that burned its
        iteration cap or produced a non-finite residual triggers."""
        self.residuals.append({"step": int(step), "iters": float(iters),
                               "resid": float(resid)})
        if cap is not None and iters >= cap > 0:
            self.trigger("poisson-itercap",
                         extra={"step": step, "iters": iters,
                                "resid": resid, "cap": cap})
        elif not _finite(resid):
            self.trigger("poisson-nan-residual",
                         extra={"step": step, "iters": iters})

    # -- postmortem --------------------------------------------------------

    def trigger(self, reason: str, extra: Optional[dict] = None
                ) -> Optional[str]:
        """Write the postmortem (once per ``max_dumps``); returns its path,
        or None when the budget is spent or an installed recovery engine
        claims the failure (it records a recovery event instead)."""
        if self.recovery_intercept is not None:
            try:
                handled = bool(self.recovery_intercept(reason, extra or {}))
            except Exception:  # a broken engine must not block the dump
                handled = False
            if handled:
                self.note_recovery({"reason": reason, "intercepted": True,
                                    "extra": _jsonable(extra or {})})
                return None
        if len(self.dumps_written) >= self.max_dumps:
            return None
        at_step = None
        if extra and "step" in extra:
            at_step = extra["step"]
        elif self.steps:
            at_step = self.steps[-1].get("step")
        state = {}
        if self.state_probe is not None:
            try:
                state = self.state_probe()
            except Exception as e:  # the probe must not kill the dump
                state = {"probe_error": repr(e)}
        payload = {
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "wall_time": time.time(),
            "triggered_at_step": _jsonable(at_step),
            "last_known_good_step": self.last_known_good_step,
            "config": _jsonable(self.run_config),
            "state": _jsonable(state),
            "extra": _jsonable(extra or {}),
            "steps": [_jsonable(r) for r in self.steps],
            "residual_history": list(self.residuals),
            "recovery_events": [_jsonable(e) for e in self.recovery_events],
            "job_events": [_jsonable(e) for e in self.job_events],
            "metrics": _jsonable(_metrics.snapshot()),
            "mesh": _mesh_block(),
            "aot": _aot_block(),
        }
        os.makedirs(self.directory or ".", exist_ok=True)
        tag = at_step if at_step is not None else len(self.steps)
        path = os.path.join(self.directory, f"flight_{reason}_{tag}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        self.dumps_written.append(path)
        self._c_dumps.inc()
        return path


def _mesh_block() -> Dict:
    """The postmortem's mesh picture: the distributed-init state and
    every live fleet server's ``mesh_state()``; a broken probe must not
    kill the dump it is trying to explain."""
    try:
        from cup3d_tpu_torch.obs import federate as _federate

        return _jsonable(_federate.mesh_summary())
    except Exception as e:
        _metrics.counter("flight.mesh_probe_errors").inc()
        return {"probe_error": repr(e)}


def _aot_block() -> Dict:
    """The compiled store and compile-service state at dump time: store
    hits, misses and rejects by reason, and every live fleet server's
    service state (queue depth, builds in flight), so a death in a build
    storm shows in the postmortem.  ``active: False`` when the store is
    inert (CUP3D_AOT_STORE unset); a broken probe must not kill the
    dump."""
    try:
        from cup3d_tpu_torch.aot import store as _aot_store
        from cup3d_tpu_torch.fleet import server as _fleet_server

        st = _aot_store.active_store()
        services = [
            srv._aot_service.state()
            for srv in _fleet_server.live_servers()
            if srv._aot_service is not None
        ]
        rejects = {
            str(c.labels.get("reason", "")): int(c.value)
            for c in _metrics.counters("aot.store_rejects")
        }
        return _jsonable({
            "active": st is not None,
            "store": st.state() if st is not None else None,
            "store_hits": int(_metrics.counter("aot.store_hits").value),
            "store_misses": int(
                _metrics.counter("aot.store_misses").value),
            "store_rejects": rejects,
            "services": services,
        })
    except Exception as e:
        _metrics.counter("flight.aot_probe_errors").inc()
        return {"probe_error": repr(e)}


def load_postmortem(path: str) -> Dict:
    """Read a postmortem back (tests, tooling)."""
    with open(path) as f:
        return json.load(f)
