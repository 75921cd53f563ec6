"""Deterministic fault injection at named seams (port of
``cup3d_tpu/resilience/faults.py``: the same site catalog and the same
``CUP3D_FAULT`` grammar, so a plan that parses in the JAX package parses
here).

==================== ======================================================
site                 seam (where ``fire`` is consulted)
==================== ======================================================
step.nan_velocity    drivers' ``calc_max_timestep``: poisons the max|u|
                     mirror, tripping the NaN-umax abort
dt.collapse          drivers' ``calc_max_timestep``: poisons the computed
                     dt, tripping the dt-collapse abort
solver.nan_residual  ``obs.trace.StepObserver.note_solver``: the consumed
                     solver residual becomes NaN
solver.itercap       ``obs.trace.StepObserver.note_solver``: the consumed
                     iteration count hits the solver's cap
ckpt.write_fail      ``io.checkpoint.write_payload``: the checkpoint
                     write raises (every retry re-fires while armed)
dump.write_fail      ``stream.dump.AsyncDumper._write``: the dump write
                     raises (every retry re-fires while armed; a dump
                     whose retries all fail is dropped and counted)
stream.stall         ``stream.qoi.QoIStream.emit``: sleeps ``STALL_S``
                     (a simulated stall, counted in the stream's stall_s)
fleet.lane_nan       ``fleet.isolate.LaneGuard.check_row``: armed with the
                     LANE index in the step slot, the consumed row of
                     that lane (and, an arm matching every step at or
                     above it, of every lane above) reads as NaN
journal.write_fail   ``fleet.journal.JobJournal.append``: the segment
                     write raises (a one-shot arm is absorbed by the
                     write guard's retry)
server.crash         ``fleet.server.FleetBatch.dispatch``: armed with the
                     dispatch count, the process exits (code 23) at that
                     K-boundary
aot.store_corrupt    ``aot.store.ExecutableStore.get``: flips bytes in the
                     middle of the record before it loads (the checksum
                     rejects it; the caller builds live)
compile.service_die  ``aot.compiler.CompileService._run``: the worker
                     thread dies holding a RUNNING build (the serve loop
                     reaps the orphan and builds inline)
==================== ======================================================

``fleet.shard_loss`` parses and arms, and fires nowhere yet: its seam is
in the fleet across cards (ROADMAP A8b).

Arming is via ``CUP3D_FAULT="site@step[:count]"`` (``;``-separated for
several; ``step`` may be ``*`` for any step) or :func:`arm`.  A site
fires at most ``count`` times once armed and reached (an arm at step s
matches every step >= s); every firing is counted in the obs registry as
``faults.injected{site=...}``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

from cup3d_tpu_torch.obs import metrics as _metrics

#: the fault-site catalog (the JAX package's, in its order)
SITES = (
    "solver.nan_residual",
    "solver.itercap",
    "step.nan_velocity",
    "dt.collapse",
    "ckpt.write_fail",
    "dump.write_fail",
    "stream.stall",
    "fleet.lane_nan",
    "fleet.shard_loss",
    "journal.write_fail",
    "server.crash",
    "aot.store_corrupt",
    "compile.service_die",
)

ENV_VAR = "CUP3D_FAULT"
#: seconds a firing ``stream.stall`` sleeps
STALL_S = 0.02


class InjectedFault(IOError):
    """The exception raised at write-path seams when their site fires."""

    def __init__(self, site: str, step):
        super().__init__(f"injected fault {site!r} at step {step}")
        self.site = site
        self.step = step


@dataclass
class _Arm:
    site: str
    step: Optional[int]  # None = any step ('*')
    count: int = 1
    fired: int = 0

    def matches(self, step) -> bool:
        if self.fired >= self.count:
            return False
        if self.step is None:
            return True
        return step is not None and int(step) >= self.step


class FaultPlan:
    """A deterministic, ordered set of armed fault sites."""

    def __init__(self) -> None:
        self.arms: List[_Arm] = []

    def arm(self, site: str, step="*", count: int = 1) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known: {', '.join(SITES)}")
        step_i = None if step in ("*", None) else int(step)
        self.arms.append(_Arm(site, step_i, int(count)))

    def clear(self) -> None:
        self.arms = []

    def parse(self, spec: str) -> None:
        """``site@step[:count]`` entries separated by ``;`` or ``,``."""
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            if "@" not in part:
                raise ValueError(f"bad CUP3D_FAULT entry {part!r}: want "
                                 "site@step[:count]")
            site, rest = part.split("@", 1)
            count = 1
            if ":" in rest:
                rest, cnt = rest.rsplit(":", 1)
                count = int(cnt)
            self.arm(site.strip(), rest.strip(), count)

    def fire(self, site: str, step=None) -> bool:
        """True exactly when an armed entry for ``site`` fires at ``step``
        (counted, so a ``count``-shot arm exhausts itself)."""
        for a in self.arms:
            if a.site == site and a.matches(step):
                a.fired += 1
                _metrics.counter("faults.injected", site=site).inc()
                return True
        return False

    def snapshot(self) -> List[dict]:
        """Armed-state view for postmortems and tests."""
        return [{"site": a.site, "step": a.step, "count": a.count,
                 "fired": a.fired} for a in self.arms]


#: the process-global plan every seam consults
PLAN = FaultPlan()

_env_src: str = ""


def load_env(force: bool = False) -> FaultPlan:
    """(Re)load ``CUP3D_FAULT`` into the global plan.  Idempotent while the
    value is unchanged, so drivers call it at every ``simulate()`` entry;
    API-armed entries survive until the value changes."""
    global _env_src
    spec = os.environ.get(ENV_VAR, "")
    if not force and spec == _env_src:
        return PLAN
    _env_src = spec
    PLAN.clear()
    if spec:
        PLAN.parse(spec)
    return PLAN


def arm(site: str, step="*", count: int = 1) -> None:
    PLAN.arm(site, step, count)


def clear() -> None:
    """Disarm everything (tests)."""
    global _env_src
    PLAN.clear()
    _env_src = ""


def fire(site: str, step=None) -> bool:
    return PLAN.fire(site, step)


def maybe_raise(site: str, step=None) -> None:
    """Raise :class:`InjectedFault` when ``site`` fires (write seams)."""
    if PLAN.fire(site, step):
        raise InjectedFault(site, step)


def maybe_stall(site: str = "stream.stall", step=None) -> bool:
    """Sleep :data:`STALL_S` when ``site`` fires (stream seams); True when
    it fired."""
    if PLAN.fire(site, step):
        time.sleep(STALL_S)
        return True
    return False
