"""Rollback/retry recovery for the step loop (port of
``cup3d_tpu/resilience/recovery.py``).

The :class:`RecoveryEngine` turns the flight recorder's terminal
conditions (nan-velocity, runaway-velocity, dt-collapse, poisson-itercap,
poisson-nan-residual) from crashes into bounded recovery:

- every ``CUP3D_SNAP_EVERY`` steps (16) it takes a rolling in-memory
  snapshot: ``io.checkpoint.build_payload`` with every device field
  cloned into a fresh device buffer (``torch.clone``; no field is read
  to the host);
- on a trigger it rolls back to the last snapshot
  (``driver._resilience_restore``), scales dt by ``0.5**attempt`` for the
  re-advance (floored at ``CUP3D_DT_FLOOR``, reset once the run is past
  the failure), and for Poisson failures walks the ladder warm-restart
  -> zero-guess -> tile-only -> iter-bump (the last two rebuild the
  solver: the tile-only rung runs the tile-only getZ kernels B3/B10
  under ``CUP3D_FUSED=1``);
- after ``CUP3D_MAX_RETRIES`` (4) failed attempts it restores the last
  snapshot, writes the postmortem and a restartable checkpoint, and
  re-raises.

Only :class:`SimulationFailure`s whose ``reason`` is in
:data:`RECOVERABLE` are claimed.  Any other exception, such as the
``RuntimeError`` of a CUDA kernel that failed to build or launch, goes
straight through ``simulate()`` and ends the run: no retry hides a
kernel.  ``CUP3D_RECOVER=0`` disables installation; the drivers then run
their plain loop.

Rollbacks and retries land in the obs registry (``resilience.rollbacks``,
``resilience.retries{stage=...}``, ``resilience.snapshots``,
``resilience.giveups``) and in the flight recorder's ``recovery_events``.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import torch

from cup3d_tpu_torch.obs import metrics as _metrics
from cup3d_tpu_torch.resilience import faults

#: flight-recorder reasons the engine knows how to recover from
RECOVERABLE = frozenset((
    "nan-velocity",
    "runaway-velocity",
    "dt-collapse",
    "poisson-itercap",
    "poisson-nan-residual",
))

#: reasons that walk the Poisson escalation ladder on retry
_POISSON = frozenset(("poisson-itercap", "poisson-nan-residual"))

#: ladder stage per attempt number for Poisson failures
_LADDER = {1: "warm-restart", 2: "zero-guess", 3: "tile-only"}


def recovery_enabled() -> bool:
    """Default on; ``CUP3D_RECOVER=0`` keeps the crash-on-fault loop."""
    return os.environ.get("CUP3D_RECOVER", "1") != "0"


class SimulationFailure(RuntimeError):
    """A run aborted by its own health checks (runaway velocity, dt
    collapse, a failed Poisson solve), with the flight recorder's
    ``reason`` so the recovery engine can classify it."""

    def __init__(self, reason: str, message: str,
                 extra: Optional[dict] = None):
        super().__init__(message)
        self.reason = reason
        self.extra = dict(extra or {})


class RecoveryEngine:
    """Snapshot / rollback / retry state machine for one driver run.

    The driver contract (sim/simulation.py, sim/amr.py): ``driver.flight``
    (flight recorder), ``driver._resilience`` (backref, for the dt
    scale), ``driver._resilience_restore(payload)``,
    ``driver._resilience_zero_pressure()`` and
    ``driver._resilience_rebuild_poisson(two_level=, maxiter_mult=)``."""

    def __init__(self, driver, snapshot_every: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 dt_floor: Optional[float] = None):
        env = os.environ.get
        self.driver = driver
        self.flight = driver.flight
        self.snapshot_every = int(snapshot_every if snapshot_every is not None
                                  else env("CUP3D_SNAP_EVERY", "16"))
        self.max_retries = int(max_retries if max_retries is not None
                               else env("CUP3D_MAX_RETRIES", "4"))
        self.dt_floor = float(dt_floor if dt_floor is not None
                              else env("CUP3D_DT_FLOOR", "1e-9"))
        self.dt_scale = 1.0
        self.attempts = 0
        self._snap: Optional[dict] = None
        self._snap_step: Optional[int] = None
        self._pending: Optional[tuple] = None
        self._recovering_until = -1
        self._c_snap = _metrics.counter("resilience.snapshots")
        self._c_roll = _metrics.counter("resilience.rollbacks")
        self._c_give = _metrics.counter("resilience.giveups")
        # one stable bound method for the flight hook (identity checks in
        # uninstall)
        self._hook = self._intercept

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def install(cls, driver, force: bool = False,
                **kw) -> Optional["RecoveryEngine"]:
        """Attach an engine to ``driver`` for one ``simulate()`` loop
        (None when disabled)."""
        if not (force or recovery_enabled()):
            return None
        faults.load_env()
        eng = cls(driver, **kw)
        driver._resilience = eng
        eng.flight.recovery_intercept = eng._hook
        return eng

    def uninstall(self) -> None:
        if getattr(self.driver, "_resilience", None) is self:
            self.driver._resilience = None
        if self.flight.recovery_intercept is self._hook:
            self.flight.recovery_intercept = None

    # -- flight-recorder interception --------------------------------------

    def _intercept(self, reason: str, extra: dict) -> bool:
        """Called inside ``flight.trigger``: claim a recoverable failure
        when a snapshot exists; the rollback runs from the loop top."""
        if reason not in RECOVERABLE or self._snap is None:
            return False
        self._pending = (reason, dict(extra))
        return True

    # -- simulate-loop hooks -----------------------------------------------

    def _step(self) -> int:
        d = self.driver
        if hasattr(d, "step_idx"):  # AMR driver
            return int(d.step_idx)
        return int(d.sim.step)

    def snapshot_due(self, step: Optional[int] = None) -> bool:
        if step is None:
            step = self._step()
        return (self._snap is None
                or step - self._snap_step >= self.snapshot_every)

    def on_loop_top(self) -> bool:
        """Top of every simulate iteration: handle a failure latched at
        the pack consumption (True after a rollback, so the loop
        re-enters), retire recovery state once the run is past the
        failure, take the cadence snapshot."""
        if self._pending is not None:
            reason, extra = self._pending
            self._pending = None
            if not self._recover(reason, extra):
                self._give_up(reason, extra)  # raises
            return True
        step = self._step()
        if self.attempts and step > self._recovering_until:
            self.attempts = 0
            self.dt_scale = 1.0
        if self.snapshot_due(step):
            try:
                self.snapshot()
            except Exception:
                # a snapshot that cannot be taken must not kill a healthy
                # run: the rollback point stays staler, the drop is counted
                _metrics.counter("resilience.snapshot_failures").inc()
        return False

    def handle_failure(self, exc: BaseException) -> bool:
        """Exception filter for the simulate loop: True after a rollback
        (retry the iteration), False when the failure is not ours (the
        caller re-raises)."""
        self._pending = None  # the raise supersedes a latched trigger
        reason = getattr(exc, "reason", None)
        if reason is None or reason not in RECOVERABLE:
            return False
        if self._snap is None:
            return False
        if not self._recover(reason, getattr(exc, "extra", {})):
            self._give_up(reason, getattr(exc, "extra", {}), exc)  # raises
        return True

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self) -> None:
        """Rolling in-memory snapshot: the restart payload with every
        device field cloned into a fresh buffer (a device copy, no host
        read) and the obstacle list frozen to bytes."""
        from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer
        from cup3d_tpu_torch.io.checkpoint import build_payload

        drv = self.driver
        if isinstance(getattr(getattr(drv, "sim", drv), "dt", 0.0),
                      torch.Tensor):
            # a device dt: the payload's float(dt) reads it, once a
            # snapshot cadence
            with sanctioned_transfer("resilience-snapshot"):
                payload = build_payload(drv)
        else:
            payload = build_payload(drv)
        payload["obstacles"] = pickle.dumps(
            payload["obstacles"], protocol=pickle.HIGHEST_PROTOCOL)
        payload["fields"] = {
            k: torch.clone(v) if isinstance(v, torch.Tensor) else v
            for k, v in payload["fields"].items()}
        self._snap = payload
        self._snap_step = int(payload["step"])
        self._c_snap.inc()

    def _restore(self) -> None:
        self.driver._resilience_restore(self._snap)

    # -- rollback / escalation ---------------------------------------------

    def _stage(self, reason: str) -> str:
        if reason in _POISSON:
            return _LADDER.get(self.attempts, "iter-bump")
        return "dt-halve"

    def _recover(self, reason: str, extra: dict) -> bool:
        """One rollback attempt; False when the retry budget is spent."""
        self.attempts += 1
        if self.attempts > self.max_retries:
            return False
        failed_at = int(extra.get("step", self._step()))
        stage = self._stage(reason)
        self._restore()
        self.dt_scale = 0.5 ** self.attempts
        if reason in _POISSON:
            if stage == "zero-guess":
                self.driver._resilience_zero_pressure()
            elif stage == "tile-only":
                self.driver._resilience_zero_pressure()
                self.driver._resilience_rebuild_poisson(two_level=False)
            elif stage == "iter-bump":
                self.driver._resilience_zero_pressure()
                self.driver._resilience_rebuild_poisson(two_level=False,
                                                        maxiter_mult=4)
        # recovery state retires once the run is safely past the failure
        self._recovering_until = failed_at + 4
        self._c_roll.inc()
        _metrics.counter("resilience.retries", stage=stage).inc()
        self.flight.note_recovery({
            "reason": reason, "stage": stage, "attempt": self.attempts,
            "failed_at_step": failed_at, "rolled_back_to": self._snap_step,
            "dt_scale": self.dt_scale,
        })
        return True

    def _give_up(self, reason: str, extra: dict,
                 exc: Optional[BaseException] = None) -> None:
        """Retries exhausted: postmortem (interception bypassed) and a
        restartable checkpoint from the last snapshot, then raise."""
        self._c_give.inc()
        icpt, self.flight.recovery_intercept = (
            self.flight.recovery_intercept, None)
        try:
            self.flight.trigger(reason, extra={
                **extra, "recovery": "exhausted", "attempts": self.attempts,
                "rolled_back_to": self._snap_step})
        finally:
            self.flight.recovery_intercept = icpt
        try:
            self._restore()
            from cup3d_tpu_torch.io.checkpoint import save_checkpoint

            path = save_checkpoint(self.driver)
            _metrics.counter("resilience.restart_checkpoints").inc()
            self.flight.note_recovery({"reason": reason, "stage": "give-up",
                                       "restart_checkpoint": path})
        except Exception:
            # the give-up must reach the raise even when the disk (or an
            # armed ckpt.write_fail) refuses the restart file
            _metrics.counter("resilience.restart_ckpt_failures").inc()
        if exc is not None:
            raise exc
        raise SimulationFailure(
            reason, f"recovery exhausted after {self.attempts - 1} retries: "
            f"{reason}", extra)

    # -- dt policy hook ----------------------------------------------------

    def scale_dt(self, dt: float) -> float:
        """Retry dt halving: the same object at scale 1.0 (so the armed,
        fault-free loop is bitwise the plain one), floored at
        ``dt_floor`` while recovering."""
        if self.dt_scale == 1.0:
            return dt
        return max(dt * self.dt_scale, min(dt, self.dt_floor))
