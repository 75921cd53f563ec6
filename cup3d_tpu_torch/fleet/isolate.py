"""Per-lane fault isolation: one lane's NaN never touches its neighbours
(port of ``cup3d_tpu/fleet/isolate.py``).

The solo resilience layer (resilience/recovery.py) rolls the WHOLE
simulation back; at fleet scale that would punish L-1 healthy tenants
for one lane's blow-up.  Here recovery is scoped to the lane:

- detection runs on the consumed QoI rows (each lane's umax/dt chain),
  so it rides the stream with no extra device traffic;
- a faulted lane is rolled back to the rolling batch snapshot through a
  lane-wise ``torch.where``: a copy for the masked lane, a bit-exact
  passthrough for every other lane (the lane step has no cross-lane
  operation, so healthy lanes are bitwise unaffected end to end);
- the restored lane's carried dt is halved per attempt (the geometric
  backoff of RecoveryEngine.scale_dt), which the step's 1.03x growth
  limiter then recovers from;
- a lane that keeps faulting past ``max_retries`` is retired (its
  ``left`` budget zeroed, so the gated step freezes it) and flagged to
  the server, which fails only that tenant's job.

Every select returns new tensors; a carry or snapshot someone still
holds is never written.  Fault seams (resilience/faults.py):
``step.nan_velocity`` fires on the per-lane step chain, and
``fleet.lane_nan``, armed with the LANE index in the step slot, poisons
the chosen lane's row.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from cup3d_tpu_torch.fleet.batch import LEFT
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.resilience import faults

#: lane lifecycle states (host-side; the device only sees ``left``)
LANE_RUNNING = "running"
LANE_DONE = "done"
LANE_FAILED = "failed"
LANE_CANCELLED = "cancelled"
LANE_PADDING = "padding"

DEFAULT_MAX_RETRIES = 4


def _max_retries() -> int:
    try:
        return int(os.environ.get("CUP3D_MAX_RETRIES", DEFAULT_MAX_RETRIES))
    except ValueError:
        # a malformed knob falls back to the default retry budget
        return DEFAULT_MAX_RETRIES


def _mask_on(mask_np, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask_np, bool), device=like.device)


def _select_lanes(mask, a, b):
    """Lane-wise select over a carry dict: ``a`` where ``mask`` (L,),
    else ``b``; unselected lanes come through with their bits."""
    out = {}
    for k in a:
        x, y = a[k], b[k]
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out[k] = torch.where(m, x, y)
    return out


def restore_lanes(carry, snap, mask_np, dt_scale):
    """Roll the masked lanes back to ``snap`` with their carried dt scaled
    by ``dt_scale``; every unmasked lane keeps its exact bits."""
    mask = _mask_on(mask_np, carry["dt"])
    out = _select_lanes(mask, snap, carry)
    out["dt"] = torch.where(mask, out["dt"] * dt_scale, out["dt"])
    return out


def retire_lanes(carry, mask_np):
    """Zero the masked lanes' ``left`` budget so the gated step freezes
    them; unmasked lanes keep their exact bits."""
    mask = _mask_on(mask_np, carry[LEFT])
    out = dict(carry)
    out[LEFT] = torch.where(mask, torch.zeros_like(carry[LEFT]), carry[LEFT])
    return out


class LaneGuard:
    """Per-batch isolation state: the rolling snapshot, per-lane epochs
    (stale-row filtering across rollbacks), and per-lane retry budgets.
    The server calls ``snapshot()`` at validated boundaries and
    ``check_row()`` from its stream consumer; ``rollback()`` and
    ``give_up()`` return the corrected batched carry."""

    def __init__(self, nlanes: int, max_retries: Optional[int] = None):
        self.B = int(nlanes)
        self.max_retries = (
            _max_retries() if max_retries is None else int(max_retries))
        self.epochs = np.zeros(self.B, np.int64)
        self.attempts = np.zeros(self.B, np.int64)
        self.fail_step = np.full(self.B, -1, np.int64)
        self.rollbacks = 0
        self.snap = None
        self.snap_step = np.zeros(self.B, np.int64)
        self.snap_left = np.zeros(self.B, np.int64)

    # -- rolling snapshot --------------------------------------------------

    def snapshot(self, carry, step_h, left_h) -> None:
        """Copy the batched carry (and the host step/budget mirrors) as the
        per-lane rollback target.  Only a VALIDATED state may be
        snapshotted: every emitted row up to it consumed clean."""
        self.snap = {k: v.clone() for k, v in carry.items()}
        self.snap_step = np.asarray(step_h, np.int64).copy()
        self.snap_left = np.asarray(left_h, np.int64).copy()

    # -- detection ---------------------------------------------------------

    def check_row(self, lane: int, step: int, umax: float,
                  dt: float) -> Optional[str]:
        """Classify one consumed lane row; None when healthy.  The
        injection seams run first, so a test fault poisons the chain at
        exactly the armed (lane, step)."""
        if faults.fire("fleet.lane_nan", lane):
            return "nan-velocity"
        if faults.fire("step.nan_velocity", step):
            return "nan-velocity"
        if not (math.isfinite(umax) and math.isfinite(dt)):
            return "nan-velocity"
        if dt <= 0.0:
            return "dt-collapse"
        return None

    def note_progress(self, lane: int, step: int) -> None:
        """A clean row past the last failure point closes the incident:
        the retry budget re-arms."""
        if self.fail_step[lane] >= 0 and step > self.fail_step[lane]:
            self.fail_step[lane] = -1
            self.attempts[lane] = 0

    # -- recovery ----------------------------------------------------------

    def exhausted(self, lane: int) -> bool:
        return bool(self.attempts[lane] >= self.max_retries)

    def rollback(self, carry, lane: int, step: int, reason: str):
        """Roll ONE lane back to the rolling snapshot with dt halved per
        attempt.  Returns (carry', snap_step, snap_left); the lane's epoch
        bump drops every in-flight row of the abandoned trajectory."""
        if self.snap is None:
            raise RuntimeError("lane rollback requested before any snapshot")
        self.attempts[lane] += 1
        self.fail_step[lane] = max(self.fail_step[lane], int(step))
        self.epochs[lane] += 1
        self.rollbacks += 1
        mask = np.zeros(self.B, bool)
        mask[lane] = True
        scale = 0.5 ** int(self.attempts[lane])
        M.counter("fleet.lane_rollbacks", reason=reason).inc()
        out = restore_lanes(carry, self.snap, mask, scale)
        return out, int(self.snap_step[lane]), int(self.snap_left[lane])

    def reseed(self, carry, lane: int, nsteps: int) -> None:
        """A freed lane was respliced with a fresh job (``carry`` the
        post-upload batched carry): the epoch bump drops the previous
        occupant's in-flight rows, the retry budget resets, and the
        lane's rows of the rolling snapshot are refreshed to the new
        job's state (other lanes' snapshot rows keep their bits)."""
        self.epochs[lane] += 1
        self.attempts[lane] = 0
        self.fail_step[lane] = -1
        if self.snap is not None:
            mask = np.zeros(self.B, bool)
            mask[lane] = True
            self.snap = _select_lanes(_mask_on(mask, carry[LEFT]), carry,
                                      self.snap)
        self.snap_step[lane] = 0
        self.snap_left[lane] = int(nsteps)

    def resume(self, carry, lane: int, step: int, left: int) -> None:
        """A recovered or migrated job was respliced mid-flight: as
        :meth:`reseed`, with the host mirrors at the resumed position."""
        self.reseed(carry, lane, left)
        self.snap_step[lane] = int(step)
        self.snap_left[lane] = int(left)

    def give_up(self, carry, lane: int, reason: str):
        """Retire a lane that exhausted its retries: freeze its carry
        (left = 0) and bump its epoch so stale rows drop."""
        self.epochs[lane] += 1
        mask = np.zeros(self.B, bool)
        mask[lane] = True
        M.counter("fleet.lane_giveups", reason=reason).inc()
        return retire_lanes(carry, mask)
