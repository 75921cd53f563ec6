"""Off-critical-path checkpoints (port of ``cup3d_tpu/stream/checkpoint.py``):
async device snapshots, background serialization, files that
``io/checkpoint.py`` of either package restores.

A save splits into:

1. **snapshot** (main thread, no blocking read): ``io.checkpoint
   .build_payload`` captures the field tensors and every host scalar;
   each field is snapshotted into a FRESH device buffer and staged to
   pinned host memory behind a CUDA event (``stream.dump.StagedTensor``).
   The port's operators replace their state tensors rather than write
   into them, but the snapshot does not rely on it: with the live
   reference, any later in-place write would reach the writer thread
   (the JAX package records the flake this caused on the TPU, where the
   step donated its buffers).  The obstacles are deep-frozen by a pickle
   round trip, since their host state keeps changing;
2. **write** (background thread): wait for the staged copies and pickle
   the exact ``io/checkpoint.py`` payload (same FORMAT_VERSION, same
   keys).

``max_pending`` bounds host memory: a save issued while the previous one
is still writing joins it first.  A failed background write is latched,
re-raised by the next ``save()`` or by ``wait()``, and visible through
``health()``.
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from cup3d_tpu_torch.io.checkpoint import (
    build_payload,
    checkpoint_path,
    materialize_payload,
    write_payload,
)
from cup3d_tpu_torch.stream.dump import StagedTensor
from cup3d_tpu_torch.obs.trace import now as obs_now


class AsyncCheckpointer:
    def __init__(self, max_pending: int = 1):
        self.max_pending = max_pending
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List = []
        # the FIRST background failure, propagated by the next
        # save()/wait() and visible through health()
        self._failed: Optional[BaseException] = None
        self.stats = {"saves": 0, "snapshot_s": 0.0, "write_s": 0.0,
                      "write_failures": 0}
        import weakref

        from cup3d_tpu_torch.obs import metrics as obs_metrics

        def _collect(ref=weakref.ref(self)):
            c = ref()
            if c is None:
                return {}
            return {f"checkpoint.{k}": v for k, v in c.stats.items()}

        obs_metrics.register_collector(_collect, owner=self)

    def _reap_done(self) -> None:
        """Retire completed write futures, latching the first failure."""
        still = []
        for fut in self._pending:
            if not fut.done():
                still.append(fut)
                continue
            try:
                fut.result()
            except Exception as e:
                if self._failed is None:
                    self._failed = e
        self._pending = still

    def health(self) -> dict:
        """{ok, pending, saves, write_failures, error}: ``ok`` is False
        while an unpropagated background failure is latched."""
        self._reap_done()
        return {
            "ok": self._failed is None,
            "pending": len(self._pending),
            "saves": self.stats["saves"],
            "write_failures": self.stats["write_failures"],
            "error": repr(self._failed) if self._failed else None,
        }

    def save(self, driver, path: Optional[str] = None) -> str:
        """Snapshot ``driver`` now; write in the background.  Returns the
        checkpoint path (the file lands when the write completes).  A
        failure of a PREVIOUS background write is re-raised here (and
        cleared) before any new snapshot."""
        self._reap_done()
        if self._failed is not None:
            err, self._failed = self._failed, None
            raise err
        t0 = obs_now()
        payload = build_payload(driver)
        payload["obstacles"] = pickle.loads(pickle.dumps(
            payload["obstacles"], protocol=pickle.HIGHEST_PROTOCOL))
        payload["fields"] = {k: StagedTensor(v)
                             for k, v in payload["fields"].items()}
        if path is None:
            path = checkpoint_path(driver.cfg.path4serialization,
                                   payload["step"])
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="cup3d-ckpt")
        while len(self._pending) >= self.max_pending:
            self._pending.pop(0).result()
        self._pending.append(self._pool.submit(self._write, payload, path))
        self.stats["saves"] += 1
        # the host staging cost the step loop pays
        self.stats["snapshot_s"] += obs_now() - t0
        return path

    def _write(self, payload: dict, path: str) -> str:
        t0 = obs_now()
        try:
            payload = dict(payload, fields={
                k: v.numpy() for k, v in payload["fields"].items()})
            out = write_payload(materialize_payload(payload), path)
        except Exception:
            self.stats["write_failures"] += 1
            raise  # latched by _reap_done, surfaced by save()/wait()
        self.stats["write_s"] += obs_now() - t0
        return out

    def wait(self) -> None:
        """Join all pending writes; re-raise the FIRST failure, including
        one latched from an earlier, already reaped write."""
        pending, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for fut in pending:
            try:
                fut.result()
            except Exception as e:
                if first is None:
                    first = e
        if first is None and self._failed is not None:
            first, self._failed = self._failed, None
        if first is not None:
            raise first

    def __bool__(self):
        return bool(self._pending)


def save_guarded(checkpointer: AsyncCheckpointer, driver) -> None:
    """A driver's periodic checkpoint with the degradation policy: under
    recovery (``driver._resilience`` set), a failed background write
    (surfaced by the checkpointer at the NEXT save) falls back to ONE
    synchronous atomic write; if that fails too the checkpoint is dropped
    and counted.  Without recovery the failure propagates."""
    from cup3d_tpu_torch.io.checkpoint import save_checkpoint
    from cup3d_tpu_torch.obs import metrics as obs_metrics

    try:
        checkpointer.save(driver)
    except Exception:
        if driver._resilience is None:
            raise
        obs_metrics.counter("resilience.ckpt_sync_fallbacks").inc()
        try:
            save_checkpoint(driver)
        except Exception:
            obs_metrics.counter("resilience.ckpt_dropped").inc()


def drain(dumper, checkpointer: AsyncCheckpointer, driver) -> None:
    """Join a driver's pending dumps and checkpoints.  Under recovery a
    failed final checkpoint write does not fail an otherwise complete
    run: it is dropped and counted.  Then a still-open capture window
    closes and is harvested before the trace flush, so its device record
    lands in this trace."""
    from cup3d_tpu_torch.obs import metrics as obs_metrics
    from cup3d_tpu_torch.obs import trace as obs_trace

    dumper.wait()
    try:
        checkpointer.wait()
    except Exception:
        if driver._resilience is None:
            raise
        obs_metrics.counter("resilience.ckpt_dropped").inc()
    driver._obs_profile.finish()
    obs_trace.TRACE.flush()
