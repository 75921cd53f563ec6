"""Streaming QoI layer: grouped, deferred device->host reads with
counters, backpressure and per-config pack slimming (port of
``cup3d_tpu/stream/qoi.py``).

Reading one QoI pack a step synchronises the host with the device once a
step.  The pipelined drivers instead emit per-step packs into a
:class:`QoIStream`, which every ``read_every`` packs concatenates them ON
THE DEVICE into one vector, copies it into a pinned host buffer with
``non_blocking=True`` and records a CUDA event behind the copy.  A group
is consumed once its event has completed (``poll``, at every emit) or,
under backpressure, when the stream waits on it: nothing blocks until
``max_inflight`` groups are outstanding, and the only blocking wait is
the device falling ``max_inflight * read_every`` steps behind the host.
Entries are applied strictly FIFO by the driver's consume callback, on
the main thread.  On CPU tensors the copy is the tensor itself and every
group is ready at once.

Host-mirror staleness is bounded by ~(1 + max_inflight) * read_every
steps; the driver's dt policy guards stability against the stale max|u|
(a 1.5x margin and a 1.03x growth bound on the host chain, or the device
dt chain).

The counters (``stats``: packs emitted and consumed, groups started and
read, bytes streamed and staged, stall and read seconds, peak groups in
flight) are seen by ``obs.metrics.snapshot()`` as
``stream.<key>{stream=<name>}``.
The ``stream.stall`` fault (resilience/faults.py) fires at ``emit``.
"""

from __future__ import annotations

import weakref
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.analysis.runtime import sanctioned_transfer
from cup3d_tpu_torch.obs.trace import now as obs_now


class PackPolicy:
    """Which parts of a step's QoI pack ride the stream.

    ``max_part_elems`` drops any part larger than that many elements
    (0/None = keep all); the parts named in ``REQUIRED`` always ship (the
    dt chain's ``umax``, the rigid mirrors, the megaloop's rows).  Dropped
    parts never leave the device; their bytes are counted in
    ``bytes_dropped``.
    """

    REQUIRED = ("umax", "rigid", "scan")

    def __init__(self, max_part_elems: int = 0):
        self.max_part_elems = int(max_part_elems or 0)

    def admits(self, name: str, size: int) -> bool:
        if name in self.REQUIRED:
            return True
        return not (self.max_part_elems and size > self.max_part_elems)

    @classmethod
    def for_cells(cls, ncells: int, slim_at: int = 2**24) -> "PackPolicy":
        """At 256^3-class resolutions (>= ``slim_at`` cells) ship only QoI
        scalars and small mirrors; below that, everything rides."""
        if ncells >= slim_at:
            return cls(max_part_elems=4096)
        return cls()


class _HostCopy:
    """One group on its way to the host: a pinned buffer filled by a
    non_blocking copy and the CUDA event recorded behind it (the group
    itself on the CPU)."""

    def __init__(self, batch: torch.Tensor):
        batch = batch.detach()
        self.nbytes = batch.numel() * batch.element_size()
        self.event = None
        with sanctioned_transfer("stream-copy"):
            if batch.is_cuda:
                self.host = torch.empty(batch.shape, dtype=batch.dtype,
                                        pin_memory=True)
                self.host.copy_(batch, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
            else:
                self.host = batch

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def values(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().astype(np.float64)


class QoIStream:
    """Grouped async device->host QoI reader.

    entries: dicts with a ``pack`` device vector and a ``layout`` of
    (name, size) pairs; ``consume(entry)`` is called with
    ``entry['vals']`` filled, in emission order.
    """

    def __init__(self, consume: Callable[[dict], None], read_every: int = 4,
                 max_inflight: int = 2,
                 policy: Optional[PackPolicy] = None,
                 profiler=None, name: str = "qoi"):
        self.consume = consume
        self.read_every = read_every
        self.max_inflight = max_inflight
        self.policy = policy or PackPolicy()
        self.profiler = profiler
        self.name = name
        self.queue: List[dict] = []
        self._inflight: List[dict] = []  # {batch: _HostCopy, group} FIFO
        self.stats = self._zero_stats()
        from cup3d_tpu_torch.obs import metrics as obs_metrics

        def _collect(ref=weakref.ref(self)):
            st = ref()
            if st is None:
                return {}
            return {f"stream.{k}{{stream={st.name}}}": v
                    for k, v in st.snapshot().items()}

        obs_metrics.register_collector(_collect, owner=self)

    @staticmethod
    def _zero_stats() -> dict:
        return {
            "packs_emitted": 0,
            "packs_consumed": 0,
            "packs_abandoned": 0,
            "groups_started": 0,
            "groups_read": 0,
            "parts_dropped": 0,
            "bytes_streamed": 0,
            "bytes_dropped": 0,
            "stall_s": 0.0,
            "read_s": 0.0,
            "inflight_peak": 0,
            "kicks": 0,
            "bytes_staged": 0,
        }

    def reset_stats(self) -> None:
        """Zero the counters (a timed window's start); the queue and the
        groups in flight stay."""
        self.stats = self._zero_stats()

    def snapshot(self) -> dict:
        """Counters plus the instantaneous queue state."""
        out = dict(self.stats)
        out["groups_inflight"] = len(self._inflight)
        out["packs_queued"] = len(self.queue)
        return out

    def __bool__(self):
        return bool(self.queue or self._inflight)

    # -- emission ----------------------------------------------------------

    def pack_parts(self, parts: Sequence[Tuple[str, torch.Tensor]], dtype,
                   **meta) -> dict:
        """(name, device vector) parts -> one entry, the slimming policy
        applied BEFORE the device concat so dropped parts never leave the
        device.  Non-pipelined callers hand the entry straight to their
        consume callback, which reads ``entry['pack']``."""
        kept = []
        for name, arr in parts:
            arr = arr.reshape(-1)
            if self.policy.admits(name, int(arr.shape[0])):
                kept.append((name, arr))
            else:
                self.stats["parts_dropped"] += 1
                self.stats["bytes_dropped"] += (
                    int(arr.shape[0]) * torch.finfo(dtype).bits // 8)
        pack = torch.cat([a.to(dtype) for _, a in kept])
        entry = {"layout": [(n, int(a.shape[0])) for n, a in kept],
                 "pack": pack}
        entry.update(meta)
        return entry

    def emit(self, entry: dict) -> None:
        from cup3d_tpu_torch.resilience import faults

        # stream.stall seam: a simulated stall lands in the stream's own
        # stall accounting
        t0 = obs_now()
        if faults.maybe_stall(step=entry.get("step")):
            self.stats["stall_s"] += obs_now() - t0
        self.queue.append(entry)
        self.stats["packs_emitted"] += 1
        self.poll()
        if len(self.queue) >= self.read_every:
            if len(self._inflight) >= self.max_inflight:
                # backpressure: the device is a full window behind the
                # host; the wait is device catch-up, not host-read cost
                ctx = (self.profiler("StreamWait")
                       if self.profiler is not None else nullcontext())
                with ctx:
                    while len(self._inflight) >= self.max_inflight:
                        self._consume_one()
            self.kick()

    def kick(self) -> None:
        """Group everything queued NOW into one device batch and start its
        host copy.  A kick at the ``max_inflight`` limit is skipped: only
        emit()'s backpressure may wait."""
        if not self.queue or len(self._inflight) >= self.max_inflight:
            return
        group, self.queue = self.queue, []
        batch = _HostCopy(torch.cat([e["pack"] for e in group]))
        self._inflight.append({"batch": batch, "group": group})
        self.stats["kicks"] += 1
        self.stats["groups_started"] += 1
        self.stats["bytes_streamed"] += batch.nbytes
        self.stats["inflight_peak"] = max(self.stats["inflight_peak"],
                                          len(self._inflight))

    # -- staging (device->host traffic outside the packs) -----------------

    def stage(self, x: torch.Tensor) -> "_HostCopy":
        """Start an async host copy of ``x`` (the AMR driver's scores
        prefetch) and count its bytes in ``bytes_staged``.  The caller
        reads it later with ``.values()``, which waits on the copy's
        event (free once it has landed)."""
        copy = _HostCopy(x)
        self.stats["bytes_staged"] += copy.nbytes
        return copy

    # -- consumption -------------------------------------------------------

    def _consume_one(self) -> None:
        """Read the oldest in-flight group (blocking only if its copy has
        not landed) and apply its entries FIFO; the wait is timed into
        ``read_s`` when the group had landed and ``stall_s`` when not."""
        holder = self._inflight.pop(0)
        was_ready = self._ready(holder["batch"]) is True
        ctx = (self.profiler("StreamRead" if was_ready else "StreamWait")
               if self.profiler is not None else nullcontext())
        t0 = obs_now()
        with ctx:
            vals = holder["batch"].values()
        self.stats["read_s" if was_ready else "stall_s"] += (
            obs_now() - t0)
        self.stats["groups_read"] += 1
        off = 0
        for entry in holder["group"]:
            size = sum(s for _, s in entry["layout"])
            entry["vals"] = vals[off:off + size]
            off += size
            self.consume(entry)
            self.stats["packs_consumed"] += 1

    @staticmethod
    def _ready(batch):
        """True when the group's copy has landed (its event completed)."""
        return batch.is_ready()

    def poll(self) -> None:
        """Consume landed groups without blocking (strictly FIFO: stop at
        the first that has not landed)."""
        while self._inflight and self._ready(
                self._inflight[0]["batch"]) is True:
            self._consume_one()

    def join(self) -> None:
        """Consume ALL in-flight groups (blocking)."""
        while self._inflight:
            self._consume_one()

    def flush(self) -> None:
        """Drain everything: in-flight groups, then still-queued packs."""
        self.join()
        while self.queue:
            entry = self.queue.pop(0)
            self.consume(entry)
            self.stats["packs_consumed"] += 1

    def abandon(self) -> None:
        """Drop every queued pack and in-flight group WITHOUT consuming
        them (a recovery rollback: mirrors from the abandoned trajectory
        must never apply to the restored state)."""
        n = len(self.queue) + sum(len(h["group"]) for h in self._inflight)
        self.queue = []
        self._inflight = []
        self.stats["packs_abandoned"] += n
