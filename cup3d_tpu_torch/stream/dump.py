"""Sharded multi-writer field dumps with async device->host staging (port
of ``cup3d_tpu/stream/dump.py``).

The reference writes snapshots through collective MPI-IO: every rank
computes its byte offset with ``MPI_Exscan`` and writes its own extent
with ``MPI_File_write_at_all`` (main.cpp:429-553).  This is the
single-host analogue:

- the cell range is split into contiguous extents, one per shard;
- byte offsets are an exclusive scan (``_exscan``) of the per-shard byte
  counts, so every shard writes independently;
- shards write concurrently with ``os.pwrite`` into a preallocated file,
  each expanding its own slice of the 8-vertex hexahedron geometry (the
  whole vertex array at 256^3 is ~1.6 GB);
- the coordinator writes one XDMF index per attribute, so the output is
  byte-identical to ``io.dump.dump_fields``.

:class:`AsyncDumper` takes it off the step loop: ``submit()`` stages each
field with a device ``clone()`` (a later in-place update of the live
tensor cannot reach the snapshot) and a ``non_blocking`` copy into pinned
host memory behind a CUDA event (:class:`StagedTensor`), and queues one
write job; a writer thread waits on the events and runs the sharded
write while the step loop goes on.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cup3d_tpu_torch.io.dump import _CORNERS, _XDMF, cell_geometry
from cup3d_tpu_torch.obs.trace import now as obs_now


class StagedTensor:
    """A snapshot of a tensor (or array) on its way to the host.  A CUDA
    tensor is cloned on the device and copied with ``non_blocking=True``
    into a pinned host buffer, a CUDA event recorded behind the copy; a
    CPU tensor or an array is copied at once.  :meth:`numpy` (any thread)
    waits on the event and returns the host array."""

    def __init__(self, value):
        self._event = None
        self._dev = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            self._dev = value.detach().clone()
            self._host = torch.empty(self._dev.shape, dtype=self._dev.dtype,
                                     pin_memory=True)
            self._host.copy_(self._dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        elif isinstance(value, torch.Tensor):
            self._host = value.detach().clone()
        else:
            self._host = np.array(value, copy=True)

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._dev = None  # the device copy may go now
        h = self._host
        return h.numpy() if isinstance(h, torch.Tensor) else h


#: cells a geometry job expands at once (its float64 temporary is 192
#: bytes a cell): bounds a writer's memory whatever the shard count
GEOM_CHUNK = 1 << 20


def _auto_shards() -> int:
    n = os.cpu_count() or 1
    return max(1, min(8, n))


def _extents(ncell: int, nshards: int) -> List[Tuple[int, int]]:
    """Split [0, ncell) into <= nshards contiguous, near-equal extents."""
    nshards = max(1, min(nshards, ncell)) if ncell else 1
    bounds = np.linspace(0, ncell, nshards + 1, dtype=np.int64)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a]


def _exscan(counts: Sequence[int]) -> List[int]:
    """Exclusive scan of byte counts -> per-shard file offsets (the
    single-host MPI_Exscan)."""
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += int(c)
    return out


def _pwrite_extents(path: str, jobs: List[Tuple[int, "object"]],
                    total_bytes: int, pool: Optional[ThreadPoolExecutor]):
    """Preallocate ``path`` to ``total_bytes`` and write each (offset,
    make_bytes) extent, concurrently when a pool is given.  Each shard
    produces ITS OWN bytes inside its worker (callable jobs), so no
    single thread materializes the whole file.  An extent is any
    contiguous buffer: ``os.pwrite`` reads it in place, without the GIL."""
    with open(path, "wb") as f:
        f.truncate(total_bytes)
    fd = os.open(path, os.O_WRONLY)

    def write_one(job):
        off, make = job
        buf = memoryview(make() if callable(make) else make).cast("B")
        while buf:  # one pwrite moves at most ~2 GiB on Linux
            n = os.pwrite(fd, buf, off)
            buf, off = buf[n:], off + n

    try:
        if pool is None:
            for job in jobs:
                write_one(job)
        else:
            list(pool.map(write_one, jobs))
    finally:
        os.close(fd)


def dump_fields_sharded(
    prefix: str,
    time_: float,
    grid,
    fields: Dict[str, np.ndarray],
    nshards: int = 0,
) -> dict:
    """Sharded-writer twin of ``io.dump.dump_fields``: identical files
    (same names, same bytes), written as concurrent per-extent
    ``pwrite``s.  Returns {bytes_written, shards, files}."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    if nshards <= 0:
        nshards = _auto_shards()
    origin, h = cell_geometry(grid)
    ncell = origin.shape[0]
    extents = _extents(ncell, nshards)
    pool = ThreadPoolExecutor(len(extents)) if len(extents) > 1 else None
    bytes_written = 0
    files = []
    try:
        # atomic promotion: every file is written to <path>.tmp and
        # os.replace'd into place, so a kill mid-dump leaves no truncated
        # raw or index; each shard expands ITS cells to 8 float32
        # vertices inside its writer
        xyz_path = f"{prefix}.xyz.raw"
        item = 8 * 3 * 4  # bytes per cell
        offs = _exscan([(b - a) * item for a, b in extents])

        def geom_bytes(a, b):
            def make():
                return (origin[a:b, None, :]
                        + _CORNERS[None, :, :] * h[a:b, None, None]
                        ).astype(np.float32)
            return make

        jobs = [(off + (c - a) * item, geom_bytes(c, min(c + GEOM_CHUNK, b)))
                for (a, b), off in zip(extents, offs)
                for c in range(a, b, GEOM_CHUNK)]
        _pwrite_extents(f"{xyz_path}.tmp", jobs, ncell * item, pool)
        os.replace(f"{xyz_path}.tmp", xyz_path)
        bytes_written += ncell * item
        files.append(xyz_path)

        for name, arr in fields.items():
            a = np.ascontiguousarray(arr, np.float32).reshape(-1)
            if a.size != ncell:
                raise ValueError(
                    f"field {name}: {a.size} values vs {ncell} cells"
                )
            attr_path = f"{prefix}.{name}.attr.raw"
            offs = _exscan([(hi - lo) * 4 for lo, hi in extents])
            jobs = [(off, a[lo:hi]) for (lo, hi), off in zip(extents, offs)]
            _pwrite_extents(f"{attr_path}.tmp", jobs, ncell * 4, pool)
            os.replace(f"{attr_path}.tmp", attr_path)
            bytes_written += ncell * 4
            files.append(attr_path)
            xdmf_path = f"{prefix}.{name}.xdmf2"
            with open(f"{xdmf_path}.tmp", "w") as f:
                f.write(
                    _XDMF.format(
                        time=time_,
                        ncell=ncell,
                        nvert=8 * ncell,
                        name=name,
                        xyz=os.path.basename(xyz_path),
                        attr=os.path.basename(attr_path),
                    )
                )
            # the index is promoted LAST: it only ever names complete raws
            os.replace(f"{xdmf_path}.tmp", xdmf_path)
            files.append(xdmf_path)
    finally:
        if pool is not None:
            pool.shutdown()
    return {"bytes_written": bytes_written, "shards": len(extents),
            "files": files}


class AsyncDumper:
    """Off-critical-path snapshot writer.

    ``submit()`` stages the fields (:class:`StagedTensor`) and queues one
    background write job; the step loop continues at once.  The writer
    thread waits for the staged copies and runs the sharded dump.
    ``wait()`` joins all pending writes; drivers call it at run end and
    before anything that must observe the files on disk.

    A write that still fails after ``retries`` retries is DROPPED and
    counted (``dropped``, the ``dump.write_dropped`` counter): snapshots
    are lossy telemetry and output never kills the step loop; the last
    error stays visible through :meth:`health`.  ``max_pending`` bounds
    host memory: a submit beyond it joins the oldest write first.

    ``nshards`` defaults to 1 here (the JAX package's to one shard a
    core, up to 8): the port's step loop is a Python thread launching
    kernels, and every further writer thread taking and dropping the GIL
    around its numpy work delays that thread (chip_smoke.py phase 18
    times a dump in the step window under both).  The one writer still
    writes its extents at their exclusive-scan offsets.
    """

    def __init__(self, nshards: int = 1, max_pending: int = 2,
                 retries: int = 2):
        self.nshards = nshards
        self.max_pending = max_pending
        self.retries = retries
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List = []
        self._last_error: Optional[BaseException] = None
        self.stats = {"dumps": 0, "bytes_written": 0, "write_s": 0.0,
                      "submit_s": 0.0, "write_failures": 0, "dropped": 0}
        # per-instance stats surfaced process-wide through the obs
        # registry (weakref collector; equal keys from live dumpers sum)
        import weakref

        from cup3d_tpu_torch.obs import metrics as obs_metrics

        def _collect(ref=weakref.ref(self)):
            d = ref()
            if d is None:
                return {}
            return {f"dump.{k}": v for k, v in d.stats.items()}

        obs_metrics.register_collector(_collect, owner=self)

    def health(self) -> dict:
        """{ok, pending, dumps, dropped, write_failures, error}: ``ok`` is
        False once a dump has been dropped."""
        return {
            "ok": self.stats["dropped"] == 0,
            "pending": len(self._pending),
            "dumps": self.stats["dumps"],
            "dropped": self.stats["dropped"],
            "write_failures": self.stats["write_failures"],
            "error": repr(self._last_error) if self._last_error else None,
        }

    def submit(self, prefix: str, time_: float, grid,
               fields: Dict[str, object], step=None) -> None:
        t0 = obs_now()
        staged = {name: StagedTensor(arr) for name, arr in fields.items()}
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="cup3d-dump")
        while len(self._pending) >= self.max_pending:
            self._pending.pop(0).result()
        self._pending.append(
            self._pool.submit(self._write, prefix, time_, grid, staged, step))
        self.stats["dumps"] += 1
        # the host staging cost the step loop pays (the copies run on)
        self.stats["submit_s"] += obs_now() - t0

    def _write(self, prefix, time_, grid, staged, step=None):
        t0 = obs_now()
        host = {k: v.numpy() for k, v in staged.items()}
        from cup3d_tpu_torch.resilience import faults, writeguard

        out = None
        for attempt in range(self.retries + 1):
            if attempt:
                writeguard.backoff_sleep(attempt)
            try:
                # the dump.write_fail seam: fires per attempt while armed
                faults.maybe_raise("dump.write_fail", step)
                out = dump_fields_sharded(prefix, time_, grid, host,
                                          nshards=self.nshards)
                break
            except Exception as e:
                self.stats["write_failures"] += 1
                self._last_error = e
        if out is None:
            # retries exhausted: drop and count, never crash the step loop
            self.stats["dropped"] += 1
            from cup3d_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.counter("dump.write_dropped").inc()
            return None
        self.stats["bytes_written"] += out["bytes_written"]
        self.stats["write_s"] += obs_now() - t0
        return out

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def __bool__(self):
        return bool(self._pending)
