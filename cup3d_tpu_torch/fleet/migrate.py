"""Live lane migration and graceful drain (port of
``cup3d_tpu/fleet/migrate.py``).

A running lane's carry is host-serializable (the journal snapshot path)
and re-enters through the per-lane reseed upload
(fleet/batch.reseed_lane_carry), so a RUNNING job can be checkpointed off
server A and finished on server B with bitwise-identical QoI bytes,
provided B resumes it in a batch of the same recorded (cap, K): the lane
count shapes the batched advance.  :func:`migrate_job` does exactly
that: ``FleetBatch.release_for_migration`` on the source (settle,
host-copy, freeze the lane, retire MIGRATED), then
``FleetServer._resume_batches`` on the destination (rebuild at the
recorded shape, splice the carry back in, restore the recorded rows).

:func:`drain_for_shutdown` is the graceful exit: close admission, move
every RUNNING job to the target server (or, with no target, journal a
final settled snapshot per lane so a later ``recover()`` resumes them),
and report what went where.  Queued jobs are already durable (their
submit records are in the journal).

The checkpoint payload is the journal snapshot view, so migration and
crash recovery share one resume path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from cup3d_tpu_torch.fleet.server import (
    QUEUED,
    RUNNING,
    FleetJob,
    FleetServer,
)
from cup3d_tpu_torch.obs import metrics as M


def checkpoint_job(server: FleetServer, job_id: str) -> dict:
    """Checkpoint one RUNNING job off ``server``: the lane settles,
    its carry + rows are host-serialized, the lane freezes, and the
    job retires MIGRATED (terminal on the source; the journal terminal
    record remembers the handoff).  Returns the resume payload."""
    job = server._jobs[job_id]
    if job.status != RUNNING or job.batch is None:
        raise ValueError(
            f"{job_id} is {job.status!r}, not a running lane")
    return job.batch.release_for_migration(job.lane)


def admit_checkpoint(server: FleetServer, ckpt: dict) -> str:
    """Install a migrated checkpoint on ``server`` and resume it
    mid-flight under its original job id.  The destination journals
    the admission like a fresh submit, so a crash AFTER migration
    recovers the job here, not on the (drained) source."""
    job_id = str(ckpt["job_id"])
    if job_id in server._jobs:
        raise ValueError(f"{job_id} already exists on the target server")
    job = FleetJob(
        job_id=job_id, tenant=str(ckpt["tenant"]),
        spec=dict(ckpt["spec"]), nsteps=int(ckpt["nsteps"]))
    job.mark("submitted")
    job.mark("queued")
    job.mark("recovered")
    server._note_job_id(job_id)
    server._jobs[job_id] = job
    server._journal("submit", job_id=job_id, tenant=job.tenant,
                    spec=dict(ckpt["spec"]), nsteps=job.nsteps)
    server._resume_batches([(job, ckpt)])
    server.migrations += 1
    M.counter("fleet.migrations").inc()
    return job_id


def migrate_job(src: FleetServer, dst: FleetServer, job_id: str) -> str:
    """Move one RUNNING job from ``src`` to ``dst`` live: checkpoint
    off A, reseed onto B, bitwise (the contract).  The source
    keeps a MIGRATED terminal under the id; the destination runs the
    job to completion under the same id."""
    return admit_checkpoint(dst, checkpoint_job(src, job_id))


def drain_for_shutdown(src: FleetServer,
                       target: Optional[FleetServer] = None
                       ) -> Dict[str, List[str]]:
    """Graceful exit: stop admission, migrate every RUNNING job to
    ``target`` (or journal a final settled snapshot per lane when no
    target is given, so a restart's ``recover()`` resumes them), and
    quiesce the compile service.  Returns ``{"migrated": [...],
    "journaled": [...], "queued": [...]}`` job-id lists."""
    src.close_admission()
    for b in src.batches:
        if b.active():
            b.settle()
    migrated: List[str] = []
    journaled: List[str] = []
    if target is not None:
        running = [j.job_id for j in src._jobs.values()
                   if j.status == RUNNING and j.batch is not None]
        for job_id in running:
            migrate_job(src, target, job_id)
            migrated.append(job_id)
    else:
        for b in src.batches:
            b.settle()
            b.journal_snapshots()
        journaled = [j.job_id for j in src._jobs.values()
                     if j.status == RUNNING]
    src._aot_quiesce()
    queued = [j.job_id for j in src._jobs.values()
              if j.status == QUEUED]
    M.counter("fleet.drains").inc()
    return {"migrated": migrated, "journaled": journaled,
            "queued": queued}
