"""Write-ahead job journal: the fleet's durability layer (port of
``cup3d_tpu/fleet/journal.py``; the same segment frame, record types and
reject taxonomy, so a journal written by either package replays in the
other).

A :class:`JobJournal` records every job lifecycle transition (submit,
placement into a batch lane, terminal) plus periodic host-serialized
lane-carry snapshots at K-boundaries, so a killed-and-restarted
``FleetServer`` (``FleetServer.recover()``) finishes every accepted job
with QoI bytes identical to a never-crashed run: terminal jobs are
remembered (their recorded rows ARE the bytes), queued jobs re-admitted,
RUNNING jobs resumed from their latest carry snapshot through the
per-lane reseed upload (fleet/batch.reseed_lane_carry).

Storage: one checksummed segment file per record, ``<seq>.jrec`` under
the journal root, written through ``resilience/writeguard.atomic_write``
(tmp + ``os.replace``, counted retries): a torn write leaves a tmp file,
never a half-promoted segment.  Each segment is
``MAGIC + blake2s(payload).hexdigest() + "\n" + pickle(payload)``; the
payload holds only Python scalars, dicts and numpy arrays.

A segment that fails to load is counted ``journal.rejects{reason}``
(``io`` / ``magic`` / ``truncated`` / ``checksum`` / ``unpickle`` /
``schema``) and skipped; replay continues with every healthy segment.
Appends are best effort: a write failure after the write guard's
retries (the ``journal.write_fail`` site fires inside the write seam) is
counted ``journal.append_failures`` and dropped.

Record types (``schema`` 1):

``submit``    job_id, tenant, spec, nsteps
``place``     job_id, batch_uid, lane, cap, K, kind
``snapshot``  job_id, batch_uid, cap, K, kind, lane, step, left,
              steps_done, time, rows[:steps_done], carry (host copies of
              the lane's carry leaves), taken at the settled K-boundary
              of the rollback snapshot
``terminal``  job_id, status, error, steps_done, time, nsteps, rows

Replay folds records seq-ascending, latest wins per job.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from collections import OrderedDict
from typing import Dict, List, Optional

from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.obs import trace as OT
from cup3d_tpu_torch.resilience import faults, writeguard

#: bump when record keys/meaning change; recovery rejects (reason
#: "schema") rather than misreads segments from another journal era
SCHEMA = 1

MAGIC = b"CUP3DJRN1\n"

#: record types a healthy journal may carry
RECORD_TYPES = ("submit", "place", "snapshot", "terminal")

#: statuses replay treats as terminal (mirrors fleet/server.py — kept
#: as literals so the journal never imports the server)
TERMINAL_STATUSES = ("done", "failed", "cancelled", "migrated")


class JournalReject(Exception):
    """One segment failed to load; ``reason`` matches the
    ``journal.rejects`` counter label."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class JobJournal:
    """Append-only checksummed segment store for job lifecycle records."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # continue numbering after the largest existing segment so a
        # recovered server appends AFTER the journal it replayed
        self._seq = 1 + max(
            (self._seq_of(name) for name in os.listdir(root)), default=-1)

    @staticmethod
    def _seq_of(name: str) -> int:
        if not name.endswith(".jrec"):
            return -1
        try:
            return int(name[:-5])
        except ValueError:
            # a foreign file in the journal dir is not a segment
            return -1

    def path_for(self, seq: int) -> str:
        return os.path.join(self.root, f"{seq:010d}.jrec")

    # -- append ------------------------------------------------------------

    def append(self, rtype: str, **fields) -> Optional[str]:
        """Write one record as a fresh segment; returns its path, or
        None when the write failed (counted, never raised — the serve
        loop outlives the journal disk)."""
        seq = self._seq
        rec = dict(fields)
        rec.update(schema=SCHEMA, seq=seq, type=str(rtype),
                   wall=OT.wall())
        inner = pickle.dumps(rec, protocol=4)
        blob = (MAGIC + hashlib.blake2s(inner).hexdigest().encode()
                + b"\n" + inner)

        def write(tmp: str, blob=blob, seq=seq) -> None:
            # the chaos site fires INSIDE the write seam: a 1-shot arm
            # is absorbed by writeguard's retry (counted
            # resilience.write_retries{site=fleet-journal}); a
            # wildcard arm exhausts the retries and surfaces below
            faults.maybe_raise("journal.write_fail", step=seq)
            with open(tmp, "wb") as f:
                f.write(blob)

        try:
            writeguard.atomic_write(self.path_for(seq), write,
                                    site="fleet-journal")
        except (OSError, faults.InjectedFault):
            M.counter("journal.append_failures", type=str(rtype)).inc()
            return None
        self._seq = seq + 1
        M.counter("journal.appends", type=str(rtype)).inc()
        return self.path_for(seq)

    # -- read / replay -----------------------------------------------------

    def _read_segment(self, path: str) -> dict:
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as exc:
            raise JournalReject("io") from exc
        if not blob.startswith(MAGIC):
            raise JournalReject("magic")
        rest = blob[len(MAGIC):]
        nl = rest.find(b"\n")
        if nl < 0 or not rest[nl + 1:]:
            raise JournalReject("truncated")
        digest, inner = rest[:nl], rest[nl + 1:]
        if hashlib.blake2s(inner).hexdigest().encode() != digest:
            raise JournalReject("checksum")
        try:
            rec = pickle.loads(inner)
        except Exception as exc:
            raise JournalReject("unpickle") from exc
        if (not isinstance(rec, dict) or rec.get("schema") != SCHEMA
                or rec.get("type") not in RECORD_TYPES
                or not isinstance(rec.get("seq"), int)):
            raise JournalReject("schema")
        return rec

    def records(self) -> List[dict]:
        """Every healthy record, seq-ascending; defective segments are
        counted ``journal.rejects{reason}`` and skipped."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            M.counter("journal.rejects", reason="io").inc()
            return []
        out: List[dict] = []
        for name in names:
            if not name.endswith(".jrec"):
                continue
            try:
                out.append(self._read_segment(
                    os.path.join(self.root, name)))
            except JournalReject as rej:
                M.counter("journal.rejects", reason=rej.reason).inc()
        out.sort(key=lambda r: r["seq"])
        return out

    def replay(self) -> "OrderedDict[str, dict]":
        """Fold the journal into one view per job (submission order,
        latest record wins): ``{job_id: {tenant, spec, nsteps, status,
        error, batch_uid, cap, K, snapshot, rows, steps_done, time}}``.
        ``status`` is "queued" until a place record, "running" after,
        and the terminal status after a terminal record; ``snapshot``
        is the latest snapshot record (or None)."""
        jobs: "OrderedDict[str, dict]" = OrderedDict()
        for rec in self.records():
            rtype = rec["type"]
            jid = rec.get("job_id")
            if not isinstance(jid, str):
                M.counter("journal.rejects", reason="schema").inc()
                continue
            if rtype == "submit":
                jobs.setdefault(jid, {
                    "tenant": rec.get("tenant", "unknown"),
                    "spec": rec.get("spec", {}),
                    "nsteps": int(rec.get("nsteps", 0)),
                    "status": "queued", "error": None,
                    "batch_uid": None, "cap": None, "K": None,
                    "snapshot": None, "rows": None,
                    "steps_done": 0, "time": 0.0,
                })
                continue
            view = jobs.get(jid)
            if view is None:
                # a place/snapshot/terminal with no submit: the submit
                # segment was rejected — remember what we can
                M.counter("journal.orphan_records", type=rtype).inc()
                view = jobs.setdefault(jid, {
                    "tenant": rec.get("tenant", "unknown"),
                    "spec": rec.get("spec", {}),
                    "nsteps": int(rec.get("nsteps", 0)),
                    "status": "queued", "error": None,
                    "batch_uid": None, "cap": None, "K": None,
                    "snapshot": None, "rows": None,
                    "steps_done": 0, "time": 0.0,
                })
            if rtype == "place":
                if view["status"] not in TERMINAL_STATUSES:
                    view["status"] = "running"
                view["batch_uid"] = rec.get("batch_uid")
                view["cap"] = rec.get("cap")
                view["K"] = rec.get("K")
            elif rtype == "snapshot":
                view["snapshot"] = rec
                view["batch_uid"] = rec.get("batch_uid")
                view["cap"] = rec.get("cap")
                view["K"] = rec.get("K")
            elif rtype == "terminal":
                view["status"] = rec.get("status", "failed")
                view["error"] = rec.get("error")
                view["rows"] = rec.get("rows")
                view["steps_done"] = int(rec.get("steps_done", 0))
                view["time"] = float(rec.get("time", 0.0))
                if rec.get("nsteps"):
                    view["nsteps"] = int(rec["nsteps"])
        return jobs

    # -- observability -----------------------------------------------------

    def state(self) -> dict:
        """Segment count + byte total for ``health()["durability"]``."""
        segments = 0
        nbytes = 0
        try:
            for name in os.listdir(self.root):
                if name.endswith(".jrec"):
                    segments += 1
                    try:
                        nbytes += os.path.getsize(
                            os.path.join(self.root, name))
                    except OSError:
                        M.counter("journal.rejects", reason="io").inc()
        except OSError:
            M.counter("journal.rejects", reason="io").inc()
        return {"root": self.root, "segments": segments,
                "bytes": nbytes, "next_seq": self._seq}
