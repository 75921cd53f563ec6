"""Background compile service (port of ``cup3d_tpu/aot/compiler.py``).

A cold signature on the fleet's admission path would stall the dispatch
thread for its whole build; with the service the scheduler submits the
build here, keeps the job queued, and goes on dispatching warm
signatures.  The worker thread runs the build, the scheduler finds it
done at its next pass (:meth:`CompileService.status`), and the job
assembles with no build time on the dispatch thread.  In the port the
build that costs is a cold ``amr_tgv`` forest's tables (fleet/server.py
``_tables_wait``); a lane-batched advance binds in microseconds and is
bound inline.

**The worker makes no CUDA call.**  A build produces host data (a forest
topology's tables, put into the store); the dispatch thread loads it
onto the device.  Streams and the caching allocator stay
single-threaded.

Tasks are keyed and deduplicated and popped by priority (the JAX
package's demand and speculative classes); a failed build parks its key
``failed`` so the scheduler builds inline (counted in
``aot.compile_failures``).

A build that is mostly Python (a forest topology's tables) would hold
the GIL against the dispatch thread's launches on the worker thread;
such builds go to :class:`HostProcess`, one helper process a service,
started at its first use and kept across drains (its start costs
seconds: an interpreter and torch), stopped by :meth:`close`, when the
service is collected, or when this process exits.  Its worker waits on
a pipe with the GIL released.

No wait here is unbounded: the worker waits in slices and retires when
idle (a submit restarts it), :meth:`wait` needs a timeout, :meth:`drain`
reaps a dead worker's orphans on every slice, :meth:`fail_stale` fails a
build that outlived its deadline, and a helper call past its deadline
kills the helper, so a scheduler parked on the service always comes back
to build inline.
"""

from __future__ import annotations

import heapq
import os
import pickle
import select
import struct
import subprocess
import sys
import threading
import weakref
from typing import Callable, Dict, Optional

from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.obs import trace as OT
from cup3d_tpu_torch.resilience import faults

PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

#: demand builds beat speculative ones in the priority heap (the JAX
#: package's classes; the fleet submits demand builds)
PRIORITY_DEMAND = 0
PRIORITY_SPECULATIVE = 10

#: seconds an idle worker waits for a task before it retires
IDLE_S = 30.0
#: the worker's wait slice (seconds)
SLICE_S = 0.25


#: seconds a build may take before :meth:`CompileService.fail_stale`
#: fails it (the JAX package's quiesce bound)
BUILD_TIMEOUT_S = 600.0


_HEAD = struct.Struct("<Q")


def _host_main() -> None:
    """The helper process's loop: length-prefixed pickled requests
    ``("module:function", args)`` on stdin, ``(ok, result or error,
    seconds the call took)`` replies on stdout, until stdin closes.  Only
    the port's functions are called."""
    import importlib

    inp, out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # stray prints must not corrupt the replies
    for mod in sys.argv[1:]:
        importlib.import_module(mod)
    while True:
        head = inp.read(_HEAD.size)
        if len(head) < _HEAD.size:
            return
        path, args = pickle.loads(inp.read(_HEAD.unpack(head)[0]))
        t0 = OT.now()
        try:
            if not path.startswith("cup3d_tpu_torch."):
                raise ValueError(f"{path} is not the port's")
            mod, name = path.split(":", 1)
            res = getattr(importlib.import_module(mod), name)(*args)
            reply = (True, res, OT.now() - t0)
        except Exception as e:
            reply = (False, repr(e), OT.now() - t0)
        blob = pickle.dumps(reply, protocol=4)
        out.write(_HEAD.pack(len(blob)) + blob)
        out.flush()


class HostProcess:
    """A persistent Python helper process for host builds (module doc):
    started at the first :meth:`call` (it imports the forest's table
    code once), reused by later calls, one call at a time, stopped by
    :meth:`stop` or when this process exits (its stdin closes).  The
    seconds from a start to the helper's first request (its interpreter
    and imports: most of a cold build's wait) land in :attr:`start_s` and
    the ``aot.helper_start_s`` histogram."""

    #: what the helper imports at start
    PRELOAD = ("cup3d_tpu_torch.sim.amr",)

    def __init__(self):
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._t_start: Optional[float] = None
        self.start_s: Optional[float] = None

    def _start(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            self._t_start = OT.now()
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ, OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH", "")) if p)
            self._proc = subprocess.Popen(
                [sys.executable, "-c", "from cup3d_tpu_torch.aot.compiler "
                 "import _host_main; _host_main()", *self.PRELOAD],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, env=env)
        return self._proc

    def _read(self, fd: int, n: int, deadline: float) -> bytes:
        buf = b""
        while len(buf) < n:
            left = deadline - OT.now()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                raise TimeoutError("host build past its deadline")
            chunk = os.read(fd, n - len(buf))
            if not chunk:
                raise RuntimeError("host build process exited")
            buf += chunk
        return buf

    def call(self, path: str, args: tuple, timeout: float):
        """``path(*args)`` ("module:function" of the port) in the helper;
        raises on its error, its death or the deadline (the helper is
        then stopped; the next call starts another)."""
        with self._lock:
            proc = self._start()
            deadline = OT.now() + float(timeout)
            try:
                blob = pickle.dumps((path, args), protocol=4)
                proc.stdin.write(_HEAD.pack(len(blob)) + blob)
                proc.stdin.flush()
                fd = proc.stdout.fileno()
                n = _HEAD.unpack(self._read(fd, _HEAD.size, deadline))[0]
                ok, res, call_s = pickle.loads(self._read(fd, n, deadline))
            except Exception:
                self._stop_locked()
                raise
            if self._t_start is not None:
                # the first reply of this start: its wall less the call
                self.start_s = OT.now() - self._t_start - call_s
                self._t_start = None
                M.histogram("aot.helper_start_s").observe(self.start_s)
        if not ok:
            raise RuntimeError(f"host build failed: {res}")
        return res

    def _stop_locked(self) -> None:
        proc, self._proc = self._proc, None
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()

    def stop(self) -> None:
        with self._lock:
            self._stop_locked()


class CompileService:
    """One daemon worker draining a keyed priority queue of builds, and
    its helper process for host builds (:attr:`host`)."""

    def __init__(self, name: str = "aot-compile"):
        self.name = str(name)
        self._cv = threading.Condition()
        self._heap = []  # (priority, seq, key)
        self._seq = 0
        self._tasks: Dict[object, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self.host = HostProcess()
        weakref.finalize(self, self.host.stop)

    # -- submission ----------------------------------------------------------

    def submit(self, key, build: Callable[[], object],
               name: str = "exec",
               priority: int = PRIORITY_DEMAND,
               jobs=None) -> bool:
        """Enqueue ``build`` under ``key`` (dedup: a key already
        pending/running/done is left alone; a failed key may be
        resubmitted).  ``jobs``: the FleetJob ids parked on this build;
        they ride the task into the pid-5 compile span and its flow
        arrows.  Returns True when actually enqueued."""
        with self._cv:
            task = self._tasks.get(key)
            if task is not None and task["status"] != FAILED:
                return False
            self._tasks[key] = {"status": PENDING, "build": build,
                                "name": str(name), "result": None,
                                "priority": int(priority),
                                "jobs": list(jobs or []),
                                "t_submit": OT.now(), "t_start": None}
            heapq.heappush(self._heap, (int(priority), self._seq, key))
            self._seq += 1
            self._ensure_worker()
            self._cv.notify_all()
        M.counter(
            "aot.compile_submits",
            kind="speculative" if priority >= PRIORITY_SPECULATIVE
            else "demand").inc()
        self._update_depth()
        return True

    def attach(self, key, jobs) -> None:
        """Merge more waiting-job ids onto an in-flight build."""
        with self._cv:
            task = self._tasks.get(key)
            if task is None or task["status"] in (DONE, FAILED):
                return
            have = task.setdefault("jobs", [])
            for j in jobs:
                if j not in have:
                    have.append(j)

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=self.name, daemon=True)
            self._thread.start()

    # -- queries -------------------------------------------------------------

    def status(self, key) -> Optional[str]:
        with self._cv:
            task = self._tasks.get(key)
            return None if task is None else task["status"]

    def take(self, key):
        """Pop and return a DONE build's result (None otherwise; the task
        record stays so dedup keeps holding the key)."""
        with self._cv:
            task = self._tasks.get(key)
            if task is None or task["status"] != DONE:
                return None
            result, task["result"] = task["result"], None
            return result

    def depth(self) -> int:
        """Builds not yet finished (queued + running)."""
        with self._cv:
            return self.depth_locked()

    def depth_locked(self) -> int:
        return sum(1 for t in self._tasks.values()
                   if t["status"] in (PENDING, RUNNING))

    def wait(self, timeout: float) -> bool:
        """Block until some build finishes or ``timeout`` seconds pass;
        True when the queue is fully drained.  There is no waiting
        without a bound."""
        with self._cv:
            if self.depth_locked() == 0:
                return True
            self._cv.wait(max(0.0, float(timeout)))
            return self.depth_locked() == 0

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until every submitted build finished or ``timeout``
        passed.  A dead worker can never finish its orphaned RUNNING
        task, so each slice reaps orphans (:meth:`fail_orphans`)."""
        deadline = OT.now() + float(timeout)
        while True:
            self.fail_orphans()
            with self._cv:
                if self.depth_locked() == 0:
                    return True
                remaining = deadline - OT.now()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, SLICE_S))

    def fail_orphans(self) -> int:
        """A worker thread that died (``compile.service_die``, or any
        thread death) leaves its popped build RUNNING for ever: mark every
        RUNNING build whose worker is no longer alive FAILED (the
        scheduler then builds inline, counted ``aot.service_fallbacks``)
        and restart a worker for any PENDING entries.  Each build records
        its own worker, so an orphan is found even after a later
        ``submit`` started a new worker.  Returns the number of orphans
        failed."""
        with self._cv:
            n = 0
            for task in self._tasks.values():
                owner = task.get("worker")
                if (task["status"] == RUNNING and owner is not None
                        and not owner.is_alive()):
                    task["status"] = FAILED
                    task["build"] = None
                    n += 1
            if any(t["status"] == PENDING for t in self._tasks.values()):
                self._ensure_worker()
            if n:
                self._cv.notify_all()
        if n:
            M.counter("aot.service_fallbacks").inc(n)
            self._update_depth()
        return n

    def fail_stale(self, max_age: Optional[float] = None) -> int:
        """Fail every unfinished build submitted more than ``max_age``
        seconds ago (default :data:`BUILD_TIMEOUT_S`): a build that hangs in
        a live worker must not park its jobs for ever.  Counted
        ``aot.service_fallbacks``; a late result of a failed build is
        dropped.  Returns the number failed."""
        limit = BUILD_TIMEOUT_S if max_age is None else float(max_age)
        now = OT.now()
        n = 0
        with self._cv:
            for task in self._tasks.values():
                if (task["status"] in (PENDING, RUNNING)
                        and now - task["t_submit"] > limit):
                    task["status"] = FAILED
                    task["build"] = None
                    n += 1
            if n:
                self._cv.notify_all()
        if n:
            M.counter("aot.service_fallbacks").inc(n)
            self._update_depth()
        return n

    def state(self) -> dict:
        """The /health payload."""
        with self._cv:
            counts: Dict[str, int] = {}
            for t in self._tasks.values():
                counts[t["status"]] = counts.get(t["status"], 0) + 1
            return {"queue_depth": self.depth_locked(),
                    "tasks": counts,
                    "worker_alive": bool(
                        self._thread is not None
                        and self._thread.is_alive())}

    def close(self) -> None:
        """Stop the helper process (a later host build starts another);
        the worker thread retires by itself when idle."""
        self.host.stop()

    def _update_depth(self) -> None:
        M.gauge("aot.compile_queue_depth").set(float(self.depth()))

    # -- the worker ----------------------------------------------------------

    def _next_key(self):
        """Pop the best PENDING key, waiting in slices; None after
        :data:`IDLE_S` idle seconds (the worker then retires)."""
        idle_since = OT.now()
        while True:
            while self._heap:
                _, _, cand = heapq.heappop(self._heap)
                task = self._tasks.get(cand)
                if task is not None and task["status"] == PENDING:
                    return cand
            if OT.now() - idle_since > IDLE_S:
                return None
            self._cv.wait(SLICE_S)

    def _run(self) -> None:
        while True:
            with self._cv:
                key = self._next_key()
                if key is None:
                    # retire: cleared under the lock, so a submit that
                    # follows starts a new worker
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return
                task = self._tasks[key]
                task["status"] = RUNNING
                task["t_start"] = OT.now()
                task["worker"] = threading.current_thread()
                build, name = task["build"], task["name"]
            # the chaos seam: the worker dies mid-task, leaving this build
            # orphaned RUNNING: the state fail_orphans() and the serve
            # loop's fallback recover from
            if faults.fire("compile.service_die"):
                return
            t0 = OT.now()
            try:
                result = build()
                status = DONE
                M.counter("aot.background_compiles").inc()
            except Exception:
                result, status = None, FAILED
                M.counter("aot.compile_failures", executable=name).inc()
            t1 = OT.now()
            M.histogram("aot.background_compile_s",
                        executable=name).observe(t1 - t0)
            with self._cv:
                task = self._tasks.get(key)
                jobs = list(task.get("jobs") or ()) if task else []
                if task is not None and task["status"] == RUNNING:
                    task["status"] = status
                    task["result"] = result
                    task["build"] = None
                self._cv.notify_all()
            self._update_depth()
            self._trace_build(name, status, jobs, t0, t1)

    @staticmethod
    def _trace_build(name: str, status: str, jobs, t0: float,
                     t1: float) -> None:
        """One pid-5 compile span per build, plus a flow arrow opened per
        waiting job (terminated by that job's lane span in
        fleet/server.py ``_job_terminal``)."""
        sink = OT.TRACE
        if not sink.enabled:
            return
        sink.compile_span(
            1, name, t0, t1 - t0,
            args={"outcome": status, "jobs": list(jobs)})
        for job_id in jobs:
            sink.flow_start(job_id, "compile->lane", t1,
                            OT.COMPILE_PID, 1)
