"""Device-time attribution: profiler capture windows and trace parsing
(port of ``cup3d_tpu/obs/profile.py``, on ``torch.profiler``).

The host spans of :mod:`cup3d_tpu_torch.obs.trace` stop at the launch
boundary: a fused BiCGSTAB solve or a megaloop is one block of host
wall.  This module recovers where the device spent it:

1. :class:`CaptureController`: ``torch.profiler`` capture windows on a
   step cadence.  ``CUP3D_PROFILE=every:N`` opens a window every N steps
   (``once``/``once:S`` for a single window); the drivers call
   :meth:`CaptureController.on_step` at the loop top (for the megaloop
   that is a K boundary, so a window brackets whole megaloops).
   Disarmed (the default) the hook is one attribute load and a branch:
   no profiler import, no device sync, nothing on the step loop.  A
   window records CPU and CUDA activity when the driver's device is
   CUDA (CPU alone otherwise) and is written with
   ``export_chrome_trace`` to ``<window dir>/<window name>.trace.json.gz``.

2. The trace parser: loads the gzipped Chrome trace-event JSON and
   attributes every device op to a logical section, so that the
   sections plus ``other`` sum to the total device time.  A Kineto trace
   (what ``torch.profiler`` writes) is read so:

   - device ops are the events of ``cat`` ``kernel``, ``gpu_memcpy`` and
     ``gpu_memset``; the ``gpu_user_annotation`` spans Kineto lays over
     them on the device track are not ops and never count;
   - the section candidates are the ``record_function`` ranges (``cat``
     ``user_annotation``: the spans obs/trace.py opens under
     ``CUP3D_TRACE_XLA=1``), never ATen ``cpu_op`` names,
     ``python_function`` frames or ``cuda_runtime`` calls;
   - an op goes first to the kernel-name table :data:`KERNEL_SECTIONS`,
     then to a section whose name its own name holds, then to the
     innermost candidate range that encloses its LAUNCH: the host call
     (``cuda_runtime``/``cuda_driver``) that carries the same
     ``args.correlation``, on the same host thread.  A kernel runs after
     the range that launched it has closed, so containment by the op's
     own device timestamp would hand it to whatever range is open then;
     the correlation id is exact where the device track's
     ``gpu_user_annotation`` ranges are derived from it and overlap when
     streams do;
   - else ``other``.

   A trace without a Kineto category (the JAX package's XLA captures,
   its checked-in fixture) is read as the JAX package reads it: device
   tracks by process and thread name, containment by the op's own
   timestamp.  The summaries then equal the JAX package's.

3. The merge: each closed window lands per-section gauges
   (``profile.device_ms{section=...}``, ``profile.device_total_ms``), a
   ``kind="device"`` record in the step-trace JSONL, and the device ops
   as pid-:data:`DEVICE_PID` events in the sink's Perfetto export.

A capture on the CPU has no device track: the window then writes no
``profile.device_ms`` gauge and no ``kind="device"`` record and counts
``profile.empty_captures`` (the JAX package counts its CPU executor
threads as a device; the port puts no CPU number under a device
metric's name).  Everything here runs at window close, on the host, and
a failure to start, stop or parse is counted (``profile.capture_errors``,
``profile.parse_errors``) and disables the plan, never raised.

Env knobs: ``CUP3D_PROFILE`` (plan), ``CUP3D_PROFILE_DIR`` (capture
directory), ``CUP3D_PROFILE_STEPS`` (window length in loop iterations,
default 1).

``python -m cup3d_tpu_torch.obs.profile --selftest`` runs the synthetic
parse and merge round trip; ``python -m cup3d_tpu_torch.obs.profile
<trace>`` prints one capture's attribution.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from cup3d_tpu_torch.obs import metrics as _metrics
from cup3d_tpu_torch.obs import trace as obs_trace

#: pid the merged Perfetto export places device ops on (host spans are
#: pid 1, obs/trace.py)
DEVICE_PID = 2

#: process names marking a track of a JAX-package capture as a device
_DEVICE_NAME_RE = re.compile(
    r"device|tpu|gpu|accelerator|/stream", re.IGNORECASE
)

#: thread names marking a device/executor stream inside a host-named
#: process of a JAX-package capture
_DEVICE_THREAD_RE = re.compile(r"tf_xla|xla:|/stream", re.IGNORECASE)

#: Kineto categories of device ops (older PyTorch writes the capitalized
#: ``Kernel``/``Memcpy``/``Memset``); compared lower-cased
KINETO_DEVICE_CATS = frozenset(
    ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"))

#: the Kineto category of ``record_function`` ranges
KINETO_SECTION_CAT = "user_annotation"

#: kernel-name fragments -> logical section, checked in order (first
#: hit wins).  The JAX package's sections and fragments, plus the port's
#: kernel names (csrc/*.cu, demangled as ``void (anonymous
#: namespace)::k_update<float>(...)``), each in the section of its JAX
#: counterpart: ``k_update`` with ``_k_update``; ``k_lap`` (and
#: ``k_lap_amr``) with ``_k_lap``; ``k_axpy`` and ``k_finish`` with
#: ``_k_axpy`` and ``_k_finish``.  ``k_getz_two``, ``k_getz_tile``,
#: ``k_getz_amr`` and ``k_getz_cg`` reach ``getz``, ``k_ring_shift``
#: reaches ``ring_shift``.  ``k_frenet`` has no fragment: it takes its
#: range's section, or ``other``.  The ``scan`` and ``while`` fragments
#: also catch cub's ``DeviceScanKernel`` (cumsum, nonzero).
KERNEL_SECTIONS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("bicgstab.update", ("_k_update", "fused_update", "bicgstab_update",
                         "k_update")),
    ("bicgstab.getz_lap", ("_k_getz", "_k_lap", "fused_getz", "fused_lap",
                           "getz", "k_lap")),
    ("bicgstab.finish", ("_k_finish", "_k_axpy", "fused_finish",
                         "fused_axpy", "bicgstab_finish", "k_finish",
                         "k_axpy")),
    ("halo.ring", ("ring_shift", "remote_copy", "all_to_all", "ppermute",
                   "collective-permute", "collective_permute", "halo")),
    ("megaloop.body", ("megaloop", "scan_body", "while", "fori_loop",
                       "scan")),
)


# -- capture plan ------------------------------------------------------------


def parse_plan(spec: Optional[str]) -> Optional[dict]:
    """``CUP3D_PROFILE`` -> plan dict, or None (profiling off).

    ``every:N``  one window every N steps (N >= 1);
    ``once``     one window at the first loop iteration;
    ``once:S``   one window at the first iteration with step >= S.
    Unset, empty, ``0``, ``off`` or ``none`` disable.  A malformed spec
    disables and counts ``profile.bad_plan``.
    """
    if not spec or spec in ("0", "off", "none"):
        return None
    try:
        if spec.startswith("every:"):
            n = int(spec.split(":", 1)[1])
            if n < 1:
                raise ValueError(spec)
            return {"mode": "every", "n": n}
        if spec == "once":
            return {"mode": "once", "at": 0}
        if spec.startswith("once:"):
            return {"mode": "once", "at": int(spec.split(":", 1)[1])}
        raise ValueError(spec)
    except ValueError:
        _metrics.counter("profile.bad_plan").inc()
        return None


#: the open default-profiler windows: (profile, logdir, cuda)
_ACTIVE: List[tuple] = []


def _default_start(logdir: str, cuda: bool) -> None:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _ACTIVE.append((prof, logdir, cuda))


def _default_stop() -> None:
    """Close the open window and write it as
    ``<logdir>/<basename>.trace.json.gz``: ``export_chrome_trace`` to
    plain JSON, gzipped at level 1 (a window of a forest step holds
    hundreds of thousands of events; level 9, what PyTorch uses for a
    ``.gz`` path, takes seconds more).  With CUDA on, the device is
    synchronised first so the window's kernels have finished and their
    records are flushed with it (window close only, never per step)."""
    import shutil

    import torch

    prof, logdir, cuda = _ACTIVE.pop()
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    name = os.path.basename(os.path.normpath(logdir)) or "capture"
    plain = os.path.join(logdir, f"{name}.trace.json")
    prof.export_chrome_trace(plain)
    with open(plain, "rb") as src, gzip.open(plain + ".gz", "wb",
                                             compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 1 << 20)
    os.remove(plain)


class CaptureController:
    """Opens and closes ``torch.profiler`` windows on a step cadence and
    harvests each closed window into a :class:`DeviceAttribution`.

    One process-global instance (:data:`CONTROLLER`) is wired into both
    drivers; a private instance with injected ``start_fn``/``stop_fn`` is
    the test seam.  ``device`` picks the profiler's activities (CUDA with
    a CUDA device; None: CUDA when a card is present); the drivers pass
    theirs through :meth:`default_directory`.  All state is host-side;
    ``on_step`` never touches a device value."""

    def __init__(self, plan=None, directory: Optional[str] = None,
                 window_steps: Optional[int] = None,
                 start_fn=None, stop_fn=None, sink=None, device=None):
        env = os.environ
        if isinstance(plan, str):
            plan = parse_plan(plan)
        self.plan = plan
        self.directory = (directory or env.get("CUP3D_PROFILE_DIR")
                          or "profile")
        self._dir_pinned = bool(directory or env.get("CUP3D_PROFILE_DIR"))
        try:
            self.window_steps = (int(env.get("CUP3D_PROFILE_STEPS", "1"))
                                 if window_steps is None else int(window_steps))
        except ValueError:
            self.window_steps = 1
        self.window_steps = max(1, self.window_steps)
        self.device = device
        self._start = start_fn or (
            lambda logdir: _default_start(logdir, self._cuda()))
        self._stop = stop_fn or _default_stop
        self._sink = sink  # None -> the global TRACE at harvest time
        self.capturing = False
        self.windows = 0
        self.last_attribution: Optional["DeviceAttribution"] = None
        self._open_step: Optional[int] = None
        self._open_dir: Optional[str] = None
        self._last_step = 0
        self._next_open = self._first_open()
        self._g_capturing = _metrics.gauge("profile.capturing")

    @classmethod
    def from_env(cls) -> "CaptureController":
        return cls(plan=parse_plan(os.environ.get("CUP3D_PROFILE")))

    def _first_open(self) -> Optional[int]:
        if self.plan is None:
            return None
        if self.plan["mode"] == "once":
            return self.plan["at"]
        # every:N skips the first steps (builds, warm-up): the first
        # window opens at step N, the next at open + N, ...
        return self.plan["n"]

    def _cuda(self) -> bool:
        if self.device is not None:
            return str(self.device).startswith("cuda")
        import torch

        return torch.cuda.is_available()

    @property
    def sink(self) -> obs_trace.TraceSink:
        return self._sink if self._sink is not None else obs_trace.TRACE

    def default_directory(self, directory: str, device=None) -> None:
        """Driver hint (as TraceSink.default_directory): capture under
        the run directory unless the user pinned a location; ``device``
        the driver's device."""
        if device is not None:
            self.device = device
        if not self._dir_pinned and not self.capturing:
            self.directory = os.path.join(directory, "profile")

    # -- the driver hook (loop top / K boundary) ---------------------------

    def on_step(self, step: int) -> None:
        """Called at the loop top with the current step index.  For the
        megaloop consecutive calls differ by K, so a window brackets
        whole megaloops.  Disarmed: one branch."""
        if self.plan is None:
            return
        self._last_step = step
        if self.capturing:
            if step >= self._open_step + self.window_steps:
                self._close_window(step)
            return
        if self._next_open is not None and step >= self._next_open:
            self._open_window(step)

    def finish(self) -> None:
        """Run end: close a still-open window (the drivers call this when
        they drain their streams; atexit backstops it)."""
        if self.capturing:
            self._close_window(self._last_step + 1)

    # -- window mechanics ---------------------------------------------------

    def _open_window(self, step: int) -> None:
        logdir = os.path.join(self.directory, f"window_{step:07d}")
        try:
            os.makedirs(logdir, exist_ok=True)
            self._start(logdir)
        except Exception:
            # a profiler that cannot start disables the plan: counted,
            # never raised, and not retried every step
            _metrics.counter("profile.capture_errors").inc()
            self.plan = None
            return
        self.capturing = True
        self._open_step = step
        self._open_dir = logdir
        self._g_capturing.set(1.0)

    def _close_window(self, step: int) -> None:
        try:
            self._stop()
        except Exception:
            _metrics.counter("profile.capture_errors").inc()
            self.plan = None
            self.capturing = False
            self._g_capturing.set(0.0)
            return
        self.capturing = False
        self._g_capturing.set(0.0)
        self.windows += 1
        _metrics.counter("profile.windows").inc()
        window = (int(self._open_step), int(step))
        if self.plan is not None and self.plan["mode"] == "every":
            self._next_open = self._open_step + self.plan["n"]
        else:
            self._next_open = None
        self.harvest(self._open_dir, window=window)

    @contextmanager
    def capture(self, tag: str = "capture"):
        """One programmatic window (tools, smoke tests); yields the
        capture directory and harvests on exit."""
        if self.capturing:
            raise RuntimeError("a capture window is already open")
        logdir = os.path.join(self.directory, tag)
        os.makedirs(logdir, exist_ok=True)
        self._start(logdir)
        self.capturing = True
        self._g_capturing.set(1.0)
        try:
            yield logdir
        finally:
            self._stop()
            self.capturing = False
            self._g_capturing.set(0.0)
            self.windows += 1
            _metrics.counter("profile.windows").inc()
            self.harvest(logdir, window=(self._last_step, self._last_step))

    # -- harvest: parse + attribute + merge --------------------------------

    def harvest(self, logdir: str,
                window: Tuple[int, int] = (0, 0)
                ) -> Optional["DeviceAttribution"]:
        """Parse the newest capture under ``logdir``, attribute its device
        time, and merge it into the metrics and the trace sink.  A parse
        failure counts ``profile.parse_errors``; a capture with no device
        op (the CPU) counts ``profile.empty_captures`` and lands
        nothing."""
        attr = None
        for path in reversed(find_trace_files(logdir)):
            try:
                attr = attribute(load_chrome_trace(path), source=path)
                break
            except Exception:
                _metrics.counter("profile.parse_errors").inc()
        if attr is None or not attr.events:
            _metrics.counter("profile.empty_captures").inc()
            return None
        self.last_attribution = attr
        for name, ms in attr.sections.items():
            _metrics.gauge("profile.device_ms", section=name).set(ms)
        _metrics.gauge("profile.device_ms", section="other").set(attr.other_ms)
        _metrics.gauge("profile.device_total_ms").set(attr.total_ms)
        sink = self.sink
        if sink.enabled:
            merge_into_sink(sink, attr, window=window)
        return attr


#: the process-global controller (env-configured), wired into both
#: drivers like obs_trace.TRACE; finish() runs atexit so a window open
#: at interpreter exit still stops and harvests
CONTROLLER = CaptureController.from_env()

import atexit  # noqa: E402  (registration must follow CONTROLLER)

atexit.register(CONTROLLER.finish)


# -- trace-event loading -----------------------------------------------------


def find_trace_files(logdir: str) -> List[str]:
    """Chrome-JSON capture files under ``logdir``, oldest first."""
    pats = ("*.trace.json.gz", "*.trace.json", "perfetto_trace.json.gz")
    hits: List[str] = []
    for pat in pats:
        hits += glob.glob(os.path.join(logdir, "**", pat), recursive=True)
    return sorted(set(hits), key=lambda p: (os.path.getmtime(p), p))


def load_chrome_trace(path: str) -> dict:
    """Load one (optionally gzipped) Chrome trace-event JSON file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        obj = json.load(f)
    if isinstance(obj, list):  # bare traceEvents array form
        obj = {"traceEvents": obj}
    if not isinstance(obj.get("traceEvents"), list):
        raise ValueError(f"{path}: no traceEvents")
    return obj


# -- attribution -------------------------------------------------------------


@dataclass
class DeviceAttribution:
    """Per-section device time of one capture window.  Invariant:
    ``sum(sections.values()) + other_ms == total_ms`` (every device op is
    bucketed once)."""

    total_ms: float = 0.0
    sections: Dict[str, float] = field(default_factory=dict)
    other_ms: float = 0.0
    events: List[dict] = field(default_factory=list)
    source: str = ""

    def summary(self) -> dict:
        return {
            "total_device_ms": round(self.total_ms, 6),
            "device_sections": {k: round(v, 6)
                                for k, v in sorted(self.sections.items())},
            "other_ms": round(self.other_ms, 6),
            "source": self.source,
        }

    def kernels_by_section(self) -> Dict[str, Dict[str, int]]:
        """section (``other`` for None) -> {op name: ops}: which kernels
        each section caught."""
        out: Dict[str, Dict[str, int]] = {}
        for e in self.events:
            names = out.setdefault(e["section"] or "other", {})
            names[e["name"]] = names.get(e["name"], 0) + 1
        return out


def _kernel_section(name: str) -> Optional[str]:
    low = name.lower()
    for section, frags in KERNEL_SECTIONS:
        for frag in frags:
            if frag in low:
                return section
    return None


def _name_section(name: str, names) -> Optional[str]:
    """The longest section name that the op's name holds."""
    low = name.lower()
    hits = [s for s in names if s.lower() in low]
    return max(hits, key=len) if hits else None


def _track_names(events: List[dict]) -> Dict[int, str]:
    """pid -> process name from the metadata events."""
    names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            try:
                names[int(e["pid"])] = str(e.get("args", {}).get("name", ""))
            except (KeyError, TypeError, ValueError):
                _metrics.counter("profile.bad_metadata").inc()
    return names


def _thread_names(events: List[dict]) -> Dict[Tuple[int, int], str]:
    """(pid, tid) -> thread name from the metadata events."""
    names: Dict[Tuple[int, int], str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            try:
                names[(int(e["pid"]), int(e["tid"]))] = str(
                    e.get("args", {}).get("name", ""))
            except (KeyError, TypeError, ValueError):
                _metrics.counter("profile.bad_metadata").inc()
    return names


def _is_kineto(events: List[dict]) -> bool:
    return any(str(e.get("cat", "")).lower() in KINETO_DEVICE_CATS
               or e.get("cat") == KINETO_SECTION_CAT for e in events)


def _is_span(e: dict) -> bool:
    return (e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))
            and isinstance(e.get("name"), str) and e["name"] != "step"
            and not e["name"].startswith("$"))


def _as_int(v) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def _add(attr: DeviceAttribution, e: dict, name: str,
         section: Optional[str]) -> None:
    dur = e["dur"]
    ms = dur / 1000.0
    attr.total_ms += ms
    if section is None:
        attr.other_ms += ms
    else:
        attr.sections[section] = attr.sections.get(section, 0.0) + ms
    attr.events.append({
        "name": name, "section": section,
        "ts": float(e.get("ts", 0.0)), "dur": float(dur),
        "tid": _as_int(e.get("tid", 0)),
    })


def _device_op(e: dict) -> bool:
    dur = e.get("dur")
    return (e.get("ph") == "X" and isinstance(dur, (int, float))
            and dur >= 0)


def attribute(trace: dict, sections=None, source: str = ""
              ) -> DeviceAttribution:
    """Attribute every device op of a Chrome trace to a logical section.

    ``sections``: the section candidates (default: every candidate host
    range's name).  A Kineto trace is read as the module docstring sets
    out (device ops by category, containment through the launch's
    correlation id); any other trace as the JAX package reads it."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    if _is_kineto(events):
        return _attribute_kineto(events, sections, source)
    pnames = _track_names(events)
    tnames = _thread_names(events)
    device_pids = {pid for pid, name in pnames.items()
                   if _DEVICE_NAME_RE.search(name)}
    device_pids.add(DEVICE_PID)

    def _is_device(e: dict) -> bool:
        if e.get("pid") in device_pids:
            return True
        return bool(_DEVICE_THREAD_RE.search(
            tnames.get((e.get("pid"), e.get("tid")), "")))

    host_spans = [e for e in events if _is_span(e) and not _is_device(e)]
    names = (set(sections) if sections is not None
             else {e["name"] for e in host_spans})
    # innermost first for the temporal fallback
    host_spans.sort(key=lambda e: e["dur"])
    attr = DeviceAttribution(source=source)
    for e in events:
        if not (_device_op(e) and _is_device(e)):
            continue
        name = str(e.get("name", ""))
        section = _kernel_section(name) or _name_section(name, names)
        if section is None:
            mid = e.get("ts", 0.0) + e["dur"] / 2.0
            for span in host_spans:
                if (span["name"] in names
                        and span["ts"] <= mid <= span["ts"] + span["dur"]):
                    section = span["name"]
                    break
        _add(attr, e, name, section)
    return attr


def _attribute_kineto(events: List[dict], sections,
                      source: str) -> DeviceAttribution:
    ranges = [e for e in events
              if e.get("cat") == KINETO_SECTION_CAT and _is_span(e)]
    names = (set(sections) if sections is not None
             else {e["name"] for e in ranges})
    # (pid, tid) -> candidate ranges, innermost first
    by_thread: Dict[tuple, List[dict]] = {}
    for e in sorted(ranges, key=lambda e: e["dur"]):
        if e["name"] in names:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    # correlation id -> (host thread, launch midpoint) of the host call
    launches: Dict[int, tuple] = {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        args = e.get("args")
        if (e.get("ph") != "X" or cat in KINETO_DEVICE_CATS
                or not isinstance(args, dict)):
            continue
        corr = args.get("correlation")
        if isinstance(corr, int) and isinstance(e.get("ts"), (int, float)):
            launches[corr] = ((e.get("pid"), e.get("tid")),
                              e["ts"] + float(e.get("dur") or 0.0) / 2.0)
    attr = DeviceAttribution(source=source)
    for e in events:
        if not (_device_op(e) and str(e.get("cat", "")).lower()
                in KINETO_DEVICE_CATS):
            continue
        name = str(e.get("name", ""))
        section = _kernel_section(name) or _name_section(name, names)
        if section is None:
            args = e.get("args")
            hit = launches.get(args.get("correlation")
                               if isinstance(args, dict) else None)
            if hit is not None:
                thread, t = hit
                for span in by_thread.get(thread, ()):
                    if span["ts"] <= t <= span["ts"] + span["dur"]:
                        section = span["name"]
                        break
        _add(attr, e, name, section)
    return attr


# -- merge into the host trace ----------------------------------------------


def merge_into_sink(sink: obs_trace.TraceSink, attr: DeviceAttribution,
                    window: Tuple[int, int] = (0, 0)) -> None:
    """Land one window's attribution in the sink: a ``kind="device"``
    JSONL record plus the device ops as pid-:data:`DEVICE_PID` events in
    the Perfetto export.  The ops are shifted so the window ends at merge
    time on the sink's epoch: alignment is by window, not by tick."""
    rec = {"kind": "device", "step": int(window[1]),
           "window": [int(window[0]), int(window[1])]}
    rec.update(attr.summary())
    sink.aux(rec)
    if not attr.events:
        return
    now_us = (obs_trace.now() - sink.epoch) * 1e6
    end_us = max(e["ts"] + e["dur"] for e in attr.events)
    offset = now_us - end_us
    sink.events.append({
        "name": "process_name", "ph": "M", "pid": DEVICE_PID, "ts": 0,
        "args": {"name": "device (attributed capture)"},
    })
    for e in attr.events:
        sink.events.append({
            "name": e["name"], "ph": "X", "pid": DEVICE_PID,
            "tid": e["tid"], "ts": e["ts"] + offset, "dur": e["dur"],
            "args": {"section": e["section"] or "other"},
        })


# -- selftest and the synthetic Kineto fixture -------------------------------

_HOST_PID, _MAIN_TID, _WRITER_TID, _GPU_PID, _STREAM = 4242, 4242, 4300, 0, 7

#: (device op name, cat, correlation id, launch ts, device ts, dur):
#: the port's kernels, a library kernel launched inside a range that has
#: closed before it runs, copies, an unmatched launch
_SYNTHETIC_OPS = (
    ("void (anonymous namespace)::k_update<float>(float const*, float*)",
     "kernel", 1, 100.0, 150.0, 800.0),
    ("void (anonymous namespace)::k_getz_two<2, 1>(float const*, float*)",
     "kernel", 2, 200.0, 960.0, 700.0),
    ("void (anonymous namespace)::k_lap<float>(float const*, float*)",
     "kernel", 3, 300.0, 1700.0, 300.0),
    ("void (anonymous namespace)::k_axpy<float>(float const*, float*)",
     "kernel", 4, 400.0, 2050.0, 150.0),
    ("void (anonymous namespace)::k_finish<float>(float const*, float*)",
     "kernel", 5, 500.0, 2250.0, 500.0),
    ("void (anonymous namespace)::k_ring_shift(char const*, char*)",
     "kernel", 6, 600.0, 2800.0, 400.0),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 7, 4800.0, 4850.0,
     100.0),
    # launched in AdvectionDiffusion (5000-7000), runs after it closed,
    # while the writer thread's range is open
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, float*)", "kernel", 8,
     6900.0, 7200.0, 300.0),
    ("void (anonymous namespace)::k_frenet(float const*, float*)",
     "kernel", 9, 7600.0, 7700.0, 200.0),
    ("Memset (Device)", "gpu_memset", 10, 7800.0, 7950.0, 50.0),
    # a kernel whose launch fell outside the window
    ("void at::native::reduce_kernel<512, 1>(float*)", "kernel", 99,
     None, 8100.0, 250.0),
)


def synthetic_trace() -> dict:
    """A deterministic Kineto-shaped trace covering every attribution
    path: the port's five BiCGSTAB kernels and B14 by name, a copy by the
    correlation of its launch, a library kernel that runs after its range
    closed (by correlation, not by its own timestamp: a writer thread's
    range is open then), ``k_frenet`` and a memset launched outside any
    range (-> other), an op with no launch in the window (-> other), and
    the spans that must never count: ``gpu_user_annotation`` ranges over
    the kernels, ATen ``cpu_op`` and ``python_function`` events."""
    ev = [
        {"name": "process_name", "ph": "M", "pid": _HOST_PID, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_name", "ph": "M", "pid": _GPU_PID, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": _GPU_PID, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"name": "thread_name", "ph": "M", "pid": _GPU_PID, "tid": _STREAM,
         "args": {"name": f"stream {_STREAM}"}},
        # the record_function ranges (CUP3D_TRACE_XLA=1)
        {"ph": "X", "cat": "user_annotation", "name": "PoissonSolve",
         "pid": _HOST_PID, "tid": _MAIN_TID, "ts": 0.0, "dur": 5000.0},
        {"ph": "X", "cat": "user_annotation", "name": "AdvectionDiffusion",
         "pid": _HOST_PID, "tid": _MAIN_TID, "ts": 5000.0, "dur": 2000.0},
        {"ph": "X", "cat": "user_annotation", "name": "DumpWriter",
         "pid": _HOST_PID, "tid": _WRITER_TID, "ts": 7000.0, "dur": 2000.0},
        # never section candidates
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": _HOST_PID,
         "tid": _MAIN_TID, "ts": 6890.0, "dur": 30.0},
        {"ph": "X", "cat": "python_function",
         "name": "cup3d_tpu_torch/sim/simulation.py(500): advance",
         "pid": _HOST_PID, "tid": _MAIN_TID, "ts": 0.0, "dur": 9000.0},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0,
         "dur": 9000.0},
        # the device-side range Kineto lays over the solve's kernels
        {"ph": "X", "cat": "gpu_user_annotation", "name": "PoissonSolve",
         "pid": _GPU_PID, "tid": _STREAM, "ts": 150.0, "dur": 4800.0},
    ]
    for name, cat, corr, launch, ts, dur in _SYNTHETIC_OPS:
        if launch is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": ("cudaMemcpyAsync" if cat == "gpu_memcpy"
                                else "cudaLaunchKernel"),
                       "pid": _HOST_PID, "tid": _MAIN_TID, "ts": launch,
                       "dur": 10.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": _GPU_PID,
                   "tid": _STREAM, "ts": ts, "dur": dur,
                   "args": {"device": 0, "stream": _STREAM,
                            "correlation": corr}})
    return {"schemaVersion": 1, "traceEvents": ev, "displayTimeUnit": "ms"}


#: the synthetic trace's attribution, in device ms
SYNTHETIC_SECTIONS = {
    "bicgstab.update": 0.8, "bicgstab.getz_lap": 1.0,
    "bicgstab.finish": 0.65, "halo.ring": 0.4, "PoissonSolve": 0.1,
    "AdvectionDiffusion": 0.3,
}
SYNTHETIC_OTHER_MS = 0.5


def write_synthetic_capture(path: str) -> str:
    """Write the synthetic trace as a gzipped capture (byte-identical on
    every run: mtime 0, no file name in the header)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = json.dumps(synthetic_trace()).encode()
    with open(path, "wb") as raw:
        with gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                           mtime=0) as f:
            f.write(blob)
    return path


def selftest() -> None:
    """Synthetic capture -> parse -> attribute -> merged export, every
    invariant asserted (no card, no simulation)."""
    import math
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        cap = write_synthetic_capture(
            os.path.join(td, "window_0000000", "window_0000000.trace.json.gz"))
        found = find_trace_files(td)
        assert found == [cap], found
        attr = attribute(load_chrome_trace(cap), source=cap)
        assert set(attr.sections) == set(SYNTHETIC_SECTIONS), attr.sections
        for k, v in SYNTHETIC_SECTIONS.items():
            assert math.isclose(attr.sections[k], v, abs_tol=1e-12), (k, attr)
        assert math.isclose(attr.other_ms, SYNTHETIC_OTHER_MS,
                            abs_tol=1e-12), attr.other_ms
        total = sum(attr.sections.values()) + attr.other_ms
        assert abs(total - attr.total_ms) < 1e-9, (total, attr.total_ms)
        assert len(attr.events) == len(_SYNTHETIC_OPS)
        # capture-window cadence on injected start/stop
        calls: List[str] = []
        sink = obs_trace.TraceSink(enabled=True, directory=td)
        ctl = CaptureController(
            plan="every:4", directory=td, window_steps=2, sink=sink,
            start_fn=lambda d: calls.append("start"),
            stop_fn=lambda: calls.append("stop"),
        )
        for s in range(12):
            ctl.on_step(s)
        assert ctl.windows == 2 and calls == ["start", "stop"] * 2, (
            ctl.windows, calls)
        merge_into_sink(sink, attr, window=(4, 6))
        dev = [e for e in sink.events
               if e.get("pid") == DEVICE_PID and e.get("ph") == "X"]
        assert len(dev) == len(attr.events), (len(dev), len(attr.events))
        assert all("section" in e["args"] for e in dev)
        sink.close()
        with open(sink.jsonl_path) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        assert len(recs) == 1 and recs[0]["kind"] == "device", recs
        problems = obs_trace.validate_step_record(recs[0])
        assert not problems, problems
    print("profile selftest: OK")


if __name__ == "__main__":
    import sys

    if "--selftest" in sys.argv:
        selftest()
    elif len(sys.argv) > 1:
        a = attribute(load_chrome_trace(sys.argv[1]), source=sys.argv[1])
        print(json.dumps(a.summary(), indent=1))
    else:
        print(__doc__)
