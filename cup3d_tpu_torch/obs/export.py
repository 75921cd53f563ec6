"""The HTTP exporter: ``/metrics`` (Prometheus text) and ``/health``
(JSON), plus the federation endpoints (port of
``cup3d_tpu/obs/export.py``).

Off by default.  ``CUP3D_METRICS_PORT=<port>`` (or an explicit
:func:`ensure_exporter` call) starts one background
``ThreadingHTTPServer`` daemon thread a process; the step loop is never
touched.  A scrape renders a registry :func:`snapshot` on the server
thread: host scalars only, no tensor read, no device sync, and the
registry's own lock is the only shared state.

``/metrics`` renders the flat ``obs/metrics.py`` snapshot keys
(``name{k=v,...}[.suffix]``) as Prometheus exposition text 0.0.4:
``cup3d_`` prefix, dots to underscores, labels quoted and escaped, one
``# TYPE`` line a family.  Registered histograms render as histogram
families (cumulative ``_bucket{le="..."}`` lines on the
``obs.metrics.BUCKET_BOUNDS`` ladder plus ``+Inf``, ``_sum`` and
``_count``); their flat ``.count``/``.sum`` keys are left out of the
untyped section, where they would collide.  NaN and +-Inf render as
``NaN``/``+Inf``/``-Inf``.  The text is byte-equal to the JAX package's
for the same registry contents.  :func:`parse_prometheus_text` is the
matching parser and :func:`parse_histograms` regroups the bucket series.

``/health`` carries the JAX package's keys: each live flight recorder's
arm state and last-known-good step, the recovery and fleet counters,
the live fleet servers' ``health()``, the trace sink's and the capture
controller's state (obs/profile.py) and the federation state.  Two
blocks carry the JAX package's own "unset" value, since nothing stands
behind them in the port yet: ``"aot": {"store": None}`` (what the JAX
package reports with ``CUP3D_AOT_STORE`` unset; the port refuses the
compiled store, ROADMAP queue A item 3), and ``"stragglers"``, the
block the JAX package's ``StragglerWatch.health()`` gives before any
shard wall was recorded (threshold from ``CUP3D_STRAGGLER_RATIO``,
default 2.0; the watch itself is ROADMAP queue A item 5).

``/federate`` serves this process's federation snapshot (JSON, schema
1), ``/metrics/federated`` and ``/health/federated`` the coordinator's
merged view (obs/federate.py).
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from cup3d_tpu_torch.obs import flight as _flight
from cup3d_tpu_torch.obs import metrics as _metrics
from cup3d_tpu_torch.obs import trace as _trace

_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
)

TEXT_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- Prometheus text rendering ----------------------------------------------


def prometheus_key(flat: str) -> Tuple[str, Dict[str, str]]:
    """One flat snapshot key -> (metric name, labels).

    ``poisson.iters_hist{driver=amr}.count`` ->
    (``cup3d_poisson_iters_hist_count``, {"driver": "amr"}).
    """
    labels: Dict[str, str] = {}
    base = flat
    if "{" in flat:
        head, rest = flat.split("{", 1)
        inner, _, tail = rest.partition("}")
        labels = dict(p.split("=", 1) for p in inner.split(",") if "=" in p)
        base = head + tail
    name = "cup3d_" + _NAME_SANITIZE_RE.sub("_", base.strip("."))
    return name, labels


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _fmt_value(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(le: float) -> str:
    """A bucket bound as an ``le`` label value (``+Inf`` for overflow,
    ``repr`` otherwise so ``float()`` round-trips exactly)."""
    return "+Inf" if math.isinf(le) else repr(le)


def render_prometheus(snap: Optional[Dict[str, float]] = None,
                      histograms=None) -> str:
    """The registry snapshot as Prometheus exposition text 0.0.4.

    With no arguments (the live scrape) registered histograms render as
    histogram families and their flat ``.count``/``.sum`` keys are
    dropped from the untyped section.  An explicit ``snap`` without
    ``histograms`` renders the untyped text only."""
    if snap is None:
        snap = _metrics.snapshot()
        if histograms is None:
            histograms = _metrics.histograms()
    histograms = list(histograms or ())
    lines = []
    skip = set()
    # histogram families first, grouped by prometheus name so each
    # family gets one TYPE line across its label sets
    hist_fams: Dict[str, list] = {}
    for h in histograms:
        name, labels = prometheus_key(h.flat)
        hist_fams.setdefault(name, []).append((labels, h))
        # _count/_sum replace the flat suffix keys (same sanitized
        # names); min/max/last keep rendering untyped below
        skip.add(f"{h.flat}.count")
        skip.add(f"{h.flat}.sum")
    for name in sorted(hist_fams):
        lines.append(f"# TYPE {name} histogram")
        for labels, h in hist_fams[name]:
            for le, cum in h.cumulative_buckets():
                blabels = dict(labels)
                blabels["le"] = _fmt_le(le)
                lines.append(f"{name}_bucket{_label_str(blabels)} {cum}")
            lstr = _label_str(labels)
            lines.append(f"{name}_sum{lstr} {_fmt_value(h.sum)}")
            lines.append(f"{name}_count{lstr} {h.count}")
    families: Dict[str, list] = {}
    for flat in sorted(snap):
        if flat in skip:
            continue
        name, labels = prometheus_key(flat)
        families.setdefault(name, []).append((labels, snap[flat]))
    for name, series in families.items():
        lines.append(f"# TYPE {name} untyped")
        for labels, val in series:
            lines.append(f"{name}{_label_str(labels)} {_fmt_value(val)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[Tuple[str, frozenset], float]:
    """Exposition text -> {(name, frozenset(label items)): value}.
    Raises ValueError on a malformed sample line; comment and blank
    lines are skipped."""
    out: Dict[Tuple[str, frozenset], float] = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: not a prometheus sample: {line!r}")
        name, inner, val = m.group(1), m.group(2), m.group(3)
        labels = frozenset(
            (k, _unescape_label(v))
            for k, v in _LABEL_RE.findall(inner or "")
        )
        out[(name, labels)] = float(val)
    return out


def parse_histograms(text: str) -> Dict[Tuple[str, frozenset], dict]:
    """Regroup an exposition's histogram series: ``{(family_name,
    frozenset(labels without le)): {"buckets": [(le, cum), ...
    ascending, +Inf last], "sum": float, "count": float}}``.

    Families appear once a ``_bucket`` line is seen; buckets must be
    non-decreasing in cumulative count (ValueError otherwise)."""
    samples = parse_prometheus_text(text)
    fams: Dict[Tuple[str, frozenset], dict] = {}

    def fam(name: str, labels: frozenset) -> dict:
        return fams.setdefault((name, labels),
                               {"buckets": [], "sum": None, "count": None})

    for (name, labels), val in samples.items():
        if name.endswith("_bucket"):
            ldict = dict(labels)
            le = ldict.pop("le", None)
            if le is None:
                continue  # a _bucket-suffixed untyped metric, not ours
            fam(name[:-len("_bucket")],
                frozenset(ldict.items()))["buckets"].append(
                    (float(le), val))
    for (name, labels), val in samples.items():
        for suffix, field in (("_sum", "sum"), ("_count", "count")):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and (base, labels) in fams:
                fams[(base, labels)][field] = val
    for (name, labels), rec in fams.items():
        rec["buckets"].sort(key=lambda b: b[0])
        cums = [c for _, c in rec["buckets"]]
        if cums != sorted(cums):
            raise ValueError(
                f"histogram {name}{dict(labels)}: non-cumulative buckets")
    return fams


# -- /health ----------------------------------------------------------------


def health_payload() -> dict:
    """Supervisor view: flight-recorder arm state and last-known-good
    step per live recorder, recovery and fleet counters, fleet servers,
    trace, capture-window and federation state."""
    from cup3d_tpu_torch.fleet.server import live_servers as _fleet_live
    from cup3d_tpu_torch.obs import federate as _federate
    from cup3d_tpu_torch.obs import profile as _profile

    snap = _metrics.snapshot()
    flights = []
    for fr in _flight.live_recorders():
        flights.append({
            "directory": fr.directory,
            "armed": fr.armed,
            "last_known_good_step": fr.last_known_good_step,
            "steps_recorded": len(fr.steps),
            "dumps_written": list(fr.dumps_written),
            "recovery_events": len(fr.recovery_events),
            "job_events": len(fr.job_events),
        })
    counters = {k: v for k, v in snap.items()
                if k.startswith(("flight.", "resilience.", "recovery.",
                                 "fleet.", "aot.", "journal."))}
    return {
        "status": "ok",
        "time": _trace.wall(),
        "flight_recorders": flights,
        "recovery_counters": counters,
        "fleet": [srv.health() for srv in _fleet_live()],
        # the compiled store is refused in the port (ROADMAP queue A
        # item 3): the JAX package's value with CUP3D_AOT_STORE unset
        "aot": {"store": None},
        "trace": {"enabled": _trace.TRACE.enabled,
                  "steps_recorded": _trace.TRACE.steps_recorded,
                  "steps_dropped": _trace.TRACE.steps_dropped},
        "profile": {"windows": _profile.CONTROLLER.windows,
                    "capturing": _profile.CONTROLLER.capturing},
        "federation": _federate.FED.state(),
        "stragglers": _federate.straggler_health(),
    }


# -- the server --------------------------------------------------------------


def _federated_metrics() -> Tuple[bytes, str]:
    from cup3d_tpu_torch.obs import federate as _federate

    return _federate.FED.view().render_prometheus().encode(), TEXT_CTYPE


def _federated_health() -> Tuple[bytes, str]:
    from cup3d_tpu_torch.obs import federate as _federate

    return (json.dumps(_federate.FED.view().health()).encode(),
            "application/json")


def _federate_payload() -> Tuple[bytes, str]:
    # this process's registry snapshot: what a coordinator scrapes
    from cup3d_tpu_torch.obs import federate as _federate

    return (json.dumps(_federate.FED.local_payload()).encode(),
            "application/json")


#: path -> renderer of (body, content type)
_ROUTES = {
    "/metrics": lambda: (render_prometheus().encode(), TEXT_CTYPE),
    "/health": lambda: (json.dumps(health_payload()).encode(),
                        "application/json"),
    "/federate": _federate_payload,
    "/metrics/federated": _federated_metrics,
    "/health/federated": _federated_health,
}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        route = _ROUTES.get(path)
        if route is None:
            self.send_error(
                404, "try /metrics[,/federated], /health[,/federated]"
                " or /federate")
            return
        try:
            body, ctype = route()
        except Exception:
            _metrics.counter("export.errors").inc()
            self.send_error(500, "exporter render failed")
            return
        _metrics.counter("export.scrapes", path=path.strip("/")).inc()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsExporter:
    """One background daemon HTTP server; ``port=0`` binds an ephemeral
    port.  ``start()`` returns self; ``stop()`` is idempotent."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.host = host
        self.port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="cup3d-metrics",
            daemon=True,
        )
        self._thread.start()
        _metrics.gauge("export.port").set(float(self.port))
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


#: the process singleton; the drivers call ensure_exporter() at
#: construction, a no-op unless CUP3D_METRICS_PORT is set
EXPORTER: Optional[MetricsExporter] = None


def ensure_exporter(port: Optional[int] = None) -> Optional[MetricsExporter]:
    """Start (once) the process exporter.  ``port=None`` reads
    ``CUP3D_METRICS_PORT``; unset, empty or 0 means off.  A failure to
    bind is counted (``export.bind_errors``), never raised."""
    global EXPORTER
    if EXPORTER is not None:
        return EXPORTER
    if port is None:
        spec = os.environ.get("CUP3D_METRICS_PORT", "")
        if not spec or spec == "0":
            return None
        try:
            port = int(spec)
        except ValueError:
            _metrics.counter("export.bad_port").inc()
            return None
    try:
        EXPORTER = MetricsExporter(port=port).start()
    except Exception:
        _metrics.counter("export.bind_errors").inc()
        return None
    import atexit

    atexit.register(EXPORTER.stop)
    return EXPORTER
