"""Metric federation (port of ``cup3d_tpu/obs/federate.py``).

**Federation.**  Each process serializes its registry
(:func:`local_snapshot`: counters, gauges, and histograms with their
bucket counts) at K-boundaries (``Federation.on_k_boundary``, called
from the fleet's dispatch seam when armed); :func:`merge_snapshots`
merges snapshots into a :class:`FederatedView`: counters sum, gauges
keep per-process identity (``process=i``), histograms revive
bucket-wise, so ``metrics.merged_quantile`` over a group is the
quantile one fleet-wide registry would have given.  In-process
providers (``Federation.register_provider``) feed the coordinator
without sockets; HTTP peers (``peers=`` or a comma-separated list of
exporter base URLs in ``CUP3D_FEDERATE``) are scraped at their
``/federate`` endpoint (obs/export.py) with a timeout, and a peer that
fails is counted (``federate.scrape_errors{peer=}``) and left out of
the view, never raised.  The merged view renders through the exposition
of obs/export.py (``/metrics/federated``) and a federated ``/health``.
The snapshot is JSON with ``SNAPSHOT_SCHEMA = 1`` in both packages, so
a port coordinator merges JAX peers and the reverse.

Not ported: the mesh straggler watch (``StragglerWatch``,
``CUP3D_STRAGGLER_RATIO``, ROADMAP queue A item 5): it judges shards
that are separate devices.  Constructing one raises; /health reports
the block the JAX package's watch gives before any shard wall
(:func:`straggler_health`).

Everything here is host arithmetic on scalars the callers already had:
no device read.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cup3d_tpu_torch.obs import metrics as _metrics
from cup3d_tpu_torch.obs import trace as _trace

SNAPSHOT_SCHEMA = 1

#: the straggler alert threshold the JAX package defaults to
DEFAULT_STRAGGLER_RATIO = 2.0


def straggler_ratio() -> float:
    """``CUP3D_STRAGGLER_RATIO`` (> 1.0) or the default."""
    raw = os.environ.get("CUP3D_STRAGGLER_RATIO", "").strip()
    if not raw:
        return DEFAULT_STRAGGLER_RATIO
    try:
        r = float(raw)
    except ValueError:
        _metrics.counter("federate.bad_knob",
                         knob="CUP3D_STRAGGLER_RATIO").inc()
        return DEFAULT_STRAGGLER_RATIO
    if r > 1.0:
        return r
    _metrics.counter("federate.bad_knob",
                     knob="CUP3D_STRAGGLER_RATIO").inc()
    return DEFAULT_STRAGGLER_RATIO


def straggler_health() -> dict:
    """The /health "stragglers" block as the JAX package's
    ``StragglerWatch.health()`` gives it before any shard wall."""
    return {"threshold": straggler_ratio(), "skew_ratio": None,
            "last_walls": {}, "straggler_counts": {}, "warnings": [],
            "alerts": []}


class StragglerWatch:
    """The mesh straggler watch: not ported (ROADMAP queue A item 5)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StragglerWatch judges shards on separate devices: ROADMAP "
            "queue A item 5")


def _dist_probe() -> dict:
    """``parallel.topology.dist_state()``; a rank-0 single-process stub
    when the probe fails — federation must work in obs-only contexts."""
    try:
        from cup3d_tpu_torch.parallel import topology as topo

        return topo.dist_state()
    except Exception:
        _metrics.counter("federate.dist_probe_errors").inc()
        return {"mode": "off", "initialized": False, "error": None,
                "processes": 1, "rank": 0}


def mesh_summary() -> dict:
    """JSON-able mesh picture for federated /health and flight
    postmortems: the distributed-init state plus every live fleet
    server's mesh (unsharded on one card)."""
    from cup3d_tpu_torch.fleet.server import live_servers
    from cup3d_tpu_torch.parallel import topology as topo

    return {"dist": _dist_probe(),
            "fleet_meshes": [topo.mesh_state(None) for _ in live_servers()]}


# -- snapshot / revive -------------------------------------------------------

def serialize_histogram(h: _metrics.Histogram) -> dict:
    """One histogram's full merge state: bucket counts + count/sum/
    min/max/last.  JSON round-trips ints and IEEE doubles exactly, so
    reviving on the coordinator loses nothing."""
    return {"name": h.name, "labels": {k: str(v)
                                       for k, v in h.labels.items()},
            "count": int(h.count), "sum": float(h.sum),
            "min": h.min, "max": h.max, "last": h.last,
            "bucket_counts": list(h.bucket_counts)}


def revive_histogram(d: dict,
                     extra_labels: Optional[dict] = None
                     ) -> _metrics.Histogram:
    """Rebuild an (unregistered) Histogram from its serialized state,
    optionally with extra labels (the coordinator adds ``process=i``).
    The revived object is merge-equivalent to the original: same
    buckets, count, sum, min, max."""
    labels = dict(d.get("labels") or {})
    if extra_labels:
        labels.update(extra_labels)
    h = _metrics.Histogram(str(d["name"]), labels)
    h.count = int(d["count"])
    h.sum = float(d["sum"])
    h.min = d.get("min")
    h.max = d.get("max")
    h.last = d.get("last")
    counts = list(d.get("bucket_counts") or [])
    if len(counts) == len(h.bucket_counts):
        h.bucket_counts = [int(c) for c in counts]
    else:
        _metrics.counter("federate.bucket_mismatch").inc()
    return h


def local_snapshot(registry: Optional[_metrics.MetricsRegistry] = None,
                   process: Optional[int] = None) -> dict:
    """This process's registry, serialized for federation.

    Structured per kind (counters/gauges/histograms) so the
    coordinator can apply per-kind merge semantics; collector output
    (stream stats etc., flat-only, counter-like) rides in ``extras``
    and merges by summing.  ``process`` defaults to the distributed
    rank (0 single-process)."""
    reg = registry if registry is not None else _metrics.REGISTRY
    dist = _dist_probe()
    if process is None:
        process = int(dist.get("rank") or 0)
    counters, gauges, hists = [], [], []
    structured_keys = set()
    for m in reg.metrics():
        if isinstance(m, _metrics.Histogram):
            hists.append(serialize_histogram(m))
            structured_keys.update(m.sample().keys())
        elif isinstance(m, _metrics.Counter):
            counters.append({"name": m.name, "labels": dict(m.labels),
                             "value": m.value})
            structured_keys.add(m.flat)
        elif isinstance(m, _metrics.Gauge):
            gauges.append({"name": m.name, "labels": dict(m.labels),
                           "value": m.value})
            structured_keys.add(m.flat)
    extras = {k: v for k, v in reg.snapshot().items()
              if k not in structured_keys
              and isinstance(v, (int, float))}
    return {"schema": SNAPSHOT_SCHEMA, "process": int(process),
            "time": _trace.now(), "dist": dist,
            "counters": counters, "gauges": gauges,
            "histograms": hists, "extras": extras}


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class FederatedView:
    """The coordinator's merged picture over N process snapshots.

    - ``counters``: flat name -> fleet-wide sum (extras folded in)
    - ``gauges``: flat name WITH ``process=i`` label -> value
    - ``histograms``: every per-process revived Histogram, labeled
      ``process=i`` (what ``/metrics/federated`` renders)
    - ``merged(name, **labels)``: the per-process group for one family
      / label set — feed it to ``metrics.merged_quantile``
    """

    def __init__(self, snapshots: Sequence[dict]):
        self.snapshots = sorted(
            (s for s in snapshots if isinstance(s, dict)),
            key=lambda s: int(s.get("process") or 0))
        self.processes = [int(s.get("process") or 0)
                          for s in self.snapshots]
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: List[_metrics.Histogram] = []
        self._groups: Dict[Tuple[str, Tuple], List[_metrics.Histogram]]
        self._groups = {}
        for snap in self.snapshots:
            p = int(snap.get("process") or 0)
            for c in snap.get("counters") or []:
                flat = _metrics.flat_name(c["name"], c.get("labels") or {})
                self.counters[flat] = (
                    self.counters.get(flat, 0) + c["value"])
            for k, v in (snap.get("extras") or {}).items():
                self.counters[k] = self.counters.get(k, 0) + v
            for g in snap.get("gauges") or []:
                labels = dict(g.get("labels") or {})
                labels["process"] = str(p)
                self.gauges[_metrics.flat_name(g["name"], labels)] = (
                    g["value"])
            for hd in snap.get("histograms") or []:
                h = revive_histogram(hd, {"process": str(p)})
                self.histograms.append(h)
                key = (str(hd["name"]), _label_key(hd.get("labels") or {}))
                self._groups.setdefault(key, []).append(h)

    def merged(self, name: str, **labels) -> List[_metrics.Histogram]:
        """The per-process histogram group for one (name, labels)."""
        return list(self._groups.get((name, _label_key(labels)), []))

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        """Exact fleet-wide quantile: ``merged_quantile`` over the
        per-process group (bucket sums + min-of-mins / max-of-maxes)."""
        return _metrics.merged_quantile(self.merged(name, **labels), q)

    def phase_quantiles(self, tenant: Optional[str] = None,
                        qs: Sequence[float] = (0.5, 0.99)) -> dict:
        """Fleet-wide per-phase latency quantiles: exact
        merged quantiles of ``fleet.latency_phase_s`` across every
        process snapshot, keyed by phase — the federated analogue of
        ``FleetServer.phase_quantiles``.  With ``tenant=None`` the
        groups pool across tenants; pooling histogram groups keeps the
        quantiles exact (bucket sums are associative)."""
        pooled: Dict[str, List[_metrics.Histogram]] = {}
        for (name, lkey), group in self._groups.items():
            if name != "fleet.latency_phase_s":
                continue
            labels = dict(lkey)
            if tenant is not None and labels.get("tenant") != tenant:
                continue
            pooled.setdefault(labels.get("phase", ""), []).extend(group)
        return {ph: {f"p{int(round(q * 100))}":
                     _metrics.merged_quantile(group, q) for q in qs}
                for ph, group in sorted(pooled.items())}

    def render_prometheus(self) -> str:
        """Prometheus exposition of the merged view: counters summed (no
        process label), gauges and histogram families per process with
        ``process=i``, so ``sum by (le)`` downstream is exact."""
        from cup3d_tpu_torch.obs import export as _export

        snap = dict(self.counters)
        snap.update(self.gauges)
        return _export.render_prometheus(snap, self.histograms)

    def health(self) -> dict:
        """Federated /health body: per-process sub-blocks + the
        coordinator's mesh picture."""
        procs = {}
        for snap in self.snapshots:
            p = str(int(snap.get("process") or 0))
            procs[p] = {"time": snap.get("time"),
                        "dist": snap.get("dist"),
                        "counters": len(snap.get("counters") or []),
                        "gauges": len(snap.get("gauges") or []),
                        "histograms": len(snap.get("histograms") or [])}
        return {"schema": SNAPSHOT_SCHEMA,
                "processes": procs,
                "coordinator": {"mesh": mesh_summary()}}


def merge_snapshots(snapshots: Sequence[dict]) -> FederatedView:
    """Merge per-process snapshots into one :class:`FederatedView`."""
    return FederatedView(snapshots)


# -- transport ---------------------------------------------------------------

def _scrape_peer(url: str, timeout: float = 2.0) -> Optional[dict]:
    """GET one peer exporter's ``/federate`` JSON (stdlib urllib); a
    failure is counted per peer, never raised: a dead peer drops out of
    the merged view instead of failing the scrape."""
    import urllib.request

    target = url.rstrip("/") + "/federate"
    try:
        with urllib.request.urlopen(target, timeout=timeout) as resp:
            snap = json.loads(resp.read().decode("utf-8"))
        if isinstance(snap, dict):
            return snap
        _metrics.counter("federate.scrape_errors", peer=url).inc()
    except Exception:
        _metrics.counter("federate.scrape_errors", peer=url).inc()
    return None


def _peers_from_env() -> List[str]:
    """``CUP3D_FEDERATE``: ``0``/empty = off, ``1`` = armed
    self-only, otherwise a comma-separated list of peer exporter base
    URLs the coordinator scrapes."""
    spec = os.environ.get("CUP3D_FEDERATE", "0").strip()
    if spec in ("0", "", "1"):
        return []
    return [p.strip() for p in spec.split(",") if p.strip()]


class Federation:
    """One process's federation endpoint state.

    Every process runs one (the module singleton :data:`FED`): it
    caches a local snapshot at K-boundaries and serves it on scrape.
    The coordinator additionally collects providers (in-process,
    socket-free) and peers (HTTP) and merges.  ``armed`` is read once
    per K-boundary — one bool test when federation is off."""

    def __init__(self,
                 providers: Optional[List[Callable[[], dict]]] = None,
                 peers: Optional[List[str]] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        env = os.environ.get("CUP3D_FEDERATE", "0").strip()
        self.providers = list(providers or [])
        self.peers = list(peers if peers is not None
                          else _peers_from_env())
        self.registry = registry
        self.armed = bool(self.providers or self.peers
                          or env not in ("0", ""))
        self.boundaries = 0
        self._cached: Optional[dict] = None
        self._lock = threading.Lock()

    # -- arming ------------------------------------------------------------

    def arm(self) -> "Federation":
        self.armed = True
        return self

    def disarm(self) -> "Federation":
        self.armed = False
        with self._lock:
            self._cached = None
        return self

    def register_provider(self, fn: Callable[[], dict]) -> None:
        """In-process fallback transport: ``fn()`` returns a snapshot
        dict (another registry's :func:`local_snapshot`).  Single-host
        tests federate N simulated processes this way — no sockets."""
        self.providers.append(fn)
        self.armed = True

    # -- K-boundary hook ---------------------------------------------------

    def on_k_boundary(self) -> None:
        """Refresh the cached local snapshot (host dict work only).
        Called from the megaloop / fleet dispatch K-boundary seams;
        no-op unless armed, so the un-federated hot path pays one bool
        test."""
        if not self.armed:
            return
        snap = local_snapshot(self.registry)
        with self._lock:
            self._cached = snap
        self.boundaries += 1
        _metrics.counter("federate.boundaries").inc()

    def local_payload(self) -> dict:
        """What ``/federate`` serves: the K-boundary cache when armed
        and fresh, else a snapshot taken now (scrape-time fallback —
        the ISSUE's "at K-boundaries AND on scrape")."""
        with self._lock:
            cached = self._cached
        if cached is not None:
            return cached
        return local_snapshot(self.registry)

    # -- coordinator -------------------------------------------------------

    def collect(self) -> List[dict]:
        """Local payload + every provider + every scrapeable peer."""
        snaps = [self.local_payload()]
        for fn in list(self.providers):
            try:
                snap = fn()
                if isinstance(snap, dict):
                    snaps.append(snap)
                else:
                    _metrics.counter("federate.provider_errors").inc()
            except Exception:
                _metrics.counter("federate.provider_errors").inc()
        for url in self.peers:
            snap = _scrape_peer(url)
            if snap is not None:
                snaps.append(snap)
        return snaps

    def view(self) -> FederatedView:
        return merge_snapshots(self.collect())

    def state(self) -> dict:
        """Compact /health block for the plain (un-federated) payload."""
        return {"armed": self.armed, "boundaries": self.boundaries,
                "providers": len(self.providers),
                "peers": list(self.peers)}


#: the process-global federation endpoint (env-armed via CUP3D_FEDERATE)
FED = Federation()
