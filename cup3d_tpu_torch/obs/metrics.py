"""Process-global metrics registry (port of ``cup3d_tpu/obs/metrics.py``:
counters, gauges, log-bucket histograms and the flat
snapshot/delta/reset surface).

Metrics are keyed by ``(name, labels)``; ``counter("resilience.retries",
stage="tile-only")`` returns the same object on every call.
``snapshot()`` flattens everything to ``{"name{label=value}": number}``
with the JAX package's key format, so the port's tests read the same
keys (``resilience.retries{stage=tile-only}``, ``faults.injected{site=
solver.itercap}``, ``topology.megaloop_mesh_fallbacks``, the fleet's
``fleet.*`` families).  Values entering the registry are host scalars:
an ``inc`` never reads a device tensor.

Histograms keep count/sum/min/max/last plus fixed log-spaced bucket
counts (:data:`BUCKET_BOUNDS`, 8 a decade over 1e-5 .. 1e3), so
quantiles (the fleet's p50/p95/p99 job latency and phase quantiles) are
estimable within one bucket width: :func:`bucket_index`,
:func:`quantile_from_buckets`, :func:`merged_quantile` (a family's
buckets summed, PromQL ``histogram_quantile(sum by (le))``), and the
``histograms()``/``counters()`` family views.

Per-instance collectors (``register_collector``: the QoI streams'
``stats`` views, held by weakref) merge into every snapshot.  The HTTP
exporter (obs/export.py) renders the buckets.
"""

from __future__ import annotations

import threading
import weakref
from bisect import bisect_left
from statistics import median
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]

#: The pinned histogram bucket ladder (the VALIDATION.md contract):
#: log-spaced upper bounds covering 1e-5 .. 1e3 (10 µs .. ~17 min when
#: observing seconds; fractions of an iteration .. 1000 when observing
#: solver iteration counts) at 8 buckets per decade — a ~33% geometric
#: step, so a quantile estimate is off by at most one bucket width
#: (≈15% relative after log-interpolation).  66 integer counters per
#: histogram (64 finite + the le=1e-5 floor bucket + overflow): cheap
#: enough to keep the observe() hot path a bisect + two adds.
BUCKETS_PER_DECADE = 8
_DECADES = (-5, 3)  # 10**-5 .. 10**3 inclusive
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (_DECADES[0] + i / BUCKETS_PER_DECADE)
    for i in range((_DECADES[1] - _DECADES[0]) * BUCKETS_PER_DECADE + 1)
)


def bucket_index(v: float) -> int:
    """Index into the per-histogram count array for one observation:
    ``i < len(BUCKET_BOUNDS)`` means ``v <= BUCKET_BOUNDS[i]`` (and
    ``v > BUCKET_BOUNDS[i-1]``); ``i == len(BUCKET_BOUNDS)`` is the
    overflow (+Inf) bucket."""
    return bisect_left(BUCKET_BOUNDS, v)


def quantile_from_buckets(counts: Sequence[int], total: int,
                          mn: Optional[float], mx: Optional[float],
                          q: float) -> Optional[float]:
    """Quantile estimate from one (possibly merged) bucket-count array.

    Log-linear interpolation inside the containing bucket; the floor
    bucket answers ``mn`` and the overflow bucket ``mx`` (the exact
    extremes are tracked, so the tails never extrapolate past reality).
    The result is clamped to [mn, mx] — the one-bucket-width error
    bound the VALIDATION.md contract pins.  None when empty."""
    if total <= 0 or mn is None or mx is None:
        return None
    q = min(1.0, max(0.0, float(q)))
    target = max(1, int(q * total + 0.9999999999))  # ceil without math
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        cum += c
        if cum < target:
            continue
        if i >= len(BUCKET_BOUNDS):          # overflow: > top bound
            return mx
        if i == 0:                           # floor bucket: <= 1e-5
            return mn
        lo, hi = BUCKET_BOUNDS[i - 1], BUCKET_BOUNDS[i]
        frac = (target - (cum - c)) / c
        est = lo * (hi / lo) ** frac
        return min(max(est, mn), mx)
    return mx  # counts/total disagree (merged snapshots): best effort


def merged_quantile(hists: Iterable["Histogram"], q: float
                    ) -> Optional[float]:
    """One quantile across several histograms (e.g. the per-tenant
    ``fleet.job_e2e_s`` family) by summing their bucket counts —
    exactly what a PromQL ``histogram_quantile(sum by (le))`` would
    compute from the exported ``_bucket`` series."""
    counts = [0] * (len(BUCKET_BOUNDS) + 1)
    total = 0
    mn: Optional[float] = None
    mx: Optional[float] = None
    for h in hists:
        if not h.count:
            continue
        total += h.count
        for i, c in enumerate(h.bucket_counts):
            counts[i] += c
        mn = h.min if mn is None else min(mn, h.min)
        mx = h.max if mx is None else max(mx, h.max)
    return quantile_from_buckets(counts, total, mn, mx, q)


def rolling_baseline(series: Sequence[float], window: int = 5) -> float:
    """Median of the up-to-``window`` values before the newest (the JAX
    package's ``obs/history.rolling_baseline``): the baseline the fleet's
    burn attribution (``FleetServer.phase_attribution``) judges phase
    shares against.  With fewer than two points the newest value (or 0.0
    on empty) is its own baseline."""
    if len(series) < 2:
        return float(series[-1]) if series else 0.0
    return float(median(series[-(window + 1):-1]))


def _key(name: str, labels: Dict[str, object]) -> _Key:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def flat_name(name: str, labels: Dict[str, object]) -> str:
    """The snapshot key format: ``name{k=v,...}`` (labels sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.flat = flat_name(name, labels)

    def reset(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def sample(self) -> Dict[str, float]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic event/byte counter (host-side add; no device syncs)."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def sample(self) -> Dict[str, float]:
        return {self.flat: self.value}


class Gauge(_Metric):
    """Last-written value (capacity, queue depth, last iteration count)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def sample(self) -> Dict[str, float]:
        return {self.flat: self.value}


class Histogram(_Metric):
    """count/sum/min/max/last + fixed log-bucket counts of observed host
    scalars — O(1) state, no stored samples (the flight recorder keeps
    the recent raw series).  ``quantile(q)`` estimates from the buckets
    (within one bucket width of exact — see :data:`BUCKET_BOUNDS`)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self.reset()

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.last = v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self.bucket_counts[bisect_left(BUCKET_BOUNDS, v)] += 1

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.last: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.bucket_counts: List[int] = [0] * (len(BUCKET_BOUNDS) + 1)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-estimated quantile (None when empty)."""
        return quantile_from_buckets(self.bucket_counts, self.count,
                                     self.min, self.max, q)

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, count)``
        — the Prometheus ``_bucket{le=...}`` series, ready to render."""
        out: List[Tuple[float, int]] = []
        cum = 0
        for le, c in zip(BUCKET_BOUNDS, self.bucket_counts):
            cum += c
            out.append((le, cum))
        out.append((float("inf"), self.count))
        return out

    def sample(self) -> Dict[str, float]:
        # legacy flat suffix keys, unchanged for existing consumers
        # (bench window deltas, tests asserting .count/.last); bucket
        # counts are NOT flattened here — obs/export.py renders them
        # from the registry as proper _bucket exposition instead.
        out = {f"{self.flat}.count": float(self.count),
               f"{self.flat}.sum": float(self.sum)}
        if self.count:
            out[f"{self.flat}.min"] = float(self.min)
            out[f"{self.flat}.max"] = float(self.max)
            out[f"{self.flat}.last"] = float(self.last)
        return out


class MetricsRegistry:
    """Get-or-create metric store + snapshot/delta/reset.

    Creation takes a lock (rare); the returned metric objects are plain
    attribute stores mutated lock-free under the GIL (hot path)."""

    def __init__(self) -> None:
        self._metrics: Dict[_Key, _Metric] = {}
        self._collectors: List[Tuple[object, Callable[[], Dict[str, float]]]] = []
        self._lock = threading.Lock()

    # -- creation ----------------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, object]) -> _Metric:
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._lock:
                m = self._metrics.get(k)
                if m is None:
                    m = cls(name, labels)
                    self._metrics[k] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {flat_name(name, labels)!r} already registered "
                f"as {m.kind}, requested {cls.kind}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- collectors --------------------------------------------------------

    def register_collector(
        self, fn: Callable[[], Dict[str, float]], owner: object = None
    ) -> None:
        """``fn()`` -> {flat_name: number} merged into every snapshot.
        ``owner`` is held by weakref: when it dies the collector drops out
        (streams register per-instance ``stats`` views this way).  Equal
        keys from multiple live collectors SUM (process-wide totals)."""
        ref = weakref.ref(owner) if owner is not None else (lambda: self)
        with self._lock:
            self._collectors.append((ref, fn))

    # -- queries -----------------------------------------------------------

    def metrics(self) -> List[_Metric]:
        """Every registered metric object, kind-tagged via ``.kind`` —
        the federation layer (obs/federate.py) serializes these into
        per-process snapshots, so merge semantics can differ by kind
        (counters sum, gauges keep per-process identity, histograms
        merge bucket-wise)."""
        return list(self._metrics.values())

    def histograms(self, name: Optional[str] = None) -> List[Histogram]:
        """Every registered Histogram (optionally filtered by metric
        name across all label sets) — the exporter renders ``_bucket``
        series from these, and the fleet server merges a family's
        buckets for aggregate p50/p95/p99.  the per-phase
        ``fleet.latency_phase_s{phase,tenant}`` family rides this
        accessor for phase quantiles + burn attribution
        (fleet/server.py ``phase_quantiles``)."""
        return [m for m in list(self._metrics.values())
                if isinstance(m, Histogram)
                and (name is None or m.name == name)]

    def counters(self, name: Optional[str] = None) -> List[Counter]:
        """Every registered Counter (optionally one family across all
        label sets) — the postmortem ``aot`` block reads the
        ``aot.store_rejects{reason}`` family this way without knowing
        the reason label values in advance."""
        return [m for m in list(self._metrics.values())
                if isinstance(m, Counter)
                and (name is None or m.name == name)]

    def snapshot(self) -> Dict[str, float]:
        """One flat dict of every metric + every live collector's view."""
        out: Dict[str, float] = {}
        for m in list(self._metrics.values()):
            out.update(m.sample())
        with self._lock:
            live = [(r, fn) for r, fn in self._collectors if r() is not None]
            self._collectors = live
        for _, fn in live:
            try:
                for k, v in fn().items():
                    out[k] = out.get(k, 0) + v if k in out else v
            # dead owners are dropped by the weakref sweep above
            # torch-lint: allow(JX009, a dying collector must not kill
            # telemetry, and counting INTO the registry being snapshotted
            # here would recurse)
            except Exception:
                continue
        return out

    def delta(self, prev: Dict[str, float],
              cur: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Numeric difference of two snapshots (window accounting).  Keys
        absent from ``prev`` count from 0; gauges difference like
        everything else (callers wanting absolutes read the snapshot)."""
        if cur is None:
            cur = self.snapshot()
        out = {}
        for k, v in cur.items():
            try:
                out[k] = v - prev.get(k, 0)
            except TypeError:  # non-numeric collector value
                out[k] = v
        return out

    def reset(self) -> None:
        """Zero every registered metric (collectors keep their own state
        and are NOT reset — they are per-instance views)."""
        for m in list(self._metrics.values()):
            m.reset()


#: the process-global registry every subsystem shares
REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def histograms(name: Optional[str] = None) -> List[Histogram]:
    return REGISTRY.histograms(name)


def counters(name: Optional[str] = None) -> List[Counter]:
    return REGISTRY.counters(name)


def snapshot() -> Dict[str, float]:
    return REGISTRY.snapshot()


def delta(prev: Dict[str, float],
          cur: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    return REGISTRY.delta(prev, cur)


def reset() -> None:
    REGISTRY.reset()


def register_collector(fn: Callable[[], Dict[str, float]],
                       owner: object = None) -> None:
    REGISTRY.register_collector(fn, owner)
