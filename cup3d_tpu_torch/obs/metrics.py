"""Process-global metrics registry (port of ``cup3d_tpu/obs/metrics.py``:
counters, gauges, histograms and the flat snapshot/delta/reset surface).

Metrics are keyed by ``(name, labels)``; ``counter("resilience.retries",
stage="tile-only")`` returns the same object on every call.
``snapshot()`` flattens everything to ``{"name{label=value}": number}``
with the JAX package's key format, so the port's tests read the same
keys (``resilience.retries{stage=tile-only}``, ``faults.injected{site=
solver.itercap}``, ``topology.megaloop_mesh_fallbacks``: the x-slab
megaloops that could not slab their grid and ran solo).  Values entering
the registry are host scalars: an ``inc`` never reads a device tensor.

Per-instance collectors (``register_collector``: the QoI streams'
``stats`` views, held by weakref) merge into every snapshot.  Not ported
(nothing in the port reads them yet): histogram buckets and their
quantiles and the exporter (ROADMAP A9).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


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


class Counter(_Metric):
    """Monotonic event counter (a host-side add)."""

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
    """Last-written value (last solver iteration count, residual)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, object]):
        super().__init__(name, labels)
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def sample(self) -> Dict[str, float]:
        return {self.flat: self.value}


class Histogram(_Metric):
    """count/sum/min/max/last of observed host scalars: O(1) state, no
    stored samples."""

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

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.last: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def sample(self) -> Dict[str, float]:
        out = {f"{self.flat}.count": float(self.count),
               f"{self.flat}.sum": float(self.sum)}
        if self.count:
            out[f"{self.flat}.min"] = float(self.min)
            out[f"{self.flat}.max"] = float(self.max)
            out[f"{self.flat}.last"] = float(self.last)
        return out


class MetricsRegistry:
    """Get-or-create metric store + snapshot/delta/reset.  Creation takes
    a lock; the metric objects are mutated lock-free under the GIL."""

    def __init__(self) -> None:
        self._metrics: Dict[_Key, _Metric] = {}
        self._collectors: List[Tuple[object, Callable]] = []
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, object]) -> _Metric:
        k = (name, tuple(sorted((a, str(v)) for a, v in labels.items())))
        m = self._metrics.get(k)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(k, cls(name, labels))
        if not isinstance(m, cls):
            raise TypeError(f"metric {flat_name(name, labels)!r} already "
                            f"registered as {m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def register_collector(self, fn: Callable[[], Dict[str, float]],
                           owner: object = None) -> None:
        """``fn()`` -> {flat_name: number} merged into every snapshot;
        ``owner`` is held by weakref (when it dies the collector drops
        out).  Equal keys from several live collectors sum."""
        ref = weakref.ref(owner) if owner is not None else (lambda: self)
        with self._lock:
            self._collectors.append((ref, fn))

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in list(self._metrics.values()):
            out.update(m.sample())
        with self._lock:
            live = [(r, fn) for r, fn in self._collectors if r() is not None]
            self._collectors = live
        for _, fn in live:
            for k, v in fn().items():
                out[k] = out[k] + v if k in out else v
        return out

    def delta(self, prev: Dict[str, float],
              cur: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Difference of two snapshots; keys absent from ``prev`` count
        from 0."""
        if cur is None:
            cur = self.snapshot()
        return {k: v - prev.get(k, 0) for k, v in cur.items()}

    def reset(self) -> None:
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


def register_collector(fn: Callable[[], Dict[str, float]],
                       owner: object = None) -> None:
    REGISTRY.register_collector(fn, owner)


def snapshot() -> Dict[str, float]:
    return REGISTRY.snapshot()


def delta(prev: Dict[str, float],
          cur: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    return REGISTRY.delta(prev, cur)


def reset() -> None:
    REGISTRY.reset()
