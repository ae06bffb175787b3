"""Process-global metrics registry: counters, gauges, fixed-bucket
histograms, and sim-time-keyed series.

The registry is deliberately tiny — dict lookups and float adds under
one lock per metric (Series appends are lock-free: deque.append is
atomic under the GIL) — because its hot-path callers (the micro-batcher
flush, the admission drain, the fused event loop) record behind the same
``repro_torch.obs.trace.enabled`` guard the tracer uses: with observability
off, no metric code runs at all.

Four metric kinds, all label-aware (labels are sorted kwarg tuples):

* :class:`Counter` — monotone ``inc``;
* :class:`Gauge` — last-write ``set``;
* :class:`Histogram` — **fixed buckets** chosen at creation (the
  cumulative-bucket layout Prometheus expects; no dynamic resizing on
  the hot path);
* :class:`Series` — bounded ``(t, value)`` append log keyed by *sim
  time*, for the cluster replay's per-event-batch wastage/utilization/
  starvation curves.

:func:`repro_torch.obs.export.prometheus_text` renders the registry in
Prometheus text exposition format; :meth:`Registry.snapshot` gives the
JSON form.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Series", "Registry",
           "REGISTRY", "counter", "gauge", "hist", "series",
           "LATENCY_BUCKETS_S", "COUNT_BUCKETS"]

# Default fixed buckets: request latencies (seconds, log-spaced) and
# batch/lane counts (pow2).
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)
COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in sorted(self._values.items())]}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(labels))

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in sorted(self._values.items())]}


class Histogram(_Metric):
    """Fixed upper-bound buckets (+inf implicit), cumulative on export."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help)
        ups = sorted(float(b) for b in buckets)
        if not ups or any(not math.isfinite(b) for b in ups):
            raise ValueError(f"histogram {name!r} needs finite fixed buckets")
        self.buckets: Tuple[float, ...] = tuple(ups)
        # per label-set: [bucket counts..., overflow], sum, count
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            row = self._counts.get(key)
            if row is None:
                row = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            row[i] += 1
            self._sums[key] += v

    def count(self, **labels) -> int:
        row = self._counts.get(_label_key(labels))
        return sum(row) if row else 0

    def snapshot(self) -> dict:
        with self._lock:
            out = []
            for key, row in sorted(self._counts.items()):
                cum, cums = 0, []
                for c in row:
                    cum += c
                    cums.append(cum)
                out.append({"labels": dict(key),
                            "buckets": list(self.buckets),
                            "cumulative": cums,  # last entry == count
                            "sum": self._sums[key],
                            "count": cum})
            return {"kind": self.kind, "values": out}


class Series(_Metric):
    """Bounded append-only ``(t, value)`` log keyed by sim time."""

    kind = "series"

    def __init__(self, name: str, help: str = "", maxlen: int = 65536):
        super().__init__(name, help)
        self._points: deque = deque(maxlen=int(maxlen))

    def append(self, t: float, v: float) -> None:
        # Lock-free: deque.append is atomic under the GIL, and this is
        # the one metric op hot enough (every fused event batch) for a
        # lock acquire/release to show in a traced replay's time.
        self._points.append((float(t), float(v)))

    def points(self) -> List[Tuple[float, float]]:
        return list(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "points": self.points()}


class Registry:
    """Name -> metric, get-or-create with kind checking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help=help)

    def hist(self, name: str, help: str = "",
             buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help=help, buckets=buckets)

    def series(self, name: str, help: str = "",
               maxlen: int = 65536) -> Series:
        return self._get(Series, name, help=help, maxlen=maxlen)

    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able dump of every metric."""
        return {name: m.snapshot()
                for name, m in sorted(self.metrics().items())}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# The process-global registry all hot-path instrumentation records into.
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
hist = REGISTRY.hist
series = REGISTRY.series
