"""Process-wide counters, gauges, histograms and host spans, counterpart
of ``mxnet_tpu/telemetry.py`` (the registry, the recording helpers and
the snapshot, and the sorted metric items that ``tracing.prometheus_text``
exposes; merging snapshots, JSONL records and Chrome traces are not
ported yet: ROADMAP.md Queue A item 11).

* **Counters**: monotonically increasing ints (``ckpt.saves``).
* **Gauges**: last-write-wins floats.
* **Histograms**: exact count/sum/min/max, fixed cumulative buckets,
  and a ring of the most recent samples for percentiles.
* **Spans**: host intervals (``with telemetry.span(name)``) in a bounded
  ring and a ``span.<name>_ms`` histogram; each also opens a
  ``torch.profiler.record_function`` range, so a profiler trace shows it
  beside the card's kernels.

Telemetry is off by default (``MXNET_TPU_TELEMETRY``, or
:func:`enable`): every recording helper then returns after one flag
check, taking no lock and allocating nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence

from . import env as _env
from .base import MXNetError

__all__ = ["enabled", "enable", "disable", "counter", "gauge", "histogram",
           "inc", "set_gauge", "observe", "span", "spans", "snapshot",
           "reset", "peek", "metrics_items", "Counter", "Gauge",
           "Histogram", "DEFAULT_BUCKET_BOUNDS"]

_ENABLED = _env.get("MXNET_TPU_TELEMETRY")

_reg_lock = threading.Lock()
_metrics: Dict[str, object] = {}
_spans: deque = deque(maxlen=_env.get("MXNET_TPU_TELEMETRY_SPAN_CAP"))


def enabled() -> bool:
    return _ENABLED


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


class Counter:
    """Monotonic counter; thread-safe increments."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def export(self):
        return self._value


class Gauge:
    """Last-write-wins float."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float):
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def export(self):
        return self._value


# latency buckets in milliseconds, finite bounds only (the +Inf bucket's
# count is the histogram's count)
DEFAULT_BUCKET_BOUNDS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                         250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """Exact count/sum/min/max, fixed cumulative buckets (Prometheus
    ``le`` semantics), and a ring of the most recent ``capacity`` samples
    for percentiles."""

    __slots__ = ("name", "capacity", "bounds", "_lock", "_count", "_sum",
                 "_min", "_max", "_ring", "_idx", "_bucket_counts")

    def __init__(self, name: str, capacity: int = 512,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.capacity = int(capacity)
        self.bounds = tuple(sorted(float(b) for b in
                                   (DEFAULT_BUCKET_BOUNDS if bounds is None
                                    else bounds)))
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._ring = []
        self._idx = 0
        self._bucket_counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            self._bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            if len(self._ring) < self.capacity:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self.capacity

    @property
    def count(self) -> int:
        return self._count

    def export(self) -> dict:
        """Summary: count, sum, mean, min, max, p50/p90/p99 of the sample
        ring (nearest rank) and the cumulative counts of each finite
        bucket."""
        with self._lock:
            n, s = self._count, self._sum
            lo, hi = self._min, self._max
            sample = sorted(self._ring)
            per_bucket = list(self._bucket_counts)
        cum, acc = [], 0
        for c in per_bucket[:-1]:
            acc += c
            cum.append(acc)
        buckets = {"bounds": list(self.bounds), "counts": cum}
        if n == 0:
            return {"count": 0, "buckets": buckets}
        m = len(sample)
        return {"count": n, "sum": s, "mean": s / n, "min": lo, "max": hi,
                "p50": sample[m // 2],
                "p90": sample[min(m - 1, int(m * 0.9))],
                "p99": sample[min(m - 1, int(m * 0.99))],
                "buckets": buckets}


def _get(name: str, cls, **kw):
    m = _metrics.get(name)
    if m is None:
        with _reg_lock:
            m = _metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                _metrics[name] = m
    if not isinstance(m, cls):
        raise MXNetError("telemetry metric %r is a %s, not a %s"
                         % (name, type(m).__name__, cls.__name__))
    return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str, capacity: int = 512,
              bounds: Optional[Sequence[float]] = None) -> Histogram:
    return _get(name, Histogram, capacity=capacity, bounds=bounds)


def peek(name: str, kind: str = "counter"):
    """A metric's raw value without registering it: a counter's or
    gauge's value, a histogram's count (its running sum with
    ``kind="hist_sum"``); None for a name never recorded."""
    m = _metrics.get(name)
    if m is None:
        return None
    if isinstance(m, Histogram):
        return m._sum if kind == "hist_sum" else m._count
    return m._value


def metrics_items():
    """Sorted ``(name, metric)`` pairs: the exposition format's reader."""
    with _reg_lock:
        return sorted(_metrics.items())


def inc(name: str, n: int = 1):
    if not _ENABLED:
        return
    counter(name).inc(n)


def set_gauge(name: str, v: float):
    if not _ENABLED:
        return
    gauge(name).set(v)


def observe(name: str, v: float):
    if not _ENABLED:
        return
    histogram(name).observe(v)


@contextlib.contextmanager
def span(name: str):
    """A named host interval: into the span ring and the
    ``span.<name>_ms`` histogram, and a ``record_function`` range for a
    running torch.profiler."""
    if not _ENABLED:
        yield
        return
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dur = time.perf_counter() - t0
        _spans.append((name, threading.get_ident(), t0, dur))
        observe("span.%s_ms" % name, dur * 1e3)


def spans():
    """The buffered ``(name, thread id, start perf_counter, seconds)``."""
    return list(_spans)


def snapshot() -> dict:
    """Every metric as a nested dict keyed by the dot-split name
    (``ckpt.saves`` -> ``{"ckpt": {"saves": N}}``); a name that is both a
    leaf and a prefix keeps its leaf value under ``"_value"``."""
    with _reg_lock:
        items = sorted(_metrics.items())
    out: dict = {}
    for name, m in items:
        parts = name.split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {} if nxt is None else {"_value": nxt}
                node[p] = nxt
            node = nxt
        leaf = parts[-1]
        if isinstance(node.get(leaf), dict):
            node[leaf]["_value"] = m.export()
        else:
            node[leaf] = m.export()
    return out


def reset():
    """Clear every metric and span; the enabled flag stays as it is."""
    with _reg_lock:
        _metrics.clear()
    _spans.clear()
