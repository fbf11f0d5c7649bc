"""Process-wide counters, gauges, histograms and host spans, counterpart
of ``mxnet_tpu/telemetry.py``: the registry, the recording helpers, the
snapshot, the sorted metric items that ``tracing.prometheus_text``
exposes, and the exporters, whose files read as the JAX package's do::

    telemetry.snapshot()              # nested dict, one leaf a metric
    telemetry.dump_jsonl(path)        # append ONE step record
    telemetry.write_chrome_trace(p)   # host spans as Chrome trace events
    telemetry.merge_snapshots(snaps)  # fleet roll-up of snapshots

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
import copy
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence

from . import env as _env
from .base import MXNetError

__all__ = ["enabled", "enable", "disable", "counter", "gauge", "histogram",
           "inc", "set_gauge", "observe", "span", "spans", "snapshot",
           "reset", "peek", "metrics_items", "Counter", "Gauge",
           "Histogram", "DEFAULT_BUCKET_BOUNDS", "dump_jsonl",
           "write_chrome_trace", "merge_snapshots", "bucket_quantile",
           "sample_quantile"]

_ENABLED = _env.get("MXNET_TPU_TELEMETRY")

_reg_lock = threading.Lock()
_metrics: Dict[str, object] = {}
_spans: deque = deque(maxlen=_env.get("MXNET_TPU_TELEMETRY_SPAN_CAP"))
# perf_counter -> wall clock, fixed at import: every thread's spans share
# one epoch, the wall clock a torch.profiler trace stamps
_EPOCH = time.time() - time.perf_counter()

_step_lock = threading.Lock()
_step = 0


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

    def quantile(self, q: float) -> Optional[float]:
        """The ``q`` quantile of the sample ring (nearest rank, as
        :func:`sample_quantile`), None while empty."""
        with self._lock:
            sample = sorted(self._ring)
        return sample_quantile(sample, q)

    def export(self, include_sample: bool = False) -> dict:
        """Summary: count, sum, mean, min, max, p50/p90/p99 of the sample
        ring (nearest rank) and the cumulative counts of each finite
        bucket; with ``include_sample`` the sorted ring rides along, so a
        federator can merge exact percentiles."""
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
        out = {"count": n, "sum": s, "mean": s / n, "min": lo, "max": hi,
               "p50": sample_quantile(sample, 0.5),
               "p90": sample_quantile(sample, 0.9),
               "p99": sample_quantile(sample, 0.99),
               "buckets": buckets}
        if include_sample:
            out["sample"] = sample
        return out


def sample_quantile(sample: Sequence[float], q: float) -> Optional[float]:
    """Quantile of a pre-sorted sample by the nearest-rank convention of
    :meth:`Histogram.export` (``sample[int(m * q)]``, clamped; the median
    ``sample[m // 2]``). None for an empty sample."""
    m = len(sample)
    if m == 0:
        return None
    if q == 0.5:
        return sample[m // 2]
    return sample[min(m - 1, int(m * q))]


def bucket_quantile(buckets: dict, count: int, q: float,
                    hi: Optional[float] = None) -> Optional[float]:
    """Quantile interpolated from a cumulative-bucket export
    (``{"bounds": [...], "counts": [...]}``): linear within the bucket
    that holds the target rank; ranks past the last finite bound clamp to
    ``hi`` (the observed max) or the last bound. None when empty."""
    if count <= 0 or not buckets:
        return None
    bounds = buckets.get("bounds") or []
    counts = buckets.get("counts") or []
    target = q * count
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in zip(bounds, counts):
        if cum >= target:
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return bound
            frac = (target - prev_cum) / in_bucket
            return prev_bound + (bound - prev_bound) * min(1.0, frac)
        prev_bound, prev_cum = bound, cum
    if hi is not None:
        return float(hi)
    return float(bounds[-1]) if bounds else None


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


def write_chrome_trace(path: str, extra_events: Optional[list] = None):
    """Write the buffered host spans as Chrome trace events (wall-clock
    microseconds), led by ``process_name`` / ``thread_name`` metadata
    events that name this process's lanes; ``extra_events`` are
    appended as they are. Returns the number of events written."""
    import sys

    spans_ = list(_spans)
    pid = os.getpid()
    thread_names = {t.ident: t.name for t in threading.enumerate()}
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "%s (pid %d)"
                      % (os.path.basename(sys.argv[0] or "python"),
                         pid)}}]
    for tid in sorted({tid for _, tid, _, _ in spans_}):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid,
                     "args": {"name": thread_names.get(
                         tid, "tid-%d" % tid)}})
    events = meta + [
        {"name": name, "ph": "X", "cat": "host",
         "pid": pid, "tid": tid,
         "ts": (t0 + _EPOCH) * 1e6, "dur": dur * 1e6}
        for name, tid, t0, dur in spans_]
    if extra_events:
        events.extend(extra_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def _is_hist_export(d) -> bool:
    return isinstance(d, dict) and "count" in d and "buckets" in d


_MERGE_SAMPLE_CAP = 4096


def _merge_hist(a: dict, b: dict) -> dict:
    ba, bb = a.get("buckets") or {}, b.get("buckets") or {}
    bounds_a = list(ba.get("bounds") or [])
    bounds_b = list(bb.get("bounds") or [])
    if bounds_a and bounds_b and bounds_a != bounds_b:
        raise MXNetError(
            "merge_snapshots: conflicting histogram bucket bounds "
            "%r vs %r — federation requires one ladder per metric"
            % (bounds_a, bounds_b))
    n = int(a.get("count", 0)) + int(b.get("count", 0))
    bounds = bounds_a or bounds_b
    counts_a = list(ba.get("counts") or [0] * len(bounds))
    counts_b = list(bb.get("counts") or [0] * len(bounds))
    counts = [x + y for x, y in zip(counts_a, counts_b)]
    out = {"count": n, "buckets": {"bounds": bounds, "counts": counts}}
    if n == 0:
        return out
    out["sum"] = float(a.get("sum", 0.0)) + float(b.get("sum", 0.0))
    out["mean"] = out["sum"] / n
    mins = [v for v in (a.get("min"), b.get("min")) if v is not None]
    maxs = [v for v in (a.get("max"), b.get("max")) if v is not None]
    if mins:
        out["min"] = min(mins)
    if maxs:
        out["max"] = max(maxs)
    sample = sorted((a.get("sample") or []) + (b.get("sample") or []))
    if len(sample) > _MERGE_SAMPLE_CAP:
        # decimate evenly rather than truncate: keeps the distribution
        step = len(sample) / float(_MERGE_SAMPLE_CAP)
        sample = [sample[int(i * step)] for i in range(_MERGE_SAMPLE_CAP)]
    if sample:
        out["sample"] = sample
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[key] = sample_quantile(sample, q)
    else:
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = bucket_quantile(out["buckets"], n, q, hi=out.get("max"))
            if v is not None:
                out[key] = v
    return out


def _merge_into(dst: dict, src: dict, path: str):
    for k, v in src.items():
        here = "%s.%s" % (path, k) if path else k
        if k not in dst:
            dst[k] = copy.deepcopy(v)
            continue
        cur = dst[k]
        if _is_hist_export(cur) and _is_hist_export(v):
            dst[k] = _merge_hist(cur, v)
        elif _is_hist_export(cur) or _is_hist_export(v):
            raise MXNetError("merge_snapshots: %r is a histogram in one "
                             "snapshot and not in another" % here)
        elif isinstance(cur, dict) and isinstance(v, dict):
            _merge_into(cur, v, here)
        elif isinstance(cur, (int, float)) and isinstance(v, (int, float)):
            # counters and gauges both merge by sum
            dst[k] = cur + v
        else:
            raise MXNetError("merge_snapshots: %r has mismatched kinds "
                             "(%s vs %s)" % (here, type(cur).__name__,
                                             type(v).__name__))


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge :func:`snapshot`-shaped dicts into one roll-up: counters and
    gauges sum, histograms merge bucket-wise (percentiles exact from the
    merged samples where every input carried one, else interpolated from
    the buckets); conflicting bucket ladders raise. Inputs are never
    mutated."""
    out: dict = {}
    for s in snaps:
        if s:
            _merge_into(out, s, "")
    return out


def dump_jsonl(path: str, extra: Optional[dict] = None) -> dict:
    """Append ONE step record (timestamp, step index, the snapshot, and
    ``extra``) to ``path`` in a single ``os.write`` on an ``O_APPEND``
    descriptor, so a crash or a concurrent writer can cut at most the
    last line. ``MXNET_TPU_TELEMETRY_FSYNC`` adds an fsync a record."""
    global _step
    with _step_lock:
        _step += 1
        step = _step
    rec = {"ts": round(time.time(), 6), "step": step,
           "telemetry": snapshot()}
    if extra:
        rec.update(extra)
    line = (json.dumps(rec) + "\n").encode("utf-8")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line)
        if _env.get("MXNET_TPU_TELEMETRY_FSYNC"):
            os.fsync(fd)
    finally:
        os.close(fd)
    return rec


def reset():
    """Clear every metric, span and the record counter; the enabled flag
    stays as it is."""
    global _step
    with _reg_lock:
        _metrics.clear()
    _spans.clear()
    with _step_lock:
        _step = 0
