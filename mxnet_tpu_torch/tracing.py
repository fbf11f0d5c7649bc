"""Step traces, anomaly detection, flight recording and live metrics,
counterpart of ``mxnet_tpu/tracing.py``.

* :class:`StepTrace`: once per training step, the deltas of every
  tracked telemetry counter (:data:`DELTA_SOURCES`) beside the step's
  latency, in a bounded ring, each record labeled with what the step
  spent its time on (:meth:`StepTrace._dominant`).
* Anomaly detectors over that ring (:func:`default_detectors`): slow
  step, steady-state recapture, input stall, slow request, fleet
  health, and the numerics plane's loss spike, gradient explosion, dead
  update and nonfinite alarms. With ``MXNET_TPU_TRACE_ON_ANOMALY`` an
  event opens a short, rate-limited ``torch.profiler`` window
  (:class:`AnomalyProfiler`).
* :class:`FlightRecorder`: ``sys.excepthook`` and SIGTERM/SIGUSR1
  handlers that dump the reason, all-thread stacks, a telemetry
  snapshot, the step ring (``steps.jsonl``) and the numerics plane's
  health rows (``numwatch.jsonl``) into a crash directory. On SIGTERM it
  then runs the registered preemption hooks and re-raises the signal, so
  the process ends as it would have without the recorder, unless a hook
  returned ``"defer"``: the hook's owner then re-delivers SIGTERM itself
  at its next safe point (the checkpoint manager does so at the end of
  the step under way).
* :class:`MetricsServer`: a stdlib ``http.server`` thread serving the
  Prometheus text format at ``/metrics`` and liveness JSON at
  ``/healthz`` (``MXNET_TPU_METRICS_PORT``), every sample labeled with
  the worker rank.

Everything here is off unless telemetry is enabled: :func:`record_step`
and :func:`maybe_init` start with one flag check and return at once,
taking no lock and allocating nothing.
"""
from __future__ import annotations

import http.server
import json
import logging
import math
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

from . import env as _env
from . import telemetry as _tel

__all__ = ["StepTrace", "SlowStepDetector", "RecompileDetector",
           "InputStallDetector", "SlowRequestDetector",
           "FleetHealthDetector", "LossSpikeDetector",
           "GradExplosionDetector", "DeadUpdateDetector",
           "NonfiniteDetector", "AnomalyProfiler", "FlightRecorder",
           "MetricsServer", "DELTA_SOURCES", "default_detectors",
           "prometheus_text", "step_trace", "record_step", "maybe_init",
           "metrics_server", "set_worker_rank", "worker_rank",
           "register_health_probe", "unregister_health_probe",
           "register_health_info", "unregister_health_info",
           "register_preempt_hook", "unregister_preempt_hook",
           "ensure_flight_recorder", "flight_recorder", "shutdown"]

_log = logging.getLogger(__name__)

# Per-step delta sources: (record field, telemetry metric, kind).
# "counter" reads the running int; "hist_sum" reads a histogram's running
# sum (the stall histograms observe milliseconds, so their sum delta is
# the ms this step spent stalled). The port has no executor compiles and
# no compile registry, so recompiles and compiles stay 0 unless a caller
# records them; a fused-step recapture counts step.fused_recompiles.
DELTA_SOURCES = (
    ("io_stall_ms", "io.pipeline.stall_ms", "hist_sum"),
    ("prefetch_stall_ms", "io.prefetch_stall_ms", "hist_sum"),
    ("feed_stall_ms", "io.feed_stall_ms", "hist_sum"),
    ("h2d_bytes", "ndarray.h2d_bytes", "counter"),
    ("kv_push_bytes", "kvstore.push_bytes", "counter"),
    ("kv_pull_bytes", "kvstore.pull_bytes", "counter"),
    ("decode_cache_hits", "io.decode_cache_hit", "counter"),
    ("recompiles", "executor.jit_build", "counter"),
    ("dispatches", "step.dispatches", "counter"),
    ("fused_recompiles", "step.fused_recompiles", "counter"),
    ("fallbacks", "step.fused_fallback", "counter"),
    ("sanitizer_trips", "sanitizer.trips", "counter"),
    ("compiles", "compile.count", "counter"),
    ("compile_ms", "compile.time_ms", "hist_sum"),
    ("ckpt_saves", "ckpt.saves", "counter"),
    ("ckpt_save_ms", "ckpt.save_ms", "hist_sum"),
    ("numwatch_skipped", "numwatch.skipped_steps", "counter"),
    ("numwatch_rolled_back", "numwatch.rollbacks", "counter"),
)

_STALL_FIELDS = ("io_stall_ms", "prefetch_stall_ms", "feed_stall_ms")


# ---------------------------------------------------------------------------
# anomaly detectors
# ---------------------------------------------------------------------------

class SlowStepDetector:
    """A step whose latency exceeds ``k`` times the rolling median of the
    preceding ``window`` steps, after ``warmup`` steps (so the eager and
    capturing steps do not poison the baseline)."""

    type = "slow_step"

    def __init__(self, k: float = 3.0, warmup: int = 10, window: int = 64):
        self.k = float(k)
        self.warmup = int(warmup)
        self._lat = deque(maxlen=int(window))

    def check(self, rec: dict) -> Optional[dict]:
        lat = rec["latency_ms"]
        prior = sorted(self._lat)
        self._lat.append(lat)
        if rec["step"] <= self.warmup or not prior:
            return None
        median = prior[len(prior) // 2]
        if median > 0 and lat > self.k * median:
            return {"type": self.type, "latency_ms": round(lat, 3),
                    "median_ms": round(median, 3),
                    "ratio": round(lat / median, 2)}
        return None


class RecompileDetector:
    """A build, compile or fused-step recapture past ``warmup`` steps: a
    shape or the update's structure drifted mid-run."""

    type = "recompile"

    def __init__(self, warmup: int = 10):
        self.warmup = int(warmup)

    def check(self, rec: dict) -> Optional[dict]:
        n = rec["deltas"].get("recompiles", 0)
        nf = rec["deltas"].get("fused_recompiles", 0)
        nc = rec["deltas"].get("compiles", 0)
        if rec["step"] > self.warmup and (n > 0 or nf > 0 or nc > 0):
            ev = {"type": self.type, "recompiles": n,
                  "latency_ms": round(rec["latency_ms"], 3)}
            if nf:
                ev["fused_recompiles"] = nf
            if nc:
                ev["compiles"] = nc
                ev["compile_ms"] = rec["deltas"].get("compile_ms", 0.0)
            return ev
        return None


class InputStallDetector:
    """A step that spent more than ``frac`` of its wall time blocked on
    the input pipeline."""

    type = "input_stall"

    def __init__(self, frac: float = 0.5, min_ms: float = 1.0):
        self.frac = float(frac)
        self.min_ms = float(min_ms)

    def check(self, rec: dict) -> Optional[dict]:
        stall = sum(rec["deltas"].get(f, 0.0) for f in _STALL_FIELDS)
        lat = rec["latency_ms"]
        if stall >= self.min_ms and lat > 0 and stall > self.frac * lat:
            return {"type": self.type, "stall_ms": round(stall, 3),
                    "latency_ms": round(lat, 3),
                    "stall_frac": round(stall / lat, 2)}
        return None


class SlowRequestDetector:
    """Serving SLO guard: a record whose worst request latency
    (``request_ms``) exceeds its SLO (``slo_ms``); the event copies the
    scheduler's state and the sampled trace id where the record has
    them. Inert on training records."""

    type = "slow_request"

    def check(self, rec: dict) -> Optional[dict]:
        req = rec.get("request_ms")
        slo = rec.get("slo_ms")
        if req is not None and slo and req > slo:
            ev = {"type": self.type, "request_ms": round(req, 3),
                  "slo_ms": round(float(slo), 3),
                  "over_frac": round(req / slo - 1.0, 3)}
            for k in ("adaptive_wait_ms", "queue_depth", "worst_trace_id"):
                if rec.get(k) is not None:
                    ev[k] = rec[k]
            return ev
        return None


class FleetHealthDetector:
    """Fleet guard: a record stamped with dead replicas
    (``fleet_down``), open breakers (``breaker_open``) or an SLO burn
    alert. Inert on training and single-replica records."""

    type = "fleet_degraded"

    def check(self, rec: dict) -> Optional[dict]:
        down = rec.get("fleet_down", 0)
        tripped = rec.get("breaker_open", 0)
        burn = rec.get("slo_burn_alert", 0)
        if down or tripped or burn:
            ev = {"type": self.type}
            if down:
                ev["replicas_down"] = int(down)
            if tripped:
                ev["breakers_open"] = int(tripped)
            if burn:
                ev["slo_burn_alert"] = 1
                for k in ("slo_burn_fast", "slo_burn_slow",
                          "slo_budget_spent"):
                    if rec.get(k) is not None:
                        ev[k] = round(float(rec[k]), 4)
            if rec.get("fleet_size") is not None:
                ev["fleet_size"] = int(rec["fleet_size"])
            return ev
        return None


class LossSpikeDetector:
    """The fetched loss (``numwatch_loss``) above
    ``MXNET_TPU_NUMWATCH_SPIKE_K`` times its rolling median. Inert on
    records without the stamp."""

    type = "loss_spike"

    def __init__(self, k: Optional[float] = None, window: int = 32):
        self.k = float(k if k is not None
                       else _env.get("MXNET_TPU_NUMWATCH_SPIKE_K"))
        self._hist: deque = deque(maxlen=window)

    def check(self, rec: dict) -> Optional[dict]:
        loss = rec.get("numwatch_loss")
        if loss is None or not math.isfinite(loss):
            return None
        prior = sorted(self._hist)
        self._hist.append(float(loss))
        if len(prior) < 3:
            return None
        median = prior[len(prior) // 2]
        if median > 0 and loss > self.k * median:
            return {"type": self.type, "loss": round(float(loss), 6),
                    "median": round(median, 6),
                    "ratio": round(float(loss) / median, 2)}
        return None


class GradExplosionDetector:
    """The fetched global gradient norm (``numwatch_grad_norm``) above
    ``MXNET_TPU_NUMWATCH_EXPLODE_K`` times its rolling median."""

    type = "grad_explosion"

    def __init__(self, k: Optional[float] = None, window: int = 32):
        self.k = float(k if k is not None
                       else _env.get("MXNET_TPU_NUMWATCH_EXPLODE_K"))
        self._hist: deque = deque(maxlen=window)

    def check(self, rec: dict) -> Optional[dict]:
        norm = rec.get("numwatch_grad_norm")
        if norm is None or not math.isfinite(norm):
            return None
        prior = sorted(self._hist)
        self._hist.append(float(norm))
        if len(prior) < 3:
            return None
        median = prior[len(prior) // 2]
        if median > 0 and norm > self.k * median:
            return {"type": self.type,
                    "grad_norm": round(float(norm), 6),
                    "median": round(median, 6),
                    "ratio": round(float(norm) / median, 2)}
        return None


class DeadUpdateDetector:
    """Every update-to-weight ratio (``numwatch_uw_max``) below
    ``MXNET_TPU_NUMWATCH_DEAD_UW`` while gradients still flow."""

    type = "dead_update"

    def __init__(self, threshold: Optional[float] = None):
        self.threshold = float(
            threshold if threshold is not None
            else _env.get("MXNET_TPU_NUMWATCH_DEAD_UW"))

    def check(self, rec: dict) -> Optional[dict]:
        uw = rec.get("numwatch_uw_max")
        if uw is None:
            return None
        norm = rec.get("numwatch_grad_norm") or 0.0
        if uw < self.threshold and norm > 0 and math.isfinite(norm):
            return {"type": self.type, "uw_max": float(uw),
                    "grad_norm": round(float(norm), 6),
                    "threshold": self.threshold}
        return None


class NonfiniteDetector:
    """Any nonfinite weight or gradient element seen by a fetch
    (``numwatch_nonfinite``), with the provenance verdict and the guard
    counters."""

    type = "nonfinite"

    def check(self, rec: dict) -> Optional[dict]:
        n = rec.get("numwatch_nonfinite")
        if not n:
            return None
        ev = {"type": self.type, "nonfinite": int(n)}
        for k in ("numwatch_bad_tensor", "numwatch_skips",
                  "numwatch_rollbacks"):
            if rec.get(k) is not None:
                ev[k.replace("numwatch_", "")] = rec[k]
        return ev


def default_detectors() -> list:
    return [SlowStepDetector(), RecompileDetector(), InputStallDetector(),
            SlowRequestDetector(), FleetHealthDetector(),
            LossSpikeDetector(), GradExplosionDetector(),
            DeadUpdateDetector(), NonfiniteDetector()]


# ---------------------------------------------------------------------------
# /healthz probes and info
# ---------------------------------------------------------------------------

_probe_lock = threading.Lock()
_health_probes: Dict[str, object] = {}
_health_info: Dict[str, object] = {}


def register_health_probe(name: str, probe):
    """A liveness probe for ``/healthz``: a callable returning None when
    healthy, else a JSON-able detail; any failing probe turns the
    endpoint to ``{"status": "degraded"}`` with HTTP 503."""
    with _probe_lock:
        _health_probes[name] = probe


def unregister_health_probe(name: str):
    with _probe_lock:
        _health_probes.pop(name, None)


def register_health_info(name: str, info):
    """An info provider for ``/healthz``: a callable returning a
    JSON-able dict merged into every payload (existing keys win)."""
    with _probe_lock:
        _health_info[name] = info


def unregister_health_info(name: str):
    with _probe_lock:
        _health_info.pop(name, None)


def _run_health_info() -> Dict[str, object]:
    """The merged info payload; a provider that raises contributes an
    error string."""
    with _probe_lock:
        infos = list(_health_info.items())
    merged: Dict[str, object] = {}
    for name, info in infos:
        try:
            detail = info()
            if detail:
                merged.update(dict(detail))
        except Exception as e:
            merged[name] = "info provider raised: %s" % (e,)
    return merged


def _run_health_probes() -> Dict[str, object]:
    """Failing probes by name ({} is healthy); a probe that raises is a
    failure."""
    with _probe_lock:
        probes = list(_health_probes.items())
    failing = {}
    for name, probe in probes:
        try:
            detail = probe()
        except Exception as e:
            detail = "probe raised: %s" % (e,)
        if detail is not None:
            failing[name] = detail
    return failing


# ---------------------------------------------------------------------------
# anomaly-triggered profiling
# ---------------------------------------------------------------------------

class AnomalyProfiler:
    """Opens a short ``torch.profiler`` window when an anomaly fires, so
    the evidence is captured while it is still happening: at most one
    window a ``cooldown_s`` (suppressed triggers are counted), never
    while another profiler runs. The window's Chrome trace lands in
    ``trace_dir/step<N>_<type>/trace.json``. ``start_fn``/``stop_fn``
    replace the profiler (tests)."""

    def __init__(self, trace_dir: Optional[str] = None,
                 window_steps: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 start_fn: Optional[Callable] = None,
                 stop_fn: Optional[Callable] = None):
        self.trace_dir = trace_dir or _env.get(
            "MXNET_TPU_TRACE_DIR",
            default=os.path.join(tempfile.gettempdir(),
                                 "mxnet_tpu_anomaly_trace"))
        self.window_steps = int(window_steps if window_steps is not None
                                else _env.get("MXNET_TPU_TRACE_WINDOW"))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _env.get("MXNET_TPU_TRACE_COOLDOWN"))
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._prof = None
        self._path = None
        self._last_start: Optional[float] = None
        self._stop_at: Optional[int] = None
        self.started = 0
        self.suppressed = 0

    def _start(self, path: str):
        if self._start_fn is not None:
            return self._start_fn(path)
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._path = path

    def _stop(self):
        if self._stop_fn is not None:
            return self._stop_fn()
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(self._path, "trace.json"))

    def on_anomaly(self, step: int, event: dict) -> bool:
        """Maybe open a window for ``event``; True if one started."""
        if self._stop_at is not None:
            return False
        if self._start_fn is None:
            import torch

            if torch.autograd._profiler_enabled():
                return False   # a user's profiler is running: stay out
        now = time.monotonic()
        if self._last_start is not None \
                and now - self._last_start < self.cooldown_s:
            self.suppressed += 1
            _tel.inc("tracing.auto_trace_suppressed")
            return False
        path = os.path.join(self.trace_dir,
                            "step%d_%s" % (step, event["type"]))
        try:
            os.makedirs(path, exist_ok=True)
            self._start(path)
        except Exception as e:
            _log.warning("anomaly trace start failed: %s", e)
            return False
        self._last_start = now
        self._stop_at = step + self.window_steps
        self.started += 1
        _tel.inc("tracing.auto_traces")
        _log.warning("anomaly at step %d (%s): capturing %d-step trace "
                     "into %s", step, event["type"], self.window_steps, path)
        return True

    def on_step(self, step: int):
        """Close the window once ``window_steps`` more steps passed."""
        if self._stop_at is not None and step >= self._stop_at:
            self._stop_at = None
            try:
                self._stop()
            except Exception as e:
                _log.warning("anomaly trace stop failed: %s", e)


# ---------------------------------------------------------------------------
# step trace recorder
# ---------------------------------------------------------------------------

class StepTrace:
    """Bounded ring of per-step records, each with the telemetry deltas
    of its step. ``record(latency_ms)`` is called once a training step
    (the fit loop); step 1's deltas count from the counters at
    construction."""

    def __init__(self, capacity: Optional[int] = None, detectors=None,
                 profiler: Optional[AnomalyProfiler] = None,
                 event_cooldown: Optional[int] = None):
        cap = int(capacity if capacity is not None
                  else _env.get("MXNET_TPU_TRACE_RING"))
        self._ring: deque = deque(maxlen=max(1, cap))
        self._lock = threading.Lock()
        self._step = 0
        self._prev = self._raw_values()
        self.detectors = (default_detectors() if detectors is None
                          else list(detectors))
        if profiler is None and _env.get("MXNET_TPU_TRACE_ON_ANOMALY"):
            profiler = AnomalyProfiler()
        self.profiler = profiler
        self.events: deque = deque(maxlen=256)
        self.event_cooldown = int(
            event_cooldown if event_cooldown is not None
            else _env.get("MXNET_TPU_TRACE_EVENT_COOLDOWN"))
        self._last_event_step: Dict[str, int] = {}

    @staticmethod
    def _raw_values() -> Dict[str, float]:
        return {field: _tel.peek(metric, kind) or 0
                for field, metric, kind in DELTA_SOURCES}

    @staticmethod
    def _dominant(deltas: Dict[str, float], latency_ms: float) -> str:
        """What the step spent its time on: a measured compile, then a
        build or recapture, then a stall source above a quarter of the
        wall time; otherwise compute."""
        if deltas.get("compiles", 0) > 0:
            return "compile"
        if deltas.get("recompiles", 0) > 0 \
                or deltas.get("fused_recompiles", 0) > 0:
            return "recompile"
        worst, field = max((deltas.get(f, 0.0), f) for f in _STALL_FIELDS)
        if latency_ms > 0 and worst > 0.25 * latency_ms:
            return field
        return "compute"

    def record(self, latency_ms: float, extra: Optional[dict] = None) -> dict:
        """Snapshot the counters, take the deltas against the previous
        step, run the detectors; returns the appended record."""
        raw = self._raw_values()
        with self._lock:
            self._step += 1
            step = self._step
            deltas = {}
            for field, _metric, kind in DELTA_SOURCES:
                d = raw[field] - self._prev.get(field, 0)
                deltas[field] = round(d, 3) if kind == "hist_sum" \
                    else int(d)
            self._prev = raw
            rec = {"step": step, "ts": round(time.time(), 6),
                   "latency_ms": round(float(latency_ms), 3),
                   "deltas": deltas,
                   "dominant": self._dominant(deltas, latency_ms)}
            if extra:
                rec.update(extra)
            self._ring.append(rec)
        if self.profiler is not None:
            self.profiler.on_step(step)
        for det in self.detectors:
            try:
                ev = det.check(rec)
            except Exception as e:
                _log.warning("anomaly detector %s failed: %s",
                             type(det).__name__, e)
                continue
            if ev is None:
                continue
            last = self._last_event_step.get(ev["type"])
            if last is not None and step - last < self.event_cooldown:
                continue
            self._last_event_step[ev["type"]] = step
            ev.update(step=step, ts=rec["ts"], dominant=rec["dominant"])
            self.events.append(ev)
            _tel.inc("tracing.anomalies")
            _tel.inc("tracing.anomaly.%s" % ev["type"])
            _log.warning("step %d anomaly %s: %s", step, ev["type"],
                         {k: v for k, v in ev.items()
                          if k not in ("type", "step", "ts")})
            if self.profiler is not None \
                    and self.profiler.on_anomaly(step, ev):
                ev["trace_started"] = True
        return rec

    @property
    def step(self) -> int:
        return self._step

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def dump_jsonl(self, path: str) -> int:
        """Write the ring, one record a line; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
        return len(recs)

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._step = 0
            self._prev = self._raw_values()
            self.events.clear()
            self._last_event_step.clear()


# ---------------------------------------------------------------------------
# flight recorder and preemption hooks
# ---------------------------------------------------------------------------

def _format_all_stacks() -> str:
    """Every thread's current stack."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append("Thread %s (%d):" % (names.get(tid, "?"), tid))
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


# Callables run from the SIGTERM handler before the signal is re-raised
# (signal-handler context: keep them short). A hook that returns "defer"
# suppresses the re-raise and must re-deliver SIGTERM itself once it is
# safe. A hook's exception is logged and swallowed: a broken hook must not
# mask the preemption.
_preempt_hooks: List[Callable[[], Optional[str]]] = []
_preempt_lock = threading.Lock()


def register_preempt_hook(fn: Callable[[], Optional[str]]):
    """Run ``fn()`` on SIGTERM before termination proceeds."""
    with _preempt_lock:
        if fn not in _preempt_hooks:
            _preempt_hooks.append(fn)
    return fn


def unregister_preempt_hook(fn: Callable[[], Optional[str]]):
    with _preempt_lock:
        try:
            _preempt_hooks.remove(fn)
        except ValueError:
            pass


def _run_preempt_hooks() -> bool:
    """True when any hook deferred termination."""
    with _preempt_lock:
        hooks = list(_preempt_hooks)
    defer = False
    for fn in hooks:
        try:
            if fn() == "defer":
                defer = True
        except Exception as e:
            _log.error("preempt hook %r failed: %s", fn, e)
    return defer


class FlightRecorder:
    """Dumps the reason, all-thread stacks, a telemetry snapshot, the step
    ring (``trace``, else the process's :func:`step_trace` where one
    exists) and the numerics plane's health rows into ``crash_dir``
    (default ``MXNET_TPU_CRASH_DIR``, else ``$TMPDIR/mxnet_tpu_crash``)
    on an unhandled exception, SIGTERM or SIGUSR1 (the run continues).
    ``install()`` chains the previous excepthook and signal handlers;
    ``uninstall()`` puts them back."""

    def __init__(self, crash_dir: Optional[str] = None, trace=None):
        self.crash_dir = crash_dir or _env.get(
            "MXNET_TPU_CRASH_DIR",
            default=os.path.join(tempfile.gettempdir(), "mxnet_tpu_crash"))
        self._trace = trace
        self._installed = False
        self._prev_excepthook = None
        self._prev_handlers: Dict[int, object] = {}
        self._dump_count = 0

    def _ring(self) -> Optional[StepTrace]:
        return self._trace if self._trace is not None else _recorder

    def dump(self, reason: str, exc_info=None) -> Optional[str]:
        """Write one dump directory and return its path; never raises (a
        broken disk must not mask the failure being recorded), None when
        the dump could not be written."""
        try:
            self._dump_count += 1
            d = os.path.join(self.crash_dir, "flight-%s-pid%d-%d"
                             % (time.strftime("%Y%m%dT%H%M%S"), os.getpid(),
                                self._dump_count))
            os.makedirs(d, exist_ok=True)
            tr = self._ring()
            meta = {"reason": reason, "ts": round(time.time(), 6),
                    "pid": os.getpid(), "rank": worker_rank(),
                    "argv": list(sys.argv),
                    "steps_recorded": tr.step if tr is not None else 0,
                    "events": list(tr.events) if tr is not None else []}
            if exc_info is not None and exc_info[0] is not None:
                meta["exception"] = "".join(
                    traceback.format_exception(*exc_info))
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
            with open(os.path.join(d, "stacks.txt"), "w") as f:
                f.write(_format_all_stacks())
            with open(os.path.join(d, "telemetry.json"), "w") as f:
                json.dump(_tel.snapshot(), f, indent=1)
            if tr is not None:
                tr.dump_jsonl(os.path.join(d, "steps.jsonl"))
            from . import numwatch as _numwatch

            rows = _numwatch.health_rows()
            if rows:
                with open(os.path.join(d, "numwatch.jsonl"), "w") as f:
                    for row in rows:
                        f.write(json.dumps(row) + "\n")
            _log.error("flight recorder dump (%s) written to %s", reason, d)
            return d
        except Exception as e:
            _log.error("flight recorder dump failed: %s", e)
            return None

    def install(self) -> "FlightRecorder":
        if self._installed:
            return self
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                # not the main thread: the exception hook and dump() work
                pass
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _excepthook(self, etype, value, tb):
        self.dump("exception:%s" % etype.__name__, (etype, value, tb))
        (self._prev_excepthook or sys.__excepthook__)(etype, value, tb)

    def _on_signal(self, signum, frame):
        self.dump("signal:%s" % signal.Signals(signum).name)
        if signum != signal.SIGTERM:
            return
        if _run_preempt_hooks():
            return
        # the prior disposition back, then the signal again: termination
        # proceeds as it would have without the recorder
        prev = self._prev_handlers.get(signum)
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signum)


# ---------------------------------------------------------------------------
# live metrics exposition
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return "mxnet_tpu_" + "".join(ch if ch.isalnum() or ch == "_" else "_"
                                  for ch in name)


def _prom_labels(**labels) -> str:
    """``{k="v",...}`` with the values escaped (backslash, quote and
    newline), keys in the given order."""
    def esc(v):
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))
    return "{%s}" % ",".join('%s="%s"' % (k, esc(v))
                             for k, v in labels.items())


def prometheus_text() -> str:
    """The registry in the Prometheus text exposition format (0.0.4):
    counters and gauges as they are, histograms as cumulative ``le``
    buckets closing with ``+Inf`` plus ``_sum`` and ``_count``; every
    sample carries the worker rank."""
    rank = worker_rank()
    lbl = _prom_labels(rank=rank)
    lines = []
    for name, m in _tel.metrics_items():
        pname = _prom_name(name)
        if isinstance(m, _tel.Counter):
            lines.append("# TYPE %s counter" % pname)
            lines.append("%s%s %d" % (pname, lbl, m.value))
        elif isinstance(m, _tel.Gauge):
            lines.append("# TYPE %s gauge" % pname)
            lines.append("%s%s %s" % (pname, lbl, repr(m.value)))
        elif isinstance(m, _tel.Histogram):
            ex = m.export()
            count = ex.get("count", 0)
            buckets = ex["buckets"]
            lines.append("# TYPE %s histogram" % pname)
            for bound, cum in zip(buckets["bounds"], buckets["counts"]):
                lines.append("%s_bucket%s %d" % (
                    pname, _prom_labels(rank=rank, le="%g" % bound), cum))
            lines.append("%s_bucket%s %d"
                         % (pname, _prom_labels(rank=rank, le="+Inf"),
                            count))
            lines.append("%s_sum%s %s" % (pname, lbl, repr(ex.get("sum", 0))))
            lines.append("%s_count%s %d" % (pname, lbl, count))
    return "\n".join(lines) + "\n"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-metrics/1"

    def do_GET(self):   # noqa: N802 (http.server API)
        path = self.path.split("?")[0]
        status = 200
        if path == "/metrics":
            body = prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            tr = _recorder
            failing = _run_health_probes()
            payload = {
                "status": "degraded" if failing else "ok",
                "pid": os.getpid(), "rank": worker_rank(),
                "uptime_s": round(time.time() - self.server.started_at, 3),
                "steps": tr.step if tr is not None else 0,
                "anomalies": len(tr.events) if tr is not None else 0}
            for k, v in _run_health_info().items():
                payload.setdefault(k, v)
            if failing:
                payload["probes"] = failing
                status = 503   # a load balancer drains without parsing
            body = json.dumps(payload).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):   # scrapes must not spam stderr
        _log.debug("metrics server: " + fmt, *args)


class MetricsServer:
    """Threaded HTTP server for ``/metrics`` and ``/healthz``; port 0
    binds an ephemeral port, exposed as ``.port``."""

    def __init__(self, port: int, host: str = ""):
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _MetricsHandler)
        self._httpd.daemon_threads = True
        self._httpd.started_at = time.time()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-metrics",
            daemon=True)
        self._thread.start()

    def stop(self):
        """Shut the server down and join its thread. Idempotent."""
        th, self._thread = self._thread, None
        if th is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        th.join(timeout=5.0)

    close = stop


# ---------------------------------------------------------------------------
# process-global wiring
# ---------------------------------------------------------------------------

_init_lock = threading.Lock()
_recorder: Optional[StepTrace] = None
_metrics_server: Optional[MetricsServer] = None
_flight_recorder: Optional[FlightRecorder] = None
_atexit_registered = False
_worker_rank = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)


def set_worker_rank(rank: int):
    """Tag exported metrics with this process's worker rank."""
    global _worker_rank
    _worker_rank = int(rank)


def worker_rank() -> int:
    return _worker_rank


def step_trace() -> StepTrace:
    """The process's step recorder, created on first use."""
    global _recorder
    if _recorder is None:
        with _init_lock:
            if _recorder is None:
                _recorder = StepTrace()
    return _recorder


def record_step(latency_ms: float, extra: Optional[dict] = None):
    """Fit-loop hook: one step into the process's ring. One flag check
    while telemetry is off."""
    if not _tel._ENABLED:
        return None
    return step_trace().record(latency_ms, extra)


def _register_atexit():
    global _atexit_registered
    if not _atexit_registered:
        import atexit

        atexit.register(shutdown)
        _atexit_registered = True


def maybe_init():
    """Set-up from the environment at fit() entry: the metrics server on
    ``MXNET_TPU_METRICS_PORT``, the flight recorder with
    ``MXNET_TPU_FLIGHT_RECORDER``; :func:`shutdown` at exit. Idempotent;
    one flag check while telemetry is off."""
    if not _tel._ENABLED:
        return None
    global _metrics_server, _flight_recorder
    with _init_lock:
        port = _env.get("MXNET_TPU_METRICS_PORT")
        if _metrics_server is None and port:
            try:
                _metrics_server = MetricsServer(int(port))
                _log.info("metrics server listening on :%d (/metrics, "
                          "/healthz)", _metrics_server.port)
            except (OSError, ValueError) as e:
                _log.warning("metrics server failed to start on %r: %s",
                             port, e)
        if _flight_recorder is None \
                and _env.get("MXNET_TPU_FLIGHT_RECORDER"):
            _flight_recorder = FlightRecorder().install()
        _register_atexit()
    return _metrics_server


def metrics_server() -> Optional[MetricsServer]:
    return _metrics_server


def flight_recorder() -> Optional[FlightRecorder]:
    return _flight_recorder


def ensure_flight_recorder() -> FlightRecorder:
    """The process's flight recorder, installed on first call whatever
    ``MXNET_TPU_FLIGHT_RECORDER`` says, with :func:`shutdown` registered
    at exit (the checkpoint manager's SIGTERM path needs its signal
    routing)."""
    global _flight_recorder
    with _init_lock:
        if _flight_recorder is None:
            _flight_recorder = FlightRecorder().install()
        _register_atexit()
        return _flight_recorder


def shutdown():
    """Stop the metrics server (joining its thread), uninstall the
    flight recorder and drop the step recorder. Idempotent."""
    global _recorder, _metrics_server, _flight_recorder
    with _init_lock:
        server, _metrics_server = _metrics_server, None
        if _flight_recorder is not None:
            _flight_recorder.uninstall()
            _flight_recorder = None
        _recorder = None
    if server is not None:
        server.stop()
