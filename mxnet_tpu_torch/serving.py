"""Batched inference serving, counterpart of ``mxnet_tpu/serving.py``
(distributed-trace spans and injected faults wait for a later slice,
ROADMAP.md Queue A item 12).

* :func:`bucket_ladder` — the padded batch sizes: each dispatched batch
  is padded with zero rows up to the next rung, so the served batch
  shapes are few and fixed; every rung is a multiple of the batch's
  shards (``dp``).
* :class:`BatchScheduler` — a deadline-aware continuous batcher. Every
  request carries a ``priority`` lane (interactive or batch) and a
  ``deadline_ms`` (given, or the lane's default from the SLO). One
  worker thread admits requests, sheds the lowest-priority, most-expired
  ones under overload (:class:`RequestShed`), decides when to dispatch
  (``_decide``: full, deadline, rung_fill, idle or window) and packs the
  batch earliest deadline first. A closed-loop
  :class:`AdaptiveWaitController` replaces the fixed ``max_wait_ms`` when
  an SLO is set: it widens the coalescing window while the recent p99
  has headroom and collapses it near breach. Every request's latency
  splits exactly into queue, scheduler hold, H2D, device and D2H
  (``Request.components``). The worker enters ``torch.inference_mode()``
  itself, since the mode is thread-local. An error in a dispatch (a CUDA
  fault included) is stored on every request of that batch and raised to
  its caller by :meth:`Request.get`. ``clock=`` and ``autostart=False``
  make the whole decision plane drivable from a fake-clock test through
  :meth:`BatchScheduler.step`.
* :class:`InferenceServer` — a bound Module behind a scheduler, through
  :class:`~mxnet_tpu_torch.fused_step.FusedInfer`, with the SLO probe and
  the controller state on the metrics server's ``/healthz``, and the
  delta refresh from a checkpoint snapshot. A module bound over several
  contexts serves over them: as dp replicas, each card serving its rows
  of every padded batch, or with ``tp`` (``MXNET_TPU_SERVE_TP``) on a
  ``(dp, tp)`` grid of the same contexts, each card of a tp line keeping
  its shard of every split param and computing its share of every
  FullyConnected and Convolution product
  (:mod:`mxnet_tpu_torch.parallel.tp_infer`).

``close()`` stops intake, serves what is queued, and joins the worker.
"""
from __future__ import annotations

import collections
import logging
import queue as _queue
import threading
import time
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import env as _env
from . import telemetry as _tel
from . import tracing as _tracing
from .base import MXNetError
from .io_pipeline import RequestStager

__all__ = ["bucket_ladder", "LANES", "Request", "RequestShed",
           "ArrivalRateEstimator", "ServiceTimeEstimator",
           "AdaptiveWaitController", "BatchScheduler", "InferenceServer"]

_log = logging.getLogger(__name__)

#: The priority lanes. ``interactive`` requests default to the SLO
#: deadline; ``batch`` requests to a 4x looser one and are the first shed
#: under overload; they ride along in whatever bucket capacity the
#: interactive lane leaves free.
LANES = ("interactive", "batch")


class RequestShed(MXNetError):
    """The scheduler dropped this request under overload (lowest
    priority, most expired first) instead of serving every queued request
    past its deadline. Safe to retry elsewhere."""


def bucket_ladder(max_batch: int, dp: int = 1, spec=None,
                  mesh=None) -> Tuple[int, ...]:
    """Padded batch sizes: powers of two up to ``max_batch`` (which is
    always covered by the top rung), or the rungs of ``spec`` (a
    sequence, or a comma list as ``MXNET_TPU_SERVE_BUCKETS`` gives it,
    which is read when ``spec`` is None). Every rung is rounded up to a
    multiple of the batch-sharding extent, so the batch always splits
    evenly: ``mesh``'s data axes (``dp``, ``dp x fsdp``; on a ``(dp,
    tp)`` grid just ``dp``), or ``dp`` given directly."""
    if mesh is not None:
        from .parallel.sharding import batch_shard_extent

        dp = batch_shard_extent(mesh)
    dp = max(1, int(dp))
    if spec is None:
        spec = _env.get("MXNET_TPU_SERVE_BUCKETS")
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    if spec:
        rungs = [int(s) for s in spec]
    else:
        rungs, b = [], 1
        while b < max_batch:
            rungs.append(b)
            b *= 2
        rungs.append(max_batch)
    if not rungs or min(rungs) <= 0:
        raise MXNetError("invalid bucket ladder %r" % (sorted(rungs),))
    ladder = sorted({max(dp, -(-r // dp) * dp) for r in rungs})
    if ladder[-1] < max_batch:
        ladder.append(-(-int(max_batch) // dp) * dp)
    return tuple(ladder)


# ---------------------------------------------------------------------------
# the adaptive control plane: arrival rate, service time, wait window
# ---------------------------------------------------------------------------

class ArrivalRateEstimator:
    """EWMA of the arrival rate (requests a second), one ``observe()`` an
    accepted request. ``rate()`` decays while nothing arrives (at most
    ``1 / idle``), so a burst followed by silence does not keep the
    scheduler waiting for arrivals that will not come."""

    def __init__(self, clock=time.perf_counter, alpha: float = 0.2):
        self._clock = clock
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._last: Optional[float] = None
        self._rate = 0.0

    def observe(self):
        now = self._clock()
        with self._lock:
            if self._last is not None:
                dt = max(now - self._last, 1e-6)
                self._rate += self._alpha * (1.0 / dt - self._rate)
            self._last = now

    def rate(self) -> float:
        with self._lock:
            if self._last is None:
                return 0.0
            idle = self._clock() - self._last
            if idle <= 1e-6:
                return self._rate
            return min(self._rate, 1.0 / idle)


class ServiceTimeEstimator:
    """EWMA of a batch's service time (stage, device, D2H) by bucket
    rung: the scheduler subtracts it from a deadline to know how long it
    may keep coalescing. An unseen rung borrows the worst estimate, or
    ``default_ms`` before any dispatch."""

    def __init__(self, default_ms: float = 2.0, alpha: float = 0.25):
        self._default = float(default_ms)
        self._alpha = float(alpha)
        self._est: dict = {}

    def observe(self, bucket: int, ms: float):
        cur = self._est.get(bucket)
        self._est[bucket] = (float(ms) if cur is None
                             else cur + self._alpha * (float(ms) - cur))

    def estimate_ms(self, bucket: int) -> float:
        est = self._est.get(bucket)
        if est is not None:
            return est
        return max(self._est.values()) if self._est else self._default


class AdaptiveWaitController:
    """The coalescing window as a closed loop: widen it by ``widen``
    while the p99 leaves more than ``hi`` of the SLO as headroom, shrink
    it by ``collapse`` below ``lo``, clamped to [floor, ceil]; for the
    same state a worse p99 never gives a longer wait. The ceiling
    defaults to half the SLO, at most 50 ms."""

    def __init__(self, slo_ms: float, start_ms: float,
                 floor_ms: float = 0.2, ceil_ms: Optional[float] = None,
                 widen: float = 1.5, collapse: float = 0.5,
                 lo: float = 0.15, hi: float = 0.35):
        self.slo_ms = float(slo_ms or 0.0)
        if ceil_ms is None:
            ceil_ms = (min(50.0, 0.5 * self.slo_ms) if self.slo_ms
                       else float(start_ms))
        self.floor_ms = float(floor_ms)
        self.ceil_ms = max(self.floor_ms, float(ceil_ms))
        self.widen = float(widen)
        self.collapse = float(collapse)
        self.lo = float(lo)
        self.hi = float(hi)
        self.wait_ms = min(max(float(start_ms), self.floor_ms),
                           self.ceil_ms)
        self.updates = 0

    def update(self, p99_ms: Optional[float]) -> float:
        """One control step on the recent p99 (None, no samples, reads as
        full headroom); returns the new wait."""
        self.updates += 1
        if not self.slo_ms:
            return self.wait_ms
        headroom = (1.0 if p99_ms is None
                    else 1.0 - float(p99_ms) / self.slo_ms)
        w = self.wait_ms
        if headroom < self.lo:
            w *= self.collapse
        elif headroom > self.hi:
            w *= self.widen
        self.wait_ms = min(self.ceil_ms, max(self.floor_ms, w))
        return self.wait_ms


class Request:
    """One in-flight request: payload arrays (one per data name, leading
    axis = rows) and the event the scheduler sets when its result (or an
    error) is in. ``request_id`` (given or a fresh uuid) dedups a retried
    duplicate; ``deadline_ms`` and ``priority`` are its scheduling
    envelope; ``components`` its latency decomposition once served."""

    __slots__ = ("arrays", "rows", "t_enq", "_done", "result", "error",
                 "queue_ms", "latency_ms", "request_id", "deadline_ms",
                 "priority", "t_deadline", "t_adm", "sched_idle_ms",
                 "components", "bucket")

    def __init__(self, arrays: Sequence[np.ndarray],
                 request_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 priority: Optional[str] = None):
        self.arrays = [np.asarray(a) for a in arrays]
        self.rows = int(self.arrays[0].shape[0])
        self.t_enq = time.perf_counter()
        self._done = threading.Event()
        self.result: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.queue_ms = 0.0
        self.latency_ms = 0.0
        self.sched_idle_ms = 0.0
        self.request_id = request_id or uuid.uuid4().hex
        self.deadline_ms = None if not deadline_ms else float(deadline_ms)
        self.priority = priority or "interactive"
        self.t_deadline: Optional[float] = None   # stamped at submit
        self.t_adm = self.t_enq
        self.components: Optional[dict] = None
        self.bucket = 0

    def get(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block until served; the per-request rows of each result
        (the argmax/top-k when the server has ``top_k``, else the raw
        outputs). Raises the dispatch's error if it failed."""
        if not self._done.wait(timeout):
            raise MXNetError("inference request timed out after %ss"
                             % timeout)
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return self._done.is_set()


def _device_wait(results) -> None:
    """Wait for the card to finish the work behind CUDA results."""
    devices = {r.device for r in results
               if isinstance(r, torch.Tensor) and r.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def _to_host(r) -> np.ndarray:
    if isinstance(r, torch.Tensor):
        return r.cpu().numpy()
    return np.asarray(r)


class BatchScheduler:
    """Deadline-aware continuous batcher in front of an infer callable
    ``infer_fn(placed_arrays) -> (outputs, post)``, dispatched once a
    batch. ``dp``, the batch's shards over the cards, rounds
    ``max_batch`` and every rung of the ladder up to a multiple of it.

    The dispatch decision (``_decide``) fires on the first of:

    * **full** — the pending rows reached ``max_batch``;
    * **deadline** — the earliest pending deadline, less twice the
      service-time estimate and a margin, has come;
    * **rung_fill** — (adaptive) the pending rows sit exactly on a rung
      and the arrival rate puts the next rung out of reach;
    * **idle** — (adaptive) nothing more is plausibly arriving inside the
      window;
    * **window** — the coalescing window (adaptive, or the static
      ``max_wait_ms``) expired; where the next rung is reachable within
      the slack and twice the window, the window stretches to meet it.
    """

    #: deadline-slack safety: dispatch when ``deadline - now`` falls
    #: below ``SVC_SAFETY * service_estimate + SLACK_MARGIN_MS``
    SVC_SAFETY = 2.0
    SLACK_MARGIN_MS = 2.0
    #: the window may stretch to this multiple of itself to fill a rung
    FILL_STRETCH = 2.0

    def __init__(self, infer_fn, data_shapes: Sequence[tuple],
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 slo_ms: Optional[float] = None, dp: int = 1, place=None,
                 slo_window: int = 512, adaptive: Optional[bool] = None,
                 default_deadline_ms: Optional[float] = None,
                 batch_deadline_ms: Optional[float] = None,
                 clock=time.perf_counter, autostart: bool = True):
        self._infer = infer_fn
        self._data_shapes = [tuple(s) for s in data_shapes]
        dp = max(1, int(dp))
        if max_batch is None:
            max_batch = _env.get("MXNET_TPU_SERVE_MAX_BATCH")
        # a multiple of dp, so the top rung splits over the batch shards
        self.max_batch = max(dp, -(-int(max_batch) // dp) * dp)
        self.max_wait_ms = float(_env.get("MXNET_TPU_SERVE_MAX_WAIT_MS")
                                 if max_wait_ms is None else max_wait_ms)
        self.buckets = bucket_ladder(self.max_batch, dp=dp, spec=buckets)
        self._rung_set = frozenset(self.buckets)
        self.slo_ms = float(_env.get("MXNET_TPU_SERVE_SLO_MS")
                            if slo_ms is None else slo_ms)
        self._clock = clock
        if adaptive is None:
            adaptive = _env.get("MXNET_TPU_SERVE_ADAPTIVE")
        self.adaptive = bool(adaptive) and self.slo_ms > 0
        self._arrival = ArrivalRateEstimator(clock=clock)
        self._svc = ServiceTimeEstimator()
        self._ctl = AdaptiveWaitController(self.slo_ms, self.max_wait_ms)
        # lane deadlines: the argument, else the variable, else the SLO
        # (adaptive only), and 4x the interactive one for the batch lane
        dflt = float(_env.get("MXNET_TPU_SERVE_DEADLINE_MS")
                     if default_deadline_ms is None else default_deadline_ms)
        if dflt <= 0:
            dflt = self.slo_ms if self.adaptive else 0.0
        bdflt = float(_env.get("MXNET_TPU_SERVE_BATCH_DEADLINE_MS")
                      if batch_deadline_ms is None else batch_deadline_ms)
        if bdflt <= 0:
            bdflt = 4.0 * dflt if dflt else 0.0
        self._deadline_default_ms = {"interactive": dflt, "batch": bdflt}
        self._shed_rows = 2 * self.max_batch
        self._stager = RequestStager(place=place)
        self._q: _queue.Queue = _queue.Queue()
        self._pending: List[Request] = []
        self._pending_rows = 0
        self._dispatch_reason = ""
        self._stop = threading.Event()
        self._closed = False
        self._started = False
        self._lock = threading.Lock()
        # the controller's feedback: (t_done, latency_ms), aged by time
        # in recent_quantile
        self._recent: collections.deque = collections.deque(maxlen=64)
        self._warmed: set = set()
        self._served = 0
        self._batches = 0
        self._errors = 0
        self._occ_sum = 0.0
        self._by_bucket: dict = {}
        self._in_flight = 0
        self._slo_breaches = 0
        # this scheduler's own latency histogram (not the registry's), so
        # two servers in one process never share one series; its ring of
        # the last slo_window latencies is the SLO window
        self._lat_hist = _tel.Histogram("serve.request_ms",
                                        capacity=int(slo_window))
        self._lane = {lane: {"served": 0, "shed": 0} for lane in LANES}
        self._depth_samples: collections.deque = collections.deque(
            maxlen=4096)
        self._traj: collections.deque = collections.deque(maxlen=512)
        self._t0 = self._clock()
        # request id -> Request: in-flight dedup always; completed
        # results only when the infer fn is idempotent (FusedInfer is)
        self._idempotent = bool(getattr(infer_fn, "idempotent", False))
        self._inflight_ids: dict = {}
        self._done_ids: collections.OrderedDict = collections.OrderedDict()
        self._done_cap = 1024
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start()

    def start(self):
        """Start the worker (``__init__`` does unless ``autostart=False``);
        a second start raises."""
        with self._lock:
            if self._closed:
                raise MXNetError("BatchScheduler is closed; build a new one "
                                 "instead of restarting it")
            if self._started:
                raise MXNetError("BatchScheduler already started (double "
                                 "start)")
            self._started = True
        self._worker = threading.Thread(target=self._run,
                                        name="mxtorch-serve-batcher",
                                        daemon=True)
        self._worker.start()

    def rebind_infer(self, infer_fn, place=None):
        """Dispatch later batches through ``infer_fn`` (and place them
        with ``place``): the server rebuilt its FusedInfer after a re-bind.
        A dispatch already running finishes on the callable it read."""
        with self._lock:
            self._infer = infer_fn
            self._idempotent = bool(getattr(infer_fn, "idempotent", False))
            if place is not None:
                self._stager.rebind_place(place)

    # -- intake ------------------------------------------------------------
    def submit(self, arrays, request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[str] = None) -> Request:
        """Enqueue one request (a list of arrays in data-name order, or
        one array for a single data input). Returns at once; block on
        :meth:`Request.get`. ``deadline_ms`` is the latency budget
        (default: the lane's), ``priority`` the lane. A ``request_id``
        already in flight (or served, under an idempotent infer fn)
        returns the original request and counts
        ``serve.duplicate_requests``."""
        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        priority = priority or "interactive"
        if priority not in LANES:
            raise MXNetError("unknown priority lane %r (expected one of %s)"
                             % (priority, ", ".join(LANES)))
        if deadline_ms is None:
            deadline_ms = self._deadline_default_ms[priority] or None
        req = Request(arrays, request_id, deadline_ms=deadline_ms,
                      priority=priority)
        req.t_enq = self._clock()
        req.t_adm = req.t_enq
        if req.deadline_ms:
            req.t_deadline = req.t_enq + req.deadline_ms / 1e3
        if len(req.arrays) != len(self._data_shapes):
            raise MXNetError("expected %d input arrays, got %d"
                             % (len(self._data_shapes), len(req.arrays)))
        for a, shape in zip(req.arrays, self._data_shapes):
            if tuple(a.shape[1:]) != tuple(shape[1:]):
                raise MXNetError(
                    "request row shape %r does not match the served "
                    "model's %r (the ladder pads only the batch axis)"
                    % (tuple(a.shape[1:]), tuple(shape[1:])))
        if req.rows > self.max_batch:
            raise MXNetError("request of %d rows exceeds max_batch=%d"
                             % (req.rows, self.max_batch))
        if self._closed:
            raise MXNetError("BatchScheduler is closed")
        with self._lock:
            dup = self._inflight_ids.get(req.request_id)
            if dup is None and self._idempotent:
                dup = self._done_ids.get(req.request_id)
            if dup is not None:
                _tel.inc("serve.duplicate_requests")
                return dup
            self._inflight_ids[req.request_id] = req
            self._in_flight += 1
        self._arrival.observe()
        _tel.inc("serve.requests")
        _tel.set_gauge("serve.in_flight", self.in_flight())
        self._q.put(req)
        return req

    def in_flight(self) -> int:
        """Requests accepted and not yet completed."""
        with self._lock:
            return self._in_flight

    def _finish(self, req: Request, served: bool):
        """Retire a request id: into the dedup cache when served under an
        idempotent infer fn, and out of the in-flight count."""
        with self._lock:
            if self._inflight_ids.pop(req.request_id, None) is not None:
                self._in_flight -= 1
            if served and self._idempotent:
                self._done_ids[req.request_id] = req
                while len(self._done_ids) > self._done_cap:
                    self._done_ids.popitem(last=False)

    def infer(self, arrays, timeout: Optional[float] = 60.0,
              deadline_ms: Optional[float] = None,
              priority: Optional[str] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(arrays, deadline_ms=deadline_ms,
                           priority=priority).get(timeout)

    # -- scheduling loop ---------------------------------------------------
    def _admit_intake(self, block_s: float = 0.0):
        """Move queued requests into the pending set, blocking at most
        ``block_s`` for the first."""
        try:
            if block_s > 0:
                self._admit(self._q.get(timeout=block_s))
            while True:
                self._admit(self._q.get_nowait())
        except _queue.Empty:
            pass

    def _admit(self, req: Request):
        now = self._clock()
        req.t_adm = now
        req.queue_ms = (now - req.t_enq) * 1e3
        self._pending.append(req)
        self._pending_rows += req.rows
        depth = self._pending_rows + self._q.qsize()
        self._depth_samples.append(depth)
        _tel.set_gauge("serve.queue_depth", depth)

    def _bucket_for(self, rows: int) -> int:
        return next(b for b in self.buckets
                    if b >= min(rows, self.buckets[-1]))

    def _maybe_shed(self, now: float):
        """Above twice ``max_batch`` pending rows, fail the expired
        requests, batch lane first, then the most expired, with
        :class:`RequestShed` until one dispatch can take the rest. Never
        while draining on close."""
        if self._stop.is_set() or self._pending_rows <= self._shed_rows:
            return
        victims = [r for r in self._pending
                   if r.t_deadline is not None and now > r.t_deadline]
        if not victims:
            return
        victims.sort(key=lambda r: (0 if r.priority == "batch" else 1,
                                    r.t_deadline))
        shed, rows = [], self._pending_rows
        for r in victims:
            if rows <= self.max_batch:
                break
            shed.append(r)
            rows -= r.rows
        if not shed:
            return
        shed_ids = {id(r) for r in shed}
        self._pending = [r for r in self._pending if id(r) not in shed_ids]
        self._pending_rows = rows
        for r in shed:
            _tel.inc("serve.shed_requests")
            _tel.inc("serve.shed.%s" % r.priority)
            with self._lock:
                self._lane[r.priority]["shed"] += 1
            r.error = RequestShed(
                "request %s (%s lane) shed under overload: deadline %.1fms "
                "expired %.1fms ago with %d rows queued"
                % (r.request_id, r.priority, r.deadline_ms or 0.0,
                   (now - r.t_deadline) * 1e3, self._pending_rows))
            self._finish(r, served=False)
            r._done.set()
        _log.warning("shed %d request(s) under overload", len(shed))

    def _decide(self, now: float) -> Optional[float]:
        """None: dispatch now (``_dispatch_reason`` says why); else the
        seconds coalescing may go on before the next look."""
        rows = self._pending_rows
        if rows >= self.max_batch:
            self._dispatch_reason = "full"
            return None
        hold0 = min(r.t_adm for r in self._pending)
        window_ms = self._ctl.wait_ms if self.adaptive else self.max_wait_ms
        window_s = window_ms / 1e3
        window_end = hold0 + window_s
        bucket = self._bucket_for(rows)
        est_s = (self._svc.estimate_ms(bucket) * self.SVC_SAFETY
                 + self.SLACK_MARGIN_MS) / 1e3
        slack_end = None
        for r in self._pending:
            if r.t_deadline is not None:
                e = r.t_deadline - est_s
                if slack_end is None or e < slack_end:
                    slack_end = e
        if slack_end is not None and now >= slack_end:
            self._dispatch_reason = "deadline"
            return None
        end = window_end if slack_end is None else min(window_end, slack_end)
        if self.adaptive:
            rate = self._arrival.rate()
            nxt = next((b for b in self.buckets if b > rows), None)
            fill_s = ((nxt - rows) / rate
                      if nxt is not None and rate > 0 else None)
            if fill_s is not None:
                # the next rung fills within the slack and a bounded
                # stretch of the window (never past the controller's
                # ceiling): wait for it
                ext_end = hold0 + min(self.FILL_STRETCH * window_s,
                                      self._ctl.ceil_ms / 1e3)
                if slack_end is not None:
                    ext_end = min(ext_end, slack_end)
                if now + fill_s <= ext_end:
                    end = max(end, now + fill_s)
            if rows in self._rung_set and (fill_s is None
                                           or now + fill_s > end):
                self._dispatch_reason = "rung_fill"
                return None
            if rate * max(end - now, 0.0) < 1.0:
                self._dispatch_reason = "idle"
                return None
        if now >= end:
            self._dispatch_reason = "window"
            return None
        return end - now

    def _pack(self, now: float) -> List[Request]:
        """Earliest deadline first (no deadline last, admission order
        within ties) up to ``max_batch`` rows, never splitting a request;
        the batch lane fills what the interactive lane leaves."""
        self._pending.sort(key=lambda r: (
            r.t_deadline if r.t_deadline is not None else float("inf"),
            r.t_adm))
        batch: List[Request] = []
        rest: List[Request] = []
        rows = 0
        for r in self._pending:
            if rows + r.rows <= self.max_batch:
                batch.append(r)
                rows += r.rows
            else:
                rest.append(r)
        self._pending = rest
        self._pending_rows = sum(r.rows for r in rest)
        return batch

    def step(self) -> Optional[str]:
        """One scheduling step in the caller's thread (fake-clock tests,
        ``autostart=False``): admit, shed, decide, dispatch at most one
        batch. Returns the dispatch reason, ``"shed"`` when shedding
        emptied the pending set, ``"wait"`` while coalescing goes on, or
        None when idle."""
        self._admit_intake(0.0)
        if not self._pending:
            return None
        now = self._clock()
        self._maybe_shed(now)
        if not self._pending:
            return "shed"
        if self._decide(now) is not None:
            return "wait"
        reason = self._dispatch_reason
        self._dispatch_guarded(self._pack(now))
        return reason

    def _run(self):
        with torch.inference_mode():
            while True:
                if self._stop.is_set():
                    self._admit_intake(0.0)
                    if not self._pending:
                        break
                    batch = self._pack(self._clock())
                else:
                    self._admit_intake(0.0 if self._pending else 0.05)
                    if not self._pending:
                        continue
                    now = self._clock()
                    self._maybe_shed(now)
                    if not self._pending:
                        continue
                    wait_s = self._decide(now)
                    if wait_s is not None:
                        # sleep on the intake queue: an arrival looks again
                        self._admit_intake(min(wait_s, 0.05))
                        continue
                    batch = self._pack(now)
                if batch:
                    self._dispatch_guarded(batch)

    def _dispatch_guarded(self, batch: List[Request]):
        try:
            self._dispatch(batch)
        except Exception as e:   # the batch fails, not the loop
            _tel.inc("serve.errors")
            with self._lock:
                self._errors += 1
            for req in batch:
                req.error = e
                self._finish(req, served=False)
                req._done.set()
            _log.exception("serve batch failed (%d requests)", len(batch))

    def _dispatch(self, batch: List[Request]):
        t0 = self._clock()
        rows = sum(r.rows for r in batch)
        bucket = next(b for b in self.buckets if b >= rows)
        for req in batch:
            req.sched_idle_ms = (t0 - req.t_adm) * 1e3
        with self._lock:
            infer, stager = self._infer, self._stager
        placed, _ = stager.stage([r.arrays for r in batch], bucket)
        t1 = self._clock()
        with torch.inference_mode():
            outs, post = infer(placed)
            results = list(post) if post else list(outs)
            _device_wait(results)
        t2 = self._clock()
        host = [_to_host(r) for r in results]
        t3 = self._clock()

        h2d_ms = (t1 - t0) * 1e3
        dispatch_ms = (t2 - t1) * 1e3
        d2h_ms = (t3 - t2) * 1e3
        occupancy = rows / float(bucket)
        self._svc.observe(bucket, (t3 - t0) * 1e3)
        _tel.observe("serve.batch_occupancy", occupancy)
        _tel.inc("serve.batches")
        off, worst = 0, 0.0
        for req in batch:
            req.result = [h[off:off + req.rows] for h in host]
            off += req.rows
            req.bucket = bucket
            req.latency_ms = (t3 - req.t_enq) * 1e3
            # the five components sum to latency_ms by construction
            req.components = {
                "queue_ms": req.queue_ms, "sched_idle_ms": req.sched_idle_ms,
                "h2d_ms": h2d_ms, "dispatch_ms": dispatch_ms,
                "d2h_ms": d2h_ms}
            for name, v in req.components.items():
                _tel.observe("serve." + name, v)
            _tel.observe("serve.pad_waste_ms", dispatch_ms * (1 - occupancy))
            _tel.observe("serve.request_ms", req.latency_ms)
            worst = max(worst, req.latency_ms)
            with self._lock:
                self._lane[req.priority]["served"] += 1
            self._finish(req, served=True)
            req._done.set()
        _tel.set_gauge("serve.in_flight", self.in_flight())
        with self._lock:
            self._served += rows
            self._batches += 1
            self._occ_sum += occupancy
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
            if self.slo_ms:
                self._slo_breaches += sum(
                    1 for r in batch if r.latency_ms > self.slo_ms)
            for r in batch:
                self._lat_hist.observe(r.latency_ms)
            # a bucket's first dispatch builds its libraries and lets
            # cuDNN choose algorithms: real latency for the SLO probe,
            # but no feedback for the controller
            if bucket in self._warmed:
                self._recent.extend((t3, r.latency_ms) for r in batch)
            else:
                self._warmed.add(bucket)
        depth = self._pending_rows + self._q.qsize()
        if self.adaptive:
            self._ctl.update(self.recent_quantile(0.99))
        _tel.set_gauge("serve.adaptive_wait_ms", self._ctl.wait_ms)
        _tel.set_gauge("serve.arrival_rate", self._arrival.rate())
        _tel.set_gauge("serve.queue_depth", depth)
        self._traj.append({
            "t_s": round(t3 - self._t0, 4),
            "wait_ms": round(self._ctl.wait_ms if self.adaptive
                             else self.max_wait_ms, 3),
            "queue_depth": depth, "rows": rows, "bucket": bucket,
            "occupancy": round(occupancy, 4),
            "reason": self._dispatch_reason,
            "arrival_rps": round(self._arrival.rate(), 2)})
        _tracing.record_step((t3 - t0) * 1e3, extra={
            "request_ms": round(worst, 3), "slo_ms": self.slo_ms,
            "serve_rows": rows, "serve_bucket": bucket,
            "adaptive_wait_ms": round(self._ctl.wait_ms, 3),
            "queue_depth": depth})

    # -- SLO, read-outs ----------------------------------------------------
    def latency_quantile(self, q: float) -> Optional[float]:
        """``q`` quantile of the last ``slo_window`` latencies."""
        return self._lat_hist.quantile(q)

    def recent_quantile(self, q: float,
                        window_s: float = 0.5) -> Optional[float]:
        """Quantile over the last 64 warm latencies that finished within
        ``window_s``: the controller's feedback. None reads as full
        headroom."""
        cutoff = self._clock() - float(window_s)
        with self._lock:
            lat = sorted(ms for (t, ms) in self._recent if t >= cutoff)
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def slo_probe(self) -> Optional[dict]:
        """``/healthz`` probe: a failing detail (with the controller
        state) once the sliding p99 exceeds the SLO, else None."""
        if not self.slo_ms:
            return None
        p99 = self.latency_quantile(0.99)
        if p99 is not None and p99 > self.slo_ms:
            detail = {"p99_ms": round(p99, 3), "slo_ms": self.slo_ms}
            detail.update(self.controller_state())
            return detail
        return None

    def controller_state(self) -> dict:
        """The adaptive control plane as one JSON-able dict."""
        return {"adaptive": self.adaptive,
                "adaptive_wait_ms": round(
                    self._ctl.wait_ms if self.adaptive
                    else self.max_wait_ms, 3),
                "arrival_rate_rps": round(self._arrival.rate(), 2),
                "queue_depth": self._pending_rows + self._q.qsize()}

    def occupancy_snapshot(self) -> dict:
        """Monotone counters: mean occupancy between two snapshots is
        ``d(occ_sum) / d(batches)``."""
        with self._lock:
            return {"batches": self._batches, "occ_sum": self._occ_sum,
                    "served": self._served}

    def metrics_payload(self) -> dict:
        """This scheduler's series as ``name -> export`` (what a fleet
        scrape federates): counters as ints, gauges as floats, the
        latency histogram with its sample ring."""
        with self._lock:
            served, batches = self._served, self._batches
            occ_sum, breaches = self._occ_sum, self._slo_breaches
        return {
            "serve.requests_served": served,
            "serve.batches": batches,
            "serve.slo_breaches": breaches,
            "serve.occupancy_sum": float(occ_sum),
            "serve.in_flight": float(self.in_flight()),
            "serve.queue_depth": float(self._pending_rows + self._q.qsize()),
            "serve.request_ms": self._lat_hist.export(include_sample=True),
        }

    def drain_depth_samples(self) -> List[int]:
        """Pop the queue-depth samples recorded since the last drain."""
        out: List[int] = []
        while True:
            try:
                out.append(self._depth_samples.popleft())
            except IndexError:
                return out

    def wait_trajectory(self) -> List[dict]:
        """One sample a dispatched batch: time, wait, queue depth, rows,
        bucket, occupancy, reason, arrival rate."""
        return list(self._traj)

    def lane_stats(self) -> dict:
        with self._lock:
            return {lane: dict(v) for lane, v in self._lane.items()}

    def stats(self) -> dict:
        with self._lock:
            batches, served = self._batches, self._served
            occ = self._occ_sum / batches if batches else 0.0
            lanes = {lane: dict(v) for lane, v in self._lane.items()}
            errors, by_bucket = self._errors, dict(self._by_bucket)
        out = {"requests_served": served, "batches": batches,
               "mean_occupancy": round(occ, 4), "lanes": lanes,
               "errors": errors, "batches_by_bucket": by_bucket}
        out.update(self.controller_state())
        depth = sorted(self._depth_samples)
        if depth:
            out["queue_depth_p50"] = depth[len(depth) // 2]
            out["queue_depth_p99"] = depth[min(len(depth) - 1,
                                               int(0.99 * len(depth)))]
            out["queue_depth_max"] = depth[-1]
        for name, q in (("p50_ms", 0.50), ("p99_ms", 0.99),
                        ("p999_ms", 0.999)):
            v = self.latency_quantile(q)
            if v is not None:
                out[name] = round(v, 3)
        return out

    # -- shutdown ----------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Stop intake, serve what is queued, join the worker. Anything
        still queued after that fails with an error, never hangs.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                _log.warning("serve batcher still alive after %.1fs join",
                             timeout)
        leftovers = list(self._pending)
        self._pending = []
        self._pending_rows = 0
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except _queue.Empty:
                break
        for req in leftovers:
            req.error = MXNetError("BatchScheduler closed before the "
                                   "request was served")
            self._finish(req, served=False)
            req._done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _group_executor(group):
    """What a group serves through: its replicated executor over several
    contexts, else its one executor."""
    return group.replicated or group.executor


class InferenceServer:
    """A bound, initialized Module served behind a :class:`BatchScheduler`
    through a :class:`~mxnet_tpu_torch.fused_step.FusedInfer`.
    ``top_k=0`` returns the raw outputs, ``1`` the argmax, ``>1`` the
    top-k values and indices, all computed on the device. With an SLO the
    scheduler runs adaptive (unless ``adaptive=False``), its probe turns
    ``/healthz`` degraded on a breach, and ``health_info`` adds the
    in-flight count and the controller state to every ``/healthz``
    payload. ``port`` (default ``MXNET_TPU_SERVE_PORT``) starts a metrics
    server; unset, a running one is reused.

    A module bound over several contexts serves over all of them, on the
    group's mesh (dp replicas: each card serves its rows of every padded
    batch). ``tp`` (default ``MXNET_TPU_SERVE_TP``; given, 1 included)
    factors the contexts into the ``(dp, tp)`` grid (:meth:`_tp_mesh`):
    each card of a tp line serves its dp group's rows, keeps only its
    shard of every param that ``tp_param_spec`` splits and computes its
    share of every FullyConnected and Convolution product. ``dp`` and
    ``tp`` say how the server serves; the ladder's rungs are multiples of
    ``dp``."""

    def __init__(self, module, top_k: int = 0,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 slo_ms: Optional[float] = None,
                 port: Optional[object] = None,
                 adaptive: Optional[bool] = None,
                 default_deadline_ms: Optional[float] = None,
                 batch_deadline_ms: Optional[float] = None,
                 tp: Optional[int] = None):
        from .fused_step import make_fused_infer
        from .parallel.sharding import batch_shard_extent

        if not module.binded or not module.params_initialized:
            raise MXNetError("InferenceServer needs a bound, "
                             "param-initialized module")
        group = module._exec_group
        mesh = group._mesh
        if tp is None:
            tp = _env.get("MXNET_TPU_SERVE_TP") or None
        #: a tp was asked for (1 included): serve on the (dp, tp) grid
        self._factor = tp is not None
        self.tp = tp = max(1, int(tp or 1))
        if self._factor:
            mesh = self._tp_mesh(group, mesh, tp)
        self._module = module
        self._mesh = mesh
        self._top_k = top_k
        #: the batch's shards: rungs round to dp, never to dp x tp
        self.dp = dp = batch_shard_extent(mesh)
        #: serving steps rebuilt after a re-bind (serve.executable_rebuilds)
        self.executable_rebuilds = 0
        self._fused = make_fused_infer(_group_executor(group),
                                       module.data_names, top_k=top_k,
                                       mesh=mesh)
        self.scheduler = BatchScheduler(
            self._fused, [d.shape for d in group.data_shapes],
            max_batch=max_batch, max_wait_ms=max_wait_ms, buckets=buckets,
            slo_ms=slo_ms, dp=dp, place=self._fused.place_batch,
            adaptive=adaptive, default_deadline_ms=default_deadline_ms,
            batch_deadline_ms=batch_deadline_ms)
        self._metrics = None
        self._own_metrics = False
        if port is None:
            port = _env.get("MXNET_TPU_SERVE_PORT")
        if port != "" and port is not None:
            self._metrics = _tracing.MetricsServer(int(port))
            self._own_metrics = True
        elif _tracing.metrics_server() is not None:
            self._metrics = _tracing.metrics_server()
        self._probe_name = "serve_slo:%d" % id(self)
        _tracing.register_health_probe(self._probe_name,
                                       self.scheduler.slo_probe)
        self._info_name = "serve:%d" % id(self)
        _tracing.register_health_info(self._info_name, self.health_info)
        self._closed = False
        self._close_lock = threading.Lock()
        _log.info("serving: buckets=%s max_wait_ms=%s adaptive=%s dp=%d "
                  "tp=%d slo_ms=%s%s",
                  self.scheduler.buckets, self.scheduler.max_wait_ms,
                  self.scheduler.adaptive, dp, tp,
                  self.scheduler.slo_ms or "off",
                  " metrics on :%d" % self._metrics.port
                  if self._metrics else "")

    @staticmethod
    def _tp_mesh(group, mesh, tp: int):
        """The ``(dp, tp)`` serving grid of the group's contexts (the
        mesh's, where it has one): ``tp`` of them split the model, the
        ``dp`` lines split the batch. Raises, naming the knob, when ``tp``
        does not divide the contexts, rather than serve on fewer cards
        than the module was bound on."""
        from .parallel.sharding import make_mesh

        contexts = (list(mesh.devices.flat) if mesh is not None
                    else list(group.contexts))
        n = len(contexts)
        if n % tp:
            raise MXNetError(
                "MXNET_TPU_SERVE_TP=%d does not divide the %d-device "
                "group; pick a tp that factors the device count" % (tp, n))
        return make_mesh({"dp": n // tp, "tp": tp}, devices=contexts)

    @property
    def port(self) -> Optional[int]:
        return self._metrics.port if self._metrics is not None else None

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.scheduler.buckets

    @property
    def compiles(self) -> int:
        return self._fused.compiles

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self):
        """The server starts serving at construction, so an explicit
        start is a second start: the scheduler's guard raises."""
        self.scheduler.start()

    def submit(self, arrays, request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[str] = None) -> Request:
        return self.scheduler.submit(arrays, request_id=request_id,
                                     deadline_ms=deadline_ms,
                                     priority=priority)

    def infer(self, arrays, timeout: Optional[float] = 60.0,
              deadline_ms: Optional[float] = None,
              priority: Optional[str] = None):
        return self.scheduler.infer(arrays, timeout, deadline_ms=deadline_ms,
                                    priority=priority)

    def refresh_params(self, host_params=None, digests=None):
        """Repack after a weight update: everything after
        ``module.set_params`` (no arguments), or, with ``host_params``
        (name -> host array) and ``digests`` (name -> sha256), only the
        params whose digest differs from the served pack
        (:meth:`~mxnet_tpu_torch.fused_step.FusedInfer.refresh_params`).
        Either way the serving step is first checked against the module's
        current executor and rebuilt after a re-bind."""
        self._ensure_executable()
        if host_params is None:
            self._fused.refresh_params()
        else:
            self._fused.refresh_params(host_params=host_params,
                                       digests=digests)

    def refresh_from_snapshot(self, payload: dict):
        """Delta refresh from a :func:`mxnet_tpu_torch.checkpoint.snapshot`
        payload: its ``params`` and ``param_digests``."""
        self.refresh_params(host_params=payload.get("params") or {},
                            digests=payload.get("param_digests"))

    def _ensure_executable(self):
        """Rebuild the FusedInfer when the module was bound again since
        it was built, or its contexts factor otherwise (a re-bound group
        under tp is factored again), and repoint the scheduler (and its
        stager) at it; a dispatch already running finishes on the old
        one."""
        group = self._module._exec_group
        ex = _group_executor(group)
        mesh = self._mesh
        if not self._factor:
            mesh = group._mesh
        elif self._fused.stale_for(ex, self._mesh):
            mesh = self._tp_mesh(group, group._mesh, self.tp)
        if not self._fused.stale_for(ex, mesh):
            return
        from .fused_step import make_fused_infer
        from .parallel.sharding import batch_shard_extent

        self._mesh = mesh
        self.dp = batch_shard_extent(mesh)
        self._fused = make_fused_infer(ex, self._module.data_names,
                                       top_k=self._top_k, mesh=mesh)
        self.scheduler.rebind_infer(self._fused, self._fused.place_batch)
        self.executable_rebuilds += 1
        _tel.inc("serve.executable_rebuilds")

    def health_info(self) -> dict:
        """What ``/healthz`` adds for this server: the in-flight and
        served counts and the controller state."""
        info = {"in_flight": self.scheduler.in_flight(),
                "requests_served":
                    self.scheduler.occupancy_snapshot()["served"],
                "dp": self.dp, "tp": self.tp}
        info.update(self.scheduler.controller_state())
        return info

    def metrics_payload(self) -> dict:
        """The scheduler's series and the compile count, for a fleet
        scrape."""
        out = self.scheduler.metrics_payload()
        out["serve.compiles"] = self.compiles
        return out

    def stats(self) -> dict:
        out = self.scheduler.stats()
        out["compiles"] = self.compiles
        out["dispatches"] = self._fused.dispatches
        out["buckets"] = list(self.buckets)
        out["in_flight"] = self.scheduler.in_flight()
        out["dp"] = self.dp
        out["tp"] = self.tp
        return out

    def close(self):
        """Idempotent: the first caller closes, later ones return."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        _tracing.unregister_health_probe(self._probe_name)
        _tracing.unregister_health_info(self._info_name)
        self.scheduler.close()
        if self._own_metrics and self._metrics is not None:
            self._metrics.stop()
        self._metrics = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
