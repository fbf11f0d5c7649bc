"""Batched inference serving, counterpart of ``mxnet_tpu/serving.py``
(the bucket ladder and fixed-window batching; the adaptive controller,
priority lanes, tracing, fault injection and the metrics server wait for
a later slice, ROADMAP.md).

* :func:`bucket_ladder` — the padded batch sizes: each dispatched batch
  is padded with zero rows up to the next rung, so the served batch
  shapes are few and fixed.
* :class:`BatchScheduler` — one worker thread coalesces queued requests
  for at most ``max_wait_ms`` (or until ``max_batch`` rows are waiting),
  pads them to a rung, runs the infer callable once, and slices each
  request's rows back out. The worker enters ``torch.inference_mode()``
  itself, since the mode is thread-local. An error in a dispatch (a CUDA
  fault included) is stored on every request of that batch and raised
  to its caller by :meth:`Request.get`.
* :class:`InferenceServer` — a bound Module behind a scheduler, through
  :class:`~mxnet_tpu_torch.fused_step.FusedInfer`.

``close()`` stops intake, serves what is queued, and joins the worker.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError

__all__ = ["bucket_ladder", "Request", "BatchScheduler", "InferenceServer"]

DEFAULT_MAX_BATCH = 64
DEFAULT_MAX_WAIT_MS = 2.0


def bucket_ladder(max_batch: int, spec: Optional[Sequence[int]] = None
                  ) -> Tuple[int, ...]:
    """Padded batch sizes: powers of two up to ``max_batch`` (which is
    always the top rung), or the rungs of ``spec``."""
    if spec:
        rungs = [int(s) for s in spec]
    else:
        rungs, b = [], 1
        while b < max_batch:
            rungs.append(b)
            b *= 2
        rungs.append(max_batch)
    ladder = sorted(set(rungs))
    if not ladder or ladder[0] <= 0:
        raise MXNetError("invalid bucket ladder %r" % (ladder,))
    if ladder[-1] < max_batch:
        ladder.append(int(max_batch))
    return tuple(ladder)


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


class Request:
    """One in-flight request: payload arrays (one per data name, leading
    axis = rows) and the event the scheduler sets when its result (or
    an error) is in."""

    __slots__ = ("arrays", "rows", "t_enq", "_done", "result", "error",
                 "latency_ms", "bucket")

    def __init__(self, arrays: Sequence[np.ndarray]):
        self.arrays = [np.asarray(a) for a in arrays]
        self.rows = int(self.arrays[0].shape[0])
        self.t_enq = time.perf_counter()
        self._done = threading.Event()
        self.result: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.latency_ms = 0.0
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


class BatchScheduler:
    """Fixed-window continuous batcher in front of an infer callable
    ``infer_fn(arrays) -> (outputs, post)``."""

    def __init__(self, infer_fn, data_shapes: Sequence[tuple],
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None):
        self._infer = infer_fn
        self._data_shapes = [tuple(s) for s in data_shapes]
        self.max_batch = int(DEFAULT_MAX_BATCH if max_batch is None
                             else max_batch)
        self.max_wait_ms = float(DEFAULT_MAX_WAIT_MS if max_wait_ms is None
                                 else max_wait_ms)
        self.buckets = bucket_ladder(self.max_batch, buckets)
        self._q: _queue.Queue = _queue.Queue()
        self._pending: List[Request] = []
        self._pending_rows = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._closed = False
        self._served = 0
        self._batches = 0
        self._errors = 0
        self._occ_sum = 0.0
        self._by_bucket: dict = {}
        self._lat: List[float] = []
        self._batch_ms: List[float] = []
        self._worker = threading.Thread(target=self._run,
                                        name="mxtorch-serve-batcher",
                                        daemon=True)
        self._worker.start()

    # -- intake ------------------------------------------------------------
    def submit(self, arrays) -> Request:
        """Enqueue one request (a list of arrays in data-name order, or
        one array for a single data input). Returns at once; block on
        :meth:`Request.get`."""
        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        req = Request(arrays)
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
        self._q.put(req)
        return req

    def infer(self, arrays, timeout: Optional[float] = 60.0):
        """Synchronous convenience: submit + wait."""
        return self.submit(arrays).get(timeout)

    # -- scheduling loop ---------------------------------------------------
    def _admit(self, block_s: float = 0.0):
        try:
            if block_s > 0:
                req = self._q.get(timeout=block_s)
                self._pending.append(req)
                self._pending_rows += req.rows
            while True:
                req = self._q.get_nowait()
                self._pending.append(req)
                self._pending_rows += req.rows
        except _queue.Empty:
            pass

    def _pack(self) -> List[Request]:
        """FIFO up to ``max_batch`` rows, never splitting a request."""
        batch, rest, rows = [], [], 0
        for r in self._pending:
            if not rest and rows + r.rows <= self.max_batch:
                batch.append(r)
                rows += r.rows
            else:
                rest.append(r)
        self._pending = rest
        self._pending_rows = sum(r.rows for r in rest)
        return batch

    def _run(self):
        with torch.inference_mode():
            while True:
                if self._stop.is_set():
                    self._admit()
                    if not self._pending:
                        break
                else:
                    self._admit(0.0 if self._pending else 0.05)
                    if not self._pending:
                        continue
                    if self._pending_rows < self.max_batch:
                        left = (self._pending[0].t_enq
                                + self.max_wait_ms / 1e3
                                - time.perf_counter())
                        if left > 0:
                            self._admit(min(left, 0.05))
                            continue
                batch = self._pack()
                try:
                    self._dispatch(batch)
                except Exception as e:   # the batch fails, not the loop
                    with self._lock:
                        self._errors += 1
                    for req in batch:
                        req.error = e
                        req._done.set()

    def _dispatch(self, batch: List[Request]):
        rows = sum(r.rows for r in batch)
        bucket = next(b for b in self.buckets if b >= rows)
        arrays = []
        for i in range(len(self._data_shapes)):
            parts = [r.arrays[i] for r in batch]
            if bucket > rows:
                parts.append(np.zeros((bucket - rows,)
                                      + parts[0].shape[1:], parts[0].dtype))
            arrays.append(np.concatenate(parts, axis=0)
                          if len(parts) > 1 else parts[0])
        t0 = time.perf_counter()
        outs, post = self._infer(arrays)
        results = list(post) if post else list(outs)
        host = [r.cpu().numpy() for r in results]  # waits for the stream
        t1 = time.perf_counter()
        off = 0
        for req in batch:
            req.result = [h[off:off + req.rows] for h in host]
            off += req.rows
            req.bucket = bucket
            req.latency_ms = (t1 - req.t_enq) * 1e3
        with self._lock:
            self._served += rows
            self._batches += 1
            self._occ_sum += rows / float(bucket)
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
            self._batch_ms.append((t1 - t0) * 1e3)
            self._lat.extend(r.latency_ms for r in batch)
        for req in batch:
            req._done.set()

    # -- stats and shutdown ------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {"requests_served": self._served,
                   "batches": self._batches,
                   "errors": self._errors,
                   "mean_occupancy": (self._occ_sum / self._batches
                                      if self._batches else 0.0),
                   "batches_by_bucket": dict(self._by_bucket)}
            lat, bms = list(self._lat), list(self._batch_ms)
        for name, vals, q in (("p50_ms", lat, 0.5), ("p99_ms", lat, 0.99),
                              ("batch_p50_ms", bms, 0.5)):
            v = _quantile(vals, q)
            if v is not None:
                out[name] = v
        return out

    def close(self, timeout: float = 30.0):
        """Stop intake, serve what is queued, join the worker. Anything
        still queued after that fails with an error, never hangs."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._worker.join(timeout)
        leftovers = list(self._pending)
        self._pending = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except _queue.Empty:
                break
        for req in leftovers:
            req.error = MXNetError("BatchScheduler closed before the "
                                   "request was served")
            req._done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InferenceServer:
    """A bound, initialized Module served behind a :class:`BatchScheduler`
    through a :class:`~mxnet_tpu_torch.fused_step.FusedInfer`.
    ``top_k=0`` returns the raw outputs, ``1`` the argmax, ``>1`` the
    top-k values and indices, all computed on the device."""

    def __init__(self, module, top_k: int = 0,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 tp: Optional[int] = None):
        from .fused_step import make_fused_infer

        if tp is not None and int(tp) > 1:
            raise MXNetError("tensor-parallel serving (tp=%d) is not "
                             "ported yet: ROADMAP.md Queue A item 10" % tp)
        if not module.binded or not module.params_initialized:
            raise MXNetError("InferenceServer needs a bound, "
                             "param-initialized module")
        group = module._exec_group
        self._module = module
        self._fused = make_fused_infer(group.executor, module.data_names,
                                       top_k=top_k)
        self.scheduler = BatchScheduler(
            self._fused, [d.shape for d in group.data_shapes],
            max_batch=max_batch, max_wait_ms=max_wait_ms, buckets=buckets)

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.scheduler.buckets

    @property
    def compiles(self) -> int:
        return self._fused.compiles

    def submit(self, arrays) -> Request:
        return self.scheduler.submit(arrays)

    def infer(self, arrays, timeout: Optional[float] = 60.0):
        return self.scheduler.infer(arrays, timeout)

    def refresh_params(self):
        """Repack after ``module.set_params``."""
        self._fused.refresh_params()

    def stats(self) -> dict:
        out = self.scheduler.stats()
        out["compiles"] = self.compiles
        out["dispatches"] = self._fused.dispatches
        out["buckets"] = list(self.buckets)
        return out

    def close(self):
        self.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
