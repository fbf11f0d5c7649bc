"""Device staging and the feed scheduler, counterpart of that part of
``mxnet_tpu/io_pipeline.py`` (the decode workers and the shared-memory
ring are not ported yet: ROADMAP.md Queue A item 9).

On a card a batch is staged in three moves: a host copy into a pinned
buffer from a small ring, a ``non_blocking`` host-to-device copy on a
dedicated copy stream into fresh device tensors, and an event recorded
after that copy. ``next()`` makes the consumer's current stream wait on
the event and marks the tensors as used by that stream
(``record_stream``), so the caching allocator hands their memory out
again only after the consumer's work on them has run; the host thread
never waits for the card's compute. A ring slot is rewritten only after
the copy out of it has completed (its event). Every pinned buffer is
allocated when the first batch is staged, before the first training
step. On the CPU a staged batch is a copy of the base iterator's.

:class:`DeviceStagingIter` stages batch N+1 when it hands out batch N;
:class:`FeedScheduler` keeps ``depth`` staged batches in flight from a
worker thread and records how long ``next()`` blocked on an empty queue
(``io.feed_stall_ms``). Both delegate the checkpoint state to the base
iterator and drop their read-ahead on a seek. ``fit`` wraps its
iterator with :func:`maybe_wrap_feed_scheduler` and
:func:`maybe_wrap_device_staging` (``MXNET_TPU_FEED_DEPTH``,
``MXNET_TPU_DEVICE_STAGING``).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from . import env as _env
from . import telemetry as _tel
from .context import current_context
from .io import DataBatch, DataIter
from .ndarray import NDArray, _host_tensor

__all__ = ["DeviceStagingIter", "FeedScheduler", "maybe_wrap_device_staging",
           "maybe_wrap_feed_scheduler"]


def _as_host(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        x = x.handle
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return _host_tensor(np.asarray(x))


class _Stager:
    """Stages host arrays onto one device: pinned ring, copy stream,
    event. ``slots`` ring slots; a slot holds one pinned buffer an
    array."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._n_slots = slots
        self._ring = None
        self._turn = 0
        self._stream = None

    def stage(self, arrays):
        """Device tensors of ``arrays`` and the event after their copy
        (None on the CPU)."""
        host = [_as_host(a) for a in arrays]
        if self.device.type != "cuda":
            return [t.clone() for t in host], None
        if self._ring is None:
            self._stream = torch.cuda.Stream(self.device)
            self._ring = [[[torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in host],
                           torch.cuda.Event()]
                          for _ in range(self._n_slots)]
        bufs, done = self._ring[self._turn]
        self._turn = (self._turn + 1) % self._n_slots
        done.synchronize()   # the copy out of this slot has run
        for i, t in enumerate(host):
            if bufs[i].shape != t.shape or bufs[i].dtype != t.dtype:
                # a batch of another shape: a new buffer for this slot
                bufs[i] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
            bufs[i].copy_(t)
        with torch.cuda.stream(self._stream):
            staged = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                      for b in bufs]
            for d, b in zip(staged, bufs):
                d.copy_(b, non_blocking=True)
            done.record(self._stream)
        _tel.inc("ndarray.h2d_bytes", sum(t.numel() * t.element_size()
                                          for t in host))
        return staged, done


def _hand_over(staged: DataBatch) -> DataBatch:
    """Order the consumer's stream after the batch's copy and keep the
    allocator from reusing its memory before the consumer's work ran."""
    event = getattr(staged, "_staged_event", None)
    if event is not None:
        arrays = list(staged.data) + list(staged.label)
        stream = torch.cuda.current_stream(arrays[0].handle.device)
        stream.wait_event(event)
        for arr in arrays:
            arr.handle.record_stream(stream)
        staged._staged_event = None
    return staged


class DeviceStagingIter(DataIter):
    """Double-buffered staging around any ``DataIter``: ``next()``
    returns the batch staged on the previous call and stages the
    following one at once, so its host-to-device copy runs on the copy
    stream while the card runs the step. ``ctx`` (or the bound executor
    group's context, ``group``) names the device; the default is the
    current context.

    Telemetry: ``io.staging.h2d_ms`` (the host time to stage a batch),
    ``io.staging.batches`` and ``ndarray.h2d_bytes``."""

    def __init__(self, base: DataIter, ctx=None, group=None):
        super().__init__()
        self.base = base
        if ctx is None:
            ctx = group.context if group is not None else current_context()
        self._ctx = ctx
        # two slots: the batch being handed out and the one staged ahead
        self._stager = _Stager(ctx.torch_device(), 2)
        self.batch_size = getattr(base, "batch_size", 0)
        self._staged: Optional[DataBatch] = None
        self._exhausted = False

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    def reset(self):
        self.base.reset()
        self._staged = None
        self._exhausted = False

    # -- checkpoint state: the base iterator's; a seek drops the staged
    # read-ahead, which the base re-produces from the restored position
    def get_checkpoint_state(self):
        get = getattr(self.base, "get_checkpoint_state", None)
        return get() if callable(get) else None

    def set_checkpoint_state(self, state):
        self._staged = None
        self._exhausted = False
        st = getattr(self.base, "set_checkpoint_state", None)
        if callable(st):
            st(state)

    def _stage(self, batch: DataBatch) -> DataBatch:
        t0 = time.perf_counter() if _tel.enabled() else 0.0
        n_data = len(batch.data)
        tensors, event = self._stager.stage(
            list(batch.data) + list(batch.label or []))
        arrays = [NDArray(t, self._ctx) for t in tensors]
        if _tel.enabled():
            _tel.observe("io.staging.h2d_ms",
                         (time.perf_counter() - t0) * 1e3)
            _tel.inc("io.staging.batches")
        staged = DataBatch(arrays[:n_data], arrays[n_data:], batch.pad,
                           batch.index, bucket_key=batch.bucket_key,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        staged._staged_event = event
        return staged

    def next(self) -> DataBatch:
        if self._staged is None:
            if self._exhausted:
                raise StopIteration
            # the epoch's first batch: staged here, in series
            self._staged = self._stage(self.base.next())
        current = self._staged
        self._staged = None
        try:
            self._staged = self._stage(self.base.next())
        except StopIteration:
            self._exhausted = True
        return _hand_over(current)

    def iter_next(self) -> bool:
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def getindex(self):
        return self._current.index

    def close(self):
        close = getattr(self.base, "close", None)
        if callable(close):
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_wrap_device_staging(data_iter: DataIter, group=None) -> DataIter:
    """Wrap ``data_iter`` in :class:`DeviceStagingIter` when
    ``MXNET_TPU_DEVICE_STAGING`` is set (idempotent; a
    :class:`FeedScheduler` already stages and is left as it is)."""
    if not _env.get("MXNET_TPU_DEVICE_STAGING"):
        return data_iter
    if isinstance(data_iter, (DeviceStagingIter, FeedScheduler)):
        return data_iter
    logging.getLogger(__name__).info(
        "device staging enabled: wrapping %s in DeviceStagingIter",
        type(data_iter).__name__)
    return DeviceStagingIter(data_iter, group=group)


class FeedScheduler(DataIter):
    """Keeps up to ``depth`` staged batches in flight ahead of the
    training loop: a worker thread pulls from the base iterator, stages
    each batch (its ring has ``depth + 2`` slots) and parks it in a
    bounded queue; ``next()`` pops. The time ``next()`` blocks on an
    empty queue is the ``io.feed_stall_ms`` histogram;
    ``io.feed.in_flight`` gauges the queue and ``io.feed.batches``
    counts deliveries."""

    _END = object()

    def __init__(self, base: DataIter, depth: int = 2, ctx=None,
                 group=None):
        super().__init__()
        self.base = base
        self.depth = max(1, int(depth))
        if ctx is None:
            ctx = group.context if group is not None else current_context()
        self._ctx = ctx
        self._stager = _Stager(ctx.torch_device(), self.depth + 2)
        self.batch_size = getattr(base, "batch_size", 0)
        self._q = _queue.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._exhausted = False
        self._closed = False

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    _stage = DeviceStagingIter._stage

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = self.base.next()
                except StopIteration:
                    self._put(self._END)
                    return
                self._put(self._stage(batch))
        except BaseException as e:   # raised on the consumer's next()
            self._err = e
            self._put(self._END)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    def _ensure_thread(self):
        if self._thread is None:
            self._stop.clear()
            self._err = None
            self._thread = threading.Thread(
                target=self._worker, name="mxtpu-feed-scheduler",
                daemon=True)
            self._thread.start()

    def next(self) -> DataBatch:
        if self._exhausted:
            raise StopIteration
        self._ensure_thread()
        t0 = time.perf_counter() if _tel.enabled() else 0.0
        item = self._q.get()
        if _tel.enabled():
            _tel.observe("io.feed_stall_ms",
                         (time.perf_counter() - t0) * 1e3)
            _tel.set_gauge("io.feed.in_flight", self._q.qsize())
        if item is self._END:
            self._exhausted = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        _tel.inc("io.feed.batches")
        return _hand_over(item)

    def stop(self):
        """Stop the worker and drop the staged read-ahead; the next
        ``next()`` starts a worker again from where the base iterator
        stands."""
        # stop first: a worker blocked on a full queue sees the event in
        # _put and exits; only then is the queue safe to drain
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break

    def reset(self):
        self.stop()
        self.base.reset()
        self._err = None
        self._exhausted = False
        self._closed = False

    # -- checkpoint state: stop the worker and drop its read-ahead before
    # the base seeks; staged batches belong to the old position
    def get_checkpoint_state(self):
        get = getattr(self.base, "get_checkpoint_state", None)
        return get() if callable(get) else None

    def set_checkpoint_state(self, state):
        self.stop()
        self._err = None
        self._exhausted = False
        st = getattr(self.base, "set_checkpoint_state", None)
        if callable(st):
            st(state)

    def iter_next(self) -> bool:
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def getindex(self):
        return self._current.index

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.stop()
        close = getattr(self.base, "close", None)
        if callable(close):
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_wrap_feed_scheduler(data_iter: DataIter, group=None) -> DataIter:
    """Wrap ``data_iter`` in :class:`FeedScheduler` when
    ``MXNET_TPU_FEED_DEPTH`` >= 1 (idempotent; it subsumes device
    staging, whose wrapper it unwraps)."""
    depth = _env.get("MXNET_TPU_FEED_DEPTH")
    if depth <= 0:
        return data_iter
    if isinstance(data_iter, FeedScheduler):
        return data_iter
    if isinstance(data_iter, DeviceStagingIter):
        data_iter = data_iter.base
    logging.getLogger(__name__).info(
        "feed scheduler enabled: %d staged batches in flight ahead of %s",
        depth, type(data_iter).__name__)
    return FeedScheduler(data_iter, depth=depth, group=group)
