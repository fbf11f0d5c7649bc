"""The input pipeline, counterpart of ``mxnet_tpu/io_pipeline.py``:
process decode into a shared-memory batch ring, device staging, the
feed scheduler and the serving tier's request stager.

Process decode (``ImageRecordIter(preprocess_mode="process")`` or
``MXNET_TPU_DECODE_PROCS``): :class:`ShmRecordStore` lays the record
bytes out once in a shared-memory segment, :class:`ShmBatchRing` holds
batch-sized float32 slots in another, and :class:`ProcessDecodePipeline`
hands ``(cursor, epoch, slot)`` tasks to spawned workers
(:func:`_decode_worker_main`), which decode a whole batch in place into
its slot with the iterator's :class:`~mxnet_tpu_torch.io.RecordDecoder`.
Every augmentation draw is keyed by (epoch, record index), so any worker
count gives the thread path's batches bit for bit. A worker touches no
card and imports neither ``jax`` nor ``mxnet_tpu``. Every wait has a
deadline; a dead worker or a wedged ring raises :class:`PipelineError`,
on which ``ImageRecordIter`` goes on decoding in process.

On a card a batch is staged in three moves: a host copy into a pinned
buffer from a small ring, a ``non_blocking`` host-to-device copy on a
dedicated copy stream into fresh device tensors, and an event recorded
after that copy (an array already on the card is copied device to
device on that stream, after the work that made it). ``next()`` makes
the consumer's current stream wait on the event and marks the tensors as
used by that stream (``record_stream``), so the caching allocator hands
their memory out again only after the consumer's work on them has run;
the host thread never waits for the card's compute. A ring slot is
rewritten only after the copy out of it has completed (its event). Every
pinned buffer is allocated when the first batch is staged, before the
first training step. On the CPU a staged batch is a copy of the base
iterator's. A device-feed batch keeps its ``aug`` (the crop offsets,
mirror flags, mean and scale, on the host) through staging; for a group
bound over several contexts its uint8 frames are staged slice by slice,
each replica's rows onto its own card by a stager of that card's
(``batch.feed_parts``), and only the labels onto the first card, so no
frame crosses from card to card and none goes back to the host.

:class:`DeviceStagingIter` stages batch N+1 when it hands out batch N;
:class:`FeedScheduler` keeps ``depth`` staged batches in flight from a
worker thread and records how long ``next()`` blocked on an empty queue
(``io.feed_stall_ms``). Both delegate the checkpoint state to the base
iterator and drop their read-ahead on a seek. ``fit`` wraps its
iterator with :func:`maybe_wrap_feed_scheduler` and
:func:`maybe_wrap_device_staging` (``MXNET_TPU_FEED_DEPTH``,
``MXNET_TPU_DEVICE_STAGING``).

:class:`RequestStager` builds one serving batch: the queued requests'
rows concatenated and padded to the scheduled bucket, then placed on the
device by the server's ``place`` function.
"""
from __future__ import annotations

import logging
import multiprocessing
import queue as _queue
import struct
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import env as _env
from . import telemetry as _tel
from .base import MXNetError
from .context import current_context
from .io import DataBatch, DataIter, RecordDecoder
from .ndarray import NDArray, _host_tensor

__all__ = ["PipelineError", "ShmRecordStore", "ShmBatchRing",
           "ProcessDecodePipeline", "DeviceStagingIter", "FeedScheduler",
           "maybe_wrap_device_staging", "maybe_wrap_feed_scheduler",
           "RequestStager"]


class PipelineError(MXNetError):
    """A decode worker died or the ring stalled past its deadline; the
    iterator goes on decoding in process."""


# ---------------------------------------------------------------------------
# shared-memory layouts
# ---------------------------------------------------------------------------

class ShmRecordStore:
    """Raw record bytes in one shared-memory segment, laid out
    ``<Q n><Q offsets[n+1]><blob>`` in the parent's record order (its
    shuffle included), so a record index means the same record in every
    worker."""

    def __init__(self, shm, owner: bool):
        self._shm = shm
        self._owner = owner
        self.n = struct.unpack_from("<Q", shm.buf, 0)[0]
        self._offsets = np.frombuffer(shm.buf, dtype=np.uint64,
                                      count=self.n + 1, offset=8)
        self._base = 8 + (self.n + 1) * 8

    @classmethod
    def create(cls, records: Sequence[bytes]) -> "ShmRecordStore":
        from multiprocessing import shared_memory

        n = len(records)
        blob = sum(len(r) for r in records)
        shm = shared_memory.SharedMemory(create=True,
                                         size=max(1, 8 + (n + 1) * 8 + blob))
        struct.pack_into("<Q", shm.buf, 0, n)
        offsets = np.ndarray((n + 1,), dtype=np.uint64, buffer=shm.buf,
                             offset=8)
        base = 8 + (n + 1) * 8
        pos = 0
        for i, rec in enumerate(records):
            offsets[i] = pos
            shm.buf[base + pos:base + pos + len(rec)] = rec
            pos += len(rec)
        offsets[n] = pos
        del offsets
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRecordStore":
        from multiprocessing import shared_memory

        return cls(shared_memory.SharedMemory(name=name), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def __len__(self) -> int:
        return self.n

    def get(self, i: int) -> bytes:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return bytes(self._shm.buf[self._base + lo:self._base + hi])

    def close(self):
        self._offsets = None    # no numpy view may outlive the mapping
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:
            pass


class ShmBatchRing:
    """Preallocated batch slots in shared memory: each holds ``(batch,
    *data_shape)`` float32 images and a ``(batch, label_width)`` float32
    label block, which workers fill in place (a batch is never
    pickled)."""

    def __init__(self, num_slots: int, batch_size: int, data_shape,
                 label_width: int = 1, name: Optional[str] = None):
        from multiprocessing import shared_memory

        self.num_slots = int(num_slots)
        self.batch_size = int(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self._img_bytes = self.batch_size * int(np.prod(self.data_shape)) * 4
        self._lbl_bytes = self.batch_size * self.label_width * 4
        self.slot_bytes = self._img_bytes + self._lbl_bytes
        if name is None:
            self._shm = shared_memory.SharedMemory(
                create=True, size=max(1, self.num_slots * self.slot_bytes))
            self._owner = True
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self._owner = False

    def meta(self) -> dict:
        """What a worker needs to attach (picklable)."""
        return {"name": self._shm.name, "num_slots": self.num_slots,
                "batch_size": self.batch_size, "data_shape": self.data_shape,
                "label_width": self.label_width}

    @classmethod
    def attach(cls, meta: dict) -> "ShmBatchRing":
        return cls(meta["num_slots"], meta["batch_size"], meta["data_shape"],
                   meta["label_width"], name=meta["name"])

    def img_view(self, slot: int) -> np.ndarray:
        return np.ndarray((self.batch_size,) + self.data_shape,
                          dtype=np.float32, buffer=self._shm.buf,
                          offset=slot * self.slot_bytes)

    def label_view(self, slot: int) -> np.ndarray:
        return np.ndarray((self.batch_size, self.label_width),
                          dtype=np.float32, buffer=self._shm.buf,
                          offset=slot * self.slot_bytes + self._img_bytes)

    def close(self):
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _decode_worker_main(worker_id: int, decoder_cfg: dict, batch_size: int,
                        label_width: int, store_name: str, ring_meta: dict,
                        task_q, result_q):
    """One decode worker: takes ``(cursor, epoch, slot)`` tasks, decodes
    the batch at ``cursor`` into ring slot ``slot`` and reports ``(cursor,
    epoch, slot, error, seconds)``. Ends on the ``None`` task or when its
    parent is gone. Host work only: numpy, PIL and the record format."""
    store = ring = None
    try:
        store = ShmRecordStore.attach(store_name)
        ring = ShmBatchRing.attach(ring_meta)
        decoder = RecordDecoder(**decoder_cfg)
        parent = multiprocessing.parent_process()
        while True:
            try:
                task = task_q.get(timeout=1.0)
            except _queue.Empty:
                if parent is not None and not parent.is_alive():
                    return
                continue
            if task is None:
                return
            cursor, epoch, slot = task
            t0 = time.perf_counter()
            err = None
            try:
                imgs = ring.img_view(slot)
                labels = ring.label_view(slot)
                for j in range(batch_size):
                    idx = cursor + j
                    img, lab = decoder.decode(store.get(idx % store.n),
                                              decoder.derive_rng(epoch, idx))
                    imgs[j] = img
                    if label_width == 1:
                        labels[j, 0] = float(lab.ravel()[0])
                    else:
                        labels[j, :] = lab.ravel()[:label_width]
                decoder.normalize_inplace(imgs)
                del imgs, labels    # no view may outlive the mapping
            except BaseException as e:  # reported; the parent decides
                err = "%s: %s" % (type(e).__name__, e)
            result_q.put((cursor, epoch, slot, err, time.perf_counter() - t0))
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        if store is not None:
            store.close()
        if ring is not None:
            ring.close()


# ---------------------------------------------------------------------------
# parent-side pipeline
# ---------------------------------------------------------------------------

class ProcessDecodePipeline:
    """The decode workers and the shared-memory ring; serves batches by
    cursor and schedules read-ahead.

    The parent assigns ring slots and queues ``(cursor, epoch, slot)``
    tasks; completions come back in any order and wait in a ready table
    until the consumer asks for their cursor. A completion of an older
    epoch (after ``flush``) is dropped and its slot reclaimed, so a reset
    mid-epoch neither leaks a slot nor feeds a stale batch. Workers start
    with ``start_method`` (``MXNET_TPU_DECODE_START``, spawn by default);
    the ring has ``num_slots`` (``MXNET_TPU_DECODE_RING``, default
    ``max(2, 2 x workers)``); a wait longer than ``timeout``
    (``MXNET_TPU_DECODE_TIMEOUT``) seconds raises :class:`PipelineError`.

    Telemetry: ``io.pipeline.decode_ms``, ``io.pipeline.stalls`` and
    ``io.pipeline.stall_ms``, gauges ``io.pipeline.workers_alive`` and
    ``io.pipeline.ring_occupancy``."""

    def __init__(self, records: Sequence[bytes], decoder_cfg: dict,
                 batch_size: int, label_width: int = 1, num_workers: int = 2,
                 num_slots: Optional[int] = None,
                 start_method: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        ctx = multiprocessing.get_context(
            start_method or _env.get("MXNET_TPU_DECODE_START"))
        slots = num_slots or _env.get("MXNET_TPU_DECODE_RING") \
            or max(2, 2 * self.num_workers)
        self.timeout = timeout if timeout is not None \
            else _env.get("MXNET_TPU_DECODE_TIMEOUT")
        self._store = ShmRecordStore.create(records)
        self._ring = ShmBatchRing(slots, batch_size,
                                  decoder_cfg["data_shape"], label_width)
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._free: List[int] = list(range(slots))
        self._pending: Dict[Tuple[int, int], int] = {}
        self._ready: Dict[Tuple[int, int], int] = {}
        self._closed = False
        self._procs = []
        try:
            for i in range(self.num_workers):
                p = ctx.Process(
                    target=_decode_worker_main,
                    args=(i, decoder_cfg, batch_size, label_width,
                          self._store.name, self._ring.meta(),
                          self._task_q, self._result_q),
                    daemon=True, name="mxtpu-decode-%d" % i)
                p.start()
                self._procs.append(p)
        except BaseException:
            self.shutdown()
            raise
        # the segments must not outlive a pipeline that is collected
        self._finalizer = weakref.finalize(
            self, ProcessDecodePipeline._cleanup,
            self._procs, self._task_q, self._store, self._ring)

    @property
    def num_slots(self) -> int:
        return self._ring.num_slots

    def workers_alive(self) -> bool:
        return all(p.is_alive() for p in self._procs)

    # -- scheduling --------------------------------------------------------
    def schedule(self, cursor: int, epoch: int) -> bool:
        """Queue the decode of the batch at ``cursor`` if a slot is free;
        True when it is queued or done."""
        key = (cursor, epoch)
        if key in self._pending or key in self._ready or not self._free:
            return key in self._pending or key in self._ready
        slot = self._free.pop()
        self._pending[key] = slot
        self._task_q.put((cursor, epoch, slot))
        return True

    def prefetch(self, cursor: int, epoch: int, limit: int):
        """Queue the batches after ``cursor`` while slots are free."""
        for k in range(1, self.num_slots):
            nxt = cursor + k * self.batch_size
            if nxt >= limit or not self._free:
                break
            self.schedule(nxt, epoch)

    def _drain_one(self, timeout: float, epoch: int) -> bool:
        """Take one completion off the result queue; False on timeout.
        Raises on a dead worker or a decode error."""
        try:
            cursor, ep, slot, err, dur = self._result_q.get(timeout=timeout)
        except _queue.Empty:
            if not self.workers_alive():
                raise PipelineError(
                    "decode worker died (exitcodes %s)"
                    % [p.exitcode for p in self._procs])
            return False
        self._pending.pop((cursor, ep), None)
        if err is not None:
            self._free.append(slot)
            raise MXNetError("decode worker failed on batch at cursor %d: %s"
                             % (cursor, err))
        if ep != epoch:
            self._free.append(slot)     # an older epoch's: reclaimed
        else:
            self._ready[(cursor, ep)] = slot
            _tel.observe("io.pipeline.decode_ms", dur * 1e3)
        return True

    def get_batch(self, cursor: int, epoch: int,
                  limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """The decoded batch at ``cursor`` (images, labels), copied out of
        the ring (its slot freed); schedules the cursor and, with
        ``limit``, the batches after it."""
        key = (cursor, epoch)
        self.schedule(cursor, epoch)
        if limit is not None:
            self.prefetch(cursor, epoch, limit)
        if _tel.enabled():
            _tel.set_gauge("io.pipeline.workers_alive",
                           float(sum(p.is_alive() for p in self._procs)))
        stalled = key not in self._ready
        t0 = time.perf_counter()
        while key not in self._ready:
            if time.perf_counter() - t0 > self.timeout:
                raise PipelineError(
                    "decode pipeline stalled %.0fs waiting for cursor %d"
                    % (self.timeout, cursor))
            self._drain_one(0.2, epoch)
            # a drained completion of an older epoch may have freed the
            # slot this cursor needs
            self.schedule(cursor, epoch)
        if stalled:
            _tel.inc("io.pipeline.stalls")
            _tel.observe("io.pipeline.stall_ms",
                         (time.perf_counter() - t0) * 1e3)
        slot = self._ready.pop(key)
        imgs = np.array(self._ring.img_view(slot))
        labels = np.array(self._ring.label_view(slot))
        self._free.append(slot)
        _tel.set_gauge("io.pipeline.ring_occupancy",
                       self.num_slots - len(self._free))
        if limit is not None:
            self.prefetch(cursor, epoch, limit)
        return imgs, labels

    def flush(self):
        """Forget the parked results (a reset). Queued tasks keep their
        slots; their completions are reclaimed as stale."""
        for slot in self._ready.values():
            self._free.append(slot)
        self._ready.clear()

    # -- teardown ----------------------------------------------------------
    @staticmethod
    def _cleanup(procs, task_q, store, ring):
        for p in procs:
            if p.is_alive():
                try:
                    task_q.put_nowait(None)
                except Exception:
                    pass
        for p in procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        try:
            task_q.close()
            task_q.cancel_join_thread()
        except Exception:
            pass
        store.close()
        ring.close()

    def shutdown(self):
        """Stop the workers (the ``None`` task, then terminate) and free
        the shared memory; bounded in time, never raises."""
        if self._closed:
            return
        self._closed = True
        if hasattr(self, "_finalizer"):
            self._finalizer.detach()
        ProcessDecodePipeline._cleanup(self._procs, self._task_q,
                                       self._store, self._ring)
        try:
            self._result_q.close()
            self._result_q.cancel_join_thread()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ---------------------------------------------------------------------------
# device staging
# ---------------------------------------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    """An array of a batch as a tensor where it lies (host data as a CPU
    tensor)."""
    if isinstance(x, NDArray):
        x = x.handle
    if isinstance(x, torch.Tensor):
        return x.detach()
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
        (None on the CPU). Host arrays go through the pinned ring; an
        array already on the card is copied device to device on the copy
        stream, after the work of the stream that made it."""
        tensors = [_as_tensor(a) for a in arrays]
        if self.device.type != "cuda":
            return [t.cpu().clone() for t in tensors], None
        from .replicas import capture_lock

        # never during a capture over several cards (see capture_lock)
        with capture_lock:
            return self._stage_on_card(tensors)

    def _stage_on_card(self, tensors):
        if self._ring is None:
            self._stream = torch.cuda.Stream(self.device)
            self._ring = [[[None if t.is_cuda else
                            torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in tensors],
                           torch.cuda.Event()]
                          for _ in range(self._n_slots)]
        bufs, done = self._ring[self._turn]
        self._turn = (self._turn + 1) % self._n_slots
        done.synchronize()   # the copy out of this slot has run
        for i, t in enumerate(tensors):
            if t.is_cuda:
                continue
            if bufs[i] is None or bufs[i].shape != t.shape \
                    or bufs[i].dtype != t.dtype:
                # a batch of another shape: a new buffer for this slot
                bufs[i] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
            bufs[i].copy_(t)
        if any(t.is_cuda for t in tensors):
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        staged = []
        with torch.cuda.stream(self._stream):
            for t, b in zip(tensors, bufs):
                src = t if t.is_cuda else b
                d = torch.empty(src.shape, dtype=src.dtype,
                                device=self.device)
                d.copy_(src, non_blocking=True)
                if t.is_cuda:
                    t.record_stream(self._stream)
                staged.append(d)
            done.record(self._stream)
        _tel.inc("ndarray.h2d_bytes", sum(t.numel() * t.element_size()
                                          for t in tensors if not t.is_cuda))
        return staged, done


def _hand_over(staged: DataBatch) -> DataBatch:
    """Order the consumer's stream on each card after the batch's copy
    there and keep the allocator from reusing its memory before the
    consumer's work ran."""
    for event, tensors in getattr(staged, "_staged", None) or ():
        if event is None:
            continue
        stream = torch.cuda.current_stream(tensors[0].device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
    staged._staged = None
    return staged


class _Staging:
    """What the staging wrappers share: a :class:`_Stager` a device of
    ``ctx`` (or of the bound group's contexts, ``group``), each with
    ``slots`` ring slots, and :meth:`_stage`."""

    def _init_staging(self, ctx, group, slots):
        if ctx is None:
            ctx = group.context if group is not None else current_context()
        self._ctx = ctx
        contexts = (list(group.contexts) if group is not None
                    and ctx == group.context else [ctx])
        self._stagers = [_Stager(c.torch_device(), slots) for c in contexts]
        self._stager = self._stagers[0]

    def _stage(self, batch: DataBatch) -> DataBatch:
        t0 = time.perf_counter() if _tel.enabled() else 0.0
        n_data = len(batch.data)
        # a device-feed batch's deferred augmentation: dropping it would
        # feed the raw stored frames to the model
        aug = getattr(batch, "aug", None)
        split = (aug is not None and n_data == 1
                 and len(self._stagers) > 1)
        if split:
            # each replica's rows of the frames onto its own card; the
            # batch keeps the host frames as its data
            frames = batch.data[0]
            rows = frames.shape[0] // len(self._stagers)
            parts, staged_events = [], []
            for k, stager in enumerate(self._stagers):
                sl = slice(k * rows, (k + 1) * rows)
                (part,), event = stager.stage([frames[sl]])
                parts.append((sl, part))
                staged_events.append((event, [part]))
            labels, event = self._stager.stage(list(batch.label or []))
            arrays = [batch.data[0]] + [NDArray(t, self._ctx)
                                        for t in labels]
            staged_events.append((event, labels))
        else:
            tensors, event = self._stager.stage(
                list(batch.data) + list(batch.label or []))
            arrays = [NDArray(t, self._ctx) for t in tensors]
            staged_events = [(event, tensors)]
        if _tel.enabled():
            _tel.observe("io.staging.h2d_ms",
                         (time.perf_counter() - t0) * 1e3)
            _tel.inc("io.staging.batches")
        staged = DataBatch(arrays[:n_data], arrays[n_data:], batch.pad,
                           batch.index, bucket_key=batch.bucket_key,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        staged._staged = [(e, ts) for e, ts in staged_events if ts]
        if aug is not None:
            staged.aug = aug
        if split:
            staged.feed_parts = parts
        return staged


class DeviceStagingIter(_Staging, DataIter):
    """Double-buffered staging around any ``DataIter``: ``next()``
    returns the batch staged on the previous call and stages the
    following one at once, so its host-to-device copy runs on the copy
    stream while the card runs the step. ``ctx`` (or the bound executor
    group's context, ``group``) names the device; the default is the
    current context. Given a ``group`` bound over several contexts, a
    device-feed batch's frames are staged a replica's rows a card.

    Telemetry: ``io.staging.h2d_ms`` (the host time to stage a batch),
    ``io.staging.batches`` and ``ndarray.h2d_bytes``."""

    def __init__(self, base: DataIter, ctx=None, group=None):
        super().__init__()
        self.base = base
        # two slots: the batch being handed out and the one staged ahead
        self._init_staging(ctx, group, 2)
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


class FeedScheduler(_Staging, DataIter):
    """Keeps up to ``depth`` staged batches in flight ahead of the
    training loop: a worker thread pulls from the base iterator, stages
    each batch (its ring has ``depth + 2`` slots) and parks it in a
    bounded queue; ``next()`` pops. The time ``next()`` blocks on an
    empty queue is the ``io.feed_stall_ms`` histogram;
    ``io.feed.in_flight`` gauges the queue and ``io.feed.batches``
    counts deliveries. Given a ``group`` bound over several contexts, a
    device-feed batch's frames are staged a replica's rows a card."""

    _END = object()

    def __init__(self, base: DataIter, depth: int = 2, ctx=None,
                 group=None):
        super().__init__()
        self.base = base
        self.depth = max(1, int(depth))
        self._init_staging(ctx, group, self.depth + 2)
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


# ---------------------------------------------------------------------------
# serving-tier request staging
# ---------------------------------------------------------------------------

class RequestStager:
    """Staging of serving request batches (:mod:`mxnet_tpu_torch.serving`),
    as ``mxnet_tpu/io_pipeline.py:812-897`` stages them.

    One scheduled batch is the queued requests' payloads concatenated
    along the batch axis and padded with zero rows up to the scheduled
    bucket, then placed through the caller's ``place`` function
    (``FusedInfer.place_batch``: onto the card). Padding to a ladder rung
    keeps every dispatch one of at most ``len(buckets)`` shapes. The pad
    rows are one cached zero block a (rows, shape, dtype), not a fresh
    allocation a dispatch. A single payload that already fills its bucket
    skips the concatenation and the pad (``serve.stage_fastpath``).

    Telemetry: ``serve.h2d_bytes`` (host bytes handed to ``place``) and
    ``serve.pad_rows``; ``last_fastpath`` and ``last_bytes`` describe the
    latest :meth:`stage` call."""

    def __init__(self, place=None):
        self._place = place
        self.last_fastpath = False
        self.last_bytes = 0
        self._pad_cache: dict = {}

    def rebind_place(self, place) -> None:
        """Place later batches with ``place`` (a server rebuilt its
        ``FusedInfer`` after a re-bind). The pad cache stays: its blocks
        are host arrays."""
        self._place = place

    def _pad_rows(self, pad: int, shape: tuple, dtype) -> np.ndarray:
        key = (pad, shape, np.dtype(dtype).str)
        block = self._pad_cache.get(key)
        if block is None:
            block = np.zeros((pad,) + shape, dtype)
            if len(self._pad_cache) >= 64:   # ladder shapes are few
                self._pad_cache.clear()
            self._pad_cache[key] = block
        return block

    def stage(self, rows, bucket: int):
        """``rows`` holds one payload (a sequence of arrays, rows first)
        a queued request, all of one arity. Returns ``(placed, pad)``:
        the placed arrays of ``bucket`` rows and the zero rows added."""
        n = sum(int(r[0].shape[0]) for r in rows)
        if n > bucket:
            raise MXNetError("request batch of %d rows scheduled into a "
                             "bucket of %d" % (n, bucket))
        pad = bucket - n
        self.last_fastpath = len(rows) == 1 and pad == 0
        if self.last_fastpath:
            batch = [np.asarray(a) for a in rows[0]]
            _tel.inc("serve.stage_fastpath")
        else:
            batch = [np.concatenate([np.asarray(a) for a in col], axis=0)
                     for col in zip(*rows)]
            if pad:
                batch = [np.concatenate(
                    [b, self._pad_rows(pad, b.shape[1:], b.dtype)], axis=0)
                    for b in batch]
        placed = self._place(batch) if self._place is not None else batch
        self.last_bytes = sum(int(b.nbytes) for b in batch)
        _tel.inc("serve.h2d_bytes", self.last_bytes)
        if pad:
            _tel.inc("serve.pad_rows", pad)
        return placed, pad
