"""Dependency engine, counterpart of ``mxnet_tpu/engine.py``: operations
pushed with the variables they read and write; conflicting ones run in
order, the rest may run together.

On the card PyTorch orders the work of one stream itself, so the default
engine (:class:`XLAEngine`, named as in the JAX package) runs each
pushed closure inline, and its ``wait_for_all`` synchronises the card.
The others are the JAX package's host engines:

* :class:`NaiveEngine`: synchronous; waits for the card after every
  push that returns tensors (a push marked ``fused_step`` only with
  ``MXNET_TPU_ENGINE_SYNC``).
* :class:`ThreadedEngine`: a host thread pool with the reference's
  ThreadedVar read/write queues; reads of one variable run together,
  writes one at a time, and a ready operation of higher ``priority``
  runs first.
* :class:`ThreadedEnginePooled`: the same with a separate I/O pool for
  pushes marked ``io`` or ``copy``.

``MXNET_ENGINE_TYPE`` picks the engine :func:`get_engine` creates
(read through :mod:`mxnet_tpu_torch.env`); ``NativeThreadedEngine``
raises, since the C API it runs on is not ported. Telemetry counts
``engine.push`` and ``engine.dispatch``, and the threaded engines'
``engine.queue_wait_ms``.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from . import env as _env
from . import telemetry as _tel
from .base import MXNetError

__all__ = ["Engine", "Var", "get_engine", "set_engine", "NaiveEngine",
           "XLAEngine", "ThreadedEngine", "ThreadedEnginePooled"]

_var_counter = itertools.count()


class Var:
    """A unit of read/write dependency tracking (the reference's
    ThreadedVar)."""

    __slots__ = ("vid", "version", "_lock", "_queue", "_num_pending_reads",
                 "_pending_write")

    def __init__(self):
        self.vid = next(_var_counter)
        self.version = 0          # bumped on every completed write
        self._lock = threading.Lock()
        # (is_write, opr) blocks waiting on this variable
        self._queue: deque = deque()
        self._num_pending_reads = 0
        self._pending_write = None

    def __repr__(self):
        return "Var(%d, v%d)" % (self.vid, self.version)


class _OprBlock:
    __slots__ = ("fn", "const_vars", "mutable_vars", "priority", "wait",
                 "lock", "seq", "prop", "enq_t")

    def __init__(self, fn, const_vars, mutable_vars, priority, seq,
                 prop="normal"):
        self.fn = fn
        self.const_vars = const_vars
        self.mutable_vars = mutable_vars
        self.priority = priority
        self.seq = seq
        self.wait = 0
        self.lock = threading.Lock()
        self.prop = prop
        self.enq_t = 0.0

    def dec_wait(self) -> bool:
        with self.lock:
            self.wait -= 1
            return self.wait == 0


def _check_duplicates(const_vars, mutable_vars):
    cset = set(id(v) for v in const_vars)
    mset = set(id(v) for v in mutable_vars)
    if len(mset) != len(mutable_vars):
        raise MXNetError("duplicate variable in mutable_vars")
    if cset & mset:
        raise MXNetError("variable appears in both const_vars and "
                         "mutable_vars")


class Engine:
    """The engine interface."""

    def new_variable(self) -> Var:
        return Var()

    def push(self, fn: Callable[[], object], const_vars: Sequence[Var] = (),
             mutable_vars: Sequence[Var] = (), priority: int = 0,
             prop: str = "normal") -> None:
        """Run ``fn`` after the pushes it depends on: those that write
        a variable of ``const_vars`` or touch one of ``mutable_vars``.
        ``prop`` ("normal", "io", "copy", "fused_step") routes it."""
        raise NotImplementedError

    def wait_for_var(self, var: Var) -> None:
        raise NotImplementedError

    def wait_for_all(self) -> None:
        raise NotImplementedError

    def delete_variable(self, var: Var) -> None:
        """Python's garbage collector owns a variable; kept for the
        API."""


def _bump_versions(mutable_vars: Iterable[Var]):
    for v in mutable_vars:
        v.version += 1


_ENGINE_INFO = None


def _engine_info_enabled():
    global _ENGINE_INFO
    if _ENGINE_INFO is None:   # read once, at the first push
        _ENGINE_INFO = _env.get("MXNET_ENGINE_INFO")
    return _ENGINE_INFO


def _log_push(engine, fn, const_vars, mutable_vars, priority, prop):
    """One line a pushed operation, with its dependency sets."""
    logging.getLogger("mxnet_tpu_torch.engine").info(
        "%s push %s const=%s mutable=%s priority=%d prop=%s",
        type(engine).__name__,
        getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn))),
        [v.vid for v in const_vars], [v.vid for v in mutable_vars],
        priority, prop)


def _synchronize_card():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class XLAEngine(Engine):
    """The default: run each closure inline; the CUDA stream orders the
    device work (the JAX package's XLAEngine leaves it to XLA's queue)."""

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             prop="normal"):
        _check_duplicates(const_vars, mutable_vars)
        if _engine_info_enabled():
            _log_push(self, fn, const_vars, mutable_vars, priority, prop)
        _tel.inc("engine.push")
        fn()
        _tel.inc("engine.dispatch")
        _bump_versions(mutable_vars)

    def wait_for_var(self, var):
        pass   # NDArray.wait_to_read waits for the data itself

    def wait_for_all(self):
        _synchronize_card()


class NaiveEngine(Engine):
    """Synchronous: each push runs inline, and the card is waited for
    when the closure returns tensors on it."""

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             prop="normal"):
        _check_duplicates(const_vars, mutable_vars)
        if _engine_info_enabled():
            _log_push(self, fn, const_vars, mutable_vars, priority, prop)
        _tel.inc("engine.push")
        ret = fn()
        _tel.inc("engine.dispatch")
        _bump_versions(mutable_vars)
        if prop == "fused_step" and not _env.get("MXNET_TPU_ENGINE_SYNC"):
            # waiting here would serialise every batch on the card
            return
        _block_on(ret)

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass


def _block_on(ret):
    if isinstance(ret, (tuple, list)):
        for r in ret:
            _block_on(r)
    elif isinstance(ret, torch.Tensor) and ret.is_cuda:
        torch.cuda.current_stream(ret.device).synchronize()


class ThreadedEngine(Engine):
    """Host thread-pool engine (the reference's ThreadedVar algorithm):
    each variable keeps a FIFO of pending blocks, reads run together,
    writes serialise, and an operation dispatches when its wait count
    reaches zero; workers pop a priority queue."""

    def __init__(self, num_workers: Optional[int] = None):
        self._num_workers = num_workers or 4
        self._heap: List = []
        self._heap_lock = threading.Condition()
        self._pending = 0
        self._pending_lock = threading.Condition()
        self._seq = itertools.count()
        self._shutdown = False
        self._workers = []
        for i in range(self._num_workers):
            t = threading.Thread(target=self._worker_loop,
                                 name="mxtorch-engine-%d" % i, daemon=True)
            t.start()
            self._workers.append(t)

    # -- dependency bookkeeping (ThreadedVar) ------------------------------
    @staticmethod
    def _append_read(var: Var, opr: _OprBlock) -> bool:
        """True if the read is ready at once."""
        with var._lock:
            if var._pending_write is None and not var._queue:
                var._num_pending_reads += 1
                return True
            var._queue.append((False, opr))
            return False

    @staticmethod
    def _append_write(var: Var, opr: _OprBlock) -> bool:
        with var._lock:
            if (var._pending_write is None and var._num_pending_reads == 0
                    and not var._queue):
                var._pending_write = opr
                return True
            var._queue.append((True, opr))
            return False

    def _complete_read(self, var: Var):
        ready = []
        with var._lock:
            var._num_pending_reads -= 1
            if var._num_pending_reads == 0 and var._queue:
                is_write, opr = var._queue[0]
                if is_write:
                    var._queue.popleft()
                    var._pending_write = opr
                    ready.append(opr)
        self._on_deps_resolved(ready)

    def _complete_write(self, var: Var):
        ready = []
        with var._lock:
            var._pending_write = None
            var.version += 1
            # the reads queued next, or the one write at the head
            while var._queue:
                is_write, opr = var._queue[0]
                if is_write:
                    if var._num_pending_reads == 0 \
                            and var._pending_write is None:
                        var._queue.popleft()
                        var._pending_write = opr
                        ready.append(opr)
                    break
                var._queue.popleft()
                var._num_pending_reads += 1
                ready.append(opr)
        self._on_deps_resolved(ready)

    def _on_deps_resolved(self, oprs):
        for opr in oprs:
            if opr.dec_wait():
                self._dispatch(opr)

    # -- scheduling --------------------------------------------------------
    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             prop="normal"):
        const_vars = list(const_vars)
        mutable_vars = list(mutable_vars)
        _check_duplicates(const_vars, mutable_vars)
        if _engine_info_enabled():
            _log_push(self, fn, const_vars, mutable_vars, priority, prop)
        _tel.inc("engine.push")
        opr = _OprBlock(fn, const_vars, mutable_vars, priority,
                        next(self._seq), prop)
        with self._pending_lock:
            self._pending += 1
        # every dependency counted unready, plus one guard unit, so one
        # completing during registration cannot reach zero early
        opr.wait = 1 + len(const_vars) + len(mutable_vars)
        n_ready = 0
        for v in const_vars:
            if self._append_read(v, opr):
                n_ready += 1
        for v in mutable_vars:
            if self._append_write(v, opr):
                n_ready += 1
        with opr.lock:
            opr.wait -= n_ready + 1
            ready = opr.wait == 0
        if ready:
            self._dispatch(opr)

    def _dispatch(self, opr: _OprBlock):
        if _tel.enabled():
            opr.enq_t = time.perf_counter()
        with self._heap_lock:
            heapq.heappush(self._heap, (-opr.priority, opr.seq, opr))
            self._heap_lock.notify()

    def _worker_loop(self, heap=None, cond=None):
        heap = self._heap if heap is None else heap
        cond = self._heap_lock if cond is None else cond
        while True:
            with cond:
                while not heap and not self._shutdown:
                    cond.wait()
                if self._shutdown and not heap:
                    return
                _, _, opr = heapq.heappop(heap)
            if _tel.enabled():
                _tel.inc("engine.dispatch")
                if opr.enq_t:
                    _tel.observe("engine.queue_wait_ms",
                                 (time.perf_counter() - opr.enq_t) * 1e3)
            try:
                opr.fn()
            finally:
                for v in opr.const_vars:
                    self._complete_read(v)
                for v in opr.mutable_vars:
                    self._complete_write(v)
                with self._pending_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._pending_lock.notify_all()

    def wait_for_var(self, var: Var):
        done = threading.Event()
        self.push(done.set, const_vars=[var])
        done.wait()

    def wait_for_all(self):
        with self._pending_lock:
            while self._pending:
                self._pending_lock.wait()

    def stop(self):
        self.wait_for_all()
        with self._heap_lock:
            self._shutdown = True
            self._heap_lock.notify_all()


class ThreadedEnginePooled(ThreadedEngine):
    """A compute pool and a separate I/O pool: pushes marked ``io`` or
    ``copy`` run on the I/O workers (with none, on the compute pool)."""

    def __init__(self, num_workers: Optional[int] = None,
                 num_io_workers: Optional[int] = None):
        super().__init__(num_workers)
        self._io_heap: List = []
        self._io_lock = threading.Condition()
        n_io = 1 if num_io_workers is None else num_io_workers
        self._io_workers = []
        for i in range(n_io):
            t = threading.Thread(
                target=self._worker_loop, args=(self._io_heap,
                                                self._io_lock),
                name="mxtorch-engine-io-%d" % i, daemon=True)
            t.start()
            self._io_workers.append(t)

    def _dispatch(self, opr: _OprBlock):
        if opr.prop in ("io", "copy") and self._io_workers:
            if _tel.enabled():
                opr.enq_t = time.perf_counter()
            with self._io_lock:
                heapq.heappush(self._io_heap, (-opr.priority, opr.seq, opr))
                self._io_lock.notify()
        else:
            super()._dispatch(opr)

    def stop(self):
        super().stop()
        with self._io_lock:
            self._io_lock.notify_all()


_engine: Optional[Engine] = None
_engine_lock = threading.Lock()


def _create_engine() -> Engine:
    kind = _env.get("MXNET_ENGINE_TYPE")
    if kind == "NaiveEngine":
        return NaiveEngine()
    if kind == "ThreadedEnginePooled":
        return ThreadedEnginePooled()
    if kind == "ThreadedEngine":
        return ThreadedEngine()
    if kind in ("NativeEngine", "NativeThreadedEngine"):
        raise MXNetError(
            "MXNET_ENGINE_TYPE=%s runs on the C API, which the port does "
            "not have yet (ROADMAP.md Queue A item 13); use XLAEngine, "
            "NaiveEngine, ThreadedEngine or ThreadedEnginePooled" % kind)
    # XLAEngine, ThreadedEnginePerDevice (the reference's default), unset
    return XLAEngine()


def get_engine() -> Engine:
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = _create_engine()
    return _engine


def set_engine(engine: Engine) -> Engine:
    global _engine
    _engine = engine
    return engine
