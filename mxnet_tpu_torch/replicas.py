"""One process over several devices: the replica set of an executor
group bound over several contexts (ROADMAP.md Queue A item 10a).

The JAX package binds one executor whose arrays are sharded over a
``dp`` mesh, and GSPMD puts the collectives inside the step. The port
binds one :class:`~mxnet_tpu_torch.executor.Executor` a context, each
on an equal slice of the batch and each with its own copy of every
parameter, gradient, aux state and optimizer state, and keeps the
reference's meaning: one host thread walks the replicas in lock-step,
node by node, so that an op whose result depends on the whole batch
(BatchNorm's training statistics, SoftmaxOutput's ``batch`` and
``valid`` normalizations) combines them with a cross-card sum.

* :meth:`Replicas.all_sum` is autograd-aware: one
  ``torch.autograd.Function`` over every replica's tensor that returns
  every replica's sum, whose backward is the same sum of the incoming
  gradients (the pattern of ``torch.nn.parallel``'s Broadcast and
  ReduceAddCoalesced: the engine calls the node once, with all the
  gradients).
* :meth:`Replicas.sum_` sums in place with no gradient: the executor
  group's gradient exchange after the backward (one flat buffer a
  card) and the ``valid`` label count.

On cards a sum is a single-process NCCL all-reduce (``torch.cuda.nccl``,
one group call over every card's stream), which gives every card the
same bytes. On the CPU, where every ``cpu(i)`` is torch's one CPU
device, it adds the replicas' tensors in order, 0 to N-1, and copies
the one result to each.

A fused train step over several cards is one CUDA graph over every card
(:class:`CardGraph`): NCCL refuses a group call whose streams are being
captured into different graphs, so the capture begins on card 0's
stream and forks the other cards' streams into it.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import List, Optional

import torch

from .base import MXNetError

__all__ = ["Replicas", "CardGraph"]


class _On:
    """Card ``k``'s device and stream, entered together."""

    __slots__ = ("device", "stream", "_ctx")

    def __init__(self, device, stream):
        self.device = device
        self.stream = stream

    def __enter__(self):
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(torch.cuda.device(self.device))
        if self.stream is not None:
            self._ctx.enter_context(torch.cuda.stream(self.stream))
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


class Replicas:
    """The devices of a group bound over several contexts, one replica a
    device, in context order. ``streams`` are the streams of the current
    walk, one a card (recorded by :meth:`begin`), on which a collective's
    backward and a recomputed segment launch from autograd's threads."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.cuda = self.devices[0].type == "cuda"
        self.streams: Optional[List] = None
        #: held by a recomputed segment of the mirrored backward, which
        #: may be asked for from two of autograd's device threads at once
        self.remat_lock = threading.Lock()

    def begin(self):
        """Record each card's current stream: the walk's."""
        if self.cuda:
            self.streams = [torch.cuda.current_stream(d)
                            for d in self.devices]

    def device(self, k):
        """A context that makes replica ``k``'s device current, with this
        thread's current stream there (for work outside the walk: a
        batch's copy in, the hyperparameters' rows); nothing on the
        CPU."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.device(self.devices[k])

    def on(self, k, streams=None):
        """A context that makes replica ``k``'s device and the walk's
        stream on it current (inside the walk, and where autograd runs a
        node of it on another thread); nothing on the CPU."""
        if not self.cuda:
            return contextlib.nullcontext()
        streams = streams if streams is not None else self.streams
        return _On(self.devices[k], streams[k] if streams else None)

    def each(self, fn, ctxs, inputs, aux):
        """``fn(ctx, inputs, aux)`` replica by replica, each on its own
        device: ``(outputs, new aux)`` a replica."""
        outs, new_aux = [], []
        for k in range(self.n):
            with self.on(k):
                o, a = fn(ctxs[k], inputs[k], aux[k])
            outs.append(o)
            new_aux.append(a)
        return outs, new_aux

    def sum_(self, tensors, streams=None):
        """Every tensor (one a replica, contiguous, same shape) becomes
        the sum of all of them, in place, with no gradient."""
        if self.cuda:
            streams = streams if streams is not None else self.streams
            torch.cuda.nccl.all_reduce(list(tensors), streams=streams)
            return tensors
        with torch.no_grad():
            total = tensors[0].clone()
            for t in tensors[1:]:
                total += t
            for t in tensors:
                t.copy_(total)
        return tensors

    def all_sum(self, tensors):
        """The sum of the replicas' tensors on every replica, as an
        autograd node whose backward sums the gradients the same way."""
        return list(_AllSum.apply(self, *tensors))


class _AllSum(torch.autograd.Function):
    """One node over every replica: forward and backward are both the
    in-place cross-replica sum of fresh copies."""

    @staticmethod
    def forward(ctx, reps, *xs):
        ctx.reps, ctx.streams = reps, reps.streams
        outs = []
        for k, x in enumerate(xs):
            with reps.on(k):
                outs.append(x.contiguous().clone())
        return tuple(reps.sum_(outs))

    @staticmethod
    def backward(ctx, *grads):
        reps, streams = ctx.reps, ctx.streams
        if any(g is None for g in grads):
            raise MXNetError("cross-card sum: a replica's gradient is "
                             "missing")
        outs = []
        for k, g in enumerate(grads):
            # autograd runs this node on one device's thread: each card's
            # copy goes on the stream the forward ran on there
            with reps.on(k, streams):
                outs.append(g.contiguous().clone())
        return (None,) + tuple(reps.sum_(outs, streams))


class CardGraph:
    """One CUDA graph over every card of ``reps``. :meth:`capture` begins
    on card 0's ``streams[0]``, forks ``streams[1:]`` (one a card) into
    the capture with events, makes each its card's current stream while
    ``fn`` runs, and joins them back before the capture ends; the other
    cards' allocations go to a private pool of the graph's, as card 0's
    do. :meth:`replay` launches it on card 0's current stream after every
    card's current stream, and makes every card's current stream wait
    for it. :meth:`close` (or the collector, through ``__del__``) waits
    for every card, then frees the graph and its pools."""

    def __init__(self, reps: Replicas, streams):
        self.reps = reps
        self.streams = list(streams)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle()
        self._pools_held = False

    def capture(self, fn, capture_error_mode="thread_local"):
        reps, streams = self.reps, self.streams
        for d in reps.devices:
            torch.cuda.synchronize(d)
        gc.collect()    # no dead graph may be freed during the capture
        prev = [torch.cuda.current_stream(d) for d in reps.devices]
        for s, p in zip(streams, prev):
            s.wait_stream(p)
        for d in reps.devices[1:]:
            torch._C._cuda_beginAllocateToPool(d.index, self.pool)
        self._pools_held = True
        try:
            with torch.cuda.device(reps.devices[0]):
                torch.cuda.set_stream(streams[0])
                self.graph.capture_begin(
                    pool=self.pool, capture_error_mode=capture_error_mode)
            try:
                fork = torch.cuda.Event()
                fork.record(streams[0])
                for s in streams[1:]:
                    s.wait_event(fork)
                for s in streams:
                    torch.cuda.set_stream(s)
                fn()
                for s in streams[1:]:
                    join = torch.cuda.Event()
                    join.record(s)
                    streams[0].wait_event(join)
            finally:
                with torch.cuda.device(reps.devices[0]):
                    torch.cuda.set_stream(streams[0])
                    self.graph.capture_end()
        finally:
            for d in reps.devices[1:]:
                torch._C._cuda_endAllocateToPool(d.index, self.pool)
            for p in prev:
                torch.cuda.set_stream(p)

    def replay(self):
        devs = self.reps.devices
        main = [torch.cuda.current_stream(d) for d in devs]
        for s in main[1:]:
            ready = torch.cuda.Event()
            ready.record(s)
            main[0].wait_event(ready)
        with torch.cuda.device(devs[0]):
            self.graph.replay()
        done = torch.cuda.Event()
        done.record(main[0])
        for s in main[1:]:
            s.wait_event(done)

    def close(self):
        """Wait for every card (a replay may still run), then free the
        graph and hand its pools back: card 0's through the graph, the
        others' here. Idempotent."""
        if not self._pools_held:
            return
        self._pools_held = False
        for d in self.reps.devices:
            torch.cuda.synchronize(d)
        self.graph.reset()
        for d in self.reps.devices[1:]:
            torch._C._cuda_releasePool(d.index, self.pool)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
