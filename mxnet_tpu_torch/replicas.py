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
  card) and the ``valid`` label count; :meth:`Replicas.extreme_` takes
  the max or min the same way (``max``/``min`` over the batch, the
  numerics plane's max-abs under fsdp).
* :meth:`Replicas.all_gather_rows` is autograd-aware: the replicas'
  rows joined on every replica (ROIPooling's feature maps, whose rois
  name images in the whole batch), its backward a reduce-scatter.
* :meth:`Replicas.reduce_scatter` and :meth:`Replicas.all_gather` are
  the fsdp exchange over the group's ``(dp, fsdp)`` mesh (ROADMAP.md
  Queue A item 10c): a shard-major flat buffer a card summed over every
  card with each card keeping its fsdp shard, and each card's shard
  gathered into every card of its fsdp group.
* :meth:`Replicas.gather_along` and :meth:`Replicas.sum_groups` are the
  tensor-parallel forward's exchange within each ``tp`` line of a
  serving grid (:mod:`mxnet_tpu_torch.parallel.tp_infer`): the cards'
  pieces of an activation (or of a param) joined along any axis on every
  card of the line, and the cards' partial products summed. Serving has
  no backward, so neither records one.

On cards a sum is a single-process NCCL all-reduce (``torch.cuda.nccl``,
one group call over every card's stream), which gives every card the
same bytes; the fsdp sum is a reduce-scatter over each fsdp group's
cards, then an all-reduce of the shards over each dp group's. On the
CPU, where every ``cpu(i)`` is torch's one CPU device, it adds the
replicas' tensors in order, 0 to N-1, and copies the one result (or
its slice) to each, so that dp and fsdp give the same bytes there.

:class:`ProcessReplicas` is one process's single replica of a batch
sharded over the ranks of a process group (``parallel.sharding``'s
train step over a DeviceMesh): its sums are ``torch.distributed``
all-reduces over that group.

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
import torch.distributed as dist

from .base import MXNetError

__all__ = ["Replicas", "ProcessReplicas", "ShardedParams", "CardGraph",
           "capture_lock"]

#: held for the whole of a capture over several cards (:class:`CardGraph`)
#: and, by a staging thread, around its copies and allocations on a card
#: (``io_pipeline._Stager``): every allocation on the other cards goes to
#: the graph's pool during the capture, so a staged batch allocated then
#: could share memory that the replays write
capture_lock = threading.Lock()

#: NCCL's ncclMax and ncclMin, the ``op`` of ``torch.cuda.nccl.all_reduce``
_NCCL_MAX, _NCCL_MIN = 2, 3


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
    backward and a recomputed segment launch from autograd's threads.
    ``procs`` is the number of processes whose replicas a sum spans, each
    holding ``n`` of them: 1 here."""

    procs = 1

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

    def extreme_(self, tensors, largest=True, groups=None, streams=None):
        """Every tensor (one a replica, contiguous, one shape) becomes the
        elementwise max (``largest``) or min over the replicas of its
        line of ``groups`` (default: all of them), in place, with no
        gradient."""
        groups = groups or [list(range(self.n))]
        if self.cuda:
            streams = streams if streams is not None else self.streams
            for g in groups:
                torch.cuda.nccl.all_reduce(
                    [tensors[k] for k in g],
                    op=_NCCL_MAX if largest else _NCCL_MIN,
                    streams=_pick(streams, g))
            return tensors
        pick = torch.maximum if largest else torch.minimum
        with torch.no_grad():
            for g in groups:
                total = tensors[g[0]].clone()
                for k in g[1:]:
                    total = pick(total, tensors[k])
                for k in g:
                    tensors[k].copy_(total)
        return tensors

    def all_gather_rows(self, tensors):
        """Every replica's tensor (one shape) joined along dim 0 in
        replica order, on every replica, as an autograd node: replica
        ``k``'s gradient is the sum over the replicas of their gradients'
        rows of ``k`` (a reduce-scatter)."""
        return list(_AllGatherRows.apply(self, *tensors))

    def reduce_scatter(self, inputs, outputs, fsdp_groups, dp_groups,
                       streams=None):
        """The fsdp gradient exchange, with no gradient: ``inputs`` hold a
        flat shard-major buffer a replica (``f`` shards of ``S``
        elements, ``f`` the fsdp size), ``outputs`` one ``S``-element
        buffer a replica. Replica ``k``, the ``j``-th of its fsdp group,
        gets shard ``j`` of the sum of every replica's input.
        ``fsdp_groups`` and ``dp_groups`` are the replica indices of each
        line of the mesh along ``fsdp`` and along ``dp``."""
        if self.cuda:
            streams = streams if streams is not None else self.streams
            nccl = torch.cuda.nccl
            for g in fsdp_groups:
                nccl.reduce_scatter([inputs[k] for k in g],
                                    [outputs[k] for k in g],
                                    streams=_pick(streams, g))
            if len(dp_groups[0]) > 1:
                for g in dp_groups:
                    nccl.all_reduce([outputs[k] for k in g],
                                    streams=_pick(streams, g))
            return outputs
        with torch.no_grad():
            total = inputs[0].clone()
            for t in inputs[1:]:
                total += t
            for g in fsdp_groups:
                for j, k in enumerate(g):
                    size = outputs[k].numel()
                    outputs[k].copy_(total[j * size:(j + 1) * size])
        return outputs

    def all_gather(self, inputs, outputs, fsdp_groups, streams=None):
        """Every replica's ``S``-element shard (``inputs``) into shard
        ``j`` of the flat shard-major buffer (``outputs``) of every
        replica of its fsdp group, ``j`` its index there."""
        if self.cuda:
            streams = streams if streams is not None else self.streams
            for g in fsdp_groups:
                torch.cuda.nccl.all_gather([inputs[k] for k in g],
                                           [outputs[k] for k in g],
                                           streams=_pick(streams, g))
            return outputs
        with torch.no_grad():
            for g in fsdp_groups:
                for j, src in enumerate(g):
                    size = inputs[src].numel()
                    for k in g:
                        outputs[k][j * size:(j + 1) * size].copy_(
                            inputs[src])
        return outputs

    def gather_along(self, tensors, axis: int, groups, streams=None):
        """Every line ``g`` of ``groups`` (replica indices): the
        replicas' ``tensors`` of the line (one a replica, one shape)
        joined along ``axis`` in the line's order, as ``torch.cat``
        would, on each of its replicas. Returns the joined tensor a
        replica. No gradient."""
        out = [None] * self.n
        axis = axis % tensors[0].dim()
        if self.cuda:
            streams = streams if streams is not None else self.streams
            for g in groups:
                shape = tensors[g[0]].shape
                ins, bufs = [], []
                for k in g:
                    with self.on(k, streams):
                        ins.append(tensors[k].contiguous())
                        bufs.append(torch.empty(
                            (len(g),) + tuple(shape), dtype=ins[-1].dtype,
                            device=ins[-1].device))
                torch.cuda.nccl.all_gather(ins, bufs,
                                           streams=_pick(streams, g))
                merged = list(shape)
                merged[axis] *= len(g)
                for k, buf in zip(g, bufs):
                    with self.on(k, streams):
                        out[k] = buf.movedim(0, axis).reshape(merged)
            return out
        for g in groups:
            joined = torch.cat([tensors[k] for k in g], dim=axis)
            for k in g:
                out[k] = joined
        return out

    def sum_groups(self, tensors, groups, streams=None):
        """Every line ``g`` of ``groups``: each of its replicas' tensors
        (contiguous, one shape) becomes the sum of the line's, in place
        (in the line's order on the CPU). No gradient."""
        if self.cuda:
            streams = streams if streams is not None else self.streams
            for g in groups:
                torch.cuda.nccl.all_reduce([tensors[k] for k in g],
                                           streams=_pick(streams, g))
            return tensors
        with torch.no_grad():
            for g in groups:
                total = tensors[g[0]].clone()
                for k in g[1:]:
                    total += tensors[k]
                for k in g:
                    tensors[k].copy_(total)
        return tensors


def _pick(streams, indices):
    return None if streams is None else [streams[k] for k in indices]


class ProcessReplicas(Replicas):
    """This process's one replica (on ``device``) of a batch sharded over
    the ``procs`` ranks of ``group``: the lock-step walk of
    ``make_graph_eval`` over one replica, whose sums run over the group
    (``torch.distributed`` all-reduces; NCCL on a card, gloo on the
    CPU)."""

    def __init__(self, device, group, procs):
        super().__init__([torch.device(device)])
        self.group = group
        self.procs = int(procs)

    def sum_(self, tensors, streams=None):
        with torch.no_grad():
            for t in tensors:
                dist.all_reduce(t, group=self.group)
        return tensors

    def all_sum(self, tensors):
        return list(_ProcessSum.apply(self, *tensors))

    def extreme_(self, tensors, largest=True, groups=None, streams=None):
        op = dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN
        with torch.no_grad():
            for t in tensors:
                dist.all_reduce(t, op=op, group=self.group)
        return tensors

    def all_gather_rows(self, tensors):
        return list(_ProcessGatherRows.apply(self, *tensors))


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


class _AllGatherRows(torch.autograd.Function):
    """One node over every replica: forward the all-gather of the
    replicas' rows onto every replica, backward the reduce-scatter of the
    gathered gradients."""

    @staticmethod
    def forward(ctx, reps, *xs):
        ctx.reps, ctx.streams = reps, reps.streams
        ctx.rows = xs[0].shape[0]
        if not reps.cuda:
            joined = torch.cat(xs)
            return tuple(joined.clone() for _ in xs)
        ins, outs = [], []
        for k, x in enumerate(xs):
            with reps.on(k):
                ins.append(x.contiguous())
                outs.append(torch.empty((reps.n * x.shape[0],)
                                        + tuple(x.shape[1:]),
                                        dtype=x.dtype, device=x.device))
        torch.cuda.nccl.all_gather(ins, outs, streams=reps.streams)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        reps, streams, rows = ctx.reps, ctx.streams, ctx.rows
        if any(g is None for g in grads):
            raise MXNetError("cross-card gather: a replica's gradient is "
                             "missing")
        if not reps.cuda:
            total = grads[0].clone()
            for g in grads[1:]:
                total += g
            return (None,) + tuple(total[k * rows:(k + 1) * rows].clone()
                                   for k in range(reps.n))
        ins, outs = [], []
        for k, g in enumerate(grads):
            with reps.on(k, streams):
                ins.append(g.contiguous())
                outs.append(torch.empty((rows,) + tuple(g.shape[1:]),
                                        dtype=g.dtype, device=g.device))
        torch.cuda.nccl.reduce_scatter(ins, outs, streams=streams)
        return (None,) + tuple(outs)


class _ProcessGatherRows(torch.autograd.Function):
    """The ranks' rows joined in rank order on every rank; backward each
    rank's rows of the gradients summed over the ranks."""

    @staticmethod
    def forward(ctx, reps, *xs):
        ctx.reps = reps
        outs = []
        for x in xs:
            parts = [torch.empty_like(x) for _ in range(reps.procs)]
            dist.all_gather(parts, x.contiguous(), group=reps.group)
            outs.append(torch.cat(parts))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        reps = ctx.reps
        rank = dist.get_rank(reps.group)
        out = []
        for g in grads:
            total = g.contiguous().clone()
            dist.all_reduce(total, group=reps.group)
            out.append(total.chunk(reps.procs)[rank].clone())
        return (None,) + tuple(out)


class _ProcessSum(torch.autograd.Function):
    """The sum over the ranks of a process group, forward and backward:
    each rank's loss reads its copy of the sum, so a part's gradient is
    the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, reps, *xs):
        ctx.reps = reps
        return tuple(reps.sum_([x.contiguous().clone() for x in xs]))

    @staticmethod
    def backward(ctx, *grads):
        if any(g is None for g in grads):
            raise MXNetError("cross-process sum: a gradient is missing")
        return (None,) + tuple(ctx.reps.sum_(
            [g.contiguous().clone() for g in grads]))


class CardGraph:
    """One CUDA graph over every card of ``reps``. :meth:`capture` begins
    on card 0's ``streams[0]``, forks ``streams[1:]`` (one a card) into
    the capture with events, makes each its card's current stream while
    ``fn`` runs, and joins them back before the capture ends; the other
    cards' allocations go to a private pool of the graph's, as card 0's
    do. :meth:`replay` launches it on card 0's
    current stream after every card's current stream, and makes every
    card's current stream wait for it. :meth:`close` (or the collector,
    through ``__del__``) waits for every card, then frees the graph and
    its pools.

    ``generators`` (one a card) are the generators ``fn`` draws from on
    each card (a Dropout's masks): each replay draws afresh, as eager
    draws from the same generator would. PyTorch keeps a registered
    generator's seed and offset for the graph in two tensors on the
    device that is current when it is registered, and a replay first
    fills them on that device's current stream. So card 0's generator is
    registered with the graph under card 0, and card k's under card k
    with a prologue graph of its own (``prologues``): captured on a side
    stream of card k around the main capture, it holds no work of the
    step (one mark), but its registration counts card k's draws and its
    replay fills card k's seed and offset. :meth:`replay` replays every
    prologue before it records the cards' ready events, so each card's
    fill is ordered before the card's part of the graph; the main
    graph's own fill for card 0 runs on card 0's stream just before the
    launch."""

    def __init__(self, reps: Replicas, streams):
        self.reps = reps
        self.streams = list(streams)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle()
        self._pools_held = False
        #: ``(device, graph)`` a card past the first whose generator is
        #: registered for the capture
        self.prologues = []

    def capture(self, fn, capture_error_mode="thread_local",
                generators=None):
        reps = self.reps
        register = None
        if generators is not None:
            register = getattr(self.graph, "register_generator_state", None)
            if register is None or len(generators) != reps.n:
                raise MXNetError(
                    "a CUDA graph over %d cards draws random numbers "
                    "(Dropout): it needs a generator a card (got %d) and a "
                    "PyTorch that can register one with a CUDA graph (this "
                    "is %s), or every replay would reuse one mask"
                    % (reps.n, len(generators), torch.__version__))
        with capture_lock:
            self._capture(fn, capture_error_mode, generators, register)

    def _capture(self, fn, capture_error_mode, generators, register):
        reps, streams = self.reps, self.streams
        for d in reps.devices:
            torch.cuda.synchronize(d)
        gc.collect()    # no dead graph may be freed during the capture
        prev = [torch.cuda.current_stream(d) for d in reps.devices]
        for s, p in zip(streams, prev):
            s.wait_stream(p)
        if generators is not None:
            with torch.cuda.device(reps.devices[0]):
                register(generators[0])
            self._begin_prologues(generators[1:])
        try:
            # every allocation on the other cards goes to the graph's pool
            # until the capture ends (capture_lock keeps a staging
            # thread's off the cards meanwhile)
            for d in reps.devices[1:]:
                torch._C._cuda_beginAllocateToPool(d.index, self.pool)
            self._pools_held = True
            try:
                with torch.cuda.device(reps.devices[0]):
                    torch.cuda.set_stream(streams[0])
                    self.graph.capture_begin(
                        pool=self.pool,
                        capture_error_mode=capture_error_mode)
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
        finally:
            self._end_prologues()
            for p in prev:
                torch.cuda.set_stream(p)

    def _begin_prologues(self, generators):
        """Card k's prologue graph: ``generators[k - 1]`` registered
        under card k, its capture begun on a side stream of card k (in
        relaxed mode: the main capture's own calls stay allowed). The
        generator counts every draw made on card k until
        :meth:`_end_prologues` ends it."""
        for d, gen in zip(self.reps.devices[1:], generators):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(d):
                graph.register_generator_state(gen)
                mark = torch.zeros(1, dtype=torch.int32, device=d)
                side = torch.cuda.Stream(d)
                side.wait_stream(torch.cuda.current_stream(d))
                keep = torch.cuda.current_stream(d)
                torch.cuda.set_stream(side)
                try:
                    graph.capture_begin(capture_error_mode="relaxed")
                    mark.add_(1)    # the graph's one node
                finally:
                    torch.cuda.set_stream(keep)
            self.prologues.append((d, graph, side, mark))

    def _end_prologues(self):
        """End every prologue capture begun (each on its own stream)."""
        ended = []
        for d, graph, side, mark in self.prologues:
            with torch.cuda.device(d):
                keep = torch.cuda.current_stream(d)
                torch.cuda.set_stream(side)
                try:
                    graph.capture_end()
                finally:
                    torch.cuda.set_stream(keep)
            ended.append((d, graph))
        self.prologues = ended

    def replay(self):
        devs = self.reps.devices
        main = [torch.cuda.current_stream(d) for d in devs]
        for d, prologue in self.prologues:
            # card k's seed and offset filled on card k's current stream,
            # before its ready event below
            with torch.cuda.device(d):
                prologue.replay()
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
        for _, prologue in self.prologues:
            prologue.reset()
        self.prologues = []
        for d in self.reps.devices[1:]:
            torch._C._cuda_releasePool(d.index, self.pool)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShardedParams:
    """The fsdp storage of a group's sharded parameters (ROADMAP.md Queue
    A item 10c) over a ``(dp, fsdp)`` mesh of the replicas.

    Parameter ``p`` (``names``, dim 0 divisible by the fsdp size ``f``)
    is cut along dim 0 into ``f`` shards of ``m_p`` elements; the card
    at fsdp index ``j`` keeps shard ``j``. A card's shards of every
    parameter sit end to end in one flat buffer of ``S`` elements, in
    ``names`` order: ``master`` (the weights the update writes) and
    ``grads`` (the reduced gradient the update reads), both a card.
    ``works`` and ``flat_grads`` are each card's full-width flat
    buffers (``f * S`` elements), in ``names`` order, of which the
    executors' parameter and gradient arrays are views (the walk's
    workspace). Each serves in turn as the shard-major buffer (shard
    ``j`` of every parameter at ``j * S``) that both collectives take,
    while it holds nothing else:

    * :meth:`gather` before a forward, while the gradients are spent:
      every card's master into ``flat_grads`` of each card of its fsdp
      group (one all-gather a group), then into ``works`` by one
      ``torch.cat`` a card;
    * :meth:`reduce` after a backward, once the walk is done with the
      weights: ``flat_grads`` into ``works`` by one ``torch.cat`` a
      card, then one reduce-scatter a fsdp group and one all-reduce of
      the shards a dp group into ``grads``.

    So between a backward and the next forward ``works`` holds the
    packed gradients, not weights: the weights are the master shards
    (:meth:`gather_value`)."""

    def __init__(self, reps, mesh, names, shapes, works, flat_grads,
                 contexts, adds=()):
        from .ndarray import NDArray

        f = int(mesh.shape["fsdp"])
        self.reps = reps
        self.names = list(names)
        self.fsdp_groups = mesh.groups("fsdp")
        self.dp_groups = mesh.groups("dp")
        self.at = [mesh.coords(k)["fsdp"] for k in range(reps.n)]
        self.f = f
        self.shapes = {n: tuple(s) for n, s in zip(names, shapes)}
        sizes = [int(torch.Size(s).numel()) // f for s in shapes]
        offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.size = sum(sizes)
        #: name -> (offset in a card's shard buffer, elements a shard)
        self.index = {n: (o, m) for n, o, m in zip(names, offsets, sizes)}
        self.works = list(works)
        self.flat_grads = list(flat_grads)
        #: the parameters bound with grad_req "add": each backward's
        #: reduced shard is added to the shard's gradient
        self.adds = set(adds)
        self._incoming = None
        self.master, self.grads = [], []
        self._weights, self._grad_views = [], []
        for k, ctx in enumerate(contexts):
            dev = works[k].device
            self.master.append(torch.zeros(self.size, dtype=torch.float32,
                                           device=dev))
            self.grads.append(torch.zeros(self.size, dtype=torch.float32,
                                          device=dev))
            self._weights.append({n: NDArray(self._view(self.master[k], n),
                                             ctx) for n in names})
            self._grad_views.append({n: NDArray(self._view(self.grads[k], n),
                                                ctx) for n in names})
        s = self.size
        # torch.cat's pieces: gathered flat_grads -> works is
        # parameter-major (each parameter's f shards in order),
        # flat_grads -> packed works is shard-major (every parameter's
        # shard j, then j + 1)
        self._unpack = [[g[j * s + o:j * s + o + m]
                         for n in names for o, m in [self.index[n]]
                         for j in range(f)] for g in self.flat_grads]
        starts = [f * o for o in offsets]
        self._pack = [[g[st + j * m:st + (j + 1) * m]
                       for j in range(f)
                       for st, m in zip(starts, sizes)]
                      for g in self.flat_grads]

    def _view(self, flat, name):
        o, m = self.index[name]
        shape = self.shapes[name]
        return flat[o:o + m].view((shape[0] // self.f,) + shape[1:])

    def rows(self, name, k) -> slice:
        """The rows of dim 0 of ``name`` that card ``k`` keeps."""
        r = self.shapes[name][0] // self.f
        j = self.at[k]
        return slice(j * r, (j + 1) * r)

    def weight(self, name, k):
        """Card ``k``'s master shard of ``name`` (an NDArray view)."""
        return self._weights[k][name]

    def grad(self, name, k):
        """Card ``k``'s shard of ``name``'s reduced gradient."""
        return self._grad_views[k][name]

    def gather_value(self, name) -> torch.Tensor:
        """``name`` over its whole shape from the first fsdp group's
        master shards, on the first card."""
        return self._joined(self._weights, name)

    def gather_grad(self, name) -> torch.Tensor:
        """``name``'s reduced gradient over its whole shape, from the
        first fsdp group's shards, on the first card."""
        return self._joined(self._grad_views, name)

    def _joined(self, views, name):
        first = self.works[0].device
        return torch.cat([views[k][name].handle.to(first)
                          for k in self.fsdp_groups[0]])

    def gather(self):
        """Every card's master shards into its replicas' workspace."""
        reps = self.reps
        reps.all_gather(self.master, self.flat_grads, self.fsdp_groups)
        for k in range(reps.n):
            with reps.on(k):
                torch.cat(self._unpack[k], out=self.works[k])

    def reduce(self):
        """Every card's full-width gradients, summed over all cards, into
        the cards' reduced shards: written, or added where the parameter
        is in :attr:`adds` (through a shard buffer a card)."""
        reps = self.reps
        for k in range(reps.n):
            with reps.on(k):
                torch.cat(self._pack[k], out=self.works[k])
        if not self.adds:
            reps.reduce_scatter(self.works, self.grads, self.fsdp_groups,
                                self.dp_groups)
            return
        if self._incoming is None:
            self._incoming = [torch.empty_like(g) for g in self.grads]
        reps.reduce_scatter(self.works, self._incoming, self.fsdp_groups,
                            self.dp_groups)
        for k in range(reps.n):
            with reps.on(k):
                for name, (o, m) in self.index.items():
                    dst = self.grads[k][o:o + m]
                    src = self._incoming[k][o:o + m]
                    if name in self.adds:
                        dst.add_(src)
                    else:
                        dst.copy_(src)
