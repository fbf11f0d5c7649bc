"""Fused steps, counterparts of ``mxnet_tpu/fused_step.py``: the train
step (on one device, or over the cards of a group bound over several
contexts) and the inference step (on one device, or over a grid of a
group's contexts: each batch's rows split over ``dp``, and on a
``(dp, tp)`` grid every param that ``tp_param_spec`` splits kept as one
shard a card, its FullyConnected and Convolution products split,
:mod:`mxnet_tpu_torch.parallel.tp_infer`).

:class:`FusedTrainStep` runs a training batch as one unit: the train
forward, the backward, the optimizer's update (every kind whose plan
describes its update: SGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta) and
the metric fold, on the bound arrays in place. On a card that unit is
one CUDA graph, captured by the step that ``fit`` builds and replayed
for every batch, where the JAX package compiles one donated XLA
dispatch. The first batch runs eagerly
(a real training step, which builds the kernels' libraries, sets their
one-time attributes and lets cuDNN choose its algorithms), the second
is captured on a side stream and replayed at once, and every later
batch is an in-place copy of the batch into the bound data and label
arrays, the hyperparameter refresh (``Optimizer.plan``, on the host)
and one ``replay()``. On the CPU, which only a caller who asks
for it gets, the same step function runs eagerly.

With the numerics plane armed (:mod:`mxnet_tpu_torch.numwatch`:
``MXNET_TPU_NUMWATCH`` or a default-stat ``Monitor``) the step also
keeps copies of the weights from before the update, folds the stats
pack in place after the update (inside the graph on a card) and, under
the skip guard, selects the pre-step weights, optimizer states and
metric sums on a device predicate when a gradient is not finite; the
aux states and the pack still advance on such a step, as in the JAX
package.

A device-feed batch (``io_cache.CachedImageRecordIter(device_feed=
True)``: raw uint8 frames, with the crop offsets, mirror flags, mean and
scale in ``batch.aug``) is copied into step-owned device buffers
(:class:`~mxnet_tpu_torch.io_cache.DeviceFeed`, one a card over several
contexts, each holding its replica's rows), only its labels go through
the group's loader, and the step function's first node on each card is
the ``crop_norm`` kernel, which crops, mirrors and normalises the frames
into the bound data array: one graph serves every batch, mean and scale
(``step.fused_feed_batches`` counts such batches). A graph with more
than one data input materialises the batch instead, as the JAX package
does. Under ``compute_dtype`` the feed still writes float32, which the
executor's cast wrapper casts.

The graph reads and writes fixed addresses: the bound weights and
gradients, the aux states, the optimizer states, the metric's device
accumulator, the numerics pack with the pre-step copies, the feed's
buffers, and the executors' generators. A checkpoint restore
(:mod:`mxnet_tpu_torch.checkpoint`) therefore copies into those tensors
and never replaces one, so the next replay runs on the restored values.
The step captures again when the update's structure changes or when a
weight, gradient or state tensor it captured is no longer the one the
module holds, never replaying a graph over storage the module let go.

Over several contexts (ROADMAP.md Queue A item 10a) the step runs the
group's replicas together: the lock-step forward, one backward with the
gradient exchange (an all-reduce over a flat buffer a card) at its end,
the host half of the update once and its device half on every card,
and each card's metric fold into that card's accumulator, after each
card's crop of its rows of a device-feed batch. On cards the whole of it
is one CUDA graph over every card
(:class:`~mxnet_tpu_torch.replicas.CardGraph`): one capture and one
replay a step, with the exchange inside the replayed work; a graph that
draws random numbers (Dropout) draws on each card from that replica's
own generator, registered for the capture under its card, so every
replay draws fresh masks, each card its own. The numerics plane folds on
every card (:meth:`~mxnet_tpu_torch.numwatch.NumWatch.fold_replicas`):
each card its exchanged gradients and its weights, or under fsdp its
shards, with the partial statistics combined across each fsdp line and
the head's summed over every card, so that every card's pack is the
whole batch's and every card computes the same skip predicate; the skip
guard then restores each card's own pre-step weights (master shards
under fsdp), optimizer states and metric sums.

A :class:`FusedInfer` packs the bound executor's non-data arguments and
auxiliary states onto the device once, then serves each batch with one
call: place the batch on the device, run the forward and the argmax or
top-k under ``torch.inference_mode()``, and hand back device tensors. A
delta refresh (``refresh_params(host_params, digests)``) copies only the
params whose digest changed into the packed tensors, in place. Over a
grid of cards the call walks the cards in lock-step, each on its rows,
and joins the outputs on the first card.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from . import autotune as _autotune
from . import env as _env
from . import numwatch as _numwatch
from . import telemetry as _tel
from . import xprof as _xprof
from .analysis import sanitizers as _san
from .base import MXNetError
from .metric import CompositeEvalMetric
from .ndarray import NDArray
from .optimizer import _state_tensors
from .replicas import CardGraph

__all__ = ["enabled", "make_fused_step", "FusedTrainStep",
           "make_fused_infer", "FusedInfer"]


def enabled() -> bool:
    """``MXNET_TPU_FUSED_STEP=1`` asks ``fit`` for the fused step
    (default off)."""
    return _env.get("MXNET_TPU_FUSED_STEP")


def make_fused_step(module, eval_metric, monitor=None):
    """A :class:`FusedTrainStep` over a Module bound for training with
    its params and optimizer initialised. A configuration the step cannot
    run raises :class:`MXNetError` naming the reason (the JAX package
    warns and falls back to the classic loop; the port has no fallback):
    a kvstore whose ``fused_step_compatible`` is false (a ``dist`` one of
    several workers, or ``dist_async``: the message is its
    ``fused_fallback`` reason),
    ``inputs_need_grad``, a monitor with
    a custom ``stat_func`` (``monitor``, or one installed on the
    executor), a grad_req other than ``"write"``, or an optimizer without
    a fusable update (``Optimizer._fusable``: SGLD, Test, a subclass that
    overrides ``update`` or ``update_multi``) or with
    ``MXNET_TPU_FUSED_UPDATE=0``, or a graph with a Custom node (a host
    callback, which a CUDA graph cannot hold). A default-stat monitor
    rides the numerics pack."""
    if not (module.binded and module.for_training
            and module.params_initialized and module.optimizer_initialized):
        raise MXNetError("fused train step: the module must be bound for "
                         "training with its params and optimizer "
                         "initialised")
    kv = module._kvstore
    if kv is not None and not getattr(kv, "fused_step_compatible", False):
        reason = getattr(kv, "fused_fallback", None)
        raise MXNetError("fused train step: kvstore %r: %s; use 'local', "
                         "'device', 'device_sync', a one-worker "
                         "'dist_sync' or None"
                         % (kv.type, reason[1] if reason else
                            "it moves gradients between dispatches"))
    if module.inputs_need_grad:
        raise MXNetError("fused train step: inputs_need_grad=True needs "
                         "input gradients that the step does not keep")
    group = module._exec_group
    ex = group.executor
    holder = group.replicated or ex
    if monitor is None and holder._monitor_callback is not None:
        cb = holder._monitor_callback
        monitor = getattr(cb, "__self__", cb)
    if monitor is not None and not _numwatch.monitor_routable(monitor):
        raise MXNetError("fused train step: a monitor with a custom "
                         "stat_func reads every internal tensor, which the "
                         "step keeps inside its graph (monitor_custom); a "
                         "default-stat Monitor rides the numerics pack")
    adds = sorted(n for n, r in ex._grad_req.items()
                  if r not in ("write", "null"))
    if adds:
        raise MXNetError("fused train step: grad_req %s on %s accumulates "
                         "across batches; the step needs \"write\""
                         % (sorted({ex._grad_req[n] for n in adds}), adds))
    _refuse_host_callbacks("fused train step", ex._symbol)
    opt = module._optimizer
    if not opt._fusable() or not _env.get("MXNET_TPU_FUSED_UPDATE"):
        raise MXNetError("fused train step: optimizer %s has no fusable "
                         "update plan (or MXNET_TPU_FUSED_UPDATE=0); its "
                         "update runs only in the classic loop"
                         % type(opt).__name__)
    return FusedTrainStep(module, eval_metric, monitor)


class FusedTrainStep:
    """Forward, backward, optimizer update and metric fold as one CUDA
    graph (one eager step function on the CPU), over the bind the module has
    when the step is built: ``fit`` builds one a call, so each ``fit`` on
    a card runs its first batch eagerly and captures on its second.

    ``eager_steps`` counts the batches run eagerly (the first on a card,
    every one on the CPU), ``captures`` the graphs captured (one, and one
    more only if the update's structure, ``Optimizer.structure``, or a
    tensor it updates changes) and
    ``dispatches`` the replays, one a batch after the first on a card.
    The kernels' wrappers count the launches of the eager step and those
    the capture records; a replay moves no count
    (``ops.kernels.launches_in`` counts a replay's launches from a
    profiler's kernel events).

    ``get_outputs()`` returns fixed output tensors that every batch
    overwrites: a batch-end callback that keeps them across batches must
    copy them. The metric folds on the device when it has a device fold
    (Accuracy, TopKAccuracy, CrossEntropy, or a composite of them) and
    there is one label an output; otherwise it updates on the host from
    the outputs after each batch, as the JAX package does.

    Telemetry: ``step.dispatches`` each replay, ``step.fused_recompiles``
    each capture (StepTrace labels the capturing step ``recompile``).

    With the compile registry on (``MXNET_TPU_XPROF``) each capture is a
    ``fused_step`` record: its wall time, the signature of the bound
    arguments and aux states by name, and the FLOPs of the eager step
    (``step_flops``, by category); a capture whose eager step's memory
    would not fit twice over is refused first (``xprof.preflight_check``).
    ``MXNET_TPU_SANITIZE``'s ``retrace`` raises on a capture after the
    warmup steps, and ``donation`` checks after every step that each
    weight, gradient and optimizer state the module holds is the tensor
    the step writes.

    A mirrored executor (``MXNET_BACKWARD_DO_MIRROR``) runs through the
    same step: its checkpointed segments recompute inside the backward,
    in the eager step and in the one captured graph alike."""

    def __init__(self, module, eval_metric, monitor=None):
        self._module = module
        self._optimizer = module._optimizer
        self._updater = module._updater
        group = module._exec_group
        self._ex = group.executor
        #: the replica set of a group over several contexts, else None
        self._reps = group.replicas
        n_labels = len(group.label_names)
        foldable = (eval_metric.has_device_fold and n_labels > 0
                    and n_labels == len(self._ex.output_names))
        #: the metric folded inside the step, or None (host update)
        self._fold = eval_metric if foldable else None
        names = [n for n in module._param_names if n in self._ex.grad_dict]
        #: the numerics plane riding the step, or None
        self._numwatch = _numwatch.maybe_plane(
            names, [self._ex.arg_dict[n].handle.numel() for n in names],
            monitor)
        #: card -> [pre-update weights, flat (numerics plane); pre-step
        #: optimizer states, flat, and metric sums (skip guard)]
        self._old = {}
        self._w_old = None      # the first card's pre-update weights
        self._stream = None
        self._outs = None
        self._graph = None
        self._structure = None
        self._captured = []
        #: the device feed's buffers (a DeviceFeed, or one a card over
        #: several contexts: one set a frame shape, crop and layout), and
        #: the set the graph was captured with
        self._feed = None
        self._captured_feed = None
        self.eager_steps = 0
        self.captures = 0
        self.dispatches = 0
        #: FLOPs by category of the eager step (xprof), or None
        self.step_flops = None
        self._eager_mem = None      # (live before, peak) of the eager step
        self._retrace_san = (_san.RetraceSanitizer()
                             if _san.enabled("retrace") else None)
        self._donation = _san.enabled("donation")
        self._held = None           # (tensor, data_ptr) the graph writes
        self._streams = None        # a side stream a card (several)

    def _params(self):
        """(updater index, weight, grad, state tensors) of every
        parameter with a gradient, in the updater's order, and the same
        items as NDArrays (the state as the updater keeps it)."""
        arrays = []
        for i, g, w in self._module._update_items()[0]:
            arrays.append((i, w, g, self._updater._state(i, w)))
        return [(i, w.handle, g.handle, _state_tensors(s))
                for i, w, g, s in arrays], arrays

    def _body(self, items, structure, hyper, feed=None):
        """The step function: everything between the batch's copy in and
        the host's next look, with no host sync. With ``feed`` (the device
        feed's buffers) it starts by cropping and normalising the frames
        into the bound data array."""
        ex = self._ex
        if feed is not None:
            name = self._module._exec_group.data_names[0]
            feed.crop(out=ex.arg_dict[name].handle)
        # an installed monitor is served from the pack, not by callback
        callback, ex._monitor_callback = ex._monitor_callback, None
        try:
            ex.forward(is_train=True)
        finally:
            ex._monitor_callback = callback
        ex.backward()
        if self._outs is None:
            self._outs = [torch.empty_like(o.handle) for o in ex._outputs]
        for dst, o in zip(self._outs, ex._outputs):
            dst.copy_(o.handle)
        ws = [w for _, w, _, _ in items]
        gs = [g for _, _, g, _ in items]
        ss = [s for _, _, _, s in items]
        nw = self._numwatch
        if nw is not None:
            live, kept = self._keep_pre_step(ws, ss)
        self._optimizer.apply(structure, hyper, ws, gs, ss)
        labels = [ex.arg_dict[n].handle
                  for n in self._module._exec_group.label_names]
        if self._fold is not None:
            self._fold.device_fold(labels, self._outs)
        if nw is not None:
            grads_ok = nw.fold(self._w_old, gs, ws, self._outs, labels)
            if nw.skip_guard:
                # a nonfinite gradient: every tensor the update or the
                # metric fold wrote takes its pre-step value back
                for new, old in zip(live, kept):
                    torch.where(grads_ok, new, old, out=new)

    def _step_fn(self, *args):
        """The step function of this bind: :meth:`_body`, or
        :meth:`_body_replicas` over several contexts. (Chosen per call:
        a bound method kept on the step would make a reference cycle, and
        the cycle collector could then free a dead step's CUDA graph in
        the middle of another capture.)"""
        if self._reps is None:
            return self._body(*args)
        return self._body_replicas(*args)

    def _replica_items(self):
        """Every replica's ``(updater index, weight, grad, state
        tensors)``, a list a replica in the updater's order; the states
        are each replica's own updater's."""
        module = self._module
        return [[(i, w.handle, g.handle, _state_tensors(updater._state(i, w)))
                 for i, g, w in items]
                for updater, items in zip(module._updaters,
                                          module._update_items())]

    def _body_replicas(self, all_items, structure, hypers, feed):
        """The step function over every replica: with ``feed`` (a
        DeviceFeed a card) each card's crop of its rows into its bound
        data array, then the lock-step forward (under fsdp its gather
        first), the backward with the gradient exchange, and per card
        the update from its own copy of the rows and the metric fold
        into its own accumulator; the numerics plane folds the first
        card."""
        group, reps = self._module._exec_group, self._reps
        rex = group.replicated
        if feed is not None:
            reps.begin()
            name = group.data_names[0]
            for k, (ex, f) in enumerate(zip(group.execs, feed)):
                with reps.on(k):
                    f.crop(out=ex.arg_dict[name].handle)
        callback, rex._monitor_callback = rex._monitor_callback, None
        try:
            rex.forward(is_train=True)
        finally:
            rex._monitor_callback = callback
        rex.backward()
        if self._outs is None:
            self._outs = [[torch.empty_like(o.handle) for o in ex._outputs]
                          for ex in group.execs]
        nw = self._numwatch
        kept, folds, labels_all = [], [], []
        for k, (ex, items, hyper) in enumerate(zip(group.execs, all_items,
                                                   hypers)):
            with reps.on(k):
                for dst, o in zip(self._outs[k], ex._outputs):
                    dst.copy_(o.handle)
                ws = [w for _, w, _, _ in items]
                gs = [g for _, _, g, _ in items]
                ss = [s for _, _, _, s in items]
                if nw is not None:
                    kept.append(self._keep_pre_step(ws, ss, k))
                    folds.append((self._old[k][0], gs, ws))
                self._optimizer.apply(structure, hyper, ws, gs, ss)
                labels = [ex.arg_dict[n].handle for n in group.label_names]
                labels_all.append(labels)
                if self._fold is not None:
                    self._fold.device_fold(labels, self._outs[k], k)
        if nw is None:
            return
        shards = group.shards
        owned = fsdp = None
        if shards is not None:
            # a parameter fsdp does not shard is whole on every card:
            # counted once a fsdp line, by its first card
            names = [name for name, _, _ in group.update_arrays(0)]
            owned = [[name in shards.index or shards.at[k] == 0
                      for name in names] for k in range(reps.n)]
            fsdp = shards.fsdp_groups
        oks = nw.fold_replicas(reps, folds, self._outs, labels_all, owned,
                               fsdp)
        if nw.skip_guard:
            # every card computes the same predicate from the exchanged
            # gradients, so every card keeps or restores its own state
            for k, ((live, old), ok) in enumerate(zip(kept, oks)):
                with reps.on(k):
                    for new, prev in zip(live, old):
                        torch.where(ok, new, prev, out=new)

    def _keep_pre_step(self, ws, ss, k=0):
        """Copy card ``k``'s weights (and, under the skip guard, every
        optimizer state tensor and the metric's device sums) into
        step-owned tensors of that card before the update: the weights
        and the states each into one flat float32 buffer by one batched
        copy. Returns the live tensors the skip guard restores and their
        copies."""
        old = self._old.setdefault(k, [None, None, None])
        old[0] = _flat_copy(old[0], ws)
        if k == 0:
            self._w_old = old[0]
        live, kept = list(ws), _views(old[0], ws)
        if not self._numwatch.skip_guard:
            return live, kept
        states = [t for s in ss for t in s]
        if states:
            old[1] = _flat_copy(old[1], states)
            live += states
            kept += _views(old[1], states)
        if self._fold is not None:
            leaves = (self._fold.metrics
                      if isinstance(self._fold, CompositeEvalMetric)
                      else [self._fold])
            dev = ws[0].device
            accs = [leaf.accumulator(dev) if k == 0
                    else leaf.replica_accumulator(k, dev) for leaf in leaves]
            if old[2] is None:
                old[2] = [torch.empty_like(a) for a in accs]
            for dst, a in zip(old[2], accs):
                dst.copy_(a)
            live += accs
            kept += old[2]
        return live, kept

    def step(self, data_batch, eval_metric):
        """One training batch; ``eval_metric`` is updated on the host
        when the metric the step was built with does not fold."""
        group = self._module._exec_group
        ex = self._ex
        if group.executor is not ex:
            raise MXNetError("fused train step: the module was bound again "
                             "after the step was built; build a new step")
        if self._reps is None:
            args = self._load_one(data_batch)
        else:
            args = self._load_replicas(data_batch)
        if ex._device.type != "cuda":
            self._eager(*args)
        elif self.eager_steps == 0:
            self._warm_up(*args)
        else:
            self._replay(*args)
        if self._held is None:
            self._held = [(t, t.data_ptr()) for t in _written_all(
                self._item_lists(args[0]))]
        if self._donation:
            live = self._item_lists(self._params()[0] if self._reps is None
                                    else self._replica_items())
            _san.DonationSanitizer.check("the fused step", self._held,
                                         _written_all(live))
        if self._retrace_san is not None:
            self._retrace_san.check(self.captures)
        outs = [self._outs] if self._reps is None else self._outs
        for e, o in zip(group.execs, outs):
            e._outputs = [NDArray(t, e._ctx) for t in o]
        if self._numwatch is not None:
            self._numwatch.stepped()
        if self._fold is None:
            with _san.intentional_transfer():    # a host-side metric
                group.update_metric(eval_metric, data_batch.label)

    def _item_lists(self, items):
        """``items`` (the step function's first argument) as a list of
        one replica's items a replica."""
        return [items] if self._reps is None else items

    def _load_one(self, data_batch):
        """The batch (or the device feed's frames) into the bound arrays
        and the step's rows on the device: the step function's
        arguments."""
        group = self._module._exec_group
        aug = getattr(data_batch, "aug", None)
        if aug is not None and len(group.data_names) != 1:
            # the in-graph crop is for the one image input of the cached
            # iterators; anything else materialises
            from .io_cache import materialize_device_feed

            data_batch = materialize_device_feed(data_batch, group.context)
            aug = None
        feed = None
        if aug is None:
            group.load_data_batch(data_batch)
        else:
            from .io_cache import load_device_feed

            feed = self._feed = load_device_feed(self._feed, data_batch,
                                                 self._ex._device)
            group.load_label_batch(data_batch)
            _tel.inc("step.fused_feed_batches")
        items, arrays = self._params()
        opt = self._optimizer
        structure = opt.structure([i for i, _, _, _ in items])
        rows = opt.plan(arrays, structure)
        hyper = opt.scalars(self._ex._device, rows.shape).copy(rows)
        return items, structure, hyper, feed

    def _load_replicas(self, data_batch):
        """:meth:`_load_one` over the replicas of a group bound over
        several contexts: the batch copied in slice by slice (a
        device-feed batch's rows each into its card's step-owned
        buffers), the host half of the update once and its rows copied
        to every card."""
        group, reps = self._module._exec_group, self._reps
        aug = getattr(data_batch, "aug", None)
        feed = None
        if aug is None or len(group.data_names) != 1:
            group.load_data_batch(data_batch)
        else:
            feeds = group.load_feed(data_batch, self._feed)
            # the same list while every card keeps its buffers, so a
            # replay does not capture again
            if self._feed is None or any(
                    a is not b for a, b in zip(feeds, self._feed)):
                self._feed = feeds
            feed = self._feed
            group.load_label_batch(data_batch)
            _tel.inc("step.fused_feed_batches")
        all_items = self._replica_items()
        _, arrays = self._params()
        opt = self._optimizer
        structure = opt.structure([i for i, _, _, _ in all_items[0]])
        rows = opt.plan(arrays, structure)
        hypers = []
        for k, ex in enumerate(group.execs):
            with reps.device(k):
                hypers.append(opt.scalars(ex._device, rows.shape).copy(rows))
        return all_items, structure, hypers, feed

    def _eager(self, *args):
        """The step function run eagerly; the first such step is
        measured for the registry where it is on: FLOPs by category
        (``MXNET_TPU_XPROF_OPS``) and, on a card, its peak allocation
        above what was live before it."""
        if self.eager_steps or not _xprof.enabled():
            self._step_fn(*args)
        else:
            dev = self._ex._device
            if dev.type == "cuda":
                live = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            if _env.get("MXNET_TPU_XPROF_OPS"):
                _, self.step_flops = _xprof.count_flops(
                    lambda: self._step_fn(*args))
            else:
                self._step_fn(*args)
            if dev.type == "cuda":
                self._eager_mem = (live, torch.cuda.max_memory_allocated(dev))
        self.eager_steps += 1

    # -- the card ----------------------------------------------------------
    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._ex._device)
        return self._stream

    def _side_streams(self):
        """A side stream a card (the first is :meth:`_side_stream`)."""
        if self._streams is None:
            self._streams = [self._side_stream()] + [
                torch.cuda.Stream(d) for d in self._reps.devices[1:]]
        return self._streams

    def _warm_up(self, *args):
        """The first batch, eagerly on the stream(s) that will capture."""
        if self._reps is not None:
            streams = self._side_streams()
            mains = [torch.cuda.current_stream(d) for d in self._reps.devices]
            for s, main in zip(streams, mains):
                s.wait_stream(main)
            with contextlib.ExitStack() as stack:
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                self._eager(*args)
            for s, main in zip(streams, mains):
                main.wait_stream(s)
            return
        s = self._side_stream()
        main = torch.cuda.current_stream(self._ex._device)
        s.wait_stream(main)
        with torch.cuda.stream(s):
            self._eager(*args)
        main.wait_stream(s)

    def _replay(self, items, structure, hyper, feed):
        tensors = _written_all(self._item_lists(items))
        if structure != self._structure or feed is not self._captured_feed \
                or len(tensors) != len(self._captured) or any(
                    a is not b for a, b in zip(tensors, self._captured)):
            self._graph = self._capture(items, structure, hyper, feed)
            self._structure = structure
            self._captured = tensors
            self._captured_feed = feed
            self._held = [(t, t.data_ptr()) for t in tensors]
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise MXNetError("fused train step: CUDA graph replay failed: %s"
                             % e) from e
        self.dispatches += 1
        _tel.inc("step.dispatches")

    def _capture(self, *args):
        """Record the step function as a CUDA graph (it does not run:
        the caller replays it for this batch)."""
        if self._eager_mem is not None \
                and _env.get("MXNET_TPU_XPROF_PREFLIGHT"):
            # the capture's private pool takes the step's transient bytes
            # again, beside what stays allocated
            live, peak = self._eager_mem
            _xprof.preflight_check(2 * peak - live, device=self._ex._device,
                                   what="the fused step's capture")
        # the kernels' wrappers apply the autotuner's launch parameters as
        # the capture records them (looked up once a signature, the same
        # ones the eager step and the classic loop took); this records the
        # consultation, once a process, and a replay looks up nothing
        _autotune.note_build("fused_step")
        t0 = time.perf_counter()
        if self._reps is not None:
            graph = CardGraph(self._reps, self._side_streams())
            # each replica draws from its own executor's generator, which
            # the graph registers under that replica's card
            execs = self._module._exec_group.execs
            gens = ([ex._generator() for ex in execs]
                    if self._ex.draws_random() else None)
            try:
                with _san.intentional_transfer():
                    graph.capture(lambda: self._step_fn(*args),
                                  generators=gens)
            except RuntimeError as e:
                raise MXNetError("fused train step: CUDA graph capture over "
                                 "%d cards failed: %s" % (self._reps.n, e)) \
                    from e
            return self._captured_graph(graph, t0)
        graph = torch.cuda.CUDAGraph()
        if self._ex.draws_random():
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise MXNetError(
                    "fused train step: the graph draws random numbers "
                    "(Dropout) and this PyTorch (%s) cannot register the "
                    "executor's generator with a CUDA graph, so every "
                    "replay would reuse one mask" % torch.__version__)
            register(self._ex._generator())
        # thread_local: a staging thread's copies and event queries on its
        # own stream (io_pipeline.FeedScheduler) may run during the
        # capture; they touch no tensor the graph reads
        # a dead fit's CUDA graph that the cycle collector freed during
        # the capture would end it (cudaGraphExecDestroy is refused while
        # a stream captures), and torch.cuda.graph collects on entry no
        # longer: collect now
        gc.collect()
        try:
            # entering a capture synchronises the card once, a reviewed
            # sync under the transfer sanitizer; inside, CUDA itself
            # refuses any
            with _san.intentional_transfer(), \
                    torch.cuda.graph(graph, stream=self._side_stream(),
                                     capture_error_mode="thread_local"):
                self._body(*args)
        except RuntimeError as e:
            raise MXNetError("fused train step: CUDA graph capture failed: "
                             "%s" % e) from e
        return self._captured_graph(graph, t0)

    def _captured_graph(self, graph, t0):
        self.captures += 1
        _tel.inc("step.fused_recompiles")
        self._record_capture(time.perf_counter() - t0)
        return graph

    def _record_capture(self, seconds):
        """A capture into the compile registry, where it is on: its wall
        time, the bound arguments' and aux states' signature by name, the
        eager step's FLOPs and peak allocation."""
        if not _xprof.enabled():
            return
        ex = self._ex
        _xprof.record_compile(
            "fused_step", seconds,
            signature=_xprof.leaf_signature(
                [[a.handle for a in ex.arg_arrays],
                 [a.handle for a in ex.aux_arrays]],
                [ex.arg_names, ex.aux_names]),
            flops=sum((self.step_flops or {}).values()) or None,
            peak_bytes=self._eager_mem[1] if self._eager_mem else None)


def _written(items):
    """Every weight, gradient and optimizer-state tensor of ``items``
    (``FusedTrainStep._params``), in order."""
    return [t for _, w, g, s in items for t in (w, g) + s]


def _written_all(item_lists):
    """:func:`_written` of every replica's items, in order."""
    return [t for items in item_lists for t in _written(items)]


def _flat_copy(buf, tensors):
    """``tensors`` end to end into the flat float32 ``buf`` (allocated on
    first use, the same storage from then on) by one batched copy."""
    flat = [t.reshape(-1) for t in tensors]
    if buf is None:
        buf = torch.empty(sum(t.numel() for t in flat), dtype=torch.float32,
                          device=flat[0].device)
    torch.cat(flat, out=buf)
    return buf


def _views(buf, tensors):
    """Views of the flat ``buf`` shaped as ``tensors``."""
    return [v.view_as(t) for v, t in
            zip(buf.split([t.numel() for t in tensors]), tensors)]


def _refuse_host_callbacks(what, symbol):
    """Raise naming the graph's Custom nodes: their operators run on the
    host between launches, which a fused step cannot hold (the JAX
    package runs the callback inside ``jit``)."""
    from .operator import custom_nodes

    names = custom_nodes(symbol)
    if names:
        raise MXNetError("%s: Custom node(s) %s run their operator on the "
                         "host, which a CUDA graph cannot hold; train them "
                         "through the classic loop" % (what, names))


def make_fused_infer(executor, data_names, top_k=0, mesh=None):
    """A :class:`FusedInfer` over a bound executor (an ``Executor``, or a
    group's ``ReplicatedExecutor`` over several contexts). ``data_names``
    are the per-batch argument slots; every other argument is packed.
    ``top_k=0`` returns the raw outputs only, ``1`` adds the argmax over
    the last axis of the first output, ``>1`` its top-k values and
    indices. ``mesh`` (a ``ContextMesh`` over the executor's contexts, in
    their order) splits each batch's rows over its data axes; on a
    ``(dp, tp)`` grid each card also keeps only its shard of every param
    that ``tp_param_spec`` splits and computes its share of the split
    products (:mod:`mxnet_tpu_torch.parallel.tp_infer`). A graph with a
    Custom node raises, naming it; a sample op draws from the executor's
    generator."""
    execs = getattr(executor, "execs", None) or [executor]
    _refuse_host_callbacks("fused inference step", execs[0]._symbol)
    return FusedInfer(executor, data_names, top_k=top_k, mesh=mesh)


def _labels(ex):
    """The label arguments of executor ``ex``: packed with the params but
    not params (never split, not counted as a param's bytes): its label
    names, and any argument named ``*label``."""
    return set(ex._label_names) | {n for n in ex.arg_names
                                   if n.endswith("label")}


class _Placed(list):
    """A batch placed over the cards of a grid: one list of data tensors
    a card, and ``sig``, the batch's whole shapes and dtypes."""

    sig = ()


class FusedInfer:
    """One call per batch. ``dispatches`` counts calls; ``compiles`` is
    the number of distinct (mesh factoring, batch shapes) seen (PyTorch
    compiles nothing; the count mirrors the JAX package's, whose
    executable cache it bounds, and under the serving ladder it stays at
    most the number of buckets). The forward runs the executor's graph
    function, so a ``compute_dtype`` bind serves in that dtype with
    float32 outputs.

    Over several contexts, or with a ``mesh``, the step serves on a grid
    of the executor's contexts: card ``k`` gets its batch shard's rows
    (:func:`~mxnet_tpu_torch.parallel.sharding.batch_shard_index`; every
    card of a tp line the same rows), the replicas run in lock-step as
    ``ReplicatedExecutor.forward`` runs them, and the outputs of one card
    a batch shard are joined along the batch axis on the first card,
    where the argmax or top-k runs. The params pack is one list a card
    (``_param_vals[k]``): the whole of every param, or on a tp grid the
    card's shard of each split one. Auxiliary states stay whole on every
    card, as the reference replicates them.

    The serving surface of ``mxnet_tpu/fused_step.py:693-1029``:
    :attr:`idempotent`, :attr:`mesh_key`, :meth:`factoring_key`,
    :meth:`stale_for`, :meth:`place_batch` and :meth:`refresh_params`'
    delta refresh."""

    #: a call reads the packed params and writes nothing they hold, so
    #: serving a retried request twice is harmless: the scheduler's
    #: request-id dedup of completed requests keys off this
    idempotent = True

    def __init__(self, executor, data_names, top_k=0, mesh=None):
        self._ex = executor
        execs = getattr(executor, "execs", None)
        self._execs = list(execs) if execs is not None else [executor]
        ex0 = self._execs[0]
        arg_pos = {n: i for i, n in enumerate(ex0.arg_names)}
        missing = [n for n in data_names if n not in arg_pos]
        if missing:
            raise MXNetError("fused_infer data args %s not in the "
                             "executor's arguments" % (missing,))
        self._data_names = list(data_names)
        self._d_idx = [arg_pos[n] for n in data_names]
        self._p_idx = [i for i in range(len(ex0.arg_names))
                       if i not in set(self._d_idx)]
        self._top_k = int(top_k)
        self._device = ex0._device
        self._mesh = mesh
        self._grid = None
        if execs is not None or mesh is not None:
            self._grid = _Grid(executor, self._execs, mesh, self._p_idx,
                               self._data_names)
        self._seen_sigs = set()
        self.dispatches = 0
        self._param_vals = None
        self._aux_vals = None
        # per-param sha256 of the resident pack (checkpoint.param_digest,
        # as a snapshot's manifest records it); None: unknown provenance,
        # so the next delta refresh moves every param and seeds them
        self._digests = None
        self.last_refresh_bytes = 0
        self.last_refresh_ms = 0.0
        self.last_refresh_changed = 0
        self.last_refresh_skipped = 0
        self.refresh_params()

    @property
    def compiles(self) -> int:
        return len(self._seen_sigs)

    @property
    def mesh_key(self):
        """The factoring this step serves on (``(("dp", 2), ("tp",
        2))``), None off a mesh: a re-bind across factorings misses it."""
        return self.factoring_key(self._mesh)

    @staticmethod
    def factoring_key(mesh):
        """The :attr:`mesh_key` of a step built over ``mesh``."""
        if mesh is None:
            return None
        from .parallel.sharding import mesh_axis_sizes

        return tuple(mesh_axis_sizes(mesh).items())

    @property
    def tp_gathers(self) -> int:
        """Transient whole params gathered by the split forward so far."""
        plan = None if self._grid is None else self._grid.plan
        return 0 if plan is None else plan.gathers

    def stale_for(self, executor, mesh=None) -> bool:
        """True when ``executor`` is not the one this step packs and runs
        (the module was bound again), or ``mesh`` factors the contexts
        otherwise: serve through a new step."""
        return (executor is not self._ex
                or self.factoring_key(mesh) != self.mesh_key)

    def param_bytes(self, k: int = 0) -> int:
        """Bytes of the packed params resident on card ``k`` (labels
        excepted): a tp grid's shards, else whole params."""
        ex0 = self._execs[0]
        labels = _labels(ex0)
        vals = self._param_vals if self._grid is None \
            else self._param_vals[k]
        return sum(v.numel() * v.element_size()
                   for v, i in zip(vals, self._p_idx)
                   if ex0.arg_names[i] not in labels)

    def refresh_params(self, host_params=None, digests=None):
        """Repack the non-data arguments and auxiliary states.

        * With no arguments (after ``module.set_params``): a copy of every
          argument and aux array on the device (on a tp grid each card's
          shard of a split param), so later writes to the executor's
          arrays reach serving only through this call (as with the JAX
          package). The resident digests become unknown.
        * With ``host_params`` (name -> host array) and optionally
          ``digests`` (name -> sha256, a snapshot's ``param_digests``;
          hashed here where missing): the delta refresh. Only params
          whose digest differs from the resident pack's are copied, in
          place, into the packed tensors (each card's shard of a split
          one) and through to the executors' arrays; names that are not
          packed params are ignored.

        ``last_refresh_bytes`` (host bytes of the whole params moved) /
        ``_changed`` / ``_skipped`` / ``_ms`` describe the call;
        telemetry ``infer.refresh_bytes``, ``infer.refresh_changed``,
        ``infer.refresh_skipped`` and ``infer.refresh_ms``."""
        from .checkpoint import param_digest

        t0 = time.perf_counter()
        moved = changed = skipped = 0
        grid = self._grid
        if host_params is None:
            if grid is None:
                ex = self._ex
                self._param_vals = [ex.arg_arrays[i].handle.detach().clone()
                                    for i in self._p_idx]
                self._aux_vals = [a.handle.detach().clone()
                                  for a in ex.aux_arrays]
                moved = sum(v.numel() * v.element_size()
                            for v in self._param_vals)
            else:
                self._param_vals, self._aux_vals, moved = grid.pack()
            changed = len(self._p_idx)
            self._digests = None
        else:
            ex0 = self._execs[0]
            pos_of = {ex0.arg_names[i]: pos
                      for pos, i in enumerate(self._p_idx)}
            known = self._digests
            new_digests = dict(known or {})
            for name, host in host_params.items():
                pos = pos_of.get(name)
                if pos is None:
                    continue
                digest = (digests or {}).get(name) or param_digest(host)
                if known is not None and known.get(name) == digest:
                    skipped += 1
                    continue
                host = np.ascontiguousarray(np.asarray(host))
                i = self._p_idx[pos]
                whole = tuple(ex0.arg_arrays[i].shape)
                if tuple(host.shape) != whole:
                    raise MXNetError("refresh_params: '%s' is %s, the "
                                     "served param %s" % (
                                         name, host.shape, whole))
                if grid is None:
                    dst = self._param_vals[pos]
                    src = torch.from_numpy(host).to(dst.device, dst.dtype)
                    dst.copy_(src)
                    self._ex.arg_arrays[i].handle.copy_(src)
                else:
                    grid.write(self._param_vals, pos, name, host)
                new_digests[name] = digest
                changed += 1
                moved += int(host.nbytes)
            self._digests = new_digests
        self.last_refresh_bytes = moved
        self.last_refresh_changed = changed
        self.last_refresh_skipped = skipped
        self.last_refresh_ms = (time.perf_counter() - t0) * 1e3
        _tel.inc("infer.refresh_bytes", moved)
        _tel.inc("infer.refresh_changed", changed)
        _tel.inc("infer.refresh_skipped", skipped)
        _tel.observe("infer.refresh_ms", self.last_refresh_ms)

    def place_batch(self, arrays):
        """Host arrays (or tensors) of one batch -> tensors on the device;
        on a grid, each card's rows on that card (a batch placed already
        passes through)."""
        if self._grid is not None:
            return self._grid.place(arrays)
        placed = []
        for a in arrays:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            placed.append(a.to(self._device))
        return placed

    def __call__(self, arrays):
        """One batch -> ``(outputs, post)``: ``post`` is ``()`` for
        top_k=0, ``(argmax,)`` for top_k=1, ``(values, indices)``
        otherwise. Results stay on the (first) card."""
        d_vals = self.place_batch(arrays)
        sig = d_vals.sig if self._grid is not None else tuple(
            (tuple(v.shape), str(v.dtype)) for v in d_vals)
        key = (self.mesh_key, sig)
        if key not in self._seen_sigs:
            self._seen_sigs.add(key)
            _tel.inc("infer.recompiles")
        self.dispatches += 1
        _tel.inc("infer.dispatches")
        if self._grid is not None:
            outs = self._grid.run(self._param_vals, d_vals, self._aux_vals)
        else:
            full = [None] * len(self._ex.arg_names)
            for pos, i in enumerate(self._p_idx):
                full[i] = self._param_vals[pos]
            for pos, i in enumerate(self._d_idx):
                full[i] = d_vals[pos]
            outs = self._ex.run(full, self._aux_vals, is_train=False)
        post = ()
        head = outs[0] if outs else None
        if self._top_k and head is not None and head.dim() >= 2 \
                and head.is_floating_point():
            with torch.inference_mode():
                if self._top_k == 1:
                    post = (torch.argmax(head, dim=-1),)
                else:
                    post = tuple(torch.topk(head, self._top_k, dim=-1))
        return tuple(outs), post


def _batch_spanning_nodes(symbol, layouts):
    """The nodes whose cross-card form combines rows of the whole batch
    in a forward: a reduction over the batch's axis (by its input's
    layout; one whose layout is not known counts), softmax_cross_entropy
    and ROIPooling."""
    from .batch_layout import batch_axis
    from .ops.tensor import _ReduceOp
    from .ops.vision import ROIPooling, SoftmaxCrossEntropy

    out = []
    for node in symbol._topo():
        op = None if node.is_variable else node.op
        if isinstance(op, (ROIPooling, SoftmaxCrossEntropy)):
            out.append(node.name)
        elif isinstance(op, _ReduceOp):
            src, i = node.inputs[0]
            lay = None if layouts is None else layouts.get((src.uid, i))
            if lay is None or batch_axis(lay, op.op_name) in op._axes(
                    len(lay)):
                out.append(node.name)
    return out


class _Grid:
    """:class:`FusedInfer` over the cards of a grid: the mesh, the replica
    set, the split forward's plan on a tp grid, and each card's rows."""

    def __init__(self, executor, execs, mesh, p_idx, data_names):
        from .executor import _cast_graph, make_graph_eval
        from .parallel.sharding import (ContextMesh, batch_shard_extent,
                                        batch_shard_index)
        from .replicas import Replicas

        ex0 = execs[0]
        if any(ex._group2ctx for ex in execs):
            raise MXNetError("fused inference over a grid: group2ctx "
                             "placement runs a replica's graph across "
                             "contexts; bind placed graphs without a mesh")
        ctxs = [ex._ctx for ex in execs]
        if mesh is None:
            mesh = ContextMesh({"dp": len(execs)}, ctxs)
        if list(mesh.devices.flat) != ctxs:
            raise MXNetError("fused inference: the mesh's contexts %s are "
                             "not the executor's %s, in order"
                             % ([str(c) for c in mesh.devices.flat],
                                [str(c) for c in ctxs]))
        self.ex, self.execs, self.mesh = executor, execs, mesh
        self.reps = getattr(executor, "replicas", None) \
            or Replicas([ex0._device])
        self.p_idx = p_idx
        self.d_idx = [ex0.arg_names.index(n) for n in data_names]
        self.data_names = data_names
        self.extent = batch_shard_extent(mesh)
        self.tp = int(mesh.shape.get("tp", 1))
        axes = getattr(executor, "inputs", {})
        self.axes = [axes.get(n, 0) for n in data_names]
        self.index = [batch_shard_index(mesh, k) for k in range(mesh.size)]
        #: one card a batch shard, in shard order: the outputs joined
        self.heads = [self.index.index(b) for b in range(self.extent)]
        self.plan = None
        node_apply = None
        layouts = getattr(executor, "layouts", None)
        if self.tp > 1:
            from .parallel.tp_infer import TensorParallel

            spans = _batch_spanning_nodes(ex0._symbol, layouts)
            if spans:
                raise MXNetError(
                    "fused inference over a (dp %d, tp %d) grid: %s combine "
                    "rows of the whole batch, and their cross-card form "
                    "runs over every card of the grid, the copies of a "
                    "batch shard on its tp line too; serve them at tp 1"
                    % (self.extent, self.tp, ", ".join(spans)))

            labels = _labels(ex0)
            shapes = {ex0.arg_names[i]: tuple(ex0.arg_arrays[i].shape)
                      for i in p_idx if ex0.arg_names[i] not in labels}
            self.plan = TensorParallel(ex0._symbol, mesh, self.reps, shapes)
            node_apply = self.plan.apply
        eval_graph, _ = make_graph_eval(ex0._symbol, replicas=self.reps,
                                        node_apply=node_apply,
                                        layouts=layouts)
        if ex0.compute_dtype is not None:
            eval_graph = _cast_graph(eval_graph, ex0.arg_names,
                                     set(ex0._label_names),
                                     ex0.compute_dtype, self.reps)
        self.eval_graph = eval_graph

    def _whole(self, k, i):
        """Argument ``i``'s whole value on card ``k``: the executor's
        array (a fsdp-sharded param joined from its master shards)."""
        name = self.execs[0].arg_names[i]
        shards = getattr(self.ex, "shards", None)
        if shards is not None and name in shards.index:
            return shards.gather_value(name).to(self.execs[k]._device)
        return self.execs[k].arg_arrays[i].handle

    def _local(self, k, name, value):
        """Card ``k``'s part of param ``name``'s whole ``value``."""
        if self.plan is None or self.plan.split_dim(name) is None:
            return value
        from .parallel.sharding import tp_shard

        return tp_shard(value, self.mesh, k)

    def pack(self):
        """``(params a card, aux a card, whole bytes)`` copied from the
        executors' arrays."""
        names = self.execs[0].arg_names
        params, aux = [], []
        for k, ex in enumerate(self.execs):
            with self.reps.device(k):
                params.append([self._local(k, names[i], self._whole(k, i))
                               .detach().clone() for i in self.p_idx])
                aux.append([a.handle.detach().clone()
                            for a in ex.aux_arrays])
        arrays = self.execs[0].arg_arrays
        moved = sum(arrays[i].handle.numel() * arrays[i].handle.element_size()
                    for i in self.p_idx)
        return params, aux, moved

    def write(self, params, pos, name, host):
        """The delta refresh of packed param ``pos`` (``name``) from its
        whole host value: each card's part into its pack, in place, and
        the whole value through to each executor's array."""
        i = self.p_idx[pos]
        shards = getattr(self.ex, "shards", None)
        whole = torch.from_numpy(host)
        for k, ex in enumerate(self.execs):
            dst = params[k][pos]
            part = np.ascontiguousarray(self._local(k, name, host))
            with self.reps.device(k):
                dst.copy_(torch.from_numpy(part).to(dst.device, dst.dtype))
                if shards is not None and name in shards.index:
                    view = shards.weight(name, k).handle
                    view.copy_(whole[shards.rows(name, k)].to(
                        view.device, view.dtype))
                else:
                    arr = ex.arg_arrays[i].handle
                    arr.copy_(whole.to(arr.device, arr.dtype))

    def place(self, arrays):
        """Each card's rows of the batch on that card."""
        if isinstance(arrays, _Placed):
            return arrays
        whole = [a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a))
                 for a in arrays]
        placed = _Placed()
        placed.sig = tuple((tuple(v.shape), str(v.dtype)) for v in whole)
        for k, ex in enumerate(self.execs):
            row = []
            for v, axis, name in zip(whole, self.axes, self.data_names):
                n = v.shape[axis]
                if n % self.extent:
                    raise MXNetError(
                        "fused inference: '%s' has %d rows, not a multiple "
                        "of the mesh's %d batch shards (serve through the "
                        "bucket ladder)" % (name, n, self.extent))
                rows = n // self.extent
                part = v.narrow(axis, self.index[k] * rows, rows)
                with self.reps.device(k):
                    row.append(part.to(ex._device))
            placed.append(row)
        return placed

    def run(self, params, placed, aux):
        """The lock-step forward over the cards; the outputs of one card
        a batch shard joined along their batch axis on the first card."""
        execs = self.execs
        n_args = len(execs[0].arg_names)
        full = []
        for k in range(len(execs)):
            f = [None] * n_args
            for pos, i in enumerate(self.p_idx):
                f[i] = params[k][pos]
            for pos, i in enumerate(self.d_idx):
                f[i] = placed[k][pos]
            full.append(f)
        rngs = [ex._generator() if ex._draws else None for ex in execs]
        with torch.inference_mode():
            outs, _ = self.eval_graph(full, aux, rngs, False)
            if len(self.heads) == 1:
                return list(outs[self.heads[0]])
            dev0 = execs[0]._device
            return [self.ex.join_output(i, [outs[k][i] for k in self.heads],
                                        dev0)
                    for i in range(len(execs[0].output_names))]
