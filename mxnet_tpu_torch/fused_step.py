"""Fused steps, counterparts of ``mxnet_tpu/fused_step.py``: the train
step (single device) and the inference step (the mesh and
tensor-parallel parts wait for the distribution slice).

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

The graph reads and writes fixed addresses: the bound weights and
gradients, the aux states, the optimizer states, the metric's device
accumulator, the numerics pack with the pre-step copies, and the
executor's generator. A checkpoint restore
(:mod:`mxnet_tpu_torch.checkpoint`) therefore copies into those tensors
and never replaces one, so the next replay runs on the restored values.
The step captures again when the update's structure changes or when a
weight, gradient or state tensor it captured is no longer the one the
module holds, never replaying a graph over storage the module let go.

A :class:`FusedInfer` packs the bound executor's non-data arguments and
auxiliary states onto the device once, then serves each batch with one
call: place the batch on the device, run the forward and the argmax or
top-k under ``torch.inference_mode()``, and hand back device tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import env as _env
from . import numwatch as _numwatch
from . import telemetry as _tel
from .base import MXNetError
from .kvstore import _LOCAL
from .metric import CompositeEvalMetric
from .ndarray import NDArray
from .optimizer import _state_tensors

__all__ = ["make_fused_step", "FusedTrainStep", "make_fused_infer",
           "FusedInfer"]


def make_fused_step(module, eval_metric, monitor=None):
    """A :class:`FusedTrainStep` over a Module bound for training with
    its params and optimizer initialised. A configuration the step cannot
    run raises :class:`MXNetError` naming the reason (the JAX package
    warns and falls back to the classic loop; the port has no fallback):
    a kvstore other than ``local``, ``inputs_need_grad``, a monitor with
    a custom ``stat_func`` (``monitor``, or one installed on the
    executor), a grad_req other than ``"write"``, or an optimizer without
    a fusable update (``Optimizer._fusable``: SGLD, Test, a subclass that
    overrides ``update`` or ``update_multi``) or with
    ``MXNET_TPU_FUSED_UPDATE=0``. A default-stat monitor rides the
    numerics pack."""
    if not (module.binded and module.for_training
            and module.params_initialized and module.optimizer_initialized):
        raise MXNetError("fused train step: the module must be bound for "
                         "training with its params and optimizer "
                         "initialised")
    kv = module._kvstore
    if kv is not None and kv.type not in _LOCAL:
        raise MXNetError("fused train step: kvstore %r moves gradients "
                         "between dispatches; use 'local' or None" % kv.type)
    if module.inputs_need_grad:
        raise MXNetError("fused train step: inputs_need_grad=True needs "
                         "input gradients that the step does not keep")
    ex = module._exec_group.executor
    if monitor is None and ex._monitor_callback is not None:
        cb = ex._monitor_callback
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
    each capture (StepTrace labels the capturing step ``recompile``)."""

    def __init__(self, module, eval_metric, monitor=None):
        self._module = module
        self._optimizer = module._optimizer
        self._updater = module._updater
        group = module._exec_group
        self._ex = group.executor
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
        self._w_old = None      # pre-update weights, flat (numerics plane)
        self._s_old = None      # pre-step optimizer states, flat (skip guard)
        self._acc_old = None    # pre-step metric sums (skip guard)
        self._stream = None
        self._outs = None
        self._graph = None
        self._structure = None
        self._captured = []
        self.eager_steps = 0
        self.captures = 0
        self.dispatches = 0

    def _params(self):
        """(updater index, weight, grad, state tensors) of every
        parameter with a gradient, in the updater's order, and the same
        items as NDArrays (the state as the updater keeps it)."""
        ex, arrays = self._ex, []
        for i, name in enumerate(self._module._param_names):
            if name in ex.grad_dict:
                w = ex.arg_dict[name]
                arrays.append((i, w, ex.grad_dict[name],
                               self._updater._state(i, w)))
        return [(i, w.handle, g.handle, _state_tensors(s))
                for i, w, g, s in arrays], arrays

    def _body(self, items, structure, hyper):
        """The step function: everything between the batch's copy in and
        the host's next look, with no host sync."""
        ex = self._ex
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

    def _keep_pre_step(self, ws, ss):
        """Copy the weights (and, under the skip guard, every optimizer
        state tensor and the metric's device sums) into step-owned
        tensors before the update: the weights and the states each into
        one flat float32 buffer by one batched copy. Returns the live
        tensors the skip guard restores and their copies."""
        self._w_old = _flat_copy(self._w_old, ws)
        live, kept = list(ws), _views(self._w_old, ws)
        if not self._numwatch.skip_guard:
            return live, kept
        states = [t for s in ss for t in s]
        if states:
            self._s_old = _flat_copy(self._s_old, states)
            live += states
            kept += _views(self._s_old, states)
        if self._fold is not None:
            leaves = (self._fold.metrics
                      if isinstance(self._fold, CompositeEvalMetric)
                      else [self._fold])
            accs = [leaf.accumulator(ws[0].device) for leaf in leaves]
            if self._acc_old is None:
                self._acc_old = [torch.empty_like(a) for a in accs]
            for dst, a in zip(self._acc_old, accs):
                dst.copy_(a)
            live += accs
            kept += self._acc_old
        return live, kept

    def step(self, data_batch, eval_metric):
        """One training batch; ``eval_metric`` is updated on the host
        when the metric the step was built with does not fold."""
        group = self._module._exec_group
        ex = self._ex
        if group.executor is not ex:
            raise MXNetError("fused train step: the module was bound again "
                             "after the step was built; build a new step")
        group.load_data_batch(data_batch)
        items, arrays = self._params()
        opt = self._optimizer
        structure = opt.structure([i for i, _, _, _ in items])
        rows = opt.plan(arrays, structure)
        hyper = opt.scalars(ex._device, rows.shape).copy(rows)
        if ex._device.type != "cuda":
            self._body(items, structure, hyper)
            self.eager_steps += 1
        elif self.eager_steps == 0:
            self._warm_up(items, structure, hyper)
        else:
            self._replay(items, structure, hyper)
        ex._outputs = [NDArray(t, ex._ctx) for t in self._outs]
        if self._numwatch is not None:
            self._numwatch.stepped()
        if self._fold is None:
            eval_metric.update(data_batch.label, ex._outputs)

    # -- the card ----------------------------------------------------------
    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._ex._device)
        return self._stream

    def _warm_up(self, *args):
        """The first batch, eagerly on the stream that will capture."""
        s = self._side_stream()
        main = torch.cuda.current_stream(self._ex._device)
        s.wait_stream(main)
        with torch.cuda.stream(s):
            self._body(*args)
        main.wait_stream(s)
        self.eager_steps += 1

    def _replay(self, items, structure, hyper):
        tensors = [t for _, w, g, s in items for t in (w, g) + s]
        if structure != self._structure or len(tensors) != len(
                self._captured) or any(a is not b for a, b in
                                       zip(tensors, self._captured)):
            self._graph = self._capture(items, structure, hyper)
            self._structure = structure
            self._captured = tensors
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
        try:
            with torch.cuda.graph(graph, stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                self._body(*args)
        except RuntimeError as e:
            raise MXNetError("fused train step: CUDA graph capture failed: "
                             "%s" % e) from e
        self.captures += 1
        _tel.inc("step.fused_recompiles")
        return graph


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


def make_fused_infer(executor, data_names, top_k=0):
    """A :class:`FusedInfer` over a bound executor. ``data_names`` are
    the per-batch argument slots; every other argument is packed.
    ``top_k=0`` returns the raw outputs only, ``1`` adds the argmax over
    the last axis of the first output, ``>1`` its top-k values and
    indices."""
    return FusedInfer(executor, data_names, top_k=top_k)


class FusedInfer:
    """One call per batch. ``dispatches`` counts calls; ``compiles`` is
    the number of distinct batch shapes seen (PyTorch compiles nothing;
    the count mirrors the JAX package's, whose executable cache it
    bounds, and under the serving ladder it stays at most the number of
    buckets)."""

    def __init__(self, executor, data_names, top_k=0):
        self._ex = executor
        arg_pos = {n: i for i, n in enumerate(executor.arg_names)}
        missing = [n for n in data_names if n not in arg_pos]
        if missing:
            raise MXNetError("fused_infer data args %s not in the "
                             "executor's arguments" % (missing,))
        self._data_names = list(data_names)
        self._d_idx = [arg_pos[n] for n in data_names]
        self._p_idx = [i for i in range(len(executor.arg_names))
                       if i not in set(self._d_idx)]
        self._top_k = int(top_k)
        self._device = executor._device
        self._seen_sigs = set()
        self.dispatches = 0
        self.refresh_params()

    @property
    def compiles(self) -> int:
        return len(self._seen_sigs)

    def refresh_params(self):
        """(Re)pack the non-data arguments and auxiliary states: a copy
        on the device, so later writes to the executor's arrays reach
        serving only through this call (as with the JAX package)."""
        ex = self._ex
        self._param_vals = [ex.arg_arrays[i].handle.detach().clone()
                            for i in self._p_idx]
        self._aux_vals = [a.handle.detach().clone() for a in ex.aux_arrays]

    def place_batch(self, arrays):
        """Host arrays (or tensors) of one batch -> tensors on the
        device."""
        placed = []
        for a in arrays:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            placed.append(a.to(self._device))
        return placed

    def __call__(self, arrays):
        """One batch -> ``(outputs, post)``: ``post`` is ``()`` for
        top_k=0, ``(argmax,)`` for top_k=1, ``(values, indices)``
        otherwise. Results stay on the device."""
        d_vals = self.place_batch(arrays)
        self._seen_sigs.add(tuple((tuple(v.shape), str(v.dtype))
                                  for v in d_vals))
        self.dispatches += 1
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
