"""Executor group, counterpart of ``mxnet_tpu/module/executor_group.py``.

The data and label arrays are the per-batch slots; every other argument
is a parameter whose array the group owns. Parameter and batch writes
copy into the bound arrays in place (a batch through a pinned buffer on
a card, so that a CUDA graph over the bound arrays sees each batch).
Bound for training, each parameter (and, with ``inputs_need_grad``,
each data input) gets a gradient array that ``backward`` fills by
``grad_req``; labels and ``fixed_param_names`` get none.

One context binds one executor over the whole batch. Bound with a
``shared_group``, the group takes that group's arrays (parameters,
gradients, aux states and inputs) wherever the shapes agree: the same
tensors, as the bucketing module's buckets share one set of weights.

Several contexts (ROADMAP.md Queue A item 10a) bind one executor a
context, each on an equal slice of the batch along every array's batch
axis (the batch must divide by the number of contexts, as the JAX
package requires), each with its own copy of every parameter, gradient
and aux state, so that the tensors a CUDA graph captured stay fixed.
They run as one :class:`~mxnet_tpu_torch.executor.ReplicatedExecutor`:
a lock-step forward whose BatchNorm statistics and normalized losses
are those of the global batch, and a backward after which every
replica holds the gradients of the global batch. ``executor`` is the
first replica's, from which ``get_params`` reads; ``set_params`` writes
every replica. Outputs come back joined along each output's batch
axis on the first context's device, as the JAX package's global arrays
read; the metric scores each replica against its slice of the labels.
``work_load_list`` is accepted and, as in the JAX package, ignored: the
slices are equal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import env as _env
from ..base import MXNetError
from ..context import Context
from ..executor import _UNSET, Executor, ReplicatedExecutor
from ..io import DataDesc
from ..metric import check_label_shapes
from ..ndarray import HostToDevice, NDArray, zeros

__all__ = ["DataParallelExecutorGroup", "check_contexts"]


def check_contexts(contexts) -> List[torch.device]:
    """The torch devices of a context list, which must be all CPU or all
    GPU contexts, each named once; a card that is not there raises
    :class:`~mxnet_tpu_torch.base.DeviceUnavailableError`."""
    contexts = list(contexts)
    if not contexts:
        raise MXNetError("no context given")
    kinds = {c.device_type for c in contexts}
    if len(kinds) > 1:
        raise MXNetError("contexts %s mix CPU and GPU devices; a group runs "
                         "on one kind" % contexts)
    if len(set(contexts)) != len(contexts):
        raise MXNetError("contexts %s name a device twice; each replica "
                         "needs its own" % contexts)
    return [c.torch_device() for c in contexts]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: Sequence[Context], data_shapes,
                 label_shapes, param_names: List[str], for_training: bool,
                 inputs_need_grad: bool = False, grad_req: str = "write",
                 fixed_param_names=(), shared_group=None,
                 compute_dtype=_UNSET, workload=None):
        self.contexts = list(contexts)
        devices = check_contexts(self.contexts)
        self.symbol = symbol
        self.context = self.contexts[0]
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.workload = workload
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[
            DataDesc.get_batch_axis(self.data_shapes[0].layout)]

        reqs = {}
        for name in self.arg_names:
            if name in self.data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            elif name in self.label_names or not for_training \
                    or name in fixed_param_names:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req
        self.grad_req = reqs
        self._loaders = None
        #: the replica set and its executor (several contexts), else None
        self.replicas = None
        self.replicated = None
        if len(self.contexts) > 1:
            self._bind_replicas(devices, shared_group, compute_dtype)
            return

        shapes = {d.name: d.shape for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        ctx = self.context
        shared_args, shared_grads, shared_aux = {}, {}, {}
        if shared_group is not None:
            if shared_group.context != ctx:
                raise MXNetError("shared module on %s, this one on %s"
                                 % (shared_group.context, ctx))
            ex = shared_group.executor
            shared_args, shared_grads = ex.arg_dict, ex.grad_dict
            shared_aux = ex.aux_dict
        inputs = set(self.data_names) | set(self.label_names)
        args, grads = [], {}
        for name, shape in zip(self.arg_names, arg_shapes):
            shared = shared_args.get(name)
            if shared is not None and shared.shape == tuple(shape):
                args.append(shared)
            elif shared is not None and name not in inputs:
                raise MXNetError(
                    "shared param '%s' changes shape across buckets (%s "
                    "vs %s); every bucket's symbol must give a param the "
                    "same shape" % (name, shared.shape, tuple(shape)))
            else:
                args.append(zeros(shape, ctx=ctx))
            if reqs[name] != "null":
                g = shared_grads.get(name)
                grads[name] = (g if g is not None
                               and g.shape == tuple(shape)
                               else zeros(shape, ctx=ctx))
        aux = [shared_aux[n] if n in shared_aux
               and shared_aux[n].shape == tuple(s) else zeros(s, ctx=ctx)
               for n, s in zip(self.aux_names, aux_shapes)]
        self.executor = Executor(symbol, ctx, args, grads, reqs, aux,
                                 label_names=self.label_names,
                                 compute_dtype=compute_dtype)
        self.execs = [self.executor]

    # -- several contexts -----------------------------------------------------
    def _bind_replicas(self, devices, shared_group, compute_dtype):
        from ..replicas import Replicas

        n = len(self.contexts)
        if self.batch_size % n:
            raise MXNetError("batch size %d not divisible by %d devices"
                             % (self.batch_size, n))
        fsdp = _env.get("MXNET_TPU_MESH_FSDP")
        if fsdp > 1:
            raise MXNetError(
                "MXNET_TPU_MESH_FSDP=%d over %d contexts: sharded params "
                "(the fsdp axis) are ROADMAP.md Queue A item 10c; the port "
                "replicates them" % (fsdp, n))
        if shared_group is not None:
            raise MXNetError("a module bound over several contexts shares "
                             "no arrays with another (shared_module); bind "
                             "the buckets on one context")
        _refuse_batch_coupled(self.symbol)
        shapes = {}
        for d in self.data_shapes + self.label_shapes:
            shape = list(d.shape)
            shape[self._batch_axis_of(d.name)] //= n
            shapes[d.name] = tuple(shape)
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        exchange = [name for name in self.param_names
                    if self.grad_req.get(name, "null") != "null"]
        shape_of = dict(zip(self.arg_names, arg_shapes))
        self.execs, flats = [], []
        for ctx in self.contexts:
            args = [zeros(s, ctx=ctx) for s in arg_shapes]
            grads, flat = _flat_grads(exchange, shape_of, ctx)
            for name in self.data_names:
                if self.grad_req[name] != "null":
                    grads[name] = zeros(shape_of[name], ctx=ctx)
            aux = [zeros(s, ctx=ctx) for s in aux_shapes]
            self.execs.append(Executor(
                self.symbol, ctx, args, grads, self.grad_req, aux,
                label_names=self.label_names, compute_dtype=compute_dtype))
            flats.append(flat)
        self.executor = self.execs[0]
        self.replicas = Replicas(devices)
        inputs = {d.name: self._batch_axis_of(d.name)
                  for d in self.data_shapes + self.label_shapes}
        self.replicated = ReplicatedExecutor(self.execs, self.replicas,
                                             exchange, flats, inputs)

    def _batch_axis_of(self, name: str) -> int:
        for d in self.data_shapes + self.label_shapes:
            if d.name == name:
                return DataDesc.get_batch_axis(d.layout)
        return 0

    def param_sharding(self, name: str):
        """None: every parameter is replicated (fsdp is item 10c)."""
        return None

    def place_param(self, name: str, np_or_nd, dtype=None) -> List[NDArray]:
        """A parameter (or a state of its shape) on every context: one
        NDArray a context, in context order."""
        if isinstance(np_or_nd, NDArray):
            src = np_or_nd.handle
        else:
            src = torch.from_numpy(np.ascontiguousarray(
                np.asarray(np_or_nd, dtype=dtype)))
        return [NDArray(src.to(ctx.torch_device(), copy=True), ctx)
                for ctx in self.contexts]

    def place_like_param(self, name: Optional[str], np_or_nd,
                         dtype=None) -> List[NDArray]:
        """As :meth:`place_param`: a replicated group places every state,
        whatever its shape, on every context."""
        return self.place_param(name, np_or_nd, dtype=dtype)

    # -- params -----------------------------------------------------------------
    def set_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """Every replica's arrays, in place."""
        for ex in self.execs:
            for name, arr in arg_params.items():
                if name in ex.arg_dict:
                    ex.arg_dict[name][:] = arr
            for name, arr in (aux_params or {}).items():
                if name in ex.aux_dict:
                    ex.aux_dict[name][:] = arr

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """From the first replica (the replicas are equal)."""
        for name in self.param_names:
            if name in self.executor.arg_dict:
                arg_params[name][:] = self.executor.arg_dict[name]
        for name, arr in zip(self.aux_names, self.executor.aux_arrays):
            if name in aux_params:
                aux_params[name][:] = arr

    def install_monitor(self, mon):
        mon.install(self.replicated or self.executor)

    # -- batches ----------------------------------------------------------------
    def load_data_batch(self, data_batch):
        """Copy a batch's data and labels (NDArrays, tensors or host
        arrays) into the bound arrays, in place, each replica its slice
        along the array's batch axis: host arrays through a pinned buffer
        a replica, on that card's stream; arrays already on a card (a
        staged batch) device to device. A device-feed batch (``aug``:
        uint8 frames whose crop and normalisation are deferred) is
        materialised first on this group's first device, through the
        same ``crop_norm`` kernel the fused step runs in its graph."""
        if getattr(data_batch, "aug", None) is not None:
            from ..io_cache import materialize_device_feed

            data_batch = materialize_device_feed(data_batch, self.context)
        self._load(self.data_shapes, data_batch.data, 0)
        self.load_label_batch(data_batch)

    def load_label_batch(self, data_batch):
        """Copy only the batch's labels into the bound label arrays: the
        fused step's device feed writes the data array itself."""
        self._load(self.label_shapes, data_batch.label or [],
                   len(self.data_shapes))

    def _load(self, descs, arrays, first):
        if self._loaders is None:
            self._loaders = [[HostToDevice(ex.arg_dict[d.name].handle)
                              for ex in self.execs]
                             for d in self.data_shapes + self.label_shapes]
        n = len(self.execs)
        for desc, loaders, arr in zip(descs, self._loaders[first:], arrays):
            axis = self._batch_axis_of(desc.name)
            want = list(loaders[0].dst.shape)
            want[axis] *= n
            if tuple(arr.shape) != tuple(want):
                raise MXNetError("batch '%s' has shape %s, bound for %s"
                                 % (desc.name, tuple(arr.shape),
                                    tuple(want)))
            if n == 1:
                loaders[0].copy(arr)
                continue
            src = arr.handle if isinstance(arr, NDArray) else arr
            rows = want[axis] // n
            for k, loader in enumerate(loaders):
                part = _take(src, axis, k * rows, rows)
                with self.replicas.device(k):
                    loader.copy(part)

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        (self.replicated or self.executor).forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("executor group bound for inference only")
        (self.replicated or self.executor).backward(out_grads)

    def get_outputs(self, merge_multi_context=True) -> List:
        """The outputs over the whole batch (on the first context), or,
        with ``merge_multi_context=False``, a list of the replicas' slices
        an output."""
        if self.replicated is None:
            return self.executor.outputs
        if merge_multi_context:
            return self.replicated.outputs
        per = [ex.outputs for ex in self.execs]
        return [[o[i] for o in per] for i in range(len(per[0]))]

    def get_input_grads(self, merge_multi_context=True) -> List:
        if not self.inputs_need_grad:
            raise MXNetError("bound with inputs_need_grad=False")
        if self.replicated is None:
            return [self.executor.grad_dict[n] for n in self.data_names]
        per = [[ex.grad_dict[n] for ex in self.execs]
               for n in self.data_names]
        if not merge_multi_context:
            return per
        return [self.replicated.merge([g.handle for g in grads],
                                      self._batch_axis_of(n))
                for n, grads in zip(self.data_names, per)]

    def update_metric(self, eval_metric, labels):
        """The metric over the global batch. Over several contexts each
        replica's outputs are scored against its own slice of the labels
        (each label's slice along its batch axis, on the replica's
        device), as the replicas were fed: a metric with a device fold
        folds each replica into its own accumulator, any other updates
        once a replica."""
        if self.replicated is None:
            eval_metric.update(labels, self.get_outputs())
            return
        n = len(self.execs)
        for k, ex in enumerate(self.execs):
            labs = []
            for desc, lab in zip(self.label_shapes, labels):
                src = lab.handle if isinstance(lab, NDArray) else lab
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.ascontiguousarray(src))
                axis = self._batch_axis_of(desc.name)
                rows = src.shape[axis] // n
                labs.append(src.narrow(axis, k * rows, rows).to(ex._device))
            preds = ex.outputs
            if eval_metric.has_device_fold:
                check_label_shapes(labs, preds)
                eval_metric.device_fold(labs, [p.handle for p in preds], k)
            else:
                eval_metric.update([NDArray(t, self.contexts[k])
                                    for t in labs], preds)


def _take(src, axis, start, rows):
    """Rows ``start:start + rows`` of ``src`` (numpy or a tensor) along
    ``axis``."""
    index = [slice(None)] * len(src.shape)
    index[axis] = slice(start, start + rows)
    return src[tuple(index)]


def _flat_grads(names, shape_of, ctx):
    """Gradient arrays for ``names``, views of one flat float32 buffer on
    ``ctx`` (in order): ``({name: NDArray}, [flat])``."""
    dev = ctx.torch_device()
    sizes = [int(np.prod(shape_of[n])) for n in names]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    grads = {n: NDArray(v.view(shape_of[n]), ctx)
             for n, v in zip(names, flat.split(sizes))}
    return grads, [flat]


def _refuse_batch_coupled(symbol):
    """Raise naming the nodes whose op reduces over, or indexes across,
    the batch in a way the replicas cannot combine (``couples_batch``):
    each replica would compute its own slice's value."""
    coupled = ["%s (%s)" % (n.name, n.op.op_name) for n in symbol._topo()
               if not n.is_variable and n.op.couples_batch()]
    if coupled:
        raise MXNetError(
            "node(s) %s reduce over or index across the batch, which a "
            "group bound over several contexts splits; bind them on one "
            "context (the cross-card forms of BatchNorm and SoftmaxOutput "
            "are the ported ones)" % coupled)
