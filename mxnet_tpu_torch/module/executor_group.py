"""Executor group, counterpart of ``mxnet_tpu/module/executor_group.py``.

One executor on one device. The data and label arrays are the
per-batch slots; every other argument is a parameter whose array the
group owns. Parameter and batch writes copy into the bound arrays in
place (a batch through a pinned buffer on a card, so that a CUDA graph
over the bound arrays sees each batch). Bound for training, each
parameter (and, with ``inputs_need_grad``, each data input) gets a
gradient array that ``backward`` fills by ``grad_req``; labels and
``fixed_param_names`` get none. Bound with a ``shared_group``, the
group takes that group's arrays (parameters, gradients, aux states and
inputs) wherever the shapes agree: the same tensors, as the bucketing
module's buckets share one set of weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..base import MXNetError
from ..context import Context
from ..executor import _UNSET, Executor
from ..io import DataDesc
from ..ndarray import HostToDevice, NDArray, zeros

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: Sequence[Context], data_shapes,
                 label_shapes, param_names: List[str], for_training: bool,
                 inputs_need_grad: bool = False, grad_req: str = "write",
                 fixed_param_names=(), shared_group=None,
                 compute_dtype=_UNSET):
        if len(contexts) != 1:
            raise MXNetError("the port binds one device; got %s"
                             % list(contexts))
        self.symbol = symbol
        self.context = contexts[0]
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
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
        self._loaders = None

    def set_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        for name, arr in arg_params.items():
            if name in self.executor.arg_dict:
                self.executor.arg_dict[name][:] = arr
        for name, arr in (aux_params or {}).items():
            if name in self.executor.aux_dict:
                self.executor.aux_dict[name][:] = arr

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        for name in self.param_names:
            if name in self.executor.arg_dict:
                arg_params[name][:] = self.executor.arg_dict[name]
        for name, arr in zip(self.aux_names, self.executor.aux_arrays):
            if name in aux_params:
                aux_params[name][:] = arr

    def install_monitor(self, mon):
        mon.install(self.executor)

    def load_data_batch(self, data_batch):
        """Copy a batch's data and labels (NDArrays, tensors or host
        arrays) into the bound arrays, in place: host arrays through a
        pinned buffer, arrays already on the card (a staged batch) device
        to device on the current stream. A device-feed batch (``aug``:
        uint8 frames whose crop and normalisation are deferred) is
        materialised first on this group's device, through the same
        ``crop_norm`` kernel the fused step runs in its graph."""
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
            self._loaders = [HostToDevice(self.executor.arg_dict[d.name]
                                          .handle)
                             for d in self.data_shapes + self.label_shapes]
        for desc, loader, arr in zip(descs, self._loaders[first:], arrays):
            if tuple(arr.shape) != tuple(loader.dst.shape):
                raise MXNetError("batch '%s' has shape %s, bound for %s"
                                 % (desc.name, tuple(arr.shape),
                                    tuple(loader.dst.shape)))
            loader.copy(arr)

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.executor.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("executor group bound for inference only")
        self.executor.backward(out_grads)

    def get_outputs(self) -> List[NDArray]:
        return self.executor.outputs

    def get_input_grads(self) -> List[NDArray]:
        if not self.inputs_need_grad:
            raise MXNetError("bound with inputs_need_grad=False")
        return [self.executor.grad_dict[n] for n in self.data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
