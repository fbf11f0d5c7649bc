"""Executor group, counterpart of ``mxnet_tpu/module/executor_group.py``.

This slice binds one executor on one device, for inference. The data
and label arrays are the per-batch slots; every other argument is a
parameter whose array the group owns. Parameter and batch writes copy
into the bound arrays in place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..base import MXNetError, TrainingNotPortedError
from ..context import Context
from ..executor import Executor
from ..io import DataDesc
from ..ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: Sequence[Context], data_shapes,
                 label_shapes, param_names: List[str], for_training: bool):
        if for_training:
            raise TrainingNotPortedError(
                "bind(for_training=True) needs backward and the fused "
                "train step: the training slice, ROADMAP.md Queue A "
                "item 5. Bind with for_training=False to serve")
        if len(contexts) != 1:
            raise MXNetError("this slice binds one device; got %s"
                             % list(contexts))
        self.symbol = symbol
        self.context = contexts[0]
        self.param_names = param_names
        self.for_training = for_training
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

        shapes = {d.name: d.shape for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        ctx = self.context
        args = [zeros(s, ctx=ctx) for s in arg_shapes]
        aux = [zeros(s, ctx=ctx) for s in aux_shapes]
        self.executor = Executor(symbol, ctx, args, aux_states=aux)
        self.execs = [self.executor]

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

    def load_data_batch(self, data_batch):
        descs = self.data_shapes + self.label_shapes
        arrays = list(data_batch.data) + list(data_batch.label or [])
        for desc, arr in zip(descs, arrays):
            dst = self.executor.arg_dict[desc.name]
            if tuple(arr.shape) != dst.shape:
                raise MXNetError("batch '%s' has shape %s, bound for %s"
                                 % (desc.name, tuple(arr.shape), dst.shape))
            dst[:] = arr if isinstance(arr, NDArray) else np.asarray(arr)

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        self.executor.forward(is_train=bool(is_train))

    def get_outputs(self) -> List[NDArray]:
        return self.executor.outputs
