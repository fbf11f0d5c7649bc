"""Module: the standard unit over one symbol, counterpart of
``mxnet_tpu/module/module.py`` (single device, inference)."""
from __future__ import annotations

import logging
from typing import Dict, Optional

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import Uniform
from ..io import DataDesc
from .. import ndarray as nd
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """``context`` defaults to the current context, ``gpu(0)`` unless a
    ``with mx.cpu():`` scope is open; a CUDA context without a card
    raises :class:`~mxnet_tpu_torch.base.DeviceUnavailableError` here."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        for ctx in context:
            ctx.torch_device()
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params: Optional[Dict[str, nd.NDArray]] = None
        self._aux_params: Optional[Dict[str, nd.NDArray]] = None
        self._exec_group: Optional[DataParallelExecutorGroup] = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind for inference (``for_training=False``). Training binds
        raise :class:`~mxnet_tpu_torch.base.TrainingNotPortedError`."""
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training)
        self.for_training = for_training
        self.binded = True
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the host copies (on the CPU) from ``arg_params`` /
        ``aux_params`` or the initializer, then copy them to the bound
        arrays."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        ex = self._exec_group.executor
        if self._arg_params is None:
            self._arg_params = {n: nd.zeros(ex.arg_dict[n].shape, ctx=cpu())
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: nd.zeros(ex.aux_dict[n].shape, ctx=cpu())
                                for n in self._aux_names}
        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif arg_params is not None and not allow_missing:
                raise MXNetError("missing arg_param '%s' (pass "
                                 "allow_missing=True to initialize it)"
                                 % name)
            elif initializer is not None:
                initializer(name, arr)
        for name, arr in self._aux_params.items():
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(name, arr)
        self.params_initialized = True
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def get_params(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        return self._arg_params, self._aux_params

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not self.binded or not self.params_initialized:
            raise MXNetError("module not initialized")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._exec_group.executor.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs()
