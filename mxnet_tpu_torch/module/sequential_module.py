"""SequentialModule, counterpart of
``mxnet_tpu/module/sequential_module.py``: modules chained head to
tail, each module's outputs the next one's data, gradients passed back
through ``get_input_grads``."""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """``add(module, take_labels=True)`` gives a module the batch's
    labels (a loss); ``auto_wiring=True`` renames the incoming data to
    the module's own data names."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs) -> "SequentialModule":
        self._modules.append(module)
        for key in kwargs:
            if key not in self._meta_keys:
                raise MXNetError("unknown meta '%s'" % key)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module unsupported for SequentialModule")
        if not self._modules:
            raise MXNetError("add modules before bind")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas,
                                                     self._modules)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            my_label_shapes = label_shapes if meta_take_labels else None
            if meta_take_labels:
                anybody_ever_needs_label = True
            # every module after the first passes gradients back
            my_inputs_need_grad = for_training and (inputs_need_grad
                                                    or i_layer > 0)
            if meta.get(self.META_AUTO_WIRING, False):
                my_data_shapes = [
                    DataDesc(name, d.shape if isinstance(d, DataDesc)
                             else d[1])
                    for name, d in zip(module.data_names, my_data_shapes)]
            module.bind(my_data_shapes, my_label_shapes, for_training,
                        my_inputs_need_grad, force_rebind, None, grad_req)
            my_data_shapes = [DataDesc(name, shape)
                              for name, shape in module.output_shapes]
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        for module in self._modules:
            module.init_params(initializer, arg_params, aux_params,
                               allow_missing, force_init)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module in self._modules:
            module.init_optimizer(kvstore, optimizer, optimizer_params,
                                  force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, (meta, module) in enumerate(zip(self._metas, self._modules)):
            module.forward(batch, is_train)
            if i == len(self._modules) - 1:
                break
            out = module.get_outputs()
            batch = DataBatch(out, data_batch.label, data_batch.pad,
                              data_batch.index,
                              provide_data=[DataDesc(n, s) for n, s
                                            in module.output_shapes],
                              provide_label=data_batch.provide_label)

    def backward(self, out_grads=None):
        for i_layer in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i_layer]
            module.backward(out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def update_metric(self, eval_metric, labels):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs()

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads()

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
