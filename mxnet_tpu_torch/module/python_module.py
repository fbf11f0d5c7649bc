"""PythonModule and PythonLossModule, counterparts of
``mxnet_tpu/module/python_module.py``: modules whose computation is
Python code, for losses and glue inside a SequentialModule."""
from __future__ import annotations

import logging

from ..base import MXNetError
from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module without parameters; subclasses give
    ``_compute_output_shapes``, ``forward``, ``backward``,
    ``get_outputs`` and ``get_input_grads``."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            raise NotImplementedError

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss: forward keeps the scores (and, training, the labels);
    backward is ``grad_func(scores, labels)``, an NDArray or host data
    put on the scores' device."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if len(data_names) != 1 or len(label_names) != 1:
            raise MXNetError("PythonLossModule supports single data/label")
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        shape = self._data_shapes[0]
        shape = shape.shape if hasattr(shape, "shape") else shape[1]
        return [(self._name + "_output", shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("PythonLossModule ignores out_grads")
        if self._grad_func is None:
            raise NotImplementedError
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
