"""BaseModule: the high-level predict interface, counterpart of
``mxnet_tpu/module/base_module.py`` (inference half; ``fit`` and the
optimizer come with the training slice)."""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd
from ..io import NDArrayIter

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self._symbol = None

    # -- interface ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # -- derived -----------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Forward every batch of ``eval_data`` (an iterator of
        DataBatch, or host arrays batched at the bound batch size) and
        return the outputs with the padded rows sliced off."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("module must be binded and initialized")
        if isinstance(eval_data, (np.ndarray, nd.NDArray)):
            eval_data = NDArrayIter(eval_data,
                                    batch_size=self._data_shapes[0].shape[0])
        if reset and hasattr(eval_data, "reset"):
            eval_data.reset()
        output_list = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outputs = [out[0:out.shape[0] - batch.pad]
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged
