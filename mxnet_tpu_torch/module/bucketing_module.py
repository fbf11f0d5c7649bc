"""BucketingModule, counterpart of
``mxnet_tpu/module/bucketing_module.py``: variable-length training with
one Module a bucket, every bucket bound with the default bucket's module
as its ``shared_module``, so all of them train one set of parameter
tensors through the default bucket's optimizer and updater.

The JAX package has no fused step for it (its ``_fused_train_step`` is
the base module's, which gives None), so here ``fit(fused_step=True)``
raises, as for any module without a fused step; ``fit`` runs the classic
loop, switching bucket at each batch's ``bucket_key``.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """``sym_gen(bucket_key)`` gives a symbol, or ``(symbol, data_names,
    label_names)``; ``default_bucket_key`` is the bucket bound first,
    whose module owns the parameters (bind it at the largest shapes)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        sym, _, _ = self._call_sym_gen(self._default_bucket_key)
        return sym.list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def get_symbol(self):
        return self.symbol

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if isinstance(res, tuple):
            return res
        return res, ("data",), ("softmax_label",)

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._buckets = {}
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule unsupported")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it (once) with
        the default bucket's module as its ``shared_module``."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        self._buckets[self._default_bucket_key].init_params(
            initializer, arg_params, aux_params, allow_missing, force_init)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        self._buckets[self._default_bucket_key].init_optimizer(
            kvstore, optimizer, optimizer_params, force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if data_batch.bucket_key is not None:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        """The current bucket's gradients through the default bucket's
        optimizer and updater (one set of states for every bucket)."""
        default = self._buckets[self._default_bucket_key]
        cur = self._curr_module
        if cur is not default:
            cur._optimizer = default._optimizer
            cur._updater = default._updater
            cur._updaters = default._updaters
            cur._kvstore = default._kvstore
            cur.optimizer_initialized = True
        cur.update()

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def install_monitor(self, mon):
        for module in self._buckets.values():
            module.install_monitor(mon)
