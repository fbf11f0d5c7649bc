"""The legacy data-parallel executor manager, counterpart of
``mxnet_tpu/executor_manager.py``, kept for old training scripts. It
drives one :class:`~mxnet_tpu_torch.module.executor_group.
DataParallelExecutorGroup` over the whole batch.

It takes one context, or several CPU contexts: every ``cpu(i)`` is
torch's one CPU device, so they bind one executor over the full batch,
whose summed gradients equal the per-device ones added. Several GPUs
raise: one process over several cards is ROADMAP Queue A item 10.
"""
from __future__ import annotations

from typing import List

from .base import MXNetError

__all__ = ["_split_input_slice", "DataParallelExecutorManager"]


def _split_input_slice(batch_size: int, work_load_list: List[float]):
    """Split ``batch_size`` into slices proportional to
    ``work_load_list``."""
    total = sum(work_load_list)
    if total <= 0:
        raise MXNetError("invalid work_load_list")
    parts = [int(round(batch_size * w / total)) for w in work_load_list]
    parts[-1] += batch_size - sum(parts)     # the rounding drift
    slices = []
    begin = 0
    for p in parts:
        end = min(begin + p, batch_size)
        if begin >= end:
            raise MXNetError("too many slices; batch size too small")
        slices.append(slice(begin, end))
        begin = end
    return slices


def _one_device(ctx) -> list:
    """The contexts a group binds: ``ctx`` itself, or the first of
    several CPU contexts (one torch device)."""
    ctx = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if len(ctx) > 1:
        if any(c.device_type != "cpu" for c in ctx):
            raise MXNetError("DataParallelExecutorManager over %s: several "
                             "GPUs in one process wait for ROADMAP Queue A "
                             "item 10; pass one context" % ctx)
        return ctx[:1]
    return ctx


class DataParallelExecutorManager:
    """Binds ``symbol`` for training over ``train_data``'s shapes and
    exposes the arrays as lists of one-device lists, as the JAX package's
    manager does."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        from .module.executor_group import DataParallelExecutorGroup

        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, list) else [ctx]
        self.arg_names = arg_names or symbol.list_arguments()
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        data_names = [d.name for d in train_data.provide_data]
        label_names = [d.name for d in train_data.provide_label]
        self.param_names = param_names or [
            n for n in self.arg_names if n not in data_names + label_names]
        self.execgrp = DataParallelExecutorGroup(
            symbol, _one_device(self.ctx), train_data.provide_data,
            train_data.provide_label, self.param_names, for_training=True,
            inputs_need_grad=False)

    @property
    def param_arrays(self):
        ex = self.execgrp.executor
        return [[ex.arg_dict[n]] for n in self.param_names
                if n in ex.arg_dict]

    @property
    def grad_arrays(self):
        ex = self.execgrp.executor
        return [[ex.grad_dict[n]] for n in self.param_names
                if n in ex.grad_dict]

    @property
    def aux_arrays(self):
        return [[a] for a in self.execgrp.executor.aux_arrays]

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self.execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.execgrp.executor.forward(is_train=is_train)

    def backward(self):
        self.execgrp.executor.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)

    @property
    def curr_execgrp(self):
        """The group serving the current batch (there is one)."""
        return self.execgrp

    def get_outputs(self):
        """The outputs of the last forward, over the whole batch."""
        return self.execgrp.get_outputs()
