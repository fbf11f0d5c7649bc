"""The legacy data-parallel executor manager, counterpart of
``mxnet_tpu/executor_manager.py``, kept for old training scripts. It
drives one :class:`~mxnet_tpu_torch.module.executor_group.
DataParallelExecutorGroup` over every context it is given: one replica
a context on an equal slice of the batch (several contexts are
ROADMAP.md Queue A item 10a), whose ``backward`` leaves every replica
the gradients of the whole batch. The arrays come as lists of per-
context lists; the outputs merged over the batch.
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


class DataParallelExecutorManager:
    """Binds ``symbol`` for training over ``train_data``'s shapes on
    every context and exposes the arrays as lists of per-context lists
    (one entry a context). ``work_load_list`` is accepted and, as in the
    JAX package, the slices are equal."""

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
            symbol, self.ctx, train_data.provide_data,
            train_data.provide_label, self.param_names, for_training=True,
            inputs_need_grad=False, workload=work_load_list)
        if self.execgrp.shards is not None:
            raise MXNetError(
                "DataParallelExecutorManager under MXNET_TPU_MESH_FSDP: the "
                "manager hands out every replica's full-width param arrays "
                "for the caller to update, which the fsdp recipe keeps as "
                "the walk's workspace (the card's shards are the params); "
                "train through Module, or unset MXNET_TPU_MESH_FSDP")

    @property
    def param_arrays(self):
        execs = self.execgrp.execs
        return [[ex.arg_dict[n] for ex in execs] for n in self.param_names
                if n in execs[0].arg_dict]

    @property
    def grad_arrays(self):
        execs = self.execgrp.execs
        return [[ex.grad_dict[n] for ex in execs] for n in self.param_names
                if n in execs[0].grad_dict]

    @property
    def aux_arrays(self):
        execs = self.execgrp.execs
        return [[ex.aux_arrays[i] for ex in execs]
                for i in range(len(execs[0].aux_arrays))]

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self.execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        group = self.execgrp
        (group.replicated or group.executor).forward(is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)

    @property
    def curr_execgrp(self):
        """The group serving the current batch (there is one)."""
        return self.execgrp

    def get_outputs(self):
        """The outputs of the last forward, over the whole batch."""
        return self.execgrp.get_outputs()
