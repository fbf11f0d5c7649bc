"""The FeedForward estimator and checkpoint files, counterpart of
``mxnet_tpu/model.py``.

``save_checkpoint`` writes ``prefix-symbol.json`` and
``prefix-NNNN.params`` (the named-array container both packages read
and write), the params through ``checkpoint.atomic_ndarray_save``, so a
crash mid-save leaves the old file whole. ``FeedForward`` trains,
predicts and scores over the port's Module; its ``fit`` goes through
``Module.fit``, so ``fused_step`` (``None``: ``MXNET_TPU_FUSED_STEP``)
and the checkpoint manager (``MXNET_TPU_CKPT_DIR``) apply to it.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from .base import MXNetError
from .checkpoint import atomic_ndarray_save
from .context import Context, cpu, current_context
from .initializer import Uniform
from . import ndarray as nd
from . import symbol as sym_mod
from .io import DataIter, NDArrayIter

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict) -> None:
    """``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-NNNN.params`` with ``arg:``/``aux:`` keys."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    atomic_ndarray_save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)`` of a checkpoint either
    package wrote, the params on the CPU; a torn or foreign file raises
    :class:`MXNetError` naming it."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    save_dict = nd.load(param_name, ctx=cpu())
    if not isinstance(save_dict, dict):
        raise MXNetError("invalid checkpoint %s: no names" % param_name)
    arg_params, aux_params = {}, {}
    for k, value in save_dict.items():
        arg_type, _, name = k.partition(":")
        if arg_type == "arg":
            arg_params[name] = value
        elif arg_type == "aux":
            aux_params[name] = value
        else:
            raise MXNetError("invalid checkpoint %s: key %r" % (param_name, k))
    return symbol, arg_params, aux_params


class FeedForward:
    """Estimator over a symbol: ``fit`` on numpy arrays or a DataIter,
    ``predict``, ``score``, ``save``/``load`` and ``create``. Extra
    keyword arguments are the optimizer's; ``fused_step`` goes to
    ``Module.fit`` (``None`` reads ``MXNET_TPU_FUSED_STEP``)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, fused_step=None,
                 **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.fused_step = fused_step
        self._module = None

    def _init_iter(self, X, y, is_train: bool) -> DataIter:
        if isinstance(X, DataIter):
            return X
        if isinstance(X, nd.NDArray):
            X = X.asnumpy()
        if not isinstance(X, np.ndarray):
            raise TypeError("X must be DataIter, NDArray or numpy array")
        if y is None:
            if is_train:
                raise ValueError("y is required for training")
            y = np.zeros(X.shape[0], dtype=np.float32)
        if isinstance(y, nd.NDArray):
            y = y.asnumpy()
        y = np.asarray(y).ravel()
        batch_size = min(self.numpy_batch_size, X.shape[0])
        return NDArrayIter(X, y, batch_size=batch_size, shuffle=is_train,
                           last_batch_handle="discard" if is_train else "pad")

    def _make_module(self, data_iter: DataIter):
        from .module import Module

        label_names = [d.name for d in data_iter.provide_label]
        data_names = [d.name for d in data_iter.provide_data]
        if not label_names:
            label_names = [n for n in self.symbol.list_arguments()
                           if n.endswith("_label") and n not in data_names]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None):
        data = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not isinstance(eval_data, DataIter):
            if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
                eval_data = self._init_iter(eval_data[0], eval_data[1],
                                            False)
            else:
                raise TypeError("eval_data must be DataIter or (X, y)")
        mod = self._make_module(data)
        if logger is not None:
            mod.logger = logger
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, fused_step=self.fused_step)
        self.arg_params, self.aux_params = mod.get_params()
        self._module = mod
        return self

    def _bindable_labels(self, data_iter):
        args = set(self.symbol.list_arguments())
        return [d for d in data_iter.provide_label if d.name in args]

    def _bound(self, data):
        mod = self._make_module(data)
        mod.bind(data.provide_data, self._bindable_labels(data),
                 for_training=False)
        mod.init_params(arg_params=self.arg_params,
                        aux_params=self.aux_params,
                        initializer=self.initializer)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Outputs over ``X`` as numpy, the padded rows sliced off; with
        ``return_data`` also the data and labels they came from."""
        data = self._init_iter(X, None, is_train=False)
        outputs = self._bound(data).predict(data, num_batch=num_batch,
                                            always_output_list=True)
        outs = [o.asnumpy() for o in outputs]
        if return_data:
            data.reset()
            xs, ys = [], []
            for batch in data:
                keep = batch.data[0].shape[0] - batch.pad
                xs.append(batch.data[0].asnumpy()[:keep])
                ys.append(batch.label[0].asnumpy()[:keep])
            return outs, np.concatenate(xs), np.concatenate(ys)
        return outs[0] if len(outs) == 1 else outs

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over ``X`` (and ``y``)."""
        data = self._init_iter(X, y, is_train=False)
        res = self._bound(data).score(data, eval_metric, num_batch=num_batch,
                                      batch_end_callback=batch_end_callback)
        return res[0][1]

    def save(self, prefix: str, epoch: Optional[int] = None) -> None:
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise MXNetError("epoch unknown; pass explicitly")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix: str, epoch: int, ctx=None, **kwargs) -> "FeedForward":
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None,
               fused_step=None, **kwargs) -> "FeedForward":
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, fused_step=fused_step,
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
