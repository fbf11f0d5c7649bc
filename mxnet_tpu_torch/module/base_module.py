"""BaseModule: the high-level train and predict interface, counterpart of
``mxnet_tpu/module/base_module.py``.

``fit`` is the JAX package's training loop: per batch either the
classic three phases (``forward_backward``, ``update``,
``update_metric``; ``base_module.py:317-421`` there) or, with
``fused_step=True`` (or ``MXNET_TPU_FUSED_STEP``), one
:class:`~mxnet_tpu_torch.fused_step.FusedTrainStep` (one CUDA graph
replay a batch on a card). The loop arms, from the environment, what the
JAX package's arms: the feed scheduler and device staging
(:mod:`mxnet_tpu_torch.io_pipeline`), the metrics server and flight
recorder (``tracing.maybe_init``), the checkpoint manager
(``MXNET_TPU_CKPT_DIR``: resume at entry, periodic snapshots and the
SIGTERM grace path around each batch) and the numerics plane riding the
fused step, with its rollback guard bound to that manager. With
telemetry on, each step is timed boundary to boundary into the step
trace with the plane's extras.
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import namedtuple

import numpy as np

from ..analysis import sanitizers as _san
from ..base import MXNetError
from .. import env as _env
from .. import metric as _metric
from .. import ndarray as nd
from .. import numwatch as _numwatch
from .. import telemetry as _tel
from .. import tracing as _tracing
from ..context import cpu
from ..initializer import Uniform
from ..io import DataBatch, NDArrayIter
from ..io_pipeline import (FeedScheduler, maybe_wrap_device_staging,
                           maybe_wrap_feed_scheduler)

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _asks_for_fused(kvstore) -> bool:
    """True for a store (or store name) whose gradient exchange is the
    one inside the fused step (``device_sync``)."""
    if isinstance(kvstore, str):
        return kvstore.lower() == "device_sync"
    return bool(getattr(kvstore, "in_jit_gradient_exchange", False))


def _as_list(obj):
    if obj is None:
        return []
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- interface ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    def get_symbol(self):
        return self._symbol

    def _fused_train_step(self, eval_metric, monitor=None):
        """The fused train step that ``fit(fused_step=True)`` runs; a
        module without one raises."""
        raise MXNetError("%s has no fused train step" % type(self).__name__)

    def install_monitor(self, mon):
        raise NotImplementedError

    # -- derived -----------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname: str):
        """The params as ``arg:``/``aux:`` entries of the named-array
        container, through a temporary file and a rename."""
        from ..checkpoint import atomic_ndarray_save

        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        atomic_ndarray_save(fname, save_dict)

    def load_params(self, fname: str):
        """Params saved by :meth:`save_params` (either package's)."""
        save_dict = nd.load(fname, ctx=cpu())
        if not isinstance(save_dict, dict):
            raise MXNetError("invalid param file %s: no names" % fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, _, name = k.partition(":")
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise MXNetError("invalid param file %s: key %r"
                                 % (fname, k))
        self.set_params(arg_params, aux_params)

    def _pad_partial_batch(self, eval_batch):
        """A batch with fewer rows than the bound batch size, padded with
        zero rows up to it and ``pad`` extended, so that the bound
        executor takes it and ``score``/``predict`` slice the filler back
        off (``mxnet_tpu/module/base_module.py:137-172``). Returns
        ``(batch, extra_rows)``: the batch itself and 0 when it is
        full."""
        shapes = getattr(self, "_data_shapes", None)
        if not shapes or not eval_batch.data:
            return eval_batch, 0
        bound = shapes[0].shape[0]
        rows = eval_batch.data[0].shape[0]
        if rows >= bound:
            return eval_batch, 0
        extra = bound - rows

        def _pad(arrs):
            out = []
            for a in arrs or []:
                h = a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
                out.append(nd.array(np.concatenate(
                    [h, np.zeros((extra,) + h.shape[1:], h.dtype)], axis=0),
                    ctx=cpu(), dtype=h.dtype))
            return out

        padded = DataBatch(_pad(eval_batch.data), _pad(eval_batch.label),
                           pad=eval_batch.pad + extra, index=eval_batch.index)
        return padded, extra

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Run inference over ``eval_data`` and return the metric's
        ``[(name, value)]``; a short last batch is padded to the bound
        batch size and the metric sees only its real rows."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("module must be binded and initialized")
        eval_metric = _metric.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            padded, extra = self._pad_partial_batch(eval_batch)
            self.forward(padded, is_train=False)
            if extra:
                outs = [out[0:out.shape[0] - extra]
                        for out in self.get_outputs()]
                eval_metric.update(eval_batch.label, outs)
            else:
                self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Forward every batch of ``eval_data`` (an iterator of
        DataBatch, or host arrays batched at the bound batch size) and
        return the outputs with the padded rows sliced off; a short last
        batch is padded to the bound batch size first."""
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
            padded, _ = self._pad_partial_batch(batch)
            self.forward(padded, is_train=False)
            outputs = [out[0:out.shape[0] - padded.pad]
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

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch of
        ``eval_data``, a short last batch padded as in :meth:`predict`
        and its filler sliced back off."""
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            padded, _ = self._pad_partial_batch(eval_batch)
            self.forward(padded, is_train=False)
            outputs = [out[0:out.shape[0] - padded.pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, fused_step=None):
        """Train: bind for training, init params and the optimizer, then
        per epoch run every batch through ``forward_backward``,
        ``update`` and ``update_metric`` (or, with ``fused_step``,
        through one fused train step, which raises naming the reason
        where the configuration cannot fuse), call the batch-end
        callbacks, log the metric, call the epoch-end callbacks with the
        params and score ``eval_data``. ``fused_step=None`` reads
        ``MXNET_TPU_FUSED_STEP``, and under a ``device_sync`` kvstore
        takes the fused step unless ``MXNET_TPU_DEVICE_SYNC_FUSED=0``;
        ``True`` or ``False`` wins over both.
        Under ``MXNET_TPU_CKPT_DIR`` the run resumes from the newest
        valid snapshot (mid-epoch: the metric and the iterator are not
        reset, and ``nbatch`` counts on from the snapshot's), saves
        snapshots on the cadence and on SIGTERM. Under the fused step,
        ``get_outputs()`` in a batch-end callback is overwritten by the
        next batch: copy what you keep. ``monitor`` is installed on the
        executor in the classic loop; under the fused step a default-stat
        Monitor rides the numerics pack and a custom ``stat_func``
        raises."""
        if num_epoch is None:
            raise MXNetError("num_epoch must be specified")
        if fused_step is None:
            # device_sync asks for the fused step: its gradient exchange
            # is the one inside the step
            fused_step = _env.get("MXNET_TPU_FUSED_STEP") or (
                _asks_for_fused(kvstore)
                and _env.get("MXNET_TPU_DEVICE_SYNC_FUSED"))
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None and not fused_step:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _metric.create(eval_metric)

        # MXNET_TPU_FEED_DEPTH / MXNET_TPU_DEVICE_STAGING: batches staged
        # onto the card ahead of the step that takes them
        group = getattr(self, "_exec_group", None)
        train_data = maybe_wrap_feed_scheduler(train_data, group=group)
        train_data = maybe_wrap_device_staging(train_data, group=group)
        _tracing.maybe_init()

        fused = (self._fused_train_step(eval_metric, monitor)
                 if fused_step else None)
        self._fused_step_active = fused is not None

        from ..checkpoint import maybe_manager
        ckpt = maybe_manager(self, eval_metric, train_data)
        resume = ckpt.maybe_restore() if ckpt is not None else None
        if ckpt is not None:
            ckpt.arm()
        # the numerics plane's rollback guard restores through the same
        # manager as the preemption path
        numwatch = getattr(fused, "_numwatch", None)
        if numwatch is not None and ckpt is not None:
            numwatch.bind_ckpt(ckpt)
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_batch_end_callback,
                             monitor, fused, ckpt, resume, begin_epoch,
                             num_epoch, numwatch)
        finally:
            if ckpt is not None:
                ckpt.disarm()
            if isinstance(train_data, FeedScheduler):
                train_data.stop()   # the worker, not the base iterator

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_batch_end_callback, monitor,
                    fused, ckpt, resume, begin_epoch, num_epoch,
                    numwatch=None):
        for epoch in range(begin_epoch, num_epoch):
            if resume is not None and epoch < resume["epoch"]:
                continue
            # resuming mid-epoch: the snapshot restored the metric and the
            # data cursor, which a reset would discard
            resuming = resume is not None and epoch == resume["epoch"]
            nbatch = resume["nbatch"] if resuming else -1
            resume = None
            tic = time.time()
            if not resuming:
                eval_metric.reset()
                train_data.reset()
            # a step is timed boundary to boundary, so the wait for its
            # batch counts in the step that waited
            t_last = time.perf_counter() if _tel.enabled() else 0.0
            # MXNET_TPU_SANITIZE=transfer (the fused loop on a card): a
            # synchronising CUDA call in the loop raises at the batch that
            # made it; the reviewed host reads open intentional_transfer
            guard = (_san.step_guard(fused._ex._device)
                     if fused is not None else contextlib.nullcontext())
            try:
                with guard:
                    for data_batch in train_data:
                        nbatch += 1
                        if monitor is not None:
                            monitor.tic()
                        if ckpt is not None:
                            # a SIGTERM from here to step_end waits for
                            # step_end
                            ckpt.step_begin()
                        if fused is not None:
                            fused.step(data_batch, eval_metric)
                        else:
                            self.forward_backward(data_batch)
                            self.update()
                            self.update_metric(eval_metric,
                                               data_batch.label)
                        if ckpt is not None:
                            ckpt.step_end(epoch, nbatch)
                        nw_extra = _numwatch.after_step(numwatch)
                        if monitor is not None:
                            monitor.toc_print()
                        if _tel.enabled():
                            now = time.perf_counter()
                            extra = {"epoch": epoch, "nbatch": nbatch}
                            if nw_extra:
                                extra.update(nw_extra)
                            _tracing.record_step((now - t_last) * 1e3,
                                                 extra=extra)
                            t_last = now
                        if batch_end_callback is not None:
                            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                                   eval_metric=eval_metric,
                                                   locals=locals())
                            for cb in _as_list(batch_end_callback):
                                cb(params)
            except RuntimeError as e:
                if _san.is_transfer_guard_error(e):
                    _san.record_trip("transfer")
                raise
            if batch_end_callback is not None and nbatch >= 0:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    ep_end = getattr(cb, "epoch_end", None)
                    if callable(ep_end):
                        ep_end(params)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
