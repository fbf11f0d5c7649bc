"""Training callbacks, counterpart of ``mxnet_tpu/callback.py``. A
batch-end callback receives a
``BatchEndParam(epoch, nbatch, eval_metric, locals)``; an epoch-end
callback ``(epoch, symbol, arg_params, aux_params)``."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "log_train_metric", "module_checkpoint"]


def do_checkpoint(prefix: str, period: int = 1,
                  save_optimizer_states: bool = False, mod=None):
    """An epoch-end callback that saves the params every ``period``
    epochs (``prefix-symbol.json``, ``prefix-NNNN.params``). With
    ``save_optimizer_states`` it also writes ``prefix-NNNN.states``
    through ``mod``, the module that owns the optimizer (the callback's
    arguments do not carry it)."""
    from .model import save_checkpoint

    period = int(max(1, period))
    if save_optimizer_states and mod is None:
        raise ValueError("do_checkpoint(save_optimizer_states=True) needs "
                         "mod= (the bound module that owns the optimizer "
                         "states)")

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            if save_optimizer_states:
                mod.save_checkpoint(prefix, iter_no + 1,
                                    save_optimizer_states=True)
            else:
                save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix: str, period: int = 1,
                      save_optimizer_states: bool = False):
    """An epoch-end callback: ``mod.save_checkpoint`` every ``period``
    epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period: int, auto_reset: bool = False):
    """Log the training metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/s (and the metric) every ``frequent`` batches, and the
    partial window still open when the epoch ends (``epoch_end``, which
    the fit loop calls after its last batch)."""

    def __init__(self, batch_size: int, frequent: int = 50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self._tic_count = 0

    def _emit(self, epoch, count, n_batches, elapsed, eval_metric,
              tail=False):
        speed = n_batches * self.batch_size / max(elapsed, 1e-9)
        where = "Batch [%d]%s" % (count, " tail(%d)" % n_batches
                                  if tail else "")
        if eval_metric is not None:
            msg = "Epoch[%d] %s\tSpeed: %.2f samples/sec" % (epoch, where,
                                                            speed)
            for name, value in eval_metric.get_name_value():
                msg += "\t%s=%f" % (name, value)
            logging.info(msg)
        else:
            logging.info("Iter[%d] %s\tSpeed: %.2f samples/sec",
                         epoch, where, speed)

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0 and count > self._tic_count:
                self._emit(param.epoch, count, count - self._tic_count,
                           time.time() - self.tic, param.eval_metric)
                self.tic = time.time()
                self._tic_count = count
        else:
            self.init = True
            self.tic = time.time()
            self._tic_count = count

    def epoch_end(self, param):
        if not self.init:
            return
        tail = self.last_count - self._tic_count
        if tail > 0:
            self._emit(param.epoch, param.nbatch, tail,
                       time.time() - self.tic, param.eval_metric, tail=True)
        self.init = False


class ProgressBar:
    """A batch-end callback printing a progress bar of ``length``
    characters over ``total`` batches."""

    def __init__(self, total: int, length: int = 80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        filled_len = int(round(self.bar_len * param.nbatch
                               / float(self.total)))
        percents = math.ceil(100.0 * param.nbatch / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        print("[%s] %s%s\r" % (prog_bar, percents, "%"), end="")
