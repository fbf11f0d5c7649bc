"""Training callbacks, counterpart of ``Speedometer`` and
``log_train_metric`` in ``mxnet_tpu/callback.py``. A batch-end callback
receives a ``BatchEndParam(epoch, nbatch, eval_metric, locals)``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "log_train_metric"]


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
