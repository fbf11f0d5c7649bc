"""Learning-rate schedulers, counterpart of ``mxnet_tpu/lr_scheduler.py``:
the optimizer calls a scheduler with its update count and uses the
learning rate it returns."""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    def __init__(self, base_lr: float = 0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, never below
    ``stop_factor_lr``."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("lr hit stop_factor_lr %.2e", self.base_lr)
            else:
                logging.info("Update[%d]: lr now %.3e", num_update,
                             self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor once past each update count in ``step`` (an
    increasing list)."""

    def __init__(self, step, factor: float = 1.0):
        super().__init__()
        if not isinstance(step, (list, tuple)) or len(step) < 1:
            raise ValueError("step must be a non-empty list")
        for i, s in enumerate(step):
            if i and step[i] <= step[i - 1]:
                raise ValueError("step must be increasing")
            if s < 1:
                raise ValueError("steps must be >= 1")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while self.cur_step_ind < len(self.step) \
                and num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            logging.info("Update[%d]: lr now %.3e", num_update, self.base_lr)
        return self.base_lr
