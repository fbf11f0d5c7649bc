"""Monitor: per-op output and parameter statistics during training,
counterpart of ``mxnet_tpu/monitor.py``.

A facade over the numerics plane: a monitor with the default statistic
(``norm(x)/sqrt(x.size)``) is *pack-expressible*, so under the fused
train step it rides the stats pack (:mod:`mxnet_tpu_torch.numwatch`)
and :meth:`Monitor.toc` serves the ``(step, name, value)`` rows from one
small fetch of the pack: the weights' rows are of the weights before the
step's update, the gradients' rows of that step's gradients. A monitor
with a custom ``stat_func`` works through the executor's callback on
each internal output of the classic loop's forward, then reads every
argument and gradient at ``toc``; the fused step refuses it, naming the
reason.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x: NDArray) -> NDArray:
    t = x.handle.float()
    return NDArray((t.norm() / (t.numel() ** 0.5)).reshape(1), x.context)


class Monitor:
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.pack_expressible = stat_func is None
        self.stat_func = stat_func or _default_stat
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self._plane = None   # the NumWatch that serves the rows, if routed

    def attach_plane(self, plane):
        """Serve tic/toc from ``plane``'s stats pack (the fused step's
        routing calls this)."""
        self._plane = plane

    def stat_helper(self, name: str, arr: NDArray):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        if not self.activated:
            return []
        self.activated = False
        if self._plane is not None:
            res = self._plane.monitor_rows(self.re_prog, self.step)
            if self.sort:
                res.sort(key=lambda x: x[1])
            self.queue = []
            return res
        for exe in self.exes:
            for name, arr in zip(exe.arg_names, exe.arg_arrays):
                self.queue.append((self.step, name, self.stat_func(arr)))
            for name, arr in zip(exe.arg_names, exe.grad_arrays):
                if arr is not None:
                    self.queue.append((self.step, name + "_grad",
                                       self.stat_func(arr)))
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        res = []
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            res.append((n, k, ",".join("%f" % v.asnumpy().ravel()[0]
                                       for v in v_list)))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
