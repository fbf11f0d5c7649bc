"""Profiling, counterpart of ``mxnet_tpu/profiler.py``: a device trace
through ``torch.profiler`` and per-step timing::

    mx.profiler.start("/tmp/prof")      # begin the trace
    ... training steps ...
    path = mx.profiler.stop()           # writes <logdir>/trace.json

    with mx.profiler.annotate("data-load"):   # a named range in it
        batch = next(it)

    timer = mx.profiler.StepTimer(sync_fn=torch.cuda.synchronize)
    for batch in it:
        with timer:
            step(...)
    print(timer.summary())

The trace is Chrome's trace event format (Perfetto and chrome://tracing
read it): the host's ops and ranges, and on a card every kernel and copy
with its device time.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import List, Optional

from .base import MXNetError

__all__ = ["start", "stop", "annotate", "StepTimer", "is_running",
           "keep_cupti"]

_active = None      # (logdir, torch.profiler.profile)


def keep_cupti():
    """Keep CUPTI, the card's tracing interface, set up from one
    ``torch.profiler`` session to the next in this process (unless the
    environment already says otherwise). Torn down after a session and
    set up again for the next while CUDA graphs exist (the fused step's),
    CUPTI can crash the process; PyTorch sets the same two variables
    itself, but only for its compiler's CUDA graphs
    (``torch/profiler/profiler.py``, ``TEARDOWN_CUPTI``). Call it before
    a session that may trace a card."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")


def start(logdir: str):
    """Begin a trace that :func:`stop` writes into ``logdir``: host
    activity, and the card's kernels where CUDA is available."""
    global _active
    if _active is not None:
        raise MXNetError("profiler already running (logdir=%s)"
                         % _active[0])
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        keep_cupti()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active = (logdir, prof)


def stop() -> str:
    """End the trace and write it as ``<logdir>/trace.json``; returns the
    path."""
    global _active
    if _active is None:
        raise MXNetError("profiler is not running")
    (logdir, prof), _active = _active, None   # never wedge on a failed write
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def is_running() -> bool:
    return _active is not None


@contextlib.contextmanager
def annotate(name: str):
    """A named range: a ``record_function`` range in a running trace and,
    on a card, an NVTX range; harmless outside a trace."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock per-step statistics; use as a context manager around
    each step. ``sync_fn`` runs before each step's clock stops: on a card
    pass ``torch.cuda.synchronize``, since a launch returns before the
    card finishes.

    With telemetry on, each step also feeds the ``profiler.step_ms``
    histogram, and with ``jsonl_path`` appends a record (the step's ms
    and the counter snapshot) there through ``telemetry.dump_jsonl``."""

    def __init__(self, sync_fn=None, jsonl_path: Optional[str] = None):
        self._times: List[float] = []
        self._t0 = 0.0
        self._sync_fn = sync_fn
        self._jsonl_path = jsonl_path

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_fn is not None:
            self._sync_fn()
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        from . import telemetry as _tel

        if _tel.enabled():
            _tel.inc("profiler.steps")
            _tel.observe("profiler.step_ms", dt * 1e3)
            if self._jsonl_path is not None:
                _tel.dump_jsonl(self._jsonl_path,
                                extra={"step_ms": dt * 1e3})
        return False

    @property
    def times(self) -> List[float]:
        return list(self._times)

    def reset(self):
        self._times.clear()

    @staticmethod
    def _nearest_rank(sorted_ts, q: float) -> float:
        """Nearest-rank percentile: the ceil(q*n)-th smallest sample."""
        n = len(sorted_ts)
        return sorted_ts[max(0, min(n - 1, math.ceil(q * n) - 1))]

    def summary(self, skip_first: int = 1) -> dict:
        """Stats without the first ``skip_first`` steps (the eager step
        and the capture); ``{"steps": 0}`` when nothing is left."""
        ts = sorted(self._times[max(0, int(skip_first)):])
        if not ts:
            return {"steps": 0}
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1e3,
            "p50_ms": self._nearest_rank(ts, 0.50) * 1e3,
            "p90_ms": self._nearest_rank(ts, 0.90) * 1e3,
            "p99_ms": self._nearest_rank(ts, 0.99) * 1e3,
            "max_ms": ts[-1] * 1e3,
        }
