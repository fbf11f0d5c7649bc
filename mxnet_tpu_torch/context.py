"""Device context.

Counterpart of ``mxnet_tpu/context.py``. A ``Context`` names a device,
``cpu`` or ``gpu``, and resolves to a ``torch.device``. ``gpu(i)`` is
``torch.device("cuda", i)``. The default context is ``gpu(0)``: the
port runs on the card unless the caller asks for the CPU (``with
mx.cpu():``, or an explicit ``ctx=``/``context=``). A CUDA context on a
machine without a usable card raises :class:`DeviceUnavailableError`;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import threading

import torch

from .base import DeviceUnavailableError, MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """A device: ``device_type`` in {'cpu', 'gpu'} ('cuda' is an alias
    of 'gpu')."""

    _default_ctx = threading.local()
    devstr2type = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %s" % device_type)
        self.device_type = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names. Raises
        :class:`DeviceUnavailableError` for a card that is not there."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "%s requested but torch.cuda.is_available() is False. The "
                "port runs on the GPU unless asked otherwise: pass "
                "ctx=mx.cpu() / context=mx.cpu(), or enter 'with "
                "mx.cpu():'" % self)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise DeviceUnavailableError(
                "%s: device_id out of range (%d CUDA devices visible)"
                % (self, n))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._default_ctx.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)
