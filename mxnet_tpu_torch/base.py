"""Base types shared across the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: the error type, the dtype-id table
that the "TPUARRA" container stores (ids are shared with the JAX package,
so saved params cross between the two), and the string-keyed registry
behind operators and initializers.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Optional, TypeVar

import numpy as np
import torch

__all__ = ["MXNetError", "DeviceUnavailableError", "TrainingNotPortedError",
           "mx_real_t", "DTYPE_TORCH_TO_ID", "DTYPE_ID_TO_TORCH",
           "torch_dtype", "Registry"]


class MXNetError(Exception):
    """Error raised by the framework."""


class DeviceUnavailableError(MXNetError):
    """A CUDA context was asked for (explicitly, or as the default
    ``gpu(0)``) on a machine where ``torch.cuda.is_available()`` is
    false. The port never falls back to the CPU on its own: pass
    ``ctx=mx.cpu()`` / ``context=mx.cpu()`` or enter ``with mx.cpu():``."""


class TrainingNotPortedError(MXNetError):
    """The training half of the port (backward, the fused train step,
    the norm+act backward kernel) is the next slice of ROADMAP.md
    (Queue A item 5, Queue B items 1-2); this slice serves only."""


mx_real_t = np.float32

# dtype ids of the named-array container, identical to the JAX package's
# DTYPE_NP_TO_ID (mshadow type flags + bfloat16 = 7, bool = 8)
DTYPE_TORCH_TO_ID: Dict[torch.dtype, int] = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.int8: 5,
    torch.int64: 6,
    torch.bfloat16: 7,
    torch.bool: 8,
}
DTYPE_ID_TO_TORCH = {v: k for k, v in DTYPE_TORCH_TO_ID.items()}

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    try:
        npd = np.dtype(dtype)
        if npd.name == "bfloat16":   # ml_dtypes' numpy bfloat16
            return torch.bfloat16
        return _NP_TO_TORCH[npd]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,))


T = TypeVar("T")


class Registry(Generic[T]):
    """String-keyed, case-insensitive registry (``DMLC_REGISTRY``)."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}
        Registry._registries[kind] = self

    @staticmethod
    def get_registry(kind: str) -> "Registry":
        if kind not in Registry._registries:
            Registry(kind)
        return Registry._registries[kind]

    def register(self, name: Optional[str] = None) -> Callable[[T], T]:
        def _do(entry: T) -> T:
            key = name or getattr(entry, "__name__", None)
            if key is None:
                raise MXNetError("registry entry needs a name")
            lname = key.lower()
            if lname in self._entries:
                raise MXNetError(
                    "%s '%s' already registered" % (self.kind, key))
            self._entries[lname] = entry
            return entry
        return _do

    def find(self, name: str) -> Optional[T]:
        return self._entries.get(name.lower())

    def get(self, name: str) -> T:
        entry = self.find(name)
        if entry is None:
            raise MXNetError("%s '%s' is not registered; known: %s" % (
                self.kind, name, sorted(self._entries)))
        return entry

    def items(self):
        return self._entries.items()
