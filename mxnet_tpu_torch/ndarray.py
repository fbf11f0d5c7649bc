"""Imperative NDArray over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``. An ``NDArray`` holds one tensor
on its context's device. There is no dependency engine: PyTorch orders
work on the device by its stream, and ``asnumpy`` waits for it.
Unlike the JAX package's immutable arrays, ``arr[:] = v`` writes the
tensor in place.

The named-array container (magic ``"TPUARRA"``, ``save``/``load``) is
byte-compatible with the JAX package's in both directions, bfloat16
included.
"""
from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .base import (DTYPE_ID_TO_TORCH, DTYPE_TORCH_TO_ID, MXNetError,
                   mx_real_t, torch_dtype)
from .context import Context, current_context

__all__ = ["NDArray", "HostToDevice", "array", "empty", "zeros", "ones",
           "concatenate", "load", "save", "load_from_stream",
           "save_to_stream"]


def _np_dtype(dt: torch.dtype):
    """numpy dtype of a torch dtype; bfloat16 has none and stays torch."""
    if dt == torch.bfloat16:
        return torch.bfloat16
    return torch.empty((), dtype=dt).numpy().dtype


def _host_tensor(value) -> torch.Tensor:
    """A CPU tensor of host data; read-only numpy arrays are copied, and
    numpy bfloat16 (ml_dtypes) arrays are reinterpreted bit for bit."""
    arr = np.asarray(value)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise MXNetError("asnumpy of a bfloat16 array needs the "
                             "ml_dtypes package; cast with "
                             "astype('float32') first")
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data: torch.Tensor, ctx: Context):
        self._data = data
        self._ctx = ctx

    # -- basic properties --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype (``torch.bfloat16`` for bfloat16, which numpy
        lacks)."""
        return _np_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        return self._ctx

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    # -- host transfer -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        return _to_numpy(self._data)

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._data.to(torch_dtype(dtype)), self._ctx)

    # -- placement ---------------------------------------------------------
    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """Copy to another array (shapes must match) or to a context."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True),
                           other)
        if not isinstance(other, NDArray):
            raise MXNetError("copyto expects NDArray or Context")
        if other.shape != self.shape:
            raise MXNetError("copyto shape mismatch %s vs %s"
                             % (self.shape, other.shape))
        other._data.copy_(self._data)
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    # -- shape manipulation ------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            if value is self:
                return
            value = value._data
        if isinstance(value, torch.Tensor):
            val = value.to(self._data.device, self._data.dtype)
        elif np.isscalar(value):
            val = value
        else:
            val = _host_tensor(value).to(self._data.device,
                                         self._data.dtype)
        full = isinstance(key, slice) and key == slice(None)
        if full and isinstance(val, torch.Tensor):
            self._data.copy_(val.expand(self._data.shape)
                             if val.shape != self._data.shape else val)
        else:
            self._data[key] = val

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self._ctx)


class HostToDevice:
    """Copies host data into one fixed tensor ``dst``, which keeps its
    storage, so a CUDA graph that reads ``dst`` sees the new values on
    its next replay. On a card the data go through one of two pinned
    host buffers, used in turn, and one asynchronous copy on the current
    stream; :meth:`copy` waits for the copy out of its buffer two calls
    back before it rewrites it, so the host may run two copies ahead of
    the card. On the CPU it is a plain copy."""

    def __init__(self, dst: torch.Tensor):
        self.dst = dst
        self._slots = []
        self._turn = 0
        if dst.is_cuda:
            self._slots = [(torch.empty(dst.shape, dtype=dst.dtype,
                                        pin_memory=True), torch.cuda.Event())
                           for _ in range(2)]

    def copy(self, src) -> torch.Tensor:
        """``src`` (numpy, a CPU tensor or NDArray) into ``dst``."""
        if isinstance(src, NDArray):
            src = src._data
        elif not isinstance(src, torch.Tensor):
            src = _host_tensor(np.asarray(src))
        if not self._slots or src.is_cuda:
            self.dst.copy_(src)
            return self.dst
        host, done = self._slots[self._turn]
        self._turn ^= 1
        done.synchronize()
        host.copy_(src)
        self.dst.copy_(host, non_blocking=True)
        done.record()
        return self.dst


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------

def _resolve(ctx: Optional[Context]):
    ctx = ctx if ctx is not None else current_context()
    return ctx, ctx.torch_device()


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from host data (numpy, lists, tensors, NDArrays).
    Without ``dtype``, 64-bit floats and integers become float32, the
    framework default."""
    ctx, dev = _resolve(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach().clone()
    else:
        t = _host_tensor(np.array(source))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    elif t.dtype in (torch.float64, torch.int64):
        t = t.to(torch.float32)
    return NDArray(t.to(dev), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    ctx, dev = _resolve(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx)


def empty(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    ctx, dev = _resolve(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=dev), ctx)


def concatenate(arrays: Sequence[NDArray], axis: int = 0) -> NDArray:
    if not arrays:
        raise MXNetError("concatenate needs at least one array")
    return NDArray(torch.cat([a._data for a in arrays], dim=axis),
                   arrays[0].context)


# ---------------------------------------------------------------------------
# the named-array container (JAX package ndarray.py:671-776)
# ---------------------------------------------------------------------------

_MAGIC = 0x54505541525241  # "TPUARRA"


def _raw_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_to_stream(f, data) -> None:
    """Write a list or str-keyed dict of NDArrays to a binary stream."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    elif isinstance(data, NDArray):
        names, arrays = [], [data]
    else:
        raise MXNetError("save expects NDArray, list or dict of NDArray")
    f.write(struct.pack("<QQQ", _MAGIC, 0, len(arrays)))
    for arr in arrays:
        t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)
        if t.dtype not in DTYPE_TORCH_TO_ID:
            raise MXNetError("cannot save dtype %s" % t.dtype)
        f.write(struct.pack("<I", t.dim()))
        f.write(struct.pack("<%dq" % t.dim(), *t.shape))
        f.write(struct.pack("<I", DTYPE_TORCH_TO_ID[t.dtype]))
        raw = _raw_bytes(t)
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
    f.write(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)


def _read_exact(f, n: int, what: str) -> bytes:
    raw = f.read(n)
    if len(raw) != n:
        raise MXNetError("invalid NDArray file %s: truncated (wanted %d "
                         "bytes, got %d)" % (what, n, len(raw)))
    return raw


def load_from_stream(f, what: str = "<stream>",
                     ctx: Optional[Context] = None):
    """Read a container; returns a list, or a dict when it has names.
    Arrays land on ``ctx`` (default: the current context)."""
    ctx, dev = _resolve(ctx)
    header = f.read(24)
    if len(header) < 24:
        raise MXNetError("invalid NDArray file %s: truncated header" % what)
    magic, _, n = struct.unpack("<QQQ", header)
    if magic != _MAGIC:
        raise MXNetError("invalid NDArray file %s" % what)
    arrays = []
    for _ in range(n):
        ndim, = struct.unpack("<I", _read_exact(f, 4, what))
        shape = struct.unpack("<%dq" % ndim,
                              _read_exact(f, 8 * ndim, what)) if ndim else ()
        dtype_id, = struct.unpack("<I", _read_exact(f, 4, what))
        nbytes, = struct.unpack("<Q", _read_exact(f, 8, what))
        raw = _read_exact(f, nbytes, what)
        if dtype_id not in DTYPE_ID_TO_TORCH:
            raise MXNetError("invalid NDArray file %s: unknown dtype id %d"
                             % (what, dtype_id))
        dt = DTYPE_ID_TO_TORCH[dtype_id]
        if nbytes:
            t = torch.frombuffer(bytearray(raw), dtype=dt)
        else:
            t = torch.empty((0,), dtype=dt)
        arrays.append(NDArray(t.reshape(shape).to(dev), ctx))
    n_names, = struct.unpack("<Q", _read_exact(f, 8, what))
    names = []
    for _ in range(n_names):
        ln, = struct.unpack("<Q", _read_exact(f, 8, what))
        names.append(_read_exact(f, ln, what).decode("utf-8"))
    if names:
        if len(names) != len(arrays):
            raise MXNetError("corrupt NDArray file: name/array count "
                             "mismatch")
        return dict(zip(names, arrays))
    return arrays


def save(fname: str, data) -> None:
    """Save a list or str-keyed dict of NDArrays to a file."""
    with open(fname, "wb") as f:
        save_to_stream(f, data)


def load(fname: str, ctx: Optional[Context] = None):
    """Load NDArrays saved by :func:`save` (or by the JAX package)."""
    with open(fname, "rb") as f:
        return load_from_stream(f, fname, ctx=ctx)
