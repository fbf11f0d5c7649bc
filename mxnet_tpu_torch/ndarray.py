"""Imperative NDArray over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``. An ``NDArray`` holds one tensor
on its context's device. PyTorch orders work on the device by its
stream, and ``asnumpy`` waits for it; :func:`waitall` waits through the
engine (:func:`mxnet_tpu_torch.engine.get_engine`). Unlike the JAX
package's immutable arrays, ``arr[:] = v`` and the in-place operators
(``+=``, ...) write the tensor in place. Arithmetic, comparisons (0/1
arrays of the operand's dtype) and the function zoo (``exp`` ...
``crop_assign_scalar``) give results on their operands' device;
operands on two devices raise.

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
           "full", "arange", "concatenate", "load", "save",
           "load_from_stream", "save_to_stream", "waitall", "onehot_encode"]


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
    """An n-dimensional array on one device. ``writable=False`` makes
    ``arr[...] = v`` and the in-place operators raise."""

    __slots__ = ("_data", "_ctx", "writable")

    def __init__(self, data: torch.Tensor, ctx: Context,
                 writable: bool = True):
        self._data = data
        self._ctx = ctx
        self.writable = writable

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
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return self._ctx

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    # -- synchronisation ---------------------------------------------------
    def wait_to_read(self):
        """Wait for the work queued on the array's device's current
        stream (which writes it)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # -- host transfer -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        return _to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("asscalar requires size-1 array, got %s"
                             % (self.shape,))
        return self.asnumpy().reshape(())[()]

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

    def copy(self) -> "NDArray":
        return NDArray(self._data.clone(), self._ctx)

    # -- shape manipulation ------------------------------------------------
    def reshape(self, shape) -> "NDArray":
        """A new array of ``shape``; ``0`` keeps that axis' size and
        ``-1`` is inferred, as the reference's Reshape reads them."""
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(_expand_reshape(self.shape, shape)),
                       self._ctx)

    @property
    def T(self) -> "NDArray":
        return NDArray(self._data.permute(*reversed(range(self.ndim))),
                       self._ctx)

    def slice(self, start: int, stop: int) -> "NDArray":
        return self[start:stop]

    def __getitem__(self, key) -> "NDArray":
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if not self.writable:
            raise MXNetError("NDArray is not writable")
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

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return _binary(self, other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, torch.sub)

    def __rsub__(self, other):
        return _binary(self, other, lambda a, b: b - a)

    def __mul__(self, other):
        return _binary(self, other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return _binary(self, other, lambda a, b: b / a)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return _binary(self, other, lambda a, b: a ** b)

    def __neg__(self):
        return NDArray(-self._data, self._ctx)

    def __iadd__(self, other):
        return _inplace(self, other, torch.Tensor.add_)

    def __isub__(self, other):
        return _inplace(self, other, torch.Tensor.sub_)

    def __imul__(self, other):
        return _inplace(self, other, torch.Tensor.mul_)

    def __itruediv__(self, other):
        return _inplace(self, other, torch.Tensor.div_)

    __idiv__ = __itruediv__

    # comparisons give 0/1 arrays of the operand's dtype
    def __eq__(self, other):  # type: ignore[override]
        return _compare(self, other, torch.eq)

    def __ne__(self, other):  # type: ignore[override]
        return _compare(self, other, torch.ne)

    def __gt__(self, other):
        return _compare(self, other, torch.gt)

    def __ge__(self, other):
        return _compare(self, other, torch.ge)

    def __lt__(self, other):
        return _compare(self, other, torch.lt)

    def __le__(self, other):
        return _compare(self, other, torch.le)

    def __hash__(self):
        return id(self)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self._ctx)


def _expand_reshape(cur_shape, shape):
    """``0`` entries copy the current size of that axis (the reference
    Reshape's code); ``-1`` is left for torch to infer."""
    return tuple(cur_shape[i] if s == 0 else s for i, s in enumerate(shape))


def _operand(lhs: NDArray, rhs):
    """``rhs`` as a tensor or a scalar; an NDArray on another device than
    ``lhs`` raises."""
    if not isinstance(rhs, NDArray):
        return rhs
    if rhs._data.device != lhs._data.device:
        raise MXNetError("operands on two devices: %s and %s"
                         % (lhs.context, rhs.context))
    return rhs._data


def _binary(lhs: NDArray, rhs, fn) -> NDArray:
    return NDArray(fn(lhs._data, _operand(lhs, rhs)), lhs._ctx)


def _compare(lhs: NDArray, rhs, fn) -> NDArray:
    return NDArray(fn(lhs._data, _operand(lhs, rhs)).to(lhs._data.dtype),
                   lhs._ctx)


def _inplace(lhs: NDArray, rhs, fn) -> NDArray:
    if not lhs.writable:
        raise MXNetError("in-place op on non-writable NDArray")
    with torch.no_grad():
        fn(lhs._data, _operand(lhs, rhs))
    return lhs


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


def full(shape, val, ctx=None, dtype=mx_real_t) -> NDArray:
    ctx, dev = _resolve(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=dev), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=mx_real_t) -> NDArray:
    """``numpy.arange`` with each value ``repeat`` times."""
    arr = np.arange(start, stop, step, dtype=np.dtype(dtype))
    if repeat != 1:
        arr = np.repeat(arr, repeat)
    ctx, dev = _resolve(ctx)
    return NDArray(_host_tensor(arr).to(dev), ctx)


def waitall():
    """Wait for all pushed work (the engine's ``wait_for_all``)."""
    from .engine import get_engine

    get_engine().wait_for_all()


def concatenate(arrays: Sequence[NDArray], axis: int = 0) -> NDArray:
    if not arrays:
        raise MXNetError("concatenate needs at least one array")
    for a in arrays[1:]:
        _operand(arrays[0], a)
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


# ---------------------------------------------------------------------------
# the function zoo (JAX package ndarray.py:453-671)
# ---------------------------------------------------------------------------

def _same_device(*arrays: NDArray) -> None:
    for a in arrays[1:]:
        _operand(arrays[0], a)


def _unary_fn(name, fn):
    def _fn(data: NDArray, out: Optional[NDArray] = None) -> NDArray:
        res = NDArray(fn(data._data), data._ctx)
        if out is not None:
            return res.copyto(out)
        return res
    _fn.__name__ = _fn.__qualname__ = name
    _fn.__doc__ = "Elementwise %s, into ``out`` where given." % name
    globals()[name] = _fn
    __all__.append(name)
    return _fn


for _name, _fn in (("exp", torch.exp), ("log", torch.log),
                   ("sqrt", torch.sqrt), ("square", lambda x: x * x),
                   ("abs", torch.abs), ("sign", torch.sign),
                   ("round", torch.round), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("sin", torch.sin),
                   ("relu", lambda x: torch.clamp_min(x, 0)),
                   ("sigmoid", lambda x: 1.0 / (1.0 + torch.exp(-x))),
                   ("tanh", torch.tanh)):
    _unary_fn(_name, _fn)


def dot(lhs: NDArray, rhs: NDArray) -> NDArray:
    """``numpy.dot`` of two arrays (a matrix product for 2-d ones)."""
    _same_device(lhs, rhs)
    a, b = lhs._data, rhs._data
    if a.dim() <= 2 and b.dim() <= 2:
        res = torch.matmul(a, b)
    else:   # numpy.dot: a's last axis against b's second to last
        res = torch.tensordot(a, b, dims=([a.dim() - 1],
                                          [b.dim() - 2]))
    return NDArray(res, lhs._ctx)


def maximum(lhs, rhs) -> NDArray:
    if not isinstance(lhs, NDArray):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, NDArray):
        return _binary(lhs, rhs, torch.maximum)
    return NDArray(torch.clamp_min(lhs._data, rhs), lhs._ctx)


def minimum(lhs, rhs) -> NDArray:
    if not isinstance(lhs, NDArray):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, NDArray):
        return _binary(lhs, rhs, torch.minimum)
    return NDArray(torch.clamp_max(lhs._data, rhs), lhs._ctx)


def clip(data: NDArray, a_min, a_max) -> NDArray:
    return NDArray(torch.clamp(data._data, a_min, a_max), data._ctx)


def _reduce_fn(name, fn):
    def _fn(data: NDArray, axis=None, keepdims=False) -> NDArray:
        x = data._data
        if axis is None:
            r = fn(x)
            if keepdims:
                r = r.reshape((1,) * x.dim())
        else:
            r = fn(x, dim=axis, keepdim=keepdims)
        if r.dim() == 0:
            r = r.reshape((1,))
        return NDArray(r, data._ctx)
    _fn.__name__ = _fn.__qualname__ = name
    _fn.__doc__ = "%s over ``axis`` (every axis by default)." % name
    globals()[name] = _fn
    __all__.append(name)
    return _fn


def _amax(x, dim=None, keepdim=False):
    return torch.amax(x) if dim is None else torch.amax(x, dim, keepdim)


def _amin(x, dim=None, keepdim=False):
    return torch.amin(x) if dim is None else torch.amin(x, dim, keepdim)


for _name, _fn in (("sum", torch.sum), ("max", _amax), ("min", _amin),
                   ("mean", torch.mean)):
    _reduce_fn(_name, _fn)
del _name, _fn


def argmax_channel(data: NDArray) -> NDArray:
    """The argmax over axis 1, in the data's dtype."""
    return NDArray(torch.argmax(data._data, dim=1).to(data._data.dtype),
                   data._ctx)


def norm(data: NDArray) -> NDArray:
    """The l2 norm of every element, as a (1,) float32 array."""
    x = data._data.to(torch.float32)
    return NDArray(torch.sqrt(torch.sum(x ** 2)).reshape((1,)), data._ctx)


def transpose(data: NDArray, axes=None) -> NDArray:
    axes = tuple(reversed(range(data.ndim))) if axes is None else axes
    return NDArray(data._data.permute(*axes), data._ctx)


def broadcast_to(data: NDArray, shape) -> NDArray:
    return NDArray(data._data.broadcast_to(tuple(shape)).clone(), data._ctx)


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """``out[i] = onehot(indices[i])`` over ``out``'s second axis, in
    place."""
    _same_device(out, indices)
    idx = indices._data.to(torch.int64)
    classes = torch.arange(out.shape[1], device=idx.device)
    out._data.copy_((idx[:, None] == classes[None, :]).to(out._data.dtype))
    return out


def choose_element_0index(lhs: NDArray, rhs: NDArray) -> NDArray:
    """``out[i] = lhs[i, rhs[i]]``."""
    _same_device(lhs, rhs)
    a = lhs._data
    rows = torch.arange(a.shape[0], device=a.device)
    return NDArray(a[rows, rhs._data.to(torch.int64)], lhs._ctx)


def element_mask(lhs: NDArray, rhs: NDArray) -> NDArray:
    """``out[i, ...] = lhs[i, ...] * rhs[i]``."""
    if lhs.ndim < 2 or rhs.ndim != 1 or lhs.shape[0] != rhs.shape[0]:
        raise MXNetError(
            "element_mask: source tensor should be 2D or more, mask 1D "
            "with matching first dim; got lhs=%s rhs=%s"
            % (lhs.shape, rhs.shape))
    _same_device(lhs, rhs)
    a = lhs._data
    mask = rhs._data.reshape((a.shape[0],) + (1,) * (a.dim() - 1))
    return NDArray(a * mask.to(a.dtype), lhs._ctx)


def _check_crop_region(shape, begin, end, what="crop_assign"):
    """Check a [begin, end) region against ``shape``; returns the
    region's shape."""
    if len(begin) != len(shape) or len(end) != len(shape):
        raise MXNetError("%s: begin/end must cover all %d axes"
                         % (what, len(shape)))
    for b, e, d in zip(begin, end, shape):
        if not (0 <= b <= e <= d):
            raise MXNetError("%s: invalid range [%d, %d) on axis of size "
                             "%d" % (what, b, e, d))
    return tuple(e - b for b, e in zip(begin, end))


def crop_assign(lhs: NDArray, rhs: NDArray, begin, end) -> NDArray:
    """A copy of ``lhs`` with ``rhs`` written into ``[begin, end)``."""
    region = _check_crop_region(lhs.shape, begin, end)
    if rhs.shape != region:
        raise MXNetError("crop_assign: rhs shape %s does not match region "
                         "%s" % (rhs.shape, region))
    _same_device(lhs, rhs)
    res = lhs._data.clone()
    res[tuple(slice(b, e) for b, e in zip(begin, end))] = \
        rhs._data.to(res.dtype)
    return NDArray(res, lhs._ctx)


def crop_assign_scalar(data: NDArray, scalar, begin, end) -> NDArray:
    """A copy of ``data`` with ``[begin, end)`` set to ``scalar``."""
    _check_crop_region(data.shape, begin, end)
    res = data._data.clone()
    res[tuple(slice(b, e) for b, e in zip(begin, end))] = scalar
    return NDArray(res, data._ctx)


__all__ += ["dot", "maximum", "minimum", "clip", "argmax_channel", "norm",
            "transpose", "broadcast_to", "choose_element_0index",
            "element_mask", "crop_assign", "crop_assign_scalar"]
