"""Runtime kernel compilation (K6).

Counterpart of ``mxnet_tpu/rtc.py``, which compiled a user's Pallas
kernel body at run time. On the card the kernel language goes back to
CUDA C, as the reference MXNet's MXRtc had it (``src/common/mxrtc.cc``,
``include/mxnet/mxrtc.h``): NVRTC compiles the body in memory and the
CUDA driver API launches it on NDArrays.

The body is wrapped as MXRtc wrapped it::

    extern "C" __global__ void <name>(const T* <input>, ..., T* <output>) {
    <body>
    }

with ``T`` following each array's dtype (:data:`CTYPES`): the body
reads the inputs and writes the outputs by their declared names, as
flat arrays, and computes its own index from ``blockIdx``/``threadIdx``.
``push`` launches it over ``grid_dims`` x ``block_dims``, which are
required. There is no CPU path: a CUDA body needs a card.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import _nvrtc
from .base import MXNetError
from .ndarray import NDArray
from .ops import kernels

__all__ = ["Rtc", "CTYPES", "wrap_source"]

#: the C type of each supported array dtype in the kernel's signature
CTYPES = {torch.float32: "float", torch.float64: "double",
          torch.int32: "int", torch.uint8: "unsigned char"}


def _ctype(rtc_name: str, arg: str, dtype: torch.dtype) -> str:
    if dtype not in CTYPES:
        raise MXNetError("Rtc '%s': array '%s' has dtype %s; supported: %s"
                         % (rtc_name, arg, dtype,
                            ", ".join(str(d) for d in CTYPES)))
    return CTYPES[dtype]


def wrap_source(name: str, inputs: Sequence[Tuple[str, torch.dtype]],
                outputs: Sequence[Tuple[str, torch.dtype]],
                kernel: str) -> str:
    """The CUDA source of kernel ``name``: ``kernel`` (the body) inside an
    ``extern "C" __global__`` function taking a const pointer per input
    and a pointer per output, in order."""
    params = ["const %s* %s" % (_ctype(name, arg, dt), arg)
              for arg, dt in inputs]
    params += ["%s* %s" % (_ctype(name, arg, dt), arg) for arg, dt in outputs]
    return 'extern "C" __global__ void %s(%s) {\n%s\n}\n' % (
        name, ", ".join(params), kernel.strip("\n"))


def _dims(value, what: str, name: str) -> Tuple[int, int, int]:
    dims = tuple(int(v) for v in value)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("Rtc '%s': %s must be 1 to 3 positive ints, got %r"
                         % (name, what, value))
    return dims + (1,) * (3 - len(dims))


class Rtc:
    """Compile and run a CUDA kernel body.

    ``name`` names the kernel; ``inputs``/``outputs`` are (name, NDArray)
    pairs declaring the arguments and their dtypes; ``kernel`` is the
    CUDA C source of the body. Compilation happens here, with NVRTC; a
    body that does not compile raises MXNetError carrying NVRTC's log.
    Without a card this raises DeviceUnavailableError.

    Example::

        rtc = mx.rtc.Rtc("axpy", [("x", x), ("y", y)], [("out", out)],
                         "int i = blockIdx.x * blockDim.x + threadIdx.x;\\n"
                         "if (i < 64) out[i] = 2.0f * x[i] + y[i];")
        rtc.push([x, y], [out], grid_dims=(1,), block_dims=(64,))
    """

    def __init__(self, name: str, inputs: Sequence[Tuple[str, NDArray]],
                 outputs: Sequence[Tuple[str, NDArray]], kernel: str):
        _nvrtc.require_card("Rtc '%s'" % name)
        if not outputs:
            raise MXNetError("Rtc '%s': declare at least one output" % name)
        self.name = name
        self._in = [(n, a.handle.dtype) for n, a in inputs]
        self._out = [(n, a.handle.dtype) for n, a in outputs]
        self.source = wrap_source(name, self._in, self._out, kernel)
        # compiled for the current device's architecture; push loads it
        # onto any device of that architecture
        self._arch = _nvrtc.device_arch(torch.cuda.current_device())
        self._cubin = _nvrtc.compile_cubin(self.source, name, self._arch)
        self._functions = {}

    def push(self, inputs: List[NDArray], outputs: List[NDArray],
             grid_dims=None, block_dims=None):
        """Launch the kernel over ``grid_dims`` blocks of ``block_dims``
        threads (up to three ints each) on the current stream; the
        outputs are written in place. Every array lies on one CUDA device,
        is contiguous and has its declared dtype."""
        if len(inputs) != len(self._in) or len(outputs) != len(self._out):
            raise MXNetError("Rtc '%s': input/output arity mismatch (declared "
                             "%d inputs and %d outputs, got %d and %d)"
                             % (self.name, len(self._in), len(self._out),
                                len(inputs), len(outputs)))
        if grid_dims is None or block_dims is None:
            raise MXNetError("Rtc '%s': push needs grid_dims and block_dims "
                             "(they decide the CUDA launch)" % self.name)
        grid = _dims(grid_dims, "grid_dims", self.name)
        block = _dims(block_dims, "block_dims", self.name)
        tensors = [a.handle for a in list(inputs) + list(outputs)]
        dev = tensors[0].device
        for (arg, dt), t in zip(self._in + self._out, tensors):
            if t.device.type != "cuda" or t.device != dev:
                raise MXNetError("Rtc '%s': every array must lie on one CUDA "
                                 "device; '%s' is on %s" % (self.name, arg,
                                                            t.device))
            if not t.is_contiguous():
                raise MXNetError("Rtc '%s': array '%s' is not contiguous"
                                 % (self.name, arg))
            if t.dtype != dt:
                raise MXNetError("Rtc '%s': array '%s' is %s, declared %s"
                                 % (self.name, arg, t.dtype, dt))
        index = dev.index
        fn = self._functions.get(index)
        if fn is None:
            arch = _nvrtc.device_arch(index)
            if arch != self._arch:
                raise MXNetError("Rtc '%s': compiled for %s, but the arrays "
                                 "are on %s, a %s card" % (self.name,
                                                           self._arch, dev,
                                                           arch))
            fn = _nvrtc.load_function(self._cubin, self.name, index)
            self._functions[index] = fn
        with torch.cuda.device(index):
            _nvrtc.launch(fn, index, grid, block,
                          [t.data_ptr() for t in tensors],
                          torch.cuda.current_stream(index).cuda_stream)
        kernels._count("rtc_launches")
