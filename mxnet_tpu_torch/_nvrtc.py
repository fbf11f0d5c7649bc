"""ctypes bindings to NVRTC and the CUDA driver API: what ``rtc.Rtc``
needs to compile CUDA source at run time and launch it, and nothing
more.

NVRTC is found under ``CUDA_HOME/lib64`` (PyTorch's, then the
environment's, then ``/usr/local/cuda``), else as the NVRTC wheel that
PyTorch installs (``site-packages/nvidia/cuda_nvrtc/lib``) or beside
PyTorch's own libraries. The driver is ``libcuda.so.1``. Nothing is
loaded at import: the CPU tests import this module.

Modules load into the device's primary context, the one PyTorch runs
in, and kernels launch on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading
from typing import Dict, List, Optional, Sequence

import torch

from .base import DeviceUnavailableError, MXNetError

__all__ = ["device_arch", "compile_cubin", "load_function", "launch",
           "require_card"]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_U = ctypes.c_uint
_SZ = ctypes.POINTER(ctypes.c_size_t)
_S = ctypes.c_char_p

_NVRTC_SIGNATURES = {
    "nvrtcCreateProgram": [_PP, _S, _S, _I, ctypes.POINTER(_S),
                           ctypes.POINTER(_S)],
    "nvrtcCompileProgram": [_P, _I, ctypes.POINTER(_S)],
    "nvrtcGetProgramLogSize": [_P, _SZ],
    "nvrtcGetProgramLog": [_P, _S],
    "nvrtcGetCUBINSize": [_P, _SZ],
    "nvrtcGetCUBIN": [_P, _S],
    "nvrtcDestroyProgram": [_PP],
}
_CUDA_SIGNATURES = {
    "cuInit": [_U],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxGetCurrent": [_PP],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _P],
    "cuModuleGetFunction": [_PP, _P, _S],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP],
    "cuGetErrorString": [_I, ctypes.POINTER(_S)],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_contexts: Dict[int, ctypes.c_void_p] = {}


def _nvrtc_candidates() -> List[str]:
    homes = []
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes += [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
              "/usr/local/cuda"]
    dirs = [os.path.join(h, sub) for h in homes if h
            for sub in ("lib64", "lib")]
    dirs += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib") for p in sys.path
             if p]
    dirs.append(os.path.join(os.path.dirname(torch.__file__), "lib"))
    found = []
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "libnvrtc*.so*"))):
            if "builtins" not in os.path.basename(path) and path not in found:
                found.append(path)
    return found


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        if name == "nvrtc":
            paths, sigs = _nvrtc_candidates(), _NVRTC_SIGNATURES
        else:
            paths, sigs = ["libcuda.so.1"], _CUDA_SIGNATURES
        errors = []
        for path in paths:
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError as e:
                errors.append(str(e))
        else:
            raise MXNetError("runtime compilation: no loadable %s library "
                             "(tried %s) %s" % (name, paths or "nothing",
                                                "; ".join(errors)))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        if name == "nvrtc":
            lib.nvrtcGetErrorString.argtypes = [_I]
            lib.nvrtcGetErrorString.restype = _S
        _libs[name] = lib
    return lib


def _check_nvrtc(rc: int, what: str) -> None:
    if rc != 0:
        msg = _load("nvrtc").nvrtcGetErrorString(rc)
        raise MXNetError("NVRTC %s failed: %s (%d)"
                         % (what, msg.decode() if msg else "?", rc))


def _check_cuda(rc: int, what: str) -> None:
    if rc != 0:
        text = _S()
        _load("cuda").cuGetErrorString(rc, ctypes.byref(text))
        raise MXNetError("CUDA driver %s failed: %s (%d)"
                         % (what, text.value.decode() if text.value else "?",
                            rc))


def device_arch(device: int) -> str:
    """The NVRTC target of CUDA device ``device``, e.g. ``sm_90a``."""
    major, minor = torch.cuda.get_device_capability(device)
    # sm_90a: Hopper's arch-specific target (wgmma, setmaxnreg) for H100
    return "sm_%d%d%s" % (major, minor, "a" if (major, minor) == (9, 0)
                          else "")


def compile_cubin(source: str, name: str, arch: str) -> bytes:
    """Compile CUDA C source with NVRTC into a cubin for ``arch`` (see
    :func:`device_arch`); a source that does not compile raises
    MXNetError carrying NVRTC's log."""
    lib = _load("nvrtc")
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        ("%s.cu" % name).encode(), 0, None,
                                        None), "nvrtcCreateProgram")
    try:
        opts = [("--gpu-architecture=%s" % arch).encode()]
        rc = lib.nvrtcCompileProgram(prog, len(opts), (_S * len(opts))(*opts))
        if rc != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            raise MXNetError("Rtc '%s': NVRTC failed to compile the kernel:\n%s"
                             % (name, log.value.decode(errors="replace")))
        size = ctypes.c_size_t()
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(device: int) -> None:
    """Make ``device``'s primary context (PyTorch's) current on this
    thread."""
    cuda = _load("cuda")
    with _lock:
        ctx = _contexts.get(device)
        if ctx is None:
            torch.cuda.init()
            _check_cuda(cuda.cuInit(0), "cuInit")
            dev = ctypes.c_int()
            _check_cuda(cuda.cuDeviceGet(ctypes.byref(dev), device),
                        "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check_cuda(cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                        "cuDevicePrimaryCtxRetain")
            _contexts[device] = ctx
    cur = ctypes.c_void_p()
    _check_cuda(cuda.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check_cuda(cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_function(cubin: bytes, name: str, device: int):
    """Load ``cubin`` into ``device``'s primary context and return the
    function ``name`` (the module stays loaded for the process's life,
    as MXRtc kept its)."""
    cuda = _load("cuda")
    _make_current(device)
    module = ctypes.c_void_p()
    image = ctypes.create_string_buffer(cubin, len(cubin))
    _check_cuda(cuda.cuModuleLoadData(ctypes.byref(module), image),
                "cuModuleLoadData")
    fn = ctypes.c_void_p()
    _check_cuda(cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                         name.encode()),
                "cuModuleGetFunction")
    return fn


def launch(fn, device: int, grid: Sequence[int], block: Sequence[int],
           pointers: Sequence[int], stream: Optional[int]) -> None:
    """Launch ``fn`` with one device-pointer argument per entry of
    ``pointers`` on ``stream``."""
    cuda = _load("cuda")
    _make_current(device)
    # kernelParams is a void**: one pointer to each argument's storage, a
    # 64-bit CUdeviceptr each, alive until the launch returns
    args = [ctypes.c_uint64(p) for p in pointers]
    params = (ctypes.c_void_p * len(args))(
        *[ctypes.addressof(a) for a in args])
    _check_cuda(cuda.cuLaunchKernel(fn, grid[0], grid[1], grid[2], block[0],
                                    block[1], block[2], 0,
                                    ctypes.c_void_p(stream), params, None),
                "cuLaunchKernel")


def require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "%s: runtime compilation (NVRTC) builds CUDA kernels for a card, "
            "and torch.cuda.is_available() is False" % what)
