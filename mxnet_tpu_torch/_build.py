"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to
``mxnet_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
never loads a stale build. The build
happens at first use; :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from .base import MXNetError

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load", "library_path",
           "find_nvcc"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"norm_act": "norm_act.cu",
                           "conv_gemm": "conv_gemm.cu",
                           "linear": "linear.cu",
                           "flash_attn": "flash_attn.cu"}

NVCC_FLAGS: List[str] = ["-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", "-shared", "-Xcompiler",
                         "-fPIC", "-Xptxas=-v"]

# C signatures of the exported functions, declared on load: name ->
# (argument types, return type). Every pointer and the stream are c_void_p
# and every 64-bit size c_longlong, or ctypes would pass a 32-bit int.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "norm_act": {
        "norm_act_fwd": ([_P, _P, _P, _P, _LL, _I, _I, _I, _P], _I),
        "norm_act_bwd_row_blocks": ([_LL, _I], _I),
        "norm_act_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                          _I, _P], _I),
    },
    "conv_gemm": {
        "conv_gemm_k_chunk": ([_LL, _LL, _LL], _LL),
        "conv_gemm": ([_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _LL, _I, _P],
                      _I),
    },
    "linear": {
        "linear_k_chunk": ([_LL, _LL, _LL], _LL),
        "linear_fwd": ([_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _LL, _I, _P],
                       _I),
    },
    "flash_attn": {
        "flash_attn_fwd": ([_P, _P, _P, _P, _LL, _LL, _LL, _F, _I, _P], _I),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: kernel name -> {"seconds": build wall time, "log": nvcc output}
build_log: Dict[str, dict] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else under PyTorch's CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                     "kernels are built on the machine with the card")


def library_path(name: str) -> str:
    # the source, every header of csrc/ (gemm_tile.cuh) and the flags name
    # the build
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [SOURCES[name]] + sorted(
            f for f in os.listdir(_SRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(_SRC_DIR, path), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                   digest.hexdigest()[:12]))


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns ``build_log``."""
    names = list(names or SOURCES)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp,
                                     os.path.join(_SRC_DIR, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (n, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return lib
