"""mxnet_tpu_torch — the PyTorch and CUDA port of mxnet_tpu.

``import mxnet_tpu_torch as mx`` gives the JAX package's API over
``torch.Tensor``, running on an NVIDIA GPU by default:

* ``mx.nd`` — NDArray over torch tensors, and the "TPUARRA" container
* ``mx.sym`` — symbolic graphs, JSON-compatible with ``mxnet_tpu``
* ``mx.mod`` — Module (single device, inference in this slice)
* ``mx.serving`` — the batching InferenceServer
* ``mx.Predictor`` — the deployment predict API
* ``mx.interop`` — weights carried across from ``mxnet_tpu``

The default context is ``mx.gpu(0)``. Ask for the CPU with ``with
mx.cpu():`` or ``ctx=mx.cpu()``; there is no silent fallback. The
hand-written Hopper kernels live in ``ops/kernels.py`` (sources in
``csrc/``, built with nvcc at first use).
"""
from __future__ import annotations

from .base import MXNetError, DeviceUnavailableError, TrainingNotPortedError
from .context import Context, cpu, gpu, current_context
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from .name import NameManager
from .attribute import AttrScope
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from . import initializer
from . import initializer as init
from . import io
from . import module
from . import module as mod
from . import fused_step
from . import serving
from . import predictor
from .predictor import Predictor
from . import models
from . import interop

__version__ = "0.1.0"
