"""mxnet_tpu_torch — the PyTorch and CUDA port of mxnet_tpu.

``import mxnet_tpu_torch as mx`` gives the JAX package's API over
``torch.Tensor``, running on an NVIDIA GPU by default:

* ``mx.nd`` — NDArray over torch tensors, and the "TPUARRA" container
* ``mx.sym`` — symbolic graphs, JSON-compatible with ``mxnet_tpu``
* ``mx.mod`` — Module (single device): bind, predict, ``fit`` (the
  classic loop, or ``fused_step=True``: one CUDA graph a batch)
* ``mx.model`` — the FeedForward estimator and checkpoint files
* ``mx.checkpoint`` — full-state snapshots, resume and the SIGTERM
  grace path of ``fit`` (``MXNET_TPU_CKPT_*``, read through ``mx.env``)
* ``mx.numwatch``, ``mx.Monitor``, ``mx.tracing``, ``mx.io_pipeline`` —
  fit's health and input plane: the stats pack and its guards, the
  step trace with its detectors and metrics server, device staging
* ``mx.io``, ``mx.recordio`` — data iterators (in-memory, MNIST, CSV,
  image records with their decoder, resizing and prefetching) and the
  RecordIO files they read
* ``mx.optimizer``, ``mx.lr_scheduler``, ``mx.metric``,
  ``mx.callback``, ``mx.kv`` — the training loop's parts
* ``mx.serving`` — the batching InferenceServer
* ``mx.Predictor`` — the deployment predict API
* ``mx.interop`` — weights carried across from ``mxnet_tpu``

The default context is ``mx.gpu(0)``. Ask for the CPU with ``with
mx.cpu():`` or ``ctx=mx.cpu()``; there is no silent fallback. The
hand-written Hopper kernels live in ``ops/kernels.py`` (sources in
``csrc/``, built with nvcc at first use).
"""
from __future__ import annotations

from .base import MXNetError, DeviceUnavailableError
from . import env
from . import telemetry
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
from . import io_pipeline
from . import recordio
from . import lr_scheduler
from . import optimizer
from . import metric
from . import callback
from . import kvstore
from . import kvstore as kv
from . import module
from . import module as mod
from . import fused_step
from . import checkpoint
from . import tracing
from . import numwatch
from . import monitor
from .monitor import Monitor
from . import model
from . import serving
from . import predictor
from .predictor import Predictor
from . import models
from . import interop

__version__ = "0.1.0"
