"""mxnet_tpu_torch — the PyTorch and CUDA port of mxnet_tpu.

``import mxnet_tpu_torch as mx`` gives the JAX package's API over
``torch.Tensor``, running on an NVIDIA GPU by default:

* ``mx.nd`` — NDArray over torch tensors (arithmetic, the function zoo,
  ``mx.nd.<OpName>`` for every registered op), and the "TPUARRA"
  container
* ``mx.random`` — the seeded random stream; ``mx.engine`` — the
  push/wait dependency engines
* ``mx.sym`` — symbolic graphs, JSON-compatible with ``mxnet_tpu``,
  over every registered op (the nn, tensor, sequence, vision and CTC
  ops, the fused RNN on cuDNN, ROIPooling on a hand-written kernel);
  ``bind`` places ``ctx_group`` nodes by ``group2ctx``
* ``mx.operator`` — Custom ops written in Python (CustomOp,
  CustomOpProp, NumpyOp), run on the host by the classic loop
* ``mx.viz`` — ``print_summary`` and ``plot_network``;
  ``mx.filesystem`` — the URI schemes (``mem://``, registered ones)
  that every save and load takes
* ``mx.mod`` — Module on one context or over several (one replica a
  card, statistics over the global batch): bind, predict, ``fit`` (the
  classic loop, or ``fused_step=True``: one CUDA graph a batch); the
  bucketing, sequential and Python modules
* ``mx.test_utils`` — numeric gradient, symbolic and consistency checks
* ``mx.model`` — the FeedForward estimator and checkpoint files
* ``mx.checkpoint`` — full-state snapshots, resume and the SIGTERM
  grace path of ``fit`` (``MXNET_TPU_CKPT_*``, read through ``mx.env``)
* ``mx.numwatch``, ``mx.Monitor``, ``mx.tracing``, ``mx.io_pipeline`` —
  fit's health and input plane: the stats pack and its guards, the
  step trace with its detectors and metrics server, device staging
* ``mx.io``, ``mx.recordio`` — data iterators (in-memory, MNIST, CSV,
  image records with their decoder on threads or worker processes,
  resizing and prefetching) and the RecordIO files they read;
  ``mx.io_cache`` — the decoded uint8 image cache and its iterator,
  whose device feed the fused step crops and normalises in its graph
* ``mx.optimizer`` (SGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta, SGLD,
  Test), ``mx.lr_scheduler``, ``mx.metric``, ``mx.init``,
  ``mx.callback``, ``mx.kv`` — the training loop's parts
* ``mx.serving`` — the batching InferenceServer
* ``mx.Predictor`` — the deployment predict API
* ``mx.interop`` — weights carried across from ``mxnet_tpu``
* ``mx.xprof``, ``mx.profiler``, ``mx.analysis`` — device observability:
  the compile registry (captures, NVRTC compiles, kernel builds), the op
  breakdown of a profiled step, memory accounting and pre-flight checks;
  ``torch.profiler`` traces and step timers; the runtime sanitizers
  (``MXNET_TPU_SANITIZE``)

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
from . import engine
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import random
from .name import NameManager
from .attribute import AttrScope
from . import ops
from . import operator  # registers Custom before the creators are made
from .ndarray_ops import init_ndarray_ops
init_ndarray_ops(ndarray)
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from . import executor_manager
from . import filesystem
from . import visualization
from . import visualization as viz
from . import initializer
from . import initializer as init
from . import io
from . import io_pipeline
from . import io_cache
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
from . import test_utils
from . import xprof
from . import profiler
from . import analysis

__version__ = "0.1.0"
