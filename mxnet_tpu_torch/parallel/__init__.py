"""Sequence parallelism and several processes over ``torch.distributed``.

Counterpart of the parts of ``mxnet_tpu/parallel/`` that long-context
attention and the dist kvstores need: the named mesh (:func:`make_mesh`,
:func:`mesh_axis_sizes`), ring / Ulysses attention
(:mod:`.ring_attention`), the world of several processes
(:mod:`.distributed`) and the asynchronous parameter server
(:mod:`.ps`). Data parallelism in one process is the executor group's
(several contexts, :mod:`mxnet_tpu_torch.replicas`);
the fsdp and tp recipes of ``mxnet_tpu/parallel/sharding.py`` are not
ported yet (ROADMAP Queue A, item 10c).
"""
from .sharding import make_mesh, mesh_axis_sizes
from .ring_attention import (make_ring_attention, reference_attention,
                             ring_attention, ulysses_attention)

__all__ = ["make_mesh", "mesh_axis_sizes", "make_ring_attention",
           "reference_attention", "ring_attention", "ulysses_attention"]
