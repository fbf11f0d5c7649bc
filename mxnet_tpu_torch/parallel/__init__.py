"""Sequence parallelism over ``torch.distributed``.

Counterpart of the parts of ``mxnet_tpu/parallel/`` that long-context
attention needs: the named mesh (:func:`make_mesh`,
:func:`mesh_axis_sizes`) and ring / Ulysses attention
(:mod:`.ring_attention`). The dp/fsdp/tp recipes of
``mxnet_tpu/parallel/sharding.py`` are not ported yet (ROADMAP Queue A,
item 10).
"""
from .sharding import make_mesh, mesh_axis_sizes
from .ring_attention import (make_ring_attention, reference_attention,
                             ring_attention, ulysses_attention)

__all__ = ["make_mesh", "mesh_axis_sizes", "make_ring_attention",
           "reference_attention", "ring_attention", "ulysses_attention"]
