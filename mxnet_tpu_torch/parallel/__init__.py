"""Meshes, sharding rules, sharded train steps, sequence parallelism and
several processes over ``torch.distributed``.

Counterpart of ``mxnet_tpu/parallel/``: the named mesh and the dp, fsdp
and tp sharding rules with the one-function SGD step over them
(:mod:`.sharding`), ring / Ulysses attention (:mod:`.ring_attention`),
the world of several processes (:mod:`.distributed`) and the
asynchronous parameter server (:mod:`.ps`). Data parallelism and the
fsdp recipe in one process are the executor group's (several contexts,
:mod:`mxnet_tpu_torch.replicas`). Pipeline and MoE
(``parallel/pipeline.py``, ``moe.py``) are ROADMAP.md Queue A item 10d.
"""
from .sharding import (make_mesh, make_param_shardings, shard_args,
                       build_sgd_train_step, ShardingRule, mesh_axis_sizes,
                       batch_spec, fsdp_param_spec, tp_param_spec,
                       batch_shard_extent, DATA_AXES)
from .ring_attention import (make_ring_attention, reference_attention,
                             ring_attention, ulysses_attention)

__all__ = ["make_mesh", "make_param_shardings", "shard_args",
           "build_sgd_train_step", "ShardingRule", "mesh_axis_sizes",
           "batch_spec", "fsdp_param_spec", "tp_param_spec",
           "batch_shard_extent", "DATA_AXES", "make_ring_attention",
           "reference_attention", "ring_attention", "ulysses_attention"]
