"""Meshes, sharding rules, sharded train steps, sequence, pipeline and
expert parallelism, and several processes over ``torch.distributed``.

Counterpart of ``mxnet_tpu/parallel/``: the named mesh and the dp, fsdp
and tp sharding rules with the one-function SGD step over them
(:mod:`.sharding`), ring / Ulysses attention (:mod:`.ring_attention`),
the GPipe schedule over a ``pp`` axis (:mod:`.pipeline`), the
Mixture-of-Experts FFN over an ``ep`` axis (:mod:`.moe`), the world of
several processes (:mod:`.distributed`) and the asynchronous parameter
server (:mod:`.ps`). Data parallelism and the fsdp recipe in one process
are the executor group's (several contexts,
:mod:`mxnet_tpu_torch.replicas`).
"""
from .sharding import (make_mesh, make_param_shardings, shard_args,
                       build_sgd_train_step, ShardingRule, mesh_axis_sizes,
                       batch_spec, fsdp_param_spec, tp_param_spec,
                       batch_shard_extent, DATA_AXES)
from .ring_attention import (make_ring_attention, reference_attention,
                             ring_attention, ulysses_attention)
from .pipeline import (pipeline_forward, build_pipeline_train_step,
                       stack_stage_params, sequential_reference)
from .moe import (moe_ffn_local, moe_reference, init_moe_params,
                  expert_capacity)

__all__ = ["make_mesh", "make_param_shardings", "shard_args",
           "build_sgd_train_step", "ShardingRule", "mesh_axis_sizes",
           "batch_spec", "fsdp_param_spec", "tp_param_spec",
           "batch_shard_extent", "DATA_AXES", "make_ring_attention",
           "reference_attention", "ring_attention", "ulysses_attention",
           "pipeline_forward", "build_pipeline_train_step",
           "stack_stage_params", "sequential_reference",
           "moe_ffn_local", "moe_reference", "init_moe_params",
           "expert_capacity"]
