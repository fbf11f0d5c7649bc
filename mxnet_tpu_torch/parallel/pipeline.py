"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``. In SPMD PyTorch each
rank of the ``pp`` axis holds one stage (the stacked params' leading
dim 1, as under ``shard_map``) and every rank passes the same
microbatches. :func:`pipeline_forward` runs the reference's schedule:
for ``num_microbatches + num_stages - 1`` ticks every rank applies its
stage to the activation it holds, then the activations move one rank on
(:func:`~._collectives._shift`, ``lax.ppermute``'s permutation). Rank 0
takes a fresh microbatch in on each of the first ``num_microbatches``
ticks; the last rank collects the outputs, and a sum over the axis
gives them to every rank.

Autograd's backward through the schedule is the reverse schedule: each
shift's backward sends the cotangent one rank back. It is a collective,
so the graph has the same shape on every rank: which rank feeds and
which collects are tensor masks (``torch.where``, as the reference's
``jnp.where``), never a Python branch on the rank.

The gradient contract (the one of the JAX package inside ``shard_map``):
every rank's gradient is that of the SUM over the axis of every rank's
loss. The final sum's adjoint sums the ranks' cotangents, so when every
rank differentiates the same loss L of the outputs, each stage's
gradient is ``num_stages`` times dL/dstage.
:func:`build_pipeline_train_step` divides by ``num_stages``, as the
reference does.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError
from ._collectives import (_check_devices, _group_rank_size, _resolve_axis,
                           _shift)
from .sharding import mesh_axis_sizes

__all__ = ["pipeline_forward", "build_pipeline_train_step",
           "stack_stage_params", "sequential_reference"]


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists
    and tuples), keeping the structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_stage_params(per_stage_params: Sequence):
    """Stack a list of per-stage trees (dicts, lists, tuples) along a new
    leading axis, as numpy arrays. Shard the leading axis on the ``pp``
    axis so each rank keeps one stage."""
    if not per_stage_params:
        raise MXNetError("need at least one stage")
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *per_stage_params)


def pipeline_forward(stage_fn: Callable, stacked_params, microbatches,
                     axis_name: str = "pp", *, group=None, mesh=None):
    """GPipe forward over microbatches on this rank's stage.

    Parameters
    ----------
    stage_fn : (stage_params, x) -> y with ``y.shape == x.shape``.
    stacked_params : a tree (dicts, lists, tuples) of tensors with
        leading dim 1: this rank's stage.
    microbatches : (num_microbatches, ...) activations, the same on
        every rank of the axis.
    axis_name : the mesh axis the stages live on, of ``mesh`` or of the
        mesh :func:`~mxnet_tpu_torch.parallel.make_mesh` built last; or
        ``group``, where given. The group's rank order is the stage
        order.

    Returns the (num_microbatches, ...) outputs of the last stage on
    every rank. Differentiable; the gradient is that of the sum over the
    axis of the ranks' losses (the module's docstring). On an axis of
    one rank nothing is sent.
    """
    group, mesh = _resolve_axis(axis_name, group, mesh)
    leaves = _leaves(stacked_params)
    _check_devices("pipeline_forward", mesh, [microbatches] + leaves)
    bad = [tuple(x.shape) for x in leaves if x.dim() == 0 or x.shape[0] != 1]
    if bad:
        raise MXNetError("pipeline_forward: this rank's stage has leading "
                         "dim 1, got shapes %s" % bad)
    params = _tree_map(lambda x: x[0], stacked_params)
    idx, num_stages = _group_rank_size(group)
    num_mb = microbatches.shape[0]
    total = num_mb + num_stages - 1
    dev = microbatches.device
    # masks made on the device: a host tensor copied in would wait for
    # the card
    first = torch.full((), idx == 0, dtype=torch.bool, device=dev)
    state = torch.zeros_like(microbatches[0])
    outputs = []
    for t in range(total):
        x = torch.where(first, microbatches[t], state) if t < num_mb \
            else state
        y = stage_fn(params, x)
        if y.shape != x.shape:
            raise MXNetError("pipeline_forward: a stage maps %s to %s; "
                             "every stage keeps its input's shape"
                             % (tuple(x.shape), tuple(y.shape)))
        if t >= num_stages - 1:
            outputs.append(y)
        if t + 1 < total:       # the last tick's activations go nowhere
            state, = _shift(group, y)
    outputs = torch.stack(outputs)
    if num_stages == 1:
        return outputs
    from torch.distributed.nn.functional import all_reduce

    # the last stage's outputs to every rank (``lax.psum``: its adjoint
    # sums the ranks' cotangents)
    last = torch.full((), idx == num_stages - 1, dtype=torch.bool,
                      device=dev)
    return all_reduce(torch.where(last, outputs, 0.0), group=group)


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def build_pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                              mesh, num_microbatches: int,
                              pp_axis: str = "pp", dp_axis: str = None,
                              lr: float = 0.01):
    """SGD train step for a pipelined trunk on a DeviceMesh.

    Returns ``step(stacked_params, microbatches, labels) -> (loss,
    new_params)``. ``stacked_params`` is this rank's stage: tensors with
    leading dim 1, or the DTensors that
    ``shard_args(mesh, stacked, {k: NamedSharding(mesh,
    PartitionSpec(pp_axis))})`` gives (the step returns the kind it was
    given). ``microbatches``/``labels`` are (num_microbatches, mb, ...):
    with ``dp_axis``, this rank's slice of the within-microbatch batch.
    ``loss_fn(outputs, labels) -> scalar`` is applied to each
    microbatch's outputs and averaged; the loss is averaged over
    ``dp_axis`` and so are the gradients, after the division by the
    number of stages (the module's docstring). ``num_microbatches``
    documents the microbatches' leading dim, as in the reference.
    """
    sizes = mesh_axis_sizes(mesh)
    for axis in (pp_axis, dp_axis):
        if axis is not None and axis not in sizes:
            raise MXNetError("build_pipeline_train_step: axis %r is not an "
                             "axis of the mesh %s"
                             % (axis, mesh.mesh_dim_names))
    num_stages = sizes[pp_axis]
    pp_group = mesh.get_group(pp_axis)
    dp_group = mesh.get_group(dp_axis) if dp_axis else None
    num_dp = sizes[dp_axis] if dp_axis else 1

    def step(stacked_params, microbatches, labels):
        from torch.distributed.tensor import DTensor

        params = _tree_map(lambda p: _local(p).detach().requires_grad_(True),
                           stacked_params)
        mb, lab = _local(microbatches), _local(labels)
        _check_devices("build_pipeline_train_step", mesh,
                       [mb, lab] + _leaves(params))
        with torch.enable_grad():
            outs = pipeline_forward(stage_fn, params, mb, group=pp_group)
            loss = torch.stack([loss_fn(outs[i], lab[i])
                                for i in range(outs.shape[0])]).mean()
            loss.backward()

        @torch.no_grad()
        def update(old, p):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            g = g / num_stages
            if dp_group is not None:
                dist.all_reduce(g, group=dp_group)
                g = g / num_dp
            new = p.detach() - lr * g
            if isinstance(old, DTensor):
                return DTensor.from_local(new, old.device_mesh,
                                          old.placements, run_check=False)
            return new

        with torch.no_grad():
            loss = loss.detach().clone()
            if dp_group is not None:
                dist.all_reduce(loss, group=dp_group)
                loss = loss / num_dp
        return loss, _tree_map(update, stacked_params, params)

    return step


def sequential_reference(stage_fn: Callable, per_stage_params: Sequence, x):
    """Oracle: apply the stages one after another on one device."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x
