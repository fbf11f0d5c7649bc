"""The tensor-parallel forward of serving over a ``(dp, tp)`` grid of
one process's contexts: counterpart of the JAX package's GSPMD split of
its fused inference step, whose params pack is sharded by
``tp_param_spec`` (``mxnet_tpu/fused_step.py:797-812``) and whose
outputs are pinned back to the batch sharding
(``mxnet_tpu/fused_step.py:982-1010``), so that XLA inserts the
activations' collectives inside the one dispatch.

The port has no GSPMD, so the split is explicit, one op at a time.
Every card of a ``tp`` line serves the same rows (its dp group's) and
keeps only its shard of every packed param that ``tp_param_spec``
splits (:func:`~mxnet_tpu_torch.parallel.sharding.tp_shard`); the
activations between ops stay whole within the line.

* **FullyConnected** (weight ``(out, in)``) and **Convolution** (weight
  ``(out, in, *kernel)``, either layout, ungrouped): split on ``out``,
  each card computes its output features or channels, bias added, and
  the line gathers them along the last (channel) axis; split on ``in``,
  each card multiplies or convolves its slice of the input's features
  or channels and the line sums the partial products, the bias added
  once after the sum.
* **Every other op** reading a split param (BatchNorm's gamma and beta,
  Embedding, Deconvolution, RNN, a bias whose weight is split on
  ``in``): the param's shards are gathered into a transient whole
  tensor just before the op and dropped after it, so the resident bytes
  of a card stay at its shards; :attr:`TensorParallel.gathers` and
  telemetry's ``infer.tp_gathers`` count these gathers.

A Convolution whose split dim is neither ``out`` nor ``in``, or a
grouped one, and a split param read by no op (a graph output) raise,
naming the op and the param: the split rules do not take them, and
serving them whole would not be the split that was asked for. The
collectives are :meth:`Replicas.gather_along` and
:meth:`Replicas.sum_groups` (``torch.cuda.nccl`` on cards); serving has
no backward.
"""
from __future__ import annotations

import torch

from .. import telemetry as _tel
from ..base import MXNetError
from .sharding import tp_shard_dim

__all__ = ["TensorParallel"]

#: ops whose weight (input 1) and bias (input 2) split by the rules above
_SPLIT_OPS = ("FullyConnected", "Convolution")


class TensorParallel:
    """The split forward of ``symbol`` over ``mesh`` (a ``ContextMesh``
    with a ``tp`` axis) and its replica set ``reps``. ``shapes`` maps
    every packed param that may split (labels and data excluded) to its
    whole shape. :meth:`apply` is ``make_graph_eval``'s ``node_apply``."""

    def __init__(self, symbol, mesh, reps, shapes):
        self.mesh = mesh
        self.reps = reps
        self.size = int(mesh.shape["tp"])
        self.groups = mesh.groups("tp")
        self.rank = [mesh.coords(k)["tp"] for k in range(mesh.size)]
        #: param name -> the dim its shards split
        self.dims = {}
        for name, shape in shapes.items():
            d = tp_shard_dim(shape, mesh)
            if d is not None:
                self.dims[name] = d
        #: transient whole params gathered so far (a forward gathers the
        #: same number each time)
        self.gathers = 0
        self._nodes = {}
        for node in symbol._topo():
            if node.is_variable:
                continue
            slots = [(i, self.dims[src.name], src.name)
                     for i, (src, _) in enumerate(node.inputs)
                     if src.is_variable and src.name in self.dims]
            if slots:
                self._check(node, slots)
                self._nodes[node.uid] = slots
        for node, _ in symbol._outputs:
            if node.is_variable and node.name in self.dims:
                raise MXNetError(
                    "tensor-parallel serving: param %s is split along tp "
                    "and is an output of the graph; no op reads it to "
                    "split or gather" % node.name)

    def _check(self, node, slots):
        op = node.op
        if op.op_name != "Convolution":
            return
        for slot, dim, name in slots:
            if slot != 1:
                continue
            if op.num_group != 1 or dim not in (0, 1):
                raise MXNetError(
                    "tensor-parallel serving: Convolution %s's weight %s "
                    "splits along dim %d (num_group %d); the split rule "
                    "takes the output- or input-channel dim of an "
                    "ungrouped convolution" % (node.name, name, dim,
                                               op.num_group))

    def split_dim(self, name):
        """The dim param ``name`` splits along, or None (kept whole)."""
        return self.dims.get(name)

    def _gather(self, parts, dim):
        self.gathers += 1
        _tel.inc("infer.tp_gathers")
        return self.reps.gather_along(parts, dim, self.groups)

    def apply(self, node, octx, ins, aux):
        """One node over the replicas (``ins`` a list over the replicas a
        slot): None where it reads no split param."""
        slots = self._nodes.get(node.uid)
        if slots is None:
            return None
        from ..executor import _apply_replicas

        op = node.op
        rule = op.op_name in _SPLIT_OPS
        ins = list(ins)
        split = {}
        for slot, dim, _ in slots:
            if rule and slot in (1, 2):
                split[slot] = dim
            else:
                ins[slot] = self._gather(ins[slot], dim)
        if 1 not in split:
            for slot, dim in split.items():
                ins[slot] = self._gather(ins[slot], dim)
            return _apply_replicas(op, octx, ins, aux)
        return [self._split(op, ins, split)], []

    def _split(self, op, ins, split):
        """FullyConnected or Convolution with its weight split on ``out``
        (dim 0) or ``in`` (dim 1): every replica's whole output."""
        reps, conv = self.reps, op.op_name == "Convolution"
        by_out = split[1] == 0
        bias = ins[2] if len(ins) > 2 else None
        if bias is not None and not by_out and 2 in split:
            bias = self._gather(bias, 0)
        nhwc = conv and op._is_nhwc()
        outs = []
        for k in range(reps.n):
            with reps.on(k):
                x, w = ins[0][k], ins[1][k]
                j = self.rank[k]
                if not by_out:
                    part = w.shape[1]
                    if conv:
                        x = x.narrow(-1 if nhwc else 1, j * part,
                                     part).contiguous()
                    else:
                        x = x.reshape(x.shape[0], -1).narrow(
                            1, j * part, part)
                b = None
                if by_out and bias is not None:
                    b = bias[k] if 2 in split else bias[k].narrow(
                        0, j * w.shape[0], w.shape[0])
                outs.append(_conv(op, x, w, b) if conv else _fc(x, w, b))
        axis = -1 if (nhwc or not conv) else 1
        if by_out:
            return reps.gather_along(outs, axis, self.groups)
        reps.sum_groups(outs, self.groups)
        if bias is not None:
            for k in range(reps.n):
                with reps.on(k):
                    outs[k] = outs[k] + _channels(bias[k], outs[k], axis)
        return outs


def _fc(x, w, b):
    out = torch.matmul(x.reshape(x.shape[0], -1), w.t())
    return out if b is None else out + b


def _channels(b, out, axis):
    """``b`` shaped to broadcast along ``out``'s channel ``axis``."""
    if axis == -1 or axis == out.dim() - 1:
        return b
    return b.reshape([1, -1] + [1] * (out.dim() - 2))


def _conv(op, x, w, b):
    """Convolution ``op``'s product of ``x`` (in its layout) and ``w``
    (OIHW), plus ``b`` where given, as the op's own apply computes it:
    the 2-D forward through ``kernels.conv2d``, the bias added to the
    NCHW-shaped result, NHWC restored after."""
    from ..ops import nn

    kernel, stride, pad, dilate = op._norm_params()
    nhwc = op._is_nhwc()
    if nhwc:
        x = x.movedim(-1, 1)
    if len(kernel) == 2:
        out = nn.conv2d(x, w, stride, pad, dilate, 1)
    else:
        out = nn._CONV[len(kernel)](x, w, None, stride=stride, padding=pad,
                                    dilation=dilate)
    if b is not None:
        out = out + _channels(b, out, 1)
    if nhwc:
        return nn._nhwc_out(out)
    return out.contiguous()
