"""Collectives shared by sequence, pipeline and expert parallelism.

Each is an SPMD piece over one process group: every rank of the group
calls it, in the same order, with tensors of the same shapes. The
differentiable ones run their backward's exchange on the autograd
thread of the tensors' device, so every rank must also differentiate
through them in the same order (the same graph on every rank).

* :func:`_shift` moves tensors one rank along the group
  (``lax.ppermute`` with ``perm = [(j, (j + 1) % n)]``); its backward
  sends the cotangents one rank back.
* :func:`_all_to_all` trades chunk j of dim 0 with rank j
  (``lax.all_to_all`` over dim 0, tiled); its backward is another.
* :func:`_resolve_axis` names the group of a mesh axis, as every entry
  point of the parallel package resolves ``axis_name``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import MXNetError


def _group_rank_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def _exchange(tensors, group, step):
    """Send each tensor to group rank (r + step) % n and receive its
    counterpart from (r - step) % n, in one batch."""
    rank, n = _group_rank_size(group)
    g = dist.group.WORLD if group is None else group
    to = dist.get_global_rank(g, (rank + step) % n)
    frm = dist.get_global_rank(g, (rank - step) % n)
    out, ops = [], []
    for tag, t in enumerate(tensors):
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, to, group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, frm, group, tag))
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """The tensors one rank along the group in one batch; the backward
    sends the cotangents one rank back."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_exchange(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(_exchange(grads, ctx.group, -1))


def _shift(group, *tensors):
    """``tensors`` from group rank r - 1, as a tuple; rank r's own go to
    r + 1. Differentiable. On a group of one rank nothing is sent and
    the tensors come back as they are."""
    if _group_rank_size(group)[1] == 1:
        return tensors
    return _Shift.apply(group, *tensors)


def _all_to_all(x, group):
    """``all_to_all_single`` over dim 0 (chunk j to rank j; chunk j of
    the result from rank j), differentiable."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()    # empty_like would keep a permuted layout
    return all_to_all_single(torch.empty_like(x), x, group=group)


def _resolve_axis(axis_name, group, mesh):
    """``(group, mesh)`` of a call: ``group`` where given (mesh None),
    else mesh axis ``axis_name``'s group on ``mesh`` (or on the mesh
    ``make_mesh`` built last), else ``(None, None)`` (the default
    group)."""
    if group is not None or axis_name is None:
        return group, None
    if mesh is None:
        from .sharding import last_mesh

        mesh = last_mesh()
    if mesh is None:
        raise MXNetError("axis_name=%r: no mesh given and make_mesh has "
                         "built none in this process" % (axis_name,))
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise MXNetError("axis_name=%r is not an axis of the mesh %s"
                         % (axis_name, mesh.mesh_dim_names))
    return mesh.get_group(axis_name), mesh


def _check_devices(fn, mesh, tensors):
    """Every tensor on the device type of ``mesh`` (no check without a
    mesh): a collective of a CPU mesh cannot move card tensors, nor the
    other way round."""
    if mesh is None:
        return
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise MXNetError("%s: a tensor on %s, but the mesh's devices "
                             "are %s" % (fn, t.device, mesh.device_type))
