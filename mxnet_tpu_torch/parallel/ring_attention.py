"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. Layout is
(B, T, H, D) at every public function. In SPMD PyTorch each rank runs
the same code on its own sequence shard (B, T/n, H, D) and gets its own
output shard; the JAX package's entry point instead takes global arrays
under ``shard_map``. Collectives run over the mesh axis's process group:

* :func:`ring_attention` keeps Q and rotates K/V around the ring, rank r
  sending to r+1 and receiving from r-1 (``lax.ppermute``'s permutation),
  with an online softmax over the blocks. The rotation is an autograd
  function whose backward sends the cotangent the other way, so the ring
  has a gradient.
* :func:`ulysses_attention` trades the sequence shard for a head shard
  with ``all_to_all_single`` (differentiable), runs full-sequence
  attention on H/n heads with the flash kernel (K2), and trades back.

On an axis of one rank there is nothing to exchange, and neither sends.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..ops import kernels
from ..ops.kernels import reference_attention

__all__ = ["ring_attention", "ulysses_attention", "reference_attention",
           "make_ring_attention"]

_IMPLS = ("ring", "ulysses")


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


class _RingShift(torch.autograd.Function):
    """K and V one step around the ring (``lax.ppermute`` with
    ``perm = [(j, (j + 1) % n)]``); the backward sends the cotangents one
    step back."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_exchange((k, v), group, 1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _exchange((gk, gv), ctx.group, -1)
        return None, gk, gv


def _resolve_group(axis_name, group, mesh):
    """The process group of a call: ``group`` where given, else mesh
    axis ``axis_name``'s group on ``mesh`` (or on the mesh
    ``make_mesh`` built last), else None (the default group)."""
    if group is not None or axis_name is None:
        return group
    if mesh is None:
        from .sharding import last_mesh

        mesh = last_mesh()
    if mesh is None:
        raise MXNetError("axis_name=%r: no mesh given and make_mesh has "
                         "built none in this process" % (axis_name,))
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise MXNetError("axis_name=%r is not an axis of the mesh %s"
                         % (axis_name, mesh.mesh_dim_names))
    return mesh.get_group(axis_name)


def ring_attention(q, k, v, axis_name=None, causal: bool = False, *,
                   group=None, mesh=None):
    """Ring attention over sequence-sharded Q/K/V: ``q/k/v`` are this
    rank's shards (B, T_local, H, D) of a sequence split in rank order
    over mesh axis ``axis_name`` (of ``mesh``, or of the mesh
    :func:`~mxnet_tpu_torch.parallel.make_mesh` built last), or over
    ``group`` where given (the default group when neither is); returns
    this rank's output shard."""
    group = _resolve_group(axis_name, group, mesh)
    my, n = _group_rank_size(group)
    b, t_local, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q_pos = my * t_local + torch.arange(t_local, device=dev)
    acc = torch.zeros((b, h, t_local, d), dtype=q.dtype, device=dev)
    m = torch.full((b, h, t_local), -math.inf, dtype=q.dtype, device=dev)
    l = torch.zeros((b, h, t_local), dtype=q.dtype, device=dev)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n                              # owner of this K/V
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits, -math.inf)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        # guard rows with no valid key yet (-inf) against NaNs
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        probs = torch.exp(logits - safe_m[..., None])
        probs = torch.where(torch.isfinite(logits), probs, 0.0)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", probs,
                                                    v_blk)
        l = l * alpha + probs.sum(dim=-1)
        m = new_m
        if i + 1 < n:
            k_blk, v_blk = _RingShift.apply(group, k_blk, v_blk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2)                          # (b, t, h, d)


def _all_to_all(x, group):
    """``all_to_all_single`` over dim 0 (chunk j to rank j; chunk j of
    the result from rank j), differentiable."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()    # empty_like would keep a permuted layout
    return all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(q, k, v, axis_name=None, causal: bool = False, *,
                      group=None, mesh=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): this rank's
    shards (B, T_local, H, D), H divisible by the axis's size, become
    the full sequence on H/n heads, run full-sequence attention there
    and go back to sequence shards. The axis resolves as
    :func:`ring_attention`'s. float32 with D <= 256 runs the flash
    kernel (K2) at any T; other dtypes and widths run
    :func:`reference_attention`, as the JAX package falls back for
    them."""
    group = _resolve_group(axis_name, group, mesh)
    _, n = _group_rank_size(group)
    b, t_local, h, d = q.shape
    if h % n:
        raise MXNetError("ulysses: num heads %d not divisible by axis %d"
                         % (h, n))

    def scatter_heads(x):
        # (b, t_local, h, d) -> (b, n*t_local, h/n, d): lax.all_to_all with
        # split_axis=2 (heads), concat_axis=1 (sequence), tiled
        if n == 1:
            return x
        x = x.reshape(b, t_local, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _all_to_all(x, group)              # (n, b, t_local, h/n, d)
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * t_local, h // n, d)

    def gather_heads(x):
        # split_axis=1 (sequence), concat_axis=2 (heads)
        if n == 1:
            return x
        x = x.reshape(b, n, t_local, h // n, d).permute(1, 0, 2, 3, 4)
        x = _all_to_all(x, group)              # (n, b, t_local, h/n, d)
        return x.permute(1, 2, 0, 3, 4).reshape(b, t_local, h, d)

    qf, kf, vf = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if qf.dtype == torch.float32 and d <= kernels.FLASH_MAX_D:
        out = kernels.flash_attention(qf, kf, vf, causal=causal)
    else:
        out = reference_attention(qf, kf, vf, causal=causal)
    return gather_heads(out)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = False,
                        impl: str = "ring"):
    """``attn(q, k, v)`` over the mesh axis ``axis_name``, by ``impl``
    "ring" or "ulysses".

    Unlike the JAX entry point, which takes global (B, T, H, D) arrays
    and shards T itself under ``shard_map``, each rank calls ``attn``
    with its own sequence shard (B, T/n, H, D), shards in rank order
    along the axis, and gets its own output shard back; on a one-rank
    axis the shard is the whole sequence."""
    if impl not in _IMPLS:
        raise MXNetError("make_ring_attention: impl must be one of %s, got %r"
                         % (list(_IMPLS), impl))
    fn = ring_attention if impl == "ring" else ulysses_attention
    group = mesh.get_group(axis_name)

    def attn(q, k, v):
        return fn(q, k, v, group=group, causal=causal)

    return attn
