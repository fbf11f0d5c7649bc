"""Expert parallelism: a Mixture-of-Experts FFN over an ``ep`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/moe.py`` (GShard/Switch style). In
SPMD PyTorch each rank of the ``ep`` axis passes its own tokens and its
own ``num_experts / ep`` experts (the stacked expert weights' leading
dim), with the router replicated. A softmax router picks the top-k
experts of each token; each expert takes at most ``capacity`` tokens
from each rank, in token order, and the rest are dropped (Switch
semantics, the reference's routing exactly). The kept tokens are packed
into per-expert buffers, exchanged with an all-to-all, run through
their experts as batched products, exchanged back and combined,
weighted by the renormalised gates.

The reference packs and combines with one-hot products over a dense
``[S, E, C]`` tensor; here the kept (token, expert, slot) triples are
indices (``index_select`` and ``index_add``): the same drops, slots and
values, without a product over every slot.

Gradients follow the sum convention of the JAX package inside
``shard_map``: each rank's gradient is that of the SUM over the axis of
every rank's loss. The experts' gradients reach their owners through
the all-to-all's backward, already summed over every rank's tokens.
The router is replicated: each rank's router gradient covers its own
tokens only, and the caller sums it over the axis. ``aux`` is the mean
over the axis of each rank's auxiliary loss; its adjoint sums the
ranks' cotangents, so a global loss that holds ``w * aux`` once is, on
each rank, its share of the token loss plus ``w * aux / ep``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._collectives import (_all_to_all, _check_devices, _group_rank_size,
                           _resolve_axis)

__all__ = ["moe_ffn_local", "moe_reference", "init_moe_params",
           "expert_capacity"]


def expert_capacity(tokens_per_rank: int, num_experts: int,
                    top_k: int = 1, capacity_factor: float = 1.25) -> int:
    """Per-expert, per-source-rank buffer length."""
    return max(1, int(np.ceil(
        tokens_per_rank * top_k * capacity_factor / num_experts)))


def init_moe_params(rng, num_experts: int, d_model: int, d_hidden: int):
    """Router + stacked expert FFN weights (leading axis = experts), as
    numpy arrays from ``rng`` (a ``np.random.RandomState``)."""
    s = 1.0 / np.sqrt(d_model)
    return {
        "router": (rng.randn(d_model, num_experts) * s).astype(np.float32),
        "w1": (rng.randn(num_experts, d_model, d_hidden) * s).astype(
            np.float32),
        "b1": np.zeros((num_experts, d_hidden), np.float32),
        "w2": (rng.randn(num_experts, d_hidden, d_model)
               / np.sqrt(d_hidden)).astype(np.float32),
        "b2": np.zeros((num_experts, d_model), np.float32),
    }


def _softmax(logits):
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def _route(x, router, num_experts: int, top_k: int, capacity: int):
    """The reference's routing of the local tokens, as the kept slots.

    Returns ``(token, expert, slot, weight, aux)``: one entry a kept
    (token, expert) choice, ``weight`` its renormalised gate (the
    reference's ``combine[token, expert, slot]``, differentiable), and
    the Switch auxiliary loss. A choice past its expert's capacity, or
    whose gate is 0 (no entry of the reference's dispatch), is dropped.
    """
    S = x.shape[0]
    probs = _softmax(x @ router)                         # [S, E]
    eye = torch.eye(num_experts, dtype=torch.int64, device=x.device)
    counts = torch.zeros(num_experts, dtype=torch.int64, device=x.device)
    remaining = probs
    sel_prob_sum = torch.zeros(S, dtype=x.dtype, device=x.device)
    slots = []
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)         # [S], first max
        mask = eye[choice]                               # [S, E]
        gate = probs.gather(1, choice[:, None])[:, 0]
        pos = torch.cumsum(mask, dim=0) * mask - mask + counts[None, :] * mask
        pos_tok = (pos * mask).sum(dim=-1)               # [S]
        slots.append((choice, gate, pos_tok))
        counts = counts + (mask * (pos < capacity)).sum(dim=0)
        remaining = remaining * (1 - mask.to(remaining.dtype))
        sel_prob_sum = sel_prob_sum + gate

    tokens = torch.arange(S, device=x.device)
    token, expert, slot, weight = [], [], [], []
    for choice, gate, pos_tok in slots:
        w = gate / torch.clamp(sel_prob_sum, min=1e-9)  # renormalise top-k
        kept = (pos_tok < capacity) & (w > 0)
        token.append(tokens[kept])
        expert.append(choice[kept])
        slot.append(pos_tok[kept])
        weight.append(w[kept])
    token, expert, slot, weight = (torch.cat(v) for v in
                                   (token, expert, slot, weight))

    # load-balance auxiliary loss (Switch eq. 4): E * sum_e f_e * P_e
    density = torch.bincount(expert, minlength=num_experts).to(x.dtype) \
        / max(S, 1)
    aux = num_experts * torch.sum(density * probs.mean(dim=0))
    return token, expert, slot, weight, aux


def moe_ffn_local(params: Dict, x, axis_name: str = "ep", top_k: int = 1,
                  capacity_factor: float = 1.25, *, group=None, mesh=None):
    """MoE FFN on this rank's tokens.

    ``x``: [S_local, D] this rank's tokens. ``params['w1'/'b1'/'w2'/'b2']``:
    this rank's experts (leading dim ``num_experts / ep``; rank j holds
    experts ``j * local_e`` to ``(j + 1) * local_e - 1``);
    ``params['router']``: [D, E_global], the same on every rank. The axis
    resolves as :func:`~mxnet_tpu_torch.parallel.ring_attention`'s.

    Returns ``(y [S_local, D], aux)``, ``aux`` averaged over the axis.
    Differentiable; the module's docstring says what a caller sums over
    the axis.
    """
    group, mesh = _resolve_axis(axis_name, group, mesh)
    _check_devices("moe_ffn_local", mesh, [x] + list(params.values()))
    _, n_ranks = _group_rank_size(group)
    local_e = params["w1"].shape[0]
    num_experts = local_e * n_ranks
    S, D = x.shape
    capacity = expert_capacity(S, num_experts, top_k, capacity_factor)

    token, expert, slot, weight, aux = _route(x, params["router"],
                                              num_experts, top_k, capacity)
    flat = expert * capacity + slot                      # row of [E * C, D]

    # pack: [E, C, D] per-expert buffers of local tokens
    buf = x.new_zeros((num_experts * capacity, D)).index_add(
        0, flat, x.index_select(0, token))
    buf = buf.reshape(n_ranks, local_e, capacity, D)
    if n_ranks > 1:
        buf = _all_to_all(buf, group)                    # [R, Elocal, C, D]
    # buf[j] is now the per-expert buffer that rank j packed for us
    recv = buf.transpose(0, 1).reshape(local_e, n_ranks * capacity, D)

    h = torch.relu(torch.baddbmm(params["b1"][:, None, :], recv,
                                 params["w1"]))
    out = torch.baddbmm(params["b2"][:, None, :], h, params["w2"])

    out = out.reshape(local_e, n_ranks, capacity, D).transpose(0, 1)
    if n_ranks > 1:
        out = _all_to_all(out, group)
    # out[j, le] = my tokens' outputs from global expert j*local_e+le
    out = out.reshape(num_experts * capacity, D)
    y = x.new_zeros((S, D)).index_add(
        0, token, weight[:, None] * out.index_select(0, flat))
    if n_ranks > 1:
        from torch.distributed.nn.functional import all_reduce

        aux = all_reduce(aux, group=group) / n_ranks
    return y, aux


def moe_reference(params: Dict, x, top_k: int = 1):
    """Dense oracle: every token goes to its top-k experts, no capacity
    limit, same renormalized gating. ``params`` hold ALL experts."""
    probs = _softmax(x @ params["router"])
    E = params["w1"].shape[0]
    eye = torch.eye(E, dtype=probs.dtype, device=x.device)

    # top-k selection identical to _route's iterative argmax
    remaining = probs
    sel = []
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)
        gate = probs.gather(1, choice[:, None])[:, 0]
        sel.append((choice, gate))
        remaining = remaining * (1 - eye[choice])
    total = sum(g for _, g in sel)

    all_out = torch.stack([torch.relu(x @ params["w1"][e] + params["b1"][e])
                           @ params["w2"][e] + params["b2"][e]
                           for e in range(E)])           # [E, S, D]
    y = torch.zeros_like(x)
    rows = torch.arange(x.shape[0], device=x.device)
    for choice, gate in sel:
        gn = gate / torch.clamp(total, min=1e-9)
        y = y + gn[:, None] * all_out[choice, rows]
    return y
