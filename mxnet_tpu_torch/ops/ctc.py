"""Connectionist Temporal Classification, counterpart of
``mxnet_tpu/ops/ctc.py``: the negative log-likelihood as a log-semiring
alpha recursion over time, vectorised over the batch and the extended
label sequence, and the two ops over it.

* ``WarpCTC(data, label)`` (the warp-ctc plugin's op): the forward is a
  row softmax of ``data`` ((T*B, A), time-major blocks); the backward is
  the gradient of the summed NLL with respect to ``data``, ignoring the
  head gradient, as SoftmaxOutput does. It recomputes the NLL under
  autograd, as the JAX package takes ``jax.grad`` of it.
* ``CTCLoss`` / ``ctc_loss``: the (B,) float32 loss of (T, B, A) raw
  activations, differentiated by autograd.

Conventions: the blank is 0 and label rows are padded with it; blanks
anywhere in a row are dropped (a stable sort left-justifies the real
labels). log 0 is the finite -1e30, so no gradient turns NaN. The
recursion runs no host sync, so a CUDA graph captures it, and sums
nothing with atomics, so a rerun is bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import Operator, Param, register_op

_NEG_INF = -1e30  # finite stand-in for log(0): keeps grads NaN-free


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` moved ``k`` places right along axis 1, -1e30 shifted in."""
    pad = torch.full((a.shape[0], k), _NEG_INF, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a], dim=1)[:, :a.shape[1]]


def _logsumexp(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    return m + torch.log(sum(torch.exp(x - m) for x in xs))


def ctc_neg_log_likelihood(log_probs: torch.Tensor, labels: torch.Tensor,
                           blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, (B,) float32.

    ``log_probs``: (T, B, A) log-softmax scores. ``labels``: (B, L),
    padded with ``blank``; a row's length is its non-blank count.
    Differentiable: autograd of its sum with respect to the pre-softmax
    logits is warp-ctc's ``softmax - posterior``."""
    log_probs = log_probs.float()
    T, B, A = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    labels = labels.detach().to(torch.int32).long()
    # left-justify the non-blank labels: a stable sort of the blank mask
    # (an integer mask: bool is not sortable on every backend)
    order = torch.argsort((labels == blank).to(torch.int32), dim=1,
                          stable=True)
    labels = labels.gather(1, order)
    # the extended sequence (b, l1, b, l2, ..., b)
    ext = torch.stack([torch.full_like(labels, blank), labels],
                      dim=2).reshape(B, 2 * L)
    ext = torch.cat([ext, torch.full_like(labels[:, :1], blank)], dim=1)
    label_len = (labels != blank).sum(dim=1)                     # (B,)
    # the skip s-2 -> s only onto a non-blank unlike the previous one
    skip_ok = torch.zeros((B, S), dtype=torch.bool, device=ext.device)
    if S > 2:
        skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])

    # the emissions of every step at once, as a product with a one-hot
    # (B, A, S): exact (one 1 a column), and its backward is a product
    # too, where gather's backward would add the repeated blanks with
    # atomics in a different order each run
    onehot = (ext[:, None, :] == torch.arange(
        A, device=ext.device)[None, :, None]).to(torch.float32)
    emit = torch.einsum("tba,bas->tbs", log_probs, onehot)      # (T, B, S)
    alpha = torch.full((B, S), _NEG_INF, dtype=torch.float32,
                       device=log_probs.device)
    first = emit[0, :, :min(S, 2)]
    alpha = torch.cat([first, alpha[:, first.shape[1]:]], dim=1)
    neg = torch.full((), _NEG_INF, dtype=torch.float32,
                     device=log_probs.device)
    for t in range(1, T):
        skip = torch.where(skip_ok, _shift(alpha, 2), neg)
        alpha = _logsumexp(alpha, _shift(alpha, 1), skip) + emit[t]

    # end states: s = 2*len (trailing blank) and s = 2*len - 1 (last label)
    end = (2 * label_len)[:, None]
    a_end = alpha.gather(1, end)[:, 0]
    a_last = torch.where(label_len > 0,
                         alpha.gather(1, (end - 1).clamp(min=0))[:, 0], neg)
    return -_logsumexp(a_end, a_last)


class _WarpCTC(torch.autograd.Function):
    """Forward: row softmax. Backward: d(sum NLL)/d(data) recomputed
    under autograd; the head gradient and the label take none."""

    @staticmethod
    def forward(ctx, data, label, T, B):
        ctx.shape = (T, B)
        ctx.save_for_backward(data, label)
        return torch.softmax(data.float(), dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        T, B = ctx.shape
        with torch.enable_grad():
            d = data.detach().requires_grad_()
            lp = torch.log_softmax(d.float().reshape(T, B, -1), dim=-1)
            nll = ctc_neg_log_likelihood(lp, label.reshape(B, -1)).sum()
            grad, = torch.autograd.grad(nll, d)
        return grad.to(data.dtype), None, None, None


@register_op("WarpCTC")
class WarpCTC(Operator):
    """The warp-ctc plugin's op: forward a row softmax of ``data`` ((T*B,
    A), time-major blocks), backward the CTC gradient with respect to
    ``data``, the head gradient ignored."""

    name_hint = "warpctc"
    PARAMS = {
        "label_length": Param(int, 0, "padded label length per sequence"),
        "input_length": Param(int, 0, "time steps per sequence"),
    }

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("WarpCTC: data shape unknown")
        if len(data) != 2:
            raise MXNetError("WarpCTC: data must be 2D (T*B, alphabet)")
        if self.input_length <= 0 or data[0] % self.input_length:
            raise MXNetError("WarpCTC: rows %d not divisible by "
                             "input_length %d" % (data[0], self.input_length))
        minibatch = data[0] // self.input_length
        # the reference's flat (label_length * minibatch,) label; a
        # (minibatch, label_length) label is taken as well
        label = in_shapes[1]
        if label is None or int(np.prod(label)) != \
                minibatch * self.label_length:
            label = (minibatch * self.label_length,)
        return [data, label], [data], []

    def infer_type(self, in_types, out_types=None):
        dt = in_types[0] or (out_types[0] if out_types else None) \
            or np.float32
        return [dt, in_types[1] or np.float32], [dt], []

    def apply(self, ctx, inputs, aux):
        data, label = inputs
        T = self.input_length
        return [_WarpCTC.apply(data, label, T, data.shape[0] // T)], []


@register_op("CTCLoss", aliases=("ctc_loss",))
class CTCLoss(Operator):
    """Per-sequence CTC loss as a differentiable op: data (T, B, A) raw
    activations, label (B, L) 0-padded -> loss (B,) float32."""

    name_hint = "ctcloss"
    PARAMS = {}

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data, label = in_shapes
        if data is None:
            raise MXNetError("CTCLoss: data shape unknown")
        if len(data) != 3:
            raise MXNetError("CTCLoss: data must be (T, B, alphabet)")
        if label is None:
            raise MXNetError("CTCLoss: label shape unknown (B, L)")
        return [data, label], [(data[1],)], []

    def infer_type(self, in_types, out_types=None):
        dt = in_types[0] or (out_types[0] if out_types else None) \
            or np.float32
        return [dt, in_types[1] or np.float32], [np.float32], []

    def apply(self, ctx, inputs, aux):
        lp = torch.log_softmax(inputs[0].float(), dim=-1)
        return [ctc_neg_log_likelihood(lp, inputs[1])], []


__all__ = ["ctc_neg_log_likelihood", "WarpCTC", "CTCLoss"]
