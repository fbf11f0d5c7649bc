"""Sequence operators and the fused RNN, counterpart of
``mxnet_tpu/ops/seq.py``.

SequenceLast, SequenceMask and SequenceReverse take per-example lengths
along the time-major axis. RNN (modes rnn_relu, rnn_tanh, lstm, gru;
bidirectional; dropout between layers) reads one flat ``parameters``
vector in the JAX package's layout (:func:`rnn_param_size`): per layer,
then per direction, W_x (G*H, in), W_h (G*H, H), b_x and b_h. The gate
orders are cuDNN's (i, f, g, o for LSTM; r, z, n with ``r * (W_hn h +
b_hn)`` for GRU), so views of that vector go to ``torch._VF``'s RNN
functions unpermuted: cuDNN on a card, the native loop on the CPU. The
JAX package computes the op with ``lax.scan`` and no Pallas kernel, so
this is not the port of a TPU kernel. :func:`rnn_plain` is the JAX
package's per-step cell in torch, a second oracle for the tests and for
chip_smoke on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import Operator, Param, REQUIRED, register_op


# ---------------------------------------------------------------------------
# sequence_* ops
# ---------------------------------------------------------------------------
class _SeqBase(Operator):
    PARAMS = {"use_sequence_length": Param(bool, False)}

    def list_arguments(self):
        if self.use_sequence_length:
            return ["data", "sequence_length"]
        return ["data"]

    def _in_shapes(self, data):
        if self.use_sequence_length:
            return [data, (data[1],)]
        return [data]


@register_op("SequenceLast")
class SequenceLast(_SeqBase):
    """The last valid step of each sequence: ``data[len - 1, n]`` (the
    length clipped to [1, T]), or ``data[-1]``."""

    name_hint = "sequencelast"

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SequenceLast: data shape unknown")
        return self._in_shapes(data), [tuple(data[1:])], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not self.use_sequence_length:
            return [x[-1]], []
        idx = (inputs[1].detach().to(torch.int64) - 1).clamp(0, x.shape[0] - 1)
        return [x[idx, torch.arange(x.shape[1], device=x.device)]], []


@register_op("SequenceMask")
class SequenceMask(_SeqBase):
    """Steps at or past each sequence's length set to ``value``."""

    name_hint = "sequencemask"
    PARAMS = dict(_SeqBase.PARAMS, value=Param(float, 0.0))

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SequenceMask: data shape unknown")
        return self._in_shapes(data), [data], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not self.use_sequence_length:
            return [x], []
        lengths = inputs[1].detach().to(torch.int64)
        t = torch.arange(x.shape[0], device=x.device)[:, None]
        mask = (t < lengths[None, :]).reshape(
            (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2))
        return [torch.where(mask, x, torch.full_like(x, self.value))], []


@register_op("SequenceReverse")
class SequenceReverse(_SeqBase):
    """Each sequence's valid prefix reversed in place; steps past its
    length stay where they are."""

    name_hint = "sequencereverse"

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SequenceReverse: data shape unknown")
        return self._in_shapes(data), [data], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not self.use_sequence_length:
            return [torch.flip(x, [0])], []
        lengths = inputs[1].detach().to(torch.int64)[None, :]
        t = torch.arange(x.shape[0], device=x.device)[:, None]
        src = torch.where(t < lengths, lengths - 1 - t, t)
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        return [x[src, cols]], []


# ---------------------------------------------------------------------------
# fused RNN
# ---------------------------------------------------------------------------
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_VF_FN = {"rnn_relu": "rnn_relu", "rnn_tanh": "rnn_tanh", "lstm": "lstm",
          "gru": "gru"}


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   bidirectional: bool, mode: str) -> int:
    """Total flat parameter count. Layout (contiguous, per layer then per
    direction): W_x (G*H, in), W_h (G*H, H), b_x (G*H), b_h (G*H)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_size + state_size + 2)
    return size


def rnn_weights(params, mode, num_layers, input_size, state_size,
                bidirectional):
    """Views of the flat ``params`` vector: per layer, per direction, the
    list [W_x, W_h, b_x, b_h] (the order ``torch._VF``'s RNNs read)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    h = state_size
    offset = 0
    layers = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else h * dirs
        per_dir = []
        for _ in range(dirs):
            entry = []
            for shape in ((gates * h, in_size), (gates * h, h),
                          (gates * h,), (gates * h,)):
                size = int(np.prod(shape))
                entry.append(params.narrow(0, offset, size).view(shape))
                offset += size
            per_dir.append(entry)
        layers.append(per_dir)
    return layers


def _dropout(x, p, rng):
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _cell(mode, x_proj, h_prev, c_prev, wh, bh):
    """One step of the JAX package's ``_cell`` (``ops/seq.py:207-244``):
    returns (h, c), c None but for LSTM."""
    if mode in ("rnn_relu", "rnn_tanh"):
        pre = x_proj + h_prev @ wh.t() + bh
        return (torch.relu(pre) if mode == "rnn_relu"
                else torch.tanh(pre)), None
    if mode == "lstm":
        gates = x_proj + h_prev @ wh.t() + bh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        hw = h_prev @ wh.t() + bh
        xr, xz, xn = x_proj.chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h_prev, None
    raise MXNetError("unknown RNN mode %s" % mode)


def rnn_plain(data, params, state, state_cell, mode, num_layers,
              state_size, bidirectional=False):
    """The RNN as the JAX package writes it: the input projection of a
    whole sequence at once, then a Python loop over time steps with
    :func:`_cell`; no dropout. Returns (output, h_n, c_n or None)."""
    t_len, _, input_size = data.shape
    dirs = 2 if bidirectional else 1
    layers = rnn_weights(params, mode, num_layers, input_size, state_size,
                         bidirectional)
    x = data
    h_fin, c_fin = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            wx, wh, bx, bh = layers[layer][d]
            sidx = layer * dirs + d
            h = state[sidx]
            c = state_cell[sidx] if mode == "lstm" else None
            seq = x if d == 0 else torch.flip(x, [0])
            proj = torch.einsum("tni,gi->tng", seq, wx) + bx
            hs = []
            for step in range(t_len):
                h, c = _cell(mode, proj[step], h, c, wh, bh)
                hs.append(h)
            hs = torch.stack(hs)
            outs.append(hs if d == 0 else torch.flip(hs, [0]))
            h_fin.append(h)
            c_fin.append(c)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    return (x, torch.stack(h_fin),
            torch.stack(c_fin) if mode == "lstm" else None)


@register_op("RNN")
class RNN(Operator):
    """Time-major (T, N, in) multi-layer RNN. ``p`` > 0 drops out
    between layers in train mode, drawing from the executor's generator
    (never torch's global one): the layers then run one ``_VF`` call
    each."""

    name_hint = "rnn"
    PARAMS = {
        "state_size": Param(int, REQUIRED),
        "num_layers": Param(int, REQUIRED),
        "mode": Param(str, REQUIRED, "rnn_relu/rnn_tanh/lstm/gru"),
        "bidirectional": Param(bool, False),
        "p": Param(float, 0.0, "dropout between layers"),
        "state_outputs": Param(bool, False),
    }

    @property
    def draws_random(self) -> bool:
        return self.p > 0.0 and self.num_layers > 1

    def list_arguments(self):
        args = ["data", "parameters", "state"]
        if self.mode == "lstm":
            args.append("state_cell")
        return args

    def list_outputs(self):
        outs = ["output"]
        if self.state_outputs:
            outs.append("state")
            if self.mode == "lstm":
                outs.append("state_cell")
        return outs

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("RNN: data shape unknown")
        if self.mode not in _GATES:
            raise MXNetError("unknown RNN mode %s" % self.mode)
        t, n, input_size = data
        dirs = 2 if self.bidirectional else 1
        h = self.state_size
        psize = rnn_param_size(self.num_layers, input_size, h,
                               self.bidirectional, self.mode)
        state_shape = (self.num_layers * dirs, n, h)
        shapes = [data, (psize,), state_shape]
        if self.mode == "lstm":
            shapes.append(state_shape)
        outs = [(t, n, h * dirs)]
        if self.state_outputs:
            outs.append(state_shape)
            if self.mode == "lstm":
                outs.append(state_shape)
        return shapes, outs, []

    def _run(self, x, hx, weights, num_layers, is_train):
        fn = getattr(torch._VF, _VF_FN[self.mode])
        flat = [w for layer in weights for entry in layer for w in entry]
        res = fn(x, hx if self.mode == "lstm" else hx[0], flat, True,
                 num_layers, 0.0, is_train, self.bidirectional, False)
        if self.mode == "lstm":
            return res[0], res[1], res[2]
        return res[0], res[1], None

    def apply(self, ctx, inputs, aux):
        data, params, state = inputs[0], inputs[1], inputs[2]
        cell = inputs[3] if self.mode == "lstm" else None
        if self.mode not in _GATES:
            raise MXNetError("unknown RNN mode %s" % self.mode)
        weights = rnn_weights(params, self.mode, self.num_layers,
                              data.shape[2], self.state_size,
                              self.bidirectional)
        dirs = 2 if self.bidirectional else 1
        drop = self.p > 0 and ctx.is_train and ctx.rng is not None
        if not drop:
            out, h_n, c_n = self._run(data, (state, cell), weights,
                                      self.num_layers, ctx.is_train)
        else:
            x, hs, cs = data, [], []
            for layer in range(self.num_layers):
                sl = slice(layer * dirs, (layer + 1) * dirs)
                x, h, c = self._run(
                    x, (state[sl], cell[sl] if cell is not None else None),
                    weights[layer:layer + 1], 1, True)
                hs.append(h)
                cs.append(c)
                if layer < self.num_layers - 1:
                    x = _dropout(x, self.p, ctx.rng)
            out, h_n = x, torch.cat(hs)
            c_n = torch.cat(cs) if self.mode == "lstm" else None
        outputs = [out]
        if self.state_outputs:
            outputs.append(h_n)
            if self.mode == "lstm":
                outputs.append(c_n)
        return outputs, []
