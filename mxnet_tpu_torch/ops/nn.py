"""Neural-network layer operators.

Counterpart of ``mxnet_tpu/ops/nn.py``: FullyConnected, Activation,
LeakyReLU, Convolution, Deconvolution, Pooling, BatchNorm, LRN,
L2Normalization, UpSampling, Dropout, SoftmaxOutput, SoftmaxActivation,
SVMOutput, Embedding and the regression outputs (Linear, Logistic,
MAE), with the
same parameters (names, defaults, string forms) so the JSON of a graph
reads the same in both packages. Every op is differentiable under
autograd, which is how the executor's backward runs.

The forward of a convolution and the matrix products stay plain torch
(cuDNN and cuBLAS), as the JAX package leaves them to XLA. The backward
of every 2-D convolution runs the hand-written GEMM kernel through
``kernels.conv2d``; 1-D and 3-D convolutions keep torch's autograd, as
the JAX package routes only 2-D ones to Pallas. BatchNorm's
channels-last apply goes through the hand-written kernels
``kernels.fused_norm_act`` (forward K4, backward K5) every time; NCHW
keeps the plain ``x * scale + shift``. SoftmaxOutput's gradient is its
own autograd.Function, ``(softmax - onehot) * grad_scale``, and so is
each regression output's, the loss gradient of the label.

Layouts: NCHW is the default; ``layout="NHWC"`` keeps channels last.
An NHWC tensor is handed to the convolution as the permuted view
``x.movedim(-1, 1)``, which for a contiguous NHWC tensor already has
``channels_last`` memory, so cuDNN reads it in place and writes a
``channels_last`` result whose ``movedim(1, -1)`` is contiguous NHWC
again. If a backend hands back another layout, :data:`nhwc_copies`
counts the ``.contiguous()`` copy that restores it. Weights stay OIHW
in both layouts.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..batch_layout import batch_axis
from .kernels import conv2d, fused_norm_act
from .registry import Operator, Param, REQUIRED, register_op

#: NHWC results that needed a ``.contiguous()`` copy after a conv or pool
nhwc_copies = 0


def _nhwc_out(t: torch.Tensor) -> torch.Tensor:
    """Back from the permuted NCHW view to a contiguous NHWC tensor."""
    global nhwc_copies
    t = t.movedim(1, -1)
    if not t.is_contiguous():
        nhwc_copies += 1
        t = t.contiguous()
    return t


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------
@register_op("FullyConnected")
class FullyConnected(Operator):
    name_hint = "fullyconnected"
    PARAMS = {
        "num_hidden": Param(int, REQUIRED, "number of hidden units"),
        "no_bias": Param(bool, False, "whether to disable bias"),
    }

    def list_arguments(self):
        return ["data", "weight"] if self.no_bias \
            else ["data", "weight", "bias"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("FullyConnected: data shape unknown")
        n = data[0]
        d = int(np.prod(data[1:])) if len(data) > 1 else 1
        shapes = [data, (self.num_hidden, d)]
        if not self.no_bias:
            shapes.append((self.num_hidden,))
        return shapes, [(n, self.num_hidden)], []

    def apply(self, ctx, inputs, aux):
        data, w = inputs[0], inputs[1]
        out = torch.matmul(data.reshape(data.shape[0], -1), w.t())
        if not self.no_bias:
            out = out + inputs[2]
        return [out], []


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
}


@register_op("Activation")
class Activation(Operator):
    name_hint = "activation"
    PARAMS = {"act_type": Param(str, REQUIRED, "relu/sigmoid/tanh/softrelu")}

    def apply(self, ctx, inputs, aux):
        fn = _ACTIVATIONS.get(self.act_type)
        if fn is None:
            raise MXNetError("unknown act_type %s" % self.act_type)
        return [fn(inputs[0])], []


@register_op("LeakyReLU")
class LeakyReLU(Operator):
    """``x`` where ``x > 0``, else ``slope * x`` (leaky), ``slope *
    (exp(x) - 1)`` (elu), ``gamma[c] * x`` with a learned per-channel
    ``gamma`` (prelu), or a slope drawn per element from
    U(lower_bound, upper_bound) in train mode and their mean otherwise
    (rrelu; the draw comes from the executor's generator)."""

    name_hint = "leakyrelu"
    PARAMS = {
        "act_type": Param(str, "leaky"),
        "slope": Param(float, 0.25),
        "lower_bound": Param(float, 0.125),
        "upper_bound": Param(float, 0.334),
    }

    @property
    def draws_random(self) -> bool:
        return self.act_type == "rrelu"

    def list_arguments(self):
        return ["data", "gamma"] if self.act_type == "prelu" else ["data"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("LeakyReLU: data shape unknown")
        if self.act_type == "prelu":
            return [data, (data[1],)], [data], []
        return [data], [data], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        act = self.act_type
        if act == "leaky":
            neg = self.slope * x
        elif act == "elu":
            neg = self.slope * (torch.exp(x) - 1.0)
        elif act == "prelu":
            neg = inputs[1].reshape((1, -1) + (1,) * (x.dim() - 2)) * x
        elif act == "rrelu":
            if ctx.is_train and ctx.rng is not None:
                lo, hi = self.lower_bound, self.upper_bound
                slope = torch.rand(x.shape, generator=ctx.rng,
                                   device=x.device, dtype=x.dtype) \
                    * (hi - lo) + lo
            else:
                slope = (self.lower_bound + self.upper_bound) / 2.0
            neg = slope * x
        else:
            raise MXNetError("unknown act_type %s" % act)
        return [torch.where(x > 0, x, neg)], []


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------
_VALID_LAYOUTS = {"NCW", "NWC", "NCHW", "NHWC", "NCDHW", "NDHWC"}


def _layout_is_nhwc(layout):
    """Validate + classify a layout string: channels-last -> True."""
    if layout is None:
        return False
    lay = str(layout).upper()
    if lay not in _VALID_LAYOUTS:
        raise MXNetError("unsupported layout '%s' (supported: %s)"
                         % (layout, sorted(_VALID_LAYOUTS)))
    return lay.endswith("C")


def _conv_out_dim(x, k, s, p, d):
    dk = d * (k - 1) + 1
    return (x + 2 * p - dk) // s + 1


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register_op("Convolution")
class Convolution(Operator):
    name_hint = "convolution"
    PARAMS = {
        "kernel": Param("shape", REQUIRED, "(kh, kw)"),
        "num_filter": Param(int, REQUIRED),
        "stride": Param("shape", None),
        "pad": Param("shape", None),
        "dilate": Param("shape", None),
        "num_group": Param(int, 1),
        "no_bias": Param(bool, False),
        "workspace": Param(int, 512, "ignored"),
        "cudnn_tune": Param(str, None, "ignored"),
        "layout": Param(str, None, "NCHW (default) or NHWC"),
    }

    def _is_nhwc(self):
        return _layout_is_nhwc(self.layout)

    def list_arguments(self):
        return ["data", "weight"] if self.no_bias \
            else ["data", "weight", "bias"]

    def _norm_params(self):
        nd = len(self.kernel)
        return (self.kernel, self.stride or (1,) * nd, self.pad or (0,) * nd,
                self.dilate or (1,) * nd)

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Convolution: data shape unknown")
        kernel, stride, pad, dilate = self._norm_params()
        if len(data) != len(kernel) + 2:
            raise MXNetError("Convolution: data must be N,C,spatial*%d"
                             % len(kernel))
        nhwc = self._is_nhwc()
        n = data[0]
        c = data[-1] if nhwc else data[1]
        sp_in = data[1:-1] if nhwc else data[2:]
        wshape = (self.num_filter, c // self.num_group) + tuple(kernel)
        out_sp = tuple(_conv_out_dim(sp_in[i], kernel[i], stride[i],
                                     pad[i], dilate[i])
                       for i in range(len(kernel)))
        shapes = [data, wshape]
        if not self.no_bias:
            shapes.append((self.num_filter,))
        out = (n,) + out_sp + (self.num_filter,) if nhwc \
            else (n, self.num_filter) + out_sp
        return shapes, [out], []

    def apply(self, ctx, inputs, aux):
        kernel, stride, pad, dilate = self._norm_params()
        conv = _CONV.get(len(kernel))
        if conv is None:
            raise MXNetError("unsupported spatial rank %d" % len(kernel))
        x = inputs[0]
        nhwc = self._is_nhwc()
        if nhwc:
            x = x.movedim(-1, 1)
        if len(kernel) == 2:
            out = conv2d(x, inputs[1], stride, pad, dilate, self.num_group)
            if not self.no_bias:
                out = out + inputs[2].reshape(1, -1, 1, 1)
        else:
            out = conv(x, inputs[1], None if self.no_bias else inputs[2],
                       stride=stride, padding=pad, dilation=dilate,
                       groups=self.num_group)
        return [_nhwc_out(out) if nhwc else out], []


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("Deconvolution")
class Deconvolution(Convolution):
    """Transposed convolution; weight (C_in, num_filter / num_group,
    *kernel), the layout of ``conv_transpose``. Output
    ``(i - 1) * stride - 2 * pad + dilate * (k - 1) + 1`` an axis, the
    JAX op's rule (``mxnet_tpu/ops/nn.py:307-308`` with its dilated
    kernel at ``:330-332``), which is ``conv_transpose``'s with no
    output padding."""

    name_hint = "deconvolution"

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Deconvolution: data shape unknown")
        kernel, stride, pad, dilate = self._norm_params()
        nhwc = self._is_nhwc()
        n = data[0]
        c = data[-1] if nhwc else data[1]
        sp_in = data[1:-1] if nhwc else data[2:]
        wshape = (c, self.num_filter // self.num_group) + tuple(kernel)
        out_sp = tuple((sp_in[i] - 1) * stride[i] - 2 * pad[i]
                       + dilate[i] * (kernel[i] - 1) + 1
                       for i in range(len(kernel)))
        shapes = [data, wshape]
        if not self.no_bias:
            shapes.append((self.num_filter,))
        out = (n,) + out_sp + (self.num_filter,) if nhwc \
            else (n, self.num_filter) + out_sp
        return shapes, [out], []

    def apply(self, ctx, inputs, aux):
        kernel, stride, pad, dilate = self._norm_params()
        nd = len(kernel)
        conv_t = _CONV_T.get(nd)
        if conv_t is None:
            raise MXNetError("unsupported spatial rank %d" % nd)
        x = inputs[0]
        nhwc = self._is_nhwc()
        if nhwc:
            x = x.movedim(-1, 1)
        out = conv_t(x, inputs[1], None if self.no_bias else inputs[2],
                     stride=stride, padding=pad, groups=self.num_group,
                     dilation=dilate)
        return [_nhwc_out(out) if nhwc else out], []


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register_op("Pooling")
class Pooling(Operator):
    """max pads with -inf; avg divides by the full kernel, padding
    included (count_include_pad), with floor output sizes; sum is avg
    times the kernel size; global_pool takes its kernel from the input."""

    name_hint = "pooling"
    PARAMS = {
        "kernel": Param("shape", REQUIRED),
        "pool_type": Param(str, "max", "max/avg/sum"),
        "stride": Param("shape", None),
        "pad": Param("shape", None),
        "global_pool": Param(bool, False),
        "layout": Param(str, None, "NCHW (default) or NHWC"),
    }

    def _is_nhwc(self):
        return _layout_is_nhwc(self.layout)

    def _sp_base(self):
        return 1 if self._is_nhwc() else 2

    def _norm(self, data_shape):
        nd = len(self.kernel)
        base = self._sp_base()
        if self.global_pool:
            kernel = tuple(data_shape[base + i] for i in range(nd))
            return kernel, (1,) * nd, (0,) * nd
        return self.kernel, self.stride or (1,) * nd, self.pad or (0,) * nd

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Pooling: data shape unknown")
        kernel, stride, pad = self._norm(data)
        base = self._sp_base()
        if self.global_pool:
            out_sp = (1,) * len(kernel)
        else:
            out_sp = tuple(
                (data[base + i] + 2 * pad[i] - kernel[i]) // stride[i] + 1
                for i in range(len(kernel)))
        if self._is_nhwc():
            out = (data[0],) + out_sp + (data[-1],)
        else:
            out = data[:2] + out_sp
        return [data], [out], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        kernel, stride, pad = self._norm(x.shape)
        nd = len(kernel)
        nhwc = self._is_nhwc()
        if self.pool_type not in ("max", "avg", "sum"):
            raise MXNetError("unknown pool_type %s" % self.pool_type)
        if self.global_pool:
            dims = tuple(range(self._sp_base(), self._sp_base() + nd))
            if self.pool_type == "max":
                return [x.amax(dim=dims, keepdim=True)], []
            out = x.sum(dim=dims, keepdim=True)
            if self.pool_type == "avg":
                out = out / float(math.prod(kernel))
            return [out], []
        if nhwc:
            x = x.movedim(-1, 1)
        native = all(p <= k // 2 for p, k in zip(pad, kernel))
        if not native:
            # torch pads implicitly only up to half the kernel; beyond
            # that pad explicitly, with the value each pool type implies
            fill = -math.inf if self.pool_type == "max" else 0.0
            x = F.pad(x, [p for p in reversed(pad) for _ in (0, 1)],
                      value=fill)
            pad = (0,) * nd
        if self.pool_type == "max":
            out = _MAX_POOL[nd](x, kernel, stride, pad)
        else:
            out = _AVG_POOL[nd](x, kernel, stride, pad,
                                count_include_pad=True)
            if self.pool_type == "sum":
                out = out * float(math.prod(kernel))
        return [_nhwc_out(out) if nhwc else out], []


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
@register_op("BatchNorm", aliases=("CuDNNBatchNorm",))
class BatchNorm(Operator):
    """Batch statistics in train mode (one pass in f32: var = E[x^2] -
    E[x]^2, biased), the moving statistics otherwise. The affine is
    folded into one per-channel scale/shift rounded to x.dtype, as the
    JAX op does (``ops/nn.py:487-498``); channels-last applies it with
    the fused_norm_act kernels, which widen scale/shift back to f32.
    Gradients flow through the batch statistics; the new moving
    statistics are detached, and the executor commits them on backward."""

    name_hint = "batchnorm"
    PARAMS = {
        "eps": Param(float, 1e-3),
        "momentum": Param(float, 0.9),
        "fix_gamma": Param(bool, True),
        "use_global_stats": Param(bool, False),
        "axis": Param(int, 1, "channel axis (1 = NCHW; -1 for NHWC)"),
    }

    def list_arguments(self):
        return ["data", "gamma", "beta"]

    def list_auxiliary_states(self):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("BatchNorm: data shape unknown")
        c = (data[self.axis],)
        return [data, c, c], [data], [c, c]

    def _axes(self, x):
        caxis = self.axis % x.dim()
        return caxis, [i for i in range(x.dim()) if i != caxis]

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if ctx.is_train and not self.use_global_stats:
            _, axes = self._axes(x)
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            return self._normalize(True, inputs, aux, x32.mean(dim=axes),
                                   (x32 * x32).mean(dim=axes))
        return self._normalize(False, inputs, aux)

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts. In train
        mode each replica's float32 ``sum x`` and ``sum x^2`` by channel
        (one (2C,) tensor) are summed across the replicas by one
        autograd-aware cross-card sum before the mean and the variance, so
        the statistics, the moving statistics and the gradients are those
        of the global batch; otherwise each replica runs :meth:`apply`."""
        reps = ctxs[0].replicas
        if not (ctxs[0].is_train and not self.use_global_stats):
            return reps.each(self.apply, ctxs, inputs, aux)
        parts = []
        for k, (x, _, _) in enumerate(inputs):
            with reps.on(k):
                _, axes = self._axes(x)
                x32 = x.to(torch.promote_types(x.dtype, torch.float32))
                parts.append(torch.cat([x32.sum(dim=axes),
                                        (x32 * x32).sum(dim=axes)]))
        caxis, _ = self._axes(inputs[0][0])
        count = reps.procs * sum(x.numel() // x.shape[caxis]
                                 for x, _, _ in inputs)
        totals = reps.all_sum(parts)
        outs, new_aux = [], []
        for k in range(reps.n):
            with reps.on(k):
                mean, meansq = (totals[k] / count).chunk(2)
                o, a = self._normalize(True, inputs[k], aux[k], mean, meansq)
            outs.append(o)
            new_aux.append(a)
        return outs, new_aux

    def _normalize(self, batch_stats, inputs, aux, mean=None, meansq=None):
        """The output and the new moving statistics, from the batch's
        ``mean`` and ``meansq`` (float32) or from the moving ones."""
        x, gamma, beta = inputs
        moving_mean, moving_var = aux
        caxis, _ = self._axes(x)
        bshape = [-1 if i == caxis else 1 for i in range(x.dim())]
        if self.fix_gamma:
            gamma = torch.ones_like(gamma)
        if batch_stats:
            var = torch.clamp_min(meansq - mean * mean, 0.0)
            m = self.momentum
            new_aux = [moving_mean * m
                       + mean.detach().to(moving_mean.dtype) * (1 - m),
                       moving_var * m
                       + var.detach().to(moving_var.dtype) * (1 - m)]
        else:
            mean, var = moving_mean, moving_var
            new_aux = [moving_mean, moving_var]
        inv = torch.rsqrt(var + self.eps)
        g = gamma.to(inv.dtype)
        scale = (g * inv).to(x.dtype)
        shift = (beta.to(inv.dtype) - mean * g * inv).to(x.dtype)
        if caxis == x.dim() - 1:
            out = fused_norm_act(x, scale, shift, "none")
        else:
            out = x * scale.reshape(bshape) + shift.reshape(bshape)
        return [out], new_aux


# ---------------------------------------------------------------------------
# LRN
# ---------------------------------------------------------------------------
@register_op("LRN")
class LRN(Operator):
    """Cross-channel local response normalization: ``x / (knorm + alpha
    / nsize * sum(x^2)) ** beta``, the sum over a window of ``nsize``
    channels padded ``nsize // 2`` before and ``nsize - 1 - nsize // 2``
    after, as the JAX op's ``reduce_window`` (``ops/nn.py:784-805``).
    A plain op in both packages; its gradient is autograd's."""

    name_hint = "lrn"
    PARAMS = {
        "alpha": Param(float, 1e-4),
        "beta": Param(float, 0.75),
        "knorm": Param(float, 2.0),
        "nsize": Param(int, REQUIRED),
    }

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        half = self.nsize // 2
        sq = F.pad((x * x).movedim(1, -1), (half, self.nsize - 1 - half))
        ssum = sq.unfold(-1, self.nsize, 1).sum(-1).movedim(-1, 1)
        denom = (self.knorm + (self.alpha / self.nsize) * ssum) ** self.beta
        return [x / denom], []


@register_op("L2Normalization")
class L2Normalization(Operator):
    """``x / sqrt(sum(x^2) + eps)`` over every axis after the first
    (instance), axis 1 (channel) or the spatial axes (spatial)."""

    name_hint = "l2normalization"
    PARAMS = {
        "eps": Param(float, 1e-10),
        "mode": Param(str, "instance"),
    }

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if self.mode == "instance":
            axes = tuple(range(1, x.dim()))
        elif self.mode == "channel":
            axes = (1,)
        elif self.mode == "spatial":
            axes = tuple(range(2, x.dim()))
        else:
            raise MXNetError("unknown mode %s" % self.mode)
        norm = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True)
                          + self.eps)
        return [x / norm], []


@register_op("UpSampling")
class UpSampling(Operator):
    """Nearest-neighbour upsampling of every axis after the channel by an
    integer ``scale`` (bilinear is a Deconvolution, in both packages)."""

    name_hint = "upsampling"
    PARAMS = {
        "scale": Param(int, REQUIRED),
        "sample_type": Param(str, "nearest"),
        "num_args": Param(int, 1),
    }

    def list_arguments(self):
        return ["data"] if self.num_args == 1 else \
            ["arg%d" % i for i in range(self.num_args)]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("UpSampling: data shape unknown")
        return [data], [data[:2] + tuple(s * self.scale
                                         for s in data[2:])], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        for ax in range(2, x.dim()):
            x = x.repeat_interleave(self.scale, dim=ax)
        return [x], []


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
@register_op("Dropout")
class Dropout(Operator):
    """The identity at inference; in train mode a Bernoulli keep-mask
    drawn from the executor's generator."""

    name_hint = "dropout"
    PARAMS = {"p": Param(float, 0.5)}

    @property
    def draws_random(self) -> bool:
        return self.p > 0.0

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not ctx.is_train or self.p <= 0.0 or ctx.rng is None:
            return [x], []
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=ctx.rng, device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros_like(x))], []


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------
class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; backward ``(softmax - onehot(label)) *
    grad_scale`` with ignore_label and the null/batch/valid
    normalizations, ignoring the head gradient; the label's gradient is
    zero (``mxnet_tpu/ops/nn.py:588-619``)."""

    @staticmethod
    def forward(ctx, data, label, op, norm=None):
        axis = 1 if op.multi_output else -1
        out = torch.softmax(data, dim=axis)
        ctx.op = op
        ctx.norm = norm
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        op = ctx.op
        caxis = 1 if op.multi_output else out.dim() - 1
        lab = label.to(torch.int64).unsqueeze(caxis)
        shape = [1] * out.dim()
        shape[caxis] = out.shape[caxis]
        classes = torch.arange(out.shape[caxis], device=out.device)
        # an out-of-range label (ignore_label -1) gives a zero row, as
        # jax.nn.one_hot does
        onehot = (lab == classes.reshape(shape)).to(out.dtype)
        grad = out - onehot
        if op.use_ignore:
            valid = label != op.ignore_label
            grad = grad * valid.unsqueeze(caxis).to(out.dtype)
        if ctx.norm is not None:
            # the global batch's divisor (a group over several contexts)
            grad = grad / ctx.norm
        elif op.normalization == "batch":
            grad = grad / out.shape[0]
        elif op.normalization == "valid":
            grad = grad / torch.clamp_min(_valid(op, label, out.dtype).sum(),
                                          1.0)
        grad = grad * op.grad_scale
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(out.dtype), dlabel, None, None


def _valid(op, label, dtype):
    """1 where a label counts toward the ``valid`` normalization."""
    if op.use_ignore:
        return (label != op.ignore_label).to(dtype)
    return torch.ones(label.shape, dtype=dtype, device=label.device)


@register_op("SoftmaxOutput", aliases=["Softmax"])
class SoftmaxOutput(Operator):
    """Forward is softmax(data) over the last axis (axis 1 with
    multi_output); backward is the fused cross-entropy gradient
    ``(softmax - one_hot(label)) * grad_scale``, ignoring the head
    gradient (which is why training loops call ``backward()`` with no
    head grads)."""

    name_hint = "softmax"
    PARAMS = {
        "grad_scale": Param(float, 1.0),
        "ignore_label": Param(float, -1.0),
        "multi_output": Param(bool, False),
        "use_ignore": Param(bool, False),
        "preserve_shape": Param(bool, False,
                                "softmax over the last axis of an N-d "
                                "input with (shape[:-1]) labels"),
        "normalization": Param(str, "null", "null/batch/valid"),
    }

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SoftmaxOutput: data shape unknown")
        if self.multi_output:
            label = (data[0],) + tuple(data[2:])
        elif self.preserve_shape:
            label = tuple(data[:-1])
        else:
            label = (data[0],)
        return [data, label], [data], []

    def apply(self, ctx, inputs, aux):
        return [_SoftmaxOutput.apply(inputs[0], inputs[1], self)], []

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts: the
        ``batch`` and ``valid`` normalizations divide by the global batch's
        rows and valid labels (the latter summed across the replicas in
        the forward); ``null`` is each replica's own. ``batch`` is the
        global data's first axis: the replicas' lengths summed where that
        axis holds the batch, one replica's where it does not."""
        reps = ctxs[0].replicas
        if self.normalization not in ("batch", "valid"):
            return reps.each(self.apply, ctxs, inputs, aux)
        if self.normalization == "batch":
            axis = batch_axis(layouts[0] if layouts is not None else 0,
                              self.op_name)
            rows = inputs[0][0].shape[0] if axis != 0 else \
                reps.procs * sum(d.shape[0] for d, _ in inputs)
            norms = [rows] * reps.n
        else:
            counts = []
            for k, (data, label) in enumerate(inputs):
                with reps.on(k):
                    counts.append(_valid(self, label, data.dtype).sum()
                                  .reshape(1))
            reps.sum_(counts)
            norms = [torch.clamp_min(c[0], 1.0) for c in counts]
        outs = []
        for k, ((data, label), norm) in enumerate(zip(inputs, norms)):
            with reps.on(k):
                outs.append([_SoftmaxOutput.apply(data, label, self, norm)])
        return outs, [[] for _ in inputs]


@register_op("SoftmaxActivation")
class SoftmaxActivation(Operator):
    """Softmax over the last axis (instance) or axis 1 (channel), with
    its true gradient."""

    name_hint = "softmaxactivation"
    PARAMS = {"mode": Param(str, "instance", "instance/channel")}

    def apply(self, ctx, inputs, aux):
        axis = 1 if self.mode == "channel" else -1
        return [torch.softmax(inputs[0], dim=axis)], []


class _SVMOutput(torch.autograd.Function):
    """The identity forward; backward the hinge-loss gradient of the
    label, ignoring the head gradient: with ``s`` +1 at the label's class
    and -1 elsewhere, ``-s * [margin - s x > 0]`` (L1) or ``-2 s *
    max(margin - s x, 0)`` (L2), times ``regularization_coefficient``
    (``mxnet_tpu/ops/nn.py:719-737``)."""

    @staticmethod
    def forward(ctx, data, label, op):
        ctx.op = op
        ctx.save_for_backward(data, label)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        op = ctx.op
        classes = torch.arange(data.shape[1], device=data.device)
        onehot = (label.to(torch.int64)[:, None]
                  == classes[None, :]).to(data.dtype)
        sign = 2.0 * onehot - 1.0
        gap = op.margin - sign * data
        if op.use_linear:
            grad = -sign * (gap > 0).to(data.dtype)
        else:
            grad = -2.0 * sign * torch.clamp_min(gap, 0.0)
        grad = grad * op.regularization_coefficient
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(data.dtype), dlabel, None


@register_op("SVMOutput")
class SVMOutput(Operator):
    """Hinge-loss output layer: forward the identity."""

    name_hint = "svmoutput"
    PARAMS = {
        "margin": Param(float, 1.0),
        "regularization_coefficient": Param(float, 1.0),
        "use_linear": Param(bool, False),
    }

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SVMOutput: data shape unknown")
        return [data, (data[0],)], [data], []

    def apply(self, ctx, inputs, aux):
        return [_SVMOutput.apply(inputs[0], inputs[1], self)], []


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
@register_op("Embedding")
class Embedding(Operator):
    """Rows of ``weight`` (input_dim, output_dim) at the ids in ``data``,
    cast toward zero to integers. As the JAX op's ``jnp.take``: an id in
    [-input_dim, 0) counts from the end, and an id outside
    [-input_dim, input_dim) gives a row of NaN (no device assert). The
    gradient is ``F.embedding``'s dense backward, which sums in a fixed
    order."""

    name_hint = "embedding"
    PARAMS = {
        "input_dim": Param(int, REQUIRED),
        "output_dim": Param(int, REQUIRED),
    }

    def list_arguments(self):
        return ["data", "weight"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Embedding: data shape unknown")
        return ([data, (self.input_dim, self.output_dim)],
                [tuple(data) + (self.output_dim,)], [])

    def infer_type(self, in_types, out_types=None):
        # the ids keep their own dtype; weight and output share theirs
        data_t, weight_t = in_types
        out_t = (out_types or [None])[0]
        w = weight_t if weight_t is not None else out_t
        return [data_t, w], [w], []

    def apply(self, ctx, inputs, aux):
        data, weight = inputs
        n = self.input_dim
        idx = data.detach().to(torch.int64)
        valid = (idx >= -n) & (idx < n)
        safe = torch.where(valid, torch.remainder(idx, n),
                           torch.zeros_like(idx))
        out = F.embedding(safe, weight)
        return [torch.where(valid.unsqueeze(-1), out,
                            torch.full_like(out, math.nan))], []


# ---------------------------------------------------------------------------
# regression outputs
# ---------------------------------------------------------------------------
class _RegressionOutput(torch.autograd.Function):
    """``transform(data)`` forward; backward ``grad_fn(out, label) *
    grad_scale / n``, ``n`` the size of one example (the product of the
    output's axes after the first), ignoring the head gradient; the
    label's gradient is zero (``mxnet_tpu/ops/nn.py:635-664``)."""

    @staticmethod
    def forward(ctx, data, label, op):
        out = op.transform(data)
        ctx.op = op
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        op = ctx.op
        num = float(np.prod(out.shape[1:])) or 1.0
        grad = op.grad_fn(out, label.reshape(out.shape)) \
            * (op.grad_scale / num)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(out.dtype), dlabel, None


class _RegressionOp(Operator):
    """Base of the regression outputs: forward transforms the data, and
    the backward is the loss gradient of the label, whatever the head
    gradient (reference regression_output-inl.h). The label takes the
    data's shape."""

    PARAMS = {"grad_scale": Param(float, 1.0)}
    transform = staticmethod(lambda x: x)
    grad_fn = staticmethod(lambda out, label: out - label)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("%s: data shape unknown" % type(self).__name__)
        return [data, data], [data], []

    def apply(self, ctx, inputs, aux):
        return [_RegressionOutput.apply(inputs[0], inputs[1], self)], []


@register_op("LinearRegressionOutput")
class LinearRegressionOutput(_RegressionOp):
    name_hint = "linearregressionoutput"


@register_op("LogisticRegressionOutput")
class LogisticRegressionOutput(_RegressionOp):
    name_hint = "logisticregressionoutput"
    transform = staticmethod(torch.sigmoid)


@register_op("MAERegressionOutput")
class MAERegressionOutput(_RegressionOp):
    name_hint = "maeregressionoutput"
    grad_fn = staticmethod(lambda out, label: torch.sign(out - label))
