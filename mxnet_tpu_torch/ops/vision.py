"""Vision operators, counterpart of ``mxnet_tpu/ops/vision.py``:
ROIPooling, SpatialTransformer, Correlation, the sample ops (``uniform``
/ ``_sample_uniform``, ``normal`` / ``_sample_normal``) and
softmax_cross_entropy, with the JAX package's parameters and rules.

ROIPooling runs the hand-written ``roi_pool`` kernel on the card
(:func:`kernels.roi_pool`): the reference's formulation masks the whole
feature map once per bin, which at Fast R-CNN's shape is a 29.5 GB
tensor, and its max splits a tied bin's gradient equally over the tied
positions, which the kernel keeps. SpatialTransformer gathers its four
bilinear taps (the gradient into ``data`` is torch's scatter-add) and
Correlation shifts with ``torch.roll``, wrapping around the padded map
as ``jnp.roll`` does.

The sample ops draw from the executor's generator in train and in
inference (the JAX executor hands every node a key in both modes).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .kernels import roi_pool
from .registry import Operator, Param, REQUIRED, register_op


@register_op("ROIPooling")
class ROIPooling(Operator):
    """Max-pool the features inside each scaled roi to a fixed grid.
    rois: (num_rois, 5) = [batch_idx, x1, y1, x2, y2]."""

    name_hint = "roipooling"
    PARAMS = {
        "pooled_size": Param("shape", REQUIRED, "(h, w)"),
        "spatial_scale": Param(float, REQUIRED),
    }

    def list_arguments(self):
        return ["data", "rois"]

    def infer_shape(self, in_shapes):
        data, rois = in_shapes
        if data is None or rois is None:
            raise MXNetError("ROIPooling: shapes unknown")
        ph, pw = self.pooled_size
        return [data, rois], [(rois[0], data[1], ph, pw)], []

    def apply(self, ctx, inputs, aux):
        data, rois = inputs
        return [roi_pool(data, rois.to(data.dtype), self.pooled_size,
                         self.spatial_scale)], []

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts: a roi
        names its image by its index in the whole batch, so every replica
        pools its own rois from the whole batch's feature maps, gathered
        across the replicas (an all-gather whose backward is a
        reduce-scatter)."""
        reps = ctxs[0].replicas
        maps = reps.all_gather_rows([data for data, _ in inputs])
        outs = []
        for k, ((_, rois), whole) in enumerate(zip(inputs, maps)):
            with reps.on(k):
                outs.append(self.apply(ctxs[k], [whole, rois], [])[0])
        return outs, [[] for _ in inputs]


def _linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32 with JAX's arithmetic:
    ``-1 * (1 - s) + 1 * s`` for ``s = i / (n - 1)``, the end point
    exact."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, JAX divides
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / torch.tensor(
        float(n - 1), device=device)
    head = -(1.0 - s) + s
    return torch.cat([head, torch.ones(1, device=device)])


@register_op("SpatialTransformer")
class SpatialTransformer(Operator):
    """Affine spatial transformer with bilinear sampling
    (transform_type=affine, sampler=bilinear)."""

    name_hint = "spatialtransformer"
    PARAMS = {
        "target_shape": Param("shape", REQUIRED, "(h, w)"),
        "transform_type": Param(str, "affine"),
        "sampler_type": Param(str, "bilinear"),
    }

    def list_arguments(self):
        return ["data", "loc"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SpatialTransformer: data shape unknown")
        th, tw = self.target_shape
        return ([data, (data[0], 6)],
                [(data[0], data[1], th, tw)], [])

    def apply(self, ctx, inputs, aux):
        data, loc = inputs
        n, c, h, w = data.shape
        th, tw = self.target_shape
        dev = data.device
        yt, xt = torch.meshgrid(_linspace(th, dev), _linspace(tw, dev),
                                indexing="ij")
        grid = torch.stack([xt.reshape(-1), yt.reshape(-1),
                            torch.ones(th * tw, device=dev)])   # (3, P)
        src = loc.reshape(n, 2, 3).to(grid.dtype) @ grid        # (n, 2, P)
        xs = (src[:, 0] + 1.0) * (w - 1) / 2.0
        ys = (src[:, 1] + 1.0) * (h - 1) / 2.0
        x0 = torch.floor(xs)
        y0 = torch.floor(ys)
        wx = xs - x0
        wy = ys - y0
        flat = data.reshape(n, c, h * w)

        def sample(yi, xi):
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            yc = yi.clamp(0, h - 1).long()
            xc = xi.clamp(0, w - 1).long()
            idx = (yc * w + xc)[:, None, :].expand(n, c, -1)
            vals = torch.gather(flat, 2, idx)                   # (n, c, P)
            return torch.where(inb[:, None], vals, torch.zeros((), dtype=
                                                               vals.dtype,
                                                               device=dev))

        wy, wx = wy[:, None], wx[:, None]
        out = (sample(y0, x0) * (1 - wy) * (1 - wx)
               + sample(y0, x0 + 1) * (1 - wy) * wx
               + sample(y0 + 1, x0) * wy * (1 - wx)
               + sample(y0 + 1, x0 + 1) * wy * wx)
        return [out.reshape(n, c, th, tw).to(data.dtype)], []


@register_op("Correlation")
class Correlation(Operator):
    """Cross-correlation of two feature maps over a displacement window
    (FlowNet-style), as the JAX package computes it: the second map
    shifted by ``torch.roll`` (wrapping around the padded map), a mean
    over channels of the product (or of minus the absolute difference),
    read at stride1 inside the border. ``kernel_size`` sets only the
    border."""

    name_hint = "correlation"
    PARAMS = {
        "kernel_size": Param(int, 1),
        "max_displacement": Param(int, 1),
        "stride1": Param(int, 1),
        "stride2": Param(int, 1),
        "pad_size": Param(int, 0),
        "is_multiply": Param(bool, True),
    }

    def list_arguments(self):
        return ["data1", "data2"]

    def _out_geom(self, data):
        n, c, h, w = data
        pad = self.pad_size
        bor = self.max_displacement + (self.kernel_size - 1) // 2
        ph, pw = h + 2 * pad, w + 2 * pad
        out_h = int(np.ceil((ph - bor * 2) / self.stride1))
        out_w = int(np.ceil((pw - bor * 2) / self.stride1))
        d = 2 * (self.max_displacement // self.stride2) + 1
        return out_h, out_w, d * d

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Correlation: shapes unknown")
        out_h, out_w, top_c = self._out_geom(data)
        return [data, data], [(data[0], top_c, out_h, out_w)], []

    def apply(self, ctx, inputs, aux):
        d1, d2 = inputs
        c = d1.shape[1]
        pad = self.pad_size
        md = self.max_displacement
        s1 = self.stride1
        out_h, out_w, _ = self._out_geom(tuple(d1.shape))
        bor = md + (self.kernel_size - 1) // 2
        p1 = F.pad(d1, (pad, pad, pad, pad))
        p2 = F.pad(d2, (pad, pad, pad, pad))
        maps = []
        for dy in range(-md, md + 1, self.stride2):
            for dx in range(-md, md + 1, self.stride2):
                shifted = torch.roll(p2, (-dy, -dx), dims=(2, 3))
                if self.is_multiply:
                    prod = (p1 * shifted).sum(dim=1) / c
                else:
                    prod = -(p1 - shifted).abs().sum(dim=1) / c
                maps.append(prod[:, bor:bor + out_h * s1:s1,
                                 bor:bor + out_w * s1:s1])
        return [torch.stack(maps, dim=1).to(d1.dtype)], []


class _Sample(Operator):
    """A symbolic random source of a fixed shape: no inputs, one float32
    output drawn from the executor's generator in either mode."""

    def list_arguments(self):
        return []

    @property
    def draws_random(self) -> bool:
        return True

    def infer_shape(self, in_shapes):
        return [], [tuple(self.params["shape"])], []

    def _generator(self, ctx):
        if ctx.rng is None:
            raise MXNetError("%s op needs an rng (bind via executor)"
                             % self.name_hint)
        return ctx.rng


@register_op("uniform", aliases=["_sample_uniform"])
class SampleUniform(_Sample):
    """Uniform draws on [low, high)."""

    name_hint = "uniform"
    PARAMS = {
        "low": Param(float, 0.0),
        "high": Param(float, 1.0),
        "shape": Param("shape", REQUIRED),
    }

    def apply(self, ctx, inputs, aux):
        g = self._generator(ctx)
        u = torch.rand(tuple(self.shape), generator=g, device=g.device)
        return [u * (self.high - self.low) + self.low], []


@register_op("normal", aliases=["_sample_normal"])
class SampleNormal(_Sample):
    """Normal draws of mean ``loc`` and standard deviation ``scale``."""

    name_hint = "normal"
    PARAMS = {
        "loc": Param(float, 0.0),
        "scale": Param(float, 1.0),
        "shape": Param("shape", REQUIRED),
    }

    def apply(self, ctx, inputs, aux):
        g = self._generator(ctx)
        z = torch.randn(tuple(self.shape), generator=g, device=g.device)
        return [self.loc + self.scale * z], []


@register_op("softmax_cross_entropy")
class SoftmaxCrossEntropy(Operator):
    """The summed softmax cross-entropy of a batch as a (1,) value; the
    label is cast to int32 (indexing as a JAX gather does)."""

    name_hint = "softmax_cross_entropy"

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("softmax_cross_entropy: data shape unknown")
        return [data, (data[0],)], [(1,)], []

    def apply(self, ctx, inputs, aux):
        data, label = inputs
        logp = torch.log_softmax(data, dim=-1)
        k = data.shape[-1]
        lab = label.detach().to(torch.int32).long()
        lab = torch.where(lab < 0, lab + k, lab).clamp(0, k - 1)
        nll = -logp.gather(-1, lab[:, None])[:, 0]
        return [nll.sum().reshape(1)], []

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts: each
        replica's sum over its rows, summed across the replicas by one
        autograd-aware cross-card sum, on every replica."""
        reps = ctxs[0].replicas
        parts = []
        for k, ins in enumerate(inputs):
            with reps.on(k):
                parts.append(self.apply(ctxs[k], ins, [])[0][0])
        return [[o] for o in reps.all_sum(parts)], [[] for _ in inputs]


__all__ = ["ROIPooling", "SpatialTransformer", "Correlation",
           "SampleUniform", "SampleNormal", "SoftmaxCrossEntropy"]
