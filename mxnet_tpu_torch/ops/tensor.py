"""Elementwise, structural, reduction, matrix and gradient-control
operators, counterpart of ``mxnet_tpu/ops/tensor.py``: the binary and
scalar ops behind Symbol's operator overloading (``_Plus``,
``_PlusScalar`` and siblings), the broadcast and unary families, clip,
argmax_channel, smooth_l1, the structural ops (Flatten, Reshape, Cast,
transpose, SwapAxis, expand_dims, Concat, SliceChannel, Crop,
element_mask, the crop assigns, slice_axis, Flip), the reductions, dot
and batch_dot, and BlockGrad, MakeLoss and IdentityAttachKLSparseReg.
All are plain torch, so autograd differentiates them (the residual
``+`` of a ResNet is ``_Plus``); where the JAX package gives an op a
``custom_vjp`` (MakeLoss, the KL regulariser), the port gives it a
``torch.autograd.Function`` with the same backward."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..batch_layout import batch_axis
from .registry import Operator, Param, REQUIRED, register_op, same_shape_binary


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------
class _BinaryOp(Operator):
    fn = None

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        return same_shape_binary(in_shapes)

    def apply(self, ctx, inputs, aux):
        return [type(self).fn(inputs[0], inputs[1])], []


def _def_binary(name, hint, fn):
    cls = type(name.strip("_"), (_BinaryOp,), {"fn": staticmethod(fn),
                                               "name_hint": hint})
    register_op(name)(cls)
    return cls


_def_binary("_Plus", "plus", lambda a, b: a + b)
_def_binary("_Minus", "minus", lambda a, b: a - b)
_def_binary("_Mul", "mul", lambda a, b: a * b)
_def_binary("_Div", "div", lambda a, b: a / b)
_def_binary("_Power", "power", lambda a, b: a ** b)
_def_binary("_Maximum", "maximum", torch.maximum)
_def_binary("_Minimum", "minimum", torch.minimum)


class _BroadcastBinaryOp(Operator):
    """Same ndim, each axis equal or 1; autograd sums the gradient over
    the broadcast axes."""

    fn = None

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        lhs, rhs = in_shapes
        if lhs is None or rhs is None:
            raise MXNetError("broadcast op: both input shapes required")
        if len(lhs) != len(rhs):
            raise MXNetError("broadcast op: ndim mismatch %s vs %s"
                             % (lhs, rhs))
        out = []
        for a, b in zip(lhs, rhs):
            if a != b and a != 1 and b != 1:
                raise MXNetError("broadcast op: incompatible dims %s vs %s"
                                 % (lhs, rhs))
            out.append(max(a, b))
        return [lhs, rhs], [tuple(out)], []

    def apply(self, ctx, inputs, aux):
        return [type(self).fn(inputs[0], inputs[1])], []


def _def_broadcast(name, fn):
    cls = type(name, (_BroadcastBinaryOp,), {"fn": staticmethod(fn),
                                             "name_hint": name})
    register_op(name)(cls)
    return cls


_def_broadcast("broadcast_plus", lambda a, b: a + b)
_def_broadcast("broadcast_minus", lambda a, b: a - b)
_def_broadcast("broadcast_mul", lambda a, b: a * b)
_def_broadcast("broadcast_div", lambda a, b: a / b)
_def_broadcast("broadcast_power", lambda a, b: a ** b)


# ---------------------------------------------------------------------------
# tensor-scalar
# ---------------------------------------------------------------------------
class _ScalarOp(Operator):
    PARAMS = {"scalar": Param(float, REQUIRED)}
    fn = None

    def apply(self, ctx, inputs, aux):
        return [type(self).fn(inputs[0], self.scalar)], []


def _def_scalar(name, hint, fn, aliases=()):
    cls = type(name.strip("_"), (_ScalarOp,), {"fn": staticmethod(fn),
                                               "name_hint": hint})
    register_op(name, aliases=aliases)(cls)
    return cls


_def_scalar("_PlusScalar", "plusscalar", lambda a, s: a + s,
            aliases=("_plus_scalar",))
_def_scalar("_MinusScalar", "minusscalar", lambda a, s: a - s,
            aliases=("_minus_scalar",))
_def_scalar("_RMinusScalar", "rminusscalar", lambda a, s: s - a,
            aliases=("_rminus_scalar",))
_def_scalar("_MulScalar", "mulscalar", lambda a, s: a * s,
            aliases=("_mul_scalar",))
_def_scalar("_DivScalar", "divscalar", lambda a, s: a / s,
            aliases=("_div_scalar",))
_def_scalar("_RDivScalar", "rdivscalar", lambda a, s: s / a,
            aliases=("_rdiv_scalar",))
_def_scalar("_PowerScalar", "powerscalar", lambda a, s: a ** s,
            aliases=("_power_scalar",))
_def_scalar("_RPowerScalar", "rpowerscalar", lambda a, s: s ** a,
            aliases=("_rpower_scalar",))
_def_scalar("_MaximumScalar", "maximumscalar",
            lambda a, s: torch.clamp_min(a, s), aliases=("_maximum_scalar",))
_def_scalar("_MinimumScalar", "minimumscalar",
            lambda a, s: torch.clamp_max(a, s), aliases=("_minimum_scalar",))


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
class _UnaryOp(Operator):
    fn = None

    def apply(self, ctx, inputs, aux):
        return [type(self).fn(inputs[0])], []


def _def_unary(name, fn):
    cls = type("U_" + name, (_UnaryOp,), {"fn": staticmethod(fn),
                                          "name_hint": name})
    register_op(name)(cls)
    return cls


_def_unary("exp", torch.exp)
_def_unary("log", torch.log)
_def_unary("sqrt", torch.sqrt)
_def_unary("rsqrt", torch.rsqrt)
_def_unary("square", lambda x: x * x)
_def_unary("abs", torch.abs)
_def_unary("sign", torch.sign)
_def_unary("round", torch.round)    # half to even, as jnp.round
_def_unary("ceil", torch.ceil)
_def_unary("floor", torch.floor)
_def_unary("cos", torch.cos)
_def_unary("sin", torch.sin)
_def_unary("negative", torch.neg)


@register_op("clip")
class Clip(Operator):
    """Elementwise clamp to [a_min, a_max]."""

    name_hint = "clip"
    PARAMS = {"a_min": Param(float, REQUIRED), "a_max": Param(float, REQUIRED)}

    def apply(self, ctx, inputs, aux):
        return [torch.clamp(inputs[0], self.a_min, self.a_max)], []


@register_op("argmax_channel")
class ArgmaxChannel(Operator):
    """The argmax over axis 1 in the input's dtype, shape (batch,) +
    the axes after the channel; no gradient."""

    name_hint = "argmax_channel"

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("argmax_channel: data shape unknown")
        if len(data) < 2:
            raise MXNetError("argmax_channel needs >=2 dims, got %s"
                             % (data,))
        return [data], [(data[0],) + tuple(data[2:])], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0].detach()
        return [torch.argmax(x, dim=1).to(x.dtype)], []


@register_op("smooth_l1")
class SmoothL1(Operator):
    """``0.5 (s x)^2`` where ``|x| < 1/s^2``, else ``|x| - 0.5/s^2``."""

    name_hint = "smooth_l1"
    PARAMS = {"scalar": Param(float, 1.0)}

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        s2 = self.scalar ** 2
        out = torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x,
                          torch.abs(x) - 0.5 / s2)
        return [out], []


# ---------------------------------------------------------------------------
# structural ops
# ---------------------------------------------------------------------------
@register_op("Flatten")
class Flatten(Operator):
    name_hint = "flatten"

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Flatten: data shape unknown")
        return [data], [(data[0], int(np.prod(data[1:])))], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)], []


@register_op("Reshape")
class Reshape(Operator):
    """``shape`` reads 0 as "keep this axis" and -1 as "infer it"; the
    legacy ``target_shape`` reads 0 as "infer". ``reverse`` applies the
    rules with both shapes aligned from the right."""

    name_hint = "reshape"
    PARAMS = {
        "shape": Param("shape", None),
        "target_shape": Param("shape", None),
        "reverse": Param(bool, False, "match 0-dims from the right"),
    }

    def _target(self, data):
        shape = self.params["shape"]
        if shape is None and self.target_shape is not None:
            shape = tuple(-1 if s == 0 else s for s in self.target_shape)
        if shape is None:
            raise MXNetError("Reshape: no target shape")
        if self.reverse:
            out = self._expand(tuple(reversed(data)),
                               tuple(reversed(shape)))
            return tuple(reversed(out))
        return tuple(self._expand(data, shape))

    @staticmethod
    def _expand(data, shape):
        out = [data[i] if s == 0 and i < len(data) else s
               for i, s in enumerate(shape)]
        if out.count(-1) > 1:
            raise MXNetError("Reshape: at most one dim may be inferred "
                             "(-1, or 0 in the old target_shape API): %s"
                             % (tuple(shape),))
        if -1 in out:
            known = int(np.prod([s for s in out if s != -1]))
            out[out.index(-1)] = int(np.prod(data)) // max(known, 1)
        return out

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Reshape: data shape unknown")
        out = self._target(data)
        if int(np.prod(out)) != int(np.prod(data)):
            raise MXNetError("Reshape: size mismatch %s -> %s" % (data, out))
        return [data], [out], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        return [x.reshape(self._target(tuple(x.shape)))], []


@register_op("Cast")
class Cast(Operator):
    name_hint = "cast"
    PARAMS = {"dtype": Param(str, REQUIRED)}

    def infer_type(self, in_types, out_types=None):
        # the input keeps what upstream says; the output is fixed
        return [in_types[0]], [np.dtype(self.dtype)], []

    def apply(self, ctx, inputs, aux):
        return [inputs[0].to(torch_dtype(self.dtype))], []


@register_op("transpose")
class Transpose(Operator):
    name_hint = "transpose"
    PARAMS = {"axes": Param("shape", None)}

    def _axes(self, ndim):
        return self.axes or tuple(reversed(range(ndim)))

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("transpose: data shape unknown")
        return [data], [tuple(data[a] for a in self._axes(len(data)))], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        return [x.permute(*self._axes(x.dim()))], []


@register_op("SwapAxis")
class SwapAxis(Operator):
    name_hint = "swapaxis"
    PARAMS = {"dim1": Param(int, 0), "dim2": Param(int, 0)}

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SwapAxis: data shape unknown")
        s = list(data)
        s[self.dim1], s[self.dim2] = s[self.dim2], s[self.dim1]
        return [data], [tuple(s)], []

    def apply(self, ctx, inputs, aux):
        return [inputs[0].transpose(self.dim1, self.dim2)], []


@register_op("expand_dims")
class ExpandDims(Operator):
    name_hint = "expand_dims"
    PARAMS = {"axis": Param(int, REQUIRED)}

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("expand_dims: data shape unknown")
        s = list(data)
        axis = self.axis if self.axis >= 0 else len(data) + 1 + self.axis
        s.insert(axis, 1)
        return [data], [tuple(s)], []

    def apply(self, ctx, inputs, aux):
        return [inputs[0].unsqueeze(self.axis)], []


@register_op("Concat")
class Concat(Operator):
    name_hint = "concat"
    PARAMS = {"num_args": Param(int, REQUIRED), "dim": Param(int, 1)}

    def list_arguments(self):
        return ["arg%d" % i for i in range(self.num_args)]

    def infer_shape(self, in_shapes):
        known = next((s for s in in_shapes if s is not None), None)
        if known is None:
            raise MXNetError("Concat: no input shape known")
        filled = [s if s is not None else known for s in in_shapes]
        out = list(known)
        out[self.dim] = sum(s[self.dim] for s in filled)
        return filled, [tuple(out)], []

    def apply(self, ctx, inputs, aux):
        return [torch.cat(list(inputs), dim=self.dim)], []


@register_op("SliceChannel")
class SliceChannel(Operator):
    """Split along ``axis`` into ``num_outputs`` equal parts, each with
    that axis dropped under ``squeeze_axis`` (when it has size 1)."""

    name_hint = "slicechannel"
    PARAMS = {
        "num_outputs": Param(int, REQUIRED),
        "axis": Param(int, 1),
        "squeeze_axis": Param(bool, False),
    }

    def list_outputs(self):
        # self.params: the num_outputs property derives from this list
        return ["output%d" % i for i in range(self.params["num_outputs"])]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("SliceChannel: data shape unknown")
        n = self.params["num_outputs"]
        s = list(data)
        if s[self.axis] % n:
            raise MXNetError("SliceChannel: axis not divisible")
        s[self.axis] //= n
        if self.squeeze_axis and s[self.axis] == 1:
            del s[self.axis]
        return [data], [tuple(s)] * n, []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        n = self.params["num_outputs"]
        outs = torch.split(x, x.shape[self.axis] // n, dim=self.axis)
        if self.squeeze_axis:
            outs = [o.squeeze(self.axis) for o in outs]
        return list(outs), []


@register_op("ElementWiseSum", aliases=["add_n"])
class ElementWiseSum(Operator):
    name_hint = "elementwisesum"
    PARAMS = {"num_args": Param(int, REQUIRED)}

    def list_arguments(self):
        return ["arg%d" % i for i in range(self.num_args)]

    def infer_shape(self, in_shapes):
        known = next((s for s in in_shapes if s is not None), None)
        if known is None:
            raise MXNetError("ElementWiseSum: no input shape known")
        return [known] * len(in_shapes), [known], []

    def apply(self, ctx, inputs, aux):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out], []


@register_op("Crop", aliases=("crop",))
class Crop(Operator):
    """Crop the spatial axes (2, 3) to ``h_w`` or to the second input's,
    at ``offset`` or centred; or, with ``begin``/``end``, slice every
    axis (the matrix crop of ``mx.nd.crop``)."""

    name_hint = "crop"
    PARAMS = {
        "num_args": Param(int, 1),
        "offset": Param("shape", (0, 0)),
        "h_w": Param("shape", (0, 0)),
        "center_crop": Param(bool, False),
        "begin": Param("shape", None),
        "end": Param("shape", None),
    }

    def list_arguments(self):
        return ["data"] if self.num_args == 1 else ["data", "crop_like"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("Crop: data shape unknown")
        if self.begin is not None:
            if self.end is None or len(self.begin) != len(data) \
                    or len(self.end) != len(data):
                raise MXNetError("Crop: begin/end must both cover all %d "
                                 "axes" % len(data))
            for b, e, d in zip(self.begin, self.end, data):
                if not (0 <= b < e <= d):
                    raise MXNetError(
                        "Crop: invalid range [%d, %d) on axis of size %d"
                        % (b, e, d))
            return [data], [tuple(e - b for b, e in
                                  zip(self.begin, self.end))], []
        if self.num_args == 2:
            like = in_shapes[1]
            if like is None:
                raise MXNetError("Crop: crop_like shape unknown")
            return [data, like], [data[:2] + like[2:4]], []
        h, w = self.h_w
        return [data], [data[:2] + (h, w)], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if self.begin is not None:
            return [x[tuple(slice(b, e) for b, e in
                            zip(self.begin, self.end))]], []
        if self.num_args == 2:
            h, w = inputs[1].shape[2:4]
        else:
            h, w = self.h_w
        if self.center_crop:
            oh, ow = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
        else:
            oh, ow = self.offset
        return [x[:, :, oh:oh + h, ow:ow + w]], []


@register_op("element_mask")
class ElementMask(Operator):
    """``out[i, ...] = lhs[i, ...] * rhs[i]``; the mask takes no
    gradient."""

    name_hint = "elementmask"

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        lhs, rhs = in_shapes
        if lhs is None:
            raise MXNetError("element_mask: lhs shape unknown")
        if len(lhs) < 2:
            raise MXNetError("element_mask: source tensor should be 2D or "
                             "more, got %s" % (lhs,))
        want_rhs = (lhs[0],)
        if rhs is not None and tuple(rhs) != want_rhs:
            raise MXNetError("element_mask: mask must be 1D of length %d, "
                             "got %s" % (lhs[0], rhs))
        return [lhs, want_rhs], [lhs], []

    def apply(self, ctx, inputs, aux):
        lhs, rhs = inputs
        mask = rhs.detach().reshape((lhs.shape[0],) + (1,) * (lhs.dim() - 1))
        return [lhs * mask.to(lhs.dtype)], []


def _region(begin, end):
    return tuple(slice(b, e) for b, e in zip(begin, end))


@register_op("_crop_assign", aliases=("_CropAssign",))
class CropAssign(Operator):
    """A copy of ``lhs`` with ``rhs`` written into ``[begin, end)``: lhs
    takes no gradient inside the region, rhs gathers it from there."""

    name_hint = "cropassign"
    PARAMS = {
        "begin": Param("shape", REQUIRED),
        "end": Param("shape", REQUIRED),
    }

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        from ..ndarray import _check_crop_region

        lhs, rhs = in_shapes
        if lhs is None:
            raise MXNetError("_crop_assign: lhs shape unknown")
        region = _check_crop_region(lhs, self.begin, self.end,
                                    "_crop_assign")
        if rhs is not None and tuple(rhs) != region:
            raise MXNetError("_crop_assign: rhs shape %s does not match "
                             "region %s" % (rhs, region))
        return [lhs, region], [lhs], []

    def apply(self, ctx, inputs, aux):
        lhs, rhs = inputs
        out = lhs.clone()
        out[_region(self.begin, self.end)] = rhs.to(lhs.dtype)
        return [out], []


@register_op("_crop_assign_scalar", aliases=("_CropAssignScalar",))
class CropAssignScalar(Operator):
    """A copy of the input with ``[begin, end)`` set to ``scalar``."""

    name_hint = "cropassignscalar"
    PARAMS = {
        "scalar": Param(float, 0.0),
        "begin": Param("shape", REQUIRED),
        "end": Param("shape", REQUIRED),
    }

    def infer_shape(self, in_shapes):
        from ..ndarray import _check_crop_region

        data = in_shapes[0]
        if data is None:
            raise MXNetError("_crop_assign_scalar: data shape unknown")
        _check_crop_region(data, self.begin, self.end,
                           "_crop_assign_scalar")
        return [data], [data], []

    def apply(self, ctx, inputs, aux):
        out = inputs[0].clone()
        out[_region(self.begin, self.end)] = self.scalar
        return [out], []


@register_op("_CrossDeviceCopy")
class CrossDeviceCopy(Operator):
    """A device boundary in the graph; the port binds one device, so the
    identity."""

    name_hint = "crossdevicecopy"

    def apply(self, ctx, inputs, aux):
        return [inputs[0]], []


def _check_axis(what, axis, ndim):
    if not (-ndim <= axis < ndim):
        raise MXNetError("%s: axis %d out of range for %d-d input"
                         % (what, axis, ndim))
    return axis % ndim


@register_op("slice_axis")
class SliceAxis(Operator):
    """``[begin, end)`` along one axis."""

    name_hint = "slice_axis"
    PARAMS = {
        "axis": Param(int, REQUIRED),
        "begin": Param(int, REQUIRED),
        "end": Param(int, REQUIRED),
    }

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("slice_axis: data shape unknown")
        ax = _check_axis("slice_axis", self.axis, len(data))
        if not (0 <= self.begin < self.end <= data[ax]):
            raise MXNetError("slice_axis: invalid [%d, %d) on axis %d of %s"
                             % (self.begin, self.end, ax, (data,)))
        out = tuple(self.end - self.begin if i == ax else d
                    for i, d in enumerate(data))
        return [data], [out], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        ax = _check_axis("slice_axis", self.axis, x.dim())
        return [x.narrow(ax, self.begin, self.end - self.begin)], []


@register_op("Flip", aliases=("flip",))
class Flip(Operator):
    """Reverse one axis."""

    name_hint = "flip"
    PARAMS = {"axis": Param(int, REQUIRED)}

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("flip: data shape unknown")
        _check_axis("flip", self.axis, len(data))
        return [data], [data], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        return [torch.flip(x, [_check_axis("flip", self.axis, x.dim())])], []


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
class _ReduceOp(Operator):
    """Over ``axis`` (every axis by default); a result with no axes left
    is shape (1,). max and min share the gradient among ties, as JAX's
    reductions do."""

    PARAMS = {
        "axis": Param("shape", None),
        "keepdims": Param(bool, False),
    }
    fn = None

    def _axes(self, ndim):
        if self.axis is None:
            return tuple(range(ndim))
        return tuple(a % ndim for a in self.axis)


    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("reduce: data shape unknown")
        axes = self._axes(len(data))
        if self.keepdims:
            out = tuple(1 if i in axes else s for i, s in enumerate(data))
        else:
            out = tuple(s for i, s in enumerate(data) if i not in axes) \
                or (1,)
        return [data], [out], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        r = type(self).fn(x, dim=self._axes(x.dim()), keepdim=self.keepdims)
        if r.dim() == 0:
            r = r.reshape((1,))
        return [r], []

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts: a
        reduction over the axis that holds the batch (by the input's
        layout, alone or flattened with others) gives every replica the
        global batch's value, ``sum`` by one autograd-aware cross-card sum
        of the replicas' partial sums, ``max`` and ``min`` by
        :class:`_CrossExtreme`; any other, and one over an input every
        replica holds whole, is each replica's own."""
        reps = ctxs[0].replicas
        axis = batch_axis(layouts[0] if layouts is not None else 0,
                          self.op_name)
        if axis not in self._axes(inputs[0][0].dim()):
            return reps.each(self.apply, ctxs, inputs, aux)
        xs = [ins[0] for ins in inputs]
        if type(self).fn is torch.sum:
            parts = []
            for k, x in enumerate(xs):
                with reps.on(k):
                    parts.append(self.apply(ctxs[k], [x], [])[0][0])
            outs = reps.all_sum(parts)
        else:
            outs = _CrossExtreme.apply(self, reps, *xs)
        return [[o] for o in outs], [[] for _ in xs]


class _CrossExtreme(torch.autograd.Function):
    """``max`` or ``min`` over the batch across the replicas: forward each
    replica's own extreme, then the extreme over the replicas on every
    replica; backward the replicas' incoming gradients summed (each
    holds a part of the one value's), shared equally among the
    positions, on every replica, that hold the extreme, as one
    reduction over the whole batch shares it among ties."""

    @staticmethod
    def forward(ctx, op, reps, *xs):
        dims = op._axes(xs[0].dim())
        largest = type(op).fn is torch.amax
        ext, masks, counts = [], [], []
        for k, x in enumerate(xs):
            with reps.on(k):
                ext.append(type(op).fn(x, dim=dims, keepdim=True)
                           .contiguous())
        reps.extreme_(ext, largest)
        for k, x in enumerate(xs):
            with reps.on(k):
                m = x == ext[k]
                masks.append(m)
                counts.append(m.sum(dim=dims, keepdim=True)
                              .to(torch.float32).contiguous())
        reps.sum_(counts)
        ctx.reps, ctx.streams, ctx.dims = reps, reps.streams, dims
        ctx.keep = ext[0].shape
        ctx.save_for_backward(*masks, *counts)
        outs = []
        for k, e in enumerate(ext):
            with reps.on(k):
                r = e if op.keepdims else e.squeeze(dims)
                outs.append(r.reshape((1,)) if r.dim() == 0 else r.clone())
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        reps, streams = ctx.reps, ctx.streams
        saved = ctx.saved_tensors
        masks, counts = saved[:reps.n], saved[reps.n:]
        total = []
        for k, g in enumerate(grads):
            with reps.on(k, streams):
                total.append(g.reshape(ctx.keep).float().contiguous()
                             .clone())
        reps.sum_(total, streams)
        out = []
        for k, (m, c, g) in enumerate(zip(masks, counts, total)):
            with reps.on(k, streams):
                out.append((m * (g / c)).to(grads[k].dtype))
        return (None, None) + tuple(out)


for _name, _fn in (("sum", torch.sum), ("max", torch.amax),
                   ("min", torch.amin)):
    register_op(_name, aliases=["%s_axis" % _name])(
        type("Reduce_" + _name, (_ReduceOp,),
             {"fn": staticmethod(_fn), "name_hint": _name}))
del _name, _fn


@register_op("broadcast_axis")
class BroadcastAxis(Operator):
    """Size-1 axes ``axis`` repeated to ``size``."""

    name_hint = "broadcast_axis"
    PARAMS = {"axis": Param("shape", ()), "size": Param("shape", ())}

    def _out(self, data):
        out = list(data)
        for a, s in zip(self.axis, self.size):
            out[a] = s
        return tuple(out)

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("broadcast_axis: data shape unknown")
        return [data], [self._out(data)], []

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        return [x.expand(self._out(tuple(x.shape))).contiguous()], []


# ---------------------------------------------------------------------------
# matrix ops
# ---------------------------------------------------------------------------
def _reversed_axes(x):
    return x.permute(*reversed(range(x.dim())))


@register_op("dot")
class Dot(Operator):
    """``numpy.dot``: a's last axis against b's second to last (its only
    one when 1-d); ``transpose_a``/``transpose_b`` reverse every axis
    first. A scalar result is shape (1,)."""

    name_hint = "dot"
    PARAMS = {
        "transpose_a": Param(bool, False),
        "transpose_b": Param(bool, False),
    }

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            raise MXNetError("dot: input shapes unknown")
        ar = tuple(reversed(a)) if self.transpose_a else a
        br = tuple(reversed(b)) if self.transpose_b else b
        if len(ar) == 1 and len(br) == 1:
            out = (1,)
        elif len(br) == 1:
            out = ar[:-1]
        elif len(ar) == 1:
            out = br[1:]
        else:
            out = ar[:-1] + br[1:]
        return [a, b], [out], []

    def apply(self, ctx, inputs, aux):
        a, b = inputs
        if self.transpose_a:
            a = _reversed_axes(a)
        if self.transpose_b:
            b = _reversed_axes(b)
        if a.dim() <= 2 and b.dim() <= 2:
            r = torch.matmul(a, b)
        else:
            r = torch.tensordot(a, b, dims=([a.dim() - 1],
                                            [max(b.dim() - 2, 0)]))
        if r.dim() == 0:
            r = r.reshape((1,))
        return [r], []


@register_op("batch_dot")
class BatchDot(Operator):
    """(B, M, K) x (B, K, N) -> (B, M, N), each operand's last two axes
    swapped first under ``transpose_a``/``transpose_b``."""

    name_hint = "batch_dot"
    PARAMS = {
        "transpose_a": Param(bool, False),
        "transpose_b": Param(bool, False),
    }

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            raise MXNetError("batch_dot: input shapes unknown")
        m = a[2] if self.transpose_a else a[1]
        k = b[1] if self.transpose_b else b[2]
        return [a, b], [(a[0], m, k)], []

    def apply(self, ctx, inputs, aux):
        a, b = inputs
        if self.transpose_a:
            a = a.transpose(1, 2)
        if self.transpose_b:
            b = b.transpose(1, 2)
        return [torch.bmm(a, b)], []


# ---------------------------------------------------------------------------
# gradient-control ops
# ---------------------------------------------------------------------------
@register_op("BlockGrad")
class BlockGrad(Operator):
    """The identity, with no gradient."""

    name_hint = "blockgrad"

    def apply(self, ctx, inputs, aux):
        return [inputs[0].detach()], []


class _MakeLoss(torch.autograd.Function):
    """The identity forward; backward ``grad_scale`` everywhere, whatever
    the head gradient (``mxnet_tpu/ops/tensor.py:851-862``)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register_op("MakeLoss")
class MakeLoss(Operator):
    """Turns any symbol into a loss: its gradient is ``grad_scale``."""

    name_hint = "makeloss"
    PARAMS = {"grad_scale": Param(float, 1.0)}

    def apply(self, ctx, inputs, aux):
        return [_MakeLoss.apply(inputs[0], self.grad_scale)], []


class _KLSparseReg(torch.autograd.Function):
    """The identity forward; backward adds ``penalty * (-rho / rho_hat +
    (1 - rho) / (1 - rho_hat))`` per channel to the head gradient
    (``mxnet_tpu/ops/tensor.py:900-913``)."""

    @staticmethod
    def forward(ctx, x, rho_hat, rho, penalty):
        ctx.save_for_backward(rho_hat)
        ctx.rho, ctx.penalty = rho, penalty
        ctx.bshape = (1, -1) + (1,) * (x.dim() - 2)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        rho_hat, = ctx.saved_tensors
        kl = ctx.penalty * (-ctx.rho / rho_hat
                            + (1 - ctx.rho) / (1 - rho_hat))
        return g + kl.reshape(ctx.bshape), torch.zeros_like(rho_hat), \
            None, None


@register_op("IdentityAttachKLSparseReg")
class IdentityAttachKLSparseReg(Operator):
    """The identity, with a KL sparseness penalty on the mean activation
    of each channel (axis 1) added to its gradient; the moving average of
    that mean is an aux state, moved in train mode."""

    name_hint = "identityattachklsparsereg"
    PARAMS = {
        "sparseness_target": Param(float, 0.1),
        "penalty": Param(float, 0.001),
        "momentum": Param(float, 0.9),
    }

    def list_auxiliary_states(self):
        return ["moving_avg"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise MXNetError("IdentityAttachKLSparseReg: data shape unknown")
        return [data], [data], [(data[1],)]

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        rho_hat = x.detach().mean(
            dim=tuple(i for i in range(x.dim()) if i != 1))
        return self._attach(ctx, x, aux[0], rho_hat)

    def apply_replicas(self, ctxs, inputs, aux, layouts):
        """The replicas of a group bound over several contexts: the mean
        activation (and so the penalty and the moving average) is the
        global batch's, each replica's float32 sums by channel summed
        across the replicas; an input whose batch is its channel axis (1)
        raises."""
        reps = ctxs[0].replicas
        if batch_axis(layouts[0] if layouts is not None else 0,
                      self.op_name) == 1:
            raise MXNetError("%s over %d contexts: the input's batch is "
                             "its channel axis (1), so the mean activation "
                             "by channel does not span the batch; bind it "
                             "on one context" % (self.op_name, reps.n))
        sums = []
        for k, (x,) in enumerate(inputs):
            with reps.on(k):
                sums.append(x.detach().float().sum(
                    dim=tuple(i for i in range(x.dim()) if i != 1)))
        reps.sum_(sums)
        count = reps.procs * sum(x.numel() // x.shape[1] for x, in inputs)
        outs, new_aux = [], []
        for k, ((x,), (moving,)) in enumerate(zip(inputs, aux)):
            with reps.on(k):
                o, a = self._attach(ctxs[k], x, moving,
                                    (sums[k] / count).to(x.dtype))
            outs.append(o)
            new_aux.append(a)
        return outs, new_aux

    def _attach(self, ctx, x, moving, rho_hat):
        if ctx.is_train:
            new_aux = [moving * self.momentum
                       + rho_hat.to(moving.dtype) * (1 - self.momentum)]
        else:
            new_aux = [moving]
        return [_KLSparseReg.apply(x, rho_hat, self.sparseness_target,
                                   self.penalty)], new_aux
