"""Elementwise and structural operators, counterpart of the part of
``mxnet_tpu/ops/tensor.py`` the serving slice needs: the binary and
scalar ops behind Symbol's operator overloading (``_Plus``,
``_PlusScalar`` and siblings), Flatten, ElementWiseSum and Concat."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
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
