"""Operators defined in Python, counterpart of ``mxnet_tpu/operator.py``.

``CustomOp``/``CustomOpProp`` with :func:`register`, the ``Custom``
symbol op that runs them, and the legacy ``PythonOp``/``NumpyOp``/
``NDArrayOp`` with ``get_symbol``. A Custom node runs its operator on
the host: the inputs are copied to numpy, the user's ``forward`` (and,
in the backward, ``backward``) fills numpy outputs, and those are copied
back to the node's device, wired into autograd by a
``torch.autograd.Function``.

The JAX package's contract is kept, so user ops and symbol JSON cross
between the packages unchanged: every ``req`` is ``"write"``; every
output takes the first input's dtype; ``create_operator`` gets
``ctx=None`` and is called once per Custom node; the head gradient is
always passed; ``param_str_dict`` holds ``op_type`` and the prop's
keyword arguments as strings.

A host callback cannot run inside a CUDA graph, so the fused train step
and the fused inference step refuse a graph with a Custom node, naming
it (the JAX package runs the callback inside ``jit``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .base import MXNetError, Registry
from .ops.registry import Operator, Param, REQUIRED, register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "NumpyOp", "NDArrayOp",
           "PythonOp", "custom_nodes"]

_CUSTOM_REG: Registry = Registry.get_registry("custom_op")


class CustomOp:
    """Base of a user operator: ``forward`` and ``backward`` write their
    results with :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst[:] + src if hasattr(dst, "__getitem__") else dst + src


class CustomOpProp:
    """The declaration of a user operator: its arguments, outputs, shape
    and dtype rules, and the factory of its :class:`CustomOp`."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Register a CustomOpProp class (any class with its methods) under
    ``reg_name``, replacing an earlier one."""
    def _do(prop_cls):
        _CUSTOM_REG.register(reg_name, override=True)(prop_cls)
        return prop_cls
    return _do


class _HostArray:
    """The NDArray-like host array a CustomOp sees: ``asnumpy()``,
    ``shape``, ``dtype``, indexing and slice assignment."""

    def __init__(self, arr: np.ndarray):
        self._arr = np.asarray(arr)

    def asnumpy(self):
        return self._arr

    @property
    def shape(self):
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def __getitem__(self, key):
        return self._arr[key]

    def __setitem__(self, key, value):
        self._arr[key] = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                                    else value)

    def copyto(self, other):
        other[:] = self._arr


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own (never sharing the tensor's
    memory)."""
    return t.detach().cpu().numpy().copy()


class _CustomFn(torch.autograd.Function):
    """The host round trip of a Custom node, forward and backward."""

    @staticmethod
    def forward(ctx, node, is_train, *xs):
        outs = node._run_forward(is_train, xs)
        ctx.node = node
        ctx.n_in = len(xs)
        ctx.save_for_backward(*xs, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs, ys = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = ctx.node._run_backward(xs, ys, gs)
        return (None, None) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[2:]))


@register_op("Custom")
class Custom(Operator):
    """The Custom symbol op: runs a registered CustomOpProp's operator on
    the host."""

    name_hint = "custom"
    PARAMS = {"op_type": Param(str, REQUIRED)}

    def __init__(self, **kwargs):
        op_type = kwargs.pop("op_type", None)
        if op_type is None:
            raise MXNetError("Custom: op_type required")
        prop_cls = _CUSTOM_REG.find(op_type)
        if prop_cls is None:
            raise MXNetError("Custom: op '%s' not registered" % op_type)
        self.params = {"op_type": op_type}
        # the remaining kwargs go to the prop, as strings from JSON
        self._prop = prop_cls(**kwargs)
        self._prop_kwargs = kwargs
        self._op_instance = None

    def param_str_dict(self):
        d = {"op_type": self.params["op_type"]}
        d.update({k: str(v) for k, v in self._prop_kwargs.items()})
        return d

    def list_arguments(self):
        return list(self._prop.list_arguments())

    def list_outputs(self):
        return list(self._prop.list_outputs())

    def list_auxiliary_states(self):
        return list(self._prop.list_auxiliary_states())

    def infer_shape(self, in_shapes):
        if any(s is None for s in in_shapes):
            raise MXNetError("Custom: all input shapes must be known")
        in_s, out_s, aux_s = self._prop.infer_shape([list(s) for s in in_shapes])
        return ([tuple(s) for s in in_s], [tuple(s) for s in out_s],
                [tuple(s) for s in aux_s])

    def infer_type(self, in_types, out_types=None):
        # the prop's rule, once every input dtype is known (user props
        # expect concrete dtypes; the default first-known rule would
        # spread an int label's dtype onto float inputs)
        if any(t is None for t in in_types):
            raise MXNetError("Custom: input dtypes not yet known")
        return self._prop.infer_type(list(in_types))

    def _get_op(self, in_shapes, in_dtypes) -> CustomOp:
        if self._op_instance is None:
            self._op_instance = self._prop.create_operator(
                None, [list(s) for s in in_shapes], in_dtypes)
        return self._op_instance

    def _signature(self, xs):
        in_shapes = [tuple(x.shape) for x in xs]
        in_dtypes = [np.dtype(str(x.dtype).replace("torch.", "")) for x in xs]
        _, out_shapes, _ = self.infer_shape(in_shapes)
        out_dtype = in_dtypes[0] if in_dtypes else np.dtype(np.float32)
        return in_shapes, in_dtypes, out_shapes, out_dtype

    def _run_forward(self, is_train, xs) -> List[torch.Tensor]:
        in_shapes, in_dtypes, out_shapes, out_dtype = self._signature(xs)
        op = self._get_op(in_shapes, in_dtypes)
        in_data = [_HostArray(_host(x)) for x in xs]
        out_data = [_HostArray(np.zeros(s, out_dtype)) for s in out_shapes]
        op.forward(is_train, ["write"] * len(out_data), in_data, out_data, [])
        device = xs[0].device if xs else torch.device("cpu")
        return [torch.from_numpy(np.ascontiguousarray(o.asnumpy(),
                                                      out_dtype)).to(device)
                for o in out_data]

    def _run_backward(self, xs, ys, gs) -> List[torch.Tensor]:
        in_shapes, in_dtypes, _, _ = self._signature(xs)
        op = self._get_op(in_shapes, in_dtypes)
        in_grad = [_HostArray(np.zeros(s, d))
                   for s, d in zip(in_shapes, in_dtypes)]
        op.backward(["write"] * len(xs), [_HostArray(_host(g)) for g in gs],
                    [_HostArray(_host(x)) for x in xs],
                    [_HostArray(_host(y)) for y in ys], in_grad, [])
        return [torch.from_numpy(np.ascontiguousarray(g.asnumpy(), d)).to(
            x.device) for g, d, x in zip(in_grad, in_dtypes, xs)]

    def apply(self, ctx, inputs, aux):
        return list(_CustomFn.apply(self, bool(ctx.is_train), *inputs)), []


def custom_nodes(symbol) -> List[str]:
    """The names of a symbol's Custom nodes, in topological order."""
    return [n.name for n in symbol._topo()
            if not n.is_variable and isinstance(n.op, Custom)]


# ---------------------------------------------------------------------------
# the legacy NumpyOp / NDArrayOp / PythonOp
# ---------------------------------------------------------------------------
class PythonOp:
    """Base of the legacy Python-op API; ``get_symbol()`` wires it into a
    graph through a Custom node."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym_mod

        pyop = self

        class _Prop(CustomOpProp):
            def __init__(self, **_kw):
                super().__init__(pyop.need_top_grad_)

            def list_arguments(self):
                return pyop.list_arguments()

            def list_outputs(self):
                return pyop.list_outputs()

            def infer_shape(self, in_shape):
                in_s, out_s = pyop.infer_shape(in_shape)
                return in_s, out_s, []

            def create_operator(self, ctx, in_shapes, in_dtypes):
                class _Op(CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        pyop.forward([x.asnumpy() for x in in_data], out_data)

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        pyop.backward([g.asnumpy() for g in out_grad],
                                      [x.asnumpy() for x in in_data],
                                      [y.asnumpy() for y in out_data],
                                      in_grad)
                return _Op()

        reg_name = "_pyop_%s_%d" % (type(self).__name__, id(self))
        register(reg_name)(_Prop)
        kwargs["op_type"] = reg_name
        return sym_mod.Custom(*args, **kwargs)


class NumpyOp(PythonOp):
    """Numpy-convention op: ``forward``/``backward`` write into numpy-like
    output slots by plain assignment."""


class NDArrayOp(PythonOp):
    """The device-array flavour; the same plumbing here, since the
    callback runs on the host either way."""
