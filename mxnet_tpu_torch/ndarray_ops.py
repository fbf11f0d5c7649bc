"""Every registered operator as an imperative function,
``mx.nd.<OpName>(*arrays, **params)``, counterpart of
``mxnet_tpu/ndarray_ops.py``: the op's ``apply`` on the arrays' tensors,
without autograd, its outputs as NDArrays on the inputs' device. Names
``ndarray`` already defines (the function zoo) are skipped; an op with
auxiliary states (BatchNorm) raises; ``is_train=True`` and an op
without inputs draw their random numbers from
:mod:`mxnet_tpu_torch.random`'s stream.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import current_context
from .ndarray import NDArray, _same_device
from .ops import OP_REGISTRY, OpContext

__all__ = ["init_ndarray_ops"]


def _make_imperative(op_name: str):
    cls = OP_REGISTRY.get(op_name)

    def fn(*args, **params):
        is_train = params.pop("is_train", False)
        op = cls(**params)
        arg_names = op.list_arguments()
        if len(args) != len(arg_names):
            raise MXNetError("%s expects inputs %s, got %d arrays"
                             % (op_name, arg_names, len(args)))
        if op.list_auxiliary_states():
            raise MXNetError(
                "%s has auxiliary states; use the symbolic API" % op_name)
        if not all(isinstance(a, NDArray) for a in args):
            raise MXNetError("%s: inputs must be NDArrays" % op_name)
        if args:
            _same_device(*args)
            ctx = args[0].context
        else:
            ctx = current_context()
        rng = None
        if is_train or not args:
            from . import random as _random

            rng = _random.generator(ctx.torch_device())
        with torch.no_grad():
            outs, _ = op.apply(OpContext(is_train, rng),
                               [a.handle for a in args], [])
        res = [NDArray(o, ctx) for o in outs]
        return res[0] if len(res) == 1 else res

    fn.__name__ = op_name
    fn.__doc__ = cls.__doc__ or "Imperative %s." % op_name
    return fn


def init_ndarray_ops(nd_module):
    """Put an imperative function for each registered op (and alias)
    into ``nd_module``, skipping names it already defines."""
    done = set()
    for _, cls in list(OP_REGISTRY.items()):
        for name in (cls.op_name,) + getattr(cls, "op_aliases", ()):
            if name in done or hasattr(nd_module, name):
                continue
            done.add(name)
            setattr(nd_module, name, _make_imperative(name))
