"""Operator registry and base class, counterpart of
``mxnet_tpu/ops/registry.py``.

Each operator declares its arguments, outputs and auxiliary states, its
shape and dtype inference, and an ``apply`` over tensors. ``PARAMS`` holds
:class:`Param` specs; their names, defaults and string forms equal the
JAX package's, so a symbol's JSON reads the same in both packages
(``Param.parse`` reads what ``tojson`` writes: ``"(3, 3)"``,
``"False"``, ``"2e-05"``).
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, Registry

__all__ = ["Param", "REQUIRED", "Operator", "OpContext", "register_op",
           "OP_REGISTRY", "create_operator", "get_operator_class",
           "same_shape_binary"]

OP_REGISTRY: Registry = Registry.get_registry("operator")

REQUIRED = object()


class Param:
    """One declared parameter (``DMLC_DECLARE_PARAMETER`` field)."""

    def __init__(self, ptype, default=REQUIRED, doc=""):
        self.ptype = ptype      # int/float/bool/str/'shape'
        self.default = default
        self.doc = doc

    def parse(self, value):
        if value is None:
            return None
        if self.ptype == "shape":
            if isinstance(value, str):
                value = ast.literal_eval(value)
            if isinstance(value, int):
                value = (value,)
            return tuple(int(v) for v in value)
        if self.ptype is bool:
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes")
            return bool(value)
        if self.ptype is int and isinstance(value, str):
            return int(value)
        if self.ptype is float and isinstance(value, str):
            return float(value)
        return self.ptype(value)


class OpContext:
    """Per-invocation context handed to ``apply``: the training-mode flag
    and a ``torch.Generator`` for random ops (None at inference)."""

    __slots__ = ("is_train", "rng")

    def __init__(self, is_train: bool, rng=None):
        self.is_train = is_train
        self.rng = rng


class Operator:
    """Base class: one instance per graph node, holding parsed params."""

    PARAMS: Dict[str, Param] = {}
    name_hint = "op"

    def __init__(self, **kwargs):
        unknown = [k for k in kwargs if k not in self.PARAMS]
        if unknown:
            raise MXNetError("%s: unknown parameters %s (known: %s)" % (
                type(self).__name__, sorted(unknown), sorted(self.PARAMS)))
        params = {}
        for key, spec in self.PARAMS.items():
            if key in kwargs:
                params[key] = spec.parse(kwargs.pop(key))
            elif spec.default is REQUIRED:
                raise MXNetError("%s: required parameter '%s' missing"
                                 % (type(self).__name__, key))
            else:
                params[key] = spec.default
        self.params = params

    def __getattr__(self, item):
        try:
            return self.__dict__["params"][item]
        except KeyError:
            raise AttributeError(item)

    # -- interface ---------------------------------------------------------
    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    @property
    def num_outputs(self) -> int:
        return len(self.list_outputs())

    @property
    def draws_random(self) -> bool:
        """True where a train-mode ``apply`` draws from ``OpContext.rng``."""
        return False

    def infer_shape(self, in_shapes: List[Optional[Tuple[int, ...]]]):
        """Returns (in_shapes, out_shapes, aux_shapes); fills unknowns
        or raises."""
        shape = _first_known(in_shapes)
        if shape is None:
            raise MXNetError("%s: cannot infer shape" % type(self).__name__)
        return [shape] * len(in_shapes), [shape], []

    def infer_type(self, in_types, out_types=None):
        """Returns (in_types, out_types, aux_types) as numpy dtypes: every
        input and output takes the first dtype known on either side (so
        the symbol's fixpoint propagates both ways), aux states stay
        float32; None-filled while nothing is known."""
        known = list(in_types) + list(out_types or [])
        dtype = next((t for t in known if t is not None), None)
        aux = [np.dtype(np.float32)] * len(self.list_auxiliary_states())
        if dtype is None:
            return list(in_types), [None] * self.num_outputs, aux
        return [dtype] * len(in_types), [dtype] * self.num_outputs, aux

    def apply(self, ctx: OpContext, inputs: Sequence[Any],
              aux: Sequence[Any]):
        """Tensors in -> (outputs, new_aux)."""
        raise NotImplementedError

    def param_str_dict(self) -> Dict[str, str]:
        return {k: str(v) for k, v in self.params.items() if v is not None}


def _first_known(shapes):
    for s in shapes:
        if s is not None:
            return s
    return None


def register_op(name: str, aliases: Sequence[str] = ()):
    """Register an Operator subclass under ``name`` (+ aliases)."""

    def _do(cls):
        cls.op_name = name
        cls.op_aliases = tuple(aliases)
        OP_REGISTRY.register(name)(cls)
        for alias in aliases:
            if OP_REGISTRY.find(alias) is cls:
                continue
            OP_REGISTRY.register(alias)(cls)
        return cls
    return _do


def create_operator(op_name: str, **params) -> Operator:
    return OP_REGISTRY.get(op_name)(**params)


def get_operator_class(op_name: str):
    """Registered Operator class, or None if unknown."""
    return OP_REGISTRY.find(op_name)


def same_shape_binary(in_shapes):
    """Shape rule for elementwise binary ops: both inputs same shape."""
    known = _first_known(in_shapes)
    if known is None:
        raise MXNetError("cannot infer shape of elementwise op")
    filled = [s if s is not None else known for s in in_shapes]
    for s in filled:
        if s != known:
            raise MXNetError("elementwise op shape mismatch: %s" % (filled,))
    return filled, [known], []
