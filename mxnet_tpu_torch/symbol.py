"""Symbolic graph layer, counterpart of ``mxnet_tpu/symbol.py``.

A Symbol is a list of (node, output_index) heads over a DAG of operator
nodes. Composition, operator overloading, ``list_arguments`` /
``list_outputs`` / ``list_auxiliary_states``, ``infer_shape`` and the
JSON form follow the JAX package exactly, so a graph saved by either
package loads in the other with the same names and shapes. ``bind``
yields an :class:`~mxnet_tpu_torch.executor.Executor` that evaluates the
graph in topological order.

Symbol creation functions for every registered operator are generated at
import (``Convolution``, ``BatchNorm``, ``_Plus``, ...).
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

from .attribute import AttrScope
from .base import MXNetError
from .name import NameManager
from .ops import OP_REGISTRY, Operator, create_operator
from .ops.registry import get_operator_class

__all__ = ["Symbol", "Variable", "Group", "load_json"]

_node_uid = itertools.count()


class _Node:
    """One graph node: an operator application or (op is None) a variable."""

    __slots__ = ("op", "name", "inputs", "attrs", "uid")

    def __init__(self, op: Optional[Operator], name: str,
                 inputs: List[Tuple["_Node", int]], attrs: Dict[str, str]):
        self.op = op
        self.name = name
        self.inputs = inputs
        self.attrs = attrs
        self.uid = next(_node_uid)

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def num_outputs(self) -> int:
        return 1 if self.op is None else self.op.num_outputs


def topo_order(head_nodes: Sequence[_Node]) -> List[_Node]:
    """DFS post-order: inputs before the nodes that read them."""
    seen = set()
    order: List[_Node] = []

    def visit(node: _Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for src, _ in node.inputs:
            visit(src)
        order.append(node)

    for node in head_nodes:
        visit(node)
    return order


class Symbol:
    """Immutable symbolic expression; composes through the generated op
    creation functions and python operators, like ``mx.sym``."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    # -- introspection -----------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _head_nodes(self) -> List[_Node]:
        seen, heads = set(), []
        for node, _ in self._outputs:
            if id(node) not in seen:
                seen.add(id(node))
                heads.append(node)
        return heads

    def _topo(self) -> List[_Node]:
        return topo_order(self._head_nodes())

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                names.append("%s_%s" % (node.name,
                                        node.op.list_outputs()[idx]))
        return names

    def list_auxiliary_states(self) -> List[str]:
        return ["%s_%s" % (node.name, aux)
                for node in self._topo() if not node.is_variable
                for aux in node.op.list_auxiliary_states()]

    # -- composition -------------------------------------------------------
    def get_internals(self) -> "Symbol":
        """Symbol exposing every internal node output."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    # -- operator overloading (the registered _Plus etc.) ------------------
    def __add__(self, other):
        return _binary_create("_Plus", "_PlusScalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _binary_create("_Minus", "_MinusScalar", self, other)

    def __rsub__(self, other):
        return _scalar_create("_RMinusScalar", self, other)

    def __mul__(self, other):
        return _binary_create("_Mul", "_MulScalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _binary_create("_Div", "_DivScalar", self, other)

    def __rtruediv__(self, other):
        return _scalar_create("_RDivScalar", self, other)

    def __pow__(self, other):
        return _binary_create("_Power", "_PowerScalar", self, other)

    def __rpow__(self, other):
        return _scalar_create("_RPowerScalar", self, other)

    def __neg__(self):
        return _scalar_create("_MulScalar", self, -1.0)

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __repr__(self):
        return "<Symbol %s>" % (self.name or
                                "group[%d]" % len(self._outputs))

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from known input shapes,
        by fixpoint propagation through each op's infer_shape."""
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional shapes")
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        for name, shape in kwargs.items():
            if name not in arg_names:
                raise MXNetError("infer_shape: unknown argument '%s' "
                                 "(args: %s)" % (name, arg_names))
            known[name] = tuple(shape)

        nodes = self._topo()
        shapes: Dict[int, List[Optional[tuple]]] = {}
        aux_shapes: Dict[int, List[tuple]] = {}
        for node in nodes:
            shapes[node.uid] = [None] * node.num_outputs()
            if node.is_variable:
                if node.name in known:
                    shapes[node.uid][0] = known[node.name]
                elif node.attrs.get("__shape__"):
                    shapes[node.uid][0] = tuple(
                        int(v) for v in
                        node.attrs["__shape__"].strip("()").split(",")
                        if v.strip())

        # fixpoint forward propagation with write-back into variables
        last_err: Optional[MXNetError] = None
        for _ in range(3):
            changed = False
            for node in nodes:
                if node.is_variable:
                    continue
                in_shapes = [shapes[src.uid][i] for src, i in node.inputs]
                try:
                    in_filled, out_filled, aux = node.op.infer_shape(
                        in_shapes)
                except MXNetError as e:
                    last_err = e
                    continue
                for (src, i), s in zip(node.inputs, in_filled):
                    if s is not None and shapes[src.uid][i] != tuple(s):
                        shapes[src.uid][i] = tuple(s)
                        changed = True
                for i, s in enumerate(out_filled):
                    if shapes[node.uid][i] != tuple(s):
                        shapes[node.uid][i] = tuple(s)
                        changed = True
                aux_shapes[node.uid] = [tuple(s) for s in aux]
            if not changed:
                break

        arg_shapes = [shapes[n.uid][0] for n in nodes if n.is_variable]
        out_shapes = [shapes[n.uid][i] for n, i in self._outputs]
        aux_list: List[Optional[tuple]] = []
        for node in nodes:
            if not node.is_variable and node.op.list_auxiliary_states():
                if node.uid not in aux_shapes:
                    raise MXNetError("cannot infer aux shapes of %s"
                                     % node.name)
                aux_list.extend(aux_shapes[node.uid])
        suffix = (" (last node error: %s)" % last_err
                  if last_err is not None else "")
        if any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown args: %s%s"
                             % (missing, suffix))
        if any(s is None for s in out_shapes):
            raise MXNetError("infer_shape could not infer outputs%s" % suffix)
        return arg_shapes, out_shapes, aux_list

    # -- serialization -----------------------------------------------------
    def tojson(self) -> str:
        nodes = self._topo()
        nid = {n.uid: i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_variable else n.op.op_name,
            "name": n.name,
            "param": {} if n.is_variable else n.op.param_str_dict(),
            "inputs": [[nid[src.uid], i] for src, i in n.inputs],
            "attr": dict(n.attrs),
        } for n in nodes]
        heads = [[nid[n.uid], i] for n, i in self._outputs]
        return json.dumps({"nodes": jnodes,
                           "arg_nodes": [i for i, n in enumerate(nodes)
                                         if n.is_variable],
                           "heads": heads}, indent=2)

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx, grad_req="null", type_dict=None, **kwargs):
        """Infer shapes, allocate zero arrays on ``ctx`` and bind.
        Arrays are float32 unless ``type_dict`` names another dtype."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        type_dict = type_dict or {}
        args = [nd.zeros(s, ctx=ctx, dtype=type_dict.get(n, "float32"))
                for n, s in zip(self.list_arguments(), arg_shapes)]
        aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
        return self.bind(ctx, args, grad_req=grad_req, aux_states=aux)

    def bind(self, ctx, args, args_grad=None, grad_req="null",
             aux_states=None):
        """Bind arrays (a list in ``list_arguments`` order, or a dict by
        name) to this graph on ``ctx``."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def Variable(name: str, attr: Optional[Dict[str, str]] = None,
             shape=None, lr_mult=None, wd_mult=None, dtype=None,
             init=None) -> Symbol:
    """Create a symbolic variable."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    attr = AttrScope.current().get(attr)
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attr["__dtype__"] = str(dtype)
    return Symbol([(_Node(None, name, [], attr), 0)])


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """Group symbols into one multi-output symbol."""
    outputs: List[Tuple[_Node, int]] = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group expects Symbols")
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        inputs = [(nodes[i], idx) for i, idx in jn["inputs"]]
        op = None if jn["op"] == "null" \
            else create_operator(jn["op"], **jn.get("param", {}))
        nodes.append(_Node(op, jn["name"], inputs, dict(jn.get("attr", {}))))
    return Symbol([(nodes[i], idx) for i, idx in data["heads"]])


def _create(op_name: str, *args, **kwargs) -> Symbol:
    """Apply a registered operator: the generated creation functions call
    this (``Symbol::Create`` + ``Compose``)."""
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    param_kwargs = {k: v for k, v in kwargs.items()
                    if not isinstance(v, Symbol)}
    # variadic ops (Concat, ElementWiseSum) fill num_args from the
    # positional input count
    if args and "num_args" not in param_kwargs:
        cls = get_operator_class(op_name)
        if cls is not None and "num_args" in getattr(cls, "PARAMS", {}):
            param_kwargs["num_args"] = len(args)
    op = create_operator(op_name, **param_kwargs)
    arg_names = op.list_arguments()
    name = NameManager.current().get(name, op.name_hint)
    attrs = AttrScope.current().get(attr)

    if args and sym_kwargs:
        raise MXNetError("%s: cannot mix positional and keyword symbol "
                         "inputs" % op_name)
    inputs_by_name: Dict[str, Symbol] = dict(sym_kwargs)
    for argn, s in zip(arg_names, args):
        if not isinstance(s, Symbol):
            raise TypeError("%s: positional inputs must be Symbols"
                            % op_name)
        inputs_by_name[argn] = s
    for k in inputs_by_name:
        if k not in arg_names:
            raise MXNetError("%s: unknown input '%s' (expects %s)"
                             % (op_name, k, arg_names))

    inputs: List[Tuple[_Node, int]] = []
    for argn in arg_names:
        if argn in inputs_by_name:
            s = inputs_by_name[argn]
            if len(s._outputs) != 1:
                raise MXNetError("%s: input '%s' must be single-output"
                                 % (op_name, argn))
            inputs.append(s._outputs[0])
        else:
            # missing inputs become variables named <op>_<arg>
            var = _Node(None, "%s_%s" % (name, argn), [],
                        AttrScope.current().get(None))
            inputs.append((var, 0))
    node = _Node(op, name, inputs, attrs)
    return Symbol([(node, i) for i in range(op.num_outputs)])


def _binary_create(op_name, scalar_op_name, lhs, rhs) -> Symbol:
    if isinstance(rhs, Symbol):
        return _create(op_name, lhs=lhs, rhs=rhs)
    return _scalar_create(scalar_op_name, lhs, rhs)


def _scalar_create(op_name, data, scalar) -> Symbol:
    return _create(op_name, data=data, scalar=float(scalar))


def _make_creator(op_name: str):
    def creator(*args, **kwargs):
        return _create(op_name, *args, **kwargs)
    creator.__name__ = op_name
    creator.__doc__ = (OP_REGISTRY.get(op_name).__doc__
                       or "Apply operator %s." % op_name)
    return creator


def _init_symbol_module():
    done = set()
    for _, cls in list(OP_REGISTRY.items()):
        for op_name in (cls.op_name,) + getattr(cls, "op_aliases", ()):
            if op_name in done:
                continue
            done.add(op_name)
            fn = _make_creator(cls.op_name)
            fn.__name__ = op_name
            globals()[op_name] = fn
            if not op_name.startswith("_"):
                __all__.append(op_name)


_init_symbol_module()
