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

import numpy as np
import torch

from .attribute import AttrScope
from .base import MXNetError
from .executor import _UNSET
from .name import NameManager
from .ops import OP_REGISTRY, Operator, create_operator
from .ops.registry import get_operator_class

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]

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
    """DFS post-order: inputs before the nodes that read them, in the
    order of the JAX package's recursive walk. It keeps its own stack, so
    a long unrolled graph (an LSTM over 60 steps) does not reach
    Python's recursion limit."""
    seen = set()
    order: List[_Node] = []
    for head in head_nodes:
        if id(head) in seen:
            continue
        seen.add(id(head))
        stack = [(head, 0)]
        while stack:
            node, i = stack[-1]
            if i < len(node.inputs):
                stack[-1] = (node, i + 1)
                src = node.inputs[i][0]
                if id(src) not in seen:
                    seen.add(id(src))
                    stack.append((src, 0))
            else:
                stack.pop()
                order.append(node)
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

    # -- attributes --------------------------------------------------------
    def attr(self, key: str) -> Optional[str]:
        """The attribute ``key`` of a single-output symbol's node."""
        if len(self._outputs) == 1:
            return self._outputs[0][0].attrs.get(key)
        return None

    def list_attr(self) -> Dict[str, str]:
        """A single-output symbol's node attributes."""
        if len(self._outputs) == 1:
            return dict(self._outputs[0][0].attrs)
        return {}

    # -- composition -------------------------------------------------------
    def __getitem__(self, index) -> "Symbol":
        """Output ``index``, by position or by output name."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output '%s' not found in %s"
                                 % (index, names))
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    def get_internals(self) -> "Symbol":
        """Symbol exposing every internal node output."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of a single-output op symbol, grouped; None for a
        variable or a group."""
        if len(self._outputs) != 1 or self._outputs[0][0].is_variable:
            return None
        return Symbol(list(self._outputs[0][0].inputs))

    def grad(self, wrt: Sequence[str]) -> "Symbol":
        """A bindable symbol whose outputs are d(sum of this symbol's
        outputs)/d(arg) for each name in ``wrt``: one node that runs the
        whole graph and ``torch.autograd.grad`` over it (the JAX package's
        node closes over ``jax.vjp``). Integer heads take no part; an
        argument the heads do not reach gets zeros. Not JSON-serialisable,
        as in the JAX package."""
        wrt = list(wrt)
        arg_names = self.list_arguments()
        missing = [w for w in wrt if w not in arg_names]
        if missing:
            raise MXNetError("grad: unknown arguments %s (args: %s)"
                             % (missing, arg_names))
        node = _Node(_GradOp(self, arg_names, wrt),
                     NameManager.current().get(None, "grad"),
                     [(n, 0) for n in self._topo() if n.is_variable], {})
        return Symbol([(node, i) for i in range(len(wrt))])

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

    # -- shape and type inference -----------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from known input shapes,
        by fixpoint propagation through each op's infer_shape."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what cannot be inferred
        instead of an error."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
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
                    if partial:
                        aux_list.extend(
                            [None] * len(node.op.list_auxiliary_states()))
                        continue
                    raise MXNetError("cannot infer aux shapes of %s"
                                     % node.name)
                aux_list.extend(aux_shapes[node.uid])
        if partial:
            return arg_shapes, out_shapes, aux_list
        suffix = (" (last node error: %s)" % last_err
                  if last_err is not None else "")
        if any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown args: %s%s"
                             % (missing, suffix))
        if any(s is None for s in out_shapes):
            raise MXNetError("infer_shape could not infer outputs%s" % suffix)
        return arg_shapes, out_shapes, aux_list

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes, by fixpoint
        propagation through each op's ``infer_type`` in both directions
        from the given dtypes (positional in ``list_arguments`` order, or
        by name). Arguments left untyped default to float32; a given
        dtype that propagation contradicts raises."""
        arg_names = self.list_arguments()
        known: Dict[str, np.dtype] = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional types")
            for name, t in zip(arg_names, args):
                if t is not None:
                    known[name] = np.dtype(t)
        for name, t in kwargs.items():
            if name not in arg_names:
                raise MXNetError("infer_type: unknown argument '%s' "
                                 "(args: %s)" % (name, arg_names))
            if t is not None:   # np.dtype(None) would be float64
                known[name] = np.dtype(t)

        nodes = self._topo()
        types: Dict[int, List[Optional[np.dtype]]] = {}
        aux_types: Dict[int, List[np.dtype]] = {}
        seeded = set()
        for node in nodes:
            types[node.uid] = [None] * node.num_outputs()
            if node.is_variable and node.name in known:
                types[node.uid][0] = known[node.name]
                seeded.add(node.uid)

        def store(uid, i, t, by):
            t = np.dtype(t)
            cur = types[uid][i]
            if cur is None:
                types[uid][i] = t
                return True
            if cur != t:
                raise MXNetError(
                    "infer_type: op '%s' infers dtype %s where %s was %s"
                    % (by, t, "explicitly given" if uid in seeded
                       else "already inferred", cur))
            return False

        def visit(node):
            try:
                in_filled, out_filled, aux = node.op.infer_type(
                    [types[src.uid][i] for src, i in node.inputs],
                    list(types[node.uid]))
            except MXNetError:
                return False
            changed = False
            for (src, i), t in zip(node.inputs, in_filled):
                if t is not None:
                    changed |= store(src.uid, i, t, node.name)
            for i, t in enumerate(out_filled):
                if t is not None:
                    changed |= store(node.uid, i, t, node.name)
            aux_types[node.uid] = [np.dtype(t) for t in aux]
            return changed

        op_nodes = [n for n in nodes if not n.is_variable]

        def fixpoint():
            for _ in range(len(op_nodes) + 2):
                changed = False
                for node in op_nodes:
                    changed |= visit(node)
                for node in reversed(op_nodes):
                    changed |= visit(node)
                if not changed:
                    break

        fixpoint()
        defaulted = False
        for node in nodes:
            if node.is_variable and types[node.uid][0] is None:
                types[node.uid][0] = np.dtype("float32")
                defaulted = True
        if defaulted:
            fixpoint()

        arg_types = [types[n.uid][0] for n in nodes if n.is_variable]
        out_types = [types[n.uid][i] for n, i in self._outputs]
        aux_list: List[np.dtype] = []
        for node in op_nodes:
            n_aux = len(node.op.list_auxiliary_states())
            if n_aux:
                aux_list.extend(aux_types.get(
                    node.uid, [np.dtype("float32")] * n_aux))
        if any(t is None for t in out_types):
            raise MXNetError("infer_type could not infer output dtypes")
        return arg_types, out_types, aux_list

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

    def save(self, fname: str) -> None:
        """Write :meth:`tojson` to ``fname`` (UTF-8; a path or a URI of
        :mod:`mxnet_tpu_torch.filesystem`), as the JAX package's
        ``Symbol.save`` does; either package's :func:`load` reads it."""
        from .filesystem import open_uri

        with open_uri(fname, "wb") as f:
            f.write(self.tojson().encode("utf-8"))

    # -- binding -----------------------------------------------------------
    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """Node name -> its attributes, for every node that has some
        (the optimizer reads ``__lr_mult__``/``__wd_mult__`` here)."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, compute_dtype=_UNSET,
                    label_names=None, **kwargs):
        """Infer shapes (``kwargs``: name -> shape), allocate zero arrays on
        ``ctx`` (and a gradient array for every argument whose
        ``grad_req`` is not ``"null"``) and bind, with ``group2ctx`` and
        ``shared_exec`` as :meth:`bind` takes them, and the executor's
        ``compute_dtype`` and ``label_names``. Dtypes come from
        :meth:`infer_type` seeded with ``type_dict``: float32 unless
        propagation gives another."""
        from . import ndarray as nd
        from .executor import grad_req_dict

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        names = self.list_arguments()
        dtypes, _, aux_dtypes = self.infer_type(**(type_dict or {}))
        args = [nd.zeros(s, ctx=ctx, dtype=t)
                for s, t in zip(arg_shapes, dtypes)]
        reqs = grad_req_dict(grad_req, names)
        grads = {n: nd.zeros(s, ctx=ctx, dtype=t)
                 for n, s, t in zip(names, arg_shapes, dtypes)
                 if reqs[n] != "null"}
        aux = [nd.zeros(s, ctx=ctx, dtype=t)
               for s, t in zip(aux_shapes, aux_dtypes)]
        return self.bind(ctx, args, grads, grad_req=grad_req, aux_states=aux,
                         group2ctx=group2ctx, shared_exec=shared_exec,
                         compute_dtype=compute_dtype, label_names=label_names)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None, **kwargs):
        """Bind arrays (a list in ``list_arguments`` order, or a dict by
        name) to this graph on ``ctx``; ``args_grad`` receives the
        gradients of ``backward`` by ``grad_req``. ``group2ctx`` (group
        name -> Context) runs each node of a ``ctx_group`` on its group's
        context; ``shared_exec`` is accepted; ``kwargs`` go to the
        :class:`~mxnet_tpu_torch.executor.Executor` (``compute_dtype``,
        ``label_names``, ``seed``)."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec,
                        **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Bind to the NDArrays given by name (on ``ctx``, the current
        context by default) and return an inference forward's outputs."""
        from .context import current_context

        executor = self.bind(ctx or current_context(), dict(kwargs),
                             grad_req="null")
        return executor.forward(is_train=False)


class _GradOp(Operator):
    """The node of :meth:`Symbol.grad`: its inputs are the base symbol's
    arguments, its outputs the gradients of the sum of the base's float
    outputs with respect to ``wrt``."""

    name_hint = "grad"

    def __init__(self, base: Symbol, arg_names: List[str], wrt: List[str]):
        super().__init__()
        self._base = base
        self._arg_names = arg_names
        self._wrt = wrt
        self._eval = None

    def list_arguments(self):
        return list(self._arg_names)

    def list_outputs(self):
        return ["%s_grad" % w for w in self._wrt]

    def list_auxiliary_states(self):
        return self._base.list_auxiliary_states()

    @property
    def draws_random(self) -> bool:
        return any(n.op.draws_random for n in self._base._topo()
                   if not n.is_variable)

    def infer_shape(self, in_shapes):
        known = {n: s for n, s in zip(self._arg_names, in_shapes)
                 if s is not None}
        in_filled, _, aux_shapes = self._base.infer_shape_partial(**known)
        by_name = dict(zip(self._arg_names, in_filled))
        out_shapes = [by_name[w] for w in self._wrt]
        if any(s is None for s in out_shapes):
            raise MXNetError("grad: wrt shapes not inferable")
        return in_filled, out_shapes, aux_shapes

    def infer_type(self, in_types, out_types=None):
        dtype = next((t for t in in_types if t is not None), None)
        aux_types = [np.dtype(np.float32)] * len(
            self._base.list_auxiliary_states())
        if dtype is None:
            return list(in_types), [None] * len(self._wrt), aux_types
        return ([t if t is not None else dtype for t in in_types],
                [dtype] * len(self._wrt), aux_types)

    def apply(self, ctx, inputs, aux):
        from .executor import make_graph_eval

        if self._eval is None:
            self._eval = make_graph_eval(self._base)[0]
        idx = [self._arg_names.index(w) for w in self._wrt]
        # the caller may be an inference forward: clones outside
        # inference mode are ordinary tensors autograd can record
        with torch.inference_mode(False), torch.enable_grad():
            args = [x.detach().clone() for x in inputs]
            leaves = [args[i].requires_grad_(args[i].is_floating_point())
                      for i in idx]
            outs, aux_out = self._eval(args, [a.clone() for a in aux],
                                       ctx.rng, ctx.is_train)
            heads = [o for o in outs if o.requires_grad]
            diff = [x for x in leaves if x.requires_grad]
            got = iter(torch.autograd.grad(
                heads, diff, [torch.ones_like(o) for o in heads],
                allow_unused=True) if heads and diff else ())
            grads = []
            for x in leaves:
                g = next(got) if x.requires_grad else None
                grads.append(torch.zeros_like(x) if g is None else g)
        return [g.detach() for g in grads], [a.detach() for a in aux_out]


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


def load(fname: str) -> Symbol:
    """A symbol from a JSON file (a path or a URI) that either package's
    ``save`` wrote."""
    from .filesystem import open_uri

    with open_uri(fname, "rb") as f:
        return load_json(f.read().decode("utf-8"))


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


def _make_minmax(fname, op, scalar_op, number_fn):
    """``maximum`` / ``minimum``: symbol x symbol, symbol x scalar in
    either order, or two plain numbers (which give the number)."""

    def fn(lhs, rhs):
        if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
            return _binary_create(op, scalar_op, lhs, rhs)
        if isinstance(lhs, Symbol):
            return _scalar_create(scalar_op, lhs, rhs)
        if isinstance(rhs, Symbol):
            return _scalar_create(scalar_op, rhs, lhs)
        return number_fn(lhs, rhs)

    fn.__name__ = fname
    fn.__doc__ = _make_minmax.__doc__
    return fn


maximum = _make_minmax("maximum", "_Maximum", "_MaximumScalar",
                       lambda a, b: a if a > b else b)
minimum = _make_minmax("minimum", "_Minimum", "_MinimumScalar",
                       lambda a, b: a if a < b else b)


def pow(lhs, rhs):
    """``lhs ** rhs`` for any mix of symbols and scalars; two numbers
    give the plain power."""
    if isinstance(lhs, Symbol):
        return lhs ** rhs
    if isinstance(rhs, Symbol):
        return rhs.__rpow__(lhs)
    return lhs ** rhs


__all__ += ["maximum", "minimum", "pow"]
