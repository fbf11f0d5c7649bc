"""Graph executor, counterpart of ``mxnet_tpu/executor.py``.

Binding a Symbol yields an :class:`Executor` that evaluates the graph
node by node in topological order (:func:`make_graph_eval`, the same
walk and the same auxiliary-state slot order as the JAX package's
``make_graph_eval``). PyTorch runs eagerly, so there is nothing to
compile: each forward launches the ops' kernels on the current stream.

An inference forward runs under ``torch.inference_mode()``. A train
forward (``forward(is_train=True)``) records the autograd graph on
detached leaves of the bound arrays, ``requires_grad`` set where
``grad_req`` is not ``"null"``; ``backward`` runs autograd from the
heads (ones, or the given head gradients), writes or adds the
gradients into ``grad_arrays``, and only then commits the BatchNorm
moving statistics that the train forward computed, as the JAX package
commits them in its fused forward+backward (``executor.py:515-576``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ops.registry import OpContext

__all__ = ["Executor", "make_graph_eval"]


def make_graph_eval(symbol):
    """The graph-eval function of a symbol: ``eval_graph(arg_list,
    aux_list, rng, is_train, internals=None) -> (outputs, new_aux)`` over
    tensors; a dict passed as ``internals`` receives every op output as
    ``"<node>_<output>"`` (the monitor's names). Returns ``(eval_graph,
    n_aux)``."""
    nodes = symbol._topo()
    var_nodes = [n for n in nodes if n.is_variable]
    op_nodes = [n for n in nodes if not n.is_variable]
    aux_slots = {}
    slot = 0
    for n in op_nodes:
        k = len(n.op.list_auxiliary_states())
        if k:
            aux_slots[n.uid] = list(range(slot, slot + k))
            slot += k
    n_aux = slot
    out_index = [(n.uid, i) for n, i in symbol._outputs]

    def eval_graph(arg_list, aux_list, rng, is_train, internals=None):
        env = {n.uid: [a] for n, a in zip(var_nodes, arg_list)}
        aux_out = list(aux_list)
        octx = OpContext(is_train, rng)
        for n in op_nodes:
            ins = [env[src.uid][i] for src, i in n.inputs]
            slots = aux_slots.get(n.uid, ())
            outs, new_aux = n.op.apply(octx, ins, [aux_out[s] for s in slots])
            for s, a in zip(slots, new_aux):
                aux_out[s] = a
            env[n.uid] = list(outs)
            if internals is not None:
                for name, o in zip(n.op.list_outputs(), outs):
                    internals["%s_%s" % (n.name, name)] = o
        return [env[uid][i] for uid, i in out_index], aux_out

    return eval_graph, n_aux


def grad_req_dict(grad_req, names) -> Dict[str, str]:
    """``grad_req`` (one string, a list in ``names`` order, or a dict by
    name whose missing names are ``"null"``) as a dict over ``names``."""
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in names}
    elif isinstance(grad_req, (list, tuple)):
        reqs = dict(zip(names, grad_req))
    else:
        reqs = {n: grad_req.get(n, "null") for n in names}
    bad = sorted({r for r in reqs.values()
                  if r not in ("write", "add", "null")})
    if bad:
        raise MXNetError("grad_req must be write, add or null, got %s" % bad)
    return reqs


class Executor:
    """A symbol bound to arrays on one device. ``args_grad`` (a list in
    ``list_arguments`` order or a dict by name, entries may be missing)
    holds the gradient arrays; ``grad_req`` is ``"write"``, ``"add"`` or
    ``"null"``, as one string, a list or a dict by name. An argument
    without a gradient array gets ``"null"``."""

    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="write", aux_states=None,
                 seed: Optional[int] = None, label_names=None):
        self._symbol = symbol
        self._label_names = list(label_names or [])
        self._ctx = ctx
        self._device = ctx.torch_device()
        self._seed = seed
        self._rng: Optional[torch.Generator] = None
        self.arg_names = symbol.list_arguments()
        if len(set(self.arg_names)) != len(self.arg_names):
            dups = sorted({n for n in self.arg_names
                           if self.arg_names.count(n) > 1})
            raise MXNetError(
                "duplicate argument name(s) %s: reuse one Variable "
                "instance instead of creating it twice" % dups)
        self.output_names = symbol.list_outputs()
        self.aux_names = symbol.list_auxiliary_states()
        self.arg_arrays = self._to_list(args, self.arg_names, "args")
        self.arg_dict = dict(zip(self.arg_names, self.arg_arrays))
        self.grad_arrays = self._to_list(args_grad or {}, self.arg_names,
                                         "args_grad", allow_missing=True)
        self.grad_dict = {n: g for n, g in zip(self.arg_names,
                                               self.grad_arrays)
                          if g is not None}
        reqs = grad_req_dict(grad_req, self.arg_names)
        self._grad_req = {n: reqs[n] if n in self.grad_dict else "null"
                          for n in self.arg_names}
        self.aux_arrays = self._to_list(aux_states or [], self.aux_names,
                                        "aux_states")
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        self._eval_graph, _ = make_graph_eval(symbol)
        self._outputs: Optional[List[NDArray]] = None
        # the pending train forward: (heads, leaves by arg index, new aux)
        self._train = None
        self._monitor_callback: Optional[Callable] = None

    def _to_list(self, arrays, names, what, allow_missing=False):
        if isinstance(arrays, dict):
            out = [arrays.get(n) for n in names]
            missing = [n for n, a in zip(names, out) if a is None]
            if missing and not allow_missing:
                raise MXNetError("%s: missing arrays for %s"
                                 % (what, missing))
        else:
            out = list(arrays)
            if len(out) != len(names):
                raise MXNetError("%s: expected %d arrays, got %d"
                                 % (what, len(names), len(out)))
        for n, a in zip(names, out):
            if a is None and allow_missing:
                continue
            if not isinstance(a, NDArray):
                raise MXNetError("%s: '%s' must be an NDArray" % (what, n))
            if a.handle.device != self._device:
                raise MXNetError("%s: '%s' lives on %s, the executor on %s"
                                 % (what, n, a.context, self._ctx))
        return out

    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        """The generator of the train forward's random ops (Dropout),
        seeded with ``seed`` or, for an executor bound without one, at
        its first use from :mod:`mxnet_tpu_torch.random`'s stream, as
        the JAX package's executor takes its key."""
        if self._rng is None:
            if self._seed is None:
                from . import random as _random

                self._seed = _random.next_seed()
            self._rng = torch.Generator(device=self._device)
            self._rng.manual_seed(self._seed)
        return self._rng

    def draws_random(self) -> bool:
        """True where a train forward draws from the executor's
        generator (a Dropout with p > 0)."""
        return any(n.op.draws_random for n in self._symbol._topo()
                   if not n.is_variable)

    def run(self, arg_tensors, aux_tensors, is_train=False, internals=None):
        """Evaluate the graph on the given tensors without recording a
        graph (the fused inference step calls this with its packed
        params)."""
        rng = self._generator() if is_train else None
        with torch.inference_mode():
            outs, _ = self._eval_graph(arg_tensors, aux_tensors, rng,
                                       is_train, internals)
        return outs

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the forward pass; ``kwargs`` update named input arrays.
        ``is_train=True`` records the graph for :meth:`backward`."""
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("forward: unknown argument '%s'" % name)
            self.arg_dict[name][:] = arr
        self._train = None
        aux = [a.handle for a in self.aux_arrays]
        internals = {} if self._monitor_callback is not None else None
        if not is_train:
            outs = self.run([a.handle for a in self.arg_arrays], aux,
                            internals=internals)
        else:
            leaves = [a.handle.detach().requires_grad_(
                self._grad_req[n] != "null")
                for n, a in zip(self.arg_names, self.arg_arrays)]
            with torch.enable_grad():
                outs, new_aux = self._eval_graph(
                    leaves, aux, self._generator(), True, internals)
            self._train = (outs, leaves, new_aux)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        for name, value in (internals or {}).items():
            self._monitor_callback(name, NDArray(value.detach(), self._ctx))
        return self._outputs

    def set_monitor_callback(self, callback: Callable[[str, NDArray], None]):
        """Call ``callback(name, array)`` on every op output of each
        forward, named ``"<node>_<output>"`` (a Monitor's
        ``stat_helper``)."""
        self._monitor_callback = callback

    def backward(self, out_grads=None):
        """Gradients of the heads of the last train forward into
        ``grad_arrays`` (by ``grad_req``), then the moving statistics
        into ``aux_arrays``. ``out_grads`` (an NDArray or a list, one per
        output) default to ones; SoftmaxOutput ignores its head
        gradient."""
        if self._train is None:
            raise MXNetError("backward called without forward(is_train=True)")
        outs, leaves, new_aux = self._train
        self._train = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise MXNetError("backward: %d head gradients for %d outputs"
                                 % (len(out_grads), len(outs)))
            heads = [g.handle.to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        want = [i for i, n in enumerate(self.arg_names)
                if self._grad_req[n] != "null"]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(want)
        if want and pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[i] for i in want],
                                        [h for _, h in pairs],
                                        allow_unused=True)
        for i, g in zip(want, grads):
            dst = self.grad_arrays[i].handle
            if self._grad_req[self.arg_names[i]] == "add":
                if g is not None:
                    dst.add_(g)
            elif g is None:
                dst.zero_()
            else:
                dst.copy_(g)
        for arr, new in zip(self.aux_arrays, new_aux):
            if new is not arr.handle:
                arr.handle.copy_(new)

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("unknown param '%s'" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("unknown aux '%s'" % name)

    def reshape(self, partial_shaping: bool = False,
                allow_up_sizing: bool = False, fresh_args=(),
                **kwargs) -> "Executor":
        """Rebind to new input shapes. Each argument, gradient and aux
        array whose shape is unchanged is shared; the others are new
        zeros. ``grad_req``, the label names and the seed carry over.
        Names in ``fresh_args`` always get new storage, so writes through
        the new executor cannot reach the old one's inputs."""
        from . import ndarray as nd

        fresh = set(fresh_args)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = []
        new_grads: Dict[str, NDArray] = {}
        for name, shape, arr, grad in zip(self.arg_names, arg_shapes,
                                          self.arg_arrays, self.grad_arrays):
            if shape == arr.shape and name not in fresh:
                new_args.append(arr)
                if grad is not None:
                    new_grads[name] = grad
            else:
                new_args.append(nd.zeros(shape, ctx=self._ctx,
                                         dtype=arr.handle.dtype))
                if grad is not None:
                    new_grads[name] = nd.zeros(shape, ctx=self._ctx,
                                               dtype=grad.handle.dtype)
        new_aux = [arr if shape == arr.shape
                   else nd.zeros(shape, ctx=self._ctx,
                                 dtype=arr.handle.dtype)
                   for shape, arr in zip(aux_shapes, self.aux_arrays)]
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, seed=self._seed,
                        label_names=self._label_names)

    def debug_str(self) -> str:
        """The graph, one node a line: name, op (``var`` for a variable)
        and the names of its inputs."""
        lines = ["Symbol outputs: %s" % self.output_names]
        for n in self._symbol._topo():
            kind = "var" if n.is_variable else n.op.op_name
            lines.append("  %-30s %s <- %s" % (
                n.name, kind, [src.name for src, _ in n.inputs]))
        return "\n".join(lines)
