"""Graph executor, counterpart of ``mxnet_tpu/executor.py``.

Binding a Symbol yields an :class:`Executor` that evaluates the graph
node by node in topological order (:func:`make_graph_eval`, the same
walk and the same auxiliary-state slot order as the JAX package's
``make_graph_eval``). PyTorch runs eagerly, so there is nothing to
compile: each forward launches the ops' kernels on the current stream.

This slice serves: ``forward`` runs under ``torch.inference_mode()``,
and ``backward`` raises :class:`TrainingNotPortedError` (the training
slice, ROADMAP.md Queue A item 5). As in the JAX package, a train-mode
forward computes batch statistics but does not commit the BatchNorm
moving statistics (they commit on backward there).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError, TrainingNotPortedError
from .context import Context
from .ndarray import NDArray
from .ops.registry import OpContext

__all__ = ["Executor", "make_graph_eval"]


def make_graph_eval(symbol):
    """The graph-eval function of a symbol: ``eval_graph(arg_list,
    aux_list, rng, is_train) -> (outputs, new_aux)`` over tensors.
    Returns ``(eval_graph, n_aux)``."""
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

    def eval_graph(arg_list, aux_list, rng, is_train):
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
        return [env[uid][i] for uid, i in out_index], aux_out

    return eval_graph, n_aux


class Executor:
    """A symbol bound to arrays on one device."""

    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="null", aux_states=None, seed: int = 0):
        if args_grad:
            raise TrainingNotPortedError(
                "binding gradient arrays needs backward, which comes "
                "with the training slice (ROADMAP.md Queue A item 5)")
        self._symbol = symbol
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
        self.aux_arrays = self._to_list(aux_states or [], self.aux_names,
                                        "aux_states")
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        self._eval_graph, _ = make_graph_eval(symbol)
        self._outputs: Optional[List[NDArray]] = None

    def _to_list(self, arrays, names, what) -> List[NDArray]:
        if isinstance(arrays, dict):
            out = [arrays.get(n) for n in names]
            missing = [n for n, a in zip(names, out) if a is None]
            if missing:
                raise MXNetError("%s: missing arrays for %s"
                                 % (what, missing))
        else:
            out = list(arrays)
            if len(out) != len(names):
                raise MXNetError("%s: expected %d arrays, got %d"
                                 % (what, len(names), len(out)))
        for n, a in zip(names, out):
            if not isinstance(a, NDArray):
                raise MXNetError("%s: '%s' must be an NDArray" % (what, n))
            if a.handle.device != self._device:
                raise MXNetError("%s: '%s' lives on %s, the executor on %s"
                                 % (what, n, a.context, self._ctx))
        return out

    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        if self._rng is None:
            self._rng = torch.Generator(device=self._device)
            self._rng.manual_seed(self._seed)
        return self._rng

    def run(self, arg_tensors, aux_tensors, is_train=False):
        """Evaluate the graph on the given tensors (the fused inference
        step calls this with its packed params)."""
        rng = self._generator() if is_train else None
        with torch.inference_mode():
            outs, _ = self._eval_graph(arg_tensors, aux_tensors, rng,
                                       is_train)
        return outs

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the forward pass; ``kwargs`` update named input arrays."""
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("forward: unknown argument '%s'" % name)
            self.arg_dict[name][:] = arr
        outs = self.run([a.handle for a in self.arg_arrays],
                        [a.handle for a in self.aux_arrays], is_train)
        self._outputs = [NDArray(o, self._ctx) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        raise TrainingNotPortedError(
            "Executor.backward is not ported yet: gradients come with the "
            "training slice (ROADMAP.md Queue A item 5)")

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

    def reshape(self, fresh_args=(), **kwargs) -> "Executor":
        """Rebind to new input shapes, sharing the arrays whose shape is
        unchanged. Names in ``fresh_args`` always get new storage."""
        from . import ndarray as nd

        fresh = set(fresh_args)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = [arr if shape == arr.shape and name not in fresh
                    else nd.zeros(shape, ctx=self._ctx,
                                  dtype=arr.handle.dtype)
                    for name, shape, arr in zip(self.arg_names, arg_shapes,
                                                self.arg_arrays)]
        new_aux = [arr if shape == arr.shape
                   else nd.zeros(shape, ctx=self._ctx,
                                 dtype=arr.handle.dtype)
                   for shape, arr in zip(aux_shapes, self.aux_arrays)]
        return Executor(self._symbol, self._ctx, new_args,
                        aux_states=new_aux, seed=self._seed)
