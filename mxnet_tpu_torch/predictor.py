"""Deployment predict API, counterpart of ``mxnet_tpu/predictor.py``:
a predictor from a symbol JSON and a param blob (the "TPUARRA"
container, as bytes or a file path), with set_input / forward /
get_output. Forward runs through a
:class:`~mxnet_tpu_torch.fused_step.FusedInfer` built at the first
forward."""
from __future__ import annotations

import io
from typing import Dict, Optional, Sequence

import numpy as np

from .base import MXNetError
from .context import Context, cpu, current_context

__all__ = ["Predictor"]


class Predictor:
    """``ctx`` defaults to the current context (``gpu(0)`` unless a
    ``with mx.cpu():`` scope is open)."""

    def __init__(self, symbol_json: str, param_bytes_or_file,
                 input_shapes: Dict[str, tuple],
                 ctx: Optional[Context] = None,
                 input_names: Optional[Sequence[str]] = None):
        from . import ndarray as nd
        from . import symbol as sym_mod

        self._ctx = ctx if ctx is not None else current_context()
        self._ctx.torch_device()
        symbol = sym_mod.load_json(symbol_json)
        if isinstance(param_bytes_or_file, (bytes, bytearray)):
            params = nd.load_from_stream(io.BytesIO(param_bytes_or_file),
                                         "<param bytes>", ctx=cpu())
        else:
            params = nd.load(param_bytes_or_file, ctx=cpu())
        arg_params, aux_params = {}, {}
        for k, v in params.items():
            if k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k[4:] if k.startswith("arg:") else k] = v

        self._input_names = list(input_names or input_shapes.keys())
        arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in input_shapes or (name not in arg_params
                                        and name.endswith("label")):
                # inputs, and loss-layer labels that inference ignores,
                # start zero-filled
                args[name] = nd.zeros(shape, ctx=self._ctx)
            elif name in arg_params:
                if tuple(arg_params[name].shape) != tuple(shape):
                    raise MXNetError("param '%s' shape %s, the graph needs %s"
                                     % (name, arg_params[name].shape, shape))
                args[name] = arg_params[name].as_in_context(self._ctx)
            else:
                raise MXNetError("missing parameter '%s'" % name)
        aux = [aux_params[name].as_in_context(self._ctx)
               if name in aux_params else nd.zeros(shape, ctx=self._ctx)
               for name, shape in zip(symbol.list_auxiliary_states(),
                                      aux_shapes)]
        self._executor = symbol.bind(self._ctx, args, aux_states=aux)
        self._input_shapes = {n: tuple(input_shapes[n])
                              for n in self._input_names}
        self._input_vals = {n: np.zeros(self._input_shapes[n], np.float32)
                            for n in self._input_names}
        self._fused = None
        self._outputs = None

    def set_input(self, name: str, value):
        if name not in self._executor.arg_dict:
            raise MXNetError("unknown input '%s'" % name)
        value = np.asarray(value, dtype=np.float32)
        declared = self._input_shapes.get(name)
        if declared is not None and tuple(value.shape) != declared:
            raise MXNetError(
                "input '%s' has shape %r but the predictor was bound for "
                "%r; use Predictor.reshape({%r: %r}) to bind a new shape"
                % (name, tuple(value.shape), declared, name,
                   tuple(value.shape)))
        self._input_vals[name] = value

    def forward(self, **inputs):
        from .fused_step import make_fused_infer

        for name, value in inputs.items():
            self.set_input(name, value)
        if self._fused is None:
            self._fused = make_fused_infer(self._executor,
                                           self._input_names)
        outs, _ = self._fused([self._input_vals[n]
                               for n in self._input_names])
        self._outputs = list(outs)

    def get_output(self, index: int) -> np.ndarray:
        if self._outputs is None:
            raise MXNetError("call forward first")
        return self._outputs[index].cpu().numpy()

    def reshape(self, input_shapes: Dict[str, tuple]) -> "Predictor":
        """A new predictor bound to new input shapes, sharing the weights
        whose shape is unchanged; this one stays valid. The inputs always
        get new storage."""
        new = object.__new__(Predictor)
        new._ctx = self._ctx
        new._input_names = list(self._input_names)
        new._executor = self._executor.reshape(
            fresh_args=self._input_names, **input_shapes)
        new._input_shapes = dict(self._input_shapes)
        new._input_shapes.update(
            {n: tuple(s) for n, s in input_shapes.items()})
        new._input_vals = {n: np.zeros(new._input_shapes[n], np.float32)
                           for n in new._input_names}
        new._fused = None
        new._outputs = None
        return new
