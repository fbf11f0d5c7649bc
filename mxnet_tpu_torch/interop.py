"""Weights carried across from the JAX package.

The JAX package hands its params over as numpy (``{name: arr.asnumpy()}``
from ``Module.get_params``) or as the "TPUARRA" container file, which
:func:`mxnet_tpu_torch.ndarray.load` reads as it is. Conv weights are
OIHW in both packages, so nothing is transposed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import MXNetError
from .context import Context
from .ndarray import NDArray, array

__all__ = ["params_from_numpy"]


def params_from_numpy(symbol, arg_params: Dict[str, np.ndarray],
                      aux_params: Dict[str, np.ndarray],
                      ctx: Optional[Context] = None,
                      input_shapes: Optional[Dict[str, tuple]] = None):
    """The port's ``(arg_params, aux_params)`` NDArray dicts on ``ctx``
    from numpy dicts, after checking every name and shape against
    ``symbol.infer_shape(**input_shapes)``: each given name must be an
    argument (or auxiliary state) of the symbol with that shape, and
    every argument except the inputs and the ``*label`` slots, and every
    auxiliary state, must be given."""
    if input_shapes is None:
        raise MXNetError("params_from_numpy needs input_shapes (e.g. "
                         "{'data': (N, H, W, C)}) to infer the param shapes")
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    want_args = {n: s for n, s in zip(symbol.list_arguments(), arg_shapes)
                 if n not in input_shapes}
    want_aux = dict(zip(symbol.list_auxiliary_states(), aux_shapes))

    def convert(given, want, what, optional):
        unknown = sorted(set(given) - set(want))
        if unknown:
            raise MXNetError("%s %s are not in the symbol" % (what, unknown))
        missing = sorted(n for n in want
                         if n not in given and not optional(n))
        if missing:
            raise MXNetError("%s missing: %s" % (what, missing))
        out: Dict[str, NDArray] = {}
        for name, value in given.items():
            value = np.asarray(value)
            if tuple(value.shape) != tuple(want[name]):
                raise MXNetError("%s '%s' has shape %s, the symbol needs %s"
                                 % (what, name, value.shape, want[name]))
            out[name] = array(value, ctx=ctx, dtype=value.dtype)
        return out

    return (convert(arg_params, want_args, "arg_params",
                    lambda n: n.endswith("label")),
            convert(aux_params, want_aux, "aux_params", lambda n: False))
