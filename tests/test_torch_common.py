"""Shared helpers of the PyTorch-port parity tests (this file holds no
tests). Inputs are numpy arrays from seeded RandomStates; each graph runs
through the JAX package (on the CPU, Pallas kernels in interpret mode)
and through its port in ``mxnet_tpu_torch`` with ``ctx=cpu()``."""
import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)
import mxnet_tpu_torch as tmx


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def bf16_ulp(y: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at each |y| (8-bit mantissa)."""
    mag = np.maximum(np.abs(np.asarray(y, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def op_symbol(pkg, op_name, arg_names, **params):
    """A one-node graph: ``op_name`` over Variables named ``arg_names``
    (remaining inputs such as weights are auto-created as ``op_*``)."""
    inputs = {a: pkg.sym.Variable(a) for a in arg_names}
    return getattr(pkg.sym, op_name)(name="op", **inputs, **params)


def run_jax(sym, args, aux=None, is_train=False):
    """Forward a JAX-package symbol on the CPU; numpy in, numpy out."""
    ex = sym.bind(jmx.cpu(), {k: jmx.nd.array(v, dtype=v.dtype)
                              for k, v in args.items()},
                  grad_req="null",
                  aux_states={k: jmx.nd.array(v)
                              for k, v in (aux or {}).items()})
    ex.forward(is_train=is_train)
    return [o.asnumpy() for o in ex.outputs]


def run_torch(sym, args, aux=None, is_train=False):
    """Forward a port symbol with ctx=cpu(); numpy in, numpy out."""
    ctx = tmx.cpu()
    ex = sym.bind(ctx, {k: tmx.nd.array(v, ctx=ctx, dtype=v.dtype)
                        for k, v in args.items()},
                  aux_states={k: tmx.nd.array(v, ctx=ctx)
                              for k, v in (aux or {}).items()})
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def fresh_names(pkg):
    """A fresh NameManager of ``pkg``, so auto-named nodes (flatten0,
    ...) get the same names in both packages."""
    return pkg.name.NameManager()


def small_resnet(pkg, layout="NHWC", num_classes=10):
    with fresh_names(pkg):
        return pkg.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                     num_classes=num_classes,
                                     small_input=True, layout=layout)


def random_params(sym, data_shape, seed=0):
    """numpy (arg_params, aux_params) for every param and aux state of
    ``sym``: weights scaled by fan-in, gamma/beta/moving stats drawn so
    that BatchNorm does real work."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data" or name.endswith("label"):
            continue
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("beta") or name.endswith("bias"):
            v = rng.randn(*shape) * 0.1
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        args[name] = v.astype(np.float32)
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        if name.endswith("moving_var"):
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.randn(*shape) * 0.1
        aux[name] = v.astype(np.float32)
    return args, aux
