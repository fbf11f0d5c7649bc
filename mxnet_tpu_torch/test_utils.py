"""Numeric verification harness, counterpart of
``mxnet_tpu/test_utils.py``: finite-difference gradient checks, symbolic
forward and backward checks against closed forms, and consistency checks
of one symbol bound under several contexts and dtypes (the card against
the CPU). Every helper takes ``ctx``; without it, the current context,
which is the card unless a ``with mx.cpu():`` scope is open.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .base import MXNetError
from .context import Context, current_context
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["default_context", "reldiff", "same", "assert_almost_equal",
           "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "check_speed", "rand_ndarray", "random_arrays"]


def default_context() -> Context:
    """The current context: ``gpu(0)`` unless a CPU scope is open."""
    return current_context()


def random_arrays(*shapes) -> List[np.ndarray]:
    arrays = [np.random.randn(*s).astype(np.float32) for s in shapes]
    return arrays if len(arrays) > 1 else arrays[0]


def rand_ndarray(shape, ctx=None) -> NDArray:
    return nd.array(np.random.randn(*shape).astype(np.float32), ctx=ctx)


def reldiff(a, b) -> float:
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0.0
    return diff / norm


def same(a, b) -> bool:
    return np.array_equal(a, b)


def assert_almost_equal(a, b, threshold: float = 1e-5, name=""):
    rel = reldiff(np.asarray(a), np.asarray(b))
    if not rel <= threshold:
        raise AssertionError("%s reldiff %g > %g\n%s\nvs\n%s"
                             % (name, rel, threshold, a, b))
    return rel


def _parse_location(sym, location, ctx) -> Dict[str, NDArray]:
    if isinstance(location, dict):
        return {k: (v if isinstance(v, NDArray) else nd.array(v, ctx=ctx))
                for k, v in location.items()}
    return {k: (v if isinstance(v, NDArray) else nd.array(v, ctx=ctx))
            for k, v in zip(sym.list_arguments(), location)}


def numeric_grad(executor, location: Dict[str, np.ndarray],
                 aux_states=None, eps: float = 1e-4) -> Dict[str, np.ndarray]:
    """Central finite differences of sum(outputs) with respect to each
    argument in ``location``."""
    grads = {}
    for name in location:
        arr = location[name].astype(np.float64)
        grad = np.zeros_like(arr)
        flat = arr.ravel()
        gflat = grad.ravel()
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            executor.arg_dict[name][:] = arr.astype(np.float32)
            executor.forward(is_train=True)
            f_pos = sum(float(o.asnumpy().astype(np.float64).sum())
                        for o in executor.outputs)
            flat[i] = orig - eps
            executor.arg_dict[name][:] = arr.astype(np.float32)
            executor.forward(is_train=True)
            f_neg = sum(float(o.asnumpy().astype(np.float64).sum())
                        for o in executor.outputs)
            gflat[i] = (f_pos - f_neg) / (2 * eps)
            flat[i] = orig
        executor.arg_dict[name][:] = arr.astype(np.float32)
        grads[name] = grad
    return grads


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps: float = 1e-3, check_eps: float = 2e-2,
                           grad_nodes=None, ctx=None):
    """Autograd's gradients against central finite differences, within
    ``check_eps`` (relative difference of the sums of magnitudes)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    loc_np = {k: v.asnumpy() for k, v in location.items()}
    grad_nodes = grad_nodes or list(location.keys())

    executor = sym.simple_bind(ctx=ctx, grad_req={
        k: ("write" if k in grad_nodes else "null") for k in location},
        **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    if aux_states:
        for k, v in aux_states.items():
            executor.aux_dict[k][:] = v

    executor.forward(is_train=True)
    executor.backward()
    sym_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}

    num_grads = numeric_grad(executor, {k: loc_np[k] for k in grad_nodes},
                             eps=numeric_eps)
    for name in grad_nodes:
        rel = reldiff(num_grads[name], sym_grads[name])
        if not rel <= check_eps:
            raise AssertionError(
                "numeric gradient check failed for '%s': reldiff %g > %g"
                % (name, rel, check_eps))


def check_symbolic_forward(sym, location, expected, check_eps: float = 1e-5,
                           aux_states=None, ctx=None):
    """An inference forward against the expected outputs."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    executor = sym.simple_bind(ctx=ctx, grad_req="null",
                               **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    if aux_states:
        for k, v in aux_states.items():
            executor.aux_dict[k][:] = v
    outputs = executor.forward(is_train=False)
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, check_eps)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected,
                            check_eps: float = 1e-5, aux_states=None,
                            grad_req="write", ctx=None):
    """Gradients for ``out_grads`` against the expected ones (a list in
    ``list_arguments`` order, None to skip, or a dict by name)."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    executor = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                               **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    if aux_states:
        for k, v in aux_states.items():
            executor.aux_dict[k][:] = v
    executor.forward(is_train=True)
    out_grads = [g if isinstance(g, NDArray) else nd.array(g, ctx=ctx)
                 for g in out_grads]
    executor.backward(out_grads)
    if isinstance(expected, dict):
        for name, exp in expected.items():
            assert_almost_equal(executor.grad_dict[name].asnumpy(), exp,
                                check_eps, name=name)
    else:
        for name, exp in zip(sym.list_arguments(), expected):
            if exp is None:
                continue
            assert_almost_equal(executor.grad_dict[name].asnumpy(), exp,
                                check_eps, name=name)
    return {k: v.asnumpy() for k, v in executor.grad_dict.items()}


def check_consistency(sym, ctx_list, scale: float = 1.0,
                      tol: Optional[Dict] = None, grad_req: str = "write"):
    """Bind the same symbol under each ``{ctx, <shapes>, type_dict}`` of
    ``ctx_list``, on the same seeded inputs and head gradients, and hold
    every output and gradient to the first config's within the dtype's
    tolerance (the card against the CPU, or one dtype against another).
    Returns ``[(outputs, grads, tolerance)]`` per config."""
    tol = tol or {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
                  np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
                  np.dtype(np.int32): 0}
    assert len(ctx_list) > 1
    configs = []
    for spec in ctx_list:
        spec = dict(spec)
        ctx = spec.pop("ctx")
        type_dict = spec.pop("type_dict", {})
        shapes = spec
        configs.append((ctx, shapes, type_dict))

    arg_names = sym.list_arguments()
    # common random inputs, cast per config
    base_shapes = configs[0][1]
    arg_shapes, _, aux_shapes = sym.infer_shape(**base_shapes)
    rng = np.random.RandomState(0)
    base_args = [rng.normal(0, scale, size=s).astype(np.float64)
                 for s in arg_shapes]

    results = []
    for ctx, shapes, type_dict in configs:
        executor = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                                   type_dict=type_dict, **shapes)
        dtypes = [executor.arg_dict[n].dtype for n in arg_names]
        for n, v, dt in zip(arg_names, base_args, dtypes):
            executor.arg_dict[n][:] = v.astype(dt)
        executor.forward(is_train=(grad_req != "null"))
        outs = [o.asnumpy().astype(np.float64) for o in executor.outputs]
        grads = None
        if grad_req != "null":
            # seeded random head gradients, the same for every config
            grng = np.random.RandomState(17)
            heads = [nd.array(grng.normal(0, 1, size=o.shape)
                              .astype(executor.outputs[i].dtype), ctx=ctx)
                     for i, o in enumerate(outs)]
            executor.backward(heads)
            grads = {n: executor.grad_dict[n].asnumpy().astype(np.float64)
                     for n in executor.grad_dict}
        results.append((outs, grads, max(tol.get(np.dtype(d), 1e-3)
                                         for d in dtypes)))

    ref_outs, ref_grads, _ = results[0]
    for outs, grads, eps in results[1:]:
        for a, b in zip(ref_outs, outs):
            assert_almost_equal(a, b, max(eps, results[0][2]), "output")
        if grads is not None and ref_grads is not None:
            for name in ref_grads:
                assert_almost_equal(ref_grads[name], grads[name],
                                    max(eps, results[0][2]), name)
    return results


def check_speed(sym, location=None, ctx=None, N: int = 20,
                grad_req: str = "write", typ: str = "whole") -> float:
    """Seconds per forward+backward (``typ="whole"``) or forward of a
    symbol bound at ``location``'s shapes, over ``N`` runs after one
    warm-up."""
    ctx = ctx or default_context()
    if location is None:
        raise MXNetError("location required")
    location = _parse_location(sym, location, ctx)
    executor = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                               **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        executor.arg_dict[k][:] = v

    if typ == "whole":
        # warmup
        executor.forward(is_train=True)
        executor.backward()
        for o in executor.outputs:
            o.wait_to_read()
        tic = time.time()
        for _ in range(N):
            executor.forward(is_train=True)
            executor.backward()
        for g in executor.grad_dict.values():
            g.wait_to_read()
        return (time.time() - tic) / N
    elif typ == "forward":
        executor.forward(is_train=False)
        for o in executor.outputs:
            o.wait_to_read()
        tic = time.time()
        for _ in range(N):
            executor.forward(is_train=False)
        for o in executor.outputs:
            o.wait_to_read()
        return (time.time() - tic) / N
    raise MXNetError("typ must be 'whole' or 'forward'")
