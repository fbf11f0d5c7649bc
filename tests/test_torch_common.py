"""Shared helpers of the PyTorch-port parity tests (this file holds no
tests). Inputs are numpy arrays from seeded RandomStates; each graph runs
through the JAX package (on the CPU, Pallas kernels in interpret mode)
and through its port in ``mxnet_tpu_torch`` with ``ctx=cpu()``."""
import importlib.util
import os

import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)
import mxnet_tpu_torch as tmx


def _load_chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: chip_smoke.py as a module: the tests build narrow versions of its
#: models and feed them with its iterators (one copy of each builder)
chip_smoke = _load_chip_smoke()


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


# -- the checkpoint tests' MLP (tests/test_fused_step.py's) ---------------
CKPT_BATCH = 8
CKPT_DIM = 6
CKPT_CLASSES = 3


def ckpt_mlp(pkg, dropout=0.0):
    """fc1 (16) -> relu [-> Dropout] -> fc2 (3) -> SoftmaxOutput, with the
    same names in both packages."""
    with fresh_names(pkg):
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        if dropout:
            net = pkg.sym.Dropout(net, p=dropout)
        net = pkg.sym.FullyConnected(net, num_hidden=CKPT_CLASSES,
                                     name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def ckpt_data(nbatches, seed=0):
    """``nbatches`` batches of a separable 3-class problem, in order."""
    rng = np.random.RandomState(seed)
    x = rng.randn(CKPT_BATCH * nbatches, CKPT_DIM).astype(np.float32)
    y = x.dot(rng.randn(CKPT_DIM, CKPT_CLASSES)).argmax(axis=1)
    return x, y.astype(np.float32)


def ckpt_params(net, seed=3):
    """numpy params of ``net`` (either package's), from ``seed``."""
    shapes, _, _ = net.infer_shape(data=(CKPT_BATCH, CKPT_DIM),
                                   softmax_label=(CKPT_BATCH,))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def ckpt_stream_callback(stream):
    """A batch-end callback appending (epoch, nbatch, metric values, the
    batch's mean cross-entropy from the outputs) to ``stream``."""
    def cb(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = param.locals["data_batch"].label[0].asnumpy().astype(int)
        loss = -np.log(probs.astype(np.float64)[np.arange(len(lab)),
                                                lab]).mean()
        values = tuple(float(v) for _, v in
                       param.eval_metric.get_name_value())
        stream.append((param.epoch, param.nbatch, values, float(loss)))
    return cb


# -- forward and backward of one graph through both packages ----------------
def fwd_bwd(pkg, sym, args, grad_names, heads=None, aux=None,
            is_train=True):
    """Bind ``sym`` on the CPU of ``pkg`` (either package) to the numpy
    ``args`` (dtypes kept), with a gradient array for each name in
    ``grad_names``; run a forward (train mode by default) and, where
    ``heads`` is given, a backward with those head gradients. Returns
    ``(outputs, grads by name, aux)`` as numpy."""
    ctx = pkg.cpu()
    arrays = {k: pkg.nd.array(v, ctx=ctx, dtype=v.dtype)
              for k, v in args.items()}
    grads = {k: pkg.nd.zeros(args[k].shape, ctx=ctx, dtype=args[k].dtype)
             for k in grad_names}
    reqs = {k: ("write" if k in grad_names else "null") for k in args}
    aux_arrays = {k: pkg.nd.array(v, ctx=ctx) for k, v in (aux or {}).items()}
    ex = sym.bind(ctx, arrays, args_grad=grads, grad_req=reqs,
                  aux_states=aux_arrays)
    ex.forward(is_train=is_train)
    outs = [o.asnumpy().copy() for o in ex.outputs]
    if heads is not None:
        ex.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
    return (outs, {k: g.asnumpy().copy() for k, g in grads.items()},
            {k: a.asnumpy().copy() for k, a in ex.aux_dict.items()})


def both_fwd_bwd(build, args, grad_names=None, aux=None, head_seed=17):
    """``build(pkg)`` in each package (fresh names), forward in train
    mode and backward with the same seeded head gradients. ``grad_names``
    defaults to every float argument. Returns ``((jax outs, grads,
    aux), (port outs, grads, aux))``."""
    if grad_names is None:
        grad_names = [k for k, v in args.items()
                      if np.issubdtype(v.dtype, np.floating)]
    with fresh_names(tmx):
        tsym = build(tmx)
    with fresh_names(jmx):
        jsym = build(jmx)
    shapes = [o.shape for o in fwd_bwd(tmx, tsym, args, (), aux=aux,
                                       is_train=False)[0]]
    rng = np.random.RandomState(head_seed)
    heads = [rng.randn(*s).astype(np.float32) for s in shapes]
    return (fwd_bwd(jmx, jsym, args, grad_names, heads, aux),
            fwd_bwd(tmx, tsym, args, grad_names, heads, aux))


def assert_parity(got, want, rtol=1e-5, atol=1e-6, grad_rtol=1e-4,
                  grad_atol=1e-6):
    """The port's (outputs, grads, aux) against the JAX package's:
    outputs and aux at ``rtol``/``atol``, gradients at
    ``grad_rtol``/``grad_atol``; NaN where NaN."""
    (t_out, t_grad, t_aux), (j_out, j_grad, j_aux) = got, want
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert sorted(t_grad) == sorted(j_grad)
    for k in j_grad:
        np.testing.assert_allclose(t_grad[k], j_grad[k], rtol=grad_rtol,
                                   atol=grad_atol, err_msg=k)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k], j_aux[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def write_uint8_cache(prefix, frames, store, classes, seed=0):
    """``frames`` seeded uint8 frames of ``store`` x ``store`` x 3 with
    labels ``i % classes`` in the decoded cache's layout, which both
    packages' ``CachedImageRecordIter`` read
    (``tools/torch_dp_feed_check.write_cache``)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_dp_feed_check

    return torch_dp_feed_check.write_cache(prefix, frames, store, seed,
                                           classes)


def feed_iter(pkg, prefix, batch, crop, aug_replicas=1, layout="NHWC"):
    """A device-feed ``CachedImageRecordIter`` of either package over
    ``prefix``: random crops and mirrors, the upstream means, seed 7
    (the port's on the CPU)."""
    kw = dict(shuffle=True, seed=7, rand_crop=True, rand_mirror=True,
              scale=1.0 / 255.0, mean_r=123.68, mean_g=116.779,
              mean_b=103.939, device_feed=True, output_layout=layout,
              aug_replicas=aug_replicas)
    if pkg is tmx:
        with tmx.cpu():
            return pkg.io_cache.CachedImageRecordIter(
                prefix, (3, crop, crop), batch, **kw)
    from mxnet_tpu import io_cache

    return io_cache.CachedImageRecordIter(prefix, (3, crop, crop), batch,
                                          **kw)


def dropout_mlp(pkg, p=0.5, hidden=32, classes=10):
    """Flatten -> FullyConnected -> ReLU -> Dropout(p) -> FullyConnected
    -> SoftmaxOutput."""
    with fresh_names(pkg):
        net = pkg.sym.Flatten(pkg.sym.Variable("data"))
        net = pkg.sym.FullyConnected(net, num_hidden=hidden, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.Dropout(net, p=p, name="drop")
        net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")
