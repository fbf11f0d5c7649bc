"""ResNet-50 (32x32 input, NCHW here, NHWC in
``test_torch_layouts_nhwc.py``) and Inception-BN-28-small (NCHW, in
``test_torch_layouts_inception_bn.py``) of the port on the CPU
against the JAX package at batch 2: the forward (inference and train
mode), the backward (every argument's gradient) and one ``Module.fit``
step, from the same params."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_common import fresh_names, random_params, run_jax
from torch_vision_helpers import (BATCH, BN_BETA, TOL, compare_training_step,
                                  update_error)

CLASSES = 10
# The networks are conditioned as the vision models are (see
# torch_vision_helpers' bound): every BatchNorm beta at 2 and, for
# ResNet, each residual block's last BatchNorm gamma at 0.25 (the
# zero-init-residual recipe of Goyal et al., 2017, kept nonzero), so that
# few ReLU inputs sit within rounding of zero. The gradients are held
# normwise: all of them together within 1e-2 of their norm (measured: at
# most 7.5e-4), and each tensor within 5e-2 of its own norm (measured: at
# most 1.2e-2) unless that norm is under 1e-3 of the largest tensor's.
# Those are the gradients that are rounding noise: a BatchNorm beta whose
# shift passes a ReLU (mostly open at beta 2) and a convolution into the
# next BatchNorm, which takes it out again, has an exact gradient of 0
# and a computed one about 1e-9 of the largest.
GRAD_NORMWISE = 1e-2
GRAD_TENSOR = 5e-2
NOISE_FLOOR = 1e-3


def _net(pkg, which):
    with fresh_names(pkg):
        if which == "inception_bn_28_small":
            return pkg.models.get_inception_bn_28_small(num_classes=CLASSES)
        return pkg.models.get_resnet50(num_classes=CLASSES, small_input=True,
                                       layout=which)


CASES = {"NCHW": (BATCH, 3, 32, 32), "NHWC": (BATCH, 32, 32, 3),
         "inception_bn_28_small": (BATCH, 3, 28, 28)}


def _params(tsym, shape):
    args, aux = random_params(tsym, shape, seed=6)
    for k in args:
        if k.endswith("beta"):
            args[k] = np.full_like(args[k], BN_BETA)
        if k.endswith("_b3_bn_gamma"):
            args[k] = np.full_like(args[k], 0.25)
    return args, aux


def _forward_backward(pkg, sym, feed, aux):
    ctx = pkg.cpu()
    a = {k: pkg.nd.array(v, ctx=ctx) for k, v in feed.items()}
    g = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in feed.items()
         if k != "softmax_label"}
    ex = sym.bind(ctx, a, args_grad=g,
                  aux_states={k: pkg.nd.array(v, ctx=ctx)
                              for k, v in aux.items()})
    ex.forward(is_train=True)
    out = ex.outputs[0].asnumpy()
    ex.backward()
    return out, {k: v.asnumpy() for k, v in g.items()}


def check_layout(which):
    """Inference and train-mode forward, every gradient and one fit step
    of ``which`` in both packages, held to the bounds above."""
    jsym, tsym = _net(jmx, which), _net(tmx, which)
    assert tsym.tojson() == jsym.tojson()
    shape = CASES[which]
    args, aux = _params(tsym, shape)
    rng = np.random.RandomState(8)
    feed = dict(args, data=rng.randn(*shape).astype(np.float32),
                softmax_label=rng.randint(0, CLASSES, BATCH).astype(
                    np.float32))
    # inference
    targs, taux = tmx.interop.params_from_numpy(
        tsym, args, aux, tmx.cpu(), input_shapes={"data": shape})
    ex = tsym.bind(tmx.cpu(), dict(targs, **{
        k: tmx.nd.array(feed[k], ctx=tmx.cpu())
        for k in ("data", "softmax_label")}), aux_states=taux)
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               run_jax(jsym, feed, aux)[0],
                               rtol=1e-4, atol=1e-6)
    # train-mode forward and the gradients
    want = _forward_backward(jmx, jsym, feed, aux)
    got = _forward_backward(tmx, tsym, feed, aux)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    assert got[1].keys() == want[1].keys()
    zeros = {k: np.zeros_like(v) for k, v in want[1].items()}
    assert update_error(got[1], want[1], zeros) <= GRAD_NORMWISE
    norms = {k: float(np.linalg.norm(w)) for k, w in want[1].items()}
    floor = NOISE_FLOOR * max(norms.values())
    bad = {k: float(np.linalg.norm(got[1][k] - w)) / norms[k]
           for k, w in want[1].items() if norms[k] >= floor}
    assert max(bad.values()) <= GRAD_TENSOR, max(bad.items(),
                                                 key=lambda kv: kv[1])
    # one step of fit
    compare_training_step(jsym, tsym, shape, args, aux, CLASSES)
    assert TOL["update"] == GRAD_NORMWISE


def test_resnet50_nchw_forward_backward_and_step_match_jax():
    check_layout("NCHW")
