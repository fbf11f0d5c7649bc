"""The ImageNet model zoo of the port on the CPU against the JAX package:
LRN and the pooling geometries the models use (forward and gradient),
then AlexNet, VGG-11/13/16/19, GoogLeNet and Inception-v3 at full width
and the smallest input each takes: the same arguments, auxiliary
states and inferred shapes, symbol JSON read across both ways, and the
same inference forward from the same params; and ResNet's
``stem_s2d``. One training step of each model is in
``test_torch_vision_train.py``."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx

from test_torch_common import (fresh_names, op_symbol, random_params,
                               run_jax, run_torch)
from torch_vision_helpers import (BATCH, CLASSES, VISION, build,
                                  data_shape, jax_init)


def _grads(pkg, sym, args, head):
    """forward(is_train=True) and backward with ``head`` on the CPU:
    (outputs, gradients of every argument) as numpy."""
    ctx = pkg.cpu()
    a = {k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()}
    g = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()}
    ex = sym.bind(ctx, a, args_grad=g)
    ex.forward(is_train=True)
    ex.backward([pkg.nd.array(head, ctx=ctx)])
    return ([o.asnumpy() for o in ex.outputs],
            {k: v.asnumpy() for k, v in g.items()})


def _check_op(op_name, shape, rtol, atol, **params):
    """Forward and input gradient of a one-node graph, both packages."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    res = []
    for pkg in (jmx, tmx):
        sym = op_symbol(pkg, op_name, ["data"], **params)
        out_shape = sym.infer_shape(data=shape)[1][0]
        head = np.random.RandomState(1).randn(*out_shape).astype(np.float32)
        res.append(_grads(pkg, sym, {"data": x}, head))
    (jo, jg), (to, tg) = res
    np.testing.assert_allclose(to[0], jo[0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tg["data"], jg["data"], rtol=rtol, atol=atol)


# the JAX op's sum is a reduce_window, the port's an unfold and a sum:
# a few ulps apart, through a power of beta
@pytest.mark.parametrize("nsize", [5, 4, 3, 1])
@pytest.mark.parametrize("knorm", [1.0, 2.0])
def test_lrn_matches_jax(nsize, knorm):
    """Forward and gradient at odd and even windows (the even one pads
    nsize // 2 before and nsize // 2 - 1 after), knorm 1 (AlexNet's)
    and 2 (the default), alpha large enough that the sum matters."""
    _check_op("LRN", (2, 7, 5, 4), rtol=1e-5, atol=1e-6, nsize=nsize,
              knorm=knorm, alpha=0.5, beta=0.75)


def test_lrn_defaults_and_json_match_jax():
    syms = [op_symbol(pkg, "LRN", ["data"], nsize=5) for pkg in (jmx, tmx)]
    assert syms[1].tojson() == syms[0].tojson()
    params = json.loads(syms[1].tojson())["nodes"][-1]["param"]
    assert params == {"alpha": "0.0001", "beta": "0.75", "knorm": "2.0",
                      "nsize": "5"}
    with pytest.raises(tmx.MXNetError, match="nsize"):
        tmx.sym.LRN(tmx.sym.Variable("data"))


# (kernel, stride, pad, pool_type, global_pool, input H, W): the pools of
# the four models, at their odd sizes
VISION_POOLS = [
    ((3, 3), (2, 2), None, "max", False, 55, 55),   # AlexNet, GoogLeNet
    ((3, 3), (2, 2), None, "max", False, 147, 147),  # Inception-v3 stem
    ((3, 3), (2, 2), None, "max", False, 35, 35),   # Inception-v3 B
    ((3, 3), (2, 2), None, "max", False, 17, 17),   # Inception-v3 D
    ((3, 3), (1, 1), (1, 1), "max", False, 28, 28),  # GoogLeNet branches
    ((3, 3), (1, 1), (1, 1), "avg", False, 17, 17),  # Inception-v3 A/C/E
    ((2, 2), (2, 2), None, "max", False, 14, 14),   # VGG
    ((7, 7), None, None, "avg", True, 7, 7),        # GoogLeNet's head
    ((8, 8), None, None, "avg", True, 8, 8),        # Inception-v3's head
    ((7, 7), None, None, "avg", True, 5, 5),        # kernel from the input
]


@pytest.mark.parametrize("case", VISION_POOLS,
                         ids=["%s%dx%d_%s%s_%d" % (c[3], c[0][0], c[0][1],
                                                    "g" if c[4] else "s",
                                                    (c[1] or (1,))[0], c[5])
                              for c in VISION_POOLS])
def test_pooling_at_the_models_geometries(case):
    """Forward and gradient; avg with pad divides by the full kernel
    (the padding counts) in both packages."""
    kernel, stride, pad, pool_type, global_pool, h, w = case
    params = dict(kernel=kernel, pool_type=pool_type,
                  global_pool=global_pool)
    if stride:
        params["stride"] = stride
    if pad:
        params["pad"] = pad
    _check_op("Pooling", (2, 3, h, w), rtol=1e-5, atol=1e-6, **params)


def test_avg_pool_with_pad_counts_the_padding():
    x = np.ones((1, 1, 3, 3), np.float32)
    sym = op_symbol(tmx, "Pooling", ["data"], kernel=(3, 3), stride=(1, 1),
                    pad=(1, 1), pool_type="avg")
    out = run_torch(sym, {"data": x})[0][0, 0]
    assert out[0, 0] == np.float32(4.0 / 9.0) and out[1, 1] == 1.0


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", sorted(VISION))
def test_model_structure_matches_jax(model):
    """Byte-equal JSON; the same arguments (names and order), auxiliary
    states, outputs and inferred shapes; each package's JSON loaded by
    the other writes it back unchanged."""
    jsym, tsym = build(jmx, model), build(tmx, model)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_outputs() == jsym.list_outputs()
    shape = data_shape(model)
    for a, b in zip(jsym.infer_shape(data=shape),
                    tsym.infer_shape(data=shape)):
        assert [tuple(s) for s in a] == [tuple(s) for s in b]
    assert tsym.infer_shape(data=shape)[1] == [(BATCH, CLASSES)]
    assert tmx.sym.load_json(jsym.tojson()).tojson() == jsym.tojson()
    assert jmx.sym.load_json(tsym.tojson()).tojson() == tsym.tojson()


def test_vgg_depths_and_bad_depth():
    convs = {n: sum(1 for a in build(tmx, "vgg%d" % n).list_arguments()
                    if a.startswith("conv") and a.endswith("_weight"))
             for n in (11, 13, 16, 19)}
    assert convs == {11: 8, 13: 10, 16: 13, 19: 16}
    with pytest.raises(ValueError, match="num_layers"):
        tmx.models.get_vgg(num_layers=17)


# Inference forwards at full width: the models' softmax outputs agree to
# rtol 1e-4 / atol 1e-6 (measured: at most about 1e-6 of difference,
# from convolution algorithms of the two backends).
@pytest.mark.parametrize("model", sorted(VISION))
def test_model_forward_matches_jax(model):
    """is_train=False from the same params: AlexNet's initialised by the
    JAX package (Xavier) and carried across by
    ``interop.params_from_numpy``; the others' from seeded numpy
    (fan-in scaled; initialising every param through the JAX package
    compiles a random kernel a shape, tens of seconds for GoogLeNet)."""
    jsym, tsym = build(jmx, model), build(tmx, model)
    shape = data_shape(model)
    if model == "alexnet":
        args, aux = jax_init(jsym, shape)
    else:
        args, aux = random_params(tsym, shape, seed=1)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    label = np.zeros(BATCH, np.float32)
    want = run_jax(jsym, dict(args, data=x, softmax_label=label), aux)[0]
    targs, taux = tmx.interop.params_from_numpy(
        tsym, args, aux, tmx.cpu(), input_shapes={"data": shape})
    ex = tsym.bind(tmx.cpu(), dict(targs, data=tmx.nd.array(
        x, ctx=tmx.cpu()), softmax_label=tmx.nd.array(label, ctx=tmx.cpu())),
        aux_states=taux)
    got = ex.forward(is_train=False)[0].asnumpy()
    assert got.shape == (BATCH, CLASSES) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def _s2d_resnet(pkg, layout):
    with fresh_names(pkg):
        return pkg.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                     num_classes=10, layout=layout,
                                     stem_s2d=True)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_stem_s2d_matches_jax(layout):
    """``get_resnet(..., stem_s2d=True)``: a 5x5/1 conv over the 2x2
    depth-stacked (N, 12, H/2, W/2) data, then the max pool; the same
    graph, shapes and inference forward as the JAX package's."""
    jsym, tsym = _s2d_resnet(jmx, layout), _s2d_resnet(tmx, layout)
    assert tsym.tojson() == jsym.tojson()
    shape = (2, 12, 32, 32) if layout == "NCHW" else (2, 32, 32, 12)
    arg_shapes = dict(zip(tsym.list_arguments(),
                          tsym.infer_shape(data=shape)[0]))
    assert arg_shapes["stem_conv_weight"] == (16, 12, 5, 5)
    for a, b in zip(jsym.infer_shape(data=shape),
                    tsym.infer_shape(data=shape)):
        assert [tuple(s) for s in a] == [tuple(s) for s in b]
    args, aux = random_params(tsym, shape, seed=3)
    feed = dict(args, data=np.random.RandomState(4).randn(*shape).astype(
        np.float32), softmax_label=np.zeros(2, np.float32))
    np.testing.assert_allclose(run_torch(tsym, feed, aux)[0],
                               run_jax(jsym, feed, aux)[0],
                               rtol=1e-4, atol=1e-6)


def test_resnet50_keeps_the_reference_signature():
    import inspect
    assert list(inspect.signature(tmx.models.get_resnet50).parameters) == \
        list(inspect.signature(jmx.models.get_resnet50).parameters)
    assert list(inspect.signature(tmx.models.get_resnet).parameters) == \
        list(inspect.signature(jmx.models.get_resnet).parameters)
