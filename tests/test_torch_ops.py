"""Per-op forward parity of the PyTorch port against the JAX package at
float32, NCHW and NHWC: the same seeded numpy inputs through a one-node
graph in each package. Tolerances: rtol 1e-5 / atol 1e-6 for elementwise
ops (the same float32 operations, maybe in another order); rtol 1e-4 /
atol 1e-5 where a reduction of up to a few hundred terms runs in another
order (conv, FC, pooling sums, softmax, BatchNorm statistics)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_common import op_symbol, run_jax, run_torch

ELEM = dict(rtol=1e-5, atol=1e-6)
REDUCE = dict(rtol=1e-4, atol=1e-5)


def _check(op_name, inputs, extra=None, aux=None, is_train=False, tol=ELEM,
           **params):
    """inputs: the graph's named Variables; extra: arrays for the
    auto-created op_* arguments."""
    args = dict(inputs)
    args.update(extra or {})
    ref = run_jax(op_symbol(jmx, op_name, list(inputs), **params), args,
                  aux, is_train)
    out = run_torch(op_symbol(tmx, op_name, list(inputs), **params), args,
                    aux, is_train)
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert r.shape == o.shape
        np.testing.assert_allclose(o, r, **tol)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("no_bias", [False, True])
@pytest.mark.parametrize("shape", [(4, 12), (4, 3, 2, 2)])
def test_fully_connected(shape, no_bias):
    extra = {"op_weight": _rand(6, 12, seed=1)}
    if not no_bias:
        extra["op_bias"] = _rand(6, seed=2)
    _check("FullyConnected", {"data": _rand(*shape)}, extra, tol=REDUCE,
           num_hidden=6, no_bias=no_bias)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu"])
def test_activation(act):
    _check("Activation", {"data": _rand(3, 5, 4, scale=3.0)}, act_type=act)


CONV_CASES = [
    # (kernel, stride, pad, dilate, groups, no_bias)
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, False),
    ((3, 3), (2, 2), (1, 1), (2, 2), 1, True),
    ((1, 1), (2, 2), (0, 0), (1, 1), 1, True),
    ((7, 7), (2, 2), (3, 3), (1, 1), 1, True),
    ((3, 3), (1, 1), (1, 1), (1, 1), 2, False),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_convolution(layout, case):
    kernel, stride, pad, dilate, groups, no_bias = case
    c, o = 4, 6
    shape = (2, c, 11, 10) if layout == "NCHW" else (2, 11, 10, c)
    extra = {"op_weight": _rand(o, c // groups, *kernel, seed=1)}
    if not no_bias:
        extra["op_bias"] = _rand(o, seed=2)
    _check("Convolution", {"data": _rand(*shape)}, extra, tol=REDUCE,
           kernel=kernel, num_filter=o, stride=stride, pad=pad,
           dilate=dilate, num_group=groups, no_bias=no_bias, layout=layout)


POOL_CASES = [
    # (kernel, stride, pad, global_pool)
    ((3, 3), (2, 2), (1, 1), False),
    ((2, 2), (2, 2), (0, 0), False),
    ((3, 3), (1, 1), (2, 2), False),   # pad beyond half the kernel
    ((7, 7), None, None, True),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pooling(layout, pool_type, case):
    kernel, stride, pad, global_pool = case
    shape = (2, 3, 9, 8) if layout == "NCHW" else (2, 9, 8, 3)
    params = dict(kernel=kernel, pool_type=pool_type, layout=layout,
                  global_pool=global_pool)
    if stride:
        params.update(stride=stride, pad=pad)
    _check("Pooling", {"data": _rand(*shape)}, tol=REDUCE, **params)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm(layout, is_train, fix_gamma):
    c = 5
    shape = (3, c, 4, 6) if layout == "NCHW" else (3, 4, 6, c)
    rng = np.random.RandomState(3)
    extra = {"op_gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "op_beta": rng.randn(c).astype(np.float32)}
    aux = {"op_moving_mean": rng.randn(c).astype(np.float32),
           "op_moving_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    _check("BatchNorm", {"data": _rand(*shape, scale=2.0) + 1.0}, extra,
           aux=aux, is_train=is_train, tol=REDUCE, fix_gamma=fix_gamma,
           eps=2e-5, axis=1 if layout == "NCHW" else -1)


def test_dropout_is_identity_at_inference():
    _check("Dropout", {"data": _rand(4, 7)}, p=0.5)


@pytest.mark.parametrize("shape,multi", [((4, 10), False),
                                         ((2, 3, 4, 5), True)])
def test_softmax_output(shape, multi):
    label = (np.zeros((shape[0],) + shape[2:]) if multi
             else np.zeros(shape[0])).astype(np.float32)
    _check("SoftmaxOutput", {"data": _rand(*shape, scale=3.0)},
           {"op_label": label}, tol=REDUCE, multi_output=multi)


@pytest.mark.parametrize("layout_shape", [(2, 3, 4, 5), (2, 4, 5, 3)])
def test_flatten(layout_shape):
    _check("Flatten", {"data": _rand(*layout_shape)})


@pytest.mark.parametrize("op", ["_Plus", "_Minus", "_Mul", "_Div",
                                "_Power", "_Maximum", "_Minimum"])
def test_binary(op):
    lhs = np.abs(_rand(3, 4, seed=1)) + 0.5
    rhs = _rand(3, 4, seed=2)
    _check(op, {"lhs": lhs, "rhs": rhs})


@pytest.mark.parametrize("op", ["_PlusScalar", "_MinusScalar",
                                "_RMinusScalar", "_MulScalar", "_DivScalar",
                                "_RDivScalar", "_PowerScalar",
                                "_RPowerScalar", "_MaximumScalar",
                                "_MinimumScalar"])
def test_scalar(op):
    _check(op, {"data": np.abs(_rand(3, 4)) + 0.5}, scalar=1.7)


def test_symbol_operator_overloading():
    """x + y, 2 - x, x * y / 3, -x through both packages' overloads."""
    x, y = _rand(3, 4, seed=1), np.abs(_rand(3, 4, seed=2)) + 0.5
    outs = []
    for pkg, run in ((jmx, run_jax), (tmx, run_torch)):
        a, b = pkg.sym.Variable("x"), pkg.sym.Variable("y")
        s = pkg.sym.Group([a + b, 2.0 - a, a * b / 3.0, -a, a ** 2.0])
        outs.append(run(s, {"x": x, "y": y}))
    for r, o in zip(*outs):
        np.testing.assert_allclose(o, r, **ELEM)


@pytest.mark.parametrize("n", [2, 3])
def test_elementwise_sum(n):
    ins = {"a%d" % i: _rand(3, 4, seed=i) for i in range(n)}
    outs = []
    for pkg, run in ((jmx, run_jax), (tmx, run_torch)):
        s = pkg.sym.ElementWiseSum(*[pkg.sym.Variable(k) for k in ins],
                                   name="op")
        outs.append(run(s, ins))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **ELEM)


@pytest.mark.parametrize("dim", [1, 3])
def test_concat(dim):
    ins = {"a": _rand(2, 3, 4, 5, seed=1), "b": _rand(2, 3, 4, 5, seed=2)}
    outs = []
    for pkg, run in ((jmx, run_jax), (tmx, run_torch)):
        s = pkg.sym.Concat(pkg.sym.Variable("a"), pkg.sym.Variable("b"),
                           dim=dim, name="op")
        outs.append(run(s, ins))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **ELEM)


def test_param_parse_reads_tojson_strings():
    """The string forms tojson writes ("(3, 3)", "False", "2e-05") parse
    back to the same values in the port."""
    op = tmx.ops.create_operator("Convolution", kernel="(3, 3)",
                                 num_filter="8", no_bias="False",
                                 stride="(2, 2)")
    assert op.kernel == (3, 3) and op.num_filter == 8
    assert op.no_bias is False and op.stride == (2, 2)
    bn = tmx.ops.create_operator("BatchNorm", eps="2e-05", fix_gamma="True")
    assert bn.eps == 2e-5 and bn.fix_gamma is True
    with pytest.raises(tmx.MXNetError, match="unknown parameters"):
        tmx.ops.create_operator("Convolution", kernel=(3, 3),
                                num_filter=8, kernal=(3, 3))
