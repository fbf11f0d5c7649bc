"""The port's NDArray methods, arithmetic and function zoo
(mxnet_tpu_torch/ndarray.py) and ``mx.nd.<OpName>`` for every op in its
registry (mxnet_tpu_torch/ndarray_ops.py), against the JAX package's on
the same seeded numpy inputs. Float results within rtol 1e-6 / atol 1e-6
(elementwise float32 math; the convolution and the matrix products at
rtol 1e-5), integer and 0/1 results exactly, dtypes equal."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-6, 1e-6


def _x(shape=(3, 4), seed=0, positive=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


def _both(fn, *arrays):
    """``fn(pkg, *NDArrays)`` in both packages -> (port, jax) numpy."""
    out = []
    for pkg in (tmx, jmx):
        nds = [pkg.nd.array(a, ctx=pkg.cpu(), dtype=a.dtype) for a in arrays]
        res = fn(pkg, *nds)
        out.append(res.asnumpy() if hasattr(res, "asnumpy") else res)
    return out


def _same(mine, theirs, rtol=RTOL):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape
    assert mine.dtype == theirs.dtype
    np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=ATOL)


BINARY = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
          "pow": lambda a, b: a ** b,
          "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
          "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
          "lt": lambda a, b: a < b, "le": lambda a, b: a <= b}


# a scalar on the left of a comparison is Python's reflected comparison
# of the array, which the "scalar" cases hold; neither package has
# __rpow__
CASES = [(op, rhs) for op in sorted(BINARY) for rhs in ("array", "scalar",
                                                          "rscalar")
         if rhs != "rscalar" or op in ("add", "sub", "mul", "div")]


@pytest.mark.parametrize("op,rhs", CASES)
def test_binary_operators_match_jax(op, rhs):
    fn = BINARY[op]
    a, b = _x(positive=True), _x(seed=1, positive=True)
    b[0] = a[0]   # some equal elements for the comparisons
    if rhs == "array":
        got = _both(lambda pkg, x, y: fn(x, y), a, b)
    elif rhs == "scalar":
        got = _both(lambda pkg, x: fn(x, 1.5), a)
    else:
        got = _both(lambda pkg, x: fn(2.0, x), a)
    _same(*got)


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "idiv", "neg"])
def test_inplace_and_unary_operators(op):
    a, b = _x(), _x(seed=1, positive=True)

    def fn(pkg, x, y):
        if op == "neg":
            return -x
        h = x.handle if pkg is tmx else None
        if op == "iadd":
            x += y
        elif op == "isub":
            x -= 2.0
        elif op == "imul":
            x *= y
        else:
            x /= y
        if pkg is tmx:   # in place: the same tensor, written
            assert x.handle is h
        return x
    _same(*_both(fn, a, b))


def test_properties_and_methods_match_jax():
    a = _x((2, 3, 4))
    for fn in (lambda pkg, x: x.size, lambda pkg, x: x.ndim,
               lambda pkg, x: len(x), lambda pkg, x: x.shape):
        mine, theirs = _both(fn, a)
        assert mine == theirs
    for fn in (lambda pkg, x: x.reshape((0, -1)),
               lambda pkg, x: x.reshape((4, 0, 2)),
               lambda pkg, x: x.reshape(24), lambda pkg, x: x.T,
               lambda pkg, x: x.slice(1, 2), lambda pkg, x: x.copy(),
               lambda pkg, x: x.astype("int32"),
               lambda pkg, x: x[1]):
        _same(*_both(fn, a))
    s = _both(lambda pkg, x: x[0:1, 0:1, 1:2].asscalar(), a)
    assert s[0] == s[1]
    c = tmx.nd.array(a, ctx=tmx.cpu())
    d = c.copy()
    d += 1
    assert not np.array_equal(c.asnumpy(), d.asnumpy())
    c.wait_to_read()
    c.wait_to_write()
    with pytest.raises(tmx.MXNetError, match="size-1"):
        c.asscalar()
    with pytest.raises(tmx.MXNetError, match="ambiguous"):
        bool(c)
    assert bool(tmx.nd.array([2.0], ctx=tmx.cpu()))


UNARY = ["exp", "log", "sqrt", "square", "abs", "sign", "round", "ceil",
         "floor", "cos", "sin", "relu", "sigmoid", "tanh"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_zoo_matches_jax(name):
    a = _x(positive=name in ("log", "sqrt")) * 3
    _same(*_both(lambda pkg, x: getattr(pkg.nd, name)(x), a))
    out = _both(lambda pkg, x: getattr(pkg.nd, name)(
        x, out=pkg.nd.zeros(x.shape, ctx=pkg.cpu())), a)
    _same(*out)


@pytest.mark.parametrize("name", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, False),
                                           (0, True), (None, True)])
def test_reductions_match_jax(name, axis, keepdims):
    a = _x((3, 4, 5))
    _same(*_both(lambda pkg, x: getattr(pkg.nd, name)(
        x, axis=axis, keepdims=keepdims), a), rtol=1e-5)


FUNCTIONS = {
    "dot_2d": (lambda pkg, a, b: pkg.nd.dot(a, b.T), ((3, 4), (5, 4))),
    "dot_1d": (lambda pkg, a, b: pkg.nd.dot(a, b), ((4,), (4, 3))),
    "dot_3d": (lambda pkg, a, b: pkg.nd.dot(a, b), ((2, 3, 4), (4, 5))),
    "maximum": (lambda pkg, a, b: pkg.nd.maximum(a, b), ((3, 4), (3, 4))),
    "minimum": (lambda pkg, a, b: pkg.nd.minimum(a, b), ((3, 4), (3, 4))),
    "maximum_scalar": (lambda pkg, a: pkg.nd.maximum(0.2, a), ((3, 4),)),
    "minimum_scalar": (lambda pkg, a: pkg.nd.minimum(a, 0.2), ((3, 4),)),
    "clip": (lambda pkg, a: pkg.nd.clip(a, -0.5, 0.3), ((3, 4),)),
    "argmax_channel": (lambda pkg, a: pkg.nd.argmax_channel(a), ((5, 7),)),
    "norm": (lambda pkg, a: pkg.nd.norm(a), ((6, 7),)),
    "transpose": (lambda pkg, a: pkg.nd.transpose(a), ((2, 3, 4),)),
    "transpose_axes": (lambda pkg, a: pkg.nd.transpose(a, axes=(1, 0, 2)),
                       ((2, 3, 4),)),
    "broadcast_to": (lambda pkg, a: pkg.nd.broadcast_to(a, (4, 3)),
                     ((1, 3),)),
    "concatenate": (lambda pkg, a, b: pkg.nd.concatenate([a, b], axis=1),
                    ((2, 3), (2, 5))),
    "element_mask": (lambda pkg, a, b: pkg.nd.element_mask(
        a, pkg.nd.array((b > 0).astype(np.float32).asnumpy()[:, 0],
                        ctx=pkg.cpu())), ((4, 3, 2), (4, 1))),
    "crop_assign": (lambda pkg, a, b: pkg.nd.crop_assign(
        a, b, (1, 0), (3, 2)), ((4, 3), (2, 2))),
    "crop_assign_scalar": (lambda pkg, a: pkg.nd.crop_assign_scalar(
        a, 7.0, (0, 1), (2, 3)), ((4, 3),)),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_match_jax(name):
    fn, shapes = FUNCTIONS[name]
    arrays = [_x(s, seed=i) for i, s in enumerate(shapes)]
    _same(*_both(fn, *arrays), rtol=1e-5)


def test_index_functions_match_jax():
    idx = np.array([2, 0, 3, 1], np.float32)
    got = _both(lambda pkg, i: pkg.nd.onehot_encode(
        i, pkg.nd.zeros((4, 5), ctx=pkg.cpu())), idx)
    _same(*got)
    a = _x((4, 5))
    _same(*_both(lambda pkg, x, i: pkg.nd.choose_element_0index(x, i),
                 a, idx))


def test_creation_functions_match_jax():
    for fn in (lambda pkg: pkg.nd.full((2, 3), 1.5, ctx=pkg.cpu()),
               lambda pkg: pkg.nd.full(4, -2, ctx=pkg.cpu(), dtype="int32"),
               lambda pkg: pkg.nd.arange(2, 11, 3, ctx=pkg.cpu()),
               lambda pkg: pkg.nd.arange(4, repeat=2, ctx=pkg.cpu()),
               lambda pkg: pkg.nd.arange(0, 1, 0.25, ctx=pkg.cpu())):
        _same(fn(tmx).asnumpy(), fn(jmx).asnumpy())
    tmx.nd.waitall()


@pytest.mark.parametrize("case", ["rank", "range", "rhs_shape", "mask"])
def test_region_checks_raise_as_jax(case):
    def fn(pkg):
        a = pkg.nd.zeros((4, 3), ctx=pkg.cpu())
        if case == "rank":
            return pkg.nd.crop_assign_scalar(a, 1.0, (0,), (1,))
        if case == "range":
            return pkg.nd.crop_assign_scalar(a, 1.0, (0, 2), (1, 4))
        if case == "rhs_shape":
            return pkg.nd.crop_assign(a, pkg.nd.zeros((2, 2), ctx=pkg.cpu()),
                                      (0, 0), (1, 2))
        return pkg.nd.element_mask(a, pkg.nd.zeros((3,), ctx=pkg.cpu()))
    msgs = []
    for pkg in (tmx, jmx):
        with pytest.raises(pkg.MXNetError) as e:
            fn(pkg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_operands_on_two_devices_raise():
    """Results stay on the operands' device; a meta-device operand stands
    for a second device here."""
    a = tmx.nd.array(_x(), ctx=tmx.cpu())
    import torch
    other = tmx.nd.NDArray(torch.empty((3, 4), device="meta"), tmx.cpu())
    for fn in (lambda: a + other, lambda: a == other,
               lambda: tmx.nd.dot(a, other.T),
               lambda: tmx.nd.maximum(a, other)):
        with pytest.raises(tmx.MXNetError, match="two devices"):
            fn()
    assert (a + a).handle.device == a.handle.device


# -- mx.nd.<OpName> ----------------------------------------------------------
OPS = {
    "FullyConnected": ([(4, 6), (3, 6), (3,)], {"num_hidden": 3}),
    "Convolution": ([(2, 3, 8, 8), (4, 3, 3, 3), (4,)],
                    {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1),
                     "stride": (2, 2)}),
    "Activation": ([(3, 5)], {"act_type": "tanh"}),
    "Pooling": ([(2, 3, 6, 6)], {"kernel": (2, 2), "stride": (2, 2),
                                 "pool_type": "max"}),
    "SoftmaxOutput": ([(4, 5), (4,)], {}),
    "LRN": ([(2, 6, 4, 4)], {"nsize": 3}),
    "Flatten": ([(2, 3, 4)], {}),
    "Concat": ([(2, 3), (2, 4)], {"num_args": 2, "dim": 1}),
    "ElementWiseSum": ([(2, 3), (2, 3)], {"num_args": 2}),
    "Dropout": ([(3, 4)], {"p": 0.5}),
    "LinearRegressionOutput": ([(4, 2), (4, 2)], {}),
    "_Plus": ([(3, 4), (3, 4)], {}),
}


def _op_inputs(name, shapes):
    arrays = [_x(s, seed=i) for i, s in enumerate(shapes)]
    if name == "SoftmaxOutput":
        arrays[1] = np.array([0, 3, 1, 4], np.float32)
    return arrays


@pytest.mark.parametrize("name", sorted(OPS))
def test_imperative_op_matches_jax(name):
    if name not in {n for n, _ in tmx.ops.OP_REGISTRY.items()} \
            and name.lower() not in {n for n, _ in
                                     tmx.ops.OP_REGISTRY.items()}:
        pytest.fail("%s is not in the port's registry" % name)
    shapes, params = OPS[name]
    arrays = _op_inputs(name, shapes)
    _same(*_both(lambda pkg, *xs: getattr(pkg.nd, name)(*xs, **params),
                 *arrays), rtol=1e-5)


def test_every_registered_op_is_imperative():
    names = {cls.op_name for _, cls in tmx.ops.OP_REGISTRY.items()}
    for name in names:
        assert callable(getattr(tmx.nd, name)), name
    # hand-written functions keep their own definition
    assert tmx.nd.clip.__module__ == "mxnet_tpu_torch.ndarray"


def test_imperative_op_errors_and_train_mode():
    x = tmx.nd.array(np.ones((4, 3), np.float32), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="auxiliary states"):
        tmx.nd.BatchNorm(x, x, x)
    with pytest.raises(tmx.MXNetError, match="expects inputs"):
        tmx.nd.FullyConnected(x, num_hidden=2)
    with pytest.raises(tmx.MXNetError, match="must be NDArrays"):
        tmx.nd.Activation(np.ones(3), act_type="relu")
    y = tmx.nd.array(np.ones((64, 64), np.float32), ctx=tmx.cpu())
    tmx.random.seed(1)
    a = tmx.nd.Dropout(y, p=0.5, is_train=True).asnumpy()
    tmx.random.seed(1)
    b = tmx.nd.Dropout(y, p=0.5, is_train=True).asnumpy()
    assert np.array_equal(a, b)
    assert set(np.unique(a)) == {0.0, 2.0}
    assert abs((a == 0).mean() - 0.5) < 0.05
    assert np.array_equal(tmx.nd.Dropout(y, p=0.5).asnumpy(), y.asnumpy())
