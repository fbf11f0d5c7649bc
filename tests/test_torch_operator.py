"""Parity of the port's Python-defined operators with the JAX package's
(CPU, seeded numpy inputs): one duck-typed CustomOpProp class (it
subclasses neither package's CustomOpProp) registered with both
packages' ``register``, a two-input, two-output op with a label that
takes no gradient, and a NumpyOp through ``get_symbol``; forward and
VJP within rtol 1e-5 / atol 1e-6 (the same numpy code runs on the host
in both packages); the JAX package's contract (``req`` "write", the
first input's dtype, ``create_operator`` once a node with ``ctx=None``,
the head gradient always passed); symbol JSON across the packages; and
the fused steps' refusal of a Custom node."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_common import (assert_parity, both_fwd_bwd, ckpt_data,
                               ckpt_params, fresh_names)

TOL = dict(rtol=1e-5, atol=1e-6, grad_rtol=1e-5, grad_atol=1e-6)
CREATED = []      # (op_type, ctx, in_shapes, in_dtypes) a create_operator
REQS = []         # the reqs each forward and backward saw
HEADS = []        # whether backward got a head gradient


class TanhScaleOp:
    """y = scale * tanh(x), written with plain slice assignment."""

    def __init__(self, scale):
        self.scale = scale

    def forward(self, is_train, req, in_data, out_data, aux):
        REQS.append(tuple(req))
        out_data[0][:] = self.scale * np.tanh(in_data[0].asnumpy())

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        REQS.append(tuple(req))
        HEADS.append(out_grad[0] is not None)
        t = np.tanh(in_data[0].asnumpy())
        in_grad[0][:] = out_grad[0].asnumpy() * self.scale * (1 - t * t)


class TanhScaleProp:
    """Duck-typed: the methods a prop needs, no base class."""

    def __init__(self, scale="2.0"):
        self.scale = float(scale)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return True

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        CREATED.append(("tanh_scale", ctx, in_shapes, list(in_dtypes)))
        return TanhScaleOp(self.scale)


class MixOp:
    """(a + w * b, a * b) of data a and weights b; the label only scales
    the first output's gradient and takes none itself."""

    def forward(self, is_train, req, in_data, out_data, aux):
        a, b, lab = (x.asnumpy() for x in in_data)
        out_data[0][:] = a + lab[:, None] * b
        out_data[1][:] = a * b

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        a, b, lab = (x.asnumpy() for x in in_data)
        g0, g1 = (g.asnumpy() for g in out_grad)
        in_grad[0][:] = g0 + g1 * b
        in_grad[1][:] = g0 * lab[:, None] + g1 * a
        in_grad[2][:] = 0


for _pkg in (jmx, tmx):
    _pkg.operator.register("tanh_scale")(TanhScaleProp)

    class _MixProp(_pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["a", "b", "label"]

        def list_outputs(self):
            return ["mixed", "product"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            CREATED.append(("mix", ctx, in_shapes, list(in_dtypes)))
            return MixOp()

    _pkg.operator.register("mix")(_MixProp)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_custom_op_matches_jax_and_keeps_the_contract():
    CREATED.clear()
    REQS.clear()
    HEADS.clear()

    def build(pkg):
        return pkg.sym.Custom(pkg.sym.Variable("data"), op_type="tanh_scale",
                              scale="1.5", name="op")

    args = {"data": _x(4, 5, seed=1)}
    want, got = both_fwd_bwd(build, args)
    assert_parity(got, want, **TOL)
    np.testing.assert_allclose(got[0][0], 1.5 * np.tanh(args["data"]),
                               rtol=1e-6)
    # per package: the shape pass's inference forward and the train
    # forward share one operator a node, built with ctx=None
    port = [c for c in CREATED if c[0] == "tanh_scale"]
    assert all(c[1] is None and c[2] == [[4, 5]] for c in port)
    assert set(REQS) == {("write",)} and HEADS and all(HEADS)


def test_custom_op_with_two_outputs_and_a_label_matches_jax():
    CREATED.clear()

    def build(pkg):
        v = pkg.sym.Variable
        return pkg.sym.Group(list(pkg.sym.Custom(
            a=v("a"), b=v("b"), label=v("label"), op_type="mix", name="op")))

    args = {"a": _x(3, 4, seed=2), "b": _x(3, 4, seed=3),
            "label": np.array([1, 0, 2], np.float32)}
    want, got = both_fwd_bwd(build, args, grad_names=["a", "b"])
    assert_parity(got, want, **TOL)
    assert got[0][1].dtype == np.float32
    assert all(c[1] is None for c in CREATED if c[0] == "mix")


def test_numpy_op_through_get_symbol_matches_jax():
    made = {}
    for pkg in (jmx, tmx):
        class Square(pkg.operator.NumpyOp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0] ** 2

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = 2 * in_data[0] * out_grad[0]

        made[pkg] = Square()

    def build(pkg):
        return made[pkg].get_symbol(pkg.sym.Variable("data"), name="sq")

    args = {"data": _x(3, 3, seed=4)}
    want, got = both_fwd_bwd(build, args)
    assert_parity(got, want, **TOL)
    with fresh_names(tmx):
        sym = build(tmx)
    op_type = sym._outputs[0][0].op.params["op_type"]
    assert op_type == "_pyop_Square_%d" % id(made[tmx])


def test_custom_symbol_json_crosses_both_ways():
    js, ts = [], []
    for pkg, out in ((jmx, js), (tmx, ts)):
        with fresh_names(pkg):
            out.append(pkg.sym.Custom(pkg.sym.Variable("data"),
                                      op_type="tanh_scale", scale=0.25,
                                      name="op"))
    assert ts[0].tojson() == js[0].tojson()
    assert '"scale": "0.25"' in ts[0].tojson()
    assert tmx.sym.load_json(js[0].tojson()).tojson() == js[0].tojson()
    assert jmx.sym.load_json(ts[0].tojson()).tojson() == ts[0].tojson()


def test_custom_refuses_an_unregistered_op_type():
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tmx.sym.Custom(tmx.sym.Variable("data"), op_type="no_such_op")


def _custom_mlp(pkg):
    with fresh_names(pkg):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                     num_hidden=3, name="fc1")
        net = pkg.sym.Custom(net, op_type="tanh_scale", name="squash")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_fused_steps_refuse_a_custom_node_and_the_classic_loop_trains():
    """A host callback cannot live inside a CUDA graph: fit(fused_step=
    True) and make_fused_infer raise naming the node; the classic loop
    trains the same graph as the JAX package does."""
    x, y = ckpt_data(2)
    net = _custom_mlp(tmx)
    params = {k: v for k, v in ckpt_params(net).items() if k in
              ("fc1_weight", "fc1_bias")}
    mod = tmx.mod.Module(net, context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=8)
    with pytest.raises(tmx.MXNetError, match=r"Custom node\(s\) \['squash'\]"):
        mod.fit(it, num_epoch=1, arg_params={
            k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in params.items()},
            fused_step=True)
    ex = net.simple_bind(tmx.cpu(), grad_req="null", data=(8, 6))
    with pytest.raises(tmx.MXNetError, match="squash"):
        tmx.fused_step.make_fused_infer(ex, ["data"])

    def train(pkg):
        mod = pkg.mod.Module(_custom_mlp(pkg), context=pkg.cpu())
        kw = {"ctx": pkg.cpu()} if pkg is tmx else {}
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                arg_params={k: pkg.nd.array(v, **kw)
                            for k, v in params.items()},
                optimizer="sgd", optimizer_params=(("learning_rate", 0.1),))
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    want, got = train(jmx), train(tmx)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
        assert not np.array_equal(got[k], params[k])
