"""The four parity faults of ROADMAP.md's Queue C, items 5-8, each held
against the JAX package on the CPU:

5. Symbol's indexing, ``len``, iteration, attributes, ``get_children``,
   ``grad``, ``infer_shape_partial``, ``infer_type`` and ``eval`` (the
   cases of tests/test_symbol.py and tests/test_infer_type.py);
6. ``Executor.reshape`` keeping the gradients, ``Executor.debug_str``
   and ``Predictor.reshape``;
7. ``Module.iter_predict``, ``get_symbol`` and ``output_shapes``;
8. ``name.Prefix``, ``Registry.list_names``, ``NDArray.writable``,
   ``context.num_devices`` and ``Context.devtype2str``.

Forward values within rtol 1e-5 / atol 1e-6, gradients rtol 1e-4."""
import io

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.predictor  # noqa: F401  (jmx.predictor)
import mxnet_tpu_torch as tmx
from test_torch_common import fresh_names


def _mlp(pkg):
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data=data, name="fc1", num_hidden=10)
        net = pkg.sym.Activation(data=net, act_type="relu", name="relu1")
        net = pkg.sym.FullyConnected(data=net, name="fc2", num_hidden=4)
        return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _probe(pkg):
    """data -> FullyConnected fc1 -> Activation (ROADMAP.md's probe)."""
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc1")
        return pkg.sym.Activation(fc, act_type="relu")


# -- item 5: Symbol ---------------------------------------------------------
def test_symbol_indexing_len_and_iteration_match_jax():
    t, j = _probe(tmx).get_internals(), _probe(jmx).get_internals()
    assert len(t) == len(j) == 5
    assert t["fc1_output"].list_arguments() == \
        j["fc1_output"].list_arguments() == ["data", "fc1_weight",
                                             "fc1_bias"]
    assert [s.list_outputs() for s in t] == [s.list_outputs() for s in j]
    assert t[1].name == j[1].name == "fc1_weight"
    with pytest.raises(tmx.MXNetError, match="not found"):
        t["nope_output"]
    grp = {pkg: pkg.sym.Group([_mlp(pkg), _probe(pkg)]) for pkg in (tmx,
                                                                   jmx)}
    assert grp[tmx][0].name == grp[jmx][0].name == "softmax"
    assert grp[tmx][1].list_outputs() == grp[jmx][1].list_outputs()
    # a multi-output node: output i of SliceChannel, not a node of the
    # internals
    for pkg in (tmx, jmx):
        s = pkg.sym.SliceChannel(pkg.sym.Variable("data"), num_outputs=60,
                                 axis=1, squeeze_axis=True, name="sl")
        assert len(s) == 60
        assert s[37].list_outputs() == ["sl_output37"]
        assert s[37].infer_shape(data=(2, 60, 3))[1] == [(2, 3)]


def test_symbol_children_and_attributes_match_jax():
    for pkg in (tmx, jmx):
        net = _mlp(pkg)
        kids = net.get_children()
        assert kids.list_outputs() == ["fc2_output", "softmax_label"]
        assert pkg.sym.Variable("x").get_children() is None
        data = pkg.sym.Variable("data", attr={"ctx_group": "dev1"})
        assert data.attr("ctx_group") == "dev1"
        assert data.attr("missing") is None
        with pkg.AttrScope(ctx_group="dev2"):
            fc = pkg.sym.FullyConnected(data=data, num_hidden=3, name="fc")
        assert fc.attr("ctx_group") == "dev2"
        assert fc.list_attr() == {"ctx_group": "dev2"}
        w = pkg.sym.Variable("w", lr_mult=2.0, wd_mult=0.5)
        assert w.attr("__lr_mult__") == "2.0"
        assert w.list_attr() == {"__lr_mult__": "2.0", "__wd_mult__": "0.5"}
        assert pkg.sym.Group([fc, w]).list_attr() == {}


def test_infer_shape_partial_matches_jax():
    for pkg in (tmx, jmx):
        with fresh_names(pkg):
            fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                        num_hidden=10, name="fc")
        args, outs, aux = fc.infer_shape_partial()
        assert args == [None, None, None] and outs == [None]
        args, outs, _ = fc.infer_shape_partial(data=(3, 5))
        assert args == [(3, 5), (10, 5), (10,)] and outs == [(3, 10)]
        bn = pkg.sym.BatchNorm(pkg.sym.Variable("data"), name="bn")
        assert bn.infer_shape_partial()[2] == [None, None]
        with pytest.raises(Exception):
            fc.infer_shape()


def _cast_net(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    h = pkg.sym.Cast(h, dtype="float16")
    return pkg.sym.FullyConnected(h, num_hidden=4, name="fc2")


def _bn(pkg):
    return pkg.sym.BatchNorm(data=pkg.sym.Variable("data"), name="bn")


def _chain(pkg):
    xs = [pkg.sym.Variable("x%d" % i) for i in range(5)]
    net = xs[0]
    for x in xs[1:]:
        net = net * x
    return net


def _emb(pkg):
    return pkg.sym.Embedding(pkg.sym.Variable("data"), input_dim=10,
                             output_dim=4, name="emb") * \
        pkg.sym.Variable("w2")


INFER_TYPE_CASES = {
    "default_float32": (_mlp, (), {}),
    "fp16_seed": (_mlp, (), {"data": np.float16}),
    "fp64_positional": (_mlp, (np.float64,), {}),
    "cast_boundary": (_cast_net, (), {"data": np.float32}),
    "batchnorm_aux_f32": (_bn, (), {"data": np.float16}),
    "fp64_single_op": (lambda pkg: pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=4), (), {"data": np.float64}),
    "late_seed": (_chain, (), {"x4": np.float16}),
    "embedding_follows_downstream": (_emb, (), {"w2": np.float16,
                                                "data": np.int32}),
}


@pytest.mark.parametrize("case", sorted(INFER_TYPE_CASES))
def test_infer_type_matches_jax(case):
    build, args, kwargs = INFER_TYPE_CASES[case]
    with fresh_names(tmx):
        t = build(tmx).infer_type(*args, **kwargs)
    with fresh_names(jmx):
        j = build(jmx).infer_type(*args, **kwargs)
    assert [list(map(np.dtype, x)) for x in t] == \
        [list(map(np.dtype, x)) for x in j]


def test_infer_type_errors_match_jax():
    for pkg in (tmx, jmx):
        with pytest.raises(pkg.MXNetError, match="bogus"):
            _mlp(pkg).infer_type(bogus=np.float32)
        a, b, c = (pkg.sym.Variable(n) for n in "abc")
        with pytest.raises(pkg.MXNetError):
            ((a * b) + (a * c)).infer_type(b=np.float16, c=np.float64)


def test_simple_bind_takes_dtypes_from_infer_type():
    net = _mlp(tmx)
    ex = net.simple_bind(tmx.cpu(), type_dict={"data": "float64"},
                         data=(2, 3))
    assert all(a.dtype == np.float64 for a in ex.arg_arrays)
    assert all(g.dtype == np.float64 for g in ex.grad_dict.values())
    bn = _bn(tmx).simple_bind(tmx.cpu(), type_dict={"data": np.float16},
                              data=(2, 3, 4, 4))
    assert bn.arg_dict["bn_gamma"].dtype == np.float16
    assert all(a.dtype == np.float32 for a in bn.aux_arrays)


def _grad_case(pkg):
    data = pkg.sym.Variable("data")
    w = pkg.sym.Variable("w")
    fc = pkg.sym.FullyConnected(data=data, weight=w, no_bias=True,
                                num_hidden=3, name="fc")
    ints = pkg.sym.Cast(fc, dtype="int32", name="ci")
    act = pkg.sym.Activation(fc, act_type="tanh", name="act")
    return pkg.sym.Group([act, ints]).grad(["w", "data"])


def test_symbol_grad_matches_jax():
    """A bindable gradient symbol over a group with an integer head: the
    float head's gradients in both packages, in an inference forward."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 4).astype(np.float32)
    w = rng.rand(3, 4).astype(np.float32)
    outs = {}
    for pkg in (tmx, jmx):
        with fresh_names(pkg):
            g = _grad_case(pkg)
        assert g.list_outputs()[0].endswith("w_grad")
        ex = g.simple_bind(pkg.cpu(), data=(2, 4), w=(3, 4),
                           grad_req="null")
        ex.arg_dict["data"][:] = x
        ex.arg_dict["w"][:] = w
        outs[pkg] = [o.asnumpy() for o in ex.forward()]
    for a, b in zip(outs[tmx], outs[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(tmx.MXNetError, match="unknown arguments"):
        _mlp(tmx).grad(["nope"])


def test_symbol_eval_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = {}
    for pkg in (tmx, jmx):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        ctx = pkg.cpu()
        got[pkg] = (a * b + 1).eval(ctx=ctx, a=pkg.nd.array(x, ctx=ctx),
                                    b=pkg.nd.array(x + 1, ctx=ctx))
    np.testing.assert_array_equal(got[tmx][0].asnumpy(),
                                  got[jmx][0].asnumpy())


# -- item 6: Executor.reshape, debug_str, Predictor.reshape ------------------
def _lro(pkg):
    with fresh_names(pkg):
        fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                    name="fc")
        return pkg.sym.LinearRegressionOutput(fc, name="lro")


def test_executor_reshape_keeps_gradients_and_matches_jax():
    """ROADMAP.md's probe: bound at (8, 3), reshaped to (2, 3). The grad
    arrays take the new shapes [(2, 3), (4, 3), (4,), (2, 4)], the
    weights' grads are the same arrays, backward writes them, and
    the values equal the JAX package's."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3).astype(np.float32)
    y = rng.randn(2, 4).astype(np.float32)
    w = rng.randn(4, 3).astype(np.float32)
    grads = {}
    for pkg in (tmx, jmx):
        ex = _lro(pkg).simple_bind(pkg.cpu(), data=(8, 3))
        ex2 = ex.reshape(data=(2, 3))
        assert [None if g is None else tuple(g.shape)
                for g in ex2.grad_arrays] == [(2, 3), (4, 3), (4,), (2, 4)]
        assert ex2.grad_dict["fc_weight"] is ex.grad_dict["fc_weight"]
        assert ex2.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
        ex2.arg_dict["data"][:] = x
        ex2.arg_dict["lro_label"][:] = y
        ex2.arg_dict["fc_weight"][:] = w
        ex2.forward(is_train=True)
        ex2.backward()
        grads[pkg] = {k: v.asnumpy() for k, v in ex2.grad_dict.items()}
    assert sorted(grads[tmx]) == sorted(grads[jmx])
    assert np.abs(grads[tmx]["fc_weight"]).sum() > 0
    for k in grads[jmx]:
        np.testing.assert_allclose(grads[tmx][k], grads[jmx][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ex = _lro(tmx).simple_bind(tmx.cpu(), data=(8, 3), grad_req="add")
    ex2 = ex.reshape(data=(8, 3), fresh_args=["data"])
    assert ex2._grad_req["fc_weight"] == "add"
    assert ex2.arg_dict["data"] is not ex.arg_dict["data"]


def test_debug_str_matches_jax():
    t = _mlp(tmx).simple_bind(tmx.cpu(), data=(2, 3)).debug_str()
    j = _mlp(jmx).simple_bind(jmx.cpu(), data=(2, 3)).debug_str()
    assert t == j
    assert "fc1" in t and "FullyConnected" in t


def test_predictor_reshape_matches_jax():
    """A predictor over the MLP reshaped from batch 4 to batch 2: the
    outputs equal the JAX predictor's reshaped one, the weights are
    shared with the original, which stays valid."""
    rng = np.random.RandomState(5)
    net = _mlp(tmx)
    shapes, _, _ = net.infer_shape(data=(4, 3))
    params = {"arg:" + n: rng.randn(*s).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    buf = io.BytesIO()
    tmx.nd.save_to_stream(buf, {k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in params.items()})
    blob = buf.getvalue()
    x4 = rng.randn(4, 3).astype(np.float32)
    x2 = rng.randn(2, 3).astype(np.float32)
    tp = tmx.Predictor(net.tojson(), blob, {"data": (4, 3)}, ctx=tmx.cpu())
    jp = jmx.predictor.Predictor(_mlp(jmx).tojson(), blob,
                                 {"data": (4, 3)}, ctx=jmx.cpu())
    with pytest.raises(tmx.MXNetError, match="Predictor.reshape"):
        tp.set_input("data", x2)
    tp2, jp2 = tp.reshape({"data": (2, 3)}), jp.reshape({"data": (2, 3)})
    assert tp2._executor.arg_dict["fc1_weight"] is \
        tp._executor.arg_dict["fc1_weight"]
    assert tp2._executor.arg_dict["data"] is not tp._executor.arg_dict["data"]
    for p, x in ((tp2, x2), (jp2, x2), (tp, x4), (jp, x4)):
        p.forward(data=x)
    np.testing.assert_allclose(tp2.get_output(0), jp2.get_output(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.get_output(0), jp.get_output(0),
                               rtol=1e-5, atol=1e-6)
    assert tp2.get_output(0).shape == (2, 4)


# -- item 7: Module ----------------------------------------------------------
def test_module_iter_predict_get_symbol_output_shapes_match_jax():
    """iter_predict over 10 rows in batches of 4 (a short last batch of
    2, padded and sliced back off as predict does), get_symbol and
    output_shapes."""
    rng = np.random.RandomState(6)
    x = rng.randn(10, 3).astype(np.float32)
    y = rng.randint(0, 4, 10).astype(np.float32)
    sym = _mlp(tmx)
    shapes, _, _ = sym.infer_shape(data=(4, 3))
    params = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    got = {}
    for pkg in (tmx, jmx):
        net = _mlp(pkg)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=4)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in params.items()})
        assert mod.get_symbol() is net
        assert mod.output_shapes == [("softmax_output", (4, 4))]
        got[pkg] = [(nb, [o.asnumpy() for o in outs],
                     batch.data[0].shape[0])
                    for outs, nb, batch in mod.iter_predict(it)]
        whole = mod.predict(it).asnumpy()
        np.testing.assert_array_equal(
            np.concatenate([o[0] for _, o, _ in got[pkg]]), whole)
    assert [(nb, rows) for nb, _, rows in got[tmx]] == \
        [(nb, rows) for nb, _, rows in got[jmx]]
    assert [o[0].shape for _, o, _ in got[tmx]] == [(4, 4), (4, 4), (2, 4)]
    for (_, a, _), (_, b, _) in zip(got[tmx], got[jmx]):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)


# -- item 8: small names -----------------------------------------------------
def test_small_names_match_jax():
    for pkg in (tmx, jmx):
        with pkg.name.Prefix("mod_"):
            fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                        num_hidden=2)
            named = pkg.sym.Activation(fc, act_type="relu", name="act")
        assert fc.name == "mod_fullyconnected0"
        assert named.name == "mod_act"
        assert fc.list_arguments() == ["data", "mod_fullyconnected0_weight",
                                       "mod_fullyconnected0_bias"]
        names = pkg.ops.OP_REGISTRY.list_names()
        assert names == sorted(names) and "fullyconnected" in names
        assert pkg.base.Registry.get_registry("operator") \
            .list_names() == names
        assert pkg.context.Context.devtype2str[1] == "cpu"
        assert pkg.context.Context.devtype2str[3] == "cpu_pinned"
        assert pkg.context.num_devices("cpu") >= 1
    assert tmx.context.Context.devtype2str[2] == "gpu"
    assert tmx.cpu().device_typeid == 1 and tmx.gpu().device_typeid == 2
    assert tmx.context.num_devices("gpu") == (
        tmx.context.torch.cuda.device_count()
        if tmx.context.torch.cuda.is_available() else 0)
    with pytest.raises(tmx.MXNetError, match="unknown device type"):
        tmx.context.num_devices("tpu")


def test_ndarray_writable_matches_jax():
    for pkg in (tmx, jmx):
        ctx = pkg.cpu()
        a = pkg.nd.array(np.ones((2, 3), np.float32), ctx=ctx)
        assert a.writable
        data = a.handle if pkg is tmx else a._data
        ro = pkg.nd.NDArray(data, ctx, writable=False)
        assert not ro.writable
        with pytest.raises(pkg.MXNetError, match="not writable"):
            ro[:] = 2.0
        with pytest.raises(pkg.MXNetError, match="non-writable"):
            ro += 1.0
        np.testing.assert_array_equal(ro.asnumpy(), np.ones((2, 3)))
        assert (ro + 1).writable
        a.writable = False
        with pytest.raises(pkg.MXNetError):
            a[0] = 5.0
