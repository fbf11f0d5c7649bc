"""The four parity faults of ROADMAP.md's Queue C, items 5-8, each held
against the JAX package on the CPU:

5. Symbol's indexing, ``len``, iteration, attributes, ``get_children``,
   ``grad``, ``infer_shape_partial``, ``infer_type`` and ``eval`` (the
   cases of tests/test_symbol.py and tests/test_infer_type.py);
6. ``Executor.reshape`` keeping the gradients, ``Executor.debug_str``
   and ``Predictor.reshape``;
7. ``Module.iter_predict``, ``get_symbol`` and ``output_shapes``;
8. ``name.Prefix``, ``Registry.list_names``, ``NDArray.writable``,
   ``context.num_devices`` and ``Context.devtype2str``;
9. ROIPooling's bins in the data's dtype: in bfloat16 and float16 the
   reference computes each bin's edges in that dtype, and the port
   computed them in float32 (77 of 3136 values differed in bfloat16 at
   the seeded case below);
10. ``mx.sym.maximum``, ``minimum`` and ``pow`` (symbol x symbol, symbol
   x scalar in either order, two numbers);
11. ``EvalMetric(name, num=)``: per-output sums and names;
12. ``Module`` and ``BucketingModule`` taking ``work_load_list``;
13. ``InferenceServer.start``, whose second start raises;
14. ``parallel.distributed.barrier(name)``, ``all_reduce_np`` and
   ``broadcast_np`` in a one-worker world, and ``fused_step.enabled()``.

Forward values within rtol 1e-5 / atol 1e-6, gradients rtol 1e-4; item
9's forward exactly, its gradient as stated there."""
import io
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.predictor  # noqa: F401  (jmx.predictor)
import mxnet_tpu.serving  # noqa: F401  (jmx.serving)
import mxnet_tpu_torch as tmx
from test_torch_common import fresh_names, run_jax, run_torch


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


# -- item 9: ROIPooling in the data's dtype -----------------------------------
def _roi_case():
    """A seeded map (2, 4, 37, 62) and 16 rois up to x = 1000, pooled 7x7
    at scale 1/16 (conv5 of a 600x1000 image)."""
    rng = np.random.RandomState(0)
    data = rng.randn(2, 4, 37, 62).astype(np.float32)
    n = 16
    x1, y1 = rng.uniform(0, 1000, n), rng.uniform(0, 600, n)
    rois = np.stack([rng.randint(0, 2, n), x1, y1,
                     x1 + rng.uniform(0, 300, n),
                     y1 + rng.uniform(0, 200, n)], 1).astype(np.float32)
    g = rng.randn(n, 4, 7, 7).astype(np.float32)
    return data, rois, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_roipooling_in_the_data_dtype_matches_jax(dtype):
    """Both packages' ROIPooling.apply on the same values in ``dtype``:
    the forward equal bit for bit (a max is exact in any dtype, so equal
    bins give equal values). The gradient: JAX sums each pixel's terms
    g / count in ``dtype``, the port (the plain version here; the kernel
    on the card) sums them with other roundings, so they agree within
    8 units of ``dtype``'s epsilon of the sum of the terms' magnitudes at
    each pixel (that sum is the gradient for the cotangent |g|)."""
    import jax
    import jax.numpy as jnp
    import torch
    from mxnet_tpu.ops.vision import ROIPooling as JaxROIPooling
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.vision import ROIPooling

    data, rois, g = _roi_case()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    params = dict(pooled_size=(7, 7), spatial_scale=1.0 / 16)
    jop = JaxROIPooling(**params)
    jout, vjp = jax.vjp(
        lambda d: jop.apply(None, [d, jnp.asarray(rois).astype(jd)],
                            [])[0][0], jnp.asarray(data).astype(jd))
    (jdx,) = vjp(jnp.asarray(g).astype(jd))
    x = torch.from_numpy(data).to(td).requires_grad_()
    out = ROIPooling(**params).apply(
        None, [x, torch.from_numpy(rois).to(td)], [])[0][0]
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(g).to(td))
    assert out.dtype == dx.dtype == td
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    abs_sum = kernels.roi_pool_plain_grad(
        x.detach(), torch.from_numpy(rois), torch.from_numpy(g).to(td).abs(),
        (7, 7), 1.0 / 16).double().numpy()
    err = np.abs(dx.double().numpy()
                 - np.asarray(jdx.astype(jnp.float32), np.float64))
    eps = float(torch.finfo(td).eps)
    assert (err <= 8 * eps * abs_sum).all(), float(
        (err / np.maximum(abs_sum, 1e-30)).max() / eps)


# ---------------------------------------------------------------------------
# items 10-13
# ---------------------------------------------------------------------------
def _minmax_pow(pkg):
    with fresh_names(pkg):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        return pkg.sym.Group([
            pkg.sym.maximum(a, b), pkg.sym.minimum(a, b),
            pkg.sym.maximum(a, 0.25), pkg.sym.maximum(0.25, b),
            pkg.sym.minimum(a, 1.0), pkg.sym.minimum(-0.5, b),
            pkg.sym.pow(a, 2.0), pkg.sym.pow(2.0, b), pkg.sym.pow(a, b),
            pkg.sym.maximum(a, b) + pkg.sym.minimum(a, 1.0)
            + pkg.sym.pow(2.0, a)])


def test_symbol_maximum_minimum_pow_match_jax():
    """Item 10: every mix of symbols and scalars gives the reference's
    values (``a`` positive, for ``pow(a, b)``), its JSON loads in the
    port, and two numbers give the plain number."""
    rng = np.random.RandomState(10)
    args = {"a": rng.uniform(0.1, 2.0, (3, 4)).astype(np.float32),
            "b": rng.randn(3, 4).astype(np.float32)}
    want = run_jax(_minmax_pow(jmx), args)
    got = run_torch(_minmax_pow(tmx), args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    loaded = run_torch(tmx.sym.load_json(_minmax_pow(jmx).tojson()), args)
    for g, w in zip(loaded, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for lhs, rhs in ((2, 3), (3.5, -1.0), (2.0, 3)):
        for fn in ("maximum", "minimum", "pow"):
            assert getattr(tmx.sym, fn)(lhs, rhs) == \
                getattr(jmx.sym, fn)(lhs, rhs)


def _per_output_metric(pkg):
    class TwoOutputs(pkg.metric.EvalMetric):
        def __init__(self):
            super().__init__("two", num=2)

        def update(self, labels, preds):
            for i, (label, pred) in enumerate(zip(labels, preds)):
                lab = label.asnumpy().ravel()
                hit = pred.asnumpy().argmax(axis=1) == lab
                self.sum_metric[i] += float(hit.sum())
                self.num_inst[i] += lab.size

    return TwoOutputs()


def test_eval_metric_num_matches_jax():
    """Item 11: ``num`` keeps one sum and count an output; ``get`` names
    them ``<name>_<i>``, ``reset`` zeroes the lists, and an output with
    no instance reads nan in both."""
    rng = np.random.RandomState(11)
    labels = [rng.randint(0, 3, 6).astype(np.float32) for _ in range(2)]
    preds = [rng.rand(6, 3).astype(np.float32) for _ in range(2)]
    got, want = _per_output_metric(tmx), _per_output_metric(jmx)
    assert got.get()[0] == want.get()[0] == ["two_0", "two_1"]
    assert all(np.isnan(v) for v in got.get()[1] + want.get()[1])
    for m, pkg in ((got, tmx), (want, jmx)):
        m.update([pkg.nd.array(v, ctx=pkg.cpu()) for v in labels],
                 [pkg.nd.array(v, ctx=pkg.cpu()) for v in preds])
    assert got.get() == want.get()
    assert got.get_name_value() == want.get_name_value()
    got.reset()
    want.reset()
    assert (got.sum_metric, got.num_inst) == (want.sum_metric,
                                              want.num_inst) == \
        ([0.0, 0.0], [0, 0])


def test_modules_take_work_load_list_as_the_reference_does():
    """Item 12: ``work_load_list`` is accepted by Module (positionally
    after ``context``, as in the reference) and BucketingModule, kept,
    and changes nothing with one context: a forward equals the one
    without it."""
    x = np.random.RandomState(12).randn(2, 5).astype(np.float32)
    outs = []
    for wl in (None, [1]):
        mod = tmx.mod.Module(_mlp(tmx), ("data",), ("softmax_label",),
                             logging, tmx.cpu(), wl)
        ref = jmx.mod.Module(_mlp(jmx), ("data",), ("softmax_label",),
                             logging, jmx.cpu(), wl)
        assert mod._work_load_list == ref._work_load_list == wl
        mod.bind([("data", x.shape)], for_training=False)
        mod.init_params(tmx.init.Constant(0.1))
        mod.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())], []),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    bm = tmx.mod.BucketingModule(lambda key: _mlp(tmx),
                                 default_bucket_key=5,
                                 context=tmx.cpu(), work_load_list=[1])
    bm.bind([("data", x.shape)], for_training=False)
    assert bm._curr_module._work_load_list == [1]
    jbm = jmx.mod.BucketingModule(lambda key: _mlp(jmx),
                                  default_bucket_key=5,
                                  context=jmx.cpu(), work_load_list=[1])
    assert jbm._work_load_list == bm._work_load_list


def test_inference_server_start_is_the_double_start_guard():
    """Item 13: the server serves from construction; ``start`` delegates
    to the scheduler, whose guard raises on the second start in both
    packages, and the server still serves afterwards."""
    def server(pkg):
        s = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                   name="fc")
        mod = pkg.mod.Module(s, label_names=(), context=pkg.cpu())
        mod.bind([("data", (4, 3))], for_training=False)
        mod.set_params({"fc_weight": pkg.nd.zeros((4, 3), ctx=pkg.cpu()),
                        "fc_bias": pkg.nd.array([0, 2, 2, 1],
                                                ctx=pkg.cpu())}, {})
        return pkg.serving.InferenceServer(mod, top_k=1, max_batch=4)

    for pkg in (jmx, tmx):
        with server(pkg) as srv:
            with pytest.raises(pkg.MXNetError, match="already started"):
                srv.start()
            (idx,) = srv.infer([np.ones((2, 3), np.float32)])
            assert list(idx) == [1, 1]


def _no_launcher(monkeypatch):
    for k in ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_distributed_host_helpers_match_jax_in_one_worker(monkeypatch):
    """Item 14: ``barrier`` takes the reference's name, and the host numpy
    sum and broadcast over a one-worker world return the array itself,
    in both packages."""
    import mxnet_tpu.parallel.distributed as jdist
    import mxnet_tpu_torch.parallel.distributed as tdist

    _no_launcher(monkeypatch)
    arr = np.arange(3.0)
    for pkg in (jdist, tdist):
        assert pkg.num_workers() == 1
        assert pkg.barrier() is None
        assert pkg.barrier("x") is None
        assert pkg.barrier(name="step_3") is None
        got = pkg.all_reduce_np(arr)
        assert got is arr
        np.testing.assert_array_equal(got, [0.0, 1.0, 2.0])
        assert pkg.broadcast_np(arr) is arr
        assert pkg.broadcast_np(arr, root=0) is arr


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_fused_step_enabled_reads_the_variable_as_jax(monkeypatch, value):
    """Item 14: ``fused_step.enabled()`` reads ``MXNET_TPU_FUSED_STEP``
    through the registry, as the reference's."""
    import mxnet_tpu.fused_step as jfused
    import mxnet_tpu_torch.fused_step as tfused

    if value is None:
        monkeypatch.delenv("MXNET_TPU_FUSED_STEP", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_FUSED_STEP", value)
    assert tfused.enabled() == jfused.enabled() == (value == "1")
