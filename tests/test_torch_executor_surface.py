"""The port's executor surface against the JAX package's (CPU): ``bind``
and ``simple_bind`` with ``group2ctx``, ``shared_exec`` and keyword
arguments; placement by ``ctx_group``; ``compute_dtype`` and
``MXNET_COMPUTE_DTYPE`` raising (mixed precision waits for its own
slice); ``DataParallelExecutorManager`` over two CPU contexts;
``print_summary`` and ``plot_network``; ``symbol_doc``'s doctests;
``libinfo.find_lib_path``; and the URI filesystem under ``nd``,
``Symbol``, ``checkpoint`` and ``recordio``. Outputs rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-6."""
import doctest
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.executor_manager  # noqa: F401
import mxnet_tpu.visualization  # noqa: F401
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _build, executor as texecutor, libinfo
from test_torch_common import ckpt_data, fresh_names
from test_torch_vision_ops import rcnn_symbol


def _mp_net(pkg):
    """The JAX package's test_model_parallel net: fc1/relu in group
    dev1, fc2/softmax in group dev2."""
    s = pkg.sym
    with fresh_names(pkg):
        with pkg.AttrScope(ctx_group="dev1"):
            fc1 = s.FullyConnected(s.Variable("data"), num_hidden=8,
                                   name="fc1")
            act1 = s.Activation(fc1, act_type="relu")
        with pkg.AttrScope(ctx_group="dev2"):
            fc2 = s.FullyConnected(act1, num_hidden=4, name="fc2")
            return s.SoftmaxOutput(fc2, name="softmax")


def _mp_run(pkg, group2ctx, shared_exec=None):
    net = _mp_net(pkg)
    rng = np.random.RandomState(0)
    shapes, _, _ = net.infer_shape(data=(6, 10), softmax_label=(6,))
    kw = {"ctx": pkg.cpu()} if pkg is tmx else {}
    args, grads = {}, {}
    for name, shape in zip(net.list_arguments(), shapes):
        args[name] = pkg.nd.array(rng.randn(*shape).astype(np.float32) * 0.3,
                                  **kw)
        grads[name] = pkg.nd.zeros(shape, **kw)
    args["softmax_label"][:] = np.array([0, 1, 2, 3, 0, 1], np.float32)
    ex = net.bind(pkg.cpu(), args, args_grad=grads,
                  grad_req={n: ("null" if n == "softmax_label" else "write")
                            for n in args},
                  group2ctx=group2ctx, shared_exec=shared_exec)
    ex.forward(is_train=True)
    out = ex.outputs[0].asnumpy().copy()
    ex.backward()
    return out, {n: a.asnumpy().copy() for n, a in ex.grad_dict.items()}, ex


def _same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_group2ctx_matches_single_device_and_jax():
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    single = _mp_run(tmx, None)
    placed = _mp_run(tmx, g2c, shared_exec=single[2])
    _same(placed, single)
    _same(placed, _mp_run(jmx, {"dev1": jmx.cpu(0), "dev2": jmx.cpu(1)}))
    # reshape keeps the placement
    assert placed[2].reshape(data=(3, 10), softmax_label=(3,)) \
        ._group2ctx == g2c


def test_ctx_group_places_each_node_on_its_group():
    net = _mp_net(tmx)
    seen = {}

    def node_device(n):
        seen[n.name] = n.attrs.get("ctx_group")
        return None

    eval_graph, _ = texecutor.make_graph_eval(net, node_device)
    rng = np.random.RandomState(1)
    shapes, _, _ = net.infer_shape(data=(2, 10), softmax_label=(2,))
    outs, _ = eval_graph([torch.from_numpy(rng.randn(*s).astype(np.float32))
                          for s in shapes], [], None, False)
    assert outs[0].shape == (2, 4)
    assert seen == {"fc1": "dev1", "activation0": "dev1", "fc2": "dev2",
                    "softmax": "dev2"}


def test_simple_bind_takes_group2ctx_and_shared_exec():
    net = _mp_net(tmx)
    ex = net.simple_bind(tmx.cpu(), data=(4, 10),
                         group2ctx={"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)})
    ex2 = net.simple_bind(tmx.cpu(), data=(4, 10), shared_exec=ex)
    assert ex.forward()[0].shape == ex2.forward()[0].shape == (4, 4)


def test_compute_dtype_raises_naming_the_slice(monkeypatch):
    """Mixed precision is ported: a bad dtype name raises naming the
    setting, bfloat16 binds (by keyword, by the variable, through
    Module) with float32 outputs, and an explicit None overrides the
    variable."""
    net = _mp_net(tmx)
    monkeypatch.delenv("MXNET_COMPUTE_DTYPE", raising=False)
    args = net.simple_bind(tmx.cpu(), data=(4, 10)).arg_dict
    with pytest.raises(tmx.MXNetError, match="MXNET_COMPUTE_DTYPE"):
        net.bind(tmx.cpu(), args, compute_dtype="bf16")
    ex16 = net.bind(tmx.cpu(), args, compute_dtype="bfloat16")
    assert ex16.compute_dtype == torch.bfloat16
    assert ex16.forward()[0].handle.dtype == torch.float32
    net.bind(tmx.cpu(), args, compute_dtype=None)
    with pytest.raises(TypeError):
        net.bind(tmx.cpu(), args, no_such_keyword=1)
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    assert net.simple_bind(tmx.cpu(), data=(4, 10)).compute_dtype \
        == torch.bfloat16
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    assert mod._exec_group.executor.compute_dtype == torch.bfloat16
    # an explicit None overrides the variable
    ex = net.bind(tmx.cpu(), args, compute_dtype=None)
    assert ex.compute_dtype is None
    assert ex.forward()[0].shape == (4, 4)
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "float8")
    with pytest.raises(tmx.MXNetError, match="MXNET_COMPUTE_DTYPE"):
        net.simple_bind(tmx.cpu(), data=(4, 10))


def _mgr_net(pkg):
    with fresh_names(pkg):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                     name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mgr_train(pkg, ctx):
    x, y = ckpt_data(4)
    it = pkg.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    net = _mgr_net(pkg)
    params = [n for n in net.list_arguments()
              if n not in ("data", "softmax_label")]
    mgr = pkg.executor_manager.DataParallelExecutorManager(
        net, ctx, it, param_names=params)
    rng = np.random.RandomState(1)
    shapes, _, _ = net.infer_shape(data=(8, 6))
    kw = {"ctx": pkg.cpu()} if pkg is tmx else {}
    mgr.set_params({n: pkg.nd.array((rng.randn(*s) * 0.1).astype(np.float32),
                                    **kw)
                    for n, s in zip(net.list_arguments(), shapes)
                    if n in params}, {})
    for _ in range(2):
        it.reset()
        for batch in it:
            mgr.load_data_batch(batch)
            mgr.forward(is_train=True)
            mgr.backward()
            for block, grads in zip(mgr.param_arrays, mgr.grad_arrays):
                for w, g in zip(block, grads):
                    w[:] = w.asnumpy() - 0.05 * g.asnumpy()
    assert mgr.curr_execgrp is mgr.execgrp
    out = mgr.get_outputs()[0].asnumpy().copy()
    return out, {n: b[0].asnumpy().copy()
                 for n, b in zip(mgr.param_names, mgr.param_arrays)}


def test_executor_manager_over_two_cpu_contexts_matches_jax():
    got = _mgr_train(tmx, [tmx.cpu(0), tmx.cpu(1)])
    want = _mgr_train(jmx, [jmx.cpu(0), jmx.cpu(1)])
    _same(got, want)
    _same(_mgr_train(tmx, tmx.cpu()), got)
    for args in ([10, [1.0, 1.0]], [9, [2.0, 1.0]], [7, [1, 1, 1]]):
        assert tmx.executor_manager._split_input_slice(*args) == \
            jmx.executor_manager._split_input_slice(*args)
    with pytest.raises(tmx.DeviceUnavailableError):
        _mgr_train(tmx, [tmx.gpu(0), tmx.gpu(1)])


@pytest.mark.parametrize("with_shape", [True, False])
def test_print_summary_text_equals_jax(with_shape, capsys):
    shapes = {"data": (2, 3, 16, 24), "rois": (16, 5)} if with_shape \
        else None
    want = jmx.visualization.print_summary(rcnn_symbol(jmx), shapes)
    got = tmx.viz.print_summary(rcnn_symbol(tmx), shapes)
    assert got == want
    assert "roi_pool5(ROIPooling)" in got
    assert capsys.readouterr().out.count("Total params") == 2


def test_plot_network_equals_jax_and_raises_without_graphviz(monkeypatch):
    pytest.importorskip("graphviz")
    want = jmx.visualization.plot_network(_mgr_net(jmx), title="net")
    got = tmx.viz.plot_network(_mgr_net(tmx), title="net")
    assert got.source == want.source
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(tmx.MXNetError, match="graphviz"):
        tmx.viz.plot_network(_mgr_net(tmx))


def test_symbol_doc_examples_run():
    from mxnet_tpu_torch import symbol_doc

    res = doctest.testmod(symbol_doc, raise_on_error=False)
    assert res.attempted > 10 and res.failed == 0


def test_find_lib_path_lists_the_built_kernel_libraries(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert libinfo.find_lib_path() == []
    path = _build.library_path("roi_pool")
    open(path, "wb").close()
    assert libinfo.find_lib_path() == [path]


def _arrays(pkg):
    kw = {"ctx": pkg.cpu()} if pkg is tmx else {}
    rng = np.random.RandomState(2)
    return {"w": pkg.nd.array(rng.randn(3, 4).astype(np.float32), **kw),
            "b": pkg.nd.array(np.arange(5, dtype=np.float32), **kw)}


def test_mem_uri_for_nd_symbol_checkpoint_and_recordio():
    fs = tmx.filesystem
    tmx.nd.save("mem://t/params.nd", _arrays(tmx))
    jmx.nd.save("mem://t/params.nd", _arrays(jmx))
    assert fs._SCHEMES["mem"]._store["t/params.nd"] == \
        jmx.filesystem._SCHEMES["mem"]._store["t/params.nd"]
    back = tmx.nd.load("mem://t/params.nd", ctx=tmx.cpu())
    for k, v in _arrays(tmx).items():
        assert np.array_equal(back[k].asnumpy(), v.asnumpy())
    # symbol
    net = rcnn_symbol(tmx)
    net.save("mem://t/net.json")
    assert tmx.sym.load("mem://t/net.json").tojson() == net.tojson()
    # checkpoint's atomic writer passes a URI to its handler
    tmx.checkpoint.atomic_ndarray_save("mem://t/ckpt.nd", _arrays(tmx))
    assert fs._SCHEMES["mem"]._store["t/ckpt.nd"] == \
        fs._SCHEMES["mem"]._store["t/params.nd"]
    # recordio, indexed, index and records both in memory
    rec = tmx.recordio.MXIndexedRecordIO("mem://t/r.idx", "mem://t/r.rec",
                                         "w")
    for i in range(3):
        rec.write_idx(i, b"record-%d" % i * (i + 1))
    rec.close()
    rec = tmx.recordio.MXIndexedRecordIO("mem://t/r.idx", "mem://t/r.rec",
                                         "r")
    assert rec.read_idx(2) == b"record-2" * 3
    assert rec.keys == [0, 1, 2]
    rec.close()
    assert fs.exists("mem://t/r.rec") and not fs.exists("mem://t/none")
    with pytest.raises(tmx.MXNetError, match="register_scheme"):
        tmx.nd.save("s3://bucket/x.nd", _arrays(tmx))
    with pytest.raises(tmx.MXNetError, match="unknown URI scheme"):
        tmx.nd.load("nope://x")
    assert fs.scheme_of("C://x") is None and fs.scheme_of("/a/b") is None
    fs._SCHEMES["mem"].clear()
