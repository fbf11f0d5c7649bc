"""The bucketing, sequential and Python modules and ``shared_module``,
held against the JAX package on the CPU from the same seeded params:

* BucketingModule over ``lstm_unroll`` (vocabulary 20, embedding 6,
  hidden 8, 2 layers, batch 4) with buckets [3, 5]: three classic steps
  (buckets 3, 5, 3), SGD with momentum, the initial states fed as data;
  outputs within rtol 1e-5 / atol 1e-6 and the params after the steps
  within rtol 1e-4 / atol 1e-6 (three steps of float32 SGD);
* ``fit`` over a bucketed iterator: one module a bucket, one set of
  parameter tensors, and ``fit(fused_step=True)`` refused;
* ``Module.bind(shared_module=...)``: the same tensors, the owner's dirty
  flag (tests/test_module.py::
  test_shared_module_dirty_tracking_routes_to_owner);
* SequentialModule (with auto wiring and a PythonLossModule) for a few
  classic steps: outputs and params within rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)
import mxnet_tpu_torch as tmx
from test_torch_common import fresh_names

V, E, H, L, B = 20, 6, 8, 2, 4
INIT_NAMES = ["l%d_init_%s" % (i, k) for i in range(L) for k in "ch"]


def _sym_gen(pkg):
    def sym_gen(seq_len):
        with fresh_names(pkg):
            net = pkg.models.lstm_unroll(L, seq_len, V, H, E, V)
        return net, tuple(["data"] + INIT_NAMES), ("softmax_label",)
    return sym_gen


def _lm_params(seq_len=5, seed=0):
    net, _, _ = _sym_gen(tmx)(seq_len)
    shapes = dict(data=(B, seq_len), softmax_label=(B, seq_len),
                  **{n: (B, H) for n in INIT_NAMES})
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes}


def _bucket_batch(pkg, ctx, rng, seq_len):
    x = rng.randint(0, V, (B, seq_len)).astype(np.float32)
    y = rng.randint(0, V, (B, seq_len)).astype(np.float32)
    data = [pkg.nd.array(x, ctx=ctx)] + [pkg.nd.zeros((B, H), ctx=ctx)
                                         for _ in INIT_NAMES]
    descs = [pkg.io.DataDesc("data", (B, seq_len))] + [
        pkg.io.DataDesc(n, (B, H)) for n in INIT_NAMES]
    return pkg.io.DataBatch(
        data, [pkg.nd.array(y, ctx=ctx)], bucket_key=seq_len,
        provide_data=descs,
        provide_label=[pkg.io.DataDesc("softmax_label", (B, seq_len))])


def _bucketing_module(pkg, params, default=5):
    ctx = pkg.cpu()
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=default,
                                  context=ctx)
    mod.bind([("data", (B, default))] + [(n, (B, H)) for n in INIT_NAMES],
             [("softmax_label", (B, default))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5})
    return mod


def test_bucketing_module_three_steps_match_jax():
    params = _lm_params()
    got = {}
    for pkg in (tmx, jmx):
        mod = _bucketing_module(pkg, params)
        rng = np.random.RandomState(1)
        outs = []
        for seq_len in (3, 5, 3):
            mod.forward_backward(_bucket_batch(pkg, pkg.cpu(), rng, seq_len))
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy().copy())
        assert sorted(mod._buckets) == [3, 5]
        got[pkg] = (outs, {k: v.asnumpy().copy()
                           for k, v in mod.get_params()[0].items()})
    for a, b in zip(got[tmx][0], got[jmx][0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert sorted(got[tmx][1]) == sorted(got[jmx][1])
    for k, want in got[jmx][1].items():
        assert not np.array_equal(want, params[k]), k
        np.testing.assert_allclose(got[tmx][1][k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


class _BucketIter(tmx.io.DataIter):
    """Seeded batches of two buckets, in a fixed order (the port's)."""

    def __init__(self, plan, seed=2):
        super().__init__()
        self.batch_size = B
        self._plan = plan
        self._seed = seed
        self.reset()

    @property
    def provide_data(self):
        return [tmx.io.DataDesc("data", (B, 5))] + [
            tmx.io.DataDesc(n, (B, H)) for n in INIT_NAMES]

    @property
    def provide_label(self):
        return [tmx.io.DataDesc("softmax_label", (B, 5))]

    def reset(self):
        self._rng = np.random.RandomState(self._seed)
        self._cur = 0

    def next(self):
        if self._cur >= len(self._plan):
            raise StopIteration
        self._cur += 1
        return _bucket_batch(tmx, tmx.cpu(), self._rng,
                             self._plan[self._cur - 1])

    __next__ = next


def test_bucketing_fit_shares_one_set_of_tensors_and_refuses_fusion():
    params = _lm_params()
    ctx = tmx.cpu()
    mod = tmx.mod.BucketingModule(_sym_gen(tmx), default_bucket_key=5,
                                  context=ctx)
    losses = []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = param.locals["data_batch"].label[0].asnumpy().T.reshape(-1)
        losses.append(-np.log(probs[np.arange(len(lab)),
                                    lab.astype(int)]).mean())

    mod.fit(_BucketIter([3, 5, 3, 5]), num_epoch=1,
            arg_params={k: tmx.nd.array(v, ctx=ctx)
                        for k, v in params.items()},
            optimizer_params={"learning_rate": 0.1}, eval_metric="acc",
            batch_end_callback=on_batch)
    assert sorted(mod._buckets) == [3, 5]
    owner = mod._buckets[5]._exec_group.executor
    other = mod._buckets[3]._exec_group.executor
    for name in params:
        assert other.arg_dict[name].handle.data_ptr() == \
            owner.arg_dict[name].handle.data_ptr(), name
        assert other.grad_dict[name] is owner.grad_dict[name]
    assert mod._buckets[3]._updater is mod._buckets[5]._updater
    after = mod.get_params()[0]
    assert all(not np.array_equal(after[k].asnumpy(), v)
               for k, v in params.items())
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert mod.symbol is mod._buckets[5].symbol
    assert mod.output_shapes == [("softmax_output", (B * 5, V))]
    with pytest.raises(tmx.MXNetError, match="no fused train step"):
        tmx.mod.BucketingModule(_sym_gen(tmx), default_bucket_key=5,
                                context=ctx).fit(
            _BucketIter([5]), num_epoch=1, fused_step=True)


def _mlp(pkg, classes=3):
    with fresh_names(pkg):
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _synthetic(n=64, dim=10, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = x.dot(rng.randn(dim, classes)).argmax(axis=1).astype(np.float32)
    return x, y


def test_shared_module_dirty_tracking_routes_to_owner():
    """A module bound with shared_module holds the owner's tensors; its
    dirty flag tracks the owner's, and get_params on it after the owner
    trains returns the trained values."""
    x, y = _synthetic()
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    ctx = tmx.cpu()
    owner = tmx.mod.Module(_mlp(tmx), context=ctx)
    owner.bind(it.provide_data, it.provide_label, for_training=True)
    owner.init_params()
    owner.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
    sharer = tmx.mod.Module(_mlp(tmx), context=ctx)
    sharer.bind(it.provide_data, it.provide_label, for_training=True,
                shared_module=owner)
    assert sharer.params_initialized
    assert sharer._params_dirty == owner._params_dirty
    for name in owner._param_names:
        assert sharer._exec_group.executor.arg_dict[name].handle \
            .data_ptr() == owner._exec_group.executor.arg_dict[name] \
            .handle.data_ptr()
    before = {k: v.asnumpy().copy()
              for k, v in owner.get_params()[0].items()}
    owner.forward_backward(next(it))
    owner.update()
    assert owner._params_dirty and sharer._params_dirty
    after = {k: v.asnumpy() for k, v in sharer.get_params()[0].items()}
    assert any(not np.array_equal(before[k], after[k]) for k in before)
    assert not owner._params_dirty and not sharer._params_dirty
    sharer._params_dirty = True
    assert owner._params_dirty
    # a param whose shape differs cannot be shared
    other = tmx.mod.Module(_mlp(tmx, classes=5), context=ctx)
    with pytest.raises(tmx.MXNetError, match="changes shape"):
        other.bind(it.provide_data, [("softmax_label", (16,))],
                   shared_module=owner)
    unbound = tmx.mod.Module(_mlp(tmx), context=ctx)
    with pytest.raises(tmx.MXNetError, match="bound first"):
        tmx.mod.Module(_mlp(tmx), context=ctx).bind(
            it.provide_data, it.provide_label, shared_module=unbound)


def _two_stage(pkg):
    with fresh_names(pkg):
        net1 = pkg.sym.Variable("data")
        net1 = pkg.sym.FullyConnected(net1, num_hidden=8, name="fc1")
        net1 = pkg.sym.Activation(net1, act_type="relu")
        net2 = pkg.sym.Variable("data")
        net2 = pkg.sym.FullyConnected(net2, num_hidden=3, name="fc2")
        net2 = pkg.sym.SoftmaxOutput(net2, name="softmax")
    ctx = pkg.cpu()
    smod = pkg.mod.SequentialModule()
    smod.add(pkg.mod.Module(net1, label_names=[], context=ctx))
    smod.add(pkg.mod.Module(net2, context=ctx), take_labels=True,
             auto_wiring=True)
    return smod


def _seq_params(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, 10) * 0.3, "fc1_bias": rng.randn(8) * 0.1,
            "fc2_weight": rng.randn(3, 8) * 0.3, "fc2_bias": rng.randn(3) * 0.1}


def _run_sequential(pkg, smod, steps=3, with_metric=True):
    x, y = _synthetic(n=20 * steps)
    it = pkg.io.NDArrayIter(x, y, batch_size=20)
    ctx = pkg.cpu()
    smod.bind(it.provide_data, it.provide_label)
    params = {k: pkg.nd.array(v.astype(np.float32), ctx=ctx)
              for k, v in _seq_params().items()}
    smod.init_params(arg_params=params, allow_missing=True)
    smod.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.3})
    outs = []
    metric = pkg.metric.create("acc")
    for batch in it:
        smod.forward_backward(batch)
        smod.update()
        if with_metric:
            smod.update_metric(metric, batch.label)
        outs.append(smod.get_outputs()[0].asnumpy().copy())
    return outs, {k: v.asnumpy().copy()
                  for k, v in smod.get_params()[0].items()}, metric.get()


def _check_runs(t, j):
    for a, b in zip(t[0], j[0]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert sorted(t[1]) == sorted(j[1])
    for k in j[1]:
        np.testing.assert_allclose(t[1][k], j[1][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert t[2] == pytest.approx(j[2], nan_ok=True)


def test_sequential_module_matches_jax():
    t = _run_sequential(tmx, _two_stage(tmx))
    j = _run_sequential(jmx, _two_stage(jmx))
    _check_runs(t, j)
    smod = _two_stage(tmx)
    _run_sequential(tmx, smod, steps=1)
    assert smod.data_names == ["data"]
    assert smod.output_names == ["softmax_output"]
    assert smod.output_shapes == [("softmax_output", (20, 3))]
    assert smod.label_shapes[0].shape == (20,)
    with pytest.raises(tmx.MXNetError, match="unknown meta"):
        tmx.mod.SequentialModule().add(smod, bogus=True)


def _softmax_ce_grad(pkg):
    def grad(scores, labels):
        p = scores.asnumpy()
        lab = labels.asnumpy().astype(int)
        g = p.copy()
        g[np.arange(len(lab)), lab] -= 1.0
        return g
    return grad


def _with_python_loss(pkg):
    """fc1 -> relu -> fc2 -> SoftmaxActivation in a Module, then a
    PythonLossModule whose gradient is softmax - onehot."""
    with fresh_names(pkg):
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=8, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = pkg.sym.SoftmaxActivation(net)
    smod = pkg.mod.SequentialModule()
    smod.add(pkg.mod.Module(net, label_names=[], context=pkg.cpu()))
    smod.add(pkg.mod.PythonLossModule(grad_func=_softmax_ce_grad(pkg)),
             take_labels=True, auto_wiring=True)
    return smod


def test_python_loss_module_matches_jax():
    t = _run_sequential(tmx, _with_python_loss(tmx), with_metric=False)
    j = _run_sequential(jmx, _with_python_loss(jmx), with_metric=False)
    _check_runs(t, j)
    loss = tmx.mod.PythonLossModule()
    loss.bind([tmx.io.DataDesc("data", (4, 3))],
              [tmx.io.DataDesc("softmax_label", (4,))])
    assert loss.output_shapes == [("pyloss_output", (4, 3))]
    assert loss.get_params() == ({}, {})
    with pytest.raises(NotImplementedError):
        loss.backward()
    with pytest.raises(NotImplementedError):    # no metric, as in JAX
        loss.update_metric(tmx.metric.create("acc"), [])
    with pytest.raises(tmx.MXNetError, match="single data"):
        tmx.mod.PythonLossModule(data_names=("a", "b"))
