"""The metrics the port added to mxnet_tpu_torch/metric.py (F1, MAE, MSE,
RMSE, CustomMetric, np_metric, create of a callable) against the JAX
package's on the same seeded numpy batches; the device fold of MAE, MSE
and RMSE against their host update; the regression outputs
(LinearRegressionOutput, LogisticRegressionOutput, MAERegressionOutput)
forward and backward against the JAX package's; and a regression head
through the fused step with the metric folded in the step.

Bounds: metric values within rtol 1e-6 (float32 batch means, summed in
float64 in the port); the ops' outputs and gradients within rtol 1e-6 /
atol 1e-7."""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_common import fresh_names

RTOL = 1e-6


def _batches(kind, n=3, seed=0):
    """(labels, preds) numpy pairs: class labels and probabilities for F1,
    (rows,) labels and (rows, 1) predictions for the regression ones."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "f1":
            p = rng.rand(16, 2).astype(np.float32)
            lab = rng.randint(0, 2, 16).astype(np.float32)
        else:
            p = rng.randn(16, 1).astype(np.float32)
            lab = rng.randn(16).astype(np.float32)
        out.append((lab, p))
    return out


def _value(pkg, metric, batches):
    for lab, p in batches:
        metric.update([pkg.nd.array(lab, ctx=pkg.cpu())],
                      [pkg.nd.array(p, ctx=pkg.cpu())])
    return metric.get()


@pytest.mark.parametrize("name", ["f1", "mae", "mse", "rmse"])
def test_metric_matches_jax(name):
    batches = _batches(name)
    mine = _value(tmx, tmx.metric.create(name), batches)
    theirs = _value(jmx, jmx.metric.create(name), batches)
    assert mine[0] == theirs[0] == name
    np.testing.assert_allclose(mine[1], theirs[1], rtol=RTOL)


def test_composite_and_reset_match_jax():
    batches = _batches("mse")
    names = ["mse", "mae", "rmse"]
    mine, theirs = tmx.metric.create(names), jmx.metric.create(names)
    assert mine.has_device_fold
    a, b = _value(tmx, mine, batches), _value(jmx, theirs, batches)
    assert a[0] == b[0]
    np.testing.assert_allclose(a[1], b[1], rtol=RTOL)
    mine.reset()
    assert all(np.isnan(v) for v in mine.get()[1])


def _feval(label, pred):
    return float(np.abs(label - pred.ravel()).sum()), label.size


@pytest.mark.parametrize("form", ["callable", "custom", "np_metric",
                                  "float_feval"])
def test_custom_metrics_match_jax(form):
    batches = _batches("mae")

    def make(pkg):
        if form == "callable":
            return pkg.metric.create(_feval)
        if form == "custom":
            return pkg.metric.CustomMetric(_feval, name="l1")
        if form == "np_metric":
            return pkg.metric.np_metric(_feval, name="l1np")
        return pkg.metric.create(lambda l, p: float((l - p.ravel()).max()))
    mine, theirs = _value(tmx, make(tmx), batches), \
        _value(jmx, make(jmx), batches)
    assert mine[0] == theirs[0]
    np.testing.assert_allclose(mine[1], theirs[1], rtol=RTOL)


def test_f1_refuses_more_than_two_classes():
    m = tmx.metric.create("f1")
    with pytest.raises(tmx.MXNetError, match="binary"):
        m.update([tmx.nd.array([0, 1, 2], ctx=tmx.cpu())],
                 [tmx.nd.array(np.eye(3), ctx=tmx.cpu())])


@pytest.mark.parametrize("name", ["mae", "mse", "rmse"])
def test_device_fold_equals_the_host_update(name):
    """The fold (what the fused step runs on tensors) gives what update
    gives, pred reshaped to the label's shape."""
    batches = _batches(name)
    host = tmx.metric.create(name)
    _value(tmx, host, batches)
    folded = tmx.metric.create(name)
    assert folded.has_device_fold
    import torch
    for lab, p in batches:
        folded.device_fold([torch.from_numpy(lab)], [torch.from_numpy(p)])
    assert folded._acc is not None
    assert folded.get() == host.get()
    want = {"mae": lambda d: np.abs(d).mean(),
            "mse": lambda d: (d ** 2).mean(),
            "rmse": lambda d: np.sqrt((d ** 2).mean())}[name]
    ref = np.mean([want(lab.astype(np.float64) - p.ravel())
                   for lab, p in batches])
    np.testing.assert_allclose(folded.get()[1], ref, rtol=1e-6)


# -- the regression outputs ---------------------------------------------------
OPS = ["LinearRegressionOutput", "LogisticRegressionOutput",
       "MAERegressionOutput"]


def _regression_net(pkg, op, grad_scale):
    with fresh_names(pkg):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                     name="fc")
        return getattr(pkg.sym, op)(net, name="reg", grad_scale=grad_scale)


def _forward_backward(pkg, op, grad_scale, x, w, b, label):
    net = _regression_net(pkg, op, grad_scale)
    ctx = pkg.cpu()
    args = {"data": pkg.nd.array(x, ctx=ctx), "fc_weight":
            pkg.nd.array(w, ctx=ctx), "fc_bias": pkg.nd.array(b, ctx=ctx),
            "reg_label": pkg.nd.array(label, ctx=ctx)}
    grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()
             if k.startswith("fc_")}
    ex = net.bind(ctx, args, args_grad=grads)
    ex.forward(is_train=True)
    out = ex.outputs[0].asnumpy()
    ex.backward()
    return out, {k: v.asnumpy() for k, v in grads.items()}


@pytest.mark.parametrize("grad_scale", [1.0, 0.5])
@pytest.mark.parametrize("op", OPS)
def test_regression_op_matches_jax(op, grad_scale):
    rng = np.random.RandomState(4)
    x = rng.randn(5, 4).astype(np.float32)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    label = rng.rand(5, 3).astype(np.float32)
    mine = _forward_backward(tmx, op, grad_scale, x, w, b, label)
    theirs = _forward_backward(jmx, op, grad_scale, x, w, b, label)
    np.testing.assert_allclose(mine[0], theirs[0], rtol=RTOL, atol=1e-7)
    for k in theirs[1]:
        np.testing.assert_allclose(mine[1][k], theirs[1][k], rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    assert _regression_net(tmx, op, grad_scale).infer_shape(
        data=(5, 4))[0][-1] == (5, 3)


def test_regression_head_through_the_fused_step():
    """An MLP with LinearRegressionOutput trains through fit(fused_step=
    True) with [mse, mae, rmse] folded inside the step; each value equals
    a host recomputation from the batch outputs, and the classic loop's
    bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.randn(32, 10).astype(np.float32)
    y = (x[:, :1] * 0.5 - x[:, 1:2]).astype(np.float32)

    def net():
        with fresh_names(tmx):
            h = tmx.sym.Activation(tmx.sym.FullyConnected(
                tmx.sym.Variable("data"), num_hidden=16, name="fc1"),
                act_type="relu")
            h = tmx.sym.FullyConnected(h, num_hidden=1, name="fc2")
            return tmx.sym.LinearRegressionOutput(h, name="lro")

    values, per_batch = [], []
    for fused in (False, True):
        outs = []

        def record(param):
            outs.append(param.locals["self"].get_outputs()[0]
                        .asnumpy().copy())

        metric = tmx.metric.create(["mse", "mae", "rmse"])
        mod = tmx.mod.Module(net(), context=tmx.cpu(), logger=logging,
                             label_names=["lro_label"])
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8,
                                   label_name="lro_label"),
                num_epoch=1, eval_metric=metric,
                initializer=tmx.init.Xavier(seed=1),
                optimizer_params={"learning_rate": 0.05},
                batch_end_callback=record, fused_step=fused)
        if fused:
            assert mod._fused_step._fold is metric
        values.append(metric.get()[1])
        per_batch.append(outs)
    assert values[0] == values[1]
    errs = [(y[i * 8:(i + 1) * 8] - o).astype(np.float32)
            for i, o in enumerate(per_batch[1])]
    want = [np.mean([np.float32((e ** 2).mean()) for e in errs]),
            np.mean([np.float32(np.abs(e).mean()) for e in errs]),
            np.mean([np.float32(np.sqrt((e ** 2).mean())) for e in errs])]
    np.testing.assert_allclose(values[1], want, rtol=RTOL)


def test_progress_bar_prints_as_jax(capsys):
    """callback.ProgressBar, the last of the reference's callbacks."""
    from collections import namedtuple

    param = namedtuple("P", "epoch nbatch eval_metric locals")(0, 7, None,
                                                                {})
    printed = []
    for pkg in (tmx, jmx):
        pkg.callback.ProgressBar(total=20, length=30)(param)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] == "[%s%s] 35%%\r" % ("=" * 10,
                                                          "-" * 20)
