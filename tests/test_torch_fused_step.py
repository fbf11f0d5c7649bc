"""The fused train step of the port on the CPU (the same step function
the card captures as a CUDA graph, run eagerly): bit for bit against the
port's classic loop, against the JAX package's ``FusedTrainStep`` from
params the reference initialised, the on-device metric fold, the
preconditions that raise, Dropout, a step a fit, and the count of a
replay's launches from a profiler's kernel events."""
import logging
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.fused_step import make_fused_step
from mxnet_tpu_torch.ops import kernels

from test_torch_common import fresh_names, small_resnet

BATCH = 8
DIM = 6
CLASSES = 3


def _mlp(pkg, dropout=0.0):
    """The reference fused-step test's MLP (tests/test_fused_step.py)."""
    with fresh_names(pkg):
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        if dropout:
            net = pkg.sym.Dropout(net, p=dropout)
        net = pkg.sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _synthetic(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, DIM).astype(np.float32)
    y = x.dot(rng.randn(DIM, CLASSES)).argmax(axis=1).astype(np.float32)
    return x, y


def _seed_params(net, seed=3):
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, DIM),
                                       softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*shape) * 0.1).astype(np.float32)
            for name, shape in zip(net.list_arguments(), arg_shapes)
            if name not in ("data", "softmax_label")}


def _port_fit(net, x, y, fused, optimizer_params, num_epoch=1,
              eval_metric="acc", batch_end_callback=None, arg_params=None,
              aux_params=None, batch=BATCH):
    ctx = tmx.cpu()
    mod = tmx.mod.Module(net, context=ctx, logger=logging)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=num_epoch,
            arg_params={k: tmx.nd.array(v, ctx=ctx)
                        for k, v in (arg_params or _seed_params(net)).items()},
            aux_params=None if aux_params is None else {
                k: tmx.nd.array(v, ctx=ctx) for k, v in aux_params.items()},
            initializer=None, optimizer_params=optimizer_params,
            eval_metric=eval_metric, batch_end_callback=batch_end_callback,
            fused_step=fused)
    assert mod._fused_step_active == fused
    return mod


def _host_params(mod):
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _momentum():
    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def _clip_and_schedule():
    return {"learning_rate": 0.05, "momentum": 0.9, "clip_gradient": 0.5,
            "lr_scheduler": tmx.lr_scheduler.FactorScheduler(step=3,
                                                             factor=0.5)}


@pytest.mark.parametrize("nbatches,num_epoch,params", [
    (5, 2, _momentum), (10, 1, _clip_and_schedule)],
    ids=["momentum_2_epochs", "clip_and_factor_scheduler"])
def test_fused_equals_classic_bit_for_bit(nbatches, num_epoch, params):
    """K fused steps equal K classic steps of the port bit for bit
    (tests/test_fused_step.py:101-135's two cases): every step ran the
    step function eagerly, none was captured on the CPU, and the
    hyperparameter tensor stayed one tensor under the schedule."""
    net = _mlp(tmx)
    x, y = _synthetic(BATCH * nbatches)
    classic = _port_fit(net, x, y, False, params(), num_epoch)
    fused = _port_fit(net, x, y, True, params(), num_epoch)
    step = fused._fused_step
    assert (step.eager_steps, step.captures, step.dispatches) == \
        (nbatches * num_epoch, 0, 0)
    assert len(fused._optimizer._scalars) == 1
    a, b = _host_params(classic)[0], _host_params(fused)[0]
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), \
            "%s: max |d| %g" % (k, np.abs(a[k] - b[k]).max())


def _losses(y, batch, out):
    def record(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = y[param.nbatch * batch:(param.nbatch + 1) * batch]
        out.append(-np.log(probs.astype(np.float64)[
            np.arange(batch), lab.astype(int)]).mean())
    return record


def _jax_fused_fit(monkeypatch, net, x, y, args, aux, optimizer_params,
                   batch):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    losses = []
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.fit(jmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
            initializer=None, optimizer="sgd",
            optimizer_params=optimizer_params,
            batch_end_callback=_losses(y, batch, losses))
    assert mod._fused_step_active
    a, x_ = mod.get_params()
    return (np.array(losses), {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x_.items()})


def _assert_follows(got, ref):
    """Losses within rtol 1e-4; params and aux within rtol 1e-3 / atol
    1e-5 (test_torch_train.py::test_fit_matches_jax's bounds)."""
    assert len(got[0]) == len(ref[0]) and np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    for mine, theirs in ((got[1], ref[1]), (got[2], ref[2])):
        assert mine.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_fused_step_follows_jax_fused_step_mlp(monkeypatch):
    """The MLP through both packages' fused steps, 6 momentum-SGD steps
    from the same params and data order."""
    x, y = _synthetic(BATCH * 6)
    args = _seed_params(_mlp(tmx))
    ref = _jax_fused_fit(monkeypatch, _mlp(jmx), x, y, args, {},
                         _momentum(), BATCH)
    losses = []
    mod = _port_fit(_mlp(tmx), x, y, True, _momentum(), arg_params=args,
                    batch_end_callback=_losses(y, BATCH, losses))
    _assert_follows((np.array(losses),) + _host_params(mod), ref)


def test_fused_step_follows_jax_fused_step_small_resnet(monkeypatch):
    """The small NHWC ResNet (K3, K4 and K5 through their plain
    versions) through both fused steps for 3 steps, conditioned as
    test_torch_train.py::test_fit_matches_jax is (JAX seed 1, the
    blocks' last BatchNorm gamma 0.25, lr 0.01)."""
    from test_torch_train import JAX_SEED, OPT, RESIDUAL_GAMMA

    batch, steps, hw = 4, 3, 32
    shape = (batch, hw, hw, 3)
    jmx.random.seed(JAX_SEED)
    jsym = small_resnet(jmx)
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", shape)], for_training=False)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    a0, x0 = ({k: v.asnumpy() for k, v in p.items()}
              for p in jmod.get_params())
    for k in a0:
        if k.endswith("_b3_bn_gamma"):
            a0[k] = np.full_like(a0[k], RESIDUAL_GAMMA)
    rng = np.random.RandomState(9)
    x = rng.randn(steps * batch, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, 10, steps * batch).astype(np.float32)
    ref = _jax_fused_fit(monkeypatch, jsym, x, y, a0, x0, dict(OPT), batch)
    losses = []
    mod = _port_fit(small_resnet(tmx), x, y, True, dict(OPT), arg_params=a0,
                    aux_params=x0, batch=batch,
                    batch_end_callback=_losses(y, batch, losses))
    got = (np.array(losses),) + _host_params(mod)
    _assert_follows(got, ref)
    assert all(not np.array_equal(got[1][k], a0[k]) for k in a0)


class _MaxProb(tmx.metric.EvalMetric):
    """A metric without a device fold: the fused step updates it on the
    host from the step's outputs."""

    def __init__(self):
        super().__init__("max-prob")

    def _batch(self, label, pred):
        return pred.max(dim=1).values.sum(), pred.shape[0]


def test_fused_metric_fold_equals_host_metric():
    """Accuracy, TopK and CrossEntropy folded inside the fused step equal
    the same metrics computed in numpy from each batch's outputs and
    labels (and the classic loop's); a metric without a fold is updated
    on the host from the outputs, equal to the classic loop's."""
    net = _mlp(tmx)
    x, y = _synthetic(BATCH * 4, seed=1)
    host = {"acc": [], "topk": [], "ce": []}

    def numpy_metric(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = y[param.nbatch * BATCH:(param.nbatch + 1) * BATCH].astype(int)
        host["acc"].extend(probs.argmax(1) == lab)
        top2 = np.argsort(probs, axis=1)[:, -2:]
        host["topk"].extend((top2 == lab[:, None]).any(1))
        host["ce"].extend(-np.log(probs[np.arange(BATCH), lab]
                                  .astype(np.float64) + 1e-8))

    values = []
    for fused in (True, False):
        metric = tmx.metric.CompositeEvalMetric(
            [tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(top_k=2),
             tmx.metric.CrossEntropy(), _MaxProb()])
        mod = _port_fit(net, x, y, fused, _momentum(), eval_metric=metric,
                        batch_end_callback=numpy_metric if fused else None)
        if fused:
            assert mod._fused_step._fold is None   # _MaxProb has no fold
        values.append(dict(metric.get_name_value()))
    assert values[0] == values[1]
    got = values[0]
    assert got["accuracy"] == np.mean(host["acc"])
    assert got["top_k_accuracy_2"] == np.mean(host["topk"])
    np.testing.assert_allclose(got["cross-entropy"], np.mean(host["ce"]),
                               rtol=1e-6)

    folded = tmx.metric.create(["acc", "ce"])
    mod = _port_fit(net, x, y, True, _momentum(), eval_metric=folded)
    assert mod._fused_step._fold is not None
    assert folded.metrics[0]._acc is not None
    assert dict(folded.get_name_value()) == {
        k: v for k, v in got.items() if k in ("accuracy", "cross-entropy")}


def _bound_module(net, **bind):
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))],
             **bind)
    mod.init_params(tmx.init.Xavier(seed=0))
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
    return mod


class _CustomSGD(tmx.optimizer.SGD):
    def update_multi(self, items):
        super().update_multi(items)


@pytest.mark.parametrize("case,reason", [
    ("kvstore", "kvstore 'dist_sync'"),
    ("inputs_need_grad", "inputs_need_grad"),
    ("monitor", "monitor"),
    ("grad_req_add", "grad_req"),
    ("optimizer", "_CustomSGD has no fusable update"),
    ("not_initialised", "must be bound for training")])
def test_failed_precondition_raises_naming_its_reason(case, reason):
    net = _mlp(tmx)
    monitor = None
    if case == "inputs_need_grad":
        mod = _bound_module(net, inputs_need_grad=True)
    elif case == "grad_req_add":
        mod = _bound_module(net, grad_req="add")
    elif case == "not_initialised":
        mod = tmx.mod.Module(net, context=tmx.cpu())
        mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    else:
        mod = _bound_module(net)
    if case == "kvstore":
        mod._kvstore = SimpleNamespace(type="dist_sync")
    elif case == "monitor":
        monitor = object()
    elif case == "optimizer":
        mod.init_optimizer(optimizer=_CustomSGD(), force_init=True)
    with pytest.raises(tmx.MXNetError, match=reason):
        make_fused_step(mod, tmx.metric.create("acc"), monitor)


def test_fit_fused_step_raises_instead_of_falling_back():
    """fit(fused_step=True) on a configuration that cannot fuse raises;
    it never carries on through the classic loop."""
    net = _mlp(tmx)
    x, y = _synthetic(BATCH * 2)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="fusable update"):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                optimizer=_CustomSGD(), fused_step=True)
    with pytest.raises(tmx.MXNetError, match="monitor"):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                monitor=object(), fused_step=True, force_rebind=True)


def test_dropout_draws_a_fresh_mask_each_step():
    """A Dropout graph through the fused step: the classic loop's masks
    bit for bit (the executor's generator, seeded alike from the random
    stream), and at lr 0 the same batch twice gives two different
    masks."""
    net = _mlp(tmx, dropout=0.5)
    x, y = _synthetic(BATCH * 3)
    tmx.random.seed(0)
    a = _host_params(_port_fit(net, x, y, False, _momentum()))[0]
    tmx.random.seed(0)
    b = _host_params(_port_fit(net, x, y, True, _momentum()))[0]
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    mod = _bound_module(net)
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.0),),
                       force_init=True)
    metric = tmx.metric.create("acc")
    step = make_fused_step(mod, metric)
    batch = tmx.io.DataBatch([x[:BATCH]], [y[:BATCH]])
    outs = []
    for _ in range(2):
        step.step(batch, metric)
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    assert not np.array_equal(outs[0], outs[1])


def test_each_fit_builds_its_own_step():
    """Two fused fits on one module: each fit builds its own step over
    the bind (on a card, its own eager step and capture), the second
    goes on from the first's params, and the two equal two classic fits
    bit for bit."""
    net = _mlp(tmx)
    x, y = _synthetic(BATCH * 3)
    mods, steps = [], []
    for fused in (False, True):
        mod = _port_fit(net, x, y, fused, _momentum())
        first = mod._fused_step
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                optimizer_params=_momentum(), fused_step=fused)
        mods.append(mod)
        steps.append((first, mod._fused_step))
    first, second = steps[1]
    assert first is not second
    assert (first.eager_steps, second.eager_steps) == (3, 3)
    assert second.captures == second.dispatches == 0
    a, b = _host_params(mods[0])[0], _host_params(mods[1])[0]
    for k in a:
        assert np.array_equal(a[k], b[k]), k


_KERNEL_EVENTS = [
    "void (anonymous namespace)::conv_gemm_kernel<float, 128, false>(float "
    "const*, float const*, float*, int, int, int, int)",
    "(anonymous namespace)::conv_gemm_splitk_reduce_kernel(float const*, "
    "float*, long long, int)",
    "void (anonymous namespace)::norm_act_vec_kernel<(anonymous namespace)"
    "::F32, false, true>(void const*, float const*, float const*, void*, "
    "long long, int)",
    "void (anonymous namespace)::norm_act_scalar_kernel<(anonymous "
    "namespace)::F32, true, false>(void const*)",
    "void (anonymous namespace)::norm_act_bwd_partial_kernel<(anonymous "
    "namespace)::F32, false>(void const*, float const*)",
    "(anonymous namespace)::norm_act_bwd_reduce_kernel(float const*, "
    "float*, float*, int, int)",
    "void (anonymous namespace)::linear_kernel<64, 4, 2>(float const*)",
    "void at::native::upsample_bilinear_kernel<float>(int, float*)",
    "void (anonymous namespace)::flash_attn_kernel<128>((anonymous "
    "namespace)::Args)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float> >(int)",
]


@pytest.mark.parametrize("wrapper,want", [
    ("conv_gemm", 1), ("norm_act_fwd", 2), ("norm_act_bwd", 1),
    ("linear", 1), ("flash_attn", 1)])
def test_launches_in_counts_each_wrappers_first_kernel(wrapper, want):
    """A replay's launches are counted from the profiler's kernel events:
    each wrapper's launch is its first kernel (K3's and K5's reduce
    kernels, other kernels whose names contain a launch kernel's name,
    and PyTorch's own kernels count nothing), and every name that
    LAUNCH_KERNELS gives is a __global__ kernel of the wrapper's source."""
    counts = kernels.launches_in(_KERNEL_EVENTS * 3)
    assert counts[wrapper] == 3 * want
    assert sum(counts.values()) == 3 * 6
    source = {"conv_gemm": "conv_gemm", "norm_act_fwd": "norm_act",
              "norm_act_bwd": "norm_act", "linear": "linear",
              "flash_attn": "flash_attn"}[wrapper]
    path = os.path.join(os.path.dirname(tmx.__file__), "csrc",
                        source + ".cu")
    with open(path) as f:
        text = re.sub(r"\s+", " ", f.read())
    for name in kernels.LAUNCH_KERNELS[wrapper]:
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)+ )?"
                         r"%s\(" % name, text), name


def test_sgd_reads_its_hyperparameters_from_one_tensor():
    """A learning rate change reaches the update through the values of
    one fixed tensor, one row a group of parameters sharing multipliers:
    the update with lr 0 leaves the weights alone, then moves them."""
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, sym=net,
                               param_idx2name={0: "fc_weight",
                                               1: "fc_bias"})
    opt.set_lr_mult({"fc_bias": 2.0})
    upd = tmx.optimizer.get_updater(opt)
    ctx = tmx.cpu()
    w = tmx.nd.array(np.ones((2, 3), np.float32), ctx=ctx)
    b = tmx.nd.array(np.ones(2, np.float32), ctx=ctx)
    g = [tmx.nd.array(np.ones((2, 3), np.float32), ctx=ctx),
         tmx.nd.array(np.ones(2, np.float32), ctx=ctx)]
    upd.update_multi([(0, g[0], w), (1, g[1], b)])
    (h2d,) = opt._scalars.values()
    tensor = h2d.dst
    np.testing.assert_allclose(tensor[:, 1].numpy(), [0.1, 0.2], rtol=1e-7)
    np.testing.assert_allclose(b.asnumpy(), 1 - np.float32(0.2))
    opt.lr = 0.0
    before = w.asnumpy().copy()
    upd.update_multi([(0, g[0], w), (1, g[1], b)])
    assert opt._scalars[next(iter(opt._scalars))].dst is tensor
    np.testing.assert_array_equal(w.asnumpy(), before)
    assert opt.structure([0, 1]) == (((0,), (1,)), False, False)
