"""One process over several contexts (the port's group of replicas)
against the JAX package's mesh-sharded executor on the suite's forced
8-device CPU platform, and against the port on one context: the stores,
BatchNorm's statistics over the global batch, the classic and fused
fits of a small NHWC ResNet under ``device`` and ``device_sync``, the
refusals, the executor manager, FeedForward and checkpoints across
context counts. Every ``cpu(i)`` of the port is torch's one CPU device,
so the replicas run the same walk as on cards, with the cross-card sums
in plain PyTorch.

Bounds: BatchNorm outputs, moving statistics and gradients rtol 1e-6 /
atol 1e-6 (both packages reduce in float32 over the same 16 rows a
channel, in different orders); the fits hold the small-ResNet bound of
``test_torch_train.test_fit_matches_jax`` (losses rtol 1e-4, params and
aux rtol 1e-3 / atol 1e-5, residual gamma 0.25: one-step training of a
random ResNet is chaotic in float32, see there)."""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.executor_manager  # noqa: F401
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx

from test_torch_common import fresh_names, random_params

BATCH = 8                  # the global batch: 2 a context over 4
HW = 16
STEPS = 3
OPT = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 1e-4))
RESIDUAL_GAMMA = 0.25


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _net(pkg):
    with fresh_names(pkg):
        return pkg.models.get_resnet([1, 1], [8, 16, 16], num_classes=10,
                                     small_input=True, layout="NHWC")


def _params():
    args, aux = random_params(_net(tmx), (BATCH, HW, HW, 3), seed=2)
    for k in args:
        if k.endswith("_b3_bn_gamma"):
            args[k] = np.full_like(args[k], RESIDUAL_GAMMA)
    return args, aux


def _data():
    rng = np.random.RandomState(9)
    x = rng.randn(STEPS * BATCH, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, 10, STEPS * BATCH).astype(np.float32)
    return x, y


def _assert_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------
STORES = ["local", "local_update_cpu", "local_allreduce_cpu", "device",
          "tpu_sync", "device_sync", "Device", "my_tpu_store"]


@pytest.mark.parametrize("name", STORES)
def test_create_routes_each_name_as_the_reference(name):
    mine, theirs = tmx.kv.create(name), jmx.kv.create(name)
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.type == theirs.type
    assert mine.fused_step_compatible == theirs.fused_step_compatible
    assert mine.in_jit_gradient_exchange == getattr(
        theirs, "in_jit_gradient_exchange", False)
    if name == "device_sync":
        assert mine.grad_reduce_sharding(None, "p") == \
            theirs.grad_reduce_sharding(None, "p") == "p"


def _no_launcher_no_secret(monkeypatch):
    from mxnet_tpu_torch.parallel import ps

    for k in ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK",
              "MXTPU_PS_SECRET", "MXTPU_PS_SECRET_FILE", "MXTPU_PS_INSECURE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(ps, "_SECRET_CACHE", False)


def test_dist_and_unknown_stores_raise_naming_the_item(monkeypatch):
    """The dist stores are ported (item 10b): without a launcher a
    ``dist`` name is a one-worker ``dist_sync`` world, and ``dist_async``
    refuses to start its parameter server without a frame secret, naming
    the variable; an unknown name raises."""
    _no_launcher_no_secret(monkeypatch)
    for name in ("dist_sync", "dist_sync_all"):
        kv = tmx.kv.create(name)
        assert type(kv).__name__ == "KVStoreDist"
        assert (kv.rank, kv.num_workers) == (0, 1)
    with pytest.raises(tmx.MXNetError, match="MXTPU_PS_SECRET"):
        tmx.kv.create("dist_async")
    with pytest.raises(tmx.MXNetError, match="unknown kvstore"):
        tmx.kv.create("bogus")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["device", "device_sync"])
def test_push_pull_of_per_device_lists_matches_jax(name, n):
    """A key's per-device values summed (the reference's tree order) and
    pulled to every device of the out list; exact in float32."""
    rng = np.random.RandomState(n)
    init = rng.randn(5, 3).astype(np.float32)
    vals = [rng.randn(5, 3).astype(np.float32) for _ in range(n)]
    got = {}
    for pkg in (tmx, jmx):
        kv = pkg.kv.create(name)
        ctxs = _ctxs(pkg, n)
        kv.init(7, pkg.nd.array(init, ctx=ctxs[0]))
        kv.push(7, [pkg.nd.array(v, ctx=c) for v, c in zip(vals, ctxs)])
        outs = [pkg.nd.zeros((5, 3), ctx=c) for c in ctxs]
        kv.pull(7, out=outs)
        got[pkg] = [o.asnumpy() for o in outs]
    for mine, theirs in zip(got[tmx], got[jmx]):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_allclose(got[tmx][0], sum(vals), rtol=1e-6)


# ---------------------------------------------------------------------------
# BatchNorm over the replicas
# ---------------------------------------------------------------------------
def _bn_net(pkg):
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        bn = pkg.sym.BatchNorm(data, axis=-1, fix_gamma=False, eps=1e-5,
                               momentum=0.8, name="bn")
        return pkg.sym.LinearRegressionOutput(bn, name="lro")


def _bn_data():
    rng = np.random.RandomState(4)
    return rng, (rng.randn(BATCH, 2, 3, 5) * 2 + 1).astype(np.float32)


def _bn_step(pkg, ctxs):
    """One train forward and backward of the BatchNorm over ``ctxs``:
    outputs, moving statistics, and the data, gamma and beta gradients."""
    rng, x = _bn_data()
    label = rng.randn(BATCH, 2, 3, 5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    beta = rng.randn(5).astype(np.float32)
    mod = pkg.mod.Module(_bn_net(pkg), label_names=["lro_label"],
                         context=ctxs)
    mod.bind([("data", x.shape)], [("lro_label", label.shape)],
             inputs_need_grad=True)
    mod.init_params(arg_params={"bn_gamma": pkg.nd.array(gamma, ctx=pkg.cpu()),
                                "bn_beta": pkg.nd.array(beta, ctx=pkg.cpu())},
                    aux_params={"bn_moving_mean": pkg.nd.zeros((5,), ctx=pkg.cpu()),
                                "bn_moving_var": pkg.nd.ones((5,), ctx=pkg.cpu())},
                    allow_missing=False)
    batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())], [pkg.nd.array(label, ctx=pkg.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward()
    group = mod._exec_group
    ex = group.executor
    out = {"out": mod.get_outputs()[0].asnumpy(),
           "dx": mod.get_input_grads()[0].asnumpy()}
    out.update({"d" + k: ex.grad_dict[k].asnumpy()
                for k in ("bn_gamma", "bn_beta")})
    out.update({k: a.asnumpy() for k, a in zip(group.aux_names,
                                               ex.aux_arrays)})
    return out


def test_batchnorm_statistics_are_over_the_global_batch():
    want = _bn_step(jmx, _ctxs(jmx, 4))
    four = _bn_step(tmx, _ctxs(tmx, 4))
    one = _bn_step(tmx, [tmx.cpu()])
    _assert_close(four, want, rtol=1e-6, atol=1e-6)
    _assert_close(four, one, rtol=1e-6, atol=1e-6)
    # momentum 0.8 from zero: 0.2 of the global batch's mean, which the
    # first replica's slice alone misses
    x = _bn_data()[1].astype(np.float64)
    np.testing.assert_allclose(four["bn_moving_mean"],
                               0.2 * x.mean(axis=(0, 1, 2)), rtol=1e-5)
    assert not np.allclose(four["bn_moving_mean"],
                           0.2 * x[:2].mean(axis=(0, 1, 2)), rtol=1e-3)


def _softmax_grad(pkg, ctxs, normalization):
    rng = np.random.RandomState(6)
    x = rng.randn(BATCH, 4).astype(np.float32)
    label = np.array([0, 1, -1, 3, 2, -1, -1, 1], np.float32)
    with fresh_names(pkg):
        net = pkg.sym.SoftmaxOutput(pkg.sym.Variable("data"), name="sm",
                                    normalization=normalization,
                                    use_ignore=True, ignore_label=-1)
    mod = pkg.mod.Module(net, label_names=["sm_label"], context=ctxs)
    mod.bind([("data", x.shape)], [("sm_label", label.shape)],
             inputs_need_grad=True)
    mod.init_params()
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())], [pkg.nd.array(label, ctx=pkg.cpu())]),
                is_train=True)
    mod.backward()
    return mod.get_input_grads()[0].asnumpy()


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_softmax_output_normalizes_by_the_global_batch(normalization):
    want = _softmax_grad(jmx, _ctxs(jmx, 4), normalization)
    got = _softmax_grad(tmx, _ctxs(tmx, 4), normalization)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, _softmax_grad(tmx, [tmx.cpu()],
                                                     normalization))


# ---------------------------------------------------------------------------
# the group and the fit
# ---------------------------------------------------------------------------
def _fit(pkg, ctxs, kvstore, fused=None, check_replicas=False):
    """fit for STEPS batches in order: per-step losses (cross-entropy of
    the forward's probabilities), params and aux, as numpy; with
    ``check_replicas`` every replica's params and aux are held equal to
    the first's after every step."""
    x, y = _data()
    args, aux = _params()
    losses, unequal = [], []

    def record(param):
        mod = param.locals["self"]
        probs = mod.get_outputs()[0].asnumpy()
        lab = y[param.nbatch * BATCH:(param.nbatch + 1) * BATCH]
        losses.append(-np.log(probs.astype(np.float64)[
            np.arange(BATCH), lab.astype(int)]).mean())
        if check_replicas:
            execs = mod._exec_group.execs
            for ex in execs[1:]:
                for name, arr in list(ex.arg_dict.items()) + list(
                        ex.aux_dict.items()):
                    if name in ("data", "softmax_label"):
                        continue
                    first = (execs[0].arg_dict[name]
                             if name in execs[0].arg_dict
                             else execs[0].aux_dict[name])
                    if not np.array_equal(arr.asnumpy(), first.asnumpy()):
                        unequal.append((param.nbatch, name))

    mod = pkg.mod.Module(_net(pkg), context=ctxs, logger=logging)
    kw = {} if pkg is jmx else {"fused_step": fused}
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()},
            kvstore=kvstore, optimizer="sgd", optimizer_params=OPT,
            batch_end_callback=record, **kw)
    assert not unequal, unequal[:5]
    a, b = mod.get_params()
    return (np.array(losses), {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in b.items()}), mod


def _hold(got, want):
    assert len(got[0]) == STEPS and np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    _assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)
    _assert_close(got[2], want[2], rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def references():
    """The JAX package's fits over 4 CPU devices (``device``: the classic
    loop; ``device_sync``: its fused step, the store's default) and the
    port's fit on one context at the same global batch."""
    return {"device": _fit(jmx, _ctxs(jmx, 4), "device")[0],
            "device_sync": _fit(jmx, _ctxs(jmx, 4), "device_sync")[0],
            "one": _fit(tmx, [tmx.cpu()], "local", fused=False)[0]}


@pytest.mark.parametrize("kvstore,fused", [("device", False),
                                           ("device", True),
                                           ("device_sync", None),
                                           ("device_sync", False)])
def test_fit_over_four_contexts_matches_jax_and_one_context(
        references, kvstore, fused):
    got, mod = _fit(tmx, _ctxs(tmx, 4), kvstore, fused,
                    check_replicas=True)
    _hold(got, references[kvstore])
    _hold(got, references["one"])
    # device_sync takes the fused step unless told otherwise
    assert mod._fused_step_active == (fused is not False)
    assert len(mod._exec_group.execs) == 4
    assert [len(u.states) for u in mod._updaters] == \
        [len(mod._updaters[0].states)] * 4


def test_device_sync_fused_default_is_gated(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_DEVICE_SYNC_FUSED", "0")
    _, mod = _fit(tmx, _ctxs(tmx, 2), "device_sync")
    assert not mod._fused_step_active


def test_fused_fit_over_contexts_equals_its_classic_fit():
    """The fused step runs the same step function as the classic loop:
    bit-equal over the replicas on the CPU."""
    fused = _fit(tmx, _ctxs(tmx, 4), "device", fused=True)[0]
    classic = _fit(tmx, _ctxs(tmx, 4), "device", fused=False)[0]
    np.testing.assert_array_equal(fused[0], classic[0])
    for a, b in zip(fused[1:], classic[1:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mirrored_and_bfloat16_fits_over_contexts(monkeypatch):
    """The lock-step walk composed with MXNET_BACKWARD_DO_MIRROR (a
    recomputed BatchNorm redoes its cross-card sums, bit-equal to the
    plain walk) and with compute_dtype (bfloat16 mirrored bit-equal to
    bfloat16 plain; bfloat16 against the JAX package is
    test_bfloat16_fit_over_two_contexts_matches_jax_and_one_context)."""
    plain = _fit(tmx, _ctxs(tmx, 2), "device", fused=True)[0]
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    mirrored, mod = _fit(tmx, _ctxs(tmx, 2), "device", fused=True)
    assert all(ex.mirror for ex in mod._exec_group.execs)
    for a, b in zip(mirrored[1:], plain[1:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    half_mirrored, mod = _fit(tmx, _ctxs(tmx, 2), "device", fused=True)
    assert mod._exec_group.execs[1].compute_dtype is not None
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
    half = _fit(tmx, _ctxs(tmx, 2), "device", fused=True)[0]
    np.testing.assert_array_equal(half_mirrored[0], half[0])
    for a, b in zip(half_mirrored[1:], half[1:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mirror_over_cards_is_refused():
    """The mirrored backward over several cards has not run on a card:
    a replica set on cards refuses it (on the CPU it runs, above)."""
    from mxnet_tpu_torch.executor import ReplicatedExecutor
    from mxnet_tpu_torch.replicas import Replicas

    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    try:
        group = _bind(tmx, _ctxs(tmx, 2))._exec_group
    finally:
        mp.undo()
    cards = Replicas(group.replicas.devices)
    cards.cuda = True
    with pytest.raises(tmx.MXNetError, match="mirror over several cards"):
        ReplicatedExecutor(group.execs, cards, [], [], {"data": 0})


def _normwise(got, want, start):
    """The distance between two fits' results as a share of the second
    fit's move from ``start``, over every array at once."""
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum((want[k].astype(np.float64) - start[k]) ** 2))
              for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def bf16_references():
    """Under MXNET_COMPUTE_DTYPE=bfloat16: the JAX package's fit over 2
    CPU devices (classic loop) and the port's fit on one context at the
    same global batch."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    try:
        jax_fit, mod = _fit(jmx, _ctxs(jmx, 2), "device")
        assert str(mod._exec_group.executor._compute_dtype) == "bfloat16"
        refs = {"jax": jax_fit,
                "one": _fit(tmx, [tmx.cpu()], "local", fused=False)[0]}
    finally:
        mp.undo()
    return refs


@pytest.mark.parametrize("fused", [False, True])
def test_bfloat16_fit_over_two_contexts_matches_jax_and_one_context(
        bf16_references, monkeypatch, fused):
    """A bfloat16 fit over 2 CPU contexts against the JAX package's
    bfloat16 fit over 2 CPU devices, at the mixed-precision suite's
    bounds (``test_torch_mixed_precision``): losses within OUT_TOL 2e-2
    (relative), params and moving statistics normwise within GRAD_TOL
    0.1 of the reference's move over the 3 steps (measured: 0.063 and
    0.0017; BatchNorm statistics taken per context instead of over the
    global batch give 0.21 and 0.035). Against the port's bfloat16 fit
    on one context at the same global batch: params within 0.02 and
    moving statistics within 1e-4 of its move (measured 0.0035 and
    1.4e-6; the two differ only in the order of their sums, where a
    float32 fit lies 0.046 and 0.003 away, and per-context statistics
    0.21 and 0.035)."""
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    got, mod = _fit(tmx, _ctxs(tmx, 2), "device", fused=fused,
                    check_replicas=True)
    assert all(str(ex.compute_dtype) == "torch.bfloat16"
               for ex in mod._exec_group.execs)
    assert mod._fused_step_active == fused
    args0, aux0 = _params()
    want = bf16_references["jax"]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2)
    assert _normwise(got[1], want[1], args0) <= 0.1
    assert _normwise(got[2], want[2], aux0) <= 0.1
    one = bf16_references["one"]
    np.testing.assert_allclose(got[0], one[0], rtol=2e-2)
    assert _normwise(got[1], one[1], args0) <= 0.02
    assert _normwise(got[2], one[2], aux0) <= 1e-4


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_over_contexts_matches_one_context(grad_req):
    """Two backward passes: ``write`` leaves the global batch's gradient on
    every replica, ``add`` accumulates it (each pass exchanged alone)."""
    x, y = _data()
    args, aux = _params()
    grads = {}
    for n in (1, 4):
        mod = tmx.mod.Module(_net(tmx), context=_ctxs(tmx, n))
        mod.bind([("data", (BATCH, HW, HW, 3))], [("softmax_label", (BATCH,))],
                 grad_req=grad_req)
        mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in args.items()},
                        aux_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in aux.items()})
        batch = tmx.io.DataBatch([tmx.nd.array(x[:BATCH], ctx=tmx.cpu())],
                                 [tmx.nd.array(y[:BATCH], ctx=tmx.cpu())])
        for _ in range(2):
            mod.forward_backward(batch)
        execs = mod._exec_group.execs
        grads[n] = {k: g.asnumpy().copy()
                    for k, g in execs[0].grad_dict.items()}
        for ex in execs[1:]:
            for k, g in ex.grad_dict.items():
                np.testing.assert_array_equal(g.asnumpy(), grads[n][k],
                                              err_msg=k)
    _assert_close(grads[4], grads[1], rtol=1e-3, atol=1e-5)


def test_group_places_on_every_context_and_splits_along_batch_axes():
    """param_sharding None (replicated), place_param / place_like_param
    one copy a context, each array's batch axis from its layout, and the
    unmerged outputs one slice a context."""
    mod = _bind(tmx, _ctxs(tmx, 4))
    group = mod._exec_group
    assert group.param_sharding("fc1_weight") is None
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    for placed in (group.place_param("fc1_bias", value),
                   group.place_like_param("fc1_bias", value)):
        assert [p.context for p in placed] == _ctxs(tmx, 4)
        for p in placed:
            np.testing.assert_array_equal(p.asnumpy(), value)
    assert group._batch_axis_of("data") == 0
    tnc = tmx.io.DataDesc("seq", (5, BATCH, 3), layout="TNC")
    g2 = tmx.mod.executor_group.DataParallelExecutorGroup(
        tmx.sym.Variable("seq") * 2, _ctxs(tmx, 4), [tnc], None, [],
        for_training=False)
    assert g2._batch_axis_of("seq") == 1
    assert g2.execs[3].arg_dict["seq"].shape == (5, 2, 3)
    x, y = _data()
    mod.init_params()
    mod.forward(tmx.io.DataBatch([tmx.nd.array(x[:BATCH], ctx=tmx.cpu())],
                                 [tmx.nd.array(y[:BATCH], ctx=tmx.cpu())]),
                is_train=False)
    parts = mod.get_outputs(merge_multi_context=False)[0]
    assert [p.shape for p in parts] == [(2, 10)] * 4
    np.testing.assert_array_equal(
        np.concatenate([p.asnumpy() for p in parts]),
        mod.get_outputs()[0].asnumpy())


T_STEPS, CH = 3, 5


def _seq_module(pkg, ctxs, flat=False, regression=False):
    """A time-major net: (T, N, C) data in layout TNC through
    tanh(3 x); with ``flat`` the output is reshaped to (T * N, C),
    time-major rows; with ``regression`` it is a LinearRegressionOutput
    against (T, N, C) labels in layout TNC."""
    with fresh_names(pkg):
        net = pkg.sym.Activation(pkg.sym.Variable("data") * 3,
                                 act_type="tanh")
        if flat:
            net = pkg.sym.Reshape(net, shape=(-1, CH))
        if regression:
            net = pkg.sym.LinearRegressionOutput(
                net, pkg.sym.Variable("seq_label"), name="reg")
    labels = ["seq_label"] if regression else []
    mod = pkg.mod.Module(net, label_names=labels, context=ctxs)
    mod.bind([pkg.io.DataDesc("data", (T_STEPS, BATCH, CH), layout="TNC")],
             [pkg.io.DataDesc("seq_label", (T_STEPS, BATCH, CH),
                              layout="TNC")] if regression else None,
             inputs_need_grad=True)
    mod.init_params()
    return mod


def _seq_batch(pkg, labels=False):
    rng = np.random.RandomState(4)
    x = rng.randn(T_STEPS, BATCH, CH).astype(np.float32)
    y = rng.randn(T_STEPS, BATCH, CH).astype(np.float32)
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                            [pkg.nd.array(y, ctx=pkg.cpu())] if labels
                            else [])


def _seq_run(pkg, ctxs, grads=True):
    """The output and (``grads``) the input gradient under a seeded head
    gradient; then, on the regression head, two metrics against
    (T, N, C) labels: MSE (folded a replica) and a host metric that
    weighs each time step differently (updated a replica)."""
    mod = _seq_module(pkg, ctxs)
    mod.forward(_seq_batch(pkg), is_train=grads)
    out = (mod.get_outputs()[0].asnumpy(),)
    if grads:
        head = np.random.RandomState(5).randn(T_STEPS, BATCH, CH).astype(
            np.float32)
        mod.backward([pkg.nd.array(head, ctx=pkg.cpu())])
        out += (mod.get_input_grads()[0].asnumpy(),)
    reg = _seq_module(pkg, ctxs, regression=True)
    batch = _seq_batch(pkg, labels=True)
    reg.forward(batch, is_train=False)
    weights = np.arange(1, T_STEPS + 1, dtype=np.float64)[:, None, None]
    metric = pkg.metric.create(["mse", pkg.metric.CustomMetric(
        lambda label, pred: float(np.mean(weights * (pred - label) ** 2)),
        name="by_step")])
    reg.update_metric(metric, batch.label)
    return out + (dict(metric.get_name_value()),)


def test_time_major_output_joins_and_slices_along_its_batch_axis():
    """A (T, N, C) output over 4 contexts: the outputs joined along axis
    1 and each replica scored against its slice of the (T, N, C) labels,
    as the JAX package's global arrays give (its executor over 4 devices
    takes no head gradient for this net: a forward only there) and one
    context gives; the head gradient sliced along axis 1, as one context
    gives (rtol 1e-6; the metrics 1e-5)."""
    got = _seq_run(tmx, _ctxs(tmx, 4))
    assert got[0].shape == (T_STEPS, BATCH, CH)
    one = _seq_run(tmx, [tmx.cpu()])
    np.testing.assert_allclose(got[1], one[1], rtol=1e-6, atol=1e-7)
    for want in (_seq_run(jmx, _ctxs(jmx, 4), grads=False), one):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
        assert got[-1].keys() == want[-1].keys()
        for k in want[-1]:
            assert got[-1][k] == pytest.approx(want[-1][k], rel=1e-5), k


def test_output_without_a_batch_axis_is_refused():
    """A (T * N, C) output, flattened time-major, has no axis that
    follows the batch alone: joining it or slicing a head gradient for
    it raises; its per-replica slices are still there."""
    mod = _seq_module(tmx, _ctxs(tmx, 2), flat=True)
    mod.forward(_seq_batch(tmx), is_train=True)
    with pytest.raises(tmx.MXNetError, match="no batch axis"):
        mod.get_outputs()
    parts = mod.get_outputs(merge_multi_context=False)[0]
    assert [p.shape for p in parts] == [(T_STEPS * BATCH // 2, CH)] * 2
    with pytest.raises(tmx.MXNetError, match="no batch axis"):
        mod.backward([tmx.nd.zeros((T_STEPS * BATCH, CH), ctx=tmx.cpu())])


def _scores(pkg, ctxs):
    x, y = _data()
    args, aux = _params()
    mod = _bind(pkg, ctxs)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in aux.items()})
    metric = pkg.metric.create(["acc", "ce", pkg.metric.CustomMetric(
        lambda label, pred: float(np.mean(pred[np.arange(len(label)),
                                               label.astype(int)])),
        name="p_true")])
    for i in range(STEPS):
        mod.forward(pkg.io.DataBatch(
            [pkg.nd.array(x[i * BATCH:(i + 1) * BATCH], ctx=pkg.cpu())],
            [pkg.nd.array(y[i * BATCH:(i + 1) * BATCH], ctx=pkg.cpu())]),
            is_train=False)
        mod.update_metric(metric, [pkg.nd.array(
            y[i * BATCH:(i + 1) * BATCH], ctx=pkg.cpu())])
    return dict(metric.get_name_value())


def test_metric_over_contexts_matches_one_context_and_jax():
    """Accuracy and cross-entropy (folded a replica) and a host metric
    (updated a replica) over 4 contexts give the global batch's values
    (rtol 1e-5)."""
    got = _scores(tmx, _ctxs(tmx, 4))
    for want in (_scores(tmx, [tmx.cpu()]), _scores(jmx, _ctxs(jmx, 4))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_the_four_card_check_rehearses_on_cpu_contexts():
    """tools/torch_dp_check.py's run over 4 CPU contexts at a tiny size:
    every check passes, the exchange's sum is tested on gradients that
    differ by context, and the planted per-context statistics break the
    bound."""
    import os
    import sys

    import torch

    from mxnet_tpu_torch.ops import kernels

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import torch_dp_check

    rec = torch_dp_check.run(torch, tmx, kernels, 4, per_card=2, steps=2,
                             image=32, cpu=True, log=lambda *_: None)
    assert rec["failed"] == []
    assert rec["replicas_identical"]
    assert rec["exchange_check"]["inputs_differ_by_card"]
    assert rec["control"]["caught"]


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------
def _bind(pkg, ctxs, batch=BATCH):
    mod = pkg.mod.Module(_net(pkg), context=ctxs)
    mod.bind([("data", (batch, HW, HW, 3))], [("softmax_label", (batch,))])
    return mod


def test_indivisible_batch_raises_in_both():
    for pkg in (tmx, jmx):
        with pytest.raises(pkg.MXNetError, match="not divisible by 3"):
            _bind(pkg, _ctxs(pkg, 3), batch=10)


def test_duplicate_mixed_and_missing_contexts_raise():
    with pytest.raises(tmx.MXNetError, match="twice"):
        tmx.mod.Module(_net(tmx), context=[tmx.cpu(0), tmx.cpu(0)])
    with pytest.raises(Exception):
        # the reference's mesh refuses a device twice too
        _bind(jmx, [jmx.cpu(0), jmx.cpu(0)])
    with pytest.raises(tmx.MXNetError, match="mix"):
        tmx.mod.Module(_net(tmx), context=[tmx.cpu(0), tmx.gpu(0)])
    with pytest.raises(tmx.DeviceUnavailableError):
        tmx.mod.Module(_net(tmx), context=[tmx.gpu(0), tmx.gpu(1)])


def test_unported_parts_raise_naming_their_item(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "2")
    with pytest.raises(tmx.MXNetError, match="item 10c"):
        _bind(tmx, _ctxs(tmx, 4))
    monkeypatch.delenv("MXNET_TPU_MESH_FSDP")
    with fresh_names(tmx):
        data = tmx.sym.Variable("data")
        net = tmx.sym.MakeLoss(tmx.sym.sum(data), name="loss")
    mod = tmx.mod.Module(net, label_names=[], context=_ctxs(tmx, 2))
    with pytest.raises(tmx.MXNetError, match="across the batch"):
        mod.bind([("data", (4, 3))])
    one = _bind(tmx, _ctxs(tmx, 1))
    with pytest.raises(tmx.MXNetError, match="shares no arrays"):
        tmx.mod.Module(_net(tmx), context=_ctxs(tmx, 2)).bind(
            [("data", (BATCH, HW, HW, 3))], [("softmax_label", (BATCH,))],
            shared_module=one)


# ---------------------------------------------------------------------------
# the rest: the manager, FeedForward, checkpoints
# ---------------------------------------------------------------------------
def _mgr_run(pkg, ctxs):
    x, y = _data()
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    net = _net(pkg)
    params = [n for n in net.list_arguments()
              if n not in ("data", "softmax_label")]
    args, aux = _params()
    mgr = pkg.executor_manager.DataParallelExecutorManager(
        net, ctxs, it, param_names=params, work_load_list=[3, 1, 1, 1])
    mgr.set_params({k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in args.items()},
                   {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()})
    for batch in it:
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        for block, grads in zip(mgr.param_arrays, mgr.grad_arrays):
            for w, g in zip(block, grads):
                w[:] = w.asnumpy() - 0.05 * g.asnumpy()
    out = mgr.get_outputs()[0].asnumpy().copy()
    return out, {n: b[0].asnumpy().copy()
                 for n, b in zip(mgr.param_names, mgr.param_arrays)}, mgr


def test_executor_manager_over_four_contexts():
    """Every context bound (the unequal work_load_list ignored, as the
    reference ignores it); each replica's gradients are the whole
    batch's."""
    got = _mgr_run(tmx, _ctxs(tmx, 4))
    want = _mgr_run(jmx, _ctxs(jmx, 4))
    one = _mgr_run(tmx, [tmx.cpu()])
    assert len(got[2].param_arrays[0]) == 4
    assert got[0].shape == (BATCH, 10)
    for ref in (want, one):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
        _assert_close(got[1], ref[1], rtol=1e-3, atol=1e-5)


def test_feedforward_over_contexts_trains_and_predicts():
    x, y = _data()
    args, aux = _params()
    runs = {}
    for n in (1, 4):
        np.random.seed(0)      # the iterator's shuffle
        model = tmx.model.FeedForward(
            _net(tmx), ctx=_ctxs(tmx, n), num_epoch=1, numpy_batch_size=BATCH,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in args.items()},
            aux_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in aux.items()},
            learning_rate=0.01, momentum=0.9)
        model.fit(x, y)
        runs[n] = (model.predict(x[:BATCH]),
                   {k: v.asnumpy() for k, v in model.arg_params.items()})
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=1e-3, atol=1e-5)
    _assert_close(runs[4][1], runs[1][1], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("saved_on,resumed_on", [(4, 1), (1, 4)])
def test_checkpoint_crosses_context_counts(saved_on, resumed_on):
    """A snapshot after two steps on ``saved_on`` contexts restores onto
    ``resumed_on``: every replica bit-equal to the snapshot, the momenta
    too, and the third step within the fit bound of the uninterrupted
    run."""
    from mxnet_tpu_torch import checkpoint as ckpt

    x, y = _data()
    full, _ = _fit(tmx, _ctxs(tmx, saved_on), "device", fused=True)

    snaps = []

    def snap_after_two(param):
        if param.nbatch == 1:
            snaps.append(ckpt.snapshot(param.locals["self"], step=2,
                                       nbatch=1))

    args, aux = _params()
    mod = tmx.mod.Module(_net(tmx), context=_ctxs(tmx, saved_on))
    mod.fit(tmx.io.NDArrayIter(x[:2 * BATCH], y[:2 * BATCH],
                               batch_size=BATCH), num_epoch=1,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in args.items()},
            aux_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in aux.items()},
            kvstore="device", optimizer="sgd", optimizer_params=OPT,
            batch_end_callback=snap_after_two, fused_step=True)
    payload = snaps[0]
    assert payload["dp"] == saved_on

    res = tmx.mod.Module(_net(tmx), context=_ctxs(tmx, resumed_on))
    res.bind([("data", (BATCH, HW, HW, 3))], [("softmax_label", (BATCH,))])
    res.init_params()
    res.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=OPT)
    pos = ckpt.restore(payload, res)
    assert pos["dp"] == saved_on
    for ex in res._exec_group.execs:
        for name, val in payload["params"].items():
            np.testing.assert_array_equal(ex.arg_dict[name].asnumpy(), val)
    for updater in res._updaters:
        for index, saved in payload["updater_states"].items():
            np.testing.assert_array_equal(
                updater.states[int(index)].asnumpy(), saved)
    res.fit(tmx.io.NDArrayIter(x[2 * BATCH:], y[2 * BATCH:],
                               batch_size=BATCH), num_epoch=1,
            kvstore="device", optimizer="sgd", optimizer_params=OPT,
            fused_step=True)
    a, _ = res.get_params()
    _assert_close({k: v.asnumpy() for k, v in a.items()}, full[1],
                  rtol=1e-3, atol=1e-5)
