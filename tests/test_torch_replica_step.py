"""The fused train step over several contexts with the uint8 device feed
and with Dropout (mxnet_tpu_torch/fused_step.py, replicas.py,
io_cache.py, module/executor_group.py, io_pipeline.py, checkpoint.py),
on 4 ``cpu(i)`` contexts against the JAX package's fits over a 4-device
``dp`` mesh on the suite's forced 8-device CPU platform, and against the
port's own classic loop and one context.

A device-feed batch is split along the replicas: each context takes its
rows of the uint8 frames and of the crop offsets and mirror flags, its
own mean and scale, and crops into its own bound data array, in both
loops. Bounds: the crops bit-equal to the JAX package's and to the rows
of the port's one-context crop; the fits hold the small-ResNet bound of
``test_torch_multi_device`` (losses rtol 1e-4, params and aux rtol 1e-3
/ atol 1e-5) against the JAX package, and the fused fit equals the
classic loop bit for bit. A Dropout graph draws on each context from
that replica's generator: the fused fit equals the classic loop bit for
bit, each context's mask differs, and the keep rate matches the JAX
package's ``dp``-mesh masks by moments (mean within 5 standard
errors)."""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io_cache as jic

from test_torch_common import (dropout_mlp, feed_iter, fresh_names,
                               random_params, write_uint8_cache)

N_CTX = 4
BATCH = 8                  # 2 a context
CROP = 16
STORE = 18                 # 18^2 / (4 * 16^2): 0.32 of the float32 bytes
STEPS = 3
CLASSES = 10
OPT = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 1e-4))


def _ctxs(pkg, n=N_CTX):
    return [pkg.cpu(i) for i in range(n)]


def _resnet(pkg):
    with fresh_names(pkg):
        return pkg.models.get_resnet([1, 1], [8, 16, 16],
                                     num_classes=CLASSES, small_input=True,
                                     layout="NHWC")


def _resnet_params():
    args, aux = random_params(_resnet(tmx), (BATCH, CROP, CROP, 3), seed=2)
    for k in args:
        if k.endswith("_b3_bn_gamma"):
            args[k] = np.full_like(args[k], 0.25)
    return args, aux


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return write_uint8_cache(str(tmp_path_factory.mktemp("feed") / "c"),
                             STEPS * BATCH, STORE, CLASSES)


def _fit(pkg, ctxs, it, net, params, kvstore="device_sync", fused=None,
         on_batch=None, num_epoch=1):
    """fit over ``it``: the per-step losses (cross-entropy of the
    forward's probabilities, from the batch's labels), params and aux as
    numpy, and the module."""
    losses = []

    def record(param):
        mod = param.locals["self"]
        probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
        lab = param.locals["data_batch"].label[0].asnumpy().astype(int)
        losses.append(-np.log(probs[np.arange(len(lab)), lab]).mean())
        if on_batch is not None:
            on_batch(param)

    args, aux = params
    mod = pkg.mod.Module(net, context=ctxs, logger=logging)
    kw = {} if pkg is jmx else {"fused_step": fused}
    mod.fit(it, num_epoch=num_epoch, kvstore=kvstore, optimizer="sgd",
            optimizer_params=OPT,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in aux.items()},
            batch_end_callback=record, **kw)
    a, b = mod.get_params()
    return (np.array(losses), {k: v.asnumpy().copy() for k, v in a.items()},
            {k: v.asnumpy().copy() for k, v in b.items()}), mod


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close(got, want):
    assert len(got[0]) == STEPS and np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)


def _crops(mod):
    """Every replica's bound data array, joined along the batch."""
    return np.concatenate([ex.arg_dict["data"].asnumpy()
                           for ex in mod._exec_group.execs])


# ---------------------------------------------------------------------------
# the crop split along the replicas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aug_replicas", [1, 2, 4])
def test_each_context_crops_its_rows_of_the_one_context_crop(cache,
                                                             aug_replicas):
    """A fed batch over 4 contexts: each context's bound data array is
    its rows of the JAX package's materialised crop and of the port's
    one-context crop, bit for bit, whatever ``aug_replicas`` drew the
    offsets (it need not equal the contexts); each context's frames
    and offsets are its rows alone, and its uint8 bytes a batch at most
    a third of its float32 crop's."""
    batch = next(feed_iter(tmx, cache, BATCH, CROP, aug_replicas))
    want = jic.materialize_device_feed(next(feed_iter(
        jmx, cache, BATCH, CROP, aug_replicas))).data[0].asnumpy()
    one = tmx.io_cache.materialize_device_feed(batch, tmx.cpu())
    np.testing.assert_array_equal(one.data[0].asnumpy(), want)
    mod = tmx.mod.Module(_resnet(tmx), context=_ctxs(tmx))
    mod.bind([("data", (BATCH, CROP, CROP, 3))],
             [("softmax_label", (BATCH,))])
    group = mod._exec_group
    group.load_data_batch(batch)
    np.testing.assert_array_equal(_crops(mod), want)
    rows = BATCH // N_CTX
    for k, (ex, feed) in enumerate(zip(group.execs, group._feeds)):
        ours = slice(k * rows, (k + 1) * rows)
        np.testing.assert_array_equal(feed.bufs["x"].numpy(),
                                      batch.data[0].asnumpy()[ours])
        np.testing.assert_array_equal(feed.bufs["tops"].numpy(),
                                      batch.aug["tops"][ours])
        np.testing.assert_array_equal(ex.arg_dict["softmax_label"].asnumpy(),
                                      batch.label[0].asnumpy()[ours])
        u8 = feed.bufs["x"].numel()
        f32 = 4 * ex.arg_dict["data"].handle.numel()
        assert u8 <= f32 / 3, (u8, f32)


def test_score_and_predict_over_contexts_go_through_the_split(cache):
    """score and predict of a fed iterator over 4 contexts: the outputs
    of one context's, and no batch materialised on the first context
    (each context crops its own rows)."""
    params = _resnet_params()
    runs = {}
    for n in (1, N_CTX):
        mod = tmx.mod.Module(_resnet(tmx), context=_ctxs(tmx, n))
        mod.bind([("data", (BATCH, CROP, CROP, 3))],
                 [("softmax_label", (BATCH,))], for_training=False)
        mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in params[0].items()},
                        aux_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in params[1].items()})
        it = feed_iter(tmx, cache, BATCH, CROP)
        runs[n] = (mod.predict(it).asnumpy(),
                   dict(mod.score(it, ["acc", "ce"])))
        assert (mod._exec_group._feeds is not None) == (n > 1)
    np.testing.assert_allclose(runs[N_CTX][0], runs[1][0], rtol=1e-5,
                               atol=1e-6)
    for k, v in runs[1][1].items():
        assert runs[N_CTX][1][k] == pytest.approx(v, rel=1e-5), k


# ---------------------------------------------------------------------------
# the fed fit over the replicas
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_fed_fits(cache):
    """The JAX package's fed fused fits (device_sync) over a 4-device
    dp mesh, aug_replicas 1 and 4."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_FUSED_STEP", "1")
    try:
        return {r: _fit(jmx, _ctxs(jmx), feed_iter(jmx, cache, BATCH, CROP,
                                                   r),
                        _resnet(jmx), _resnet_params())[0]
                for r in (1, N_CTX)}
    finally:
        mp.undo()


@pytest.mark.parametrize("aug_replicas", [1, N_CTX])
def test_fed_fused_fit_over_four_contexts_matches_jax(cache, jax_fed_fits,
                                                      aug_replicas):
    """The port's fed fused fit over 4 contexts (device_sync takes the
    fused step) against the JAX package's fed fused fit over a 4-device
    dp mesh from the same params and the same draws, and the crops of
    every step bit-equal to the JAX iterator's materialised batch."""
    jit = feed_iter(jmx, cache, BATCH, CROP, aug_replicas)
    jit.reset()     # the epoch fit's reset starts
    crops = []

    def crop_of_step(param):
        crops.append(_crops(param.locals["self"]))

    got, mod = _fit(tmx, _ctxs(tmx), feed_iter(tmx, cache, BATCH, CROP,
                                               aug_replicas),
                    _resnet(tmx), _resnet_params(), on_batch=crop_of_step)
    step = mod._fused_step
    assert mod._fused_step_active and step.eager_steps == STEPS
    _close(got, jax_fed_fits[aug_replicas])
    assert len(crops) == STEPS
    for crop, batch in zip(crops, jit):
        np.testing.assert_array_equal(
            crop, jic.materialize_device_feed(batch).data[0].asnumpy())


@pytest.mark.parametrize("fsdp", [None, "2"])
def test_fed_fused_fit_equals_the_classic_loop(cache, monkeypatch, fsdp):
    """The fused step over 4 contexts runs the classic loop's step
    function on the same crops: bit-equal params, aux and losses, also
    under MXNET_TPU_MESH_FSDP=2 (the crop before the gather); the fused
    fit holds one feed a context and the same list from batch to
    batch."""
    if fsdp:
        monkeypatch.setenv("MXNET_TPU_MESH_FSDP", fsdp)
    runs = {}
    for fused in (True, False):
        runs[fused], mod = _fit(tmx, _ctxs(tmx),
                                feed_iter(tmx, cache, BATCH, CROP, N_CTX),
                                _resnet(tmx), _resnet_params(),
                                kvstore="device", fused=fused)
        assert (mod._exec_group.shards is not None) == bool(fsdp)
        if fused:
            feeds = mod._fused_step._feed
            assert [f.device for f in feeds] == [
                ex._device for ex in mod._exec_group.execs]
    _same(runs[True], runs[False])


@pytest.mark.parametrize("wrap", ["staging", "feed2"])
def test_staging_hands_each_context_its_rows(cache, monkeypatch, wrap):
    """DeviceStagingIter and FeedScheduler over a group of 4 contexts
    stage a fed batch's frames a context's rows at a time (the batch
    keeps its host frames as its data): the fit equals the unstaged one
    bit for bit."""
    want = _fit(tmx, _ctxs(tmx), feed_iter(tmx, cache, BATCH, CROP),
                _resnet(tmx), _resnet_params())[0]
    env = {"staging": ("MXNET_TPU_DEVICE_STAGING", "1"),
           "feed2": ("MXNET_TPU_FEED_DEPTH", "2")}[wrap]
    monkeypatch.setenv(*env)
    parts = []

    def record(param):
        batch = param.locals["data_batch"]
        parts.append([(sl, tuple(t.shape)) for sl, t in batch.feed_parts])

    got = _fit(tmx, _ctxs(tmx), feed_iter(tmx, cache, BATCH, CROP),
               _resnet(tmx), _resnet_params(), on_batch=record)[0]
    _same(got, want)
    rows = BATCH // N_CTX
    assert parts[0] == [(slice(k * rows, (k + 1) * rows),
                         (rows, STORE, STORE, 3)) for k in range(N_CTX)]


# ---------------------------------------------------------------------------
# Dropout over the replicas
# ---------------------------------------------------------------------------
def _mlp_params(seed=3):
    net = dropout_mlp(tmx)
    shapes, _, _ = net.infer_shape(data=(BATCH, CROP, CROP, 3),
                                   softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    return ({n: (rng.randn(*s) * 0.05).astype(np.float32)
             for n, s in zip(net.list_arguments(), shapes)
             if n not in ("data", "softmax_label")}, {})


def _dropout_fit(cache, fused, on_batch=None, num_epoch=1):
    tmx.random.seed(0)
    return _fit(tmx, _ctxs(tmx), feed_iter(tmx, cache, BATCH, CROP),
                dropout_mlp(tmx), _mlp_params(), kvstore="device",
                fused=fused, on_batch=on_batch, num_epoch=num_epoch)


def test_dropout_fused_fit_equals_the_classic_loop(cache):
    """A Dropout MLP over 4 contexts from a fed iterator: the fused fit
    equals the classic loop bit for bit (each replica's generator seeded
    from mx.random's stream at its first draw, in the same order), and
    the replicas' generators are distinct."""
    fused, mod = _dropout_fit(cache, True)
    classic = _dropout_fit(cache, False)[0]
    _same(fused, classic)
    seeds = [ex._seed for ex in mod._exec_group.execs]
    assert len(set(seeds)) == N_CTX


def _dropout_outputs(pkg):
    """Dropout(p=0.5) of ones, (4096, 64), in train mode over 4
    contexts: the output over the global batch (2 where kept, 0 where
    dropped)."""
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        net = pkg.sym.LinearRegressionOutput(
            pkg.sym.Dropout(data, p=0.5, name="drop"), name="lro")
    mod = pkg.mod.Module(net, label_names=["lro_label"], context=_ctxs(pkg))
    shape = (4096, 64)
    mod.bind([("data", shape)], [("lro_label", shape)])
    mod.init_params()
    pkg.random.seed(0)
    ones = np.ones(shape, np.float32)
    mod.forward(pkg.io.DataBatch([pkg.nd.array(ones, ctx=pkg.cpu())],
                                 [pkg.nd.array(ones, ctx=pkg.cpu())]),
                is_train=True)
    return mod.get_outputs()[0].asnumpy()


def test_each_contexts_mask_differs_and_keeps_at_the_reference_rate():
    """Each context draws its own mask (no two replicas' slices equal);
    the keep rate over the global batch matches the JAX package's masks
    over a 4-device dp mesh by moments: means within 5 standard errors,
    and every kept value 1 / (1 - p)."""
    mine, theirs = _dropout_outputs(tmx), _dropout_outputs(jmx)
    rows = mine.shape[0] // N_CTX
    parts = [mine[k * rows:(k + 1) * rows] for k in range(N_CTX)]
    for i in range(N_CTX):
        for j in range(i + 1, N_CTX):
            assert not np.array_equal(parts[i], parts[j]), (i, j)
    for out in (mine, theirs):
        assert set(np.unique(out)) == {0.0, 2.0}
    kept_m = (mine != 0).astype(np.float64).ravel()
    kept_t = (theirs != 0).astype(np.float64).ravel()
    se = kept_t.std() / np.sqrt(kept_t.size)
    assert abs(kept_m.mean() - kept_t.mean()) < 5 * se
    for part in parts:
        assert abs((part != 0).mean() - 0.5) < 5 * 0.5 / np.sqrt(part.size)


def test_dropout_fed_resume_over_contexts_is_bit_identical(cache):
    """A snapshot after two steps of the fed Dropout fit over 4 contexts
    records every replica's generator and the iterator's position;
    a fresh module resumed from it runs the third step of the
    uninterrupted fit bit for bit."""
    from mxnet_tpu_torch import checkpoint as ckpt

    full = _dropout_fit(cache, True)[0]
    snaps = []

    def snap_after_two(param):
        if param.nbatch == 1:
            snaps.append(ckpt.snapshot(
                param.locals["self"], step=2, nbatch=1,
                train_data=param.locals["train_data"]))

    _dropout_fit(cache, True, on_batch=snap_after_two)
    payload = snaps[0]
    assert len(payload["rng_torch"]["replicas"]) == N_CTX - 1
    res = tmx.mod.Module(dropout_mlp(tmx), context=_ctxs(tmx))
    res.bind([("data", (BATCH, CROP, CROP, 3))], [("softmax_label", (BATCH,))])
    res.init_params()
    res.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=OPT)
    it = feed_iter(tmx, cache, BATCH, CROP)
    ckpt.restore(payload, res, train_data=it)
    metric = tmx.metric.create("acc")
    step = res._fused_train_step(metric)
    losses = []
    for batch in it:
        step.step(batch, metric)
        probs = res.get_outputs()[0].asnumpy().astype(np.float64)
        lab = batch.label[0].asnumpy().astype(int)
        losses.append(-np.log(probs[np.arange(len(lab)), lab]).mean())
    np.testing.assert_array_equal(losses, full[0][2:])
    for k, v in res.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), full[1][k], err_msg=k)


# ---------------------------------------------------------------------------
# what the step still refuses over several contexts
# ---------------------------------------------------------------------------
def _bound_mlp(ctxs):
    mod = tmx.mod.Module(dropout_mlp(tmx), context=ctxs)
    mod.bind([("data", (BATCH, CROP, CROP, 3))], [("softmax_label", (BATCH,))])
    mod.init_params()
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=OPT)
    return mod


def test_a_dropout_graph_over_cards_is_no_longer_refused():
    """The step over a replica set on cards takes a graph that draws
    random numbers (its generators are registered at the capture)."""
    from mxnet_tpu_torch.fused_step import FusedTrainStep

    mod = _bound_mlp(_ctxs(tmx, 2))
    mod._exec_group.replicas.cuda = True
    try:
        step = FusedTrainStep(mod, tmx.metric.create("acc"))
    finally:
        mod._exec_group.replicas.cuda = False
    assert step._ex.draws_random()


def test_skip_guard_and_numwatch_over_fsdp_still_raise(monkeypatch):
    """No longer refused: the skip guard over 2 contexts, and the plane
    under fsdp 2, build their step and fold one batch: the fold's pack
    under fsdp equals the dp pack (counts and stamps exact, sums rtol
    1e-5), and each card keeps its own pack, equal to the first's."""
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "skip")
    x = np.random.RandomState(1).randn(BATCH, CROP, CROP, 3).astype(
        np.float32)
    y = np.arange(BATCH, dtype=np.float32) % CLASSES
    packs = []
    for fsdp in (None, "2"):
        if fsdp:
            monkeypatch.setenv("MXNET_TPU_MESH_FSDP", fsdp)
        tmx.random.seed(0)
        mod = _bound_mlp(_ctxs(tmx, 2))
        step = mod._fused_train_step(tmx.metric.create("acc"))
        assert step._numwatch.skip_guard
        step.step(next(iter(tmx.io.NDArrayIter(x, y, batch_size=BATCH))),
                  tmx.metric.create("acc"))
        pack = step._numwatch._pack.numpy().copy()
        for copy in step._numwatch._copies.values():
            np.testing.assert_array_equal(copy.numpy(), pack)
        packs.append(pack)
    from mxnet_tpu_torch import numwatch as tnw

    assert mod._exec_group.shards is not None
    exact = [tnw.G_NONFIN, tnw.G_ZERO, tnw.W_NONFIN, tnw.FB_PARAM,
             tnw.FB_GRAD]
    np.testing.assert_array_equal(packs[1][:, exact], packs[0][:, exact])
    np.testing.assert_allclose(packs[1], packs[0], rtol=1e-5, atol=1e-7)
