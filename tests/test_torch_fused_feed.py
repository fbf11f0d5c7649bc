"""The port's device feed (mxnet_tpu_torch/io_cache.py, fused_step.py,
module/executor_group.py, io_pipeline.py) against the JAX package's, on
the CPU, the cases of tests/test_fused_feed.py: a device-feed batch
carries raw uint8 frames and ``batch.aug``; ``materialize_device_feed``
gives the JAX package's values bit for bit; the fused step crops and
normalises in its step function (``crop_norm`` first) and equals the
eager cached path and the classic loop bit for bit, and the JAX
package's fused step within rtol 1e-5 / atol 1e-6 (float32 sums in
another order); the uint8 batches carry at most a third of the float32
crops' bytes; FeedScheduler and DeviceStagingIter keep ``aug``."""
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io_cache as jic
from mxnet_tpu import recordio as rio
from mxnet_tpu_torch import io_cache as tic
from mxnet_tpu_torch import io_pipeline as tiop
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.io import DataBatch, DataDesc, DataIter
from mxnet_tpu_torch.ops import kernels

BATCH = 8
# the 256-store/224-crop ratio: 36^2 / (4 * 32^2) ~ 0.316 of the bytes
STORE = 36
CROP = 32


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("feed")
    rng = np.random.RandomState(11)
    w = rio.MXRecordIO(str(tmp / "t.rec"), "w")
    for i in range(24):
        img = rng.randint(0, 255, (48, 48, 3)).astype(np.uint8)
        w.write(rio.pack_img(rio.IRHeader(0, float(i % 5), i, 0), img,
                             quality=95))
    w.close()
    prefix = str(tmp / "t.cache")
    tic.build_decoded_cache(str(tmp / "t.rec"), prefix, (3, STORE, STORE),
                            preprocess_threads=2)
    return prefix


@pytest.fixture()
def tel():
    telemetry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.reset()
    telemetry.disable()


def _net(pkg):
    with pkg.name.NameManager():
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=5, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _seed_params(net, data_shape, seed=3):
    arg_shapes, _, _ = net.infer_shape(data=data_shape,
                                       softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*shape) * 0.1).astype(np.float32)
            for name, shape in zip(net.list_arguments(), arg_shapes)
            if name not in ("data", "softmax_label")}


def _kw(**mode):
    return dict(shuffle=True, seed=7, rand_crop=True, rand_mirror=True,
                scale=1.0 / 255.0, mean_r=120.0, mean_g=110.0, mean_b=100.0,
                **mode)


def _iter(prefix, **mode):
    with tmx.cpu():
        return tic.CachedImageRecordIter(prefix, (3, CROP, CROP), BATCH,
                                         **_kw(**mode))


def _fit(prefix, fused, num_epoch=2, wrap=None, **mode):
    """The port's fit over the cache; returns the params and the step."""
    it = _iter(prefix, **mode)
    if wrap is not None:
        it = wrap(it)
    net = _net(tmx)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd", fused_step=fused,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in
                        _seed_params(net, (BATCH, 3, CROP, CROP)).items()},
            initializer=None,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    assert mod._fused_step_active == fused
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def _jax_fit(prefix, monkeypatch, **mode):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    it = jic.CachedImageRecordIter(prefix, (3, CROP, CROP), BATCH,
                                   **_kw(**mode))
    net = _net(jmx)
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            arg_params={k: jmx.nd.array(v) for k, v in
                        _seed_params(net, (BATCH, 3, CROP, CROP)).items()},
            initializer=None,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    monkeypatch.delenv("MXNET_TPU_FUSED_STEP")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the iterator's device-feed batches ---------------------------------------
def test_device_feed_batch_shape_and_aug(cache, tel):
    it = _iter(cache, device_feed=True)
    b = next(it)
    assert b.data[0].shape == (BATCH, STORE, STORE, 3)
    assert b.data[0].dtype == np.uint8
    aug = b.aug
    assert aug["crop"] == (CROP, CROP) and aug["layout"] == "NCHW"
    assert aug["tops"].shape == aug["lefts"].shape == (BATCH,)
    assert aug["tops"].dtype == aug["lefts"].dtype == np.int32
    assert aug["mirror"].shape == (BATCH,)
    assert tel.peek("io.feed_batches") >= 1
    assert it.provide_data[0].shape == (BATCH, 3, CROP, CROP)
    ref = next(jic.CachedImageRecordIter(cache, (3, CROP, CROP), BATCH,
                                         **_kw(device_feed=True)))
    np.testing.assert_array_equal(b.data[0].asnumpy(), ref.data[0].asnumpy())
    assert set(aug) == set(ref.aug)
    for k in aug:
        np.testing.assert_array_equal(np.asarray(aug[k]),
                                      np.asarray(ref.aug[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_materialize_matches_jax_and_device_augment(cache, layout):
    eager = next(_iter(cache, device_augment=True, output_layout=layout))
    feed = next(_iter(cache, device_feed=True, output_layout=layout))
    jfeed = next(jic.CachedImageRecordIter(
        cache, (3, CROP, CROP), BATCH,
        **_kw(device_feed=True, output_layout=layout)))
    np.testing.assert_array_equal(eager.label[0].asnumpy(),
                                  feed.label[0].asnumpy())
    m = tic.materialize_device_feed(feed)
    assert getattr(m, "aug", None) is None
    np.testing.assert_array_equal(m.data[0].asnumpy(),
                                  eager.data[0].asnumpy())
    np.testing.assert_array_equal(
        m.data[0].asnumpy(),
        jic.materialize_device_feed(jfeed).data[0].asnumpy())
    plain = tic.materialize_device_feed(eager)
    assert plain is eager


def test_crop_norm_plain_clamps_and_mirrors_as_dynamic_slice():
    """Offsets past the frame clamp into it (dynamic_slice's rule) and a
    mirrored crop reads its columns backwards."""
    import torch

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (3, 10, 12, 2)).astype(np.uint8))
    tops = torch.tensor([-3, 9, 2], dtype=torch.int32)
    lefts = torch.tensor([0, 100, 1], dtype=torch.int32)
    mirror = torch.tensor([False, True, True])
    mean = torch.tensor([1.0, 2.0])
    scale = torch.tensor([0.5])
    y = kernels.crop_norm(x, tops, lefts, mirror, mean, scale, (6, 7), "NHWC")
    xn = x.numpy().astype(np.float32)
    want = np.stack([xn[0, 0:6, 0:7], xn[1, 4:10, 5:12][:, ::-1],
                     xn[2, 2:8, 1:8][:, ::-1]])
    np.testing.assert_array_equal(y.numpy(), (want - [1.0, 2.0]) * 0.5)


def test_device_feed_env_gate(cache, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_DEVICE_FEED", "1")
    with tmx.cpu():
        it = tic.CachedImageRecordIter(cache, (3, CROP, CROP), BATCH,
                                       scale=1.0 / 255.0)
    assert it.device_feed
    b = next(it)
    assert b.data[0].dtype == np.uint8 and b.aug is not None


# -- the fused step and the classic loop --------------------------------------
def test_fused_feed_bit_identical_to_eager_cached(cache, tel):
    _same(_fit(cache, True, device_feed=True),
          _fit(cache, True, device_augment=True))
    assert tel.peek("step.fused_feed_batches") == 2 * (24 // BATCH)


def test_fused_feed_counts_its_batches(cache, tel):
    before = tel.peek("step.fused_feed_batches") or 0
    calls = []
    real = kernels.crop_norm

    def spy(*args, **kwargs):
        calls.append(kwargs.get("out") is not None)
        return real(*args, **kwargs)

    kernels.crop_norm = spy
    try:
        _fit(cache, True, device_feed=True)
    finally:
        kernels.crop_norm = real
    nbatches = 2 * (24 // BATCH)
    assert (tel.peek("step.fused_feed_batches") or 0) - before == nbatches
    # one crop_norm a step, each writing into the bound data array
    assert calls == [True] * nbatches


def test_classic_loop_materializes_feed_batches(cache, tel):
    _same(_fit(cache, False, device_feed=True),
          _fit(cache, False, device_augment=True))


def test_fused_vs_classic_feed_parity(cache):
    _same(_fit(cache, True, device_feed=True),
          _fit(cache, False, device_feed=True))


def test_fused_feed_matches_jax(cache, monkeypatch):
    want = _jax_fit(cache, monkeypatch, device_feed=True)
    got = _fit(cache, True, device_feed=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fused_feed_nhwc_resnet_matches_classic(cache):
    """A small channels-last ResNet (the K3/K4/K5 path) trained from an
    NHWC feed: fused bit-equal to classic."""
    from test_torch_common import random_params, small_resnet

    params = None
    runs = []
    for fused in (False, True):
        sym = small_resnet(tmx, layout="NHWC", num_classes=5)
        if params is None:
            params = random_params(sym, (BATCH, CROP, CROP, 3))
        it = _iter(cache, device_feed=True, output_layout="NHWC")
        mod = tmx.mod.Module(sym, context=tmx.cpu())
        mod.fit(it, num_epoch=1, fused_step=fused, initializer=None,
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in params[0].items()},
                aux_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in params[1].items()},
                optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
        runs.append({k: v.asnumpy().copy()
                     for k, v in mod.get_params()[0].items()})
    _same(runs[1], runs[0])


def test_fused_feed_with_two_data_inputs_materialises(cache):
    """A graph with a second data input: the fused step materialises the
    feed batch (the reference's rule) and trains as the classic loop."""
    class TwoInputs(DataIter):
        def __init__(self, base):
            super().__init__()
            self.base, self.batch_size = base, base.batch_size

        @property
        def provide_data(self):
            return self.base.provide_data + [DataDesc("extra", (BATCH, 4))]

        @property
        def provide_label(self):
            return self.base.provide_label

        def reset(self):
            self.base.reset()

        def next(self):
            b = self.base.next()
            out = DataBatch(list(b.data) + [tmx.nd.array(
                np.ones((BATCH, 4), np.float32), ctx=tmx.cpu())], b.label,
                b.pad, b.index)
            out.aug = b.aug
            return out

    def run(fused):
        with tmx.name.NameManager():
            data = tmx.sym.Flatten(tmx.sym.Variable("data"))
            net = tmx.sym.Concat(data, tmx.sym.Variable("extra"), dim=1)
            net = tmx.sym.FullyConnected(net, num_hidden=5, name="fc")
            net = tmx.sym.SoftmaxOutput(net, name="softmax")
        mod = tmx.mod.Module(net, data_names=["data", "extra"],
                             context=tmx.cpu())
        rng = np.random.RandomState(0)
        w = (rng.randn(5, 3 * CROP * CROP + 4) * 0.01).astype(np.float32)
        mod.fit(TwoInputs(_iter(cache, device_feed=True)), num_epoch=1,
                fused_step=fused, initializer=None,
                arg_params={"fc_weight": tmx.nd.array(w, ctx=tmx.cpu()),
                            "fc_bias": tmx.nd.zeros(5, ctx=tmx.cpu())},
                optimizer_params={"learning_rate": 0.05})
        return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}

    _same(run(True), run(False))


# -- bytes to the card ---------------------------------------------------------
def _batch_bytes(b):
    arrays = list(b.data) + list(b.label)
    n = sum(a.asnumpy().nbytes for a in arrays)
    aug = getattr(b, "aug", None)
    if aug is not None:
        n += sum(np.asarray(aug[k]).nbytes
                 for k in ("tops", "lefts", "mirror", "mean", "scale"))
    return n


def test_uint8_feed_bytes_at_most_one_third_of_f32(cache):
    """What a feed batch hands to the card (uint8 frames, labels and the
    aug tensors, which the fused step copies in) against the float32
    crops of the host path, over one epoch each."""
    u8 = sum(_batch_bytes(b) for b in _iter(cache, device_feed=True))
    f32 = sum(_batch_bytes(b)
              for b in _iter(cache, device_normalize=False))
    assert u8 / f32 <= 1.0 / 3.0, (u8, f32)


# -- the feed scheduler and staging keep aug -----------------------------------
@pytest.mark.parametrize("kind", ["staging", "feed2"])
def test_staging_wrappers_keep_aug(cache, kind):
    """DeviceStagingIter and FeedScheduler hand out a device-feed batch
    with its ``aug`` (before the port kept it, the staged batch lost it
    and the frames reached the model raw); the JAX wrappers do the same."""
    from mxnet_tpu import io_pipeline as jiop

    wrap = {"staging": lambda iop, it: iop.DeviceStagingIter(it),
            "feed2": lambda iop, it: iop.FeedScheduler(it, depth=2)}[kind]
    with tmx.cpu():
        it = wrap(tiop, _iter(cache, device_feed=True))
    ref = wrap(jiop, jic.CachedImageRecordIter(cache, (3, CROP, CROP), BATCH,
                                               **_kw(device_feed=True)))
    for b, r in zip(it, ref):
        assert b.aug is not None and b.data[0].dtype == np.uint8
        np.testing.assert_array_equal(b.data[0].asnumpy(),
                                      r.data[0].asnumpy())
        for k in r.aug:
            np.testing.assert_array_equal(np.asarray(b.aug[k]),
                                          np.asarray(r.aug[k]))
    for w in (it, ref):
        if hasattr(w, "close"):
            w.close()


@pytest.mark.parametrize("fused", [False, True])
def test_feed_scheduler_fit_integration(cache, tel, monkeypatch, fused):
    """fit with MXNET_TPU_FEED_DEPTH=2 over the device feed: bit-equal to
    the eager cached path without the scheduler."""
    want = _fit(cache, fused, device_augment=True)
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "2")
    got = _fit(cache, fused, device_feed=True)
    monkeypatch.delenv("MXNET_TPU_FEED_DEPTH")
    _same(got, want)
    assert telemetry.peek("io.feed.batches") == 2 * (24 // BATCH)
    assert telemetry.peek("io.feed_stall_ms", "hist_sum") is not None


class _SlowIter(DataIter):
    def __init__(self, nbatches=4, delay=0.0):
        super().__init__()
        self.nbatches, self.delay, self.cursor = nbatches, delay, 0
        self.batch_size = 2

    @property
    def provide_data(self):
        return [DataDesc("data", (2, 3))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (2,))]

    def reset(self):
        self.cursor = 0

    def next(self):
        if self.cursor >= self.nbatches:
            raise StopIteration
        if self.delay:
            time.sleep(self.delay)
        i = self.cursor
        self.cursor += 1
        return DataBatch(
            [tmx.nd.array(np.full((2, 3), i, np.float32), ctx=tmx.cpu())],
            [tmx.nd.array(np.zeros(2, np.float32), ctx=tmx.cpu())], 0, None)


def test_feed_scheduler_stall_telemetry(tel):
    with tmx.cpu():
        sched = tiop.FeedScheduler(_SlowIter(nbatches=3, delay=0.05),
                                   depth=1)
    for _ in sched:
        pass
    sched.close()
    assert telemetry.peek("io.feed_stall_ms", "hist_sum") > 50.0
    assert telemetry.peek("io.feed.batches") == 3
