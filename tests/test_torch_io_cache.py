"""The port's decoded-image cache (mxnet_tpu_torch/io_cache.py) against the
JAX package's (mxnet_tpu/io_cache.py), on the CPU, the cases of
tests/test_io_cache.py: the builds are byte-identical and each package
reads the other's cache; the iterators' orders, crops, mirrors, labels
and normalised values are bit-equal in every mode and layout; sharding,
the wrapped last batch, the build lock, rebuilds and ``aug_replicas``
behave as the reference's; a small convolutional net trained from the
cache agrees with the JAX package's within the bound of
tests/test_torch_train.py (rtol 1e-5 / atol 1e-6)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io_cache as jic
from mxnet_tpu import recordio as rio
from mxnet_tpu_torch import io_cache as tic
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"host": {}, "host_numpy": {"device_normalize": False},
         "device_augment": {"device_augment": True},
         "device_feed": {"device_feed": True}}


def _write_rec(path, num=24, size=40):
    rng = np.random.RandomState(3)
    w = rio.MXRecordIO(str(path), "w")
    for i in range(num):
        img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
        w.write(rio.pack_img(rio.IRHeader(0, float(i % 5), i, 0), img,
                             quality=95))
    w.close()


@pytest.fixture()
def cache(tmp_path):
    rec = tmp_path / "t.rec"
    _write_rec(rec)
    prefix = str(tmp_path / "t.cache")
    meta = tic.build_decoded_cache(str(rec), prefix, (3, 32, 32),
                                   preprocess_threads=4)
    return prefix, meta


def _titer(prefix, *args, **kw):
    with tmx.cpu():
        return tic.CachedImageRecordIter(prefix, *args, **kw)


def _batches(it, n=None):
    out = []
    for k, b in enumerate(it):
        item = {"data": b.data[0].asnumpy().copy(),
                "label": b.label[0].asnumpy().copy(), "pad": b.pad,
                "index": np.asarray(b.index).copy()}
        aug = getattr(b, "aug", None)
        if aug is not None:
            item["aug"] = {k2: np.asarray(v) for k2, v in aug.items()}
        out.append(item)
        if n is not None and k + 1 == n:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["data"].dtype == w["data"].dtype
        np.testing.assert_array_equal(g["data"], w["data"])
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["index"], w["index"])
        assert g["pad"] == w["pad"]
        assert ("aug" in g) == ("aug" in w)
        for k in w.get("aug", {}):
            np.testing.assert_array_equal(g["aug"][k], w["aug"][k], err_msg=k)


def test_build_and_meta(cache):
    prefix, meta = cache
    assert meta["num"] == 24 and meta["height"] == 32
    data = np.load(prefix + ".data", mmap_mode="r")
    labels = np.load(prefix + ".label", mmap_mode="r")
    assert data.shape == (24, 32, 32, 3) and data.dtype == np.uint8
    assert labels.shape == (24, 1)
    np.testing.assert_allclose(sorted(labels[:, 0].tolist()),
                               sorted([float(i % 5) for i in range(24)]))


def test_builds_are_byte_identical_across_the_packages(tmp_path):
    rec = tmp_path / "t.rec"
    _write_rec(rec)
    mj = jic.build_decoded_cache(str(rec), str(tmp_path / "j"), (3, 36, 36))
    mt = tic.build_decoded_cache(str(rec), str(tmp_path / "t"), (3, 36, 36))
    assert mj == mt
    for ext in (".data", ".label", ".meta.json"):
        with open(str(tmp_path / "j") + ext, "rb") as a, \
                open(str(tmp_path / "t") + ext, "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_each_package_reads_the_others_cache(tmp_path, builder):
    """A cache built by one package is fresh for the other (no rebuild)
    and both iterate it to the same batches."""
    rec = tmp_path / "t.rec"
    _write_rec(rec)
    prefix = str(tmp_path / "c")
    first, second = (jic, tic) if builder == "jax" else (tic, jic)
    meta = first.build_decoded_cache(str(rec), prefix, (3, 32, 32))
    before = os.path.getmtime(prefix + ".data")
    assert second.build_decoded_cache(str(rec), prefix, (3, 32, 32)) == meta
    assert os.path.getmtime(prefix + ".data") == before
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=4,
              scale=1 / 255.0)
    _same_batches(_batches(_titer(prefix, (3, 28, 28), 8, **kw)),
                  _batches(jic.CachedImageRecordIter(prefix, (3, 28, 28), 8,
                                                     **kw)))


def test_build_is_idempotent(cache, tmp_path):
    prefix, meta = cache
    before = os.path.getmtime(prefix + ".data")
    meta2 = tic.build_decoded_cache(str(tmp_path / "t.rec"), prefix,
                                    (3, 32, 32))
    assert meta2 == meta
    assert os.path.getmtime(prefix + ".data") == before


def test_center_crop_matches_stored(cache):
    prefix, _ = cache
    batch = next(_titer(prefix, (3, 28, 28), 8, shuffle=False,
                        scale=1 / 255.0))
    data = np.load(prefix + ".data", mmap_mode="r")
    want = data[:8, 2:30, 2:30].astype(np.float32) / 255.0
    np.testing.assert_allclose(batch.data[0].asnumpy(),
                               want.transpose(0, 3, 1, 2), rtol=1e-6)
    labels = np.load(prefix + ".label", mmap_mode="r")
    np.testing.assert_array_equal(batch.label[0].asnumpy(), labels[:8, 0])


def test_device_augment_matches_host_when_deterministic(cache):
    prefix, _ = cache
    kw = dict(shuffle=False, rand_crop=False, rand_mirror=False,
              scale=1 / 255.0, mean_r=10.0, mean_g=5.0, mean_b=1.0)
    host = _titer(prefix, (3, 28, 28), 8, device_normalize=False, **kw)
    dev = _titer(prefix, (3, 28, 28), 8, device_augment=True, **kw)
    np.testing.assert_allclose(next(host).data[0].asnumpy(),
                               next(dev).data[0].asnumpy(), rtol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_batches_equal_the_jax_iterators(cache, mode, layout):
    """Shuffled, random crops and mirrors, a mean and a scale, two epochs:
    every batch bit-equal to the JAX package's (the device-feed frames and
    aug values too)."""
    prefix, _ = cache
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=7,
              scale=1 / 255.0, mean_r=10.0, mean_g=5.0, mean_b=1.0,
              output_layout=layout, **MODES[mode])
    t = _titer(prefix, (3, 28, 28), 8, **kw)
    j = jic.CachedImageRecordIter(prefix, (3, 28, 28), 8, **kw)
    for _ in range(2):
        _same_batches(_batches(t), _batches(j))
        t.reset()
        j.reset()


def test_random_augment_modes_produce_valid_crops(cache):
    prefix, _ = cache
    for mode_kw in (dict(), dict(device_augment=True)):
        it = _titer(prefix, (3, 28, 28), 8, shuffle=True, rand_crop=True,
                    rand_mirror=True, scale=1 / 255.0, seed=7, **mode_kw)
        seen = []
        for _ in range(2):
            x = next(it).data[0].asnumpy()
            assert x.shape == (8, 3, 28, 28)
            assert 0.0 <= x.min() and x.max() <= 1.0
            seen.append(x)
        assert not np.array_equal(seen[0], seen[1])


def test_epoch_reshuffle_is_deterministic_and_equals_jax(cache):
    prefix, _ = cache
    a = _titer(prefix, (3, 32, 32), 8, seed=5)
    b = _titer(prefix, (3, 32, 32), 8, seed=5)
    j = jic.CachedImageRecordIter(prefix, (3, 32, 32), 8, seed=5)
    for it in (a, b, j):
        it.reset()
    first = next(a).index
    np.testing.assert_array_equal(first, next(b).index)
    np.testing.assert_array_equal(first, next(j).index)
    a.reset()
    order2 = next(a).index
    assert not np.array_equal(order2, first)
    b.reset()
    np.testing.assert_array_equal(order2, next(b).index)


def test_shards_are_disjoint_and_cover(cache):
    prefix, _ = cache
    seen = []
    for part in range(3):
        it = _titer(prefix, (3, 32, 32), 4, shuffle=False, num_parts=3,
                    part_index=part)
        ref = jic.CachedImageRecordIter(prefix, (3, 32, 32), 4,
                                        shuffle=False, num_parts=3,
                                        part_index=part)
        np.testing.assert_array_equal(it._indices, ref._indices)
        seen.append(set(it._indices.tolist()))
    assert set().union(*seen) == set(range(24))
    assert sum(len(s) for s in seen) == 24


def _lenet_cache(tmp_path):
    rng = np.random.RandomState(0)
    rec = tmp_path / "c.rec"
    w = rio.MXRecordIO(str(rec), "w")
    for i in range(32):
        label = i % 2
        lo, hi = (0, 110) if label == 0 else (145, 255)
        img = rng.randint(lo, hi, (40, 40, 3)).astype(np.uint8)
        w.write(rio.pack_img(rio.IRHeader(0, float(label), i, 0), img,
                             quality=95))
    w.close()
    prefix = str(tmp_path / "c.cache")
    tic.build_decoded_cache(str(rec), prefix, (3, 32, 32))
    return prefix


def _lenet(pkg):
    with pkg.name.NameManager():
        net = pkg.sym.Variable("data")
        net = pkg.sym.Convolution(net, num_filter=4, kernel=(3, 3))
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=2)
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_trains_lenet_from_cache_as_jax_does(tmp_path):
    """Module.fit from the cached iterator (random crops and mirrors,
    centred normalisation), 3 epochs from the same seeded weights through
    both packages: params within rtol 1e-5 / atol 1e-6; then the port's
    run to 8 epochs scores >= 0.9, as the reference's test asks."""
    prefix = _lenet_cache(tmp_path)
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=1,
              mean_r=127.5, mean_g=127.5, mean_b=127.5, scale=1 / 127.5)
    shapes, _, _ = _lenet(tmx).infer_shape(data=(8, 3, 28, 28),
                                           softmax_label=(8,))
    rng = np.random.RandomState(2)
    init = {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in zip(_lenet(tmx).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    opt = {"learning_rate": 0.003}
    jmod = jmx.mod.Module(_lenet(jmx), context=jmx.cpu())
    jmod.fit(jic.CachedImageRecordIter(prefix, (3, 28, 28), 8, **kw),
             num_epoch=3, initializer=None, optimizer_params=opt,
             arg_params={k: jmx.nd.array(v) for k, v in init.items()})
    tit = _titer(prefix, (3, 28, 28), 8, **kw)
    tmod = tmx.mod.Module(_lenet(tmx), context=tmx.cpu())
    tmod.fit(tit, num_epoch=3, initializer=None, optimizer_params=opt,
             arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                         for k, v in init.items()})
    want, got = jmod.get_params()[0], tmod.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    tmod.fit(tit, num_epoch=8, begin_epoch=3, optimizer_params=opt)
    tit.reset()
    acc = dict(tmod.score(tit, tmx.metric.Accuracy()))["accuracy"]
    assert acc >= 0.9, acc


def test_crop_larger_than_store_raises(cache):
    prefix, _ = cache
    with pytest.raises(MXNetError, match="rebuild the cache"):
        _titer(prefix, (3, 64, 64), 4)


def test_shape_mismatch_rebuilds_cache(cache, tmp_path):
    prefix, meta = cache
    meta2 = tic.build_decoded_cache(str(tmp_path / "t.rec"), prefix,
                                    (3, 36, 36))
    assert (meta2["height"], meta2["width"]) == (36, 36)
    assert np.load(prefix + ".data", mmap_mode="r").shape == (24, 36, 36, 3)


def test_output_layout_nhwc_matches_nchw(cache):
    prefix, _ = cache
    kw = dict(shuffle=False, scale=1 / 255.0)
    for aug in (dict(), dict(device_augment=True)):
        nchw = _titer(prefix, (3, 28, 28), 8, **kw, **aug)
        nhwc = _titer(prefix, (3, 28, 28), 8, output_layout="NHWC", **kw,
                      **aug)
        assert nhwc.provide_data[0].shape == (8, 28, 28, 3)
        np.testing.assert_array_equal(
            next(nchw).data[0].asnumpy(),
            next(nhwc).data[0].asnumpy().transpose(0, 3, 1, 2))


def test_registered_in_iterator_registry(cache):
    """MXDataIter builds it by name, as the JAX package's registry
    does, and the iterator protocol rewinds at reset."""
    prefix, _ = cache
    with tmx.cpu():
        it = tmx.io.MXDataIter("CachedImageRecordIter", cache_prefix=prefix,
                               data_shape=(3, 28, 28), batch_size=4,
                               shuffle=False)
    assert isinstance(it, tic.CachedImageRecordIter)
    assert it.iter_next()
    assert tuple(it.getdata()[0].shape) == (4, 3, 28, 28)
    assert it.getlabel()[0].shape[0] == 4
    it.reset()
    assert it.iter_next()


def test_rebuild_on_source_change(cache, tmp_path):
    import time

    prefix, _ = cache
    rec = tmp_path / "t.rec"
    _write_rec(rec, num=30)
    os.utime(rec, (time.time() + 5, time.time() + 5))
    meta2 = tic.build_decoded_cache(str(rec), prefix, (3, 32, 32))
    assert meta2["num"] == 30
    assert np.load(prefix + ".data", mmap_mode="r").shape[0] == 30


def test_concurrent_builders_single_winner(tmp_path):
    """Three processes, two of the port and one of the JAX package, on one
    prefix: one cache, every process sees 24 records, no lock left."""
    rec = tmp_path / "t.rec"
    _write_rec(rec)
    prefix = str(tmp_path / "t.cache")
    script = ("import sys; sys.path.insert(0, %r)\n"
              "from %s import io_cache as ic\n"
              "m = ic.build_decoded_cache(%r, %r, (3, 32, 32),"
              " preprocess_threads=2)\n"
              "print('NUM=%%d' %% m['num'])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script % (ROOT, pkg, str(rec), prefix)],
        stdout=subprocess.PIPE, text=True, env=env)
        for pkg in ("mxnet_tpu_torch", "mxnet_tpu", "mxnet_tpu_torch")]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("NUM=24" in o for o in outs), outs
    assert not os.path.exists(prefix + ".build.lock")
    assert np.load(prefix + ".data", mmap_mode="r").shape == (24, 32, 32, 3)


def test_cache_survives_source_deletion(cache, tmp_path):
    prefix, meta = cache
    os.unlink(str(tmp_path / "t.rec"))
    meta2 = tic.build_decoded_cache(str(tmp_path / "t.rec"), prefix,
                                    (3, 32, 32))
    assert meta2["num"] == meta["num"]
    with pytest.raises(MXNetError, match="no recordio"):
        tic.build_decoded_cache(str(tmp_path / "gone.rec"),
                                str(tmp_path / "other.cache"), (3, 32, 32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_partial_batch_wraps_and_reports_pad(cache, mode):
    """24 records, batch 7: 4 batches, the last wraps 4 samples to the
    epoch's start and reports them through getpad(), in every mode; the
    JAX package's batches are the same."""
    prefix, _ = cache
    t = _titer(prefix, (3, 32, 32), 7, shuffle=False, **MODES[mode])
    batches = _batches(t)
    assert [b["pad"] for b in batches] == [0, 0, 0, 4]
    assert batches[-1]["data"].shape[0] == 7
    seen = np.concatenate([b["index"] for b in batches])
    counts = np.bincount(seen, minlength=24)
    assert counts.sum() == 28 and (counts >= 1).all()
    with pytest.raises(StopIteration):
        next(t)
    _same_batches(batches, _batches(jic.CachedImageRecordIter(
        prefix, (3, 32, 32), 7, shuffle=False, **MODES[mode])))


def test_partial_batch_warns_on_mismatch(cache, caplog):
    import logging

    prefix, _ = cache
    with caplog.at_level(logging.WARNING):
        _titer(prefix, (3, 32, 32), 7)
    assert any("not a multiple of batch_size" in r.message
               for r in caplog.records)


def test_partial_batch_device_augment(cache):
    prefix, _ = cache
    batches = list(_titer(prefix, (3, 28, 28), 9, shuffle=True,
                          rand_crop=True, device_augment=True, seed=2,
                          scale=1 / 255.0))
    assert len(batches) == 3
    assert batches[-1].pad == 3
    assert batches[-1].data[0].shape == (9, 3, 28, 28)


def test_failed_build_cleans_tmp_files(tmp_path, monkeypatch):
    rec = tmp_path / "t.rec"
    _write_rec(rec, num=8)
    prefix = str(tmp_path / "t.cache")
    real = tic._decode_record
    calls = []

    def boom(rec_bytes, store_hw, channels):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("decoder crashed")
        return real(rec_bytes, store_hw, channels)

    monkeypatch.setattr(tic, "_decode_record", boom)
    with pytest.raises(RuntimeError, match="decoder crashed"):
        tic.build_decoded_cache(str(rec), prefix, (3, 32, 32),
                                preprocess_threads=1)
    leftovers = [f for f in os.listdir(tmp_path)
                 if ".tmp." in f or f.endswith(".build.lock")]
    assert leftovers == []
    assert not os.path.exists(prefix + ".meta.json")
    monkeypatch.undo()
    meta = tic.build_decoded_cache(str(rec), prefix, (3, 32, 32),
                                   preprocess_threads=1)
    assert meta["num"] == 8


def test_stale_lock_from_dead_builder_is_broken(tmp_path):
    rec = tmp_path / "t.rec"
    _write_rec(rec, num=8)
    prefix = str(tmp_path / "t.cache")
    lock = prefix + ".build.lock"
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    with open(lock, "w") as f:
        f.write("%s:%d" % (socket.gethostname(), child.pid))
    meta = tic.build_decoded_cache(str(rec), prefix, (3, 32, 32),
                                   preprocess_threads=1)
    assert meta["num"] == 8
    assert not os.path.exists(lock)


def test_live_lock_is_respected(tmp_path, monkeypatch):
    rec = tmp_path / "t.rec"
    _write_rec(rec, num=8)
    prefix = str(tmp_path / "t.cache")
    lock = prefix + ".build.lock"
    with open(lock, "w") as f:
        f.write("%s:%d" % (socket.gethostname(), os.getpid()))
    monkeypatch.setenv("MXTPU_CACHE_BUILD_TIMEOUT", "0.1")
    try:
        with pytest.raises(MXNetError, match="timed out waiting"):
            tic.build_decoded_cache(str(rec), prefix, (3, 32, 32))
    finally:
        os.unlink(lock)


def test_composes_with_prefetching_iter(cache):
    prefix, _ = cache
    base = _titer(prefix, (3, 28, 28), 8, shuffle=True, rand_crop=True,
                  scale=1 / 255.0, seed=3)
    it = tmx.io.PrefetchingIter(base)
    try:
        n = 0
        for b in it:
            assert b.data[0].shape == (8, 3, 28, 28)
            n += 1
        assert n == 3
        it.reset()
        assert next(it).data[0].shape == (8, 3, 28, 28)
    finally:
        it.close()


def test_aug_replicas_draw_independent_streams(cache):
    prefix, _ = cache
    it = _titer(prefix, (3, 24, 24), 8, rand_crop=True, rand_mirror=True,
                seed=7, aug_replicas=4)
    ref = jic.CachedImageRecordIter(prefix, (3, 24, 24), 8, rand_crop=True,
                                    rand_mirror=True, seed=7, aug_replicas=4)
    tops, lefts, mirror = it._aug_params(32, 32, 24, 24)
    for x, y in zip((tops, lefts, mirror), ref._aug_params(32, 32, 24, 24)):
        np.testing.assert_array_equal(x, y)
    assert tops.shape == lefts.shape == mirror.shape == (8,)
    shards = [(tuple(tops[i:i + 2]), tuple(lefts[i:i + 2]))
              for i in range(0, 8, 2)]
    assert len(set(shards)) > 1
    assert np.array_equal(tops, it._aug_params(32, 32, 24, 24)[0])
    it.cursor += it.batch_size
    assert not np.array_equal(tops, it._aug_params(32, 32, 24, 24)[0])


def test_aug_replicas_r1_matches_single_stream(cache, monkeypatch):
    prefix, _ = cache
    monkeypatch.setenv("MXNET_TPU_AUG_REPLICAS", "1")
    a = _titer(prefix, (3, 24, 24), 8, rand_crop=True, rand_mirror=True,
               seed=9)
    monkeypatch.delenv("MXNET_TPU_AUG_REPLICAS")
    b = _titer(prefix, (3, 24, 24), 8, rand_crop=True, rand_mirror=True,
               seed=9, aug_replicas=1)
    assert a.aug_replicas == b.aug_replicas == 1
    for x, y in zip(a._aug_params(32, 32, 24, 24),
                    b._aug_params(32, 32, 24, 24)):
        assert np.array_equal(x, y)


def test_aug_replicas_must_divide_batch(cache):
    prefix, _ = cache
    with pytest.raises(MXNetError):
        _titer(prefix, (3, 24, 24), 8, aug_replicas=3)


@pytest.mark.parametrize("mode", ["host", "device_feed"])
def test_checkpoint_seek_reproduces_the_next_batch(cache, mode):
    """A fresh iterator seeked to (epoch 1, 2 batches consumed) hands out
    the uninterrupted run's next batch bit for bit, aug values too."""
    prefix, _ = cache
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=3,
              scale=1 / 255.0, **MODES[mode])
    it = _titer(prefix, (3, 28, 28), 8, **kw)
    _batches(it)
    it.reset()
    _batches(it, 2)
    state = it.get_checkpoint_state()
    assert state == jic.CachedImageRecordIter(
        prefix, (3, 28, 28), 8, **kw).get_checkpoint_state() | {"epoch": 1}
    want = _batches(it)
    fresh = _titer(prefix, (3, 28, 28), 8, **kw)
    fresh.set_checkpoint_state(dict(state, batches=2))
    _same_batches(_batches(fresh), want)
