"""Image record data of the port on the CPU against the JAX package:
``.rec``/``.idx`` files written by one package and read by the other
byte for byte, ``pack``/``unpack``, ``ImageRecordIter`` batch for batch
(bit-equal) under each augmentation, sharding, shuffling, padding, a
second epoch, a mean image computed by one package and loaded by the
other, and 1 against 4 decode threads; ``ResizeIter``,
``PrefetchingIter`` and ``MXDataIter`` batch for batch. The records are
written with PIL here, from seeded numpy images."""
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.recordio as jrio
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.recordio as trio

N_RECORDS = 10
BATCH = 4


def _payloads(rng, n):
    return [rng.bytes(int(rng.randint(0, 37))) for _ in range(n)]


def _labels(i, width):
    return float(i % 7) if width == 1 else [float(i % 7), float(i) * 0.5]


def _write_indexed(rio, rec, idx, payloads):
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(payloads):
        width = 1 if i % 2 else 2
        w.write_idx(i, rio.pack(rio.IRHeader(0, _labels(i, width), i, 0),
                                p))
    w.close()


def test_rec_and_idx_files_cross_byte_for_byte(tmp_path):
    """The same records written by each package give identical .rec and
    .idx bytes; each package reads the other's file sequentially and by
    key, payload and header alike."""
    payloads = _payloads(np.random.RandomState(0), 9)
    paths = {}
    for name, rio in (("jax", jrio), ("port", trio)):
        rec, idx = str(tmp_path / (name + ".rec")), \
            str(tmp_path / (name + ".idx"))
        _write_indexed(rio, rec, idx, payloads)
        paths[name] = (rec, idx)
    for k in (0, 1):
        with open(paths["jax"][k], "rb") as a, open(paths["port"][k],
                                                    "rb") as b:
            assert a.read() == b.read()
    for reader, (rec, idx) in ((trio, paths["jax"]), (jrio, paths["port"])):
        seq = reader.MXRecordIO(rec, "r")
        got = []
        while True:
            r = seq.read()
            if r is None:
                break
            got.append(reader.unpack(r))
        seq.close()
        assert [p for _, p in got] == payloads
        ind = reader.MXIndexedRecordIO(idx, rec, "r")
        assert ind.keys == list(range(len(payloads)))
        for i in (8, 3, 0):
            header, payload = reader.unpack(ind.read_idx(i))
            assert payload == payloads[i]
            assert header.id == i
            np.testing.assert_array_equal(header.label,
                                          _labels(i, 1 if i % 2 else 2))
        ind.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0],
                                   np.arange(5, dtype=np.float32)])
def test_pack_unpack_matches_jax(label):
    """Scalar and vector labels pack to the same bytes and unpack to the
    same header and payload."""
    header = (0, label, 17, 3)
    got = trio.pack(trio.IRHeader(*header), b"payload")
    want = jrio.pack(jrio.IRHeader(*header), b"payload")
    assert got == want
    th, tp = trio.unpack(want)
    jh, jp = jrio.unpack(got)
    assert tp == jp == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(th.label, jh.label)


def test_recordio_refuses_bad_flags_and_magic(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(tmx.MXNetError, match="magic"):
        trio.MXRecordIO(path, "r").read()
    with pytest.raises(tmx.MXNetError, match="invalid flag"):
        trio.MXRecordIO(path, "a")
    w = trio.MXRecordIO(str(tmp_path / "w.rec"), "w")
    with pytest.raises(tmx.MXNetError, match="not opened for reading"):
        w.read()
    w.close()


# ---------------------------------------------------------------------------
# ImageRecordIter
# ---------------------------------------------------------------------------
def _image_records(path, n=N_RECORDS, width=1, seed=0):
    """``n`` records of seeded RGB images of varied sizes (JPEG and PNG),
    packed by the JAX package's ``pack_img``."""
    rng = np.random.RandomState(seed)
    w = jrio.MXRecordIO(path, "w")
    for i in range(n):
        h, wd = int(rng.randint(30, 50)), int(rng.randint(30, 50))
        img = rng.randint(0, 256, (h, wd, 3)).astype(np.uint8)
        w.write(jrio.pack_img(jrio.IRHeader(0, _labels(i, width), i, 0),
                              img, img_fmt=".jpg" if i % 2 else ".png"))
    w.close()
    return path


@pytest.fixture(scope="module")
def rec_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgrec")
    return {1: _image_records(str(d / "w1.rec")),
            2: _image_records(str(d / "w2.rec"), width=2, seed=1)}


def _walk(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype == np.float32
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


CASES = {
    "center_mean_scale": dict(mean_r=123.68, mean_g=116.78, mean_b=103.94,
                              scale=1.0 / 58.0),
    "rand_crop_mirror_resize": dict(rand_crop=True, rand_mirror=True,
                                    resize=40, seed=3),
    "rotate_shear_pad_fill": dict(max_rotate_angle=20, max_shear_ratio=0.2,
                                  pad=4, fill_value=127, rand_crop=True,
                                  seed=4),
    "rotate_list": dict(rotate_list="0,90,180", seed=8),
    "hsl_jitter": dict(random_h=20, random_s=30, random_l=25, seed=5),
    "label_width_2": dict(label_width=2, rand_mirror=True),
    "parts": dict(num_parts=3, part_index=1),
    "shuffle": dict(shuffle=True, seed=7, rand_crop=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_jax(rec_files, case):
    """Two epochs (reset between) of both packages' iterators over one
    file: every batch's data and labels bit-equal, the same pads (the
    last batch wraps around to the first records)."""
    kw = dict(CASES[case], data_shape=(3, 28, 28), batch_size=BATCH)
    path = rec_files[kw.get("label_width", 1)]
    walks = []
    for pkg in (jmx, tmx):
        with pkg.io.ImageRecordIter(path_imgrec=path, **kw) as it:
            walks.append(_walk(it, epochs=2))
            if pkg is tmx:
                assert it.provide_data[0].shape == (BATCH, 3, 28, 28)
                assert it.provide_label[0].shape == \
                    ((BATCH,) if kw.get("label_width", 1) == 1
                     else (BATCH, 2))
    _assert_same_batches(walks[1], walks[0])
    n = len(range(kw.get("part_index", 0), N_RECORDS,
                  kw.get("num_parts", 1)))
    nb = -(-n // BATCH)
    assert [p for _, _, p in walks[1]] == ([0] * (nb - 1)
                                           + [nb * BATCH - n]) * 2
    if kw.get("rand_crop") or kw.get("rand_mirror"):
        # the second epoch draws anew
        k = len(walks[1]) // 2
        assert not np.array_equal(walks[1][0][0], walks[1][k][0])


def test_image_record_iter_greyscale_matches_jax(rec_files):
    kw = dict(data_shape=(1, 24, 24), batch_size=BATCH, rand_crop=True,
              seed=2)
    walks = [_walk(pkg.io.ImageRecordIter(path_imgrec=rec_files[1], **kw))
             for pkg in (jmx, tmx)]
    _assert_same_batches(walks[1], walks[0])


def test_decode_threads_are_bit_equal(rec_files):
    """1 and 4 decode threads, with read-ahead, give the same batches:
    every draw is keyed by (seed, epoch, record)."""
    kw = dict(path_imgrec=rec_files[1], data_shape=(3, 28, 28),
              batch_size=BATCH, rand_crop=True, rand_mirror=True,
              max_rotate_angle=15, random_l=20, seed=9)
    one = _walk(tmx.io.ImageRecordIter(preprocess_threads=1, **kw), 2)
    four = _walk(tmx.io.ImageRecordIter(preprocess_threads=4,
                                        prefetch_buffer=3, **kw), 2)
    _assert_same_batches(four, one)


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_mean_image_crosses_between_packages(rec_files, tmp_path, maker):
    """The mean image computed by one package (float64 sum over every
    record, written atomically in the NDArray container) is read by
    the other, which then gives the same batches."""
    path = str(tmp_path / "mean.nd")
    kw = dict(path_imgrec=rec_files[1], data_shape=(3, 28, 28),
              batch_size=BATCH, mean_img=path, resize=32)
    first, second = (jmx, tmx) if maker == "jax" else (tmx, jmx)
    made = _walk(first.io.ImageRecordIter(**kw))
    assert os.path.isfile(path)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    loaded = _walk(second.io.ImageRecordIter(**kw))
    _assert_same_batches(loaded, made)
    mean = list(tmx.nd.load(path, ctx=tmx.cpu()).values())[0].asnumpy()
    assert mean.shape == (3, 28, 28) and mean.dtype == np.float32
    assert 0 < float(mean.mean()) < 255


def test_decode_counters(rec_files):
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    try:
        it = tmx.io.ImageRecordIter(path_imgrec=rec_files[1],
                                    data_shape=(3, 28, 28),
                                    batch_size=BATCH, preprocess_threads=1)
        assert it.iter_next()
        it.getdata()
        it.getlabel()
        assert tmx.telemetry.peek("io.decoded_records") == BATCH
        assert tmx.telemetry.peek("io.decode_cache_hit") == 1
    finally:
        tmx.telemetry.disable()
        tmx.telemetry.reset()


def test_process_decode_raises(rec_files, monkeypatch):
    """Process decode is not ported: asked for by argument or by
    MXNET_TPU_DECODE_PROCS, the port raises instead of decoding on
    threads."""
    kw = dict(path_imgrec=rec_files[1], data_shape=(3, 28, 28),
              batch_size=BATCH)
    with pytest.raises(tmx.MXNetError, match="Queue A item 9"):
        tmx.io.ImageRecordIter(preprocess_mode="process", **kw)
    monkeypatch.setenv("MXNET_TPU_DECODE_PROCS", "2")
    with pytest.raises(tmx.MXNetError, match="MXNET_TPU_DECODE_PROCS=2"):
        tmx.io.ImageRecordIter(**kw)
    with pytest.raises(tmx.MXNetError, match="thread"):
        tmx.io.ImageRecordIter(preprocess_mode="fork", **kw)


# ---------------------------------------------------------------------------
# ResizeIter, PrefetchingIter, MXDataIter
# ---------------------------------------------------------------------------
def _arrays(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


def _walk_nd(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lb.asnumpy() for lb in b.label], b.pad))
    return out


def _assert_same_walks(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert len(gd) == len(wd) and len(gl) == len(wl) and gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,reset_internal", [(7, True), (2, False)])
def test_resize_iter_matches_jax(size, reset_internal):
    """Stretched past the inner iterator's end (which it resets) or cut
    short, over two epochs."""
    x, y = _arrays()
    walks = [_walk_nd(pkg.io.ResizeIter(
        pkg.io.NDArrayIter(x, y, batch_size=4), size,
        reset_internal=reset_internal), epochs=2) for pkg in (jmx, tmx)]
    _assert_same_walks(walks[1], walks[0])
    assert len(walks[1]) == 2 * size


def test_prefetching_iter_matches_jax():
    """Two iterators joined, renamed, over two epochs (reset restarts the
    producer)."""
    x, y = _arrays()
    x2, y2 = _arrays(seed=1)
    walks, descs = [], []
    for pkg in (jmx, tmx):
        it = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=4),
             pkg.io.NDArrayIter(x2, y2, batch_size=4)],
            rename_data=[{"data": "a"}, {"data": "b"}],
            rename_label=[{"softmax_label": "la"},
                          {"softmax_label": "lb"}])
        walks.append(_walk_nd(it, epochs=2))
        descs.append(([(d.name, tuple(d.shape)) for d in it.provide_data],
                      [(d.name, tuple(d.shape)) for d in it.provide_label]))
        it.close()
    _assert_same_walks(walks[1], walks[0])
    assert descs[1] == descs[0] == ([("a", (4, 3)), ("b", (4, 3))],
                                    [("la", (4,)), ("lb", (4,))])


def test_prefetching_over_resize_matches_the_plain_iterator():
    """PrefetchingIter(ResizeIter(NDArrayIter)), the wrapping chip_smoke
    trains through: the same batches as the plain iterator."""
    x, y = _arrays(12)
    plain = _walk_nd(tmx.io.NDArrayIter(x, y, batch_size=4))
    with tmx.io.PrefetchingIter(tmx.io.ResizeIter(
            tmx.io.NDArrayIter(x, y, batch_size=4), 3)) as it:
        _assert_same_walks(_walk_nd(it), plain)


def _live_producers():
    return [t for t in threading.enumerate()
            if t.name == "PrefetchingIter" and t.is_alive()]


def test_prefetching_close_joins_the_producer():
    x, y = _arrays(40)
    it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, y, batch_size=2),
                                prefetch_depth=1)
    assert it.iter_next()
    assert _live_producers()
    it.close()
    assert not _live_producers()
    assert not it.iter_next()
    it.close()
    it.reset()
    assert len(_walk_nd(it)) == 20
    it.close()


def test_prefetching_exception_mid_epoch_leaves_no_thread():
    x, y = _arrays(40)
    with pytest.raises(RuntimeError, match="mid-epoch"):
        with tmx.io.PrefetchingIter(tmx.io.NDArrayIter(
                x, y, batch_size=2), prefetch_depth=1) as it:
            next(it)
            raise RuntimeError("mid-epoch")
    assert not _live_producers()


def test_prefetch_stall_is_observed():
    x, y = _arrays()
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    try:
        with tmx.io.PrefetchingIter(tmx.io.NDArrayIter(
                x, y, batch_size=4)) as it:
            assert len(_walk_nd(it)) == 3
        hist = tmx.telemetry.histogram("io.prefetch_stall_ms")
        assert hist.count == 4       # three batches and the end marker
    finally:
        tmx.telemetry.disable()
        tmx.telemetry.reset()


def test_mx_data_iter_matches_jax(rec_files, tmp_path):
    """Every registered iterator by name, batch for batch."""
    x, y = _arrays()
    csv = str(tmp_path / "d.csv")
    np.savetxt(csv, x, delimiter=",")
    kws = {"NDArrayIter": dict(data=x, label=y, batch_size=4),
           "CSVIter": dict(data_csv=csv, data_shape=(3,), batch_size=4),
           "ImageRecordIter": dict(path_imgrec=rec_files[1],
                                   data_shape=(3, 28, 28), batch_size=4,
                                   rand_crop=True)}
    for name, kw in kws.items():
        walks = [_walk_nd(pkg.io.MXDataIter(name, **kw))
                 for pkg in (jmx, tmx)]
        _assert_same_walks(walks[1], walks[0])
    assert sorted(n for n, _ in tmx.io._REG.items()) == \
        ["csviter", "imagerecorditer", "mnistiter", "ndarrayiter"]
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tmx.io.MXDataIter("NoSuchIter")
