"""The port's device staging and feed scheduler
(mxnet_tpu_torch/io_pipeline.py) against the JAX package's
(mxnet_tpu/io_pipeline.py), on the CPU, where a staged batch is a copy:
both packages' wrappers yield the base iterator's batches in order,
across a reset and after a seek that drops the read-ahead; the fit-loop
hooks wrap as the JAX package's do; and fit with staging or a feed depth
leaves the params bit-equal to fit without. Process decode (the shared-
memory store and ring, spawned workers) gives the thread decode's and
the JAX package's process decode's batches bit for bit, and falls back
to in-process decode when a worker dies or the pipeline cannot start."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io_pipeline as jiop
from mxnet_tpu_torch import io_pipeline as tiop

from test_torch_common import CKPT_BATCH, ckpt_data, ckpt_mlp, ckpt_params

WRAPPERS = {
    "staging": lambda iop, base: iop.DeviceStagingIter(base),
    "feed1": lambda iop, base: iop.FeedScheduler(base, depth=1),
    "feed2": lambda iop, base: iop.FeedScheduler(base, depth=2),
    "feed4": lambda iop, base: iop.FeedScheduler(base, depth=4),
}


def _base(pkg, nbatches=5):
    x, y = ckpt_data(nbatches)
    return pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)


def _wrap(pkg, iop, kind, nbatches=5):
    base = _base(pkg, nbatches)
    if pkg is tmx:
        with tmx.cpu():
            return WRAPPERS[kind](iop, base)
    return WRAPPERS[kind](iop, base)


def _epoch(it, n=None):
    out = []
    for k, b in enumerate(it):
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                    b.pad))
        if n is not None and k + 1 == n:
            break
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (xa, ya, pa), (xb, yb, pb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert pa == pb


@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_wrapper_yields_the_base_batches_in_order(kind):
    """Every batch of the epoch, in order, then again after a reset; the
    JAX package's wrapper yields the same."""
    plain = _epoch(_base(tmx))
    it = _wrap(tmx, tiop, kind)
    _same(_epoch(it), plain)
    it.reset()
    _same(_epoch(it), plain)
    _same(_epoch(_wrap(jmx, jiop, kind)), plain)
    assert it.provide_data == _base(tmx).provide_data
    if hasattr(it, "close"):
        it.close()


@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_seek_drops_the_read_ahead(kind):
    """Two batches taken (and more staged ahead), then a seek to one
    batch consumed: the next batches are the base's from batch 1 on, as
    in the JAX package; the checkpoint state is the base's."""
    got = []
    for pkg, iop in ((jmx, jiop), (tmx, tiop)):
        it = _wrap(pkg, iop, kind)
        _epoch(it, 2)
        assert it.get_checkpoint_state() == \
            _base(pkg).get_checkpoint_state()
        it.set_checkpoint_state({"batches": 1})
        got.append(_epoch(it))
    _same(got[1], got[0])
    _same(got[1], _epoch(_base(tmx))[1:])


@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_wrapper_keeps_the_batchs_aug(kind):
    """A device-feed batch's ``aug`` (its deferred crop and normalisation)
    survives staging, in both packages' wrappers: a staged batch without
    it would hand the model raw frames."""
    class WithAug(tmx.io.DataIter):
        def __init__(self, pkg):
            super().__init__()
            self.base = _base(pkg)
            self.batch_size = self.base.batch_size

        @property
        def provide_data(self):
            return self.base.provide_data

        @property
        def provide_label(self):
            return self.base.provide_label

        def reset(self):
            self.base.reset()

        def next(self):
            b = self.base.next()
            b.aug = {"tops": np.arange(CKPT_BATCH, dtype=np.int32)}
            return b

    for pkg, iop in ((jmx, jiop), (tmx, tiop)):
        ctx = tmx.cpu() if pkg is tmx else jmx.cpu()
        with ctx:
            it = WRAPPERS[kind](iop, WithAug(pkg))
        batches = list(it)
        assert len(batches) == 5
        for b in batches:
            np.testing.assert_array_equal(b.aug["tops"],
                                          np.arange(CKPT_BATCH))
        if hasattr(it, "close"):
            it.close()


def test_feed_scheduler_under_thread_switching_keeps_the_order():
    """Stress: a switch interval of 1 us, depth 1 and 3, three epochs
    each with a seek in the middle: every batch arrives once, in order,
    and no worker outlives close()."""
    import sys
    import threading

    plain = _epoch(_base(tmx, 8))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 3):
            with tmx.cpu():
                it = tiop.FeedScheduler(_base(tmx, 8), depth=depth)
            for _ in range(3):
                it.reset()
                _same(_epoch(it, 3), plain[:3])
                it.set_checkpoint_state({"batches": 5})
                _same(_epoch(it), plain[5:])
            thread = it._thread
            it.close()
            assert thread is None or not thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threading.enumerate()
                if t.name == "mxtpu-feed-scheduler"]


def test_worker_error_surfaces_on_next():
    class Broken(tmx.io.DataIter):
        provide_data = provide_label = []

        def next(self):
            raise ValueError("decode failed")

    with tmx.cpu():
        it = tiop.FeedScheduler(Broken(), depth=2)
    with pytest.raises(ValueError, match="decode failed"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_maybe_wrap_hooks(monkeypatch):
    """Off without the variables; DEVICE_STAGING wraps once (idempotent);
    FEED_DEPTH wraps in a FeedScheduler, unwrapping a staging wrapper; as
    the JAX package's hooks do."""
    monkeypatch.delenv("MXNET_TPU_DEVICE_STAGING", raising=False)
    monkeypatch.delenv("MXNET_TPU_FEED_DEPTH", raising=False)
    for pkg, iop in ((jmx, jiop), (tmx, tiop)):
        ctx = tmx.cpu() if pkg is tmx else jmx.cpu()
        with ctx:
            base = _base(pkg)
            assert iop.maybe_wrap_device_staging(base) is base
            assert iop.maybe_wrap_feed_scheduler(base) is base
            monkeypatch.setenv("MXNET_TPU_DEVICE_STAGING", "1")
            staged = iop.maybe_wrap_device_staging(base)
            assert isinstance(staged, iop.DeviceStagingIter)
            assert iop.maybe_wrap_device_staging(staged) is staged
            monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "3")
            fed = iop.maybe_wrap_feed_scheduler(staged)
            assert isinstance(fed, iop.FeedScheduler)
            assert fed.base is base and fed.depth == 3
            assert iop.maybe_wrap_device_staging(fed) is fed
            fed.close()
        monkeypatch.delenv("MXNET_TPU_DEVICE_STAGING")
        monkeypatch.delenv("MXNET_TPU_FEED_DEPTH")


def test_staging_and_feed_telemetry():
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    try:
        _epoch(_wrap(tmx, tiop, "staging"))
        it = _wrap(tmx, tiop, "feed2")
        _epoch(it)
        it.close()
        snap = tmx.telemetry.snapshot()["io"]
        assert snap["staging"]["batches"] == 10
        assert snap["staging"]["h2d_ms"]["count"] == 10
        assert snap["feed"]["batches"] == 5
        assert snap["feed_stall_ms"]["count"] == 6   # five and the end
        assert "in_flight" in snap["feed"]
    finally:
        tmx.telemetry.disable()
        tmx.telemetry.reset()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("staging,depth", [("1", "0"), ("0", "2"),
                                           ("1", "3")])
def test_fit_with_staging_is_bit_equal(fused, staging, depth, monkeypatch):
    """fit with MXNET_TPU_DEVICE_STAGING and/or MXNET_TPU_FEED_DEPTH over
    two epochs gives the params of fit without, bit for bit, and the
    feed scheduler's worker is stopped when fit returns."""
    import threading

    def run():
        net = ckpt_mlp(tmx)
        x, y = ckpt_data(6)
        mod = tmx.mod.Module(net, context=tmx.cpu())
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=2, initializer=None, fused_step=fused,
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in ckpt_params(net).items()},
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    monkeypatch.delenv("MXNET_TPU_DEVICE_STAGING", raising=False)
    monkeypatch.delenv("MXNET_TPU_FEED_DEPTH", raising=False)
    want = run()
    monkeypatch.setenv("MXNET_TPU_DEVICE_STAGING", staging)
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", depth)
    got = run()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not [t for t in threading.enumerate()
                if t.name == "mxtpu-feed-scheduler"]


# -- process decode into the shared-memory ring --------------------------------
import threading

import mxnet_tpu.io as jio
import mxnet_tpu.recordio as jrio
import mxnet_tpu_torch.io as tio

AUG = dict(rand_crop=True, rand_mirror=True, max_rotate_angle=15,
           random_h=20, random_s=20, random_l=20, scale=1.0 / 255)


def _make_rec(tmp_path, n=24, size=16, name="p.rec"):
    path = str(tmp_path / name)
    rng = np.random.RandomState(0)
    w = jrio.MXRecordIO(path, "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        w.write(jrio.pack_img(jrio.IRHeader(0, float(i % 5), i, 0), img,
                              quality=100, img_fmt=".png"))
    w.close()
    return path


def _records(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy()))
    return out


def _with_timeout(fn, seconds=120):
    """Run ``fn`` on a daemon thread: a hang fails the test instead of
    wedging the run."""
    result = {}

    def run():
        try:
            fn()
        except BaseException as e:
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "timed out after %ds" % seconds
    if "error" in result:
        raise result["error"]


def _record_iter(path, **kw):
    args = dict(path_imgrec=path, data_shape=(3, 12, 12), batch_size=8,
                seed=5, **AUG)
    args.update(kw)
    return tio.ImageRecordIter(**args)


def test_shm_record_store_roundtrip():
    recs = [b"alpha", b"", b"x" * 1000, b"tail"]
    store = tiop.ShmRecordStore.create(recs)
    try:
        att = tiop.ShmRecordStore.attach(store.name)
        assert len(att) == len(recs)
        assert [att.get(i) for i in range(len(recs))] == recs
        att.close()
    finally:
        store.close()


def test_shm_batch_ring_views():
    ring = tiop.ShmBatchRing(num_slots=2, batch_size=3, data_shape=(3, 4, 4),
                             label_width=1)
    try:
        ring.img_view(0)[:] = 7.0
        ring.label_view(1)[:] = 2.0
        att = tiop.ShmBatchRing.attach(ring.meta())
        np.testing.assert_array_equal(att.img_view(0),
                                      np.full((3, 3, 4, 4), 7.0, np.float32))
        np.testing.assert_array_equal(att.label_view(1),
                                      np.full((3, 1), 2.0, np.float32))
        att.close()
    finally:
        ring.close()


def test_decoder_config_rebuilds_the_decoder():
    dec = tio.RecordDecoder(data_shape=(3, 12, 12), seed=4, rand_crop=True,
                            max_rotate_angle=10, mean=[1.0, 2.0, 3.0])
    cfg = dec.config()
    again = tio.RecordDecoder(**cfg)
    assert again.config().keys() == jio.RecordDecoder(
        data_shape=(3, 12, 12)).config().keys()
    np.testing.assert_array_equal(again.mean, dec.mean)


def test_process_decode_matches_thread_and_jax(tmp_path):
    """Two spawned workers over the shared-memory ring, two epochs: bit-
    equal to the port's thread decode and to the JAX package's process
    decode, with no fallback."""
    path = _make_rec(tmp_path)

    def body():
        a = _record_iter(path, preprocess_threads=1)
        c = _record_iter(path, preprocess_threads=2,
                         preprocess_mode="process")
        j = jio.ImageRecordIter(path_imgrec=path, data_shape=(3, 12, 12),
                                batch_size=8, seed=5, preprocess_threads=2,
                                preprocess_mode="process", **AUG)
        with a, c, j:
            for _ in range(2):
                want = _records(a)
                got = _records(c)
                ref = _records(j)
                assert len(got) == len(want) == len(ref) == 3
                for (da, la), (dc, lc), (dj, lj) in zip(want, got, ref):
                    np.testing.assert_array_equal(dc, da)
                    np.testing.assert_array_equal(lc, la)
                    np.testing.assert_array_equal(dc, dj)
                    np.testing.assert_array_equal(lc, lj)
                for it in (a, c, j):
                    it.reset()
            assert c.preprocess_mode == "process"

    _with_timeout(body)


def test_process_worker_crash_falls_back(tmp_path):
    """Every worker killed mid-epoch: the iterator decodes in process
    from there on, with the same batches, never a hang
    (``io.pipeline.worker_crashes`` and ``io.pipeline.fallbacks``)."""
    path = _make_rec(tmp_path, n=96)

    def body():
        tmx.telemetry.reset()
        tmx.telemetry.enable()
        try:
            a = _record_iter(path, preprocess_threads=1)
            c = _record_iter(path, preprocess_threads=2,
                             preprocess_mode="process")
            with a, c:
                it_a, it_c = iter(a), iter(c)
                np.testing.assert_array_equal(
                    next(it_a).data[0].asnumpy(),
                    next(it_c).data[0].asnumpy())
                for p in c._proc_pipe._procs:
                    p.terminate()
                for p in c._proc_pipe._procs:
                    p.join()
                served = 1
                for bc in it_c:
                    np.testing.assert_array_equal(
                        next(it_a).data[0].asnumpy(), bc.data[0].asnumpy())
                    served += 1
                assert served == 12
                assert c.preprocess_mode == "thread"
            assert tmx.telemetry.peek("io.pipeline.worker_crashes") == 1
            assert tmx.telemetry.peek("io.pipeline.fallbacks") == 1
        finally:
            tmx.telemetry.disable()
            tmx.telemetry.reset()

    _with_timeout(body)


def test_process_decode_four_workers(tmp_path):
    """Four workers cannot change a bit of the output."""
    path = _make_rec(tmp_path, n=64)

    def body():
        a = _record_iter(path, preprocess_threads=1, seed=3)
        c = _record_iter(path, preprocess_threads=4,
                         preprocess_mode="process", seed=3)
        with a, c:
            for (da, la), (dc, lc) in zip(_records(a), _records(c)):
                np.testing.assert_array_equal(da, dc)
                np.testing.assert_array_equal(la, lc)
            assert c.preprocess_mode == "process"
            assert c._proc_pipe.num_workers == 4

    _with_timeout(body, seconds=180)


def test_decode_procs_env_opts_in(tmp_path, monkeypatch):
    """MXNET_TPU_DECODE_PROCS turns process mode on and sets the worker
    count over preprocess_threads; MXNET_TPU_DECODE_RING sizes the ring."""
    path = _make_rec(tmp_path)
    monkeypatch.setenv("MXNET_TPU_DECODE_PROCS", "2")
    monkeypatch.setenv("MXNET_TPU_DECODE_RING", "3")

    def body():
        it = _record_iter(path, preprocess_threads=1)
        with it:
            assert it.preprocess_mode == "process"
            assert it._num_procs == 2
            next(iter(it))
            assert it._proc_pipe.num_slots == 3

    _with_timeout(body)


def test_pipeline_failed_start_falls_back(tmp_path, monkeypatch):
    """A start method that does not exist: the pipeline cannot start and
    the iterator decodes in process, batches unchanged."""
    path = _make_rec(tmp_path)
    monkeypatch.setenv("MXNET_TPU_DECODE_START", "no-such-method")
    want = _records(_record_iter(path, preprocess_threads=1))
    it = _record_iter(path, preprocess_threads=2, preprocess_mode="process")
    with it:
        got = _records(it)
        assert it.preprocess_mode == "thread"
    for (da, la), (dc, lc) in zip(want, got):
        np.testing.assert_array_equal(da, dc)
        np.testing.assert_array_equal(la, lc)


def test_pipeline_telemetry_and_staging(tmp_path):
    """The process pipeline's decode latency, and a DeviceStagingIter
    over it: three batches staged."""
    path = _make_rec(tmp_path)
    tmx.telemetry.enable()
    tmx.telemetry.reset()

    def body():
        it = _record_iter(path, preprocess_threads=2,
                          preprocess_mode="process")
        with it:
            with tmx.cpu():
                staged = tiop.DeviceStagingIter(it)
            for _ in staged:
                pass
        snap = tmx.telemetry.snapshot()["io"]
        assert snap["pipeline"]["decode_ms"]["count"] >= 3
        assert snap["staging"]["batches"] == 3

    try:
        _with_timeout(body)
    finally:
        tmx.telemetry.disable()
        tmx.telemetry.reset()
