"""The port's device staging and feed scheduler
(mxnet_tpu_torch/io_pipeline.py) against the JAX package's
(mxnet_tpu/io_pipeline.py), on the CPU, where a staged batch is a copy:
both packages' wrappers yield the base iterator's batches in order,
across a reset and after a seek that drops the read-ahead; the fit-loop
hooks wrap as the JAX package's do; and fit with staging or a feed depth
leaves the params bit-equal to fit without."""
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
