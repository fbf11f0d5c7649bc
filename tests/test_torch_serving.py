"""The port's batching scheduler and its entry points' device rules, on
the CPU: the bucket ladder, padding and slicing, errors reaching the
caller, draining on close, the worker's inference mode, argmax ties,
and no silent CPU fallback when CUDA is missing."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving import BatchScheduler, bucket_ladder


def test_bucket_ladder():
    assert bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
    assert bucket_ladder(12) == (1, 2, 4, 8, 12)
    assert bucket_ladder(16, spec=[4, 8]) == (4, 8, 16)
    with pytest.raises(tmx.MXNetError):
        bucket_ladder(8, spec=[0, 4])


class _Doubler:
    """infer fn: records batch shapes and the worker's inference mode."""

    def __init__(self):
        self.shapes, self.inference = [], []

    def __call__(self, arrays):
        self.shapes.append(arrays[0].shape)
        self.inference.append(torch.is_inference_mode_enabled())
        return (torch.from_numpy(arrays[0] * 2),), ()


def test_scheduler_pads_to_bucket_and_slices_rows():
    fn = _Doubler()
    with BatchScheduler(fn, [(8, 3)], max_batch=8, max_wait_ms=50) as s:
        reqs = [s.submit(np.full((k, 3), k, np.float32)) for k in (1, 2, 2)]
        outs = [r.get(10)[0] for r in reqs]
    for k, out in zip((1, 2, 2), outs):
        assert out.shape == (k, 3) and np.all(out == 2 * k)
    assert all(shape[0] in (1, 2, 4, 8) for shape in fn.shapes)
    assert sum(r.bucket for r in reqs[:1]) >= 1
    assert fn.inference and all(fn.inference)
    st = s.stats()
    assert st["requests_served"] == 5 and st["errors"] == 0


def test_dispatch_error_reaches_the_caller():
    def broken(arrays):
        raise RuntimeError("CUDA error: an illegal memory access")

    with BatchScheduler(broken, [(4, 2)], max_batch=4) as s:
        req = s.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            req.get(10)
    assert s.stats()["errors"] == 1


def test_close_serves_everything_queued():
    fn = _Doubler()
    s = BatchScheduler(fn, [(4, 2)], max_batch=4, max_wait_ms=1000)
    reqs = [s.submit(np.ones((1, 2), np.float32)) for _ in range(6)]
    s.close()
    assert all(r.done() and r.error is None for r in reqs)
    with pytest.raises(tmx.MXNetError, match="closed"):
        s.submit(np.ones((1, 2), np.float32))


def test_submit_validates_rows_and_shapes():
    with BatchScheduler(_Doubler(), [(4, 2)], max_batch=4) as s:
        with pytest.raises(tmx.MXNetError, match="row shape"):
            s.submit(np.ones((1, 3), np.float32))
        with pytest.raises(tmx.MXNetError, match="exceeds max_batch"):
            s.submit(np.ones((5, 2), np.float32))


def test_concurrent_submitters_all_served():
    fn = _Doubler()
    results = {}
    with BatchScheduler(fn, [(8, 1)], max_batch=8, max_wait_ms=2) as s:
        def client(tid):
            for i in range(10):
                v = np.full((1 + (i % 3), 1), tid * 100 + i, np.float32)
                results[(tid, i)] = (v, s.submit(v))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        for v, req in results.values():
            np.testing.assert_array_equal(req.get(10)[0], v * 2)


def _tie_module(ctx):
    """FC with zero weights and bias [0, 2, 2, 1]: every row ties at
    classes 1 and 2."""
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    mod = tmx.mod.Module(s, label_names=(), context=ctx)
    mod.bind([("data", (4, 3))], for_training=False)
    mod.set_params({"fc_weight": tmx.nd.zeros((4, 3), ctx=ctx),
                    "fc_bias": tmx.nd.array([0, 2, 2, 1], ctx=ctx)}, {})
    return mod


def test_argmax_ties_take_the_first_maximum():
    """jnp.argmax and np.argmax return the first maximum; so does the
    port's top_k=1 post-processing."""
    mod = _tie_module(tmx.cpu())
    with tmx.serving.InferenceServer(mod, top_k=1, max_batch=4) as srv:
        (idx,) = srv.infer([np.ones((3, 3), np.float32)])
    assert list(idx) == [1, 1, 1]


def test_tensor_parallel_serving_raises():
    with pytest.raises(tmx.MXNetError, match="tensor-parallel"):
        tmx.serving.InferenceServer(_tie_module(tmx.cpu()), tp=2)


def test_no_silent_cpu_fallback(monkeypatch):
    """With CUDA hidden, the entry points given no context raise the
    named error instead of running on the CPU; an explicit CPU request
    works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = tmx.models.get_resnet([1, 1, 1, 1], [8, 8, 8, 8, 8],
                                num_classes=3, small_input=True,
                                layout="NHWC")
    with pytest.raises(tmx.DeviceUnavailableError, match="gpu\\(0\\)"):
        tmx.mod.Module(net)
    with pytest.raises(tmx.DeviceUnavailableError):
        tmx.nd.array(np.ones(3))
    with pytest.raises(tmx.DeviceUnavailableError):
        net.simple_bind(tmx.gpu(0), data=(1, 8, 8, 3))
    with pytest.raises(tmx.DeviceUnavailableError):
        tmx.Predictor(net.tojson(), b"", {"data": (1, 8, 8, 3)})
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        mod = tmx.mod.Module(net)
        mod.bind([("data", (1, 8, 8, 3))], for_training=False)
        assert tmx.nd.array(np.ones(3)).context == tmx.cpu()


def test_training_entry_points_name_the_training_slice():
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2)
    mod = tmx.mod.Module(net, label_names=(), context=tmx.cpu())
    with pytest.raises(tmx.TrainingNotPortedError, match="ROADMAP"):
        mod.bind([("data", (2, 3))], for_training=True)
    ex = net.simple_bind(tmx.cpu(), data=(2, 3))
    ex.forward()
    with pytest.raises(tmx.TrainingNotPortedError, match="ROADMAP"):
        ex.backward()
