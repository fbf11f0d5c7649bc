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
    """tp=2 on a module bound over one context: the tp does not divide the
    group, and the server raises naming the knob, as the reference's
    ``_tp_mesh`` does (tp serving over several contexts:
    tests/test_torch_tp_serve.py)."""
    with pytest.raises(tmx.MXNetError,
                       match="MXNET_TPU_SERVE_TP=2 does not divide the "
                             "1-device group"):
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


def test_training_entry_points_name_the_training_slice(monkeypatch):
    """The training slice is ported: a train bind gets gradient arrays
    and backward fills them; the dist kvstores are ported too: without a
    launcher ``dist_sync`` is a one-worker world, and ``dist_async``
    refuses to start its parameter server without a frame secret, naming
    the variable."""
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    mod = tmx.mod.Module(net, label_names=(), context=tmx.cpu())
    mod.bind([("data", (2, 3))], for_training=True)
    assert set(mod._exec_group.executor.grad_dict) == {"fc_weight",
                                                       "fc_bias"}
    ex = net.simple_bind(tmx.cpu(), data=(2, 3))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with pytest.raises(tmx.MXNetError, match="without forward"):
        ex.backward()
    ex.forward(is_train=True, data=x)
    ex.backward()
    # d(sum of fc)/d weight = column sums of x; / d bias = batch size
    np.testing.assert_allclose(ex.grad_dict["fc_weight"].asnumpy(),
                               np.tile(x.sum(0), (2, 1)))
    np.testing.assert_allclose(ex.grad_dict["fc_bias"].asnumpy(), [2, 2])
    from mxnet_tpu_torch.parallel import ps

    for k in ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK",
              "MXTPU_PS_SECRET", "MXTPU_PS_SECRET_FILE", "MXTPU_PS_INSECURE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(ps, "_SECRET_CACHE", False)
    assert tmx.kv.create("dist_sync").num_workers == 1
    with pytest.raises(tmx.MXNetError, match="MXTPU_PS_SECRET"):
        mod.init_params()
        mod.init_optimizer(kvstore="dist_async")


# ---------------------------------------------------------------------------
# the adaptive serving plane (the JAX package's serving.py and telemetry
# quantiles as the reference)
# ---------------------------------------------------------------------------
import json  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import mxnet_tpu.telemetry as jtel  # noqa: E402
import mxnet_tpu_torch.telemetry as ttel  # noqa: E402
from mxnet_tpu_torch import checkpoint as tckpt  # noqa: E402


class _Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


def _dbl(placed):
    return [np.asarray(placed[0]) * 2.0], ()


def test_lanes_deadlines_and_default_deadlines():
    """The interactive lane defaults to the SLO deadline and the batch
    lane to four times it; an unknown lane raises naming the lanes."""
    clk = _Clock()
    s = BatchScheduler(_dbl, [(4, 2)], max_batch=4, slo_ms=40.0,
                       adaptive=True, clock=clk, autostart=False)
    try:
        a = s.submit(np.ones((1, 2), np.float32))
        b = s.submit(np.ones((1, 2), np.float32), priority="batch")
        c = s.submit(np.ones((1, 2), np.float32), deadline_ms=7.0)
        assert (a.deadline_ms, b.deadline_ms, c.deadline_ms) == (
            40.0, 160.0, 7.0)
        assert a.t_deadline == pytest.approx(500.04)
        with pytest.raises(tmx.MXNetError, match="priority lane"):
            s.submit(np.ones((1, 2), np.float32), priority="bulk")
        clk.t += 0.1
        while s.step() not in (None, "wait"):
            pass
        assert s.lane_stats() == {"interactive": {"served": 2, "shed": 0},
                                  "batch": {"served": 1, "shed": 0}}
    finally:
        s.close()


class _Idem:
    idempotent = True

    def __call__(self, placed):
        return [np.asarray(placed[0]) + 1.0], ()


@pytest.mark.parametrize("idempotent", [True, False])
def test_request_id_dedup(idempotent):
    """A request id in flight returns the first request always; a served
    one only under an idempotent infer fn (FusedInfer is)."""
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    try:
        fn = _Idem() if idempotent else _dbl
        s = BatchScheduler(fn, [(4, 2)], max_batch=4, clock=_Clock(),
                           autostart=False)
        x = np.ones((1, 2), np.float32)
        first = s.submit(x, request_id="r1")
        assert s.submit(x, request_id="r1") is first
        assert s.in_flight() == 1
        while not first.done():
            s._clock.t += 0.01
            s.step()
        again = s.submit(x, request_id="r1")
        assert (again is first) == idempotent
        assert tmx.telemetry.peek("serve.duplicate_requests") == (
            2 if idempotent else 1)
        s.close()
    finally:
        tmx.telemetry.reset()
        tmx.telemetry.disable()


def _fc_module(ctx, seed=0):
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    s = tmx.sym.SoftmaxOutput(s, name="softmax")
    mod = tmx.mod.Module(s, context=ctx)
    mod.bind([("data", (4, 3))], for_training=False)
    rng = np.random.RandomState(seed)
    mod.set_params({"fc_weight": tmx.nd.array(rng.randn(4, 3), ctx=ctx),
                    "fc_bias": tmx.nd.array(rng.randn(4), ctx=ctx)}, {})
    return mod


def test_refresh_from_snapshot_moves_only_changed_params():
    """The first delta refresh seeds every param; after one param changes
    a snapshot's refresh copies that param alone into the served pack, in
    place, and the served rows follow it; an identical resend moves
    nothing."""
    mod = _fc_module(tmx.cpu())
    x = np.arange(12, dtype=np.float32).reshape(4, 3) / 4
    with tmx.serving.InferenceServer(mod, top_k=0, max_batch=4) as srv:
        packed = list(srv._fused._param_vals)
        srv.refresh_from_snapshot(tckpt.snapshot(mod))
        assert srv._fused.last_refresh_changed == 2
        w = mod.get_params()[0]["fc_weight"].asnumpy()
        mod.set_params({"fc_weight": tmx.nd.array(w * 3, ctx=tmx.cpu())},
                       {}, allow_missing=True)
        payload = tckpt.snapshot(mod)
        srv.refresh_from_snapshot(payload)
        fused = srv._fused
        assert (fused.last_refresh_changed, fused.last_refresh_skipped) == (
            1, 1)
        assert fused.last_refresh_bytes == payload["params"][
            "fc_weight"].nbytes
        assert all(a is b for a, b in zip(packed, fused._param_vals))
        (probs,) = srv.infer([x])
        want = mod.predict(x).asnumpy()
        np.testing.assert_allclose(probs, want, rtol=1e-6, atol=1e-7)
        srv.refresh_from_snapshot(payload)
        assert (fused.last_refresh_changed, fused.last_refresh_bytes) == (
            0, 0)


def test_stale_for_after_a_rebind_rebuilds_the_step():
    mod = _fc_module(tmx.cpu())
    x = np.arange(12, dtype=np.float32).reshape(4, 3) / 4
    with tmx.serving.InferenceServer(mod, top_k=1, max_batch=4) as srv:
        old = srv._fused
        assert srv._fused.idempotent
        assert not old.stale_for(mod._exec_group.executor)
        args, aux = mod.get_params()
        mod.bind([("data", (4, 3))], for_training=False, force_rebind=True)
        mod.set_params(args, aux)
        assert old.stale_for(mod._exec_group.executor)
        srv.refresh_params()
        assert srv._fused is not old
        assert srv.scheduler._infer is srv._fused
        assert not srv._fused.stale_for(mod._exec_group.executor)
        (top,) = srv.infer([x])
        assert top.tolist() == mod.predict(x).asnumpy().argmax(1).tolist()


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_info_metrics_payload_and_slo_probe():
    """``/healthz`` carries the server's in-flight count and controller
    state, and turns degraded (503) naming the SLO probe once the p99
    breaks the SLO; ``metrics_payload`` exports the scheduler's series."""
    tmx.telemetry.enable()
    mod = _fc_module(tmx.cpu())
    x = np.ones((2, 3), np.float32)
    try:
        with tmx.serving.InferenceServer(mod, top_k=1, max_batch=4, port=0,
                                         slo_ms=1e-6) as srv:
            assert srv.scheduler.adaptive
            srv.infer([x])
            status, body = _get(srv.port, "/healthz")
            payload = json.loads(body)
            assert status == 503 and payload["status"] == "degraded"
            probe = [v for k, v in payload["probes"].items()
                     if k.startswith("serve_slo:")]
            assert probe and probe[0]["slo_ms"] == 1e-6
            for key in ("in_flight", "requests_served", "adaptive",
                        "adaptive_wait_ms", "arrival_rate_rps",
                        "queue_depth"):
                assert key in payload, key
            assert payload["requests_served"] == 2
            mp = srv.metrics_payload()
            assert mp["serve.requests_served"] == 2
            assert mp["serve.batches"] == 1 and mp["serve.compiles"] == 1
            assert mp["serve.slo_breaches"] == 1
            assert mp["serve.request_ms"]["count"] == 1
            assert len(mp["serve.request_ms"]["sample"]) == 1
            st = srv.stats()
            assert st["lanes"]["interactive"]["served"] == 1
        with tmx.serving.InferenceServer(mod, top_k=1, max_batch=4,
                                         port=0) as srv:
            srv.infer([x])
            status, body = _get(srv.port, "/healthz")
            assert status == 200 and json.loads(body)["status"] == "ok"
    finally:
        tmx.telemetry.disable()


def test_quantiles_match_the_reference_telemetry():
    rng = np.random.RandomState(4)
    values = list(rng.lognormal(1.0, 1.2, 700))
    th, jh = ttel.Histogram("x"), jtel.Histogram("x")
    for v in values:
        th.observe(v)
        jh.observe(v)
    assert th.export(include_sample=True) == jh.export(include_sample=True)
    sample = sorted(values)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ttel.sample_quantile(sample, q) == jtel.sample_quantile(
            sample, q)
        assert th.quantile(q) == jtel.sample_quantile(
            sorted(values[-512:]), q)
        ex = jh.export()
        assert ttel.bucket_quantile(ex["buckets"], ex["count"], q,
                                    hi=ex["max"]) == jtel.bucket_quantile(
            ex["buckets"], ex["count"], q, hi=ex["max"])
    assert ttel.sample_quantile([], 0.5) is None
    assert ttel.bucket_quantile({}, 0, 0.5) is None
