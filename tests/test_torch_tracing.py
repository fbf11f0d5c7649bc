"""The port's step trace, anomaly detectors, flight recorder dump and
metrics exposition (mxnet_tpu_torch/tracing.py) against the JAX
package's (mxnet_tpu/tracing.py), on the CPU: one stream of telemetry
moves and step latencies goes through both packages' StepTrace, and the
records and the events must be the same; both registries, filled alike,
expose the same Prometheus samples. The cases are those of
tests/test_tracing.py, parametrised."""
import json
import os
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtel, tracing as jtr
from mxnet_tpu_torch import telemetry as ttel, tracing as ttr

from test_torch_common import CKPT_BATCH, ckpt_data, ckpt_mlp, ckpt_params

PKGS = ((jtel, jtr), (ttel, ttr))


@pytest.fixture(autouse=True)
def _isolated():
    for tel, tr in PKGS:
        tr.shutdown()
        tel.reset()
        tel.enable()
        tr.set_worker_rank(0)
    yield
    for tel, tr in PKGS:
        tr.shutdown()
        tel.reset()
        tel.disable()
        tr.set_worker_rank(0)


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


# Each scenario: StepTrace keyword arguments (detectors named by class),
# then the steps, each (latency_ms, telemetry moves, record extras).
SLOW = ("SlowStepDetector", {"k": 2.0, "warmup": 4})
SCENARIOS = {
    "hand_advanced_deltas": ([], [
        (5.0, [("inc", "ndarray.h2d_bytes", 4096),
               ("inc", "kvstore.push_bytes", 100)], None),
        (6.0, [("inc", "ndarray.h2d_bytes", 1024),
               ("inc", "executor.jit_build", 1),
               ("observe", "io.pipeline.stall_ms", 7.5)], None),
        (4.0, [], None)]),
    "dominant": ([], [
        (10.0, [], None),
        (100.0, [("observe", "io.pipeline.stall_ms", 80.0)], None),
        (100.0, [("observe", "io.pipeline.stall_ms", 80.0),
                 ("inc", "executor.jit_build", 1)], None),
        (100.0, [("observe", "io.prefetch_stall_ms", 50.0)], None),
        (100.0, [("inc", "step.fused_recompiles", 1)], None),
        (100.0, [("observe", "io.feed_stall_ms", 60.0)], None)]),
    "slow_step": ([SLOW], [(10.0, [], None)] * 8 + [
        (100.0, [("observe", "io.pipeline.stall_ms", 90.0)], None)]),
    "slow_step_warmup": ([SLOW], [(1.0, [], None), (500.0, [], None)]),
    "event_cooldown": ([("SlowStepDetector", {"k": 2.0, "warmup": 2})],
                       [(10.0, [], None)] * 4
                       + [(100.0, [], None)] * 2, 10),
    "recompile": ([("RecompileDetector", {"warmup": 2})], [
        (50.0, [("inc", "executor.jit_build", 1)], None),
        (5.0, [], None),
        (60.0, [("inc", "step.fused_recompiles", 1)], None),
        (60.0, [("inc", "executor.jit_build", 1)], None)]),
    "input_stall": ([("InputStallDetector", {"frac": 0.5})], [
        (10.0, [("observe", "io.pipeline.stall_ms", 2.0)], None),
        (10.0, [("observe", "io.pipeline.stall_ms", 8.0),
                ("observe", "io.prefetch_stall_ms", 1.0)], None),
        (10.0, [("observe", "io.feed_stall_ms", 9.0)], None)]),
    "numerics": (None, [
        (5.0, [], {"numwatch_loss": loss, "numwatch_grad_norm": 2.0,
                   "numwatch_uw_max": 1e-3, "numwatch_nonfinite": 0})
        for loss in (1.0, 1.1, 0.9, 1.0)] + [
        (5.0, [], {"numwatch_loss": 10.0, "numwatch_grad_norm": 50.0,
                   "numwatch_uw_max": 1e-12, "numwatch_nonfinite": 7,
                   "numwatch_bad_tensor": "fc1_weight",
                   "numwatch_skips": 2, "numwatch_rollbacks": 1})]),
    "serving_and_fleet": (None, [
        (5.0, [], {"request_ms": 80.0, "slo_ms": 50.0, "queue_depth": 3}),
        (5.0, [], {"fleet_down": 1, "breaker_open": 2, "fleet_size": 4}),
        (5.0, [], {"request_ms": 10.0, "slo_ms": 50.0})]),
}


def _run(tel, tr, scenario):
    spec = SCENARIOS[scenario]
    dets, steps = spec[0], spec[1]
    cooldown = spec[2] if len(spec) > 2 else 1
    detectors = None if dets is None else [getattr(tr, name)(**kw)
                                           for name, kw in dets]
    st = tr.StepTrace(capacity=64, detectors=detectors,
                      event_cooldown=cooldown)
    recs = []
    for lat, moves, extra in steps:
        for kind, name, v in moves:
            getattr(tel, kind)(name, v)
        recs.append(_strip(st.record(lat, extra)))
    return recs, [_strip(e) for e in st.events], tel.snapshot().get(
        "tracing")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_step_trace_and_detectors_follow_jax(scenario):
    """The same stream through both packages: equal records (deltas,
    dominant label, extras), equal events, equal tracing.* counters."""
    theirs = _run(jtel, jtr, scenario)
    mine = _run(ttel, ttr, scenario)
    assert mine == theirs
    if scenario == "dominant":
        assert [r["dominant"] for r in mine[0]] == [
            "compute", "io_stall_ms", "recompile", "prefetch_stall_ms",
            "recompile", "feed_stall_ms"]
    if scenario == "numerics":
        assert {e["type"] for e in mine[1]} == {
            "loss_spike", "grad_explosion", "dead_update", "nonfinite"}


def test_ring_is_bounded():
    st = ttr.StepTrace(capacity=4, detectors=[])
    for _ in range(10):
        st.record(1.0)
    assert [r["step"] for r in st.records()] == [7, 8, 9, 10]
    assert st.step == 10
    assert [field for field, _, _ in ttr.DELTA_SOURCES] == \
        [field for field, _, _ in jtr.DELTA_SOURCES]
    assert [type(d).__name__ for d in ttr.default_detectors()] == \
        [type(d).__name__ for d in jtr.default_detectors()]


def test_anomaly_profiler_window_and_rate_limit(tmp_path):
    """One window opens at the triggering step and closes window_steps
    later; a trigger inside the cooldown is counted, not traced; both
    packages' profilers take the same calls."""
    calls = []
    for tel, tr in PKGS:
        starts, stops = [], []
        prof = tr.AnomalyProfiler(
            trace_dir=str(tmp_path), window_steps=2, cooldown_s=3600.0,
            start_fn=starts.append, stop_fn=lambda s=stops: s.append(True))
        st = tr.StepTrace(capacity=64, event_cooldown=1, profiler=prof,
                          detectors=[tr.SlowStepDetector(k=2.0, warmup=2)])
        for lat in (10.0,) * 4 + (100.0, 10.0, 10.0, 100.0):
            st.record(lat)
        calls.append(([os.path.basename(p) for p in starts], stops,
                      prof.suppressed,
                      tel.counter("tracing.auto_traces").value,
                      st.events[0]["trace_started"]))
    assert calls[1] == calls[0] == (["step5_slow_step"], [True], 1, 1, True)


def test_anomaly_profiler_opens_a_torch_profiler_window(tmp_path):
    """Without test hooks the window is a torch.profiler run whose Chrome
    trace lands in the step's directory."""
    prof = ttr.AnomalyProfiler(trace_dir=str(tmp_path), window_steps=1,
                               cooldown_s=0.0)
    assert prof.on_anomaly(3, {"type": "slow_step"})
    sum(i * i for i in range(1000))
    prof.on_step(4)
    assert os.path.isfile(os.path.join(str(tmp_path), "step3_slow_step",
                                       "trace.json"))


def _read_dump(d):
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, "telemetry.json")) as f:
        snap = json.load(f)
    with open(os.path.join(d, "stacks.txt")) as f:
        stacks = f.read()
    with open(os.path.join(d, "steps.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    return meta, snap, stacks, steps


def test_flight_recorder_dump_contents(tmp_path):
    """meta (reason, pid, steps_recorded, events), the telemetry
    snapshot, our own frame in the stacks and the step ring, with the
    same keys as the JAX package's dump."""
    dumps = []
    for tel, tr in PKGS:
        st = tr.StepTrace(capacity=8, detectors=[])
        tel.inc("engine.push", 3)
        st.record(5.0)
        st.record(7.0)
        d = tr.FlightRecorder(str(tmp_path / tr.__name__), trace=st).dump(
            "unit-test")
        dumps.append(_read_dump(d))
    (jmeta, _, _, jsteps), (meta, snap, stacks, steps) = dumps
    assert set(meta) == set(jmeta)
    assert meta["reason"] == "unit-test" and meta["pid"] == os.getpid()
    assert meta["steps_recorded"] == 2 and meta["events"] == []
    assert snap["engine"]["push"] == 3
    assert "test_flight_recorder_dump_contents" in stacks
    assert [_strip(r) for r in steps] == [_strip(r) for r in jsteps]


def test_flight_recorder_reads_the_process_step_trace(tmp_path):
    """With telemetry on, record_step feeds the process's ring, which a
    recorder without its own trace dumps."""
    ttr.record_step(4.0, {"epoch": 0, "nbatch": 0})
    meta, _, _, steps = _read_dump(ttr.FlightRecorder(str(tmp_path)).dump(
        "ring"))
    assert meta["steps_recorded"] == 1 and steps[0]["nbatch"] == 0


def test_flight_recorder_excepthook_and_sigusr1(tmp_path):
    """The excepthook dumps and chains to the previous hook; SIGUSR1
    dumps and the process runs on; uninstall restores both."""
    st = ttr.StepTrace(capacity=8, detectors=[])
    st.record(1.0)
    seen = []
    prev_hook = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a)
    fr = ttr.FlightRecorder(str(tmp_path), trace=st).install()
    try:
        try:
            raise ValueError("simulated training crash")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5.0
        while len(os.listdir(str(tmp_path))) < 2 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        fr.uninstall()
        sys.excepthook = prev_hook
    assert len(seen) == 1 and seen[0][0] is ValueError
    reasons = sorted(_read_dump(os.path.join(str(tmp_path), d))[0]["reason"]
                     for d in os.listdir(str(tmp_path)))
    assert reasons == ["exception:ValueError", "signal:SIGUSR1"]
    assert signal.getsignal(signal.SIGUSR1) != fr._on_signal


# -- metrics exposition -------------------------------------------------------

def _parse_prom(text):
    """{name: {labels: value}} and {name: type}."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, mtype = line.split()
            types[name] = mtype
            continue
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name, _, labels = name_labels.partition("{")
        samples.setdefault(name, {})["{" + labels if labels else ""] = \
            float(value)
    return samples, types


def _fill(tel):
    tel.inc("engine.push", 7)
    tel.inc("step.dispatches", 3)
    tel.set_gauge("io.feed.in_flight", 2.0)
    tel.set_gauge("numwatch.grad_norm", 1.5)
    for v in (1.0, 2.0, 3.0, 4.0, 75.0):
        tel.observe("io.staging.h2d_ms", v)


def test_prometheus_text_equals_jax():
    """Both registries filled alike expose the same samples and types:
    counters, gauges, cumulative le buckets closing with +Inf, _sum and
    _count, every sample labeled with the rank."""
    texts = []
    for tel, tr in PKGS:
        _fill(tel)
        tr.set_worker_rank(2)
        texts.append(_parse_prom(tr.prometheus_text()))
    assert texts[1] == texts[0]
    samples, types = texts[1]
    assert types["mxnet_tpu_step_dispatches"] == "counter"
    assert types["mxnet_tpu_io_staging_h2d_ms"] == "histogram"
    b = samples["mxnet_tpu_io_staging_h2d_ms_bucket"]
    assert b['{rank="2",le="2.5"}'] == 2 and b['{rank="2",le="+Inf"}'] == 5


def _scrape(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def test_metrics_server_over_loopback(monkeypatch):
    """MXNET_TPU_METRICS_PORT=0: maybe_init starts one server on an
    ephemeral port (idempotent); /metrics carries the registry, /healthz
    the steps and anomalies, a failing probe turns it to 503 degraded,
    an unknown path is 404; shutdown joins the thread."""
    monkeypatch.setenv("MXNET_TPU_METRICS_PORT", "0")
    _fill(ttel)
    server = ttr.maybe_init()
    assert server is not None and ttr.maybe_init() is server
    ttr.record_step(5.0)
    status, ctype, text = _scrape(server.port, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    samples, _ = _parse_prom(text)
    assert samples["mxnet_tpu_step_dispatches"]['{rank="0"}'] == 3
    status, ctype, body = _scrape(server.port, "/healthz")
    health = json.loads(body)
    assert (status, ctype) == (200, "application/json")
    assert (health["status"], health["pid"], health["steps"]) == \
        ("ok", os.getpid(), 1)
    ttr.register_health_info("who", lambda: {"role": "trainer"})
    ttr.register_health_probe("slo", lambda: "p99 over the SLO")
    try:
        status, _, body = _scrape(server.port, "/healthz")
    finally:
        ttr.unregister_health_probe("slo")
        ttr.unregister_health_info("who")
    health = json.loads(body)
    assert status == 503 and health["status"] == "degraded"
    assert health["probes"] == {"slo": "p99 over the SLO"}
    assert health["role"] == "trainer"
    assert _scrape(server.port, "/nope")[0] == 404
    thread = server._thread
    ttr.shutdown()
    assert not thread.is_alive() and ttr.metrics_server() is None


def test_disabled_hooks_are_noops_and_cheap():
    """Telemetry off: record_step and maybe_init return None and create
    nothing; record_step costs one flag check (the JAX package pins its
    own below 2 us a call, best of 5; so does this)."""
    ttel.disable()
    assert ttr.record_step(5.0) is None and ttr.maybe_init() is None
    assert ttr._recorder is None and ttr.metrics_server() is None
    assert ttr.flight_recorder() is None
    best = float("inf")
    for fn in (ttr.record_step, lambda _: ttr.maybe_init()):
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(20000):
                fn(1.0)
            best = min(best, (time.perf_counter() - t0) / 20000)
        assert best < 2e-6, "disabled hook took %.0f ns" % (best * 1e9)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_populates_the_step_trace(fused, monkeypatch):
    """fit on the CPU, the classic loop or the fused step: one record a
    batch with the epoch and batch, positive latencies and every delta
    field."""
    monkeypatch.setenv("MXNET_TPU_FLIGHT_RECORDER", "1")
    net = ckpt_mlp(tmx)
    x, y = ckpt_data(5)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH), num_epoch=1,
            initializer=None, fused_step=fused,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in ckpt_params(net).items()})
    recs = ttr.step_trace().records()
    assert [(r["epoch"], r["nbatch"]) for r in recs] == \
        [(0, k) for k in range(5)]
    assert all(r["latency_ms"] > 0 for r in recs)
    assert all(set(r["deltas"]) == {f for f, _, _ in ttr.DELTA_SOURCES}
               for r in recs)
    assert ttr.flight_recorder() is not None
    assert np.sum([r["deltas"]["dispatches"] for r in recs]) == 0
