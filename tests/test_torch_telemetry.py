"""The port's telemetry registry and flight recorder against the JAX
package's: the same observations give the same counters, gauges and
histogram summaries (quantiles and buckets); a disabled registry records
nothing; a span opens a profiler range; the recorder dumps and routes
SIGTERM through the preemption hooks; the exporters (Chrome trace,
merged snapshots, JSONL records) write what the reference's write."""
import json
import os
import signal

import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tracing


@pytest.fixture
def both():
    for tel in (jtel, ttel):
        tel.reset()
        tel.enable()
    yield
    for tel in (jtel, ttel):
        tel.reset()
        tel.disable()


def test_same_observations_same_snapshot(both):
    rng = np.random.RandomState(0)
    samples = rng.lognormal(2.0, 1.5, 700)
    for tel in (jtel, ttel):
        tel.inc("ckpt.saves")
        tel.inc("ckpt.saves", 2)
        tel.inc("ckpt.bytes", 1 << 20)
        tel.set_gauge("train.samples_per_sec", 512.5)
        for v in samples:
            tel.observe("ckpt.save_ms", v)
        tel.observe("ckpt", 3.0)     # a leaf that is also a prefix
    snap = ttel.snapshot()
    assert snap == jtel.snapshot()
    hist = snap["ckpt"]["save_ms"]
    assert hist["count"] == 700 and hist["buckets"]["counts"][-1] <= 700
    for name, kind in (("ckpt.saves", "counter"),
                       ("ckpt.save_ms", "counter"),
                       ("ckpt.save_ms", "hist_sum"),
                       ("train.samples_per_sec", "gauge"),
                       ("never.recorded", "counter")):
        assert ttel.peek(name, kind) == jtel.peek(name, kind)


def test_disabled_registry_records_nothing():
    ttel.reset()
    ttel.disable()
    ttel.inc("a")
    ttel.observe("b", 1.0)
    with ttel.span("c"):
        pass
    assert ttel.snapshot() == {} and ttel.spans() == []


def test_span_is_a_profiler_range(both):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttel.span("ckpt.restore"):
            torch.ones(4).sum()
    assert "ckpt.restore" in {e.key for e in prof.key_averages()}
    assert [s[0] for s in ttel.spans()] == ["ckpt.restore"]
    assert ttel.peek("span.ckpt.restore_ms") == 1
    with pytest.raises(ttel.MXNetError, match="is a Histogram, not a "
                       "Counter"):
        ttel.counter("span.ckpt.restore_ms")


def test_flight_recorder_dumps_and_runs_preempt_hooks(tmp_path, both):
    ttel.inc("ckpt.saves")
    rec = tracing.FlightRecorder(str(tmp_path)).install()
    calls = []
    hook = tracing.register_preempt_hook(lambda: calls.append(1) or "defer")
    try:
        os.kill(os.getpid(), signal.SIGTERM)   # deferred: the run goes on
        os.kill(os.getpid(), signal.SIGUSR1)   # dump and go on
    finally:
        tracing.unregister_preempt_hook(hook)
        rec.uninstall()
    assert calls == [1]
    dumps = sorted(os.listdir(tmp_path))
    assert len(dumps) == 2
    reasons = []
    for d in dumps:
        with open(tmp_path / d / "meta.json") as f:
            reasons.append(json.load(f)["reason"])
        with open(tmp_path / d / "telemetry.json") as f:
            assert json.load(f) == {"ckpt": {"saves": 1}}
        assert "Thread" in (tmp_path / d / "stacks.txt").read_text()
    assert sorted(reasons) == ["signal:SIGTERM", "signal:SIGUSR1"]


def _observe_both():
    for tel in (jtel, ttel):
        tel.inc("ckpt.saves", 3)
        tel.set_gauge("hbm.live_bytes", 1.5e9)
        for v in (0.7, 3.0, 12.0, 400.0):
            tel.observe("step.ms", v)
        with tel.span("load"):
            pass
        with tel.span("step"):
            pass


def test_chrome_trace_reads_as_the_reference(both, tmp_path):
    """The same spans from one thread: the same metadata and events but
    for their clock readings, which the JAX package also places on the
    wall clock (microseconds)."""
    import time

    _observe_both()
    paths = [str(tmp_path / ("%s.json" % n)) for n in ("jax", "torch")]
    assert jtel.write_chrome_trace(paths[0]) == \
        ttel.write_chrome_trace(paths[1], extra_events=None)
    (want, got) = (json.load(open(p)) for p in paths)
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "dur")}
              for e in t["traceEvents"]] for t in (want, got)]
    assert strip[1] == strip[0]
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["load", "step"]
    assert abs(spans[0]["ts"] / 1e6 - time.time()) < 600
    extra = [{"name": "x", "ph": "i", "pid": 1, "tid": 1, "ts": 0}]
    n = ttel.write_chrome_trace(paths[1], extra_events=extra)
    assert n == len(got["traceEvents"]) + 1


def test_merge_snapshots_matches_the_reference(both):
    _observe_both()
    a, b = ttel.snapshot(), jtel.snapshot()
    assert ttel.merge_snapshots([a, b, {}]) == jtel.merge_snapshots(
        [a, b, {}])
    hist = dict(a["step"]["ms"], sample=[1.0, 2.0])
    assert ttel.merge_snapshots([{"h": hist}, {"h": hist}]) == \
        jtel.merge_snapshots([{"h": hist}, {"h": hist}])
    bad = dict(hist, buckets={"bounds": [1.0], "counts": [1]})
    for snaps in ([{"h": hist}, {"h": bad}], [{"h": hist}, {"h": 3}],
                  [{"a": {"b": 1}}, {"a": "x"}]):
        with pytest.raises(Exception) as got:
            ttel.merge_snapshots(snaps)
        with pytest.raises(Exception) as want:
            jtel.merge_snapshots(snaps)
        assert str(got.value) == str(want.value)


def test_dump_jsonl_matches_the_reference(both, tmp_path, monkeypatch):
    """One record a call with the step index, the snapshot and the
    extras; the same lines but for the time stamp; fsync by the
    variable; ``reset`` restarts the index."""
    _observe_both()
    monkeypatch.setenv("MXNET_TPU_TELEMETRY_FSYNC", "1")
    for tel, name in ((jtel, "jax"), (ttel, "torch")):
        path = str(tmp_path / (name + ".jsonl"))
        tel.dump_jsonl(path, extra={"step_ms": 2.5})
        tel.dump_jsonl(path)
    lines = [[json.loads(line) for line in open(tmp_path / (n + ".jsonl"))]
             for n in ("jax", "torch")]
    for rec in lines[0] + lines[1]:
        rec.pop("ts")
        rec["telemetry"].pop("span")    # the spans' own clock readings
    assert lines[1] == lines[0]
    assert [r["step"] for r in lines[1]] == [1, 2]
    ttel.reset()
    assert ttel.dump_jsonl(str(tmp_path / "again.jsonl"))["step"] == 1
