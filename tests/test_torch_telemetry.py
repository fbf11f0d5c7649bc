"""The port's telemetry registry and flight recorder against the JAX
package's: the same observations give the same counters, gauges and
histogram summaries (quantiles and buckets); a disabled registry records
nothing; a span opens a profiler range; the recorder dumps and routes
SIGTERM through the preemption hooks."""
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
