"""The port's profiler (mxnet_tpu_torch/profiler.py) on the CPU: the
step timer's summary against the JAX package's on the same step times;
start/stop writing a Chrome trace that holds an annotate range; the
errors of a double start and a stop without a start."""
import json

import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
import mxnet_tpu_torch as tmx

TIMES = [[], [0.5], [0.25, 0.002], [0.9, 0.001, 0.002, 0.003, 0.004],
         [0.03 * (i % 7) + 0.001 * i for i in range(101)]]


@pytest.mark.parametrize("times", TIMES)
@pytest.mark.parametrize("skip", [0, 1, 3, 200])
def test_step_timer_summary_matches_jax(times, skip):
    mine, theirs = tprof.StepTimer(), jprof.StepTimer()
    mine._times, theirs._times = list(times), list(times)
    assert mine.summary(skip) == theirs.summary(skip)
    assert mine.times == theirs.times == times


def test_step_timer_syncs_times_and_records(tmp_path):
    synced = []
    timer = tprof.StepTimer(sync_fn=lambda: synced.append(1),
                            jsonl_path=str(tmp_path / "steps.jsonl"))
    ttel.reset()
    ttel.enable()
    try:
        for _ in range(3):
            with timer:
                pass
    finally:
        ttel.disable()
    assert len(synced) == len(timer.times) == 3
    assert ttel.peek("profiler.steps") == 3
    lines = open(tmp_path / "steps.jsonl").read().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 3]
    assert all("step_ms" in json.loads(line) for line in lines)
    ttel.reset()
    timer.reset()
    assert timer.summary() == {"steps": 0}


def test_trace_holds_the_annotated_range(tmp_path):
    """A trace around a small fused fit's step on the CPU: the file is a
    Chrome trace with the annotate range and the step's host ops."""
    import numpy as np

    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(tmx.init.Xavier(seed=0))
    mod.init_optimizer()
    metric = tmx.metric.create("acc")
    step = mod._fused_train_step(metric)
    batch = tmx.io.DataBatch([np.ones((4, 5), np.float32)],
                             [np.zeros(4, np.float32)])
    assert not tprof.is_running()
    tprof.start(str(tmp_path / "prof"))
    assert tprof.is_running()
    with pytest.raises(tmx.MXNetError, match="already running"):
        tprof.start(str(tmp_path / "other"))
    with tprof.annotate("my_step"):
        step.step(batch, metric)
    path = tprof.stop()
    assert not tprof.is_running()
    assert path == str(tmp_path / "prof" / "trace.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "my_step" in names
    assert any(n.startswith("aten::") for n in names if n)
    with pytest.raises(tmx.MXNetError, match="not running"):
        tprof.stop()


def test_keep_cupti_sets_its_switches_and_keeps_the_callers(monkeypatch):
    """CUPTI stays set up between sessions (CUDA graphs and its teardown
    crash together): both switches set, a value already there kept."""
    import os

    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.setenv("DISABLE_CUPTI_LAZY_REINIT", "0")
    tmx.profiler.keep_cupti()
    assert os.environ["TEARDOWN_CUPTI"] == "0"
    assert os.environ["DISABLE_CUPTI_LAZY_REINIT"] == "0"
