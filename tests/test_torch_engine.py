"""The port's dependency engine (mxnet_tpu_torch/engine.py): the cases of
tests/test_engine.py that apply, run on the port's engines (randomized
read/write workloads against a serial oracle, concurrent reads,
serialized writes, priority, the pooled I/O workers, engine info
logging), plus the selection by MXNET_ENGINE_TYPE and waitall."""
import logging
import random
import threading
import time

import pytest

from mxnet_tpu_torch import engine as eng
from mxnet_tpu_torch import nd, telemetry
from mxnet_tpu_torch.base import MXNetError


def _random_workload(num_vars=10, num_ops=200, seed=0):
    rng = random.Random(seed)
    ops = []
    for _ in range(num_ops):
        reads = rng.sample(range(num_vars), rng.randint(0, 3))
        writes = rng.sample([v for v in range(num_vars) if v not in reads],
                            rng.randint(1, 2))
        ops.append((reads, writes))
    return ops


def _run_workload(engine, ops, num_vars):
    vars_ = [engine.new_variable() for _ in range(num_vars)]
    state = {v: 0.0 for v in range(num_vars)}
    lock = threading.Lock()
    logs = {v: [] for v in range(num_vars)}
    for op_id, (reads, writes) in enumerate(ops):
        def fn(op_id=op_id, reads=reads, writes=writes):
            with lock:
                s = sum(state[r] for r in reads)
                for w in writes:
                    state[w] += s + 1
                    logs[w].append(op_id)
        engine.push(fn, const_vars=[vars_[r] for r in reads],
                    mutable_vars=[vars_[w] for w in writes])
    engine.wait_for_all()
    return state, logs


@pytest.mark.parametrize("factory", [
    eng.NaiveEngine, eng.XLAEngine, lambda: eng.ThreadedEngine(num_workers=4),
    lambda: eng.ThreadedEnginePooled(num_workers=3, num_io_workers=2)],
    ids=["naive", "inline", "threaded", "pooled"])
def test_engine_vs_serial_oracle(factory):
    ops = _random_workload(seed=42)
    want = _run_workload(eng.NaiveEngine(), ops, 10)
    engine = factory()
    assert _run_workload(engine, ops, 10) == want
    if hasattr(engine, "stop"):
        engine.stop()


def test_threaded_engine_parallel_reads():
    engine = eng.ThreadedEngine(num_workers=4)
    v = engine.new_variable()
    results = []
    lock = threading.Lock()
    barrier = threading.Barrier(3, timeout=5)

    def reader():
        barrier.wait()   # deadlocks unless 3 readers run together
        with lock:
            results.append("r")

    for _ in range(3):
        engine.push(reader, const_vars=[v])
    engine.wait_for_all()
    assert results == ["r"] * 3
    engine.stop()


def test_threaded_engine_write_serialization():
    engine = eng.ThreadedEngine(num_workers=8)
    v = engine.new_variable()
    counter = {"x": 0, "max_in_flight": 0}
    lock = threading.Lock()

    def writer():
        with lock:
            counter["x"] += 1
            counter["max_in_flight"] = max(counter["max_in_flight"],
                                           counter["x"])
        with lock:
            counter["x"] -= 1

    for _ in range(100):
        engine.push(writer, mutable_vars=[v])
    engine.wait_for_all()
    assert counter["max_in_flight"] == 1
    assert v.version == 100
    engine.stop()


def test_engine_wait_for_var_and_duplicates():
    engine = eng.ThreadedEngine(num_workers=2)
    v = engine.new_variable()
    out = []
    engine.push(lambda: out.append(1), mutable_vars=[v])
    engine.wait_for_var(v)
    assert out == [1]
    engine.stop()
    naive = eng.NaiveEngine()
    w = naive.new_variable()
    with pytest.raises(MXNetError, match="both const_vars and mutable"):
        naive.push(lambda: None, const_vars=[w], mutable_vars=[w])
    with pytest.raises(MXNetError, match="duplicate"):
        naive.push(lambda: None, mutable_vars=[w, w])


def test_engine_priority():
    engine = eng.ThreadedEngine(num_workers=1)
    gate = engine.new_variable()
    order = []
    engine.push(lambda: time.sleep(0.05), mutable_vars=[gate])
    engine.push(lambda: order.append("low"), priority=0)
    engine.push(lambda: order.append("high"), priority=10)
    engine.wait_for_all()
    assert order == ["high", "low"]
    engine.stop()


def test_pooled_engine_io_routing_and_zero_io_workers():
    pooled = eng.ThreadedEnginePooled(num_workers=2, num_io_workers=1)
    v = pooled.new_variable()
    order, names = [], {}
    lock = threading.Lock()

    def record(tag):
        def fn():
            with lock:
                order.append(tag)
                names[tag] = threading.current_thread().name
        return fn

    pooled.push(record("w1"), mutable_vars=[v])
    pooled.push(record("io"), mutable_vars=[v], prop="io")
    pooled.push(record("w2"), mutable_vars=[v])
    pooled.wait_for_all()
    assert order == ["w1", "io", "w2"]
    assert names["io"].startswith("mxtorch-engine-io")
    assert not names["w1"].startswith("mxtorch-engine-io")
    pooled.stop()
    bare = eng.ThreadedEnginePooled(num_workers=2, num_io_workers=0)
    ran = []
    bare.push(lambda: ran.append("io"), mutable_vars=[bare.new_variable()],
              prop="io")
    bare.wait_for_all()
    assert ran == ["io"]
    bare.stop()


def test_engine_info_logging_and_counters(caplog, monkeypatch):
    monkeypatch.setattr(eng, "_ENGINE_INFO", True)
    telemetry.reset()
    telemetry.enable()
    try:
        e = eng.NaiveEngine()
        v = e.new_variable()
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.engine"):
            e.push(lambda: None, mutable_vars=[v])
        assert any("NaiveEngine push" in r.getMessage()
                   for r in caplog.records)
        assert telemetry.peek("engine.push") == 1
        assert telemetry.peek("engine.dispatch") == 1
    finally:
        telemetry.disable()
        telemetry.reset()


@pytest.mark.parametrize("kind,cls", [
    (None, "XLAEngine"), ("XLAEngine", "XLAEngine"),
    ("ThreadedEnginePerDevice", "XLAEngine"), ("NaiveEngine", "NaiveEngine"),
    ("ThreadedEngine", "ThreadedEngine"),
    ("ThreadedEnginePooled", "ThreadedEnginePooled")])
def test_engine_type_selects_the_engine(kind, cls, monkeypatch):
    if kind is None:
        monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    else:
        monkeypatch.setenv("MXNET_ENGINE_TYPE", kind)
    monkeypatch.setattr(eng, "_engine", None)
    engine = eng.get_engine()
    assert type(engine).__name__ == cls
    assert eng.get_engine() is engine
    nd.waitall()
    if hasattr(engine, "stop"):
        engine.stop()


def test_native_engine_raises_naming_the_c_api(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NativeThreadedEngine")
    monkeypatch.setattr(eng, "_engine", None)
    with pytest.raises(MXNetError, match="C API"):
        eng.get_engine()


def test_set_engine_and_waitall_through_it(monkeypatch):
    calls = []

    class Recording(eng.XLAEngine):
        def wait_for_all(self):
            calls.append(1)

    monkeypatch.setattr(eng, "_engine", None)
    engine = eng.set_engine(Recording())
    assert eng.get_engine() is engine
    nd.waitall()
    assert calls == [1]
