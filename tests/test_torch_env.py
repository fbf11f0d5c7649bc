"""The port's environment registry (mxnet_tpu_torch/env.py) against the
JAX package's: each variable the port reads keeps the reference's name,
type and default; the port's doc block is what the registry generates;
an undeclared name raises."""
import os

import pytest

from mxnet_tpu import env as jenv
from mxnet_tpu_torch import env as tenv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_VARS = ["MXNET_TPU_FUSED_STEP", "MXNET_TPU_TELEMETRY",
             "MXNET_TPU_TELEMETRY_SPAN_CAP", "MXNET_TPU_CRASH_DIR",
             "MXNET_TPU_CKPT_DIR", "MXNET_TPU_CKPT_EVERY_N_STEPS",
             "MXNET_TPU_CKPT_KEEP", "MXNET_TPU_CKPT_RESUME",
             "MXNET_TPU_CKPT_GRACE_S",
             # the health and input plane of fit
             "MXNET_TPU_DEVICE_STAGING", "MXNET_TPU_FEED_DEPTH",
             "MXNET_TPU_METRICS_PORT", "MXNET_TPU_TRACE_ON_ANOMALY",
             "MXNET_TPU_TRACE_DIR", "MXNET_TPU_TRACE_WINDOW",
             "MXNET_TPU_TRACE_COOLDOWN", "MXNET_TPU_TRACE_RING",
             "MXNET_TPU_TRACE_EVENT_COOLDOWN", "MXNET_TPU_FLIGHT_RECORDER",
             "MXNET_TPU_NUMWATCH", "MXNET_TPU_NUMWATCH_EVERY_N",
             "MXNET_TPU_NUMWATCH_GUARD", "MXNET_TPU_NUMWATCH_SPIKE_K",
             "MXNET_TPU_NUMWATCH_EXPLODE_K", "MXNET_TPU_NUMWATCH_DEAD_UW",
             "MXNET_TPU_NUMWATCH_MAX_SKIPS",
             "MXNET_TPU_NUMWATCH_ROLLBACK_COOLDOWN",
             # image records: process decode is refused
             "MXNET_TPU_DECODE_PROCS",
             # the optimizers' multi-tensor update and the engines
             "MXNET_TPU_FUSED_UPDATE", "MXNET_TPU_ENGINE_SYNC"]
# read by the JAX package through base.getenv(name, default), outside its
# registry: (name, the default it passes)
PLAIN_VARS = [("MXNET_ENGINE_TYPE", "XLAEngine"),
              ("MXNET_ENGINE_INFO", False)]


def test_the_port_declares_the_variables_it_reads():
    assert sorted(tenv.declared()) == sorted(
        PORT_VARS + [name for name, _ in PLAIN_VARS])


@pytest.mark.parametrize("name,default", PLAIN_VARS)
def test_plain_variable_matches_the_reference_getenv(name, default,
                                                     monkeypatch):
    from mxnet_tpu.base import getenv

    mine = tenv.var(name)
    assert (mine.type, mine.default) == (type(default), default)
    monkeypatch.delenv(name, raising=False)
    assert tenv.get(name) == getenv(name, default)
    monkeypatch.setenv(name, {bool: "1", str: "NaiveEngine"}[mine.type])
    assert tenv.get(name) == getenv(name, default)


@pytest.mark.parametrize("name", PORT_VARS)
def test_port_variable_matches_the_reference(name, monkeypatch):
    mine, theirs = tenv.var(name), jenv.var(name)
    assert (mine.name, mine.type, mine.default) == \
        (theirs.name, theirs.type, theirs.default)
    monkeypatch.delenv(name, raising=False)
    assert tenv.get(name) == jenv.get(name)
    raw = {bool: "1", int: "7", float: "2.5", str: "/x"}[mine.type]
    monkeypatch.setenv(name, raw)
    assert tenv.get(name) == jenv.get(name)
    assert tenv.is_set(name)


def test_docs_equal_the_generated_block():
    path = os.path.join(ROOT, "docs", "env_vars_torch.md")
    assert tenv.sync_docs(path, check=True), (
        "docs/env_vars_torch.md is out of sync with mxnet_tpu_torch/env.py: "
        "run mxnet_tpu_torch.env.sync_docs on it")
    with open(path) as f:
        assert tenv.generate_docs() in f.read()


def test_undeclared_name_raises():
    with pytest.raises(KeyError, match="not declared"):
        tenv.get("MXNET_TPU_NOT_A_VARIABLE")
    with pytest.raises(KeyError):
        tenv.is_set("MXNET_TPU_XPROF")
    with pytest.raises(ValueError, match="declared twice"):
        tenv.declare("MXNET_TPU_CKPT_DIR", str, "", "again")
