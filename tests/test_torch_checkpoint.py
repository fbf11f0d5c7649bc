"""The port's preemption-safe training (mxnet_tpu_torch/checkpoint.py)
on the CPU, after tests/test_checkpoint.py: crash-safe writes, torn-file
detection, model and optimizer-state files, a bit-identical resume
through the classic loop and through the fused step (run eagerly here),
restores that write in place, rollback, and the SIGTERM grace path in
process and in a child process."""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import telemetry, tracing

from test_torch_common import (CKPT_BATCH, ckpt_data, ckpt_mlp, ckpt_params,
                               ckpt_stream_callback)

HERE = os.path.dirname(os.path.abspath(__file__))


def _opt_params():
    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": tmx.lr_scheduler.FactorScheduler(step=3,
                                                             factor=0.5)}


def _fit(fused=True, nbatches=4, num_epoch=2, stream=None, dropout=0.0,
         callbacks=(), epoch_end_callback=None, mod=None):
    """One port fit on the CPU (of ``mod``, or a new Module over
    ckpt_mlp) from ckpt_params' weights, its Dropout masks drawn from
    the random stream at seed 0; ``stream`` collects the per-step (epoch,
    nbatch, metrics, loss)."""
    tmx.random.seed(0)
    if mod is None:
        mod = tmx.mod.Module(ckpt_mlp(tmx, dropout), context=tmx.cpu())
    net = mod.symbol
    x, y = ckpt_data(nbatches)
    cbs = list(callbacks)
    if stream is not None:
        cbs.insert(0, ckpt_stream_callback(stream))
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
            num_epoch=num_epoch, eval_metric=["acc", "ce"],
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in ckpt_params(net).items()},
            initializer=None, optimizer_params=_opt_params(),
            batch_end_callback=cbs, epoch_end_callback=epoch_end_callback,
            fused_step=fused)
    return mod


def _params(mod):
    args, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items())
            + list(aux.items())}


def _keep_only_step(d, step):
    """Trim the manifest to the snapshot of ``step``: a resume from a
    mid-run save, not the last one."""
    mp = os.path.join(d, ckpt.MANIFEST)
    with open(mp) as f:
        man = json.load(f)
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == step]
    assert man["snapshots"], "no snapshot at step %d" % step
    with open(mp, "w") as f:
        json.dump(man, f)


@pytest.fixture
def tel():
    telemetry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.reset()
    telemetry.disable()


# ---------------------------------------------------------------------------
# crash-safe writes and torn files
# ---------------------------------------------------------------------------

def test_atomic_writer_crash_leaves_old_file_whole(tmp_path):
    p = str(tmp_path / "f.bin")
    ckpt.atomic_write_bytes(p, b"old-complete-content")
    with pytest.raises(RuntimeError):
        with ckpt.atomic_writer(p) as f:
            f.write(b"new-half")
            raise RuntimeError("simulated crash mid-write")
    assert open(p, "rb").read() == b"old-complete-content"
    assert not [x for x in os.listdir(tmp_path) if ".tmp-" in x]


def test_snapshot_store_prunes_to_keep(tmp_path):
    st = ckpt.SnapshotStore(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        st.save({"format": ckpt.FORMAT, "step": step, "epoch": 0,
                 "nbatch": step - 1, "dp": 1})
    with open(tmp_path / ckpt.MANIFEST) as f:
        man = json.load(f)
    assert [e["step"] for e in man["snapshots"]] == [2, 3]
    assert len([x for x in os.listdir(tmp_path)
                if x.endswith(".ckpt")]) == 2
    payload, entry = st.load_latest()
    assert payload["step"] == 3 and entry["step"] == 3


def test_torn_snapshot_skipped_never_silently_loaded(tmp_path, tel):
    st = ckpt.SnapshotStore(str(tmp_path), keep=2)
    for step in (1, 2):
        st.save({"format": ckpt.FORMAT, "step": step, "epoch": 0,
                 "nbatch": step - 1, "dp": 1})
    _, newest = st.load_latest()
    path = tmp_path / newest["file"]
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // 2])
    payload, _ = st.load_latest()
    assert payload["step"] == 1, "torn snapshot was not skipped"
    assert telemetry.peek("ckpt.torn_skipped") == 1
    # the right size with one byte flipped: the hash catches it
    path.write_bytes(bytes([blob[0] ^ 0xFF]) + blob[1:])
    payload, _ = st.load_latest()
    assert payload["step"] == 1
    assert telemetry.peek("ckpt.torn_skipped") == 2


def test_unreadable_manifest_treated_as_empty(tmp_path):
    (tmp_path / ckpt.MANIFEST).write_text("{torn json")
    st = ckpt.SnapshotStore(str(tmp_path), keep=2)
    assert st.load_latest() is None
    st.save({"format": ckpt.FORMAT, "step": 1, "epoch": 0, "nbatch": 0,
             "dp": 1})
    payload, _ = st.load_latest()
    assert payload["step"] == 1


# ---------------------------------------------------------------------------
# model, optimizer-state and callback files
# ---------------------------------------------------------------------------

def test_model_checkpoint_atomic_and_corrupt_named_error(tmp_path):
    net = ckpt_mlp(tmx)
    prefix = str(tmp_path / "ck")
    args = {k: tmx.nd.array(v, ctx=tmx.cpu())
            for k, v in ckpt_params(net).items()}
    tmx.model.save_checkpoint(prefix, 1, net, args, {})
    _, loaded, _ = tmx.model.load_checkpoint(prefix, 1)
    assert set(loaded) == set(args)
    assert not [x for x in os.listdir(tmp_path) if ".tmp-" in x]
    pf = "%s-0001.params" % prefix
    blob = open(pf, "rb").read()
    open(pf, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(tmx.MXNetError) as ei:
        tmx.model.load_checkpoint(prefix, 1)
    assert "ck-0001.params" in str(ei.value)


def test_optimizer_states_atomic_and_corrupt_named_error(tmp_path):
    mod = _fit(nbatches=2, num_epoch=1)
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    sf = prefix + "-0001.states"
    ptrs = {i: s.handle.data_ptr() for i, s in mod._updater.states.items()}
    want = {i: s.asnumpy().copy() for i, s in mod._updater.states.items()}
    for s in mod._updater.states.values():
        s.handle.fill_(7.0)
    mod.load_optimizer_states(sf)
    for i, s in mod._updater.states.items():
        assert s.handle.data_ptr() == ptrs[i]
        assert np.array_equal(s.asnumpy(), want[i])
    assert not [x for x in os.listdir(tmp_path) if ".tmp-" in x]
    open(sf, "wb").write(b"\x80\x04garbage-not-a-pickle")
    with pytest.raises(tmx.MXNetError) as ei:
        mod.load_optimizer_states(sf)
    assert "m-0001.states" in str(ei.value)


def test_kvstore_optimizer_states_round_trip(tmp_path):
    kv = tmx.kv.create("local")
    with pytest.raises(tmx.MXNetError, match="no optimizer set"):
        kv.save_optimizer_states(str(tmp_path / "x.states"))
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    w = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu())
    kv.init(0, w)
    kv.push(0, tmx.nd.array(np.full((2, 3), 0.5, np.float32),
                            ctx=tmx.cpu()))
    fname = str(tmp_path / "kv.states")
    kv.save_optimizer_states(fname)
    state = kv._updater.states[0]
    want = state.asnumpy().copy()
    state.handle.zero_()
    kv.load_optimizer_states(fname)
    assert kv._updater.states[0] is state
    assert np.array_equal(state.asnumpy(), want)


def test_restored_states_wait_for_their_first_update():
    """A restore before an index's first update keeps the saved state
    and creates it, with that value, at the first update."""
    make = lambda: tmx.optimizer.get_updater(tmx.optimizer.create(  # noqa
        "sgd", learning_rate=0.1, momentum=0.9))
    src, dst = make(), make()
    w0 = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu())
    g = tmx.nd.array(np.full((2, 3), 0.5, np.float32), ctx=tmx.cpu())
    src(0, g, w0)
    dst.set_states(src.get_states())
    assert dst.states == {}
    w1 = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu())
    assert np.array_equal(dst._state(0, w1).asnumpy(),
                          src.states[0].asnumpy())
    bad = make()
    bad.set_states(src.get_states())
    with pytest.raises(tmx.MXNetError, match="saved shape"):
        bad._state(0, tmx.nd.zeros((3, 2), ctx=tmx.cpu()))


def test_do_checkpoint_save_optimizer_states(tmp_path):
    with pytest.raises(ValueError):
        tmx.callback.do_checkpoint(str(tmp_path / "x"),
                                   save_optimizer_states=True)
    prefix = str(tmp_path / "cb")
    mod = tmx.mod.Module(ckpt_mlp(tmx), context=tmx.cpu())
    _fit(nbatches=2, num_epoch=2, mod=mod,
         epoch_end_callback=tmx.callback.do_checkpoint(
             prefix, save_optimizer_states=True, mod=mod))
    for ep in (1, 2):
        assert os.path.exists("%s-%04d.params" % (prefix, ep))
        assert os.path.exists("%s-%04d.states" % (prefix, ep))
    loaded = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
    want = _params(mod)
    assert all(np.array_equal(v.asnumpy(), want[k])
               for k, v in loaded._arg_params.items())


def test_module_checkpoint_and_save_load_params(tmp_path):
    mod = _fit(nbatches=2, num_epoch=1)
    prefix = str(tmp_path / "mc")
    tmx.callback.module_checkpoint(mod, prefix, period=2)(1)
    assert os.path.exists(prefix + "-0002.params")
    want = _params(mod)
    other = _fit(nbatches=3, num_epoch=1)
    other.load_params(prefix + "-0002.params")
    got = _params(other)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# full-state snapshot and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused,dropout", [(False, 0.0), (True, 0.0),
                                           (True, 0.3)],
                         ids=["classic", "fused", "fused_dropout"])
def test_resume_bit_identical_stream(tmp_path, tel, monkeypatch, fused,
                                     dropout):
    """A fresh module resuming from the step-3 snapshot replays the rest
    of the (epoch, nbatch, metrics, loss) stream bit for bit, and ends on
    the uninterrupted run's params: params, momenta, optimizer counters
    and schedule, metric sums, the generator (Dropout) and the data
    cursor all restored."""
    ref = []
    ref_mod = _fit(fused, stream=ref, dropout=dropout)
    assert len(ref) == 8
    d = str(tmp_path / "snaps")
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")
    s1 = []
    _fit(fused, stream=s1, dropout=dropout)
    assert s1 == ref, "checkpointing perturbed the training stream"
    assert telemetry.peek("ckpt.saves") == 2
    _keep_only_step(d, 3)
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "1")
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "0")
    s2 = []
    mod = _fit(fused, stream=s2, dropout=dropout)
    assert telemetry.peek("ckpt.restores") == 1
    assert s2 == [r for r in ref if (r[0], r[1]) > (0, 2)]
    a, b = _params(mod), _params(ref_mod)
    for k in b:
        assert np.array_equal(a[k], b[k]), k


def test_a_failed_periodic_save_is_logged_and_the_run_goes_on(
        tmp_path, monkeypatch, caplog):
    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.SnapshotStore, "save", fail)
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "1")
    stream = []
    _fit(nbatches=2, num_epoch=1, stream=stream)
    assert len(stream) == 2
    assert caplog.text.count("checkpoint save failed (reason=periodic): "
                             "disk full") == 2


@pytest.mark.parametrize("change", ["extra_param", "wrong_shape"])
def test_restore_names_model_mismatch(change):
    mod = _fit(nbatches=2, num_epoch=1)
    payload = ckpt.snapshot(mod, step=1, epoch=0, nbatch=0)
    before = _params(mod)
    if change == "extra_param":
        payload["params"]["not_a_param"] = np.zeros((2, 2), np.float32)
        name = "not_a_param"
    else:
        payload["params"]["fc2_bias"] = np.zeros((4,), np.float32)
        name = "fc2_bias"
    payload["params"]["fc1_weight"] = payload["params"]["fc1_weight"] + 1
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.restore(payload, mod)
    assert name in str(ei.value)
    after = _params(mod)
    assert all(np.array_equal(after[k], before[k]) for k in before), \
        "a refused restore wrote part of the snapshot"


def test_another_devices_generator_state_is_not_carried(caplog):
    """A generator state of another device type (a card's, restored on
    the CPU) is logged and left out; the rest of the snapshot is
    restored."""
    mod = _fit(nbatches=2, num_epoch=1)
    payload = ckpt.snapshot(mod)
    payload["rng_torch"]["executor"] = np.zeros(16, np.uint8)
    gen = mod._exec_group.executor._generator()
    before = gen.get_state().clone()
    mod._exec_group.executor.arg_dict["fc1_bias"].handle.fill_(3.0)
    ckpt.restore(payload, mod)
    assert "not carried across" in caplog.text
    assert gen.get_state().equal(before)
    assert np.array_equal(_params(mod)["fc1_bias"],
                          payload["params"]["fc1_bias"])


def test_a_snapshot_before_the_first_update_restores_fresh_momenta():
    """Momenta created after the snapshot (none existed then) go back to
    a fresh state's zeros, in place, with the params."""
    net = ckpt_mlp(tmx)
    x, y = ckpt_data(2)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH).provide_data,
             [("softmax_label", (CKPT_BATCH,))])
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in ckpt_params(net).items()})
    mod.init_optimizer(optimizer_params=_opt_params())
    payload = ckpt.snapshot(mod)
    assert payload["updater_states"] == {}
    _fit(nbatches=2, num_epoch=1, mod=mod)
    states = dict(mod._updater.states)
    assert all(np.abs(s.asnumpy()).max() > 0 for s in states.values())
    ckpt.restore(payload, mod)
    assert all(mod._updater.states[i] is s for i, s in states.items())
    assert all(not s.asnumpy().any() for s in states.values())
    p = _params(mod)
    assert all(np.array_equal(p[k], v) for k, v in payload["params"].items())


def test_restore_and_rollback_write_in_place(tmp_path, tel):
    """Restore and rollback copy into the tensors the module holds: the
    data_ptr of every weight, aux state, momentum and metric accumulator
    stays."""
    mod = _fit(nbatches=3, num_epoch=1)
    ex = mod._exec_group.executor
    metric = tmx.metric.create(["acc", "ce"])
    metric.update([tmx.nd.array(np.zeros(4), ctx=tmx.cpu())],
                  [tmx.nd.array(np.full((4, 3), 1 / 3.), ctx=tmx.cpu())])

    def ptrs():
        return ([a.handle.data_ptr() for a in ex.arg_arrays]
                + [a.handle.data_ptr() for a in ex.aux_arrays]
                + [s.handle.data_ptr() for s in mod._updater.states.values()]
                + [m._acc.data_ptr() for m in metric.metrics])

    before = ptrs()
    man = ckpt.CheckpointManager(mod, metric, directory=str(tmp_path),
                                 every_n=0)
    man.save_now()
    ckpt.restore(man.store.load_latest()[0], mod, metric)
    assert ptrs() == before
    assert man.rollback() is not None
    assert ptrs() == before
    assert telemetry.peek("ckpt.rollbacks") == 1


def test_rollback_restores_state_and_leaves_iterator(tmp_path,
                                                     monkeypatch):
    """After a rollback the params, momenta, metric accumulators and
    optimizer counters are the snapshot's, and the iterator's cursor is
    where the run left it."""
    net = ckpt_mlp(tmx)
    x, y = ckpt_data(4)
    it = tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    metric = tmx.metric.create(["acc", "ce"])
    seen = {}

    def cb(param):
        man = param.locals["ckpt"]
        if param.nbatch == 1:
            man.save_now()
            seen["params"] = _params(mod)
            seen["states"] = {i: s.asnumpy().copy()
                              for i, s in mod._updater.states.items()}
            seen["metric"] = metric.get_name_value()
            seen["counts"] = mod._optimizer.get_checkpoint_state()
        if param.nbatch == 3:
            cursor = it.cursor
            assert man.rollback() is not None
            assert it.cursor == cursor
            assert man.global_step == 2
            p = _params(mod)
            assert all(np.array_equal(p[k], seen["params"][k]) for k in p)
            for i, s in mod._updater.states.items():
                assert np.array_equal(s.asnumpy(), seen["states"][i])
            assert metric.get_name_value() == seen["metric"]
            assert mod._optimizer.get_checkpoint_state() == seen["counts"]
            seen["done"] = True

    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", str(tmp_path))
    mod.fit(it, num_epoch=1, eval_metric=metric,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in ckpt_params(net).items()},
            initializer=None, optimizer_params=_opt_params(),
            batch_end_callback=cb, fused_step=True)
    assert seen.get("done")


def test_fit_reads_the_fused_step_variable(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    assert _fit(None, nbatches=2, num_epoch=1)._fused_step_active
    assert not _fit(False, nbatches=2, num_epoch=1)._fused_step_active
    x, y = ckpt_data(2)
    mod = tmx.mod.Module(ckpt_mlp(tmx), context=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="fused train step: a monitor"):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=1, monitor=object())
    monkeypatch.delenv("MXNET_TPU_FUSED_STEP")
    assert not _fit(None, nbatches=2, num_epoch=1)._fused_step_active


# ---------------------------------------------------------------------------
# SIGTERM grace path
# ---------------------------------------------------------------------------

@pytest.fixture
def manager(tmp_path, monkeypatch):
    mod = _fit(nbatches=2, num_epoch=1)
    monkeypatch.setenv("MXNET_TPU_CRASH_DIR", str(tmp_path / "crash"))
    redelivered = []
    monkeypatch.setattr(ckpt.CheckpointManager, "_reraise_sigterm",
                        staticmethod(lambda: redelivered.append(True)))
    man = ckpt.CheckpointManager(mod, directory=str(tmp_path / "snaps"))
    man.arm()
    yield man, redelivered
    man.disarm()
    tracing.shutdown()


def test_preempt_mid_step_defers_to_boundary(manager, tel):
    man, redelivered = manager
    man.step_begin()
    os.kill(os.getpid(), signal.SIGTERM)   # handled before the next line
    assert man._exit_after_step, "mid-step SIGTERM did not defer"
    assert man.store.load_latest() is None
    man.step_end(0, 0)
    assert redelivered == [True], "SIGTERM was not delivered again"
    payload, entry = man.store.load_latest()
    assert entry["reason"] == "preempt"
    assert telemetry.peek("ckpt.preempt_saves") == 1
    assert "fc1_weight" in payload["params"]


def test_preempt_between_steps_saves_at_once(manager, tel):
    """Between steps the hook saves in the handler and lets termination
    proceed: the recorder then delivers SIGTERM with the prior handler,
    here a recording one in place of the default."""
    man, _ = manager
    got = []
    rec = tracing.flight_recorder()
    prev = rec._prev_handlers[signal.SIGTERM]
    rec._prev_handlers[signal.SIGTERM] = lambda *a: got.append("ended")
    man.step_end(0, 0)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        rec._prev_handlers[signal.SIGTERM] = prev
    assert got == ["ended"]
    payload, entry = man.store.load_latest()
    assert entry["reason"] == "preempt" and entry["step"] == 1
    assert telemetry.peek("ckpt.preempt_saves") == 1
    dumps = os.listdir(rec.crash_dir)
    assert dumps and os.path.exists(os.path.join(rec.crash_dir, dumps[0],
                                                 "stacks.txt"))


def test_sigterm_grace_checkpoint_then_exit_subprocess(tmp_path):
    """In a child process: SIGTERM between steps saves a "preempt"
    snapshot and ends the process by the signal; a second child resumes
    from it and runs to the end."""
    snaps = tmp_path / "snaps"
    env = dict(os.environ, MXNET_TPU_CKPT_DIR=str(snaps),
               MXNET_TPU_CKPT_EVERY_N_STEPS="4",
               MXNET_TPU_CRASH_DIR=str(tmp_path / "crash"),
               T_DIR=str(tmp_path), DIE_AT_STEP="7")
    script = os.path.join(HERE, "torch_ckpt_child.py")
    r = subprocess.run([sys.executable, script], env=env, timeout=120,
                       capture_output=True, text=True)
    assert r.returncode == -signal.SIGTERM, r.stderr[-2000:]
    assert not (tmp_path / "completed").exists()
    with open(snaps / ckpt.MANIFEST) as f:
        last = json.load(f)["snapshots"][-1]
    assert last["reason"] == "preempt" and last["step"] == 7, last
    del env["DIE_AT_STEP"]
    r = subprocess.run([sys.executable, script], env=env, timeout=120,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "completed").read_text() == "ok"
    with open(snaps / ckpt.MANIFEST) as f:
        assert json.load(f)["snapshots"][-1]["step"] == 12
    lines = [line.split() for line in
             (tmp_path / "stream.txt").read_text().splitlines()]
    assert [tuple(map(int, line[:2])) for line in lines[7:]] == \
        [(1, 1), (1, 2), (1, 3), (1, 4), (1, 5)]
