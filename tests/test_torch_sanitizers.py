"""The port's runtime sanitizers (mxnet_tpu_torch/analysis/sanitizers.py)
against the JAX package's on the CPU: parsing ``MXNET_TPU_SANITIZE``,
the retrace check after warmup, ABBA detection with both witnesses, the
deadlock watchdog on an injected progress signal; then what is the
port's own: the transfer guard as ``torch.cuda.set_sync_debug_mode``
(recorded, since the CPU build has no CUDA), the one-copy check, and the
wiring into fit, the fused step, the engine and the tracing plane."""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.analysis import sanitizers as jsan
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tracing as ttr
from mxnet_tpu_torch.analysis import sanitizers as tsan
import mxnet_tpu_torch as tmx

ENV = "MXNET_TPU_SANITIZE"


@pytest.fixture
def counting():
    """Telemetry on (trips are counters), empty before and after."""
    ttel.reset()
    ttel.enable()
    yield
    ttel.disable()
    ttel.reset()


@pytest.mark.parametrize("raw", ["", "transfer", "retrace, donation",
                                 "ALL", "locks,deadlock,locks", "all,bogus",
                                 "bogus", " , "])
def test_enabled_kinds_matches_jax(monkeypatch, raw):
    monkeypatch.setenv(ENV, raw)
    try:
        want = jsan.enabled_kinds()
    except jmx.MXNetError as e:
        with pytest.raises(tsan.SanitizerError) as got:
            tsan.enabled_kinds()
        assert str(got.value) == str(e)
        return
    assert tsan.enabled_kinds() == want
    for kind in tsan.KINDS:
        assert tsan.enabled(kind) == jsan.enabled(kind)


@pytest.mark.parametrize("warmup,counts", [
    (3, [0, 1, 1, 1, 1, 2]), (3, [0, 1, 2, 2, 2]), (0, [1, 1, 2]),
    (2, [5, 5, 5, 5])])
def test_retrace_after_warmup_matches_jax(warmup, counts):
    """The same capture counts step by step: both raise at the same step
    with the same message, or neither does."""
    mine, theirs = tsan.RetraceSanitizer(warmup), jsan.RetraceSanitizer(
        warmup)
    for n in counts:
        try:
            theirs.check(n)
        except jmx.MXNetError as e:
            with pytest.raises(tsan.SanitizerError) as got:
                mine.check(n)
            assert str(got.value) == str(e)
            return
        mine.check(n)


def _abba(mod):
    """A then B in one thread, then B then A in another: the second
    acquisition of A raises, before acquiring it."""
    reg = mod.LockOrderRegistry()
    a = mod.InstrumentedLock(threading.Lock(), "A", reg)
    b = mod.InstrumentedLock(threading.RLock(), "B", reg)
    with a:
        with b:
            with b:     # re-entrant: no edge
                pass
    err = []

    def other():
        with b:
            try:
                a.acquire()
            except mod.SanitizerError as e:
                err.append(e)

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not a._raw.locked() and not b._raw._is_owned()
    return str(err[0]) if err else None


def test_abba_is_caught_with_both_witnesses_as_in_jax():
    got, want = _abba(tsan), _abba(jsan)
    assert got is not None and want is not None
    head = got.split("\n")[0]
    assert head == want.split("\n")[0]
    assert "--- earlier 'A'-then-'B' acquisition ---" in got
    assert "--- this acquisition ---" in got
    assert got.count("_abba") >= 2      # both stacks name the acquirer


def test_instrumented_condition_keeps_its_semantics(counting):
    cond = tsan.InstrumentedLock(threading.Condition(), "cv",
                                 tsan.LockOrderRegistry())
    box = []

    def waiter():
        with cond:
            while not box:
                cond.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        box.append(1)
        cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()
    assert ttel.peek("lock.wait_ms") >= 2
    assert ttel.peek("lock.wait_ms.cv") >= 2


def test_maybe_instrument_and_the_engine_locks(monkeypatch):
    raw = threading.Lock()
    monkeypatch.delenv(ENV, raising=False)
    assert tsan.maybe_instrument(raw, "x") is raw
    eng = tmx.engine.ThreadedEngine(num_workers=1)
    assert not isinstance(eng._heap_lock, tsan.InstrumentedLock)
    monkeypatch.setenv(ENV, "locks")
    assert isinstance(tsan.maybe_instrument(raw, "x"), tsan.InstrumentedLock)
    eng = tmx.engine.ThreadedEngine(num_workers=2)
    assert isinstance(eng._heap_lock, tsan.InstrumentedLock)
    assert isinstance(eng._pending_lock, tsan.InstrumentedLock)
    out = []
    eng.push(lambda: out.append(1))
    eng.wait_for_all()
    assert out == [1]


def _watch(mod, progress, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CRASH_DIR", str(tmp_path))
    wd = mod.DeadlockWatchdog(progress, threshold_s=0.05, interval_s=0.01)
    wd.start()
    time.sleep(0.4)
    wd.stop()
    return wd


def test_watchdog_trips_once_a_stall_as_in_jax(tmp_path, monkeypatch,
                                               counting):
    """A flat signal: one trip and one dump a stall in both packages; a
    moving signal: none."""
    for mod in (tsan, jsan):
        wd = _watch(mod, lambda: 7, tmp_path / mod.__name__, monkeypatch)
        assert wd.trips == 1 and wd.last_dump is not None
        ticks = iter(range(10 ** 6))
        wd = _watch(mod, lambda: next(ticks), tmp_path / "moving",
                    monkeypatch)
        assert wd.trips == 0
    assert ttel.peek("sanitizer.trips.deadlock") == 1
    assert ttel.peek("sanitizer.trips") == 1


def test_tracing_starts_and_stops_the_watchdog(monkeypatch, counting):
    ttr.shutdown()
    monkeypatch.setenv(ENV, "deadlock")
    ttr.maybe_init()
    wd = ttr._watchdog
    assert isinstance(wd, tsan.DeadlockWatchdog) and wd._thread.is_alive()
    thread = wd._thread
    ttr.shutdown()
    assert ttr._watchdog is None and not thread.is_alive()
    monkeypatch.setenv(ENV, "")
    ttr.maybe_init()
    assert ttr._watchdog is None
    ttr.shutdown()


class _Modes:
    """``torch.cuda.set_sync_debug_mode`` recorded (the CPU build has no
    CUDA to set)."""

    def __init__(self, monkeypatch):
        self.seen = []
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                            self.seen.append)


def test_step_guard_arms_sync_errors_on_a_card_only(monkeypatch):
    modes = _Modes(monkeypatch)
    cuda = torch.device("cuda", 0)
    monkeypatch.setenv(ENV, "retrace")
    with tsan.step_guard(cuda):
        with tsan.intentional_transfer():
            pass
    monkeypatch.setenv(ENV, "transfer")
    with tsan.step_guard(torch.device("cpu")):
        pass
    assert modes.seen == []
    with tsan.intentional_transfer():
        pass
    assert modes.seen == []
    with tsan.step_guard(cuda):
        with tsan.intentional_transfer():
            with tsan.intentional_transfer():
                pass
            assert modes.seen[-1] == "default"
        with pytest.raises(ValueError):
            with tsan.intentional_transfer():
                raise ValueError("a failing reviewed read")
    assert modes.seen == ["error", "default", "default", "default",
                          "error", "default", "error", "default"]
    assert (tsan._sync.guards, tsan._sync.windows) == (0, 0)


def test_is_transfer_guard_error():
    assert tsan.is_transfer_guard_error(RuntimeError(
        "called a synchronizing CUDA operation"))
    assert not tsan.is_transfer_guard_error(RuntimeError("out of memory"))


def test_donation_check_holds_the_one_copy_promise(counting):
    a, b = torch.zeros(3), torch.ones(2)
    held = [(a, a.data_ptr()), (b, b.data_ptr())]
    tsan.DonationSanitizer.check("s", held, [a, b])
    with pytest.raises(tsan.SanitizerError, match="1 of 2 tensors"):
        tsan.DonationSanitizer.check("s", held, [a, b.clone()])
    a.set_(torch.zeros(30))
    with pytest.raises(tsan.SanitizerError, match="2 of 2 tensors"):
        tsan.DonationSanitizer.check("s", held, [a, b.clone()])
    assert ttel.peek("sanitizer.trips.donation") == 2


def _fit(after_batch=None, epochs=1):
    rng = np.random.RandomState(0)
    x = rng.randn(40, 6).astype(np.float32)
    y = rng.randint(0, 3, 40).astype(np.float32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())

    def cb(param):
        if after_batch is not None:
            after_batch(param, mod)

    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=epochs,
            initializer=tmx.init.Xavier(seed=1),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            batch_end_callback=cb, fused_step=True)
    return mod


def test_a_sanitized_fit_trips_on_nothing(monkeypatch, counting):
    """Every sanitizer armed on a fused fit (the CPU: the transfer guard
    has no device to guard): no trip, the same params as unarmed."""
    plain = _fit().get_params()[0]
    monkeypatch.setenv(ENV, "all")
    armed = _fit(epochs=1)
    assert ttel.peek("sanitizer.trips") is None
    for k, v in armed.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), plain[k].asnumpy())
    assert ttr._watchdog is not None
    ttr.shutdown()


def test_a_replaced_state_trips_the_one_copy_check(monkeypatch, counting):
    """A batch-end callback that replaces an optimizer state tensor: the
    next step finds the module holding a tensor the step did not write
    (on a card the step captures again and the retrace check raises)."""
    monkeypatch.setenv(ENV, "donation")

    def move(param, mod):
        if param.nbatch == 2:
            st = mod._updater.states[0]
            st._data = st._data.clone()

    with pytest.raises(tsan.SanitizerError, match="donation sanitizer"):
        _fit(move)
    assert ttel.peek("sanitizer.trips.donation") == 1


def test_fit_counts_a_transfer_trip_and_releases_the_guard(monkeypatch,
                                                           counting):
    """A batch raising torch's sync error inside the armed loop counts a
    transfer trip and re-raises; the guard is closed after."""
    modes = _Modes(monkeypatch)
    monkeypatch.setenv(ENV, "transfer")
    monkeypatch.setattr(tsan, "step_guard",
                        lambda device: tsan._counted(guards=1))

    def planted(param, mod):
        if param.nbatch == 1:
            raise RuntimeError("called a synchronizing CUDA operation")

    with pytest.raises(RuntimeError, match="synchronizing"):
        _fit(planted)
    assert ttel.peek("sanitizer.trips.transfer") == 1
    assert modes.seen[0] == "error" and modes.seen[-1] == "default"
    assert tsan._sync.guards == 0
