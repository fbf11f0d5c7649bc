"""Opt-in runtime sanitizers, counterpart of
``mxnet_tpu/analysis/sanitizers.py``, armed with ``MXNET_TPU_SANITIZE``
(a comma list, or ``all``):

``transfer``
    Runs ``fit``'s fused loop on a card under
    ``torch.cuda.set_sync_debug_mode("error")`` (the counterpart of
    ``jax.transfer_guard("disallow")``): a host read of a device value
    (``.item()``, ``.cpu()``, ``.tolist()``, a copy from pageable memory)
    raises at the batch that made it. The reviewed host reads (the
    metric's values, the numerics plane's pack, a snapshot's fetch) sit
    inside :func:`intentional_transfer`, which sets the mode back to
    ``"default"`` while any such window is open. The mode is
    process-wide, so a window opened by one thread also lets another
    thread's reads through meanwhile: the guard can miss a read, never
    invent one. A fit on the CPU moves nothing between host and card,
    so there the guard arms nothing.

``retrace``
    Raises :class:`SanitizerError` when the fused step captures again
    after ``MXNET_TPU_SANITIZE_WARMUP`` steps.

``donation``
    The port's one-copy promise, in place of the JAX package's check
    that donated buffers were consumed: after every fused step each
    weight, gradient and optimizer state the module holds is still the
    tensor the step's graph writes, at the same address.

``locks``
    :func:`maybe_instrument` wraps locks in :class:`InstrumentedLock`,
    which records each thread's acquisition order in a
    :class:`LockOrderRegistry` and raises *before* acquiring where the
    acquisition inverts an order the process has shown (an ABBA
    deadlock becomes a :class:`SanitizerError` carrying both witness
    stacks), and feeds the ``lock.wait_ms`` histograms.

``deadlock``
    A :class:`DeadlockWatchdog` thread (started by ``tracing.maybe_init``,
    stopped by ``tracing.shutdown``) polls a progress signal (the step
    counter); when it stalls past ``MXNET_TPU_WATCHDOG_S`` it counts
    ``sanitizer.trips.deadlock`` and dumps all-thread stacks through the
    flight recorder. It never raises.

Every trip counts ``sanitizer.trips`` and ``sanitizer.trips.<kind>``
before it raises.
"""
from __future__ import annotations

import contextlib
import threading
import time
import traceback

from .. import env as _env
from .. import telemetry as _tel
from ..base import MXNetError

__all__ = ["SanitizerError", "enabled", "enabled_kinds", "step_guard",
           "intentional_transfer", "record_trip", "RetraceSanitizer",
           "DonationSanitizer", "is_transfer_guard_error", "KINDS",
           "LockOrderRegistry", "InstrumentedLock", "maybe_instrument",
           "DeadlockWatchdog", "lock_order_registry"]

KINDS = ("transfer", "retrace", "donation", "locks", "deadlock")


class SanitizerError(MXNetError):
    """A runtime sanitizer detected the hazard it guards against."""


def enabled_kinds() -> frozenset:
    """The armed sanitizer kinds, parsed from the environment at each
    call (read per fit or step object, not per step)."""
    raw = _env.get("MXNET_TPU_SANITIZE").strip().lower()
    if not raw:
        return frozenset()
    kinds = {k.strip() for k in raw.split(",") if k.strip()}
    if "all" in kinds:
        return frozenset(KINDS)
    unknown = kinds - set(KINDS)
    if unknown:
        raise SanitizerError(
            "MXNET_TPU_SANITIZE: unknown sanitizer(s) %s (valid: %s, all)"
            % (sorted(unknown), ", ".join(KINDS)))
    return frozenset(kinds)


def enabled(kind: str) -> bool:
    return kind in enabled_kinds()


def record_trip(kind: str) -> None:
    """Count a trip (also when an upstream handler catches the raise)."""
    _tel.inc("sanitizer.trips")
    _tel.inc("sanitizer.trips.%s" % kind)


# ---------------------------------------------------------------------------
# transfer sanitizer
# ---------------------------------------------------------------------------

class _SyncGuard:
    """The process's sync-debug state: the mode is ``"error"`` while a
    step guard is open and no :func:`intentional_transfer` window is."""

    def __init__(self):
        self._lock = threading.Lock()
        self.guards = 0
        self.windows = 0

    def _apply(self):
        import torch

        torch.cuda.set_sync_debug_mode(
            "error" if self.guards and not self.windows else "default")

    def move(self, guards: int = 0, windows: int = 0):
        with self._lock:
            self.guards += guards
            self.windows += windows
            self._apply()


_sync = _SyncGuard()


@contextlib.contextmanager
def _counted(guards: int = 0, windows: int = 0):
    _sync.move(guards, windows)
    try:
        yield
    finally:
        _sync.move(-guards, -windows)


def step_guard(device=None):
    """Context manager for ``fit``'s fused loop on ``device``: with the
    transfer sanitizer armed and a CUDA device, synchronising CUDA calls
    raise inside it; otherwise a no-op."""
    if not enabled("transfer") or getattr(device, "type", None) != "cuda":
        return contextlib.nullcontext()
    return _counted(guards=1)


def intentional_transfer():
    """Context manager marking a reviewed host read of device values
    inside an armed step guard (the sync-debug mode goes back to
    ``"default"`` while it is open). A no-op where no guard is open."""
    if not _sync.guards:
        return contextlib.nullcontext()
    return _counted(windows=1)


def is_transfer_guard_error(exc: BaseException) -> bool:
    """True when ``exc`` is torch's refusal of a synchronising CUDA call
    under the sync-debug mode ``"error"``."""
    return "synchronizing cuda operation" in str(exc).lower()


# ---------------------------------------------------------------------------
# retrace sanitizer
# ---------------------------------------------------------------------------

class RetraceSanitizer:
    """Raises when the fused step captures again after warmup.

    ``check(recompiles)`` is called once a step with the cumulative
    count of captures (counted directly, so it works with telemetry off).
    The first ``warmup`` steps may capture freely; after that a growing
    count is a steady-state recapture."""

    def __init__(self, warmup: int = None):
        self.warmup = (warmup if warmup is not None
                       else _env.get("MXNET_TPU_SANITIZE_WARMUP"))
        self._steps = 0
        self._baseline = None

    def check(self, recompiles: int) -> None:
        self._steps += 1
        if self._steps <= self.warmup:
            self._baseline = recompiles
            return
        if self._baseline is None:
            self._baseline = recompiles
            return
        if recompiles > self._baseline:
            record_trip("retrace")
            raise SanitizerError(
                "retrace sanitizer: fused step recompiled at step %d "
                "(%d -> %d trace signatures) after a %d-step warmup — a "
                "steady-state retrace means some per-batch value is "
                "changing the trace (shape, dtype, or a Python-level "
                "config read). Inspect step.fused_recompiles / the "
                "RecompileDetector anomaly for the signature."
                % (self._steps, self._baseline, recompiles, self.warmup))


# ---------------------------------------------------------------------------
# donation sanitizer
# ---------------------------------------------------------------------------

class DonationSanitizer:
    """The fused step's one-copy promise."""

    @staticmethod
    def check(label: str, held, live) -> None:
        """``held``: ``(tensor, data_ptr)`` of each weight, gradient and
        optimizer state the step's graph writes, taken when it was
        captured; ``live``: the tensors the module holds after the step,
        in the same order. A tensor that is not the held one, or whose
        storage moved, means the module keeps a second copy that the step
        does not update."""
        held, live = list(held), list(live)
        moved = sum(1 for (t, ptr), cur in zip(held, live)
                    if cur is not t or cur.data_ptr() != ptr)
        moved += abs(len(held) - len(live))
        if moved:
            record_trip("donation")
            raise SanitizerError(
                "donation sanitizer: %d of %d tensors written by %s are "
                "no longer the ones the module holds after the step — a "
                "weight, gradient or optimizer state was replaced or "
                "reallocated, so the step updates a copy the module let "
                "go (copy into the held tensors instead of assigning)."
                % (moved, len(held), label))


# ---------------------------------------------------------------------------
# lock-order sanitizer
# ---------------------------------------------------------------------------

class LockOrderRegistry:
    """Process-wide record of observed lock-acquisition order.

    ``check_acquire(name)`` runs *before* blocking on the raw lock: for
    every lock the calling thread holds, ``(held, name)`` becomes an
    order edge. If the reverse edge was observed earlier, by any thread,
    the acquisition is an inversion that can deadlock, and it raises
    instead of acquiring, with both witness stacks. A ``Condition.wait``
    releasing its lock for a while is invisible here, which only makes
    the check conservative about order."""

    def __init__(self):
        self._tls = threading.local()
        self._edges = {}            # (first, second) -> witness stack
        self._reg_lock = threading.Lock()

    def _held(self):
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def check_acquire(self, name: str) -> None:
        held = self._held()
        if name in held:    # re-entrant (RLock): no new edge
            return
        stack = "".join(traceback.format_stack(limit=12)[:-2])
        with self._reg_lock:
            for h in held:
                prior = self._edges.get((name, h))
                if prior is not None:
                    record_trip("locks")
                    raise SanitizerError(
                        "lock-order sanitizer: acquiring %r while "
                        "holding %r, but the opposite order was "
                        "observed earlier in this process — an ABBA "
                        "inversion that deadlocks under the right "
                        "interleaving.\n--- earlier %r-then-%r "
                        "acquisition ---\n%s--- this acquisition ---\n%s"
                        % (name, h, name, h, prior, stack))
            for h in held:
                self._edges.setdefault((h, name), stack)

    def note_acquired(self, name: str) -> None:
        self._held().append(name)

    def note_released(self, name: str) -> None:
        held = self._held()
        # the innermost occurrence (LIFO)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    def reset(self):
        """Forget every edge."""
        with self._reg_lock:
            self._edges.clear()


_lock_registry = LockOrderRegistry()


def lock_order_registry() -> LockOrderRegistry:
    return _lock_registry


class InstrumentedLock:
    """A ``Lock`` / ``RLock`` / ``Condition`` that feeds the
    :class:`LockOrderRegistry` and the ``lock.wait_ms`` histograms;
    everything else (``wait``, ``notify``, ...) passes through to the raw
    object, so a wrapped Condition keeps its semantics."""

    def __init__(self, raw, name: str, registry=None):
        self._raw = raw
        self._name = name
        self._registry = registry or _lock_registry

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._registry.check_acquire(self._name)
        t0 = time.perf_counter()
        if timeout is None or timeout < 0:
            ok = self._raw.acquire(blocking)
        else:
            ok = self._raw.acquire(blocking, timeout)
        if ok:
            wait_ms = (time.perf_counter() - t0) * 1e3
            _tel.observe("lock.wait_ms", wait_ms)
            _tel.observe("lock.wait_ms.%s" % self._name, wait_ms)
            self._registry.note_acquired(self._name)
        return ok

    def release(self):
        self._raw.release()
        self._registry.note_released(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._raw, attr)

    def __repr__(self):
        return "InstrumentedLock(%r, %r)" % (self._name, self._raw)


def maybe_instrument(raw, name: str):
    """``raw`` in an :class:`InstrumentedLock` when the ``locks``
    sanitizer is armed, else ``raw`` itself (one environment read at
    construction, nothing a acquisition)."""
    if not enabled("locks"):
        return raw
    return InstrumentedLock(raw, name)


# ---------------------------------------------------------------------------
# deadlock watchdog
# ---------------------------------------------------------------------------

class DeadlockWatchdog:
    """Daemon thread that trips when a progress signal stalls.

    While ``progress_fn()`` keeps changing the watchdog is quiet; once it
    has been flat for ``threshold_s`` it dumps all-thread stacks through
    the flight recorder (the installed one, else a throwaway), then
    counts ``sanitizer.trips.deadlock``, and re-arms only after progress
    resumes: one dump a stall. It never raises."""

    def __init__(self, progress_fn=None, threshold_s: float = None,
                 interval_s: float = None):
        if progress_fn is None:
            from .. import tracing as _tracing

            def progress_fn():
                return _tracing.step_trace().step
        self._progress_fn = progress_fn
        self._threshold = (threshold_s if threshold_s is not None
                           else float(_env.get("MXNET_TPU_WATCHDOG_S")))
        self._interval = (interval_s if interval_s is not None
                          else float(
                              _env.get("MXNET_TPU_WATCHDOG_INTERVAL")))
        self._stop = threading.Event()
        self._thread = None
        self.trips = 0
        self.last_dump = None

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mxtorch-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=max(5.0, 2 * self._interval))
        self._thread = None

    def _dump(self, stalled_s: float, value):
        from .. import tracing as _tracing

        fr = _tracing.flight_recorder()
        if fr is None:
            fr = _tracing.FlightRecorder()
        try:
            return fr.dump("deadlock-watchdog: no progress for %.1fs "
                           "(signal stuck at %r)" % (stalled_s, value))
        except Exception:   # the dump must never kill the watchdog
            return None

    def _run(self):
        try:
            last = self._progress_fn()
        except Exception:
            last = None
        last_change = time.monotonic()
        tripped = False
        while not self._stop.wait(self._interval):
            try:
                cur = self._progress_fn()
            except Exception:
                continue
            now = time.monotonic()
            if cur != last:
                last, last_change, tripped = cur, now, False
                continue
            stalled = now - last_change
            if stalled >= self._threshold and not tripped:
                # dump before the trip is published: observers poll
                # ``trips`` and may release the very threads the dump
                # is meant to show
                tripped = True
                self.last_dump = self._dump(stalled, cur)
                record_trip("deadlock")
                self.trips += 1
