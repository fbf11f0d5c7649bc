"""The flight recorder and the preemption hooks, counterpart of that part
of ``mxnet_tpu/tracing.py`` (StepTrace, the anomaly detectors and the
metrics server are not ported yet: ROADMAP.md Queue A item 11, so a dump
holds no step ring and no numerics rows).

:class:`FlightRecorder` installs ``sys.excepthook`` and SIGTERM/SIGUSR1
handlers that dump the reason, all-thread stacks and a telemetry
snapshot into a crash directory. On SIGTERM it then runs the registered
preemption hooks and re-raises the signal, so the process ends as it
would have without the recorder, unless a hook returned ``"defer"``: the
hook's owner then re-delivers SIGTERM itself at its next safe point (the
checkpoint manager does so at the end of the step under way).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from . import env as _env
from . import telemetry as _tel

__all__ = ["FlightRecorder", "register_preempt_hook",
           "unregister_preempt_hook", "ensure_flight_recorder",
           "flight_recorder", "shutdown"]

_log = logging.getLogger(__name__)


def _format_all_stacks() -> str:
    """Every thread's current stack."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append("Thread %s (%d):" % (names.get(tid, "?"), tid))
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


# Callables run from the SIGTERM handler before the signal is re-raised
# (signal-handler context: keep them short). A hook that returns "defer"
# suppresses the re-raise and must re-deliver SIGTERM itself once it is
# safe. A hook's exception is logged and swallowed: a broken hook must not
# mask the preemption.
_preempt_hooks: List[Callable[[], Optional[str]]] = []
_preempt_lock = threading.Lock()


def register_preempt_hook(fn: Callable[[], Optional[str]]):
    """Run ``fn()`` on SIGTERM before termination proceeds."""
    with _preempt_lock:
        if fn not in _preempt_hooks:
            _preempt_hooks.append(fn)
    return fn


def unregister_preempt_hook(fn: Callable[[], Optional[str]]):
    with _preempt_lock:
        try:
            _preempt_hooks.remove(fn)
        except ValueError:
            pass


def _run_preempt_hooks() -> bool:
    """True when any hook deferred termination."""
    with _preempt_lock:
        hooks = list(_preempt_hooks)
    defer = False
    for fn in hooks:
        try:
            if fn() == "defer":
                defer = True
        except Exception as e:
            _log.error("preempt hook %r failed: %s", fn, e)
    return defer


class FlightRecorder:
    """Dumps the reason, all-thread stacks and a telemetry snapshot into
    ``crash_dir`` (default ``MXNET_TPU_CRASH_DIR``, else
    ``$TMPDIR/mxnet_tpu_crash``) on an unhandled exception, SIGTERM or
    SIGUSR1 (the run continues). ``install()`` chains the previous
    excepthook and signal handlers; ``uninstall()`` puts them back."""

    def __init__(self, crash_dir: Optional[str] = None):
        self.crash_dir = crash_dir or _env.get(
            "MXNET_TPU_CRASH_DIR",
            default=os.path.join(tempfile.gettempdir(), "mxnet_tpu_crash"))
        self._installed = False
        self._prev_excepthook = None
        self._prev_handlers: Dict[int, object] = {}
        self._dump_count = 0

    def dump(self, reason: str, exc_info=None) -> Optional[str]:
        """Write one dump directory and return its path; never raises (a
        broken disk must not mask the failure being recorded), None when
        the dump could not be written."""
        try:
            self._dump_count += 1
            d = os.path.join(self.crash_dir, "flight-%s-pid%d-%d"
                             % (time.strftime("%Y%m%dT%H%M%S"), os.getpid(),
                                self._dump_count))
            os.makedirs(d, exist_ok=True)
            meta = {"reason": reason, "ts": round(time.time(), 6),
                    "pid": os.getpid(), "argv": list(sys.argv)}
            if exc_info is not None and exc_info[0] is not None:
                meta["exception"] = "".join(
                    traceback.format_exception(*exc_info))
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
            with open(os.path.join(d, "stacks.txt"), "w") as f:
                f.write(_format_all_stacks())
            with open(os.path.join(d, "telemetry.json"), "w") as f:
                json.dump(_tel.snapshot(), f, indent=1)
            _log.error("flight recorder dump (%s) written to %s", reason, d)
            return d
        except Exception as e:
            _log.error("flight recorder dump failed: %s", e)
            return None

    def install(self) -> "FlightRecorder":
        if self._installed:
            return self
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                # not the main thread: the exception hook and dump() work
                pass
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _excepthook(self, etype, value, tb):
        self.dump("exception:%s" % etype.__name__, (etype, value, tb))
        (self._prev_excepthook or sys.__excepthook__)(etype, value, tb)

    def _on_signal(self, signum, frame):
        self.dump("signal:%s" % signal.Signals(signum).name)
        if signum != signal.SIGTERM:
            return
        if _run_preempt_hooks():
            return
        # the prior disposition back, then the signal again: termination
        # proceeds as it would have without the recorder
        prev = self._prev_handlers.get(signum)
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signum)


_init_lock = threading.Lock()
_flight_recorder: Optional[FlightRecorder] = None
_atexit_registered = False


def flight_recorder() -> Optional[FlightRecorder]:
    return _flight_recorder


def ensure_flight_recorder() -> FlightRecorder:
    """The process's flight recorder, installed on first call, with
    :func:`shutdown` registered at exit (the checkpoint manager's SIGTERM
    path needs its signal routing)."""
    global _flight_recorder, _atexit_registered
    with _init_lock:
        if _flight_recorder is None:
            _flight_recorder = FlightRecorder().install()
        if not _atexit_registered:
            import atexit

            atexit.register(shutdown)
            _atexit_registered = True
        return _flight_recorder


def shutdown():
    """Uninstall and drop the flight recorder. Idempotent."""
    global _flight_recorder
    with _init_lock:
        if _flight_recorder is not None:
            _flight_recorder.uninstall()
            _flight_recorder = None
