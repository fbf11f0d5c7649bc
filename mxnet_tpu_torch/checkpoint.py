"""Preemption-safe training: full-state snapshots at step granularity,
crash-safe on disk; counterpart of ``mxnet_tpu/checkpoint.py``.

A snapshot (:func:`snapshot`) holds everything the next step reads, so a
resumed run is bit-identical to an uninterrupted one: the params and aux
states, the optimizer states (one tensor a param, a tuple of them for
Adam, RMSProp and AdaDelta), the optimizer's update counts and schedule
(so Adam's bias correction goes on from its count), the
metric accumulators (host sums and the device ``(sum, count)``), the
data cursor as a count of batches consumed, and the executor's torch
generator. Its payload is numpy and Python only, in the JAX package's
format (``FORMAT``, the same keys), so either package restores the
other's snapshots: the port writes ``"rng": None`` (a torch generator
state means nothing to the JAX package) and keeps its generator under
``"rng_torch"``, which the JAX package ignores.

A restore (:func:`restore`) first checks every name and shape, then
copies into the tensors the module already holds: weights, aux states,
optimizer states, the metric accumulators and the generator. It never rebinds a
tensor, because a fused train step's CUDA graph reads and writes those
addresses and would go on updating replaced storage without a word.

On disk (:class:`SnapshotStore`) every file lands through a temporary
file, fsync and ``os.replace`` (:func:`atomic_writer`); the manifest is
written last and carries each snapshot's size and sha256, and
:meth:`SnapshotStore.load_latest` skips (and counts,
``ckpt.torn_skipped``) a file that fails either check or does not
unpickle, falling back to the previous snapshot.

:class:`CheckpointManager` (armed in ``Module.fit`` by
``MXNET_TPU_CKPT_DIR``) saves every ``MXNET_TPU_CKPT_EVERY_N_STEPS``
steps, resumes from the newest valid snapshot at fit() entry
(``MXNET_TPU_CKPT_RESUME``) and routes SIGTERM through the flight
recorder: mid-step the save waits for the step's end, between steps it
runs at once; then the signal is delivered again, so the process ends
as SIGTERM ends it. ``MXNET_TPU_CKPT_GRACE_S`` bounds that save.

Telemetry (when enabled): ``ckpt.saves``, ``ckpt.bytes``,
``ckpt.save_ms`` (serialise, hash, write), ``ckpt.snapshot_ms`` (the
capture: the device fetch and the per-param digests), ``ckpt.restores``, ``ckpt.restore_ms`` (read, check,
unpickle, copy in), ``ckpt.rollbacks``, ``ckpt.preempt_saves``,
``ckpt.preempt_abandoned``, ``ckpt.torn_skipped``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import signal
import socket
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import env as _env
from . import ndarray as nd
from . import telemetry as _tel
from .base import MXNetError
from .ndarray import _host_tensor, _to_numpy
from .optimizer import _states_to_numpy

__all__ = ["CheckpointError", "atomic_writer", "atomic_write_bytes",
           "atomic_ndarray_save", "param_digest", "snapshot", "restore",
           "SnapshotStore", "CheckpointManager", "maybe_manager"]

_log = logging.getLogger(__name__)

FORMAT = 1
MANIFEST = "MANIFEST.json"


class CheckpointError(MXNetError):
    """A snapshot could not be captured, written or restored."""


# ---------------------------------------------------------------------------
# crash-safe writes
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-replaced entry survives power loss;
    best effort (not every filesystem opens directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def atomic_writer(path: str, mode: str = "wb"):
    """Crash-safe replacement of ``path``: write a temporary file in the
    same directory (host and pid in its name, so concurrent writers never
    collide), flush and fsync it, ``os.replace`` it over the target and
    fsync the directory. A crash at any point leaves the whole old file or
    the whole new one; on failure the temporary file is removed and the
    target is untouched."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, ".%s.tmp-%s-%d" % (os.path.basename(path),
                                             socket.gethostname(),
                                             os.getpid()))
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_writer(path) as f:
        f.write(data)


def atomic_ndarray_save(fname, data) -> None:
    """Crash-safe :func:`mxnet_tpu_torch.ndarray.save`."""
    with atomic_writer(os.fspath(fname)) as f:
        nd.save_to_stream(f, data)


# ---------------------------------------------------------------------------
# full-state capture / restore
# ---------------------------------------------------------------------------

def _fetch(t: torch.Tensor) -> np.ndarray:
    return _to_numpy(t.detach().to("cpu", copy=True))


def param_digest(arr) -> str:
    """sha256 over a host param array's C-contiguous bytes, as the JAX
    package hashes it."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr)).tobytes()).hexdigest()


def _metric_leaves(eval_metric):
    from .metric import CompositeEvalMetric

    if isinstance(eval_metric, CompositeEvalMetric):
        return list(eval_metric.metrics)
    return [eval_metric]


def _bound(module):
    group = getattr(module, "_exec_group", None)
    if group is None:
        raise CheckpointError("module is not bound")
    return group, group.executor


def snapshot(module, eval_metric=None, train_data=None, *, step: int = 0,
             epoch: int = 0, nbatch: int = -1) -> Dict[str, Any]:
    """The full training state of a bound module as one picklable payload
    of numpy and Python values. On a card it first waits for the device,
    so no stream (the fused step's side stream included) is still writing
    what it reads."""
    group, ex = _bound(module)
    if ex._device.type == "cuda":
        torch.cuda.synchronize(ex._device)
    payload: Dict[str, Any] = {
        "format": FORMAT, "step": int(step), "epoch": int(epoch),
        "nbatch": int(nbatch), "dp": 1, "time": round(time.time(), 3)}
    payload["params"] = {n: _fetch(ex.arg_dict[n].handle)
                         for n in module._param_names if n in ex.arg_dict}
    payload["param_digests"] = {n: param_digest(v)
                                for n, v in payload["params"].items()}
    payload["aux"] = {n: _fetch(a.handle)
                      for n, a in zip(group.aux_names, ex.aux_arrays)}
    updater = getattr(module, "_updater", None)
    payload["updater_states"] = (None if updater is None
                                 else _states_to_numpy(updater.states))
    optimizer = getattr(module, "_optimizer", None)
    payload["optimizer"] = (None if optimizer is None
                            else optimizer.get_checkpoint_state())
    metrics = None
    if eval_metric is not None:
        metrics = []
        for leaf in _metric_leaves(eval_metric):
            acc = None
            if leaf._acc is not None:
                acc = tuple(np.float64(v) for v in _fetch(leaf._acc))
            metrics.append({"name": leaf.name,
                            "sum_metric": leaf.sum_metric,
                            "num_inst": leaf.num_inst, "device_acc": acc})
    payload["metrics"] = metrics
    payload["rng"] = None
    payload["rng_torch"] = {
        "executor": ex._generator().get_state().numpy().copy()}
    get = getattr(train_data, "get_checkpoint_state", None)
    payload["data_iter"] = get() if callable(get) else None
    return payload


def _check_slots(kind, saved, bound):
    """Every saved name has a bound slot of its shape, and every bound
    slot is in the snapshot."""
    for name, val in saved.items():
        arr = bound.get(name)
        if arr is None:
            raise CheckpointError(
                "snapshot %s '%s' has no slot in the bound executor (model "
                "changed since the save?)" % (kind, name))
        if tuple(arr.shape) != tuple(np.shape(val)):
            raise CheckpointError(
                "snapshot %s '%s' shape %s does not match bound shape %s"
                % (kind, name, tuple(np.shape(val)), tuple(arr.shape)))
    missing = sorted(set(bound) - set(saved))
    if missing:
        raise CheckpointError("bound %s %s not in the snapshot"
                              % (kind, missing))


def _copy_in(arr, val) -> None:
    with torch.no_grad():
        arr.handle.copy_(_host_tensor(np.asarray(val)))


def restore(payload: Dict[str, Any], module, eval_metric=None,
            train_data=None) -> Dict[str, Any]:
    """Write a :func:`snapshot` payload (the port's or the JAX
    package's) into a bound module in place. Every name and shape is
    checked before anything is written, and a mismatch raises
    :class:`CheckpointError` naming it. The data iterator, where given,
    seeks past the batches the snapshot had consumed. Returns the resume
    position ``{"epoch", "nbatch", "step", "dp"}``."""
    group, ex = _bound(module)
    if payload.get("format") != FORMAT:
        raise CheckpointError("unsupported snapshot format %r"
                              % (payload.get("format"),))
    saved_dp = int(payload.get("dp") or 0)
    if saved_dp > 1 or payload.get("mesh"):
        _log.info("snapshot saved on %s restores onto one device (params "
                  "and optimizer states are replicated there)",
                  payload.get("mesh") or "dp=%d" % saved_dp)
    params = {n: ex.arg_dict[n] for n in module._param_names
              if n in ex.arg_dict}
    aux = dict(zip(group.aux_names, ex.aux_arrays))
    _check_slots("param", payload["params"], params)
    _check_slots("aux state", payload.get("aux") or {}, aux)
    updater = getattr(module, "_updater", None)
    states = payload.get("updater_states")
    if states is not None and updater is not None:
        if not isinstance(states, dict):
            raise CheckpointError("snapshot optimizer states are a %s, not "
                                  "a dict by param index"
                                  % type(states).__name__)
        # create the states not created yet (a fresh state equals one
        # saved before its first update), so every one is checked here
        module._bound_states()
        try:
            for index, saved in states.items():
                if int(index) in updater.states:
                    updater._check_state(int(index),
                                         updater.states[int(index)], saved)
        except MXNetError as e:
            raise CheckpointError("snapshot %s" % e) from e
    leaves = None
    if payload.get("metrics") is not None and eval_metric is not None:
        leaves = _metric_leaves(eval_metric)
        if len(leaves) != len(payload["metrics"]):
            raise CheckpointError("snapshot has %d metric leaves, fit has %d"
                                  % (len(payload["metrics"]), len(leaves)))
    gen = ex._generator()
    rng_torch = (payload.get("rng_torch") or {}).get("executor")
    if rng_torch is not None and rng_torch.size != gen.get_state().numel():
        _log.warning("the snapshot's generator state (%d bytes) is not a %s "
                     "generator's; the random stream is not carried across",
                     rng_torch.size, ex._device.type)
        rng_torch = None

    for name, val in payload["params"].items():
        _copy_in(params[name], val)
    for name, val in (payload.get("aux") or {}).items():
        _copy_in(aux[name], val)
    if states is not None and updater is not None:
        updater.set_numpy_states(states)
    optimizer = getattr(module, "_optimizer", None)
    if payload.get("optimizer") is not None and optimizer is not None:
        optimizer.set_checkpoint_state(payload["optimizer"])
    for leaf, st in zip(leaves or (), payload.get("metrics") or ()):
        leaf.sum_metric = st["sum_metric"]
        leaf.num_inst = st["num_inst"]
        acc = st["device_acc"]
        if acc is None:
            if leaf._acc is not None:
                leaf._acc.zero_()
            continue
        # the step folds into an accumulator on the executor's device;
        # one elsewhere (or none yet) is no graph's, and is replaced
        if leaf._acc is None or leaf._acc.device != ex._device:
            leaf._acc = torch.zeros(2, dtype=torch.float64,
                                    device=ex._device)
        leaf._acc.copy_(torch.tensor([float(acc[0]), float(acc[1])],
                                     dtype=torch.float64))
    if payload.get("rng") is not None:
        _log.info("snapshot from the JAX package: its RNG stream is not "
                  "carried across; the executor's generator is left as it "
                  "is")
    if rng_torch is not None:
        gen.set_state(torch.from_numpy(np.ascontiguousarray(rng_torch)))
    seek = getattr(train_data, "set_checkpoint_state", None)
    if callable(seek):
        seek({"batches": int(payload.get("nbatch", -1)) + 1})
    _tel.inc("ckpt.restores")
    return {"epoch": int(payload["epoch"]), "nbatch": int(payload["nbatch"]),
            "step": int(payload["step"]), "dp": saved_dp}


# ---------------------------------------------------------------------------
# on-disk snapshot store
# ---------------------------------------------------------------------------

class SnapshotStore:
    """A directory of ``snap-<step>-<seq>.ckpt`` payload files and a
    ``MANIFEST.json`` that lists them oldest first with each file's
    ``sha256`` and ``bytes``. The data file is written before the
    manifest, so a crash between the two leaves the previous manifest and
    snapshot whole. :meth:`load_latest` walks the manifest newest first
    and trusts a file only when it exists, has its size and hash and
    unpickles to a payload of this format."""

    def __init__(self, directory: str, keep: Optional[int] = None):
        self.dir = os.fspath(directory)
        if keep is None:
            keep = _env.get("MXNET_TPU_CKPT_KEEP")
        self.keep = max(1, int(keep))
        os.makedirs(self.dir, exist_ok=True)
        self._seq = 0

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    def _read_manifest(self) -> dict:
        empty = {"format": FORMAT, "snapshots": []}
        path = self._manifest_path()
        try:
            with open(path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return empty
        except (OSError, ValueError) as e:
            _log.warning("unreadable checkpoint manifest %s (%s); treating "
                         "the store as empty", path, e)
            return empty
        if not isinstance(m, dict) or not isinstance(m.get("snapshots"),
                                                     list):
            _log.warning("malformed checkpoint manifest %s; treating the "
                         "store as empty", path)
            return empty
        return m

    def save(self, payload: Dict[str, Any], reason: str = "periodic",
             deadline: Optional[float] = None) -> Optional[str]:
        """Serialise and write one snapshot, then the manifest, then prune
        beyond ``keep``. Past ``deadline`` (``time.monotonic()``) once the
        payload is serialised, the save is abandoned before its write
        starts. Returns the file name, or None when abandoned."""
        t0 = time.perf_counter()
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(blob).hexdigest()
        if deadline is not None and time.monotonic() > deadline:
            _tel.inc("ckpt.preempt_abandoned")
            _log.warning("abandoning snapshot (reason=%s): grace deadline "
                         "passed before the write started; the previous "
                         "snapshot remains valid", reason)
            return None
        self._seq += 1
        fname = "snap-%08d-%03d.ckpt" % (int(payload.get("step", 0)),
                                         self._seq)
        atomic_write_bytes(os.path.join(self.dir, fname), blob)
        manifest = self._read_manifest()
        entry = {"file": fname, "step": int(payload.get("step", 0)),
                 "epoch": int(payload.get("epoch", 0)),
                 "nbatch": int(payload.get("nbatch", -1)),
                 "dp": int(payload.get("dp", 0)), "sha256": digest,
                 "bytes": len(blob), "time": round(time.time(), 3),
                 "reason": reason}
        if payload.get("param_digests"):
            entry["param_digests"] = payload["param_digests"]
        manifest["snapshots"].append(entry)
        drop = manifest["snapshots"][:-self.keep]
        manifest["snapshots"] = manifest["snapshots"][-self.keep:]
        # the manifest last, pointing only at files written whole
        atomic_write_bytes(self._manifest_path(),
                           json.dumps(manifest, indent=1).encode())
        for old in drop:
            try:
                os.unlink(os.path.join(self.dir, old["file"]))
            except OSError:
                pass
        _tel.inc("ckpt.saves")
        _tel.inc("ckpt.bytes", len(blob))
        _tel.observe("ckpt.save_ms", (time.perf_counter() - t0) * 1e3)
        return fname

    def load_latest(self):
        """``(payload, manifest entry)`` of the newest valid snapshot, or
        None when there is none; a torn or corrupt file is skipped with a
        warning naming it."""
        for entry in reversed(self._read_manifest()["snapshots"]):
            path = os.path.join(self.dir, str(entry.get("file", "")))
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                if len(blob) != int(entry.get("bytes", -1)):
                    raise CheckpointError(
                        "size mismatch (manifest says %s bytes, file has "
                        "%d: torn write?)" % (entry.get("bytes"), len(blob)))
                if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
                    raise CheckpointError("content hash mismatch")
                payload = pickle.loads(blob)
                if not isinstance(payload, dict) \
                        or payload.get("format") != FORMAT:
                    raise CheckpointError("unsupported payload format")
            except (OSError, CheckpointError, pickle.UnpicklingError,
                    EOFError, ValueError, AttributeError,
                    ImportError) as e:
                _tel.inc("ckpt.torn_skipped")
                _log.warning("skipping torn/corrupt checkpoint %s: %s "
                             "(falling back to the previous snapshot)",
                             path, e)
                continue
            return payload, entry
        return None


# ---------------------------------------------------------------------------
# fit-loop manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """The snapshot cadence, resume and SIGTERM grace path of one fit()
    run. ``Module.fit`` creates one through :func:`maybe_manager`, calls
    :meth:`maybe_restore` before the epoch loop, brackets each batch with
    :meth:`step_begin`/:meth:`step_end`, and arms the preemption hook
    around the loop."""

    def __init__(self, module, eval_metric=None, train_data=None,
                 directory: Optional[str] = None,
                 every_n: Optional[int] = None,
                 keep: Optional[int] = None,
                 grace_s: Optional[float] = None):
        directory = directory or _env.get("MXNET_TPU_CKPT_DIR")
        if not directory:
            raise CheckpointError("CheckpointManager needs a directory "
                                  "(set MXNET_TPU_CKPT_DIR)")
        self._module = module
        self._metric = eval_metric
        self._data = train_data
        self._every_n = int(every_n if every_n is not None
                            else _env.get("MXNET_TPU_CKPT_EVERY_N_STEPS"))
        self._grace_s = float(grace_s if grace_s is not None
                              else _env.get("MXNET_TPU_CKPT_GRACE_S"))
        self.store = SnapshotStore(directory, keep=keep)
        self.global_step = 0
        self._epoch = 0
        self._nbatch = -1
        # the SIGTERM hook runs on the main thread between bytecodes, so
        # plain attributes suffice; _in_step spans the host's enqueue of a
        # step, while the bound tensors are being rewritten
        self._in_step = False
        self._exit_after_step = False
        self._preempt_at: Optional[float] = None
        self._armed = False

    def _restore_latest(self, train_data):
        t0 = time.perf_counter()
        found = self.store.load_latest()
        if found is None:
            return None, None
        payload, entry = found
        info = restore(payload, self._module, self._metric, train_data)
        _tel.observe("ckpt.restore_ms", (time.perf_counter() - t0) * 1e3)
        self.global_step = info["step"]
        self._epoch, self._nbatch = info["epoch"], info["nbatch"]
        return info, entry

    def maybe_restore(self) -> Optional[Dict[str, Any]]:
        """Restore the newest valid snapshot and seek the data iterator
        (when ``MXNET_TPU_CKPT_RESUME`` is on); the resume position, or
        None."""
        if not _env.get("MXNET_TPU_CKPT_RESUME"):
            return None
        info, entry = self._restore_latest(self._data)
        if info is not None:
            _log.info("resumed from snapshot %s: step %d (epoch %d, batch "
                      "%d)", entry.get("file"), info["step"], info["epoch"],
                      info["nbatch"])
        return info

    def step_begin(self) -> None:
        self._in_step = True

    def step_end(self, epoch: int, nbatch: int) -> None:
        """After each batch: a deferred preemption saves and delivers
        SIGTERM again; otherwise the periodic cadence."""
        self._in_step = False
        self.global_step += 1
        self._epoch, self._nbatch = epoch, nbatch
        if self._exit_after_step:
            self._exit_after_step = False
            deadline = (self._preempt_at or time.monotonic()) + self._grace_s
            self._save("preempt", deadline=deadline)
            self._reraise_sigterm()
            return
        if self._every_n > 0 and self.global_step % self._every_n == 0:
            self._save("periodic")

    def save_now(self, reason: str = "manual") -> Optional[str]:
        return self._save(reason)

    def rollback(self, reason: str = "guard") -> Optional[Dict[str, Any]]:
        """Restore the newest valid snapshot into the live module mid-run,
        whatever ``MXNET_TPU_CKPT_RESUME`` says; the data iterator is left
        alone. Under a captured fused step the next replay reads the
        restored values. Returns the restored position, or None when the
        store holds no valid snapshot."""
        info, entry = self._restore_latest(None)
        if info is None:
            return None
        _tel.inc("ckpt.rollbacks")
        _log.warning("rolled back (reason=%s) to snapshot %s: step %d "
                     "(epoch %d, batch %d)", reason, entry.get("file"),
                     info["step"], info["epoch"], info["nbatch"])
        return info

    def _save(self, reason: str,
              deadline: Optional[float] = None) -> Optional[str]:
        try:
            t0 = time.perf_counter()
            payload = snapshot(self._module, self._metric, self._data,
                               step=self.global_step, epoch=self._epoch,
                               nbatch=self._nbatch)
            _tel.observe("ckpt.snapshot_ms", (time.perf_counter() - t0) * 1e3)
            if deadline is not None and time.monotonic() > deadline:
                _tel.inc("ckpt.preempt_abandoned")
                _log.warning("abandoning snapshot (reason=%s): grace "
                             "deadline passed during the device fetch; the "
                             "previous snapshot remains valid", reason)
                return None
            fname = self.store.save(payload, reason=reason,
                                    deadline=deadline)
        except Exception as e:
            # a failed save must not end a healthy run (and the preempt
            # path ends it anyway); the previous snapshot is on disk
            _log.error("checkpoint save failed (reason=%s): %s", reason, e,
                       exc_info=True)
            return None
        if fname is not None and reason == "preempt":
            _tel.inc("ckpt.preempt_saves")
        return fname

    def arm(self) -> "CheckpointManager":
        """Route SIGTERM through the save-then-exit path (installs the
        flight recorder)."""
        if self._armed:
            return self
        from . import tracing as _tracing

        _tracing.ensure_flight_recorder()
        _tracing.register_preempt_hook(self._on_preempt)
        self._armed = True
        return self

    def disarm(self) -> None:
        if not self._armed:
            return
        from . import tracing as _tracing

        _tracing.unregister_preempt_hook(self._on_preempt)
        self._armed = False

    def _on_preempt(self) -> Optional[str]:
        """The SIGTERM hook: mid-step, defer to :meth:`step_end`; between
        steps the state is whole, so save here and let termination
        proceed."""
        self._preempt_at = time.monotonic()
        if self._in_step:
            self._exit_after_step = True
            return "defer"
        self._save("preempt", deadline=self._preempt_at + self._grace_s)
        return None

    @staticmethod
    def _reraise_sigterm() -> None:
        try:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_manager(module, eval_metric=None,
                  train_data=None) -> Optional[CheckpointManager]:
    """A :class:`CheckpointManager` when ``MXNET_TPU_CKPT_DIR`` is set and
    the module is bound, else None."""
    directory = _env.get("MXNET_TPU_CKPT_DIR")
    if not directory or getattr(module, "_exec_group", None) is None:
        return None
    return CheckpointManager(module, eval_metric, train_data,
                             directory=directory)
