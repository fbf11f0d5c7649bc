"""The port's registry of ``MXNET_TPU_*`` environment variables,
counterpart of ``mxnet_tpu/env.py``.

Every variable the port reads is declared here once, with the JAX
package's name, type and default, and read through :func:`get`
(reading an undeclared name raises). ``docs/env_vars_torch.md`` holds
the block :func:`generate_docs` makes from these declarations
(:func:`sync_docs` writes or checks it); ``docs/env_vars.md`` stays
the JAX package's. Only the variables the port reads are declared.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

__all__ = ["EnvVar", "declare", "get", "is_set", "declared", "var",
           "generate_docs", "sync_docs", "DOC_BEGIN", "DOC_END"]

_UNSET = object()


class EnvVar:
    """One declared variable: name, type, default, doc and section."""

    __slots__ = ("name", "type", "default", "doc", "section")

    def __init__(self, name: str, type_: type, default, doc: str,
                 section: str):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc
        self.section = section

    def coerce(self, raw: str):
        if self.type is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        if self.type is int:
            return int(raw)
        if self.type is float:
            return float(raw)
        return raw


_REGISTRY: Dict[str, EnvVar] = {}
_SECTIONS: List[str] = []


def declare(name: str, type_: type, default, doc: str,
            section: str = "General") -> EnvVar:
    """Register ``name``, once."""
    if name in _REGISTRY:
        raise ValueError("env var %r declared twice" % name)
    v = EnvVar(name, type_, default, doc, section)
    _REGISTRY[name] = v
    if section not in _SECTIONS:
        _SECTIONS.append(section)
    return v


def var(name: str) -> EnvVar:
    """The declaration of ``name`` (KeyError if undeclared)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            "env var %r is not declared in mxnet_tpu_torch/env.py; declare "
            "it there (name, type, default, doc) before reading it" % name)


def get(name: str, default: Any = _UNSET):
    """A declared variable's value, coerced to its type; unset gives the
    declared default, or ``default`` where the caller passes one."""
    v = var(name)
    raw = os.environ.get(name)
    if raw is None:
        return v.default if default is _UNSET else default
    return v.coerce(raw)


def is_set(name: str) -> bool:
    """True when the (declared) variable is in the environment."""
    var(name)
    return name in os.environ


def declared() -> Dict[str, EnvVar]:
    """Name -> declaration."""
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

declare("MXNET_TPU_FUSED_STEP", bool, False,
        "`Module.fit` (and `FeedForward.fit` through it) runs forward, "
        "backward, the SGD update and, where the metric folds on the "
        "device, the metric fold as one fused train step a batch: one "
        "CUDA graph, captured at the second batch and replayed for every "
        "later one, on a card; the same step function run eagerly on the "
        "CPU. An explicit `fit(fused_step=True)` or `False` wins over the "
        "variable. There is no fallback: a configuration the step cannot "
        "run (a kvstore other than `local`, `inputs_need_grad=True`, a "
        "monitor with a custom `stat_func`, `grad_req=\"add\"`, an "
        "optimizer other than SGD) raises naming the reason, under the "
        "variable as under the argument.",
        section="Training")

_IN = "Input pipeline"
declare("MXNET_TPU_DEVICE_STAGING", bool, False,
        "`fit()` wraps the training iterator in `DeviceStagingIter`: batch "
        "N+1 is copied into a pinned host buffer and sent to the card on a "
        "copy stream while step N runs, so the host-to-device copy "
        "overlaps the step instead of running in series with it.",
        section=_IN)
declare("MXNET_TPU_FEED_DEPTH", int, 0,
        "`fit()` wraps the training iterator in a `FeedScheduler`: a "
        "worker thread keeps N staged batches in flight ahead of the step "
        "loop (generalizes `MXNET_TPU_DEVICE_STAGING`'s double buffer; "
        "subsumes it when both are set). The time each step blocks on an "
        "empty queue lands in the `io.feed_stall_ms` histogram for "
        "StepTrace's dominant-cause labeling. Default 0 (off).",
        section=_IN)
declare("MXNET_TPU_DECODE_PROCS", int, 0,
        "Decode image records with N worker processes (the same as "
        "`ImageRecordIter(..., preprocess_mode=\"process\")`). Process "
        "decode is not ported: above 0, `ImageRecordIter` raises "
        "`MXNetError` rather than decode on threads. Default 0: the thread "
        "pool (`preprocess_threads`).", section=_IN)

_TEL = "Telemetry"
declare("MXNET_TPU_TELEMETRY", bool, False,
        "Enable the metric registry (`mxnet_tpu_torch.telemetry`): "
        "counters, gauges, histograms and host spans, such as the "
        "checkpoint manager's `ckpt.*`. Off by default; the disabled path "
        "is one module-flag check a call. `telemetry.enable()` does the "
        "same at run time.", section=_TEL)
declare("MXNET_TPU_TELEMETRY_SPAN_CAP", int, 8192,
        "Bound on the buffered host-span ring; the oldest spans are "
        "dropped first.", section=_TEL)

_TR = "Flight recorder"
declare("MXNET_TPU_CRASH_DIR", str, "",
        "Where flight-recorder dumps land (default "
        "`$TMPDIR/mxnet_tpu_crash`): the reason, the process, all-thread "
        "stacks, a telemetry snapshot, the step-trace ring "
        "(`steps.jsonl`) and the numerics plane's health rows "
        "(`numwatch.jsonl`), written on an unhandled exception, SIGTERM "
        "(dump, run the preemption hooks, then terminate) and SIGUSR1 "
        "(dump and keep running). The checkpoint manager installs the "
        "recorder for its SIGTERM path.", section=_TR)

_T = "Tracing (all require telemetry enabled)"
declare("MXNET_TPU_METRICS_PORT", str, "",
        "Start the live metrics server on this port at `fit()` entry: "
        "Prometheus text format at `/metrics` (every sample labeled "
        "`rank=\"N\"`), liveness JSON at `/healthz`. Port `0` binds an "
        "ephemeral port (tests). Unset: no server thread.", section=_T)
declare("MXNET_TPU_TRACE_ON_ANOMALY", bool, False,
        "Anomaly events (slow step, steady-state recapture, input-stalled "
        "step, numerics alarms) open a short, rate-limited "
        "`torch.profiler` window while the evidence is still happening.",
        section=_T)
declare("MXNET_TPU_TRACE_DIR", str, "",
        "Where anomaly trace windows are written (default "
        "`$TMPDIR/mxnet_tpu_anomaly_trace/step<N>_<type>`).", section=_T)
declare("MXNET_TPU_TRACE_WINDOW", int, 8,
        "Steps an anomaly-triggered capture stays open.", section=_T)
declare("MXNET_TPU_TRACE_COOLDOWN", float, 300.0,
        "Seconds between anomaly-triggered captures; triggers inside the "
        "cooldown are counted (`tracing.auto_trace_suppressed`) but not "
        "traced.", section=_T)
declare("MXNET_TPU_TRACE_RING", int, 512,
        "Per-step records kept in the step-trace ring.", section=_T)
declare("MXNET_TPU_TRACE_EVENT_COOLDOWN", int, 10,
        "Minimum steps between two anomaly events of the same type, "
        "bounding event spam from a persistently degraded run.",
        section=_T)
declare("MXNET_TPU_FLIGHT_RECORDER", bool, False,
        "Install the crash-dump hooks at `fit()` entry: unhandled "
        "exception, SIGTERM (dump then terminate normally) and SIGUSR1 "
        "(dump and keep running) write into `MXNET_TPU_CRASH_DIR`.",
        section=_T)

_NW = "Numerics observability (numwatch)"
declare("MXNET_TPU_NUMWATCH", bool, False,
        "Arm the numerics plane (`mxnet_tpu_torch.numwatch`): per-tensor "
        "gradient, weight and update statistics fold into a small float32 "
        "stats pack inside the fused train step (inside its CUDA graph on "
        "a card; no extra replay) and are fetched to the host only on the "
        "`MXNET_TPU_NUMWATCH_EVERY_N` cadence. Also armed by a default-"
        "stat `Monitor` passed to `fit`.", section=_NW)
declare("MXNET_TPU_NUMWATCH_EVERY_N", int, 50,
        "Host-fetch cadence (steps) for the stats pack. Each fetch is one "
        "small device-to-host copy that updates `numwatch.*` telemetry, "
        "the health ring and the anomaly detectors' inputs.", section=_NW)
declare("MXNET_TPU_NUMWATCH_GUARD", str, "",
        "Guarded-training actions, comma-separated, off by default. "
        "`skip`: a select on a device predicate drops any update whose "
        "gradients hold NaN/Inf (weights, momenta and metric sums keep "
        "their pre-step values bit for bit; no host sync). `rollback`: on "
        "a fetch that sees nonfinite weights, restore the last healthy "
        "snapshot through the CheckpointManager (needs "
        "`MXNET_TPU_CKPT_DIR` or a bound manager). Both are counted "
        "(`numwatch.skipped_steps`, `numwatch.rollbacks`) and "
        "rate-limited.", section=_NW)
declare("MXNET_TPU_NUMWATCH_SPIKE_K", float, 3.0,
        "Loss-spike detector threshold: fire `loss_spike` when the fetched "
        "loss exceeds this multiple of its rolling median.", section=_NW)
declare("MXNET_TPU_NUMWATCH_EXPLODE_K", float, 10.0,
        "Grad-explosion detector threshold: fire `grad_explosion` when the "
        "fetched global gradient norm exceeds this multiple of its rolling "
        "median.", section=_NW)
declare("MXNET_TPU_NUMWATCH_DEAD_UW", float, 1e-9,
        "Dead-update detector threshold: fire `dead_update` when the "
        "largest per-tensor update-to-weight ratio falls below this while "
        "gradients are still nonzero.", section=_NW)
declare("MXNET_TPU_NUMWATCH_MAX_SKIPS", int, 100,
        "Rate limit for the `skip` guard: past this many skipped steps "
        "numwatch logs an error, counts `numwatch.skip_cap_exceeded` and, "
        "with the rollback guard armed, escalates to a rollback.",
        section=_NW)
declare("MXNET_TPU_NUMWATCH_ROLLBACK_COOLDOWN", int, 200,
        "Rate limit for the `rollback` guard: at least this many steps "
        "between two rollbacks; a model still nonfinite inside the "
        "cooldown raises `NumericsError` instead of thrashing the "
        "snapshot store.", section=_NW)

_C = "Checkpointing"
declare("MXNET_TPU_CKPT_DIR", str, "",
        "Directory for step-granularity full-state training snapshots "
        "(params, aux states, SGD momenta, optimizer counters, metric "
        "accumulators, data cursor, the executor's torch generator; see "
        "`mxnet_tpu_torch/checkpoint.py`). Setting it arms the checkpoint "
        "manager inside `Module.fit`: periodic saves at "
        "`MXNET_TPU_CKPT_EVERY_N_STEPS`, a SIGTERM checkpoint-then-exit "
        "grace path, and resume from the newest valid snapshot at the "
        "next fit() (`MXNET_TPU_CKPT_RESUME`). A restore copies into the "
        "bound tensors in place, so a captured fused step replays on the "
        "restored values. Unset disables all of it.", section=_C)
declare("MXNET_TPU_CKPT_EVERY_N_STEPS", int, 0,
        "Save a full-state snapshot every N training steps (batches). `0` "
        "disables periodic saves; with `MXNET_TPU_CKPT_DIR` set the "
        "SIGTERM grace path still writes a final snapshot on preemption.",
        section=_C)
declare("MXNET_TPU_CKPT_KEEP", int, 2,
        "How many snapshots to retain in `MXNET_TPU_CKPT_DIR`; older ones "
        "are pruned after each successful save. Keep >= 2 so a write torn "
        "by the preemption itself leaves a loadable previous snapshot.",
        section=_C)
declare("MXNET_TPU_CKPT_RESUME", bool, True,
        "Auto-resume: when `MXNET_TPU_CKPT_DIR` holds a valid snapshot, "
        "`Module.fit` restores it and continues from the saved step. `0` "
        "trains from scratch while still saving snapshots.", section=_C)
declare("MXNET_TPU_CKPT_GRACE_S", float, 25.0,
        "Deadline budget (seconds) for the SIGTERM grace save: a "
        "snapshot whose device fetch and serialisation exceed it is "
        "abandoned before its write starts (`ckpt.preempt_abandoned`); "
        "the previous snapshot stays valid either way.", section=_C)


# ---------------------------------------------------------------------------
# docs generation
# ---------------------------------------------------------------------------

DOC_BEGIN = ("<!-- BEGIN MXNET_TPU_TORCH ENV REGISTRY (generated from "
             "mxnet_tpu_torch/env.py by env.sync_docs; do not edit by "
             "hand) -->")
DOC_END = "<!-- END MXNET_TPU_TORCH ENV REGISTRY -->"


def _fmt_default(v: EnvVar) -> str:
    if v.type is bool:
        return "`1`" if v.default else "`0`"
    if v.type is str:
        return "unset" if v.default == "" else "`%s`" % v.default
    return "`%s`" % (v.default,)


def generate_docs() -> str:
    """The generated block: every declared variable, by section, in
    declaration order."""
    out = [DOC_BEGIN, ""]
    for section in _SECTIONS:
        out.append("## %s" % section)
        out.append("")
        for v in _REGISTRY.values():
            if v.section == section:
                out.append("- `%s` (%s, default %s) — %s"
                           % (v.name, v.type.__name__, _fmt_default(v),
                              v.doc))
        out.append("")
    out.append(DOC_END)
    return "\n".join(out)


def sync_docs(path: str, check: bool = False) -> bool:
    """Rewrite (or with ``check=True`` only compare) the block between
    :data:`DOC_BEGIN` and :data:`DOC_END` in ``path``. True when the
    file already matched."""
    with open(path) as f:
        text = f.read()
    try:
        head, rest = text.split(DOC_BEGIN, 1)
        _, tail = rest.split(DOC_END, 1)
    except ValueError:
        raise ValueError("%s has no %r...%r markers"
                         % (path, DOC_BEGIN[:30], DOC_END))
    new = head + generate_docs() + tail
    if new == text:
        return True
    if check:
        return False
    with open(path, "w") as f:
        f.write(new)
    return False
