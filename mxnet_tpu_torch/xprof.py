"""Device observability, counterpart of ``mxnet_tpu/xprof.py``: the
compile registry, the op breakdown of a profiled step, roofline
analytics, and device-memory accounting.

* **CompileRegistry**: the port compiles nothing when it runs a graph,
  but it builds: each CUDA-graph capture of the fused step, each NVRTC
  compile of an ``Rtc`` body and each kernel library ``nvcc`` builds
  (``_build.py``). With ``MXNET_TPU_XPROF`` (or :func:`enable`) each
  build is a :class:`CompileRecord`: site, wall time, argument signature
  (:func:`leaf_signature`, the JAX package's format) and, for a capture,
  the FLOPs of the eager step before it. A rebuild at a site carries a
  retrace cause naming what changed, e.g. ``(64,224,224,3)float32 ->
  (32,224,224,3)float32 on data`` (:func:`diff_signatures`). Builds feed
  ``compile.count`` and ``compile.time_ms`` (StepTrace's ``compiles`` and
  ``compile_ms``) and :func:`last_retrace_cause` (the RecompileDetector's
  ``cause``).
* **Op breakdown**: there is no HLO. :func:`kernel_breakdown` sorts the
  kernel events of a profiled step (``torch.profiler``) into conv / dot
  / elementwise / copy / reduction / collective / other by kernel name
  (K3 and cuBLAS are dot, cuDNN's convolutions conv); each event lands
  in exactly one category, so the categories sum to the totals by
  construction. :func:`count_flops` takes a step's FLOPs by category
  from ``torch.utils.flop_counter.FlopCounterMode`` over its aten ops
  plus K3's products, which run outside aten. :func:`analyze` gives the
  roofline numbers against the card's peaks.
* **Device memory**: :func:`hbm_stats`, :class:`HbmWatermark`,
  :func:`device_memory_limit` and :func:`preflight_check` read
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``. On the
  CPU there is no device memory to read: they return None.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import env as _env
from . import telemetry as _tel
from .base import MXNetError

__all__ = [
    "enabled", "enable", "disable", "reset", "record_compile",
    "maybe_record", "records", "summary", "last_retrace_cause",
    "leaf_signature", "diff_signatures", "kernel_category",
    "kernel_breakdown", "profile_breakdown", "count_flops", "analyze",
    "chip_peak_tflops", "chip_hbm_gbps", "hbm_stats", "HbmWatermark",
    "preflight_check", "device_memory_limit", "CompileRecord",
    "CATEGORIES",
]

# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

_override: Optional[bool] = None


def enabled() -> bool:
    """``MXNET_TPU_XPROF``, or what :func:`enable` / :func:`disable`
    set last."""
    if _override is not None:
        return _override
    return bool(_env.get("MXNET_TPU_XPROF"))


def enable():
    global _override
    _override = True


def disable():
    global _override
    _override = False


# ---------------------------------------------------------------------------
# compile registry
# ---------------------------------------------------------------------------

class CompileRecord:
    """One measured build at a site. Fields the port cannot measure for
    a build (the bytes of an XLA executable's memory analysis) stay
    None."""

    __slots__ = ("site", "seq", "compile_time_s", "signature", "flops",
                 "bytes_accessed", "argument_bytes", "output_bytes",
                 "temp_bytes", "peak_bytes", "generated_code_bytes",
                 "op_breakdown", "retrace_cause", "num_devices", "ts")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in self.__slots__}
        d["signature"] = [[n, list(a[0]), a[1]]
                          + ([a[3]] if len(a) > 3 and a[3] else [])
                          for n, a in (self.signature or ())]
        return d


_lock = threading.RLock()
_records: List[CompileRecord] = []
_sites: Dict[str, dict] = {}
_last_cause: Optional[str] = None
_seq = 0


def reset():
    """Clear the records and per-site state (not the enable override)."""
    global _last_cause, _seq
    with _lock:
        del _records[:]
        _sites.clear()
        _last_cause = None
        _seq = 0


def records() -> List[CompileRecord]:
    with _lock:
        return list(_records)


def last_retrace_cause() -> Optional[str]:
    """The latest rebuild's signature diff, ``"<site>: <diff>"`` (None
    before any)."""
    return _last_cause


# -- argument signatures ----------------------------------------------------

def _dtype_name(x) -> str:
    dt = getattr(x, "dtype", None)
    if dt is None:
        return type(x).__name__
    return str(dt).replace("torch.", "")


def _aval(x) -> tuple:
    """(shape, dtype, weak type, placement): tensors and numpy arrays
    give their dtype's numpy name; the port places nothing across
    devices, so placement is None."""
    shape = tuple(int(d) for d in getattr(x, "shape", ()) or ())
    return (shape, _dtype_name(x), False, None)


def _fmt_aval(a) -> str:
    shape, dtype = a[0], a[1]
    placed = a[3] if len(a) > 3 and a[3] else ""
    return "(%s)%s%s" % (",".join(str(d) for d in shape), dtype,
                         "@" + placed if placed else "")


def _leaves(x, path=""):
    """(key path, leaf) over nested lists, tuples and dicts, keyed as
    ``jax.tree_util.keystr`` keys them (``[0]``, ``['name']``); None is
    an empty subtree."""
    if x is None:
        return
    if isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, "%s[%d]" % (path, i))
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], "%s[%r]" % (path, k))
    else:
        yield path, x


def leaf_signature(args, arg_names=None) -> tuple:
    """``((name, (shape, dtype, weak_type, placement)), ...)`` over the
    leaves of the positional ``args``. ``arg_names[i]`` labels arg i; a
    list entry names that argument's leaves one by one (the fused step
    passes the executor's argument names, so a diff says ``data``)."""
    specs = []
    for i, a in enumerate(args):
        name = arg_names[i] if arg_names and i < len(arg_names) else None
        for j, (kp, leaf) in enumerate(_leaves(a)):
            if isinstance(name, (list, tuple)):
                label = name[j] if j < len(name) else "arg%d%s" % (i, kp)
            elif name:
                label = name + kp
            else:
                label = "arg%d%s" % (i, kp)
            specs.append((label, _aval(leaf)))
    return tuple(specs)


def diff_signatures(prev, cur) -> Optional[str]:
    """The rebuild's cause in words: which leaves changed."""
    if prev is None or prev == cur:
        return None
    if len(prev) != len(cur):
        return ("argument tree changed: %d -> %d leaves"
                % (len(prev), len(cur)))
    changes = ["%s -> %s on %s" % (_fmt_aval(pa), _fmt_aval(ca), cn)
               for (_pn, pa), (cn, ca) in zip(prev, cur) if pa != ca]
    if not changes:
        return "argument names changed (same avals)"
    head = "; ".join(changes[:3])
    if len(changes) > 3:
        head += " (+%d more)" % (len(changes) - 3)
    return head


def record_compile(site: str, compile_time_s: float,
                   signature: Optional[tuple] = None,
                   flops: Optional[float] = None,
                   peak_bytes: Optional[int] = None,
                   op_breakdown: Optional[dict] = None,
                   num_devices: Optional[int] = 1) -> CompileRecord:
    """Record one build into the registry and the ``compile.*``
    telemetry, with the retrace cause against the site's previous
    signature."""
    global _last_cause, _seq
    with _lock:
        st = _sites.setdefault(site, {"compiles": 0, "time_s": 0.0,
                                      "sig": None, "last": None})
        cause = (diff_signatures(st["sig"], signature)
                 if signature is not None else None)
        _seq += 1
        rec = CompileRecord(
            site=site, seq=_seq,
            compile_time_s=round(float(compile_time_s), 6),
            signature=signature,
            flops=float(flops) if flops else None,
            peak_bytes=peak_bytes, op_breakdown=op_breakdown,
            retrace_cause=cause, num_devices=num_devices,
            ts=round(time.time(), 6))
        st["compiles"] += 1
        st["time_s"] += float(compile_time_s)
        st["sig"] = signature
        st["last"] = rec
        _records.append(rec)
        cap = int(_env.get("MXNET_TPU_XPROF_RECORDS"))
        if len(_records) > cap:
            del _records[:len(_records) - cap]
        if cause:
            _last_cause = "%s: %s" % (site, cause)
    if _tel.enabled():
        _tel.inc("compile.count")
        _tel.observe("compile.time_ms", compile_time_s * 1e3)
        if rec.flops:
            _tel.inc("compile.flops", int(rec.flops))
        if rec.peak_bytes:
            _tel.set_gauge("compile.peak_bytes", rec.peak_bytes)
    return rec


def maybe_record(site: str, compile_time_s: float,
                 **kw) -> Optional[CompileRecord]:
    """:func:`record_compile` where the registry is on, else nothing."""
    if not enabled():
        return None
    return record_compile(site, compile_time_s, **kw)


def summary() -> dict:
    """The registry as a JSON-able dict: per site the build count, time
    and last record; the totals; the card's memory (None on the CPU)."""
    with _lock:
        sites = {}
        for site, st in _sites.items():
            sites[site] = {"compiles": st["compiles"],
                           "compile_time_s": round(st["time_s"], 4),
                           "last": (st["last"].to_dict()
                                    if st["last"] else None)}
        total_t = sum(st["time_s"] for st in _sites.values())
        total_n = sum(st["compiles"] for st in _sites.values())
        peaks = [r.peak_bytes for r in _records if r.peak_bytes]
    out = {"sites": sites,
           "totals": {"compiles": total_n,
                      "compile_time_s": round(total_t, 4),
                      "peak_bytes_max": max(peaks) if peaks else 0}}
    hbm = hbm_stats()
    if hbm is not None:
        out["hbm"] = hbm
    return out


# ---------------------------------------------------------------------------
# op breakdown and FLOPs
# ---------------------------------------------------------------------------

CATEGORIES = ("conv", "dot", "elementwise", "copy", "reduction",
              "collective", "other")

# first match wins: K3's name holds "conv", cuDNN's implicit GEMMs hold
# "gemm"
_RULES = (
    ("collective", ("nccl",)),
    ("dot", ("conv_gemm", "linear_kernel", "flash_attn")),
    ("conv", ("fprop", "dgrad", "wgrad", "implicit", "winograd",
              "convolve", "cudnn", "conv")),
    ("dot", ("gemm", "gemv", "cublas", "cutlass", "matmul")),
    ("reduction", ("norm_act_bwd", "reduce", "softmax", "l2norm",
                   "pool", "argmax", "topk")),
    ("copy", ("memcpy", "memset", "copy", "cat_", "catarray",
              "transpose", "gather", "scatter", "index", "pad")),
    ("elementwise", ("elementwise", "norm_act", "foreach", "multi_tensor",
                     "crop_norm", "vectorized", "unrolled", "fill",
                     "where", "clamp")),
)


def kernel_category(name: str) -> str:
    """The category of a CUDA kernel (or copy) by its name."""
    low = name.lower()
    for cat, keys in _RULES:
        if any(k in low for k in keys):
            return cat
    return "other"


def kernel_breakdown(events, flops: Optional[dict] = None) -> dict:
    """``{category: {"ms", "count"[, "flops"]}, ..., "total": {...}}``
    over ``(kernel name, device microseconds)`` pairs, one a kernel run.
    Every event lands in one category, so the categories' ms and counts
    sum to the total's; ``flops`` (by category, :func:`count_flops`)
    rides along."""
    cats = {c: {"ms": 0.0, "count": 0} for c in CATEGORIES}
    for name, us in events:
        c = cats[kernel_category(name)]
        c["ms"] += float(us) / 1e3
        c["count"] += 1
    for c, n in (flops or {}).items():
        cats.setdefault(c, {"ms": 0.0, "count": 0})["flops"] = n
    out = {c: v for c, v in cats.items() if v["count"] or v.get("flops")}
    out["total"] = {"ms": sum(v["ms"] for v in cats.values()),
                    "count": sum(v["count"] for v in cats.values()),
                    "flops": sum((flops or {}).values())}
    return out


def profile_breakdown(run, reps: int = 1, flops: Optional[dict] = None):
    """:func:`kernel_breakdown` of ``reps`` calls of ``run`` under
    ``torch.profiler`` on the card (ms a call), with the profiled wall
    time beside it. Raises without a card: the CPU has no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise MXNetError("xprof.profile_breakdown needs a CUDA device")
    from .profiler import keep_cupti

    keep_cupti()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name, e.time_range.elapsed_us() / reps)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = kernel_breakdown(events, flops)
    for v in out.values():
        v["count"] = v["count"] / reps
    out["total"]["wall_ms"] = wall * 1e3 / reps
    return out


def count_flops(fn):
    """``(fn(), {category: flops})``: the FLOPs of one call of ``fn``
    from ``FlopCounterMode`` over its aten ops (convolutions ``conv``,
    products ``dot``) plus the products K3 launched meanwhile
    (``dot``), which run outside aten."""
    from torch.utils.flop_counter import FlopCounterMode

    from .ops import kernels

    k3 = kernels.conv_gemm_flops
    with FlopCounterMode(display=False) as fc:
        out = fn()
    by_cat: Dict[str, int] = {}
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        cat = "conv" if "conv" in str(op) else "dot"
        by_cat[cat] = by_cat.get(cat, 0) + int(n)
    k3 = kernels.conv_gemm_flops - k3
    if k3:
        by_cat["dot"] = by_cat.get("dot", 0) + k3
    return out, by_cat


# ---------------------------------------------------------------------------
# roofline analytics
# ---------------------------------------------------------------------------

# Peaks by CUDA device name fragment: NVIDIA's H100 SXM data sheet, dense
# bf16 tensor-core rate (TFLOP/s) and HBM3 bandwidth (GB/s), at the full
# 700 W power limit. Spec-sheet numbers, not measurements.
CHIP_PEAK_TFLOPS = {"h100": 989}
CHIP_HBM_GBPS = {"h100": 3350}


def _table_lookup(table, device_kind: Optional[str]):
    if not device_kind:
        return None
    kind = device_kind.lower()
    for frag, val in sorted(table.items(), key=lambda kv: -len(kv[0])):
        if frag in kind:
            return val
    return None


def chip_peak_tflops(device_kind: Optional[str]):
    return _table_lookup(CHIP_PEAK_TFLOPS, device_kind)


def chip_hbm_gbps(device_kind: Optional[str]):
    return _table_lookup(CHIP_HBM_GBPS, device_kind)


def _device_kind() -> Optional[str]:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else None


def analyze(flops, bytes_accessed, step_time_s=None,
            device_kind: Optional[str] = None) -> dict:
    """Roofline numbers for one step: arithmetic intensity, the card's
    ridge point, compute- or bandwidth-bound, and (given a measured step
    time) achieved TFLOP/s and MFU against the table's peak. A device
    the table does not know (the CPU) gives ``analytic_mfu_pct`` 0.0 and
    ``bound`` ``"unknown"``."""
    if device_kind is None:
        device_kind = _device_kind()
    peak = chip_peak_tflops(device_kind)
    bw = chip_hbm_gbps(device_kind)
    out = {"flops": flops, "bytes_accessed": bytes_accessed,
           "device_kind": device_kind,
           "peak_tflops": peak, "hbm_gbps": bw}
    ai = (float(flops) / float(bytes_accessed)
          if flops and bytes_accessed else None)
    ridge = (peak * 1e12) / (bw * 1e9) if peak and bw else None
    out["arithmetic_intensity"] = round(ai, 2) if ai else None
    out["ridge_intensity"] = round(ridge, 2) if ridge else None
    out["bound"] = (("compute" if ai >= ridge else "bandwidth")
                    if ai is not None and ridge is not None else "unknown")
    if step_time_s and flops:
        achieved = float(flops) / float(step_time_s)
        out["achieved_tflops"] = round(achieved / 1e12, 3)
        out["analytic_mfu_pct"] = (
            round(100.0 * achieved / (peak * 1e12), 2) if peak else 0.0)
    return out


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None off the card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def hbm_stats(device=None) -> Optional[dict]:
    """The caching allocator's view of one card: ``live_bytes`` (allocated
    now), ``peak_bytes`` (allocated at peak since the last reset) and
    ``limit_bytes`` (the card's memory); None on the CPU."""
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return None
    ms = torch.cuda.memory_stats(dev)
    return {"live_bytes": int(ms.get("allocated_bytes.all.current", 0)),
            "limit_bytes": device_memory_limit(dev),
            "peak_bytes": int(ms.get("allocated_bytes.all.peak", 0)),
            "source": "memory_stats"}


class HbmWatermark:
    """Per-step allocation watermark: ``sample()`` after each step;
    ``peak`` is monotone over the run and the ``hbm.*`` gauges (with
    ``hbm.headroom_bytes``) track the latest sample. ``limit_bytes``
    overrides the card's memory. On the CPU ``sample()`` returns None and
    changes nothing."""

    def __init__(self, device=None, limit_bytes: Optional[int] = None):
        self.device = device
        self.limit = limit_bytes
        self.peak = 0
        self.last = 0

    def sample(self) -> Optional[int]:
        s = hbm_stats(self.device)
        if s is None:
            return None
        self.last = s["live_bytes"]
        if self.limit is None:
            self.limit = s["limit_bytes"]
        self.peak = max(self.peak, self.last, s["peak_bytes"] or 0)
        if _tel.enabled():
            _tel.set_gauge("hbm.live_bytes", self.last)
            _tel.set_gauge("hbm.peak_bytes", self.peak)
            if self.limit:
                _tel.set_gauge("hbm.headroom_bytes",
                               self.limit - self.last)
        return self.last

    @property
    def headroom_bytes(self) -> Optional[int]:
        return self.limit - self.last if self.limit else None


def device_memory_limit(device=None) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``); None on the
    CPU."""
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def _fmt_bytes(n) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return ("%d%s" if unit == "B" else "%.1f%s") % (n, unit)
        n /= 1024.0


def preflight_check(peak_bytes, limit_bytes: Optional[int] = None,
                    device=None, devices=None, what: str = "computation"):
    """Refuse a configuration before it runs: raise :class:`MXNetError`
    when ``peak_bytes`` exceeds the device's memory (the smallest of
    ``devices``' where given). Returns the headroom in bytes, or None
    where no limit is known (the CPU)."""
    if limit_bytes is None and devices:
        limits = [device_memory_limit(d) for d in devices]
        limits = [v for v in limits if v]
        limit_bytes = min(limits) if limits else None
    if limit_bytes is None:
        limit_bytes = device_memory_limit(device)
    if not limit_bytes or not peak_bytes:
        return None
    headroom = int(limit_bytes) - int(peak_bytes)
    if headroom < 0:
        raise MXNetError(
            "pre-flight OOM: %s needs %s at peak but the device limit "
            "is %s (short %s) — shrink the batch or shard the model"
            % (what, _fmt_bytes(int(peak_bytes)),
               _fmt_bytes(int(limit_bytes)), _fmt_bytes(-headroom)))
    return headroom
