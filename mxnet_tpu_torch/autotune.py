"""Closed-loop autotuner of the hand-written kernels' launch parameters,
counterpart of ``mxnet_tpu/autotune.py``.

For a kernel *site* (a named decision point: ``conv_backward``, the K3
GEMM's split-K chunk; ``norm_act``, K4's grid cap and K5's row blocks;
``fused_step``, the capture's consultation) it enumerates a candidate
space with the kernel's own rule first, reads each candidate's analytic
facts (FLOPs, bytes, the split-K scratch against the card's memory) to
prune candidates that are pre-flight OOM or roofline-hopeless *before
spending device time*, launches the survivors on the card, holds each
one's output against the kernel's plain version (a candidate that
computes wrong raises: it is never pruned silently), times it with CUDA
events, and writes every candidate (winners and losers, with prune
reasons) to a JSONL file behind :func:`validate`'s fence, so no
physically impossible row ever lands. The winning launch parameters are
persisted to a per-(site, signature, card) cache that the kernels'
wrappers in ``ops/kernels.py`` consult where they choose their launch
parameters, once a signature on the host: a CUDA graph's replay runs no
wrapper and looks up nothing, so a tuned choice costs nothing a step.

The search core (:func:`search`) takes injected ``compile_fn``/
``run_fn``/``clock`` so tests drive it off a fake site with a fake
clock and assert determinism; the real sites live next to it
(:func:`run_smoke`).

Knobs: ``MXNET_TPU_AUTOTUNE`` turns cache consultation on,
``MXNET_TPU_AUTOTUNE_BUDGET_S`` bounds a search. The JAX package's
``MXNET_TPU_PALLAS_CONV`` and its XLA-versus-Pallas candidate have no
counterpart: the port always runs K3.

The cache and the rows live in ``mxnet_tpu_torch/_autotune/``
(git-ignored): never the JAX package's ``.autotune_cache.json`` or
``MFU_EXPERIMENTS.jsonl``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import env as _env
from . import xprof as _xprof
from .base import MXNetError

__all__ = ["search", "validate", "record", "load_cache", "save_best",
           "best_config", "aval_sig", "gemm_sig", "norm_sig", "enabled",
           "budget_s", "conv_k_chunk", "norm_fwd_blocks",
           "norm_bwd_row_blocks", "note_build", "run_smoke", "reset",
           "CandidateError", "CACHE_FILE", "DEFAULT_JSONL"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
#: the autotuner's files, git-ignored
DATA_DIR = os.path.join(_PKG_DIR, "_autotune")
CACHE_FILE = os.path.join(DATA_DIR, "cache.json")
DEFAULT_JSONL = os.path.join(DATA_DIR, "rows.jsonl")

#: K3's K block by operand dtype (gemm_tile.cuh's BK, gemm_wgmma16.cuh's)
#: and its most splits (gemm_tile::kMaxSplits)
K3_BK = {"float32": 32, "bfloat16": 64, "float16": 64}
K3_MAX_SPLITS = 256
#: K5's most row blocks (a grid's y extent)
K5_MAX_ROW_BLOCKS = 65535

# Rates by CUDA device name fragment beside xprof's bf16 peak and HBM
# rate (NVIDIA's H100 SXM data sheet, at 700 W): TF32 on the tensor
# cores (K3 in float32 takes three TF32 passes, so a third of it) and
# float32 on the CUDA cores (K4 and K5 compute in float32).
TF32_TFLOPS = {"h100": 495}
F32_SIMT_TFLOPS = {"h100": 67}


class CandidateError(RuntimeError):
    """A measured candidate computed a wrong result. Not an
    :class:`MXNetError`, so :func:`search` does not record it as
    inapplicable: it propagates."""


def enabled() -> bool:
    return bool(_env.get("MXNET_TPU_AUTOTUNE"))


def budget_s() -> float:
    return float(_env.get("MXNET_TPU_AUTOTUNE_BUDGET_S"))


# ---------------------------------------------------------------------------
# search core (injectable: tested off a fake site + fake clock)
# ---------------------------------------------------------------------------

def search(site: str, candidates: List[dict],
           compile_fn: Callable[[dict], dict],
           run_fn: Callable[[dict], float], *,
           budget_s: Optional[float] = None,
           limit_bytes: Optional[int] = None,
           peak_tflops: Optional[float] = None,
           repeats: int = 3,
           clock: Callable[[], float] = time.perf_counter):
    """Measure a candidate space for one site; deterministic in the
    candidate order (ties keep the earliest).

    ``candidates`` is ``[{"name": ..., "config": {...}}, ...]`` with the
    DEFAULT config first: it is always measured, so later candidates
    can be roofline-pruned against a real time. ``compile_fn(cand)``
    returns the candidate's facts (``flops``, ``peak_bytes``,
    ``compile_time_s``; raise :class:`MXNetError` for inapplicable
    candidates). ``run_fn(cand)`` returns one fenced time in seconds;
    the best of ``repeats`` runs is kept.

    Prunes, in order: inapplicable (compile raised), pre-flight OOM
    (``peak_bytes`` over ``limit_bytes``), roofline-hopeless (the FLOP
    floor at ``peak_tflops`` already exceeds the best measured time),
    and budget exhaustion. Every candidate yields a row; pruned rows
    carry the reason instead of a time. Returns ``(summary, rows)``.
    """
    t0 = clock()
    rows: List[dict] = []
    best = None          # (step_ms, index, cand, info)
    default_ms = None
    n_pre = n_roof = n_budget = n_inapplicable = 0

    for idx, cand in enumerate(candidates):
        row = {"experiment": "autotune:%s:%s" % (site, cand["name"]),
               "site": site, "candidate": cand["name"],
               "config": cand.get("config", {})}
        if budget_s is not None and idx > 0 and clock() - t0 > budget_s:
            row["pruned"] = ("budget exhausted (%.1fs)" % budget_s)
            n_budget += 1
            rows.append(row)
            continue
        try:
            info = compile_fn(cand) or {}
        except MXNetError as e:
            row["pruned"] = str(e)
            n_inapplicable += 1
            rows.append(row)
            continue
        if info.get("compile_time_s") is not None:
            row["compile_time_s"] = round(float(info["compile_time_s"]), 4)
        if info.get("flops"):
            row["flops_per_step"] = float(info["flops"])
        if info.get("peak_bytes"):
            row["peak_bytes"] = int(info["peak_bytes"])
        if (limit_bytes and info.get("peak_bytes")
                and info["peak_bytes"] > limit_bytes):
            row["pruned"] = ("pre-flight OOM: needs %d bytes at peak, "
                             "device limit %d" % (info["peak_bytes"],
                                                  limit_bytes))
            n_pre += 1
            rows.append(row)
            continue
        if peak_tflops and info.get("flops") and best is not None:
            floor_ms = float(info["flops"]) / (peak_tflops * 1e9)
            if floor_ms >= best[0]:
                row["pruned"] = ("roofline-hopeless: FLOP floor %.3f ms "
                                 ">= best measured %.3f ms"
                                 % (floor_ms, best[0]))
                n_roof += 1
                rows.append(row)
                continue
        step_s = min(run_fn(cand) for _ in range(max(1, repeats)))
        step_ms = step_s * 1e3
        row["step_time_ms"] = round(step_ms, 4)
        if peak_tflops and info.get("flops"):
            achieved = float(info["flops"]) / step_s
            row["analytic_mfu_pct"] = round(
                100.0 * achieved / (peak_tflops * 1e12), 2)
        if idx == 0:
            default_ms = step_ms
        if best is None or step_ms < best[0]:
            best = (step_ms, idx, cand, info)
        rows.append(row)

    result = {"site": site, "candidates": len(candidates),
              "measured": sum(1 for r in rows if "step_time_ms" in r),
              "pruned_preflight": n_pre, "pruned_roofline": n_roof,
              "pruned_inapplicable": n_inapplicable,
              "pruned_budget": n_budget,
              "default_ms": round(default_ms, 4) if default_ms else None,
              "best": None, "speedup_vs_default": None,
              "search_time_s": round(clock() - t0, 3)}
    if best is not None:
        step_ms, idx, cand, _info = best
        result["best"] = {"candidate": cand["name"],
                          "config": cand.get("config", {}),
                          "step_time_ms": round(step_ms, 4)}
        result["non_default"] = idx != 0
        if default_ms:
            result["speedup_vs_default"] = round(default_ms / step_ms, 3)
        for r in rows:
            r["best"] = r["candidate"] == cand["name"]
    return result, rows


# ---------------------------------------------------------------------------
# the fence and the JSONL rows
# ---------------------------------------------------------------------------

def kernel_peak_tflops(kernel: Optional[str], dtype: Optional[str],
                       chip: Optional[str]) -> Optional[float]:
    """The card's peak for a kernel's work, as PERF.md's kernel table
    reckons it: K3 with 16-bit operands at the bf16 tensor-core rate, K3
    in float32 at a third of the TF32 rate (three passes), K4 and K5 at
    the float32 CUDA-core rate. None for a card the tables do not know
    (the CPU) or a row that names no kernel."""
    if kernel == "conv_gemm":
        if dtype in ("bfloat16", "float16"):
            return _xprof.chip_peak_tflops(chip)
        tf32 = _xprof._table_lookup(TF32_TFLOPS, chip)
        return tf32 / 3.0 if tf32 else None
    if kernel in ("norm_act_fwd", "norm_act_bwd"):
        return _xprof._table_lookup(F32_SIMT_TFLOPS, chip)
    return None


def bound_ms(row: dict) -> Optional[float]:
    """The least time the card could take for a row's work: its bytes
    at ``xprof.chip_hbm_gbps`` or its operations at the kernel's peak
    (:func:`kernel_peak_tflops`), whichever is longer. None where
    neither is known."""
    chip = row.get("chip")
    times = []
    hbm = _xprof.chip_hbm_gbps(chip)
    if hbm and row.get("bytes_accessed"):
        times.append(float(row["bytes_accessed"]) / (hbm * 1e6))
    peak = kernel_peak_tflops(row.get("kernel"), row.get("dtype"), chip)
    if peak and row.get("flops_per_step"):
        times.append(float(row["flops_per_step"]) / (peak * 1e9))
    return max(times) if times else None


def validate(row: dict) -> Optional[str]:
    """Physical-plausibility gate for a measurement row: None when the
    row could be real, else the reason. No correct measurement reports
    more than 100% of the card's peak, or a kernel time under the
    kernel's bound (:func:`bound_ms`): such a row timed the launch, not
    the kernel."""
    for key in ("mfu_pct", "analytic_mfu_pct"):
        v = row.get(key)
        if v is not None and v > 100.0:
            return "%s %.1f exceeds 100%% of chip peak" % (key, v)
    step_ms = row.get("step_time_ms")
    if step_ms:
        floor = bound_ms(row)
        if floor is not None and step_ms < floor:
            return ("step_time_ms %.4f below the kernel's bound %.4f ms "
                    "(%s bytes, %s FLOPs on %s)"
                    % (step_ms, floor, row.get("bytes_accessed"),
                       row.get("flops_per_step"), row.get("chip")))
    return None


def record(rows: List[dict], path: Optional[str] = None,
           chip: Optional[str] = None) -> dict:
    """Append search rows to the JSONL file behind the :func:`validate`
    fence: rows the gate rejects are REFUSED (returned with the reason),
    never written; the file only ever gains ``valid: true`` rows."""
    path = path or DEFAULT_JSONL
    written, refused = [], []
    for row in rows:
        row = dict(row)
        if chip and "chip" not in row:
            row["chip"] = chip
        reason = validate(row)
        if reason:
            row["refused"] = reason
            refused.append(row)
            continue
        row["valid"] = True
        written.append(row)
    if written:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            for row in written:
                f.write(json.dumps(row, sort_keys=True) + "\n")
    return {"written": len(written), "refused": len(refused),
            "refused_rows": refused}


# ---------------------------------------------------------------------------
# best-config cache: per (site, signature, card), consulted by the
# kernels' wrappers
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_cache_memo: Optional[dict] = None
#: (site, sig, chip) -> the config the wrappers apply (or None)
_lookups: Dict[Tuple[str, str, str], Optional[dict]] = {}
#: (site, sig) -> a config the tuner forces while it measures a candidate
_forced: Dict[Tuple[str, str], dict] = {}
_device_names: Dict[int, str] = {}


def _key(site: str, sig: str, chip: str) -> str:
    return "%s|%s|%s" % (site, sig, chip)


def reset() -> None:
    """Forget the memoised cache, lookups and telemetered sites (after
    pointing :data:`CACHE_FILE` elsewhere)."""
    global _cache_memo
    with _cache_lock:
        _cache_memo = None
        _lookups.clear()
        _noted.clear()


def load_cache(path: Optional[str] = None, refresh: bool = False) -> dict:
    global _cache_memo
    path = path or CACHE_FILE
    with _cache_lock:
        if _cache_memo is not None and not refresh \
                and path == CACHE_FILE:
            return _cache_memo
        try:
            with open(path) as f:
                cache = json.load(f)
            if not isinstance(cache.get("entries"), dict):
                cache = {"version": 1, "entries": {}}
        except (OSError, ValueError):
            cache = {"version": 1, "entries": {}}
        if path == CACHE_FILE:
            _cache_memo = cache
        return cache


def save_best(site: str, config: dict, *, sig: str = "*",
              chip: str = "*", candidate: Optional[str] = None,
              step_time_ms: Optional[float] = None,
              path: Optional[str] = None) -> None:
    """Persist a winning config (atomic replace: a crash leaves the old
    cache intact, the checkpoints' guarantee)."""
    from .checkpoint import atomic_writer

    global _cache_memo
    path = path or CACHE_FILE
    cache = load_cache(path, refresh=True)
    entry = {"config": dict(config), "candidate": candidate,
             "step_time_ms": step_time_ms, "ts": round(time.time(), 3)}
    with _cache_lock:
        cache["entries"][_key(site, sig, chip)] = entry
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with atomic_writer(path, mode="w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
            f.write("\n")
        if path == CACHE_FILE:
            _cache_memo = cache
            _lookups.clear()


def best_config(site: str, sig: Optional[str] = None,
                chip: Optional[str] = None,
                path: Optional[str] = None) -> Optional[dict]:
    """Most-specific cache hit for a site: exact (sig, chip) first,
    then sig-wildcard, chip-wildcard, both-wildcard."""
    entries = load_cache(path).get("entries", {})
    for s in ((sig, "*") if sig else ("*",)):
        for c in ((chip, "*") if chip else ("*",)):
            hit = entries.get(_key(site, s, c))
            if hit:
                return hit.get("config")
    return None


def _dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def aval_sig(shape, dtype) -> str:
    """Cache key fragment for one operand, ``(shape)dtype`` with the
    dtype's numpy name (``(32,64)bfloat16``), as the JAX package renders
    it."""
    return "(%s)%s" % (",".join(str(d) for d in shape), _dtype_name(dtype))


def gemm_sig(m: int, n: int, k: int, dtype, transpose_a: bool) -> str:
    """K3's signature: ``a``'s aval (``^T`` when it is read transposed)
    ``@`` ``b``'s."""
    a_shape = (k, m) if transpose_a else (m, k)
    return "%s%s@%s" % (aval_sig(a_shape, dtype),
                        "^T" if transpose_a else "",
                        aval_sig((k, n), dtype))


def norm_sig(direction: str, rows: int, channels: int, dtype) -> str:
    """K4's (``fwd``) or K5's (``bwd``) signature at the ``norm_act``
    site: the direction and x's (rows, channels) aval."""
    return "%s:%s" % (direction, aval_sig((rows, channels), dtype))


def _chip_kind(device=None) -> str:
    """The CUDA device name of ``device`` (the current card when None),
    memoised; ``*`` without a card."""
    if not torch.cuda.is_available():
        return "*"
    index = torch.device(device).index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    name = _device_names.get(index)
    if name is None:
        name = _device_names[index] = torch.cuda.get_device_name(index)
    return name


@contextlib.contextmanager
def forcing(site: str, sig: str, config: dict):
    """Inside, the wrappers launch ``sig`` at ``site`` with ``config``
    whatever the cache holds and whether or not the autotuner is on:
    how the tuner measures a candidate through the wrapper itself."""
    _forced[(site, sig)] = config
    try:
        yield
    finally:
        _forced.pop((site, sig), None)


def _config(site: str, sig: str, device) -> Optional[dict]:
    """The config a wrapper applies: a forced one, else with the
    autotuner on the cache's, looked up once a (site, sig, card)."""
    cfg = _forced.get((site, sig))
    if cfg is not None:
        return cfg
    if not enabled():
        return None
    chip = _chip_kind(device)
    key = (site, sig, chip)
    try:
        return _lookups[key]
    except KeyError:
        pass
    cfg = best_config(site, sig, chip)
    _lookups[key] = cfg
    return cfg


def k_chunk_error(chunk: int, k: int, dtype) -> Optional[str]:
    """Why ``chunk`` is not a legal split of K3's ``k`` for operands of
    ``dtype``, or None: a positive multiple of the K block (32 in
    float32, 64 in 16 bits) with at most :data:`K3_MAX_SPLITS` splits."""
    bk = K3_BK[_dtype_name(dtype)]
    if chunk <= 0 or chunk % bk:
        return "k_chunk %d is not a positive multiple of %d" % (chunk, bk)
    if -(-k // chunk) > K3_MAX_SPLITS:
        return ("k_chunk %d splits k=%d %d ways, more than %d"
                % (chunk, k, -(-k // chunk), K3_MAX_SPLITS))
    return None


def conv_k_chunk(m: int, n: int, k: int, dtype, transpose_a: bool,
                 device=None) -> Optional[int]:
    """K3's tuned split-K chunk for this product, or None (the kernel's
    own rule). Raises where a cached chunk is not legal for it."""
    sig = gemm_sig(m, n, k, dtype, transpose_a)
    cfg = _config("conv_backward", sig, device)
    if not cfg or cfg.get("k_chunk") is None:
        return None
    chunk = int(cfg["k_chunk"])
    err = k_chunk_error(chunk, k, dtype)
    if err:
        raise MXNetError("autotune: the conv_backward entry for %s: %s"
                         % (sig, err))
    return chunk


def norm_fwd_blocks(rows: int, channels: int, dtype,
                    device=None) -> Optional[int]:
    """K4's tuned grid cap for x of (rows, channels), or None (0 to the
    kernel: its own cap)."""
    sig = norm_sig("fwd", rows, channels, dtype)
    cfg = _config("norm_act", sig, device)
    if not cfg or cfg.get("max_blocks") is None:
        return None
    blocks = int(cfg["max_blocks"])
    if not 0 <= blocks <= 0x7fffffff:
        raise MXNetError("autotune: the norm_act entry for %s: max_blocks "
                         "%d out of range" % (sig, blocks))
    return blocks


def norm_bwd_row_blocks(rows: int, channels: int, dtype,
                        device=None) -> Optional[int]:
    """K5's tuned count of row blocks for x of (rows, channels), or None
    (the kernel's own count)."""
    sig = norm_sig("bwd", rows, channels, dtype)
    cfg = _config("norm_act", sig, device)
    if not cfg or cfg.get("row_blocks") is None:
        return None
    blocks = int(cfg["row_blocks"])
    if not 1 <= blocks <= K5_MAX_ROW_BLOCKS:
        raise MXNetError("autotune: the norm_act entry for %s: row_blocks "
                         "%d not in 1..%d" % (sig, blocks, K5_MAX_ROW_BLOCKS))
    return blocks


_noted: set = set()


def note_build(site: str) -> Optional[dict]:
    """Build-time observability hook (the fused step's capture): returns
    the site's best config and telemeters the consultation once per
    site (``autotune.consulted``, ``autotune.applied``). Never on a
    replay."""
    if not enabled():
        return None
    cfg = best_config(site, chip=_chip_kind())
    if site not in _noted:
        _noted.add(site)
        from . import telemetry as _tel
        if _tel.enabled():
            _tel.inc("autotune.consulted")
            if cfg:
                _tel.inc("autotune.applied")
    return cfg


# ---------------------------------------------------------------------------
# candidate spaces
# ---------------------------------------------------------------------------

def _chunk_of(k: int, splits: int, bk: int) -> int:
    return -(-(-(-k // splits)) // bk) * bk


def conv_backward_candidates(k: int, default_chunk: int,
                             dtype) -> List[dict]:
    """K3's chunks for a product with ``k``: the kernel's rule first,
    then no split, half and twice its splits; legal ones only
    (:func:`k_chunk_error`), each chunk once."""
    bk = K3_BK[_dtype_name(dtype)]
    splits = -(-k // default_chunk)
    most = min(K3_MAX_SPLITS, -(-k // bk))
    out, seen = [], set()
    for name, chunk in (("rule", default_chunk),
                        ("nosplit", _chunk_of(k, 1, bk)),
                        ("half", _chunk_of(k, max(1, splits // 2), bk)),
                        ("twice", _chunk_of(k, min(most, 2 * splits), bk))):
        if chunk in seen or k_chunk_error(chunk, k, dtype):
            continue
        seen.add(chunk)
        out.append({"name": "%s-k%d" % (name, chunk),
                    "config": {"k_chunk": chunk}})
    return out


def norm_fwd_candidates(sms: int) -> List[dict]:
    """K4's grid caps: 0 (the kernel's 4 blocks an SM) first, then 2, 8,
    16 and 32 blocks an SM."""
    return [{"name": "rule", "config": {"max_blocks": 0}}] + [
        {"name": "%dx%d" % (b, sms), "config": {"max_blocks": b * sms}}
        for b in (2, 8, 16, 32)]


def norm_bwd_candidates(rows: int, default_blocks: int) -> List[dict]:
    """K5's row blocks: the kernel's count first, then half, twice and
    four times it, at most one a row and :data:`K5_MAX_ROW_BLOCKS`."""
    most = min(K5_MAX_ROW_BLOCKS, rows)
    out, seen = [], set()
    for name, blocks in (("rule", default_blocks),
                         ("half", max(1, default_blocks // 2)),
                         ("twice", min(most, 2 * default_blocks)),
                         ("x4", min(most, 4 * default_blocks))):
        if blocks in seen:
            continue
        seen.add(blocks)
        out.append({"name": "%s-%d" % (name, blocks),
                    "config": {"row_blocks": blocks}})
    return out


# ---------------------------------------------------------------------------
# real sites: launch through the wrappers, hold against the plain
# version, time with CUDA events
# ---------------------------------------------------------------------------

#: ~0.5 ms of spin at the H100's boost clock ahead of each timed launch,
#: so the events time the card's work and not the wrapper's Python
SPIN_CYCLES = 1_000_000


def _event_ms(fn, flush, reps: int) -> float:
    """Median ms of ``fn()`` after a warm-up, each launch timed alone by
    CUDA events with the L2 cache flushed before it."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else 0.5 * (times[mid - 1]
                                                     + times[mid])


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    mag = torch.clamp(t.double().abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


class _Site:
    """One (site, signature) on the card: its candidates, facts and the
    check and launch of a candidate through the wrapper."""

    kernel = ""
    site = ""

    def __init__(self, sig, dtype, flush, reps):
        self.sig = sig
        self.dtype = dtype
        self.flush = flush
        self.reps = reps
        self.checked = set()

    def launch(self):
        raise NotImplementedError

    def check(self, name, out):
        raise NotImplementedError

    def facts(self, cand) -> dict:
        raise NotImplementedError

    def compile_fn(self, cand) -> dict:
        from . import _build

        t0 = time.perf_counter()
        _build.load("norm_act" if self.kernel.startswith("norm_act")
                    else "conv_gemm")
        dt = time.perf_counter() - t0
        info = dict(self.facts(cand), compile_time_s=dt)
        _xprof.record_compile("autotune.%s" % self.site, dt,
                              signature=self.signature,
                              flops=info["flops"],
                              peak_bytes=info.get("peak_bytes"))
        return info

    def run_fn(self, cand) -> float:
        with forcing(self.site, self.sig, cand["config"]):
            if cand["name"] not in self.checked:
                self.check(cand["name"], self.launch())
                self.checked.add(cand["name"])
            return 1e-3 * _event_ms(self.launch, self.flush, self.reps)

    def fail(self, name, what):
        raise CandidateError("autotune %s %s candidate %s: %s"
                             % (self.site, self.sig, name, what))


class _GemmSite(_Site):
    """K3 at one product: candidates by split-K chunk; every candidate
    within 1e-6 of sum|a||b| of a float64 product and bit-identical on
    a rerun."""

    kernel, site = "conv_gemm", "conv_backward"

    def __init__(self, m, n, k, transpose_a, dtype, flush, reps, gen):
        super().__init__(gemm_sig(m, n, k, dtype, transpose_a), dtype,
                         flush, reps)
        from . import _build
        from .ops import kernels

        self.m, self.n, self.k, self.trans = m, n, k, transpose_a
        self._kernels = kernels
        a = torch.randn(*((k, m) if transpose_a else (m, k)), generator=gen,
                        device="cuda").to(dtype)
        b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        if dtype != torch.float32:
            # the convolution path hands over 16-bit rows at a pitch of a
            # multiple of 8 elements (kernels._patches): no copy timed
            a, b = kernels.pitched16(a), kernels.pitched16(b)
        self.a, self.b = a, b
        ad = a.double().t() if transpose_a else a.double()
        self.want = ad @ b.double()
        self.mag = ad.abs() @ b.double().abs()
        del ad
        lib = _build.load("conv_gemm")
        self.default = (lib.conv_gemm_k_chunk if dtype == torch.float32
                        else lib.conv_gemm16_k_chunk)(m, n, k)
        self.candidates = conv_backward_candidates(k, self.default, dtype)
        esize = a.element_size()
        self.bytes = (m * k + k * n) * esize + m * n * 4
        self.flops = 2 * m * n * k
        self.signature = (("a", (tuple(a.shape), _dtype_name(dtype), False,
                                 None)),
                          ("b", (tuple(b.shape), _dtype_name(dtype), False,
                                 None)))

    def facts(self, cand):
        splits = -(-self.k // cand["config"]["k_chunk"])
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "peak_bytes": (splits * self.m * self.n * 4
                               if splits > 1 else 0)}

    def launch(self):
        return self._kernels.matmul_f32acc(self.a, self.b, self.trans)

    def check(self, name, out):
        again = self.launch()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            self.fail(name, "a rerun is not bit-identical")
        err = (out.double() - self.want).abs()
        if not bool((err <= 1e-6 * self.mag).all()):
            self.fail(name, "error %g above 1e-6 * sum|a||b|"
                      % float((err - 1e-6 * self.mag).max()))

    def release(self):
        del self.a, self.b, self.want, self.mag


class _NormSite(_Site):
    """K4 (``fwd``: bit-equal to the plain version) or K5 (``bwd``: dx
    bit-equal, bf16 within one ulp; dscale and dshift within 1e-5 of
    sum|term| of a float64 sum and bit-identical on a rerun) at one
    (rows, channels), act none as BatchNorm runs them."""

    site = "norm_act"

    def __init__(self, direction, rows, c, dtype, flush, reps, gen):
        super().__init__(norm_sig(direction, rows, c, dtype), dtype, flush,
                         reps)
        from . import _build
        from .ops import kernels

        self.direction, self.rows, self.c = direction, rows, c
        self.kernel = "norm_act_" + direction
        self._kernels = kernels
        self.x = (torch.randn(rows, c, generator=gen, device="cuda") * 2.0
                  + 0.5).to(dtype)
        self.g = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
        self.scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        self.shift = torch.randn(c, generator=gen, device="cuda")
        esize = self.x.element_size()
        if direction == "fwd":
            self.candidates = norm_fwd_candidates(
                torch.cuda.get_device_properties(
                    self.x.device).multi_processor_count)
            self.bytes = 2 * rows * c * esize + 2 * c * 4
            self.flops = 2 * rows * c
        else:
            lib = _build.load("norm_act")
            self.candidates = norm_bwd_candidates(
                rows, lib.norm_act_bwd_row_blocks(rows, c))
            self.bytes = 3 * rows * c * esize + 4 * c * 4
            self.flops = 4 * rows * c
        self.signature = (("x", ((rows, c), _dtype_name(dtype), False,
                                 None)),)

    def facts(self, cand):
        out = {"flops": self.flops, "bytes_accessed": self.bytes}
        if self.direction == "bwd":
            out["peak_bytes"] = cand["config"]["row_blocks"] * 2 * self.c * 4
        return out

    def launch(self):
        k = self._kernels
        if self.direction == "fwd":
            return k.fused_norm_act(self.x, self.scale, self.shift, "none")
        return k.fused_norm_act_bwd(self.x, self.scale, self.shift, self.g,
                                    "none")

    def check(self, name, out):
        k = self._kernels
        if self.direction == "fwd":
            want = k.fused_norm_act_plain(self.x, self.scale, self.shift,
                                          "none")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                self.fail(name, "not bit-equal to the plain version (max "
                          "diff %g)" % float((out.double()
                                              - want.double()).abs().max()))
            return
        again = self.launch()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            self.fail(name, "a rerun is not bit-identical")
        pdx, _, _ = k.fused_norm_act_bwd_plain(self.x, self.scale,
                                               self.shift, self.g, "none")
        diff = (out[0].double() - pdx.double()).abs()
        bound = (_bf16_ulp(pdx) if self.dtype == torch.bfloat16
                 else torch.zeros_like(diff))
        if not bool((diff <= bound).all()):
            self.fail(name, "dx off by %g" % float(diff.max()))
        gd = self.g.double()
        for got, term in ((out[1], gd * self.x.double()), (out[2], gd)):
            err = (got.double() - term.sum(0)).abs()
            if not bool((err <= 1e-5 * term.abs().sum(0)).all()):
                self.fail(name, "a per-channel sum is off by %g"
                          % float(err.max()))

    def release(self):
        del self.x, self.g, self.scale, self.shift


def _tune(site_obj, budget, limit, chip, jsonl_path, cache_path, summary):
    """Search one (site, signature), record its rows and save its
    winner; the site's result goes into ``summary``."""
    peak = kernel_peak_tflops(site_obj.kernel, _dtype_name(site_obj.dtype),
                              chip)
    facts = {}

    def compile_fn(cand):
        facts[cand["name"]] = info = site_obj.compile_fn(cand)
        return info

    result, rows = search(site_obj.site, site_obj.candidates, compile_fn,
                          site_obj.run_fn, budget_s=budget,
                          limit_bytes=limit, peak_tflops=peak, repeats=1)
    for row in rows:
        row.update(sig=site_obj.sig, kernel=site_obj.kernel,
                   dtype=_dtype_name(site_obj.dtype),
                   bytes_accessed=site_obj.bytes,
                   flops_per_step=float(site_obj.flops))
    rec = record(rows, jsonl_path, chip=chip)
    summary["rows_written"] += rec["written"]
    summary["rows_refused"] += rec["refused"]
    summary["refused_rows"] += rec["refused_rows"]
    result.update(kernel=site_obj.kernel, dtype=_dtype_name(site_obj.dtype),
                  rows_written=rec["written"], rows_refused=rec["refused"])
    refused = {r["candidate"] for r in rec["refused_rows"]}
    if result["best"] is not None and result["best"]["candidate"] in refused:
        # a time the fence refuses cannot win: the fastest fenced row
        # does (ties keep the earliest), or nothing is cached
        fenced = [r for r in rows
                  if "step_time_ms" in r and r["candidate"] not in refused]
        win = min(fenced, key=lambda r: r["step_time_ms"]) if fenced else None
        result["best"] = win and {"candidate": win["candidate"],
                                  "config": win["config"],
                                  "step_time_ms": win["step_time_ms"]}
        result["non_default"] = bool(win) and win is not rows[0]
    if result["best"] is not None:
        save_best(site_obj.site, result["best"]["config"], sig=site_obj.sig,
                  chip=chip, candidate=result["best"]["candidate"],
                  step_time_ms=result["best"]["step_time_ms"],
                  path=cache_path)
        if result.get("non_default"):
            summary["non_default_winner"] = True
    summary["sites"].setdefault(site_obj.site, {})[site_obj.sig] = result
    return result


def run_smoke(gemm_shapes, norm_shapes,
              dtypes=(torch.float32, torch.bfloat16),
              budget: Optional[float] = None,
              jsonl_path: Optional[str] = None,
              cache_path: Optional[str] = None, reps: int = 10,
              log: Optional[Callable[[str], None]] = None) -> dict:
    """Tune on the card: K3's chunk at every ``(m, n, k, transpose_a)``
    of ``gemm_shapes``, K4's grid cap and K5's row blocks at every
    ``(rows, channels)`` of ``norm_shapes``, each in every dtype of
    ``dtypes``; each (site, signature) one :func:`search` bounded by
    ``budget`` (``MXNET_TPU_AUTOTUNE_BUDGET_S`` by default). Every
    measured candidate is held against the plain version first
    (:class:`CandidateError` where it computes wrong). Rows go through
    :func:`record`'s fence, winners to the cache keyed by the card's
    name. Returns the summary: ``sites[site][sig]`` is each search's
    result."""
    if not torch.cuda.is_available():
        raise MXNetError("autotune.run_smoke tunes kernels on a CUDA card; "
                         "none is available")
    budget = budget_s() if budget is None else budget
    chip = _chip_kind()
    limit = _xprof.device_memory_limit()
    summary = {"chip": chip, "budget_s": budget, "sites": {},
               "rows_written": 0, "rows_refused": 0, "refused_rows": [],
               "non_default_winner": False}
    flush = torch.empty(64 << 20, device="cuda")   # 256 MB > the 50 MB L2
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    for dtype in dtypes:
        sites = [lambda s=s: _GemmSite(*s, dtype=dtype, flush=flush,
                                       reps=reps, gen=gen)
                 for s in sorted(gemm_shapes)]
        sites += [lambda d=d, s=s: _NormSite(d, *s, dtype=dtype, flush=flush,
                                             reps=reps, gen=gen)
                  for d in ("fwd", "bwd") for s in sorted(norm_shapes)]
        for make in sites:
            site_obj = make()
            result = _tune(site_obj, budget, limit, chip, jsonl_path,
                           cache_path, summary)
            site_obj.release()
            if log is not None:
                best = result["best"] or {}
                log("  %-13s %-40s default %.4f ms, best %s %.4f ms%s, "
                    "rows %d written / %d refused"
                    % (site_obj.site, site_obj.sig,
                       result["default_ms"] or float("nan"),
                       best.get("candidate"),
                       best.get("step_time_ms", float("nan")),
                       " (non-default)" if result.get("non_default") else "",
                       result["rows_written"], result["rows_refused"]))
    torch.cuda.synchronize()
    summary["seconds"] = time.perf_counter() - t0
    return summary
