"""The port's autotuner (mxnet_tpu_torch/autotune.py) against the JAX
package's: the search core on one fake site with a fake clock (the same
result and rows from both packages, determinism, each prune), the fence,
the best-config cache and its lookup order, the signature strings, the
consumers off by default, and the cached launch parameters reaching the
kernels' wrappers (a stub library on meta tensors: nothing launches on
the CPU). No sleeping and no wall clock."""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import autotune as jat
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu_torch import autotune as at
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import kernels

H100 = "NVIDIA H100 80GB HBM3"


class FakeClock:
    """Advances ``step`` seconds a read."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def fake_site(error):
    """Five candidates with known facts and times: the default (2 ms), a
    winner (1 ms), an OOM one, a roofline-hopeless one and an
    inapplicable one (raising the package's ``error``)."""
    cands = [{"name": n, "config": {"tile": t}} for n, t in
             (("default", 128), ("fast", 256), ("huge", 1024),
              ("bloated", 64), ("bad", 32))]
    facts = {"default": {"flops": 1e9, "peak_bytes": 100,
                         "compile_time_s": 0.1},
             "fast": {"flops": 1e9, "peak_bytes": 200,
                      "compile_time_s": 0.1},
             "huge": {"flops": 1e9, "peak_bytes": 10_000,
                      "compile_time_s": 0.1},
             # 1e12 FLOPs at 100 TFLOP/s: a 10 ms floor over a 1 ms best
             "bloated": {"flops": 1e12, "peak_bytes": 10,
                         "compile_time_s": 0.2}}
    times = {"default": 2e-3, "fast": 1e-3, "huge": 0.5e-3,
             "bloated": 0.1e-3}
    ran = []

    def compile_fn(c):
        if c["name"] == "bad":
            raise error("candidate 'bad' not applicable to this shape")
        return dict(facts[c["name"]])

    def run_fn(c):
        ran.append(c["name"])
        return times[c["name"]]

    return cands, compile_fn, run_fn, ran


@pytest.mark.parametrize("budget", [None, 25.0, 5.0])
def test_search_matches_the_jax_search(budget):
    """One fake site, the same clock sequence: equal results and rows,
    with no budget, one that cuts the tail and one that leaves only the
    default."""
    out = []
    for mod, err in ((at, MXNetError), (jat, JMXNetError)):
        cands, compile_fn, run_fn, _ = fake_site(err)
        out.append(mod.search("fake", cands, compile_fn, run_fn,
                              budget_s=budget, limit_bytes=1000,
                              peak_tflops=100.0, clock=FakeClock(10.0)))
    assert out[0] == out[1]


def test_search_is_deterministic_and_prunes_each_way():
    runs = []
    for _ in range(2):
        cands, compile_fn, run_fn, ran = fake_site(MXNetError)
        runs.append((at.search("fake", cands, compile_fn, run_fn,
                               limit_bytes=1000, peak_tflops=100.0,
                               clock=FakeClock(1.0)), ran))
    assert runs[0] == runs[1]
    (result, rows), ran = runs[0]
    assert result["best"]["candidate"] == "fast"
    assert result["non_default"] is True
    assert (result["measured"], result["pruned_preflight"],
            result["pruned_roofline"], result["pruned_inapplicable"],
            result["pruned_budget"]) == (2, 1, 1, 1, 0)
    assert result["speedup_vs_default"] == pytest.approx(2.0)
    # pruned candidates never ran; every candidate has a row
    assert set(ran) == {"default", "fast"}
    by = {r["candidate"]: r for r in rows}
    assert "pre-flight OOM" in by["huge"]["pruned"]
    assert "roofline-hopeless" in by["bloated"]["pruned"]
    assert "not applicable" in by["bad"]["pruned"]
    assert [r["best"] for r in rows] == [False, True, False, False, False]
    assert by["fast"]["analytic_mfu_pct"] == pytest.approx(1.0)


def test_search_budget_always_measures_the_default():
    cands, compile_fn, run_fn, ran = fake_site(MXNetError)
    result, rows = at.search("fake", cands, compile_fn, run_fn,
                             budget_s=5.0, clock=FakeClock(10.0))
    assert ran == ["default"] * 3
    assert result["measured"] == 1 and result["pruned_budget"] == 4
    assert all("budget exhausted" in r["pruned"] for r in rows[1:])
    assert result["best"]["candidate"] == "default"
    assert result["non_default"] is False


def test_search_ties_keep_the_earliest():
    cands = [{"name": "a", "config": {}}, {"name": "b", "config": {}}]
    result, _ = at.search("fake", cands, lambda c: {}, lambda c: 1e-3,
                          clock=FakeClock(1.0))
    assert result["best"]["candidate"] == "a"


def test_a_wrong_candidate_raises_never_pruned():
    def run_fn(c):
        if c["name"] == "wrong":
            raise at.CandidateError("computes wrong")
        return 1e-3

    cands = [{"name": "default", "config": {}},
             {"name": "wrong", "config": {}}]
    with pytest.raises(at.CandidateError):
        at.search("fake", cands, lambda c: {}, run_fn,
                  clock=FakeClock(1.0))


# ---------------------------------------------------------------------------
# the fence
# ---------------------------------------------------------------------------

def _row(name, ms, **kw):
    return dict({"experiment": "autotune:conv_backward:" + name,
                 "site": "conv_backward", "candidate": name, "config": {},
                 "step_time_ms": ms}, **kw)


@pytest.mark.parametrize("kernel,dtype,flops,nbytes,bound", [
    # K3 f32: operations at 495/3 TFLOP/s
    ("conv_gemm", "float32", 2 * 6272 * 512 * 4608,
     (6272 * 4608 + 4608 * 512 + 6272 * 512) * 4,
     2 * 6272 * 512 * 4608 / (495e12 / 3) * 1e3),
    # K3 bf16: bytes at 3.35 TB/s beat operations at 989 TFLOP/s
    ("conv_gemm", "bfloat16", 2 * 100352 * 64 * 64,
     (100352 * 64 + 64 * 64) * 2 + 100352 * 64 * 4,
     ((100352 * 64 + 64 * 64) * 2 + 100352 * 64 * 4) / 3.35e12 * 1e3),
    # K4: bytes
    ("norm_act_fwd", "float32", 2 * 100352 * 64,
     2 * 100352 * 64 * 4 + 2 * 64 * 4,
     (2 * 100352 * 64 * 4 + 2 * 64 * 4) / 3.35e12 * 1e3),
])
def test_fence_bound_by_kernel_and_dtype(kernel, dtype, flops, nbytes,
                                         bound):
    row = _row("x", 1.0, kernel=kernel, dtype=dtype, chip=H100,
               flops_per_step=float(flops), bytes_accessed=nbytes)
    assert at.bound_ms(row) == pytest.approx(bound, rel=1e-9)
    assert at.validate(row) is None
    row["step_time_ms"] = 0.99 * bound
    assert "below the kernel's bound" in at.validate(row)
    # a device the tables do not know gives no bound
    assert at.validate(dict(row, chip="cpu")) is None


def test_record_refuses_impossible_rows_and_writes_valid_ones(tmp_path):
    path = str(tmp_path / "rows.jsonl")
    nbytes = 2 * 100352 * 64 * 4
    rows = [_row("ok", 2.0, kernel="norm_act_fwd", dtype="float32",
                 bytes_accessed=nbytes, flops_per_step=1e6),
            _row("mfu", 1.0, mfu_pct=1095.0),
            _row("fast", 1e-4, kernel="norm_act_fwd", dtype="float32",
                 bytes_accessed=nbytes, flops_per_step=1e6),
            _row("pruned", None)]
    rec = at.record(rows, path, chip=H100)
    assert (rec["written"], rec["refused"]) == (2, 2)
    reasons = sorted(r["refused"] for r in rec["refused_rows"])
    assert "exceeds 100%" in reasons[0] and "below" in reasons[1]
    on_disk = [json.loads(line) for line in open(path)]
    assert [r["candidate"] for r in on_disk] == ["ok", "pruned"]
    assert all(r["valid"] is True and r["chip"] == H100 for r in on_disk)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def _fill(path, save):
    save("conv_backward", {"k_chunk": 512}, sig="(64,64)float32", chip=H100,
         path=path)
    save("conv_backward", {"k_chunk": 256}, sig="(64,64)float32", path=path)
    save("conv_backward", {"k_chunk": 128}, chip=H100, path=path)
    save("conv_backward", {"k_chunk": 64}, path=path)
    save("norm_act", {"row_blocks": 3}, sig="bwd:(8,4)float32", chip=H100,
         path=path)


@pytest.mark.parametrize("sig,chip", [
    ("(64,64)float32", H100), ("(64,64)float32", "other"),
    ("(9,9)float32", H100), ("(9,9)float32", "other"), (None, H100),
    (None, None), ("(64,64)float32", None)])
def test_cache_lookup_order_matches_jax(tmp_path, sig, chip):
    """One file written by the port, read by both packages'
    best_config: exact, then sig-wildcard, chip-wildcard, both."""
    path = str(tmp_path / "cache.json")
    _fill(path, at.save_best)
    want = jat.best_config("conv_backward", sig, chip, path=path)
    assert at.best_config("conv_backward", sig, chip, path=path) == want
    assert want is not None


def test_cache_round_trip_and_file_format(tmp_path):
    ours, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _fill(ours, at.save_best)
    _fill(theirs, jat.save_best)
    a, b = json.load(open(ours)), json.load(open(theirs))
    assert a["version"] == b["version"] == 1
    assert set(a["entries"]) == set(b["entries"])
    for key, entry in a["entries"].items():
        assert set(entry) == set(b["entries"][key])
        assert entry["config"] == b["entries"][key]["config"]
    assert at.best_config("norm_act", "bwd:(8,4)float32", H100,
                          path=ours) == {"row_blocks": 3}
    assert at.best_config("norm_act", path=ours) is None
    # the atomic writer left no temporary file behind
    assert sorted(os.listdir(tmp_path)) == ["a.json", "b.json"]


def test_default_files_live_in_the_ignored_directory():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(at.CACHE_FILE) == os.path.dirname(
        at.DEFAULT_JSONL) == os.path.join(root, "mxnet_tpu_torch",
                                          "_autotune")
    with open(os.path.join(root, ".gitignore")) as f:
        assert "mxnet_tpu_torch/_autotune/" in f.read().split()


@pytest.mark.parametrize("shape,tdtype,jdtype", [
    ((32, 64), torch.float32, jnp.float32),
    ((401408, 147), torch.bfloat16, jnp.bfloat16),
    ((7,), torch.float16, jnp.float16),
    ((), torch.float32, jnp.float32)])
def test_aval_sig_equal_across_packages(shape, tdtype, jdtype):
    assert at.aval_sig(shape, tdtype) == jat.aval_sig(shape,
                                                      jnp.dtype(jdtype))
    assert at.aval_sig(shape, np.dtype(jdtype)) == at.aval_sig(shape,
                                                               tdtype)


def test_signatures_name_operands_and_direction():
    assert at.gemm_sig(147, 64, 401408, torch.bfloat16, True) == \
        "(401408,147)bfloat16^T@(401408,64)bfloat16"
    assert at.gemm_sig(100352, 64, 576, torch.float32, False) == \
        "(100352,576)float32@(576,64)float32"
    assert at.norm_sig("bwd", 1568, 2048, torch.float32) == \
        "bwd:(1568,2048)float32"


# ---------------------------------------------------------------------------
# candidate spaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,default,dtype", [
    (401408, 50176, torch.float32), (576, 576, torch.bfloat16),
    (100352, 3136, torch.bfloat16), (1568, 1568, torch.float32),
    (33, 64, torch.bfloat16)])
def test_conv_candidates_legal_rule_first(k, default, dtype):
    cands = at.conv_backward_candidates(k, default, dtype)
    chunks = [c["config"]["k_chunk"] for c in cands]
    assert chunks[0] == default
    assert len(set(chunks)) == len(chunks)
    assert all(at.k_chunk_error(c, k, dtype) is None for c in chunks)


def test_k_chunk_legality():
    assert at.k_chunk_error(96, 1000, torch.float32) is None
    assert "multiple of 64" in at.k_chunk_error(96, 1000, torch.bfloat16)
    assert "more than 256" in at.k_chunk_error(32, 32 * 257, torch.float32)


def test_norm_candidates():
    fwd = at.norm_fwd_candidates(132)
    assert fwd[0]["config"] == {"max_blocks": 0}
    assert [c["config"]["max_blocks"] for c in fwd[1:]] == [264, 1056,
                                                            2112, 4224]
    bwd = at.norm_bwd_candidates(1568, 500)
    assert [c["config"]["row_blocks"] for c in bwd] == [500, 250, 1000,
                                                        1568]
    assert [c["config"]["row_blocks"]
            for c in at.norm_bwd_candidates(3, 1)] == [1, 2, 3]


# ---------------------------------------------------------------------------
# consumers and the wrappers' launch parameters
# ---------------------------------------------------------------------------

class StubLib:
    """The kernels' C interface, recording each launch's arguments."""

    def __init__(self):
        self.calls = []

    def conv_gemm_k_chunk(self, m, n, k):
        return 4096

    def conv_gemm16_k_chunk(self, m, n, k):
        return 2048

    def norm_act_bwd_row_blocks(self, rows, c):
        return 7

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def stub(monkeypatch, tmp_path):
    """Meta tensors take the wrappers' card branch with the library, the
    device checks, the stream and the card's name stubbed; the cache is
    a temporary file."""
    from mxnet_tpu_torch import _build

    lib = StubLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(at, "_chip_kind", lambda device=None: H100)
    monkeypatch.setattr(at, "CACHE_FILE", str(tmp_path / "cache.json"))
    at.reset()
    yield lib
    at.reset()
    kernels.reset_launch_counts()


def _launch_all(m=64, n=32, k=8192, rows=1568, c=16):
    meta = torch.device("meta")
    a = torch.empty((k, m), device=meta)
    b = torch.empty((k, n), device=meta)
    kernels.matmul_f32acc(a, b, True)
    kernels.matmul_f32acc(a.to(torch.bfloat16), b.to(torch.bfloat16), True)
    x = torch.empty((rows, c), device=meta)
    sc = torch.empty((c,), device=meta)
    kernels.fused_norm_act(x, sc, sc, "none")
    kernels.fused_norm_act_bwd(x, sc, sc, x, "none")


def _params(lib):
    """(K3 f32 chunk and splits, K3 bf16 chunk and splits, K4 cap, K5 row
    blocks) from the recorded launches."""
    got = {}
    for name, args in lib.calls:
        if name == "conv_gemm":
            got.setdefault("k3", []).append((args[11], args[12]))
        elif name == "norm_act_fwd":
            got["k4"] = args[8]
        elif name == "norm_act_bwd":
            got["k5"] = args[10]
    return got


def test_consumers_off_by_default(stub, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_AUTOTUNE", raising=False)
    at.save_best("conv_backward", {"k_chunk": 64}, path=at.CACHE_FILE)

    def no_lookup(*a, **k):
        raise AssertionError("looked up with the autotuner off")

    monkeypatch.setattr(at, "best_config", no_lookup)
    assert at.conv_k_chunk(64, 32, 8192, torch.float32, True) is None
    assert at.norm_fwd_blocks(1568, 16, torch.float32) is None
    assert at.norm_bwd_row_blocks(1568, 16, torch.float32) is None
    _launch_all()
    # today's parameters: the libraries' rules, K4's cap 0
    assert _params(stub) == {"k3": [(4096, 2), (2048, 4)], "k4": 0,
                             "k5": 7}
    assert at.note_build("fused_step") is None


def test_cached_parameters_reach_the_wrappers(stub, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "1")
    for sig, cfg in (
            (at.gemm_sig(64, 32, 8192, torch.float32, True),
             {"k_chunk": 1024}),
            (at.gemm_sig(64, 32, 8192, torch.bfloat16, True),
             {"k_chunk": 8192}),
            (at.norm_sig("fwd", 1568, 16, torch.float32), {"max_blocks": 528}),
            (at.norm_sig("bwd", 1568, 16, torch.float32), {"row_blocks": 3})):
        site = "conv_backward" if "@" in sig else "norm_act"
        at.save_best(site, cfg, sig=sig, chip=H100, path=at.CACHE_FILE)
    lookups = []
    real = at.best_config

    def counting(*a, **k):
        lookups.append(a)
        return real(*a, **k)

    monkeypatch.setattr(at, "best_config", counting)
    _launch_all()
    _launch_all()
    assert _params(stub) == {"k3": [(1024, 8), (8192, 1)] * 2, "k4": 528,
                             "k5": 3}
    # each signature looked up once, however often its wrapper runs
    assert len(lookups) == 4
    # the split-K scratch follows the tuned splits: ws passed iff splits > 1
    ws = [args[3] for name, args in stub.calls if name == "conv_gemm"]
    assert [w is not None for w in ws] == [True, False] * 2


def test_an_illegal_cached_chunk_raises(stub, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "1")
    sig = at.gemm_sig(64, 32, 8192, torch.bfloat16, True)
    at.save_best("conv_backward", {"k_chunk": 96}, sig=sig, chip=H100,
                 path=at.CACHE_FILE)
    with pytest.raises(MXNetError, match="multiple of 64"):
        at.conv_k_chunk(64, 32, 8192, torch.bfloat16, True)


def test_forcing_overrides_while_the_tuner_measures(stub, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_AUTOTUNE", raising=False)
    sig = at.norm_sig("bwd", 1568, 16, torch.float32)
    with at.forcing("norm_act", sig, {"row_blocks": 11}):
        _launch_all()
    assert _params(stub)["k5"] == 11
    assert at.norm_bwd_row_blocks(1568, 16, torch.float32) is None


def test_note_build_telemeters_once(stub, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "1")
    at.save_best("fused_step", {"captured": True}, chip=H100,
                 path=at.CACHE_FILE)
    telemetry.reset()
    telemetry.enable()
    try:
        assert at.note_build("fused_step") == {"captured": True}
        assert at.note_build("fused_step") == {"captured": True}
        assert telemetry.peek("autotune.consulted") == 1
        assert telemetry.peek("autotune.applied") == 1
    finally:
        telemetry.disable()
        telemetry.reset()


# ---------------------------------------------------------------------------
# one site's tuning, off the card
# ---------------------------------------------------------------------------

class FakeSite:
    """What run_smoke's sites give _tune, with fake times."""

    kernel, site = "norm_act_bwd", "norm_act"
    dtype = torch.float32
    sig = at.norm_sig("bwd", 1568, 2048, torch.float32)
    bytes = 3 * 1568 * 2048 * 4 + 4 * 2048 * 4
    flops = 4 * 1568 * 2048
    candidates = at.norm_bwd_candidates(1568, 500)
    times = {500: 1e-4, 250: 2e-4, 1000: 0.9e-4, 1568: 1e-7}

    def compile_fn(self, cand):
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "peak_bytes": cand["config"]["row_blocks"] * 2 * 2048 * 4}

    def run_fn(self, cand):
        return self.times[cand["config"]["row_blocks"]]


def test_tune_fences_rows_and_caches_by_card(tmp_path):
    summary = {"sites": {}, "rows_written": 0, "rows_refused": 0,
               "refused_rows": [], "non_default_winner": False}
    cache, rows = str(tmp_path / "c.json"), str(tmp_path / "r.jsonl")
    result = at._tune(FakeSite(), None, None, H100, rows, cache, summary)
    # 1e-7 s is under the kernel's byte bound: its row is refused, never
    # written, and it cannot win; the fastest fenced row does
    assert result["best"]["config"] == {"row_blocks": 1000}
    assert result["non_default"] is True
    assert (summary["rows_written"], summary["rows_refused"]) == (3, 1)
    written = [json.loads(line) for line in open(rows)]
    assert all(r["kernel"] == "norm_act_bwd" and r["chip"] == H100
               and r["sig"] == FakeSite.sig for r in written)
    assert summary["sites"]["norm_act"][FakeSite.sig] is result
    assert list(json.load(open(cache))["entries"]) == [
        "norm_act|%s|%s" % (FakeSite.sig, H100)]


def test_run_smoke_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA card"):
        at.run_smoke({}, {})
