"""The port's device-observability module (mxnet_tpu_torch/xprof.py)
against the JAX package's xprof on the CPU: argument signatures and
retrace causes, the registry's records and summary, roofline analytics
and the pre-flight check on the same inputs; the op breakdown's
categories summing to its totals; FLOPs by category; memory accounting
returning None where there is no card; the fused step's capture record
and the tracing plane reading the registry."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx  # noqa: F401  (the JAX package's env)
from mxnet_tpu import xprof as jxp
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tracing as ttr
from mxnet_tpu_torch import xprof as txp
import mxnet_tpu_torch as tmx


@pytest.fixture
def registries():
    """Both registries empty and on; off and empty again after."""
    for xp in (jxp, txp):
        xp.reset()
        xp.enable()
    yield
    for xp in (jxp, txp):
        xp.disable()
        xp.reset()
    ttel.disable()
    ttel.reset()


def _args(batch):
    rng = np.random.RandomState(batch)
    return [rng.randn(batch, 224, 224, 3).astype(np.float32),
            {"w": rng.randn(3, 3).astype(np.float32),
             "b": np.zeros(3, np.int64)},
            [rng.randn(batch).astype(np.float32), 2.5]]


@pytest.mark.parametrize("names", [None, ["data", None, "lab"],
                                   [["data"], ["w", "b"], ["x", "y"]]])
def test_leaf_signature_matches_jax(names):
    a = _args(4)
    assert txp.leaf_signature(a, names) == jxp.leaf_signature(a, names)


def test_torch_tensors_sign_as_their_numpy_arrays():
    a = _args(2)
    t = [torch.from_numpy(a[0]), {k: torch.from_numpy(v)
                                  for k, v in a[1].items()},
         [torch.from_numpy(a[2][0]), 2.5]]
    assert txp.leaf_signature(t, ["data"]) == txp.leaf_signature(
        a, ["data"])


def test_diff_signatures_matches_jax():
    """The retrace cause in words, for a batch change, a dtype change, a
    tree change, a rename and more than three changes."""
    names = [["data"], ["w", "b"], ["lab", "s"]]
    base = _args(4)
    cases = [_args(4), _args(2)]
    dt = _args(4)
    dt[1]["b"] = dt[1]["b"].astype(np.int32)
    cases.append(dt)
    cases.append(_args(4)[:2])
    many = [np.zeros((1, 1)), {"w": np.zeros(2), "b": np.zeros(1)},
            [np.zeros(3), np.zeros(1)]]
    cases.append(many)
    for sig_names in (names, None):
        prev_j = jxp.leaf_signature(base, sig_names)
        prev_t = txp.leaf_signature(base, sig_names)
        for cur in cases:
            want = jxp.diff_signatures(prev_j,
                                       jxp.leaf_signature(cur, sig_names))
            got = txp.diff_signatures(prev_t,
                                      txp.leaf_signature(cur, sig_names))
            assert got == want
    assert txp.diff_signatures(None, txp.leaf_signature(base)) is None
    renamed = txp.diff_signatures(txp.leaf_signature(base, ["x"]),
                                  txp.leaf_signature(base, ["y"]))
    assert renamed == jxp.diff_signatures(
        jxp.leaf_signature(base, ["x"]), jxp.leaf_signature(base, ["y"]))
    got = txp.diff_signatures(txp.leaf_signature(_args(64), names),
                              txp.leaf_signature(_args(32), names))
    assert got.startswith("(64,224,224,3)float32 -> (32,224,224,3)float32 "
                          "on data")


class _Compiled:
    """What the JAX registry reads off an executable: FLOPs and nothing
    else measurable (no HLO text, no memory analysis)."""

    def __init__(self, flops):
        self._flops = flops

    def cost_analysis(self):
        return {"flops": self._flops}

    def memory_analysis(self):
        return None


def _strip(rec):
    d = rec.to_dict()
    d.pop("ts")
    return d


def test_records_summary_and_cause_match_jax(registries):
    """The same three builds at one site and one at another: equal
    records (but their time stamps), the same per-site summary and
    totals, and the same last retrace cause."""
    builds = [("fused_step", 0.25, _args(4), 1e9),
              ("fused_step", 0.5, _args(4), 2e9),
              ("fused_step", 0.125, _args(2), 3e9),
              ("rtc.axpy", 0.0625, [np.zeros(3)], None)]
    for site, secs, args, flops in builds:
        sig_j = jxp.leaf_signature(args, ["data"])
        sig_t = txp.leaf_signature(args, ["data"])
        rj = jxp.record_compile(site, _Compiled(flops), secs, sig_j)
        rt = txp.record_compile(site, secs, sig_t, flops=flops,
                                num_devices=None)
        assert _strip(rt) == _strip(rj)
    assert txp.last_retrace_cause() == jxp.last_retrace_cause()
    assert "on data" in txp.last_retrace_cause()
    sj, st = jxp.summary(), txp.summary()
    assert "hbm" not in st      # no device memory on the CPU
    for s in (sj, st):
        for site in s["sites"].values():
            site["last"].pop("ts")
    assert st["sites"] == sj["sites"]
    assert st["totals"] == sj["totals"]
    assert [_strip(r) for r in txp.records()] == \
        [_strip(r) for r in jxp.records()]


def test_registry_feeds_telemetry_and_stays_off_when_disabled(registries,
                                                              monkeypatch):
    ttel.reset()
    ttel.enable()
    txp.record_compile("kernel_build.x", 0.5, flops=10.0)
    assert ttel.peek("compile.count") == 1
    assert ttel.peek("compile.time_ms", "hist_sum") == 500.0
    assert ttel.peek("compile.flops") == 10
    txp.disable()
    assert txp.maybe_record("kernel_build.x", 0.5) is None
    monkeypatch.setenv("MXNET_TPU_XPROF", "1")
    txp._override = None
    assert txp.enabled() and txp.maybe_record("kernel_build.x", 0.1)
    monkeypatch.setenv("MXNET_TPU_XPROF_RECORDS", "2")
    for _ in range(3):
        txp.record_compile("s", 0.0)
    assert len(txp.records()) == 2
    assert txp.summary()["sites"]["s"]["compiles"] == 3


@pytest.mark.parametrize("flops,nbytes,secs", [(8e12, 2e10, 0.05),
                                               (1e9, 1e10, 0.01),
                                               (None, None, None),
                                               (5e11, None, 0.002)])
def test_analyze_matches_jax(monkeypatch, flops, nbytes, secs):
    """An unknown device gives what the reference gives; with the
    reference's peak table the same arithmetic gives the same numbers;
    the port's own table knows the H100 by its CUDA name."""
    assert txp.analyze(flops, nbytes, secs, "cpu") == \
        jxp.analyze(flops, nbytes, secs, "cpu")
    monkeypatch.setattr(txp, "CHIP_PEAK_TFLOPS", jxp.CHIP_PEAK_TFLOPS)
    monkeypatch.setattr(txp, "CHIP_HBM_GBPS", jxp.CHIP_HBM_GBPS)
    assert txp.analyze(flops, nbytes, secs, "TPU v5 lite") == \
        jxp.analyze(flops, nbytes, secs, "TPU v5 lite")
    monkeypatch.undo()
    h100 = txp.analyze(flops, nbytes, secs, "NVIDIA H100 80GB HBM3")
    assert (h100["peak_tflops"], h100["hbm_gbps"]) == (989, 3350)
    if flops and secs:
        assert h100["analytic_mfu_pct"] == round(
            100.0 * flops / secs / 989e12, 2)


def test_preflight_check_matches_jax():
    """Headroom with an explicit limit, the same refusal message over it,
    and None where no limit is known (the CPU) in both."""
    for peak in (1 << 30, 16 << 30):
        assert txp.preflight_check(peak, limit_bytes=16 << 30) == \
            jxp.preflight_check(peak, limit_bytes=16 << 30)
    with pytest.raises(tmx.MXNetError) as got:
        txp.preflight_check(32 << 30, limit_bytes=16 << 30, what="step")
    with pytest.raises(jmx.MXNetError) as want:
        jxp.preflight_check(32 << 30, limit_bytes=16 << 30, what="step")
    assert str(got.value) == str(want.value)
    assert "short 16.0GiB" in str(got.value)
    assert txp.preflight_check(1 << 30) is None
    assert jxp.preflight_check(1 << 30) is None


def test_memory_accounting_invents_nothing_on_the_cpu():
    assert txp.hbm_stats() is None
    assert txp.hbm_stats("cpu") is None
    assert txp.device_memory_limit() is None
    wm = txp.HbmWatermark()
    assert wm.sample() is None and wm.headroom_bytes is None
    assert (wm.peak, wm.last) == (0, 0)


@pytest.mark.parametrize("name,cat", [
    ("void conv_gemm_kernel<float, 4>(...)", "dot"),
    ("conv_gemm16_kernel<__nv_bfloat16>", "dot"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "conv"),
    ("ampere_sgemm_128x64_nn", "dot"), ("cutlass_80_tensorop_s1688gemm",
                                        "dot"),
    ("linear_kernel", "dot"), ("flash_attn_kernel<64>", "dot"),
    ("norm_act_vec_kernel<float>", "elementwise"),
    ("norm_act_bwd_partial_kernel<float>", "reduction"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("multi_tensor_apply_kernel<...>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::CatArrayBatchedCopy<float>", "copy"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("crop_norm_kernel", "elementwise"), ("spin_kernel", "other")])
def test_kernel_categories(name, cat):
    assert txp.kernel_category(name) == cat


def test_kernel_breakdown_sums_to_its_totals():
    rng = np.random.RandomState(0)
    names = ["conv_gemm_kernel", "sm90_xmma_fprop_implicit_gemm",
             "norm_act_vec_kernel", "reduce_kernel", "Memcpy DtoD",
             "vectorized_elementwise_kernel", "mystery"]
    events = [(names[i % len(names)], float(rng.rand() * 100))
              for i in range(200)]
    flops = {"conv": 3e9, "dot": 5e9}
    bd = txp.kernel_breakdown(events, flops)
    cats = {c: v for c, v in bd.items() if c != "total"}
    assert set(cats) <= set(txp.CATEGORIES)
    assert sum(v["count"] for v in cats.values()) == bd["total"]["count"] \
        == 200
    assert abs(sum(v["ms"] for v in cats.values()) - bd["total"]["ms"]) \
        <= 1e-12 * bd["total"]["ms"]
    assert abs(bd["total"]["ms"] - sum(us for _, us in events) / 1e3) \
        <= 1e-9
    assert bd["conv"]["flops"] == 3e9 and bd["total"]["flops"] == 8e9
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        txp.profile_breakdown(lambda: None)


def test_count_flops_by_category():
    """A convolution and a product on the CPU: FlopCounterMode's count
    (2 N K a product); K3's products are counted by its wrapper on the
    card only, so the CPU's plain matmul shows under dot once."""
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    a, b = torch.randn(5, 6), torch.randn(6, 7)

    def step():
        return (torch.nn.functional.conv2d(x, w, padding=1),
                tmx.ops.kernels.matmul_f32acc(a, b))

    _, flops = txp.count_flops(step)
    assert flops["conv"] == 2 * 2 * 4 * 8 * 8 * 3 * 3 * 3
    assert flops["dot"] == 2 * 5 * 6 * 7


def _mlp_module(batch):
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (batch, 5))], [("softmax_label", (batch,))])
    mod.init_params(tmx.init.Xavier(seed=0))
    mod.init_optimizer()
    return mod


def test_fused_step_records_its_capture_and_the_cause(registries):
    """The record a capture makes (the CPU step captures nothing, so the
    record is made as a capture makes it): site fused_step, the bound
    arguments' signature by name, the eager step's FLOPs; a step over
    another batch size names the change; StepTrace's compiles delta and
    the RecompileDetector's cause come from the registry."""
    ttel.reset()
    ttel.enable()
    trace = ttr.StepTrace(detectors=[ttr.RecompileDetector(warmup=0)])
    trace.event_cooldown = 0
    recs = []
    for batch in (8, 4):
        mod = _mlp_module(batch)
        metric = tmx.metric.create("acc")
        step = mod._fused_train_step(metric)
        rng = np.random.RandomState(batch)
        data = tmx.io.DataBatch(
            [rng.randn(batch, 5).astype(np.float32)],
            [rng.randint(0, 3, batch).astype(np.float32)])
        step.step(data, metric)
        # the forward's product and the weight gradient's (the data
        # takes no gradient)
        assert step.step_flops == {"dot": 2 * (2 * batch * 5 * 3)}
        step._record_capture(0.01)
        recs.append(trace.record(1.0))
    fused = [r for r in txp.records() if r.site == "fused_step"]
    assert len(fused) == 2
    sig = dict(fused[0].signature)
    assert sig["data"] == ((8, 5), "float32", False, None)
    assert sig["fc_weight"] == ((3, 5), "float32", False, None)
    assert fused[0].flops == 2 * (2 * 8 * 5 * 3)
    cause = txp.last_retrace_cause()
    assert cause.startswith("fused_step: (8,5)float32 -> (4,5)float32 on "
                            "data; (8)float32 -> (4)float32 on "
                            "softmax_label")
    assert [r["deltas"]["compiles"] for r in recs] == [1, 1]
    assert recs[1]["dominant"] == "compile"
    assert trace.events[-1]["cause"] == cause


def test_preflight_refuses_a_capture_that_cannot_fit(monkeypatch):
    """The capture's pre-flight: the eager step's peak plus its transient
    bytes again must fit the card, else the capture is refused before
    it starts (the measurement is the card's; here it is set)."""
    mod = _mlp_module(4)
    step = mod._fused_train_step(tmx.metric.create("acc"))
    step._eager_mem = (1 << 30, 9 << 30)
    monkeypatch.setattr(txp, "device_memory_limit",
                        lambda device=None: 16 << 30)
    with pytest.raises(tmx.MXNetError, match="pre-flight OOM: the fused "
                       "step's capture needs 17.0GiB"):
        step._capture()
