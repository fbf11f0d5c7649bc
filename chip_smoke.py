#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (nvidia-smi), CUDA and
   torch versions; TF32 off for convolutions and matmuls.
2. build: every hand-written kernel from mxnet_tpu_torch/csrc, one nvcc
   per source, all at once.
3. kernel parity on the card, at the shapes the main paths give each
   kernel plus ragged ones: K4 (norm_act_fwd) and K5 (norm_act_bwd)
   against their plain PyTorch versions, K3 (conv_gemm) against a
   float64 product of the same operands; reruns of K3 and K5 must be
   bit-identical.
   K2 (flash_attn) against its plain version (reference attention,
   mask -1e30) at the demo shape of examples/long_context, each head
   width the kernel instantiates and ragged T and D, reruns
   bit-identical; K1 (linear) against a float64 act(x @ w.T + b), reruns
   bit-identical; K6 (Rtc, NVRTC): an axpy body bit-equal to 2*x+y, a
   gelu-like body within rtol 1e-4, a bad body raising with NVRTC's log.
4. kernel timing: median of CUDA-event times with the L2 cache flushed
   before each launch, beside the plain version, the one-call PyTorch
   yardstick where there is one and the bound (bytes at 3.35 TB/s or
   operations at the data-sheet rate, whichever is longer), summed over
   the launches of one ResNet-50 forward (K4) or training step (K3, K5);
   K2 at the demo shape and at T=16384 (beside
   scaled_dot_product_attention), K1 at three layers (beside addmm),
   the Rtc axpy (beside 2*x+y).
5. serving at full width: ResNet-50, 224x224, 1000 classes, NHWC,
   random seeded weights, served through Module -> InferenceServer ->
   FusedInfer from two client threads; kernel launch counts are zeroed
   just before and read just after; served argmax against a direct
   Executor.forward; card probabilities against the port on the CPU.
6. training at full width: the same network through Module.fit (SGD,
   momentum 0.9, wd 1e-4, rescale_grad 1/32) over 5 batches of 32 from
   seed 0; launch counts zeroed just before and read just after (K3 105,
   K4 53 and K5 53 per step); finite losses, every param and moving
   statistic changed; step time and img/s, a torch.profiler breakdown;
   one step at batch 2 on the card against the port on the CPU.
7. entry points at full width, launch counts zeroed just before and
   read just after: parallel.make_ring_attention over a one-rank "sp"
   mesh at the demo's (1, 4096, 8, 32), causal, impl "ulysses" (K2 once
   a call) and "ring" (K2 never), each against reference_attention, and
   one backward through ulysses against autograd through the reference;
   fused_linear at ResNet-50's head on the card's ResNet features
   against the FullyConnected output; two Rtc pushes.
8. report: one JSON line of kernel records, the card line, then
   {"ok": true, "device": {...}} as the last line.

``--report PATH`` also writes the per-shape records and the main paths'
breakdowns to PATH as JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, float32 without tensor cores
BATCH = 32
IMAGE = (224, 224, 3)
BN_LAYERS = 53                 # BatchNorm layers of ResNet-50
CONV_GEMMS = 105               # 53 weight + 52 input gradients (not the stem's)
TRAIN_STEPS = 5
TRAIN_OPT = (("learning_rate", 0.0125), ("momentum", 0.9), ("wd", 1e-4),
             ("rescale_grad", 1.0 / BATCH))
GATE_GAMMA_B3 = 0.25           # see gate_module
SPIN_CYCLES = 1_000_000        # ~0.5 ms at the H100's 1.98 GHz boost clock
REQUEST_ROWS = [1, 3, 8, 17, 32, 1, 3, 8, 17, 32, 3, 8]
# (rows, channels, element offset): ragged edges, the scalar path, the
# no-shared-memory path (C > 4096) and a misaligned pointer
RAGGED_SHAPES = [(1000, 100, 0), (7, 3, 0), (4096, 66, 0), (64, 5000, 0),
                 (4096, 64, 1)]
# (M, N, K, transpose_a): ragged edges, one split, many splits, a bare 1x1x1
RAGGED_GEMMS = [(257, 33, 1001, True), (129, 65, 7, False), (1, 1, 1, True),
                (1000, 130, 4099, False)]
# (B, T, H, D) of attention: examples/long_context/ring_attention_demo.py's
# shape, each head width K2 instantiates, and ragged T with D between them
DEMO_ATTN = (1, 4096, 8, 32)
FLASH_SHAPES = [DEMO_ATTN, (2, 1024, 4, 64), (1, 512, 2, 128),
                (1, 256, 2, 256), (2, 100, 2, 48), (1, 1000, 4, 96)]
FLASH_TIMED = [DEMO_ATTN + (False,), DEMO_ATTN + (True,),
               (1, 16384, 8, 128, True)]
# (M, K, N, acts) of the fused linear: the JAX test's shape, ResNet-50's
# classifier head (which the TPU gate refuses), a large layer, a ragged one
LINEAR_ACTS = ("none", "relu", "tanh", "sigmoid")
LINEAR_CASES = [(128, 256, 128, LINEAR_ACTS), (BATCH, 2048, 1000, ("none",)),
                (8192, 4096, 4096, ("relu",)), (257, 1001, 33, LINEAR_ACTS)]
LINEAR_TIMED = [(128, 256, 128, "none"), (BATCH, 2048, 1000, "none"),
                (8192, 4096, 4096, "relu")]
RTC_N = 1 << 24                # elements of each array of the Rtc bodies


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, "nvidia-smi failed: %s" % res.stderr)
    return res.stdout.strip().splitlines()[0]


def bn_shapes(mx):
    """(rows, channels) -> count of ResNet-50 NHWC BatchNorm applies at
    batch 32, read off the graph."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(BATCH,) + IMAGE)
    counts = {}
    for name, shape in zip(internals.list_outputs(), outs):
        if name.endswith("_bn_output"):
            key = (int(np.prod(shape[:-1])), int(shape[-1]))
            counts[key] = counts.get(key, 0) + 1
    check(sum(counts.values()) == BN_LAYERS, "expected 53 BatchNorms")
    return counts


def _bf16_ulp(torch, t):
    mag = torch.clamp(t.double().abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def norm_act_fwd_parity(torch, kernels, shapes):
    """Kernel vs plain on the card for every (rows, channels, offset),
    dtype and act; a nonzero offset starts x that many elements into
    its buffer, off the 16-byte alignment the vector path needs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for rows, c, offset in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            base = (torch.randn(rows * c + offset, generator=gen,
                                device="cuda") * 2.0 + 0.5).to(dtype)
            x = base[offset:].view(rows, c)
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            shift = torch.randn(c, generator=gen, device="cuda")
            for act in ("none", "relu"):
                got = kernels.fused_norm_act(x, scale, shift, act)
                torch.cuda.synchronize()
                want = kernels.fused_norm_act_plain(x, scale, shift, act)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                mag = want.double().abs()
                if dtype == torch.float32:
                    bound = 1e-6 * torch.clamp(mag, min=1.0)
                else:
                    bound = _bf16_ulp(torch, want)
                bad = int((diff > bound).sum())
                check(bad == 0 and bool(torch.isfinite(got).all()),
                      "norm_act_fwd %s %s act=%s: %d values off (max "
                      "diff %g)" % ((rows, c, offset), dtype, act, bad,
                                    float(diff.max())))
                name = "float32" if dtype == torch.float32 else "bfloat16"
                worst[name] = max(worst[name], float(diff.max()))
                cases += 1
    return worst, cases


def time_ms(torch, fn, flush, reps=20):
    """Median ms of fn() over reps, each launch timed alone by CUDA
    events with the L2 cache flushed before it. A 0.5 ms spin kernel
    ahead of the start event keeps the card busy while the host makes
    fn's launches, so the events time the device's work and not the
    wrapper's Python and ctypes overhead (tens of us, as long as the
    small kernels themselves)."""
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
    return float(np.median(times))


def norm_act_fwd_timing(torch, kernels, counts):
    flush = torch.empty(64 << 20, device="cuda")   # 256 MB > 50 MB L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_out, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                         "bytes": 0, "flops": 0}
    for (rows, c), n in sorted(counts.items()):
        x = torch.randn(rows, c, generator=gen, device="cuda")
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        shift = torch.randn(c, generator=gen, device="cuda")
        k = time_ms(torch, lambda: kernels.fused_norm_act(x, scale, shift,
                                                          "none"), flush)
        p = time_ms(torch, lambda: kernels.fused_norm_act_plain(
            x, scale, shift, "none"), flush)
        lib = time_ms(torch, lambda: torch.addcmul(shift, x, scale), flush)
        nbytes = 2 * rows * c * 4 + 2 * c * 4
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                          2 * rows * c / F32_FLOPS_PER_S)
        rows_out.append({"rows": rows, "channels": c, "per_forward": n,
                         "ms": k, "plain_ms": p, "library_ms": lib,
                         "bound_ms": bound, "bytes": nbytes,
                         "gb_per_s": nbytes / k / 1e6})
        print("  norm_act_fwd (%7d, %4d) x%-2d kernel %.4f ms  plain %.4f "
              "ms  addcmul %.4f ms  bound %.4f ms  (%.0f GB/s)"
              % (rows, c, n, k, p, lib, bound, nbytes / k / 1e6))
        tot["ms"] += n * k
        tot["plain_ms"] += n * p
        tot["library_ms"] += n * lib
        tot["bytes"] += n * nbytes
        tot["flops"] += n * 2 * rows * c
    tot["bound_ms"] = 1e3 * max(tot["bytes"] / HBM_BYTES_PER_S,
                                tot["flops"] / F32_FLOPS_PER_S)
    return rows_out, tot


def norm_act_bwd_parity(torch, kernels, shapes):
    """K5 against its plain version on the card for every (rows,
    channels, offset), dtype and act: dx float32 bit-equal, bfloat16
    within one ulp; dscale/dshift within 1e-5 * sum|term| of a float64
    sum; a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"dx_float32": 0.0, "dx_bfloat16": 0.0, "sums_abs": 0.0,
             "sums_rel": 0.0}
    cases = 0
    for rows, c, offset in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            base = (torch.randn(rows * c + offset, generator=gen,
                                device="cuda") * 2.0 + 0.5).to(dtype)
            x = base[offset:].view(rows, c)
            g = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            shift = torch.randn(c, generator=gen, device="cuda")
            for act in ("none", "relu"):
                got = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
                again = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
                torch.cuda.synchronize()
                where = "norm_act_bwd %s %s act=%s" % ((rows, c, offset),
                                                       dtype, act)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      where + ": a rerun is not bit-identical")
                pdx, _, _ = kernels.fused_norm_act_bwd_plain(
                    x, scale, shift, g, act)
                diff = (got[0].double() - pdx.double()).abs()
                if dtype == torch.float32:
                    ok = float(diff.max()) == 0.0
                    worst["dx_float32"] = max(worst["dx_float32"],
                                              float(diff.max()))
                else:
                    ok = bool((diff <= _bf16_ulp(torch, pdx)).all())
                    worst["dx_bfloat16"] = max(worst["dx_bfloat16"],
                                               float(diff.max()))
                check(ok and bool(torch.isfinite(got[0]).all()),
                      where + ": dx off by %g" % float(diff.max()))
                gd = g.double()
                if act == "relu":
                    pre = x.float() * scale + shift
                    gd = torch.where(pre > 0, gd, torch.zeros_like(gd))
                for out, term in ((got[1], gd * x.double()), (got[2], gd)):
                    err = (out.double() - term.sum(0)).abs()
                    mag = term.abs().sum(0)
                    check(bool((err <= 1e-5 * mag).all()),
                          where + ": a per-channel sum is off by %g"
                          % float(err.max()))
                    worst["sums_abs"] = max(worst["sums_abs"],
                                            float(err.max()))
                    worst["sums_rel"] = max(worst["sums_rel"], float(
                        (err / torch.clamp(mag, min=1e-30)).max()))
                cases += 1
    return worst, cases


def norm_act_bwd_timing(torch, kernels, counts):
    """K5 at the 53 (rows, channels) of one training step, float32,
    act none (BatchNorm's apply); bytes bound it."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows_out, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}
    for (rows, c), n in sorted(counts.items()):
        x = torch.randn(rows, c, generator=gen, device="cuda")
        g = torch.randn(rows, c, generator=gen, device="cuda")
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        shift = torch.randn(c, generator=gen, device="cuda")
        k = time_ms(torch, lambda: kernels.fused_norm_act_bwd(
            x, scale, shift, g, "none"), flush)
        p = time_ms(torch, lambda: kernels.fused_norm_act_bwd_plain(
            x, scale, shift, g, "none"), flush)
        # x and g read, dx written; scale, shift read, dscale, dshift written
        nbytes = 3 * rows * c * 4 + 4 * c * 4
        flops = 4 * rows * c
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rows_out.append({"rows": rows, "channels": c, "per_step": n,
                         "ms": k, "plain_ms": p, "bound_ms": bound,
                         "bytes": nbytes, "gb_per_s": nbytes / k / 1e6})
        print("  norm_act_bwd (%7d, %4d) x%-2d kernel %.4f ms  plain %.4f ms"
              "  bound %.4f ms  (%.0f GB/s)"
              % (rows, c, n, k, p, bound, nbytes / k / 1e6))
        tot["ms"] += n * k
        tot["plain_ms"] += n * p
        tot["bytes"] += n * nbytes
        tot["flops"] += n * flops
    tot["bound_ms"] = 1e3 * max(tot["bytes"] / HBM_BYTES_PER_S,
                                tot["flops"] / F32_FLOPS_PER_S)
    return rows_out, tot


def _shape_param(text):
    return tuple(int(v) for v in text.strip("()").split(",") if v.strip())


def conv_gemm_shapes(mx):
    """(M, N, K, transpose_a) -> count of the K3 products of one
    ResNet-50 NHWC training step at batch 32, read off the graph: per
    convolution the weight gradient (patches^T @ g: M = kh*kw*C, N = O,
    K = N*HO*WO) and, unless its input is the data, the input gradient
    (patches(g~) @ w~: M = N*H*W, N = C, K = kh*kw*O)."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(BATCH,) + IMAGE)
    shape_of = dict(zip(internals.list_outputs(), outs))
    nodes = json.loads(sym.tojson())["nodes"]
    counts = {}
    convs = 0
    for node in nodes:
        if node["op"] != "Convolution":
            continue
        convs += 1
        src = nodes[node["inputs"][0][0]]
        is_data = src["op"] == "null"
        n, h, w, c = shape_of[src["name"] if is_data
                              else src["name"] + "_output"]
        kh, kw = _shape_param(node["param"]["kernel"])
        o = int(node["param"]["num_filter"])
        _, ho, wo, _ = shape_of[node["name"] + "_output"]
        keys = [(kh * kw * c, o, n * ho * wo, True)]
        if not is_data:
            keys.append((n * h * w, c, kh * kw * o, False))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    check(convs == BN_LAYERS and sum(counts.values()) == CONV_GEMMS,
          "expected 53 convolutions and 105 conv GEMMs, got %d and %d"
          % (convs, sum(counts.values())))
    return counts


def conv_gemm_parity(torch, kernels, shapes):
    """K3 against a float64 product of the same operands, float32 and
    bfloat16 operands: every element within 1e-6 * sum|a||b|; a rerun
    bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"abs_float32": 0.0, "abs_bfloat16": 0.0, "rel": 0.0}
    cases = 0
    for m, n, k, trans in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            got = kernels.matmul_f32acc(a, b, trans)
            again = kernels.matmul_f32acc(a, b, trans)
            torch.cuda.synchronize()
            where = "conv_gemm (%d, %d, %d, transpose=%s) %s" % (
                m, n, k, trans, dtype)
            check(torch.equal(got, again), where + ": a rerun differs")
            ad = a.double().t() if trans else a.double()
            err = (got.double() - ad @ b.double()).abs()
            mag = ad.abs() @ b.double().abs()
            check(bool((err <= 1e-6 * mag).all()),
                  where + ": error %g above 1e-6 * sum|a||b|"
                  % float((err - 1e-6 * mag).max()))
            name = "abs_float32" if dtype == torch.float32 else "abs_bfloat16"
            worst[name] = max(worst[name], float(err.max()))
            worst["rel"] = max(worst["rel"], float(
                (err / torch.clamp(mag, min=1e-30)).max()))
            cases += 1
            del a, b, ad, err, mag, got, again
    return worst, cases


def conv_gemm_timing(torch, kernels, counts):
    """K3 at the (M, N, K, transpose) products of one training step,
    float32 operands, beside the plain version and torch.matmul on the
    same operands; the bound is the longer of 2MNK at the float32 rate
    and the bytes (A and B read, C written) at the memory rate."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows_out = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0}
    for (m, n, k, trans), cnt in sorted(counts.items()):
        a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                        device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        at = a.t() if trans else a
        kern = time_ms(torch, lambda: kernels.matmul_f32acc(a, b, trans),
                       flush)
        plain = time_ms(torch, lambda: kernels.matmul_f32acc_plain(a, b,
                                                                   trans),
                        flush)
        lib = time_ms(torch, lambda: torch.matmul(at, b), flush)
        nbytes = (m * k + k * n + m * n) * 4
        flops = 2 * m * n * k
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rows_out.append({"m": m, "n": n, "k": k, "transpose_a": trans,
                         "per_step": cnt, "ms": kern, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "tflops": flops / kern / 1e9})
        print("  conv_gemm (%6d, %4d, %6d, %s) x%-2d kernel %.4f ms  plain "
              "%.4f ms  matmul %.4f ms  bound %.4f ms  (%.1f TFLOP/s)"
              % (m, n, k, "T" if trans else "N", cnt, kern, plain, lib,
                 bound, flops / kern / 1e9))
        tot["ms"] += cnt * kern
        tot["plain_ms"] += cnt * plain
        tot["library_ms"] += cnt * lib
        tot["bytes"] += cnt * nbytes
        tot["flops"] += cnt * flops
        del a, b, at
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    t_flops = tot["flops"] / F32_FLOPS_PER_S
    tot["bound_ms"] = 1e3 * max(t_bytes, t_flops)
    tot["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
    return rows_out, tot


def flash_parity(torch, kernels):
    """K2 against its plain version on the card (TF32 off), causal and
    not: every element within rtol 2e-4 / atol 2e-5
    (tests/test_pallas_rtc.py:119-133), a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst, cases = 0.0, 0
    for shape in FLASH_SHAPES:
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
                   for _ in range(3))
        for causal in (False, True):
            got = kernels.flash_attention(q, k, v, causal=causal)
            again = kernels.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            where = "flash_attn %s causal=%s" % (shape, causal)
            check(torch.equal(got, again), where + ": a rerun differs")
            want = kernels.flash_attention_plain(q, k, v, causal=causal)
            err = (got - want).abs()
            bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  where + ": %d values beyond rtol 2e-4 / atol 2e-5 (max abs "
                  "err %g)" % (bad, float(err.max())))
            worst = max(worst, float(err.max()))
            cases += 1
        del q, k, v, got, again, want, err
    return worst, cases


def _act64(torch, pre, act):
    return {"none": pre, "relu": torch.relu(pre), "tanh": torch.tanh(pre),
            "sigmoid": torch.sigmoid(pre)}[act]


def linear_parity(torch, kernels):
    """K1 against act(x @ w.T + b) in float64: every element within 1e-6
    of sum|x||w| + |b| (K3's bound), plus 2e-7 (one libm ulp) for tanh
    and sigmoid; a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, cases = {"abs": 0.0, "rel": 0.0}, 0
    for m, k, n, acts in LINEAR_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        pre = x.double() @ w.double().t() + b.double()
        mag = x.double().abs() @ w.double().abs().t() + b.double().abs()
        for act in acts:
            got = kernels.fused_linear(x, w, b, act)
            again = kernels.fused_linear(x, w, b, act)
            torch.cuda.synchronize()
            where = "linear (%d, %d) -> %d act=%s" % (m, k, n, act)
            check(torch.equal(got, again), where + ": a rerun differs")
            err = (got.double() - _act64(torch, pre, act)).abs()
            slack = 2e-7 if act in ("tanh", "sigmoid") else 0.0
            check(bool((err <= 1e-6 * mag + slack).all()),
                  where + ": error %g above 1e-6 * (sum|x||w| + |b|)"
                  % float((err - 1e-6 * mag - slack).max()))
            worst["abs"] = max(worst["abs"], float(err.max()))
            worst["rel"] = max(worst["rel"], float((err / mag).max()))
            cases += 1
        del x, w, b, pre, mag, got, again, err
    return worst, cases


def rtc_bodies(torch, mx, n):
    """The two Rtc kernels of tests/test_pallas_rtc.py:82-107 as CUDA
    bodies over n float32 elements, with their arrays."""
    from mxnet_tpu_torch.rtc import Rtc

    gen = torch.Generator(device="cuda").manual_seed(13)

    def nd(t):
        return mx.nd.NDArray(t, mx.gpu(0))

    x = nd(torch.randn(n, generator=gen, device="cuda"))
    y = nd(torch.randn(n, generator=gen, device="cuda"))
    out = nd(torch.zeros(n, device="cuda"))
    index = "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
    axpy = Rtc("axpy", [("x", x), ("y", y)], [("out", out)],
               index + "if (i < %dLL) out[i] = 2.0f * x[i] + y[i];" % n)
    gelu = Rtc("gelu_ish", [("x", x)], [("out", out)],
               index + "if (i < %dLL) {\n  float v = x[i];\n"
               "  out[i] = v / (1.0f + expf(-1.702f * v));\n}" % n)
    return axpy, gelu, x, y, out


def rtc_dims(n):
    return (-(-n // 256),), (256,)


def rtc_parity(torch, mx):
    """The axpy body bit-equal to 2*x+y, the gelu-like body within rtol
    1e-4 of the plain torch expression, a bad body raising with NVRTC's
    log."""
    from mxnet_tpu_torch.rtc import Rtc

    axpy, gelu, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    axpy.push([x, y], [out], grid, block)
    torch.cuda.synchronize()
    check(torch.equal(out.handle, 2 * x.handle + y.handle),
          "Rtc axpy differs from 2*x+y")
    gelu.push([x], [out], grid, block)
    torch.cuda.synchronize()
    v = x.handle
    want = v / (1 + torch.exp(-1.702 * v))
    rel = float(((out.handle - want).abs() / want.abs().clamp(min=1e-30))
                .max())
    check(rel <= 1e-4, "Rtc gelu_ish off by rtol %g" % rel)
    try:
        Rtc("bad", [("x", x)], [("out", out)], "this is not CUDA !!!")
    except mx.MXNetError as e:
        check("NVRTC failed to compile" in str(e) and "error" in str(e),
              "a bad Rtc body raised without NVRTC's log: %s" % e)
        log_head = str(e).splitlines()[1][:120]
    else:
        raise RuntimeError("chip_smoke check failed: a bad Rtc body compiled")
    return {"axpy_max_abs_err": 0.0, "gelu_max_rel_err": rel,
            "bad_body_log": log_head}


def flash_timing(torch, kernels):
    """K2 beside its plain version and scaled_dot_product_attention on
    (B, H, T, D) f32 (timed, never called by the port). The bound: 4 *
    B*H*D flops a (query, key) pair the mask keeps (T*T, or T*(T+1)/2
    causal) at the f32 rate, or q, k, v, o at the memory rate."""
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for b, t, h, d, causal in FLASH_TIMED:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   for _ in range(3))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        kern = time_ms(torch, lambda: kernels.flash_attention(
            q, k, v, causal=causal), flush)
        plain = time_ms(torch, lambda: kernels.flash_attention_plain(
            q, k, v, causal=causal), flush)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), flush)
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 4 * b * h * d * pairs
        nbytes = 4 * b * t * h * d * 4
        bound = 1e3 * max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        rows.append({"shape": [b, t, h, d], "causal": causal, "ms": kern,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "flops": flops, "tflops": flops / kern / 1e9})
        print("  flash_attn %s causal=%-5s kernel %.4f ms  plain %.4f ms  "
              "sdpa %.4f ms  bound %.4f ms  (%.1f TFLOP/s)"
              % ((b, t, h, d), causal, kern, plain, lib, bound,
                 flops / kern / 1e9))
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


def linear_timing(torch, kernels):
    """K1 beside its plain version and addmm plus the activation (timed,
    never called by the port); the bound is the longer of 2MNK at the
    f32 rate and x, w, b read and out written at the memory rate."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for m, k, n, act in LINEAR_TIMED:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        wt = w.t()
        kern = time_ms(torch, lambda: kernels.fused_linear(x, w, b, act),
                       flush)
        plain = time_ms(torch, lambda: kernels.fused_linear_plain(x, w, b,
                                                                  act), flush)
        if act == "relu":
            lib = time_ms(torch, lambda: torch.relu(torch.addmm(b, x, wt)),
                          flush)
        else:
            lib = time_ms(torch, lambda: torch.addmm(b, x, wt), flush)
        flops = 2 * m * n * k
        nbytes = (m * k + n * k + n + m * n) * 4
        t_ops, t_bytes = flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        rows.append({"m": m, "k": k, "n": n, "act": act, "ms": kern,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "tflops": flops / kern / 1e9})
        print("  linear (%5d, %4d) -> %4d %-4s kernel %.4f ms  plain %.4f ms"
              "  addmm %.4f ms  bound %.4f ms (%s)  (%.1f TFLOP/s)"
              % (m, k, n, act, kern, plain, lib, rows[-1]["bound_ms"],
                 rows[-1]["bound_by"], flops / kern / 1e9))
        del x, w, b, wt
    return rows


def rtc_timing(torch, mx):
    """The axpy body over RTC_N elements beside 2*x+y and beside the one
    PyTorch call that computes it, torch.add(y, x, alpha=2); bytes bound
    it (x and y read, out written)."""
    flush = torch.empty(64 << 20, device="cuda")
    axpy, _, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    kern = time_ms(torch, lambda: axpy.push([x, y], [out], grid, block),
                   flush)
    plain = time_ms(torch, lambda: 2 * x.handle + y.handle, flush)
    lib = time_ms(torch, lambda: torch.add(y.handle, x.handle, alpha=2.0),
                  flush)
    bound = 1e3 * 3 * RTC_N * 4 / HBM_BYTES_PER_S
    print("  rtc axpy (%d elements) kernel %.4f ms  2*x+y %.4f ms  "
          "torch.add %.4f ms  bound %.4f ms"
          % (RTC_N, kern, plain, lib, bound))
    return {"n": RTC_N, "ms": kern, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound}


def resnet_head_inputs(mx, batch):
    """ResNet-50's pooled features and fc1 output on the card for one
    seeded batch, with fc1's weight and bias (the served module's seeded
    params): the head's (batch, 2048) -> 1000 layer."""
    ctx = mx.gpu(0)
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    names = internals.list_outputs()
    flat = [n for n in names if n.startswith("flatten")]
    check(len(flat) == 1, "expected one Flatten before fc1, got %s" % flat)

    def pick(name):
        return mx.sym.Symbol([internals._outputs[names.index(name)]])

    head = mx.sym.Group([pick(flat[0]), pick("fc1_output")])
    args, aux = build_module(mx, ctx, batch).get_params()
    arrays = {k: a.as_in_context(ctx) for k, a in args.items()}
    rng = np.random.RandomState(21)
    arrays["data"] = mx.nd.array(
        rng.randn(batch, *IMAGE).astype(np.float32), ctx=ctx)
    ex = head.bind(ctx, arrays, grad_req="null",
                   aux_states={k: a.as_in_context(ctx)
                               for k, a in aux.items()})
    feats, logits = ex.forward()
    return (feats.handle, logits.handle, arrays["fc1_weight"].handle,
            arrays["fc1_bias"].handle)


def entry_points_main_path(torch, mx, kernels):
    """Phase 7: the slice's three entry points on the card at full
    width, launch counts zeroed just before and read just after."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel

    rng = np.random.RandomState(20)
    q, k, v = (torch.from_numpy(rng.randn(*DEMO_ATTN).astype(np.float32))
               .to("cuda") for _ in range(3))
    want = parallel.reference_attention(q, k, v, causal=True)
    feats, fc_out, weight, bias = resnet_head_inputs(mx, BATCH)
    axpy, gelu, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    res = {"attention": {}}
    mesh = parallel.make_mesh({"sp": 1})
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for impl in ("ulysses", "ring"):
            attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                                impl=impl)
            before = kernels.flash_attn_launches
            t0 = time.perf_counter()
            got = attn(q, k, v)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launched = kernels.flash_attn_launches - before
            err = (got - want).abs()
            bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
            check(bad == 0, "make_ring_attention impl=%s: %d values beyond "
                  "rtol 2e-4 / atol 2e-5 of reference_attention" % (impl, bad))
            res["attention"][impl] = {"flash_attn_launches": launched,
                                      "max_abs_err": float(err.max()),
                                      "host_ms": ms}
        check(res["attention"]["ulysses"]["flash_attn_launches"] == 1
              and res["attention"]["ring"]["flash_attn_launches"] == 0,
              "flash_attn launches a call: ulysses %d (want 1), ring %d (want "
              "0)" % (res["attention"]["ulysses"]["flash_attn_launches"],
                      res["attention"]["ring"]["flash_attn_launches"]))
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                            impl="ulysses")
        (attn(*leaves) ** 2).sum().backward()
        ref = [a.clone().requires_grad_() for a in (q, k, v)]
        (parallel.reference_attention(*ref, causal=True) ** 2).sum() \
            .backward()
        worst = 0.0
        for name, a, r in zip("qkv", leaves, ref):
            err = (a.grad - r.grad).abs()
            check(bool((err <= 1e-4 + 1e-3 * r.grad.abs()).all()),
                  "ulysses d%s differs from autograd through the reference "
                  "beyond rtol 1e-3 / atol 1e-4 (max %g)"
                  % (name, float(err.max())))
            worst = max(worst, float(err.max()))
        res["attention"]["ulysses_grad_max_abs_err"] = worst
        logits = kernels.fused_linear(feats, weight, bias)
        axpy.push([x, y], [out], grid, block)
        gelu.push([x], [out], grid, block)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    fd, wd = feats.double(), weight.double()
    ref = fd @ wd.t() + bias.double()
    mag = fd.abs() @ wd.abs().t() + bias.double().abs()
    err = (logits.double() - ref).abs()
    check(bool((err <= 1e-6 * mag).all()), "fused_linear at the ResNet-50 "
          "head: error above 1e-6 * (sum|x||w| + |b|)")
    fc_diff = (logits - fc_out).abs()
    fc_err = float(fc_diff.max())
    check(bool((fc_diff <= 4e-6 * mag).all()), "fused_linear and the "
          "FullyConnected output differ beyond 4e-6 * (sum|x||w| + |b|)")
    print("entry points: ulysses (K2 x%d) and ring (K2 x%d) at %s causal, "
          "max abs err vs reference %.3g / %.3g, ulysses grads %.3g; "
          "fused_linear at the ResNet-50 head %s -> 1000 vs FullyConnected "
          "%.3g; launches %s"
          % (res["attention"]["ulysses"]["flash_attn_launches"],
             res["attention"]["ring"]["flash_attn_launches"], DEMO_ATTN,
             res["attention"]["ulysses"]["max_abs_err"],
             res["attention"]["ring"]["max_abs_err"], worst,
             tuple(feats.shape), fc_err, launches))
    want_counts = {"norm_act_fwd": 0, "norm_act_bwd": 0, "conv_gemm": 0,
                   "linear": 1, "flash_attn": 2, "rtc": 2}
    check(launches == want_counts, "entry-point launches %s, want %s (K2 "
          "once for each ulysses forward, the forward and the one under the "
          "backward)" % (launches, want_counts))
    res.update({"launches": launches, "head_vs_fc_max_abs": fc_err,
                "head_max_abs_err": float(err.max())})
    return res


def build_module(mx, ctx, batch, arg_np=None, aux_np=None):
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)], for_training=False)
    if arg_np is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                       seed=0))
        args, aux = mod.get_params()
        rng = np.random.RandomState(0)
        for name, arr in args.items():
            if name.endswith("gamma"):
                arr[:] = rng.uniform(0.5, 1.0, arr.shape).astype(np.float32)
            elif name.endswith("beta"):
                arr[:] = (rng.randn(*arr.shape) * 0.1).astype(np.float32)
        for name, arr in aux.items():
            v = (rng.uniform(0.5, 2.0, arr.shape) if name.endswith("var")
                 else rng.randn(*arr.shape) * 0.1)
            arr[:] = v.astype(np.float32)
        mod.set_params(args, aux)
    else:
        mod.init_params(None, arg_params=arg_np, aux_params=aux_np)
    return mod


def serve_main_path(torch, mx, kernels, card):
    mod = build_module(mx, mx.gpu(0), BATCH)
    rng = np.random.RandomState(1)
    images = rng.randn(sum(REQUEST_ROWS), *IMAGE).astype(np.float32)
    offs = np.cumsum([0] + REQUEST_ROWS)
    payloads = [images[offs[i]:offs[i + 1]] for i in range(len(REQUEST_ROWS))]
    srv = mx.serving.InferenceServer(mod, top_k=1, max_batch=BATCH)
    try:
        reqs = [None] * len(payloads)

        def client(idx):
            for i in idx:
                reqs[i] = srv.submit([payloads[i]])
                time.sleep(0.002)

        kernels.reset_launch_counts()
        threads = [threading.Thread(target=client,
                                    args=(range(t, len(payloads), 2),))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        check(not any(t.is_alive() for t in threads), "client hung")
        served = [r.get(300)[0] for r in reqs]
        launches = kernels.launch_counts()
        stats = srv.stats()
    finally:
        srv.close()
    batches = stats["batches"]
    print("main path: %d requests, %d rows, %d batches %s, launches %s"
          % (len(reqs), sum(REQUEST_ROWS), batches,
             stats["batches_by_bucket"], launches))
    check(stats["errors"] == 0, "serving errors: %s" % stats)
    check(launches["norm_act_fwd"] == BN_LAYERS * batches,
          "norm_act_fwd launched %d times for %d batches (want 53 each)"
          % (launches["norm_act_fwd"], batches))

    # served argmax against a direct Executor.forward on the same rows
    ex = mod._exec_group.executor
    checked = 0
    for rows, top in zip(payloads, served):
        pad = np.zeros((BATCH,) + IMAGE, np.float32)
        pad[:len(rows)] = rows
        probs = ex.forward(data=pad)[0].asnumpy()[:len(rows)]
        check(np.all(np.isfinite(probs)), "non-finite probabilities")
        # margin between the top two log-probabilities (= logits)
        top2 = np.log(np.sort(probs, axis=1)[:, -2:].astype(np.float64))
        decisive = top2[:, 1] - top2[:, 0] > 1e-3
        check(np.array_equal(top[decisive], probs.argmax(1)[decisive]),
              "served argmax differs from the direct forward")
        checked += int(decisive.sum())
    print("argmax: %d of %d rows decisive (top-2 logit margin > 1e-3), all "
          "equal to the direct forward" % (checked, sum(REQUEST_ROWS)))
    check(checked >= sum(REQUEST_ROWS) // 2, "too few decisive rows")

    # argmax ties take the first maximum on the card, as jnp.argmax does
    ties = torch.tensor([[0.0, 2.0, 2.0, 1.0]] * 3, device="cuda")
    check(torch.argmax(ties, dim=-1).tolist() == [1, 1, 1],
          "torch.argmax on the card does not take the first maximum")

    # top_k=0 probabilities on the card against the port on the CPU
    two = images[:2]
    with mx.serving.InferenceServer(mod, top_k=0, max_batch=BATCH) as srv0:
        (gpu_probs,) = srv0.infer([two], timeout=300)
    args, aux = mod.get_params()
    cpu_mod = build_module(mx, mx.cpu(), 2, args, aux)
    cpu_probs = cpu_mod.predict(two).asnumpy()
    err = float(np.abs(gpu_probs - cpu_probs).max())
    print("card vs CPU probabilities (2 images): max abs diff %.3g "
          "(bound 1e-4)" % err)
    check(err <= 1e-4, "card and CPU probabilities differ by %g" % err)

    # steady-state latency and throughput at bucket 32
    lat = []
    with mx.serving.InferenceServer(mod, top_k=1, max_batch=BATCH) as srv1:
        for i in range(12):
            req = srv1.submit([images[:BATCH]])
            req.get(300)
            if i >= 2:
                lat.append(req.latency_ms)
    p50 = float(np.median(lat))
    print("bucket 32: p50 request latency %.3f ms, %.1f img/s  [%s]"
          % (p50, BATCH * 1e3 / p50, card))
    breakdown = forward_breakdown(torch, mx, mod, images[:BATCH])
    print("bucket 32 breakdown: H2D %.3f ms, forward %.3f ms on the card "
          "(device busy %.1f%% under the profiler), NHWC .contiguous() "
          "copies per forward: %d  [%s]"
          % (breakdown["h2d_ms"], breakdown["forward_ms"],
             100 * breakdown["busy_share"],
             breakdown["nhwc_copies_per_forward"], card))
    for group, ms in sorted(breakdown["by_group_ms"].items(),
                            key=lambda kv: -kv[1]):
        print("  %-22s %.4f ms per forward" % (group, ms))
    return {"launches": launches["norm_act_fwd"], "batches": batches,
            "batches_by_bucket": stats["batches_by_bucket"],
            "decisive_rows": checked, "cpu_vs_card_max_abs": err,
            "bucket32_p50_ms": p50, "bucket32_img_per_s": BATCH * 1e3 / p50,
            "bucket32_latencies_ms": lat, "breakdown": breakdown}


def _kernel_group(name):
    low = name.lower()
    if "norm_act" in low:
        return "norm_act_fwd (K4)"
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transforms"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd")):
        return "convolution (cuDNN)"
    if "pool" in low:
        return "pooling"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "elementwise" in low or "softmax" in low or "reduce" in low:
        return "elementwise/softmax"
    return "other"


def forward_breakdown(torch, mx, mod, batch):
    """Where one bucket-32 request's time goes on the card: the H2D of
    the host batch and the forward (CUDA events, 10 runs each, medians),
    then kernel time by group and the device's busy share over three
    forwards under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fused = mx.fused_step.make_fused_infer(mod._exec_group.executor,
                                           ["data"], top_k=1)

    def events(fn, reps=10):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    h2d = events(lambda: torch.from_numpy(batch).to("cuda"))
    x_dev = torch.from_numpy(batch).to("cuda")
    fused([x_dev])
    copies0 = mx.ops.nn.nhwc_copies
    fused([x_dev])
    copies = mx.ops.nn.nhwc_copies - copies0
    fwd = events(lambda: fused([x_dev]))
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fused([x_dev])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups, kernels_us = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(e.self_device_time_total)
        kernels_us.append((us, e.key))
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    busy_us = sum(us for us, _ in kernels_us)
    check(busy_us > 0, "the profiler saw no device time")
    kernels_us.sort(reverse=True)
    return {"h2d_ms": h2d, "forward_ms": fwd,
            "nhwc_copies_per_forward": copies,
            "profiled_wall_ms_per_forward": wall_s * 1e3 / reps,
            "device_ms_per_forward": busy_us / 1e3 / reps,
            "busy_share": busy_us / 1e6 / wall_s,
            "by_group_ms": {g: us / 1e3 / reps for g, us in groups.items()},
            "top_kernels": [{"name": n[:160], "ms_per_forward": us / 1e3 / reps}
                            for us, n in kernels_us[:12]]}


def _train_group(name):
    low = name.lower()
    if "conv_gemm" in low:
        return "conv_gemm (K3)"
    if "norm_act_bwd" in low:
        return "norm_act_bwd (K5)"
    if "norm_act" in low:
        return "norm_act_fwd (K4)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach SGD)"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd")):
        return "convolution forward (cuDNN)"
    return "other"


def train_module(mx, ctx, batch, seed):
    """ResNet-50 NHWC bound for training at ``batch``, Xavier weights
    (fan-in, magnitude 2) from ``seed``; the same seed gives the same
    weights on every device."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    return mod


def _host(params):
    return {k: v.asnumpy().copy() for k, v in params.items()}


def train_main_path(torch, mx, kernels, card):
    """Module.fit over one epoch of TRAIN_STEPS batches of 32 on the card,
    launch counts zeroed just before and read just after."""
    rng = np.random.RandomState(0)
    images = rng.randn(TRAIN_STEPS * BATCH, *IMAGE).astype(np.float32)
    labels = rng.randint(0, 1000, TRAIN_STEPS * BATCH).astype(np.float32)
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    args0, aux0 = (_host(p) for p in mod.get_params())
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = torch.from_numpy(labels[param.nbatch * BATCH:
                                      (param.nbatch + 1) * BATCH]).to(
            probs.device, torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    kernels.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
            num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
            batch_end_callback=on_batch)
    launches = kernels.launch_counts()
    losses = [float(v) for v in losses]
    args1, aux1 = (_host(p) for p in mod.get_params())
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = float(np.median(steps_ms))
    print("training main path: %d steps of %d, launches %s, losses %s"
          % (len(losses), BATCH, launches, ["%.4f" % v for v in losses]))
    want = {"norm_act_fwd": BN_LAYERS * TRAIN_STEPS,
            "norm_act_bwd": BN_LAYERS * TRAIN_STEPS,
            "conv_gemm": CONV_GEMMS * TRAIN_STEPS,
            "linear": 0, "flash_attn": 0, "rtc": 0}
    check(launches == want, "training launches %s, want %s (53, 53 and 105 "
          "a step)" % (launches, want))
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          "training losses %s" % losses)
    unchanged = [k for k in args0 if np.array_equal(args0[k], args1[k])]
    check(not unchanged, "params unchanged by training: %s" % unchanged)
    stale = [k for k in aux0 if np.array_equal(aux0[k], aux1[k])]
    check(not stale, "moving statistics unchanged: %s" % stale)
    check(all(np.all(np.isfinite(v)) for v in args1.values()),
          "non-finite params after training")
    print("training step (median of steps 2-%d): %.3f ms, %.1f img/s  [%s]"
          % (TRAIN_STEPS, step_ms, BATCH * 1e3 / step_ms, card))
    breakdown = train_breakdown(torch, mx, mod, images[:BATCH],
                                labels[:BATCH])
    print("training step breakdown: %.3f ms on the card per step (device "
          "busy %.1f%% under the profiler)  [%s]"
          % (breakdown["device_ms_per_step"], 100 * breakdown["busy_share"],
             card))
    for group, ms in sorted(breakdown["by_group_ms"].items(),
                            key=lambda kv: -kv[1]):
        print("  %-30s %.4f ms per step" % (group, ms))
    return {"launches": launches, "losses": losses, "steps_ms": steps_ms,
            "step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
            "breakdown": breakdown, "gate": train_gate(mx, images, labels)}


def train_breakdown(torch, mx, mod, images, labels):
    """Kernel time by group and the device's busy share over two
    training steps (forward_backward + update) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = mx.io.DataBatch([images], [labels])
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    reps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups, kernels_us = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(e.self_device_time_total)
        kernels_us.append((us, e.key))
        g = _train_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    busy_us = sum(us for us, _ in kernels_us)
    check(busy_us > 0, "the profiler saw no device time")
    kernels_us.sort(reverse=True)
    return {"profiled_wall_ms_per_step": wall_s * 1e3 / reps,
            "device_ms_per_step": busy_us / 1e3 / reps,
            "busy_share": busy_us / 1e6 / wall_s,
            "by_group_ms": {g: us / 1e3 / reps for g, us in groups.items()},
            "top_kernels": [{"name": n[:160], "ms_per_step": us / 1e3 / reps,
                             "group": _train_group(n)}
                            for us, n in kernels_us[:20]]}


def gate_module(mx, ctx, gamma_b3=None):
    """The training gate's network: :func:`train_module` at batch 2 with
    the gamma of each residual block's last BatchNorm at ``gamma_b3``
    (default GATE_GAMMA_B3)
    (the zero-init-residual recipe of Goyal et al., 2017, kept nonzero so
    that every convolution still gets a gradient). With every gamma at 1
    the step is chaotic in float32 at batch 2: a stage-3 BatchNorm sees
    98 rows a channel, so one ReLU whose pre-activation sits within
    rounding of zero moves a weight gradient by several percent, and the
    port on the CPU against itself, input perturbed by 1e-7, already
    misses rtol 1e-3 / atol 1e-5 by 2.3e-4 at the stem
    (tools/torch_gate_conditioning.py)."""
    gamma_b3 = GATE_GAMMA_B3 if gamma_b3 is None else gamma_b3
    mod = train_module(mx, ctx, 2, seed=1)
    args, aux = mod.get_params()
    for name, arr in args.items():
        if name.endswith("_b3_bn_gamma"):
            arr[:] = np.full(arr.shape, gamma_b3, np.float32)
    mod.set_params(args, aux)
    return mod


def train_gate(mx, images, labels):
    """One training step at batch 2 on the card (the kernels) against the
    port on the CPU (their plain versions), same params and data: loss
    within rtol 1e-4, params after the step within rtol 1e-3 / atol
    1e-5."""
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = gate_module(mx, ctx)
        mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
        mod.forward_backward(mx.io.DataBatch([images[:2]], [labels[:2]]))
        mod.update()
        probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
        loss = float(-np.log(probs[np.arange(2),
                                   labels[:2].astype(int)]).mean())
        res.append((loss, _host(mod.get_params()[0])))
    (lg, pg), (lc, pc) = res
    worst = max((float(np.max(np.abs(pg[k] - pc[k])
                              - 1e-3 * np.abs(pc[k]))), k) for k in pc)
    print("training gate (batch 2, card vs CPU): loss %.6f vs %.6f, params "
          "worst excess over rtol 1e-3 %.3g (atol 1e-5) at %s"
          % (lg, lc, worst[0], worst[1]))
    check(abs(lg - lc) <= 1e-4 * abs(lc), "loss %g on the card, %g on the "
          "CPU" % (lg, lc))
    check(worst[0] <= 1e-5, "param %s differs beyond rtol 1e-3 / atol 1e-5"
          % worst[1])
    return {"loss_card": lg, "loss_cpu": lc, "worst_param": worst[1],
            "worst_excess": worst[0]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", help="write the full record here (JSON)")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import _build
        from mxnet_tpu_torch.ops import kernels
    except ImportError as e:
        print("chip_smoke: the mxnet_tpu_torch package is not beside this "
              "script (%s)" % e, file=sys.stderr)
        return 2

    # 1. environment
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %d device(s): %s"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
             torch.cuda.get_device_name(0)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32))

    # 2. build
    t0 = time.perf_counter()
    log = _build.build_all()
    print("build: %s in %.1f s" % (sorted(_build.SOURCES),
                                   time.perf_counter() - t0))
    for name, rec in log.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))

    # 3. parity on the card
    counts = bn_shapes(mx)
    shapes = [(r, c, 0) for r, c in sorted(counts)] + RAGGED_SHAPES
    fwd_worst, cases = norm_act_fwd_parity(torch, kernels, shapes)
    print("norm_act_fwd parity: %d cases, max abs err f32 %g, bf16 %g"
          % (cases, fwd_worst["float32"], fwd_worst["bfloat16"]))
    bwd_worst, cases = norm_act_bwd_parity(torch, kernels, shapes)
    print("norm_act_bwd parity: %d cases, reruns bit-identical, dx max abs "
          "err f32 %g, bf16 %g; dscale/dshift vs float64: max abs err %g, "
          "max %.3g of sum|term| (bound 1e-5)"
          % (cases, bwd_worst["dx_float32"], bwd_worst["dx_bfloat16"],
             bwd_worst["sums_abs"], bwd_worst["sums_rel"]))
    gemms = conv_gemm_shapes(mx)
    gemm_worst, cases = conv_gemm_parity(
        torch, kernels, sorted(gemms) + RAGGED_GEMMS)
    print("conv_gemm parity: %d cases (%d distinct products of the step + "
          "%d ragged, f32 and bf16 operands), reruns bit-identical, max abs "
          "err vs float64 f32 %g, bf16 %g; max %.3g of sum|a||b| (bound "
          "1e-6)" % (cases, len(gemms), len(RAGGED_GEMMS),
                     gemm_worst["abs_float32"], gemm_worst["abs_bfloat16"],
                     gemm_worst["rel"]))
    flash_worst, cases = flash_parity(torch, kernels)
    print("flash_attn parity: %d cases (%d shapes, causal and not), reruns "
          "bit-identical, max abs err vs plain %g (bound rtol 2e-4 / atol "
          "2e-5)" % (cases, len(FLASH_SHAPES), flash_worst))
    linear_worst, cases = linear_parity(torch, kernels)
    print("linear parity: %d cases, reruns bit-identical, max abs err vs "
          "float64 %g; max %.3g of sum|x||w|+|b| (bound 1e-6)"
          % (cases, linear_worst["abs"], linear_worst["rel"]))
    rtc_check = rtc_parity(torch, mx)
    print("rtc parity: axpy bit-equal to 2*x+y, gelu_ish max rel err %.3g "
          "(bound 1e-4), bad body refused: %s"
          % (rtc_check["gelu_max_rel_err"], rtc_check["bad_body_log"]))

    # 4. timing at the main paths' shapes
    fwd_shapes, fwd_tot = norm_act_fwd_timing(torch, kernels, counts)
    print("norm_act_fwd per forward (53 launches, f32): kernel %.4f ms, "
          "plain %.4f ms, addcmul %.4f ms, bound %.4f ms  [%s]"
          % (fwd_tot["ms"], fwd_tot["plain_ms"], fwd_tot["library_ms"],
             fwd_tot["bound_ms"], card))
    bwd_shapes, bwd_tot = norm_act_bwd_timing(torch, kernels, counts)
    print("norm_act_bwd per step (53 launches, f32): kernel %.4f ms, plain "
          "%.4f ms, bound %.4f ms  [%s]"
          % (bwd_tot["ms"], bwd_tot["plain_ms"], bwd_tot["bound_ms"], card))
    gemm_shapes, gemm_tot = conv_gemm_timing(torch, kernels, gemms)
    print("conv_gemm per step (105 launches, f32): kernel %.4f ms, plain "
          "%.4f ms, torch.matmul %.4f ms, bound %.4f ms (%s), %.1f TFLOP  "
          "[%s]" % (gemm_tot["ms"], gemm_tot["plain_ms"],
                    gemm_tot["library_ms"], gemm_tot["bound_ms"],
                    gemm_tot["bound_by"], gemm_tot["flops"] / 1e12, card))
    flash_rows = flash_timing(torch, kernels)
    linear_rows = linear_timing(torch, kernels)
    rtc_time = rtc_timing(torch, mx)
    print("timed on [%s]" % card)

    # 5. serving, 6. training: the main paths
    serve = serve_main_path(torch, mx, kernels, card)
    train = train_main_path(torch, mx, kernels, card)

    # 7. the slice's entry points at full width
    entry = entry_points_main_path(torch, mx, kernels)

    # 8. report
    train_scope = "%d launches of one ResNet-50 NHWC training step, batch " \
        "32, f32"
    records = [{
        "name": "norm_act_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:579",
        "launches": train["launches"]["norm_act_fwd"],
        "launches_by_path": {"serve": serve["launches"],
                             "train": train["launches"]["norm_act_fwd"]},
        "max_abs_err": fwd_worst["float32"],
        "max_err_f32": fwd_worst["float32"],
        "max_err_bf16": fwd_worst["bfloat16"],
        "ms": fwd_tot["ms"], "plain_ms": fwd_tot["plain_ms"],
        "bound_ms": fwd_tot["bound_ms"], "bound_by": "bytes",
        "library_ms": fwd_tot["library_ms"],
        "scope": "53 launches of one ResNet-50 NHWC forward, batch 32, f32",
    }, {
        "name": "norm_act_bwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:610",
        "launches": train["launches"]["norm_act_bwd"],
        "max_abs_err": max(bwd_worst["dx_float32"], bwd_worst["sums_abs"]),
        "max_err_dx_f32": bwd_worst["dx_float32"],
        "max_err_dx_bf16": bwd_worst["dx_bfloat16"],
        "max_sum_err_of_abs_sum": bwd_worst["sums_rel"],
        "ms": bwd_tot["ms"], "plain_ms": bwd_tot["plain_ms"],
        "bound_ms": bwd_tot["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes dx, dscale and "
                        "dshift together",
        "scope": train_scope % BN_LAYERS,
    }, {
        "name": "conv_gemm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/conv_gemm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:319",
        "launches": train["launches"]["conv_gemm"],
        "max_abs_err": gemm_worst["abs_float32"],
        "max_err_bf16": gemm_worst["abs_bfloat16"],
        "max_err_of_abs_product": gemm_worst["rel"],
        "ms": gemm_tot["ms"], "plain_ms": gemm_tot["plain_ms"],
        "bound_ms": gemm_tot["bound_ms"], "bound_by": gemm_tot["bound_by"],
        "library_ms": gemm_tot["library_ms"],
        "library_call": "torch.matmul on the same operands",
        "scope": train_scope % CONV_GEMMS,
    }, {
        "name": "linear", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/linear.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:56",
        "launches": entry["launches"]["linear"],
        "max_abs_err": linear_worst["abs"],
        "max_err_of_abs_product": linear_worst["rel"],
        "ms": linear_rows[1]["ms"], "plain_ms": linear_rows[1]["plain_ms"],
        "bound_ms": linear_rows[1]["bound_ms"],
        "bound_by": linear_rows[1]["bound_by"],
        "library_ms": linear_rows[1]["library_ms"],
        "library_call": "torch.addmm (plus the activation)",
        "scope": "one call at ResNet-50's head, (%d, 2048) -> 1000, f32, "
                 "the entry-point path's shape" % BATCH,
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:154",
        "launches": entry["launches"]["flash_attn"],
        "max_abs_err": flash_worst,
        "ms": flash_rows[1]["ms"], "plain_ms": flash_rows[1]["plain_ms"],
        "bound_ms": flash_rows[1]["bound_ms"], "bound_by": "operations",
        "library_ms": flash_rows[1]["library_ms"],
        "library_call": "F.scaled_dot_product_attention on (B, H, T, D)",
        "scope": "one call at the demo's %s, causal, f32, the ulysses "
                 "path's shape" % (DEMO_ATTN,),
    }, {
        "name": "rtc", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py (NVRTC, body compiled at run "
                  "time)",
        "replaces": "mxnet_tpu/rtc.py:71",
        "launches": entry["launches"]["rtc"],
        "max_abs_err": rtc_check["axpy_max_abs_err"],
        "gelu_max_rel_err": rtc_check["gelu_max_rel_err"],
        "ms": rtc_time["ms"], "plain_ms": rtc_time["plain_ms"],
        "bound_ms": rtc_time["bound_ms"], "bound_by": "bytes",
        "library_ms": rtc_time["library_ms"],
        "library_call": "torch.add(y, x, alpha=2), the axpy body's function",
        "library_note": "a user kernel: the body timed is one choice of "
                        "many; every time here is the axpy body's",
        "scope": "one push of the axpy body over %d float32 elements"
                 % RTC_N,
    }]
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": records,
                       "norm_act_fwd_shapes": fwd_shapes,
                       "norm_act_bwd_shapes": bwd_shapes,
                       "conv_gemm_shapes": gemm_shapes,
                       "flash_attn_shapes": flash_rows,
                       "linear_shapes": linear_rows, "rtc_timing": rtc_time,
                       "main_path": serve, "train_path": train,
                       "entry_points": entry}, f,
                      indent=1)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
