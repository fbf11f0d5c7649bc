#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (nvidia-smi), CUDA and
   torch versions; TF32 off for convolutions and matmuls.
2. build: every hand-written kernel from mxnet_tpu_torch/csrc, one nvcc
   per source, all at once; the K3, K1 and K2 libraries must hold TF32
   tensor-core MMA instructions (HMMA with TF32 operands in cuobjdump
   -sass).
3. kernel parity on the card, at the shapes the main paths give each
   kernel plus ragged ones: K4 (norm_act_fwd) and K5 (norm_act_bwd)
   against their plain PyTorch versions, K3 (conv_gemm) against a
   float64 product of the same operands; reruns of K3 and K5 must be
   bit-identical.
   K2 (flash_attn) against its plain version (reference attention,
   mask -1e30) at the demo shape of examples/long_context, each head
   width the kernel instantiates and ragged T and D, reruns
   bit-identical; K1 (linear) against a float64 act(x @ w.T + b), one
   CUDA launch a call (torch.profiler), reruns bit-identical, and a
   sha256 digest of its output at each shape on seeded inputs; K6 (Rtc,
   NVRTC): an axpy body and the same body with float4 loads and with
   read-only (__ldg) loads bit-equal to 2*x+y, a gelu-like body within
   rtol 1e-4, an in-place push equal to 2*x, a bad body raising with
   NVRTC's log.
4. kernel timing: median of CUDA-event times with the L2 cache flushed
   before each launch, beside the plain version, the one-call PyTorch
   yardstick where there is one and the bound (bytes at 3.35 TB/s or
   operations at the data-sheet rate, whichever is longer: K1, K2 and K3
   at 495/3 TFLOP/s, three TF32 passes for float32 accuracy, with the
   67 TFLOP/s CUDA-core bound beside it as simt_bound_ms), summed over
   the launches of one ResNet-50 forward (K4) or training step (K3, K5);
   K2 at the demo shape and at T=16384 (beside
   scaled_dot_product_attention), K1 at three layers and the MNIST
   MLP's three and five around the narrow tile's limit (beside addmm),
   the Rtc axpy and its float4 and __ldg bodies beside 2*x+y and
   torch.add.
5. serving at full width: ResNet-50, 224x224, 1000 classes, NHWC,
   random seeded weights, served through Module -> InferenceServer ->
   FusedInfer from two client threads; kernel launch counts are zeroed
   just before and read just after; served argmax against a direct
   Executor.forward; card probabilities against the port on the CPU.
6. training at full width: the same network through Module.fit (SGD,
   momentum 0.9, wd 1e-4, rescale_grad 1/32) over 5 batches of 32 from
   seed 0, first through the classic loop, then through the fused step
   (fit(fused_step=True): one eager step, one CUDA graph capture, a
   replay a batch after the first) from the same weights; for each,
   launch counts zeroed just before and read just after (K3 105, K4 53
   and K5 53 a step: in the classic loop every step, in the fused loop
   the eager step and the launches the capture records, since a replay
   runs no wrapper), finite losses, every param and moving statistic
   changed; the fused loop's params, moving statistics, losses and
   metric equal the classic loop's bit for bit; both loops' host step
   time (median of steps 2-5 between batch-end callbacks, card
   synchronised), img/s, peak allocated memory and a torch.profiler
   breakdown over two steps (device ms a step, busy share, and the
   launches the card ran, counted from the kernel events: 105, 53 and
   53 a step in both loops; the fused replay also by CUDA events); one
   classic step at batch 2 on the card against the port on the CPU.
   Then the MNIST path: idx files written from seeded numpy (separable
   class templates), the MLP and LeNet through
   FeedForward(fused_step=True) over MNISTIter batches of 128 for 2
   epochs (LeNet runs K3 three times a step), losses falling and
   held-out accuracy >= 0.97, two more replays under torch.profiler
   (LeNet: K3 three times a replay), and three fused steps of each at
   batch 2 on the card against the port on the CPU.
7. entry points at full width, launch counts zeroed just before and
   read just after: parallel.make_ring_attention over a one-rank "sp"
   mesh at the demo's (1, 4096, 8, 32), causal, impl "ulysses" (K2 once
   a call) and "ring" (K2 never), each against reference_attention, and
   one backward through ulysses against autograd through the reference;
   fused_linear at ResNet-50's head on the card's ResNet features
   against the FullyConnected output; two Rtc pushes.
8. checkpoints at full width: ResNet-50 NHWC, batch 32, f32, phase 6's
   SGD settings, six batches from seed 0, fit(fused_step=True).
   (a) uninterrupted: losses L and final params P; (b) MXNET_TPU_CKPT_DIR
   with a snapshot every 3 steps: losses equal L bit for bit, ckpt.saves,
   ckpt.bytes, ckpt.save_ms and the saving steps' host time against the
   other replays'; (c) a fresh module resumed from the step-3 snapshot:
   ckpt.restores 1, losses L[3..5] and params P bit for bit, one capture,
   launch counts zeroed just before and read just after (K3 210, K4 106,
   K5 106: the eager step and the capture), the restore time; (d) data
   b0, b1, b2, b3, b3 with manager.rollback() to the step-3 snapshot
   after the first b3: the replay that follows gives L[3] bit for bit,
   the params end equal to (a)'s after four steps, one capture;
   (e) Module.save_checkpoint with the optimizer states, loaded by a
   Module on the CPU: params and momenta bit-equal; (f) a child process
   trains the MNIST MLP on the card (fit(fused_step=True),
   MXNET_TPU_CKPT_DIR set) and sends itself SIGTERM after step 5: it must
   end by the signal with a "preempt" snapshot of step 5, and a second
   child resumes from it and finishes the epoch (each bounded by a
   timeout). One summary line: snapshot MB, save ms, restore ms, the
   saving step's host ms against the median step's.
9. fit's health and input plane at full width: ResNet-50 NHWC, batch
   32, f32, phase 6's SGD settings, 8 batches from seed 0 through
   fit(fused_step=True) with telemetry on, launch counts zeroed just
   before and read just after every fit (K3 210, K4 106, K5 106: the
   eager step and the capture; one capture each). (1) plain,
   MXNET_TPU_DEVICE_STAGING=1 and MXNET_TPU_FEED_DEPTH=2, each with a
   batch-end callback that synchronises the card and without one:
   params, moving statistics and losses bit-equal to the plain fit; the
   wall ms a step over batches 3-6, the host ms a step copying batches
   in on the training thread, io.feed_stall_ms a step and the busy
   share of the last two steps (torch.profiler). (2) MXNET_TPU_NUMWATCH
   at EVERY_N=1 with device staging, the metrics server (port 0) and
   the flight recorder armed: params bit-equal to unarmed, the compiled
   kernels' events a replay unchanged, device ms a step (CUDA events)
   and kernel events a replay armed against unarmed, the fetch ms, the
   pack's grad l2, max-abs and update/weight ratio against a float64
   recomputation on the card (rtol 1e-5); /metrics and /healthz over
   loopback, the step ring (one record a step, the capturing step
   labelled recompile), a FlightRecorder dump with steps.jsonl and
   numwatch.jsonl. (3) the
   skip guard across an all-NaN batch: weights, momenta and metric sums
   bit-identical, numwatch.skipped_steps 1. (4) the rollback guard with
   MXNET_TPU_CKPT_DIR: a weight poisoned in place is named (kind
   "param") and restored into the same storage, losses finite after.
   (5) a default Monitor: its rows equal norm(x)/sqrt(size) recomputed
   on the card.
10. the ImageNet models at scale: AlexNet (with LRN), VGG-16, GoogLeNet
   and ResNet-50 at 224x224 and Inception-v3 at 299x299, NCHW, 1000
   classes, batch 32, f32, phase 6's SGD settings, 5 batches of seeded
   synthetic images, seeded Xavier weights. For each: the classic loop,
   then fit(fused_step=True) from the same weights, launch counts zeroed
   just before and read just after each (K3 2 x convolutions - 1 a step:
   9, 25, 113, 187 and 105; K4 and K5 0, as NCHW BatchNorm is
   elementwise); one capture; params, moving statistics, losses and the
   metric bit-equal, Dropout masks included; AlexNet once more through
   PrefetchingIter(ResizeIter(NDArrayIter)), bit-equal to the plain
   iterator; two profiled replays (K3 launches, device ms, busy share,
   time by group: K3, the cuDNN forward, copies); host step ms and img/s
   of both loops; peak allocated memory; one batch-2 step on the card
   against the CPU with the Dropout masks keyed by node name (loss
   within rtol 1e-4, update within 1e-2 of its norm); K3 alone over the
   step's products beside torch.matmul; the NCHW -> channels-last
   copies of K3's wrapper timed alone. Then K3 against a float64 product
   at every product of the five steps that phase 3 does not hold, and
   MXRecordIO/MXIndexedRecordIO round trips of packed records (no PIL).
11. report: one JSON line of kernel records, the card line, then
   {"ok": true, "device": {...}} as the last line.

``--report PATH`` also writes the per-shape records and the main paths'
breakdowns to PATH as JSON. ``--ckpt-child DIR`` is phase 8's child
process, which the phase starts itself.
"""
import argparse
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, float32 without tensor cores
# H100 SXM data sheet, dense TF32 on the tensor cores over three passes: the
# least time for float32-accurate products (hi*lo + lo*hi + hi*hi)
TF32X3_FLOPS_PER_S = 495e12 / 3
TF32_KERNELS = ("conv_gemm", "linear", "flash_attn")
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
# timed: the first three cases, the MNIST MLP's layers at batch 128
# (mxnet_tpu/models/mlp.py: 784 -> 128 relu -> 64 relu -> 10), then
# layers with 32, 64, 96 and 128 wide tiles, around the narrow tile's
# limit (two thirds of a wave: 88 on 132 SMs)
LINEAR_TIMED = [(128, 256, 128, "none"), (BATCH, 2048, 1000, "none"),
                (8192, 4096, 4096, "relu"), (128, 784, 128, "relu"),
                (128, 128, 64, "relu"), (128, 64, 10, "none"),
                (512, 1024, 1024, "none"), (1024, 1024, 1024, "none"),
                (768, 2048, 2048, "none"), (1024, 2048, 2048, "none"),
                (4096, 1024, 512, "none")]
RTC_N = 1 << 24                # elements of each array of the Rtc bodies
MNIST_TRAIN = 5120             # 40 batches of 128
MNIST_TEST = 1024
MNIST_BATCH = 128
MNIST_EPOCHS = 2
# separable templates at 40/255 pixel noise: both networks should reach
# every held-out digit; 0.97 leaves room for a few hard samples
MNIST_MIN_ACC = 0.97
CKPT_STEPS = 6                 # the checkpoint phase's batches of 32
CKPT_EVERY = 3                 # its periodic cadence: snapshots at 3 and 6
CKPT_DIE_AT = 5                # the SIGTERM child's last step
CKPT_CHILD_TIMEOUT_S = 300


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


def conv_gemm_timing(torch, kernels, counts, reps=20, verbose=True):
    """K3 at the (M, N, K, transpose) products of one training step,
    float32 operands, beside the plain version and torch.matmul on the
    same operands; the bound is the longer of 2MNK at the 3xTF32 rate
    and the bytes (A and B read, C written) at the memory rate, and the
    CUDA-core bound (2MNK at the float32 rate) stands beside it."""
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
                       flush, reps)
        plain = time_ms(torch, lambda: kernels.matmul_f32acc_plain(a, b,
                                                                   trans),
                        flush, reps)
        lib = time_ms(torch, lambda: torch.matmul(at, b), flush, reps)
        nbytes = (m * k + k * n + m * n) * 4
        flops = 2 * m * n * k
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / TF32X3_FLOPS_PER_S)
        simt = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rows_out.append({"m": m, "n": n, "k": k, "transpose_a": trans,
                         "per_step": cnt, "ms": kern, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "simt_bound_ms": simt,
                         "tflops": flops / kern / 1e9})
        if verbose:
            print("  conv_gemm (%6d, %4d, %6d, %s) x%-2d kernel %.4f ms  "
                  "plain %.4f ms  matmul %.4f ms  bound %.4f ms (simt %.4f)  "
                  "(%.1f TFLOP/s)" % (m, n, k, "T" if trans else "N", cnt,
                                      kern, plain, lib, bound, simt,
                                      flops / kern / 1e9))
        tot["ms"] += cnt * kern
        tot["plain_ms"] += cnt * plain
        tot["library_ms"] += cnt * lib
        tot["bytes"] += cnt * nbytes
        tot["flops"] += cnt * flops
        del a, b, at
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    t_flops = tot["flops"] / TF32X3_FLOPS_PER_S
    tot["bound_ms"] = 1e3 * max(t_bytes, t_flops)
    tot["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
    tot["simt_bound_ms"] = 1e3 * max(t_bytes,
                                     tot["flops"] / F32_FLOPS_PER_S)
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


def cuda_kernels(torch, fn):
    """Names of the kernels the card ran for fn(), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def linear_digests(torch, kernels):
    """sha256 (first 16 hex digits) of K1's output bytes at every
    LINEAR_CASES shape and act on fixed seeded inputs: two trees whose K1
    splits K alike give equal digests on one card."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for m, k, n, acts in LINEAR_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        for act in acts:
            y = kernels.fused_linear(x, w, b, act).cpu().numpy()
            out["(%d, %d) -> %d %s" % (m, k, n, act)] = hashlib.sha256(
                y.tobytes()).hexdigest()[:16]
        del x, w, b
    return out


def linear_parity(torch, kernels):
    """K1 against act(x @ w.T + b) in float64: every element within 1e-6
    of sum|x||w| + |b| (K3's bound), plus 2e-7 (one libm ulp) for tanh
    and sigmoid; a rerun bit-identical; one CUDA launch a call (one more
    call at every shape and act under one torch.profiler session)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, cases = {"abs": 0.0, "rel": 0.0}, 0
    calls = []
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
            calls.append((x, w, b, act))
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
        del pre, mag, got, again, err
    ran = cuda_kernels(torch, lambda: [kernels.fused_linear(*c)
                                       for c in calls])
    check(len(ran) == len(calls) and all("linear_kernel" in r for r in ran),
          "%d fused_linear calls ran %d kernels, want one linear_kernel "
          "each: %s" % (len(calls), len(ran), sorted(set(ran))))
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


def rtc_yardsticks(x, y, out, n):
    """The axpy body written two other ways, as yardsticks of what the
    launch route allows, not kernels the port calls: "float4", four
    elements a thread by 16-byte loads, and "ldg", one element a thread
    read through the read-only path (what __restrict__ parameters let the
    compiler choose). Each maps to its Rtc, grid and block."""
    from mxnet_tpu_torch.rtc import Rtc

    check(n % 4 == 0, "the float4 body takes a multiple of 4 elements")
    index = "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
    float4 = ("long long i = ((long long)blockIdx.x * blockDim.x + "
              "threadIdx.x) * 4;\nif (i < %dLL) {\n"
              "  float4 a = *reinterpret_cast<const float4*>(x + i);\n"
              "  float4 c = *reinterpret_cast<const float4*>(y + i);\n"
              "  *reinterpret_cast<float4*>(out + i) = make_float4(2.0f * a.x"
              " + c.x, 2.0f * a.y + c.y, 2.0f * a.z + c.z, 2.0f * a.w + c.w);"
              "\n}" % n)
    ldg = index + ("if (i < %dLL) out[i] = 2.0f * __ldg(x + i) + "
                   "__ldg(y + i);" % n)
    arrays = ([("x", x), ("y", y)], [("out", out)])
    return {"float4": (Rtc("axpy4", *arrays, float4), (-(-n // 1024),),
                       (256,)),
            "ldg": (Rtc("axpy_ldg", *arrays, ldg),) + rtc_dims(n)}


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
    # in place: x is the input and the output
    z = mx.nd.NDArray(x.handle.clone(), mx.gpu(0))
    scale2 = Rtc("scale2", [("x", z)], [("out", z)],
                 "long long i = (long long)blockIdx.x * blockDim.x + "
                 "threadIdx.x;\nif (i < %dLL) out[i] = 2.0f * x[i];" % RTC_N)
    scale2.push([z], [z], grid, block)
    torch.cuda.synchronize()
    check(torch.equal(z.handle, 2 * x.handle), "in-place Rtc push of "
          "out[i] = 2.0f * x[i] differs from 2*x")
    for name, (body, grid_, block_) in rtc_yardsticks(x, y, out,
                                                      RTC_N).items():
        out.handle.zero_()
        body.push([x, y], [out], grid_, block_)
        torch.cuda.synchronize()
        check(torch.equal(out.handle, 2 * x.handle + y.handle),
              "the %s axpy body differs from 2*x+y" % name)
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
    causal) at the 3xTF32 rate, or q, k, v, o at the memory rate; the
    CUDA-core bound (the flops at the f32 rate) beside it."""
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
        bound = 1e3 * max(flops / TF32X3_FLOPS_PER_S,
                          nbytes / HBM_BYTES_PER_S)
        simt = 1e3 * max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        rows.append({"shape": [b, t, h, d], "causal": causal, "ms": kern,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "simt_bound_ms": simt, "flops": flops,
                     "tflops": flops / kern / 1e9})
        print("  flash_attn %s causal=%-5s kernel %.4f ms  plain %.4f ms  "
              "sdpa %.4f ms  bound %.4f ms (simt %.4f)  (%.1f TFLOP/s)"
              % ((b, t, h, d), causal, kern, plain, lib, bound, simt,
                 flops / kern / 1e9))
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


def linear_timing(torch, kernels):
    """K1 beside its plain version and addmm plus the activation (timed,
    never called by the port); the bound is the longer of 2MNK at the
    3xTF32 rate and x, w, b read and out written at the memory rate; the
    CUDA-core bound (2MNK at the f32 rate) beside it."""
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
        t_ops, t_bytes = flops / TF32X3_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        rows.append({"m": m, "k": k, "n": n, "act": act, "ms": kern,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "simt_bound_ms": 1e3 * max(flops / F32_FLOPS_PER_S,
                                                t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "tflops": flops / kern / 1e9})
        print("  linear (%5d, %4d) -> %4d %-4s kernel %.4f ms  plain %.4f ms"
              "  addmm %.4f ms  bound %.4f ms (%s)  (%.1f TFLOP/s)"
              % (m, k, n, act, kern, plain, lib, rows[-1]["bound_ms"],
                 rows[-1]["bound_by"], flops / kern / 1e9))
        del x, w, b, wt
    return rows


def rtc_timing(torch, mx):
    """The axpy body over RTC_N elements beside its rtc_yardsticks bodies,
    2*x+y and the one PyTorch call that computes it,
    torch.add(y, x, alpha=2); bytes bound it (x and y read, out
    written)."""
    flush = torch.empty(64 << 20, device="cuda")
    axpy, _, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    kern = time_ms(torch, lambda: axpy.push([x, y], [out], grid, block),
                   flush)
    yard = {name: time_ms(torch, lambda: body.push([x, y], [out], g, b),
                          flush)
            for name, (body, g, b) in rtc_yardsticks(x, y, out,
                                                     RTC_N).items()}
    plain = time_ms(torch, lambda: 2 * x.handle + y.handle, flush)
    lib = time_ms(torch, lambda: torch.add(y.handle, x.handle, alpha=2.0),
                  flush)
    bound = 1e3 * 3 * RTC_N * 4 / HBM_BYTES_PER_S
    print("  rtc axpy (%d elements) kernel %.4f ms  float4 body %.4f ms  "
          "ldg body %.4f ms  2*x+y %.4f ms  torch.add %.4f ms  bound %.4f ms"
          % (RTC_N, kern, yard["float4"], yard["ldg"], plain, lib, bound))
    return {"n": RTC_N, "ms": kern, "yardstick_ms": yard,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bound}


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


def train_data(steps=TRAIN_STEPS):
    """``steps`` batches of 32 images and labels from seed 0."""
    rng = np.random.RandomState(0)
    images = rng.randn(steps * BATCH, *IMAGE).astype(np.float32)
    labels = rng.randint(0, 1000, steps * BATCH).astype(np.float32)
    return images, labels


def _resnet_launches(steps):
    """The compiled kernels' launches of ``steps`` ResNet-50 training
    steps, by wrapper."""
    return {"norm_act_fwd": BN_LAYERS * steps,
            "norm_act_bwd": BN_LAYERS * steps,
            "conv_gemm": CONV_GEMMS * steps, "linear": 0, "flash_attn": 0}


def fit_module(torch, mx, kernels, mod, images, labels, fused, wrap=None):
    """Module.fit of the bound ``mod`` over one epoch of ``images`` in
    batches of 32 on the card, the classic loop or the fused step; launch
    counts and the peak of allocated memory zeroed just before and read
    just after. Per step: the loss of the forward's probabilities and
    the host clock at the batch-end callback, with the card
    synchronised. ``wrap`` wraps the NDArrayIter (and is closed
    after)."""
    metric = mx.metric.Accuracy()
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = torch.from_numpy(labels[param.nbatch * BATCH:
                                      (param.nbatch + 1) * BATCH]).to(
            probs.device, torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    it = mx.io.NDArrayIter(images, labels, batch_size=BATCH)
    if wrap is not None:
        it = wrap(it)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
            eval_metric=metric, batch_end_callback=on_batch,
            fused_step=fused)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if wrap is not None:
        it.close()
    args, aux = (_host(p) for p in mod.get_params())
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = float(np.median(steps_ms))
    return {"mod": mod, "metric": metric, "launches": launches,
            "losses": [float(v) for v in losses], "steps_ms": steps_ms,
            "step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
            "peak_bytes": peak, "peak_above_start_bytes": peak - base,
            "args": args, "aux": aux, "accuracy": metric.get()[1]}


def fit_resnet(torch, mx, kernels, images, labels, fused):
    """fit_module over TRAIN_STEPS batches from train_module's seed-0
    weights, checked: the launches of every step (classic) or of the
    eager step and the capture (fused), finite losses, every param and
    moving statistic changed."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    args0, aux0 = (_host(p) for p in mod.get_params())
    run = fit_module(torch, mx, kernels, mod, images, labels, fused)
    launches, losses = run["launches"], run["losses"]
    args1, aux1 = run["args"], run["aux"]
    # a replay runs no wrapper: the fused loop's wrappers count the eager
    # step and the capture (fused_train_path counts the replays)
    counted = 2 if fused else TRAIN_STEPS
    want = dict(_resnet_launches(counted), rtc=0)
    loop = "fused" if fused else "classic"
    print("training main path (%s loop): %d steps of %d, launches %s, "
          "losses %s" % (loop, len(losses), BATCH, launches,
                         ["%.4f" % v for v in losses]))
    check(launches == want, "%s training launches %s, want %s (53, 53 and "
          "105 a step, %d steps)" % (loop, launches, want, counted))
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          "%s training losses %s" % (loop, losses))
    unchanged = [k for k in args0 if np.array_equal(args0[k], args1[k])]
    check(not unchanged, "params unchanged by training: %s" % unchanged)
    stale = [k for k in aux0 if np.array_equal(aux0[k], aux1[k])]
    check(not stale, "moving statistics unchanged: %s" % stale)
    check(all(np.all(np.isfinite(v)) for v in args1.values()),
          "non-finite params after training")
    return run


def print_breakdown(loop, breakdown, card):
    print("%s step breakdown: %.3f ms on the card per step (device busy "
          "%.1f%% under the profiler, %.3f ms a step on the host clock)  "
          "[%s]" % (loop, breakdown["device_ms_per_step"],
                    100 * breakdown["busy_share"],
                    breakdown["profiled_wall_ms_per_step"], card))
    for group, ms in sorted(breakdown["by_group_ms"].items(),
                            key=lambda kv: -kv[1]):
        print("  %-30s %.4f ms per step" % (group, ms))


def train_main_path(torch, mx, kernels, card, images, labels):
    """The classic loop (forward_backward, update, update_metric)."""
    run = fit_resnet(torch, mx, kernels, images, labels, fused=False)
    del run["metric"]
    print("classic step (median of steps 2-%d): %.3f ms, %.1f img/s, peak "
          "allocated %.3f GB (%.3f above the start)  [%s]"
          % (TRAIN_STEPS, run["step_ms"], run["img_per_s"],
             run["peak_bytes"] / 1e9, run["peak_above_start_bytes"] / 1e9,
             card))
    run["breakdown"] = train_breakdown(torch, mx, kernels, run.pop("mod"),
                                       images[:BATCH], labels[:BATCH])
    print_breakdown("classic", run["breakdown"], card)
    check_profiled_launches("classic", run["breakdown"])
    run["gate"] = train_gate(mx, images, labels)
    return run


def fused_train_path(torch, mx, kernels, card, images, labels, classic):
    """The fused loop: Module.fit(fused_step=True) from the same weights,
    data and optimizer as the classic loop. One eager step, one capture,
    a replay a batch after the first; the classic loop's launches a step;
    params and moving statistics after 5 steps bit-equal to the classic
    loop's."""
    run = fit_resnet(torch, mx, kernels, images, labels, fused=True)
    mod = run.pop("mod")
    step = mod._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    print("fused step counters: %s" % counters)
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": TRAIN_STEPS - 1},
          "fused step counters %s, want one eager step, one capture and "
          "a replay a batch after the first" % counters)
    diffs = {}
    for name, mine, theirs in (("params", run["args"], classic["args"]),
                               ("aux", run["aux"], classic["aux"])):
        diffs[name] = max(float(np.max(np.abs(mine[k] - theirs[k])))
                          for k in theirs)
        unequal = [k for k in theirs if not np.array_equal(mine[k],
                                                           theirs[k])]
        check(not unequal, "fused and classic %s differ after %d steps at "
              "%s (max abs diff %g)" % (name, TRAIN_STEPS, unequal[:5],
                                        diffs[name]))
    check(run["losses"] == classic["losses"], "fused losses %s, classic %s"
          % (run["losses"], classic["losses"]))
    check(run["accuracy"] == classic["accuracy"], "fused metric %r, classic "
          "%r" % (run["accuracy"], classic["accuracy"]))
    print("fused vs classic after %d steps: params and moving statistics "
          "bit-equal (max abs diff %g / %g), losses and accuracy equal"
          % (TRAIN_STEPS, diffs["params"], diffs["aux"]))
    print("fused step (median of steps 2-%d): %.3f ms, %.1f img/s, peak "
          "allocated %.3f GB (%.3f above the start)  [%s]"
          % (TRAIN_STEPS, run["step_ms"], run["img_per_s"],
             run["peak_bytes"] / 1e9, run["peak_above_start_bytes"] / 1e9,
             card))
    run["breakdown"] = fused_breakdown(torch, mx, kernels, step,
                                       run["metric"], images[:BATCH],
                                       labels[:BATCH])
    print_breakdown("fused", run["breakdown"], card)
    check_profiled_launches("fused", run["breakdown"])
    print("fused replay: %.3f ms a step on the card by CUDA events, %.3f ms "
          "of host time to enqueue a step on an idle card (copy in, "
          "hyperparameters, replay)  [%s]"
          % (run["breakdown"]["event_ms_per_step"],
             run["breakdown"]["host_enqueue_ms"], card))
    run.pop("metric")
    run.update(counters=counters, max_abs_diff_vs_classic=diffs)
    return run


def check_profiled_launches(loop, breakdown):
    """The launches the card ran in the profiled steps, counted from the
    kernel events: 105 K3, 53 K4 and 53 K5 a step."""
    want = _resnet_launches(breakdown["steps"])
    print("%s: launches the card ran in %d profiled steps (kernel events): "
          "%s" % (loop, breakdown["steps"], breakdown["launches"]))
    check(breakdown["launches"] == want, "%s: the card ran %s in %d "
          "profiled steps, want %s" % (loop, breakdown["launches"],
                                       breakdown["steps"], want))


def train_breakdown(torch, mx, kernels, mod, images, labels):
    """Kernel time by group and the device's busy share over two
    training steps (forward_backward + update) under torch.profiler."""
    batch = mx.io.DataBatch([images], [labels])

    def classic_step():
        mod.forward_backward(batch)
        mod.update()

    classic_step()
    torch.cuda.synchronize()
    return _profile_steps(torch, kernels, classic_step)


def _profile_steps(torch, kernels, run_step, reps=2, group=None):
    """Kernel time by group (``group``, default _train_group), the busy
    share and the compiled kernels' launches (``kernels.launches_in``
    over the kernel events) of ``reps`` calls of ``run_step`` under
    torch.profiler."""
    group = group or _train_group
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups, kernels_us, names = {}, [], []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        names += [e.key] * e.count
        us = float(e.self_device_time_total)
        kernels_us.append((us, e.key))
        g = group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    busy_us = sum(us for us, _ in kernels_us)
    check(busy_us > 0, "the profiler saw no device time")
    kernels_us.sort(reverse=True)
    return {"steps": reps, "launches": kernels.launches_in(names),
            "profiled_wall_ms_per_step": wall_s * 1e3 / reps,
            "device_ms_per_step": busy_us / 1e3 / reps,
            "busy_share": busy_us / 1e6 / wall_s,
            "by_group_ms": {g: us / 1e3 / reps for g, us in groups.items()},
            "top_kernels": [{"name": n[:160], "ms_per_step": us / 1e3 / reps,
                             "group": group(n)}
                            for us, n in kernels_us[:20]]}


def fused_breakdown(torch, mx, kernels, step, metric, images, labels,
                    reps=2):
    """Two replays of the captured step under torch.profiler; then the
    device time of 10 back-to-back steps by CUDA events, and the host
    time to enqueue one step on an idle card (median of 10, each after a
    synchronise: with work queued, the step waits for the copy out of
    its pinned buffer two steps back)."""
    batch = mx.io.DataBatch([images], [labels])
    step.step(batch, metric)
    torch.cuda.synchronize()
    res = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                         reps)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        step.step(batch, metric)
    end.record()
    torch.cuda.synchronize()
    res["event_ms_per_step"] = start.elapsed_time(end) / 10
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.step(batch, metric)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    res["host_enqueue_ms"] = 1e3 * float(np.median(host))
    return res


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


def write_mnist_idx(out_dir, seed=0):
    """MNIST-format idx files (train-images-idx3-ubyte and the rest) from
    seeded numpy: a 28x28 template of bright strokes a class, each sample
    its class's template shifted by up to two pixels with Gaussian pixel
    noise. The classes are separable; no PIL, no download."""
    rng = np.random.RandomState(seed)
    templates = (rng.rand(10, 28, 28) < 0.2) * 200.0
    for prefix, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        labels = rng.randint(0, 10, n)
        shifts = rng.randint(-2, 3, (n, 2))
        images = np.stack([np.roll(templates[c], tuple(d), axis=(0, 1))
                           for c, d in zip(labels, shifts)])
        images = np.clip(images + rng.randn(n, 28, 28) * 40.0, 0, 255)
        with open(os.path.join(out_dir, "%s-images-idx3-ubyte" % prefix),
                  "wb") as f:
            f.write(struct.pack(">IIII", 0x803, n, 28, 28))
            f.write(images.astype(np.uint8).tobytes())
        with open(os.path.join(out_dir, "%s-labels-idx1-ubyte" % prefix),
                  "wb") as f:
            f.write(struct.pack(">II", 0x801, n))
            f.write(labels.astype(np.uint8).tobytes())


def mnist_iter(mx, data_dir, split, net, batch, shuffle=True):
    return mx.io.MNISTIter(
        image=os.path.join(data_dir, "%s-images-idx3-ubyte" % split),
        label=os.path.join(data_dir, "%s-labels-idx1-ubyte" % split),
        batch_size=batch, flat=net == "mlp", shuffle=shuffle, seed=0)


def mnist_main_path(torch, mx, kernels, card):
    """The MLP and LeNet through FeedForward(fused_step=True) over
    MNISTIter batches of 128 for MNIST_EPOCHS epochs, launch counts zeroed
    just before each fit and read just after (LeNet: K3 three times a
    step, the weight gradients of both convolutions and conv2's input
    gradient; a replay runs no wrapper, so the wrappers count the eager
    step and the capture); losses fall, held-out accuracy reaches
    MNIST_MIN_ACC; two more replays under torch.profiler run K3 three
    times each for LeNet (kernel events); then three fused steps at batch
    2 on the card against the port on the CPU."""
    res = {}
    with tempfile.TemporaryDirectory() as data_dir:
        write_mnist_idx(data_dir)
        for net in ("mlp", "lenet"):
            losses = []

            def on_batch(param, losses=losses):
                probs = param.locals["self"].get_outputs()[0].handle
                lab = param.locals["data_batch"].label[0].handle.to(
                    probs.device, torch.int64)
                losses.append(-torch.log(probs.gather(1, lab[:, None]))
                              .mean())

            sym = getattr(mx.models, "get_" + net)()
            model = mx.model.FeedForward(
                sym, ctx=mx.gpu(0), num_epoch=MNIST_EPOCHS,
                learning_rate=0.1, momentum=0.9, wd=1e-4,
                initializer=mx.init.Xavier(magnitude=2.0, seed=3),
                fused_step=True)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            model.fit(mnist_iter(mx, data_dir, "train", net, MNIST_BATCH),
                      batch_end_callback=on_batch)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            step = model._module._fused_step
            steps = len(losses)
            losses = [float(v) for v in losses]
            acc = model.score(mnist_iter(mx, data_dir, "t10k", net,
                                         MNIST_BATCH, shuffle=False))
            head = float(np.mean(losses[:5]))
            tail = float(np.mean(losses[-5:]))
            print("mnist %s: %d fused steps of %d in %.2f s (eager %d, "
                  "captures %d, replays %d), launches %s, loss %.4f -> "
                  "%.4f (mean of the first and last 5), held-out accuracy "
                  "%.4f  [%s]" % (net, steps, MNIST_BATCH, fit_s,
                                  step.eager_steps, step.captures,
                                  step.dispatches, launches, head, tail, acc,
                                  card))
            check((step.eager_steps, step.captures, step.dispatches)
                  == (1, 1, steps - 1), "mnist %s fused counters" % net)
            gemms = 3 if net == "lenet" else 0
            want = {"norm_act_fwd": 0, "norm_act_bwd": 0,
                    "conv_gemm": 2 * gemms, "linear": 0, "flash_attn": 0}
            check(launches == dict(want, rtc=0), "mnist %s launches %s "
                  "(the eager step and the capture), want %s"
                  % (net, launches, want))
            batch = mnist_iter(mx, data_dir, "train", net,
                               MNIST_BATCH).next()
            metric = mx.metric.Accuracy()
            ran = _profile_steps(torch, kernels,
                                 lambda: step.step(batch, metric))
            want["conv_gemm"] = ran["steps"] * gemms
            print("mnist %s: launches the card ran in %d profiled replays "
                  "(kernel events): %s" % (net, ran["steps"],
                                           ran["launches"]))
            check(ran["launches"] == want, "mnist %s: the card ran %s in "
                  "%d profiled replays, want %s"
                  % (net, ran["launches"], ran["steps"], want))
            check(all(np.isfinite(losses)) and tail < 0.5 * head,
                  "mnist %s losses did not fall: %.4f -> %.4f"
                  % (net, head, tail))
            check(acc >= MNIST_MIN_ACC, "mnist %s held-out accuracy %.4f < "
                  "%.2f" % (net, acc, MNIST_MIN_ACC))
            res[net] = {"steps": steps, "fit_s": fit_s, "launches": launches,
                        "replays_profiled": ran["steps"],
                        "replay_launches": ran["launches"],
                        "loss_first5": head, "loss_last5": tail,
                        "heldout_accuracy": acc,
                        "gate": mnist_gate(mx, data_dir, net)}
    return res


def mnist_gate(mx, data_dir, net):
    """Three fused steps at batch 2 (eager, capture and replay on the
    card) against the port on the CPU from the same weights and data:
    per-step losses within rtol 1e-4, params within rtol 1e-3 / atol
    1e-5."""
    it = mnist_iter(mx, data_dir, "train", net, 6, shuffle=False)
    batch = it.next()
    x, y = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        losses = []

        def on_batch(param, losses=losses):
            probs = param.locals["self"].get_outputs()[0].asnumpy()
            lab = y[2 * param.nbatch:2 * param.nbatch + 2].astype(int)
            losses.append(-np.log(probs.astype(np.float64)[
                np.arange(2), lab]).mean())

        mod = mx.mod.Module(getattr(mx.models, "get_" + net)(), context=ctx)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=2), num_epoch=1,
                initializer=mx.init.Xavier(magnitude=2.0, seed=5),
                optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)),
                batch_end_callback=on_batch, fused_step=True)
        res.append((losses, _host(mod.get_params()[0]), mod._fused_step))
    (lg, pg, sg), (lc, pc, _) = res
    check((sg.eager_steps, sg.captures, sg.dispatches) == (1, 1, 2),
          "mnist gate: fused counters on the card")
    worst = max((float(np.max(np.abs(pg[k] - pc[k])
                              - 1e-3 * np.abs(pc[k]))), k) for k in pc)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    print("mnist %s gate (3 fused steps of 2, card vs CPU): losses %s vs "
          "%s, params worst excess over rtol 1e-3 %.3g (atol 1e-5) at %s"
          % (net, ["%.6f" % v for v in lg], ["%.6f" % v for v in lc],
             worst[0], worst[1]))
    check(loss_err <= 1e-4, "mnist %s losses on the card %s, on the CPU %s"
          % (net, lg, lc))
    check(worst[0] <= 1e-5, "mnist %s param %s differs beyond rtol 1e-3 / "
          "atol 1e-5" % (net, worst[1]))
    return {"losses_card": lg, "losses_cpu": lc, "worst_param": worst[1],
            "worst_excess": worst[0]}


def ckpt_fit(torch, mx, images, labels, after_batch=None):
    """Module.fit(fused_step=True) over one epoch of the batches of
    ``images`` from train_module's seed-0 weights, MXNET_TPU_CKPT_* as the
    environment has them. Per step: the loss of the forward's
    probabilities and the host clock at the batch-end callback with the
    card synchronised; then ``after_batch(param, mod)``."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = torch.from_numpy(labels[param.nbatch * BATCH:
                                      (param.nbatch + 1) * BATCH]).to(
            probs.device, torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if after_batch is not None:
            after_batch(param, mod)

    torch.cuda.synchronize()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
            num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
            eval_metric=mx.metric.Accuracy(), batch_end_callback=on_batch,
            fused_step=True)
    args, aux = (_host(p) for p in mod.get_params())
    return {"mod": mod, "losses": [float(v) for v in losses],
            "steps_ms": [1e3 * (b - a) for a, b in zip(marks, marks[1:])],
            "args": args, "aux": aux}


def _check_params_equal(what, got, want):
    for name in ("args", "aux"):
        unequal = [k for k in want[name]
                   if not np.array_equal(got[name][k], want[name][k])]
        check(not unequal, "%s: %s differ at %s" % (what, name, unequal[:5]))


def _keep_only_step(ckpt, directory, step):
    """Trim the store's manifest to the snapshot of ``step``: a resume
    from a mid-run save, as after a preemption there."""
    store = ckpt.SnapshotStore(directory)
    man = store._read_manifest()
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == step]
    check(len(man["snapshots"]) == 1, "no snapshot of step %d" % step)
    ckpt.atomic_write_bytes(store._manifest_path(),
                            json.dumps(man).encode())


def checkpoint_main_path(torch, mx, kernels, card):
    """Phase 8 on ResNet-50 NHWC at batch 32 through the fused step:
    (a) an uninterrupted fit of CKPT_STEPS batches; (b) the same with a
    snapshot every CKPT_EVERY steps, losses bit-equal; (c) a fresh module
    resumed from the step-3 snapshot, the rest bit-equal, one capture,
    launch counts zeroed just before and read just after; (d) batches
    b0-b3 then b3 again after a rollback to the step-3 snapshot into the
    live graph; (e) Module.save_checkpoint files loaded on the CPU; (f) a
    child trained on the card and ended by SIGTERM, then resumed."""
    from mxnet_tpu_torch import checkpoint as ckpt

    tel = mx.telemetry
    images, labels = train_data(CKPT_STEPS)
    four = {}

    def keep_four(param, mod):
        if param.nbatch == 3:
            four["args"], four["aux"] = (_host(p) for p in mod.get_params())

    a = ckpt_fit(torch, mx, images, labels, keep_four)
    check(len(a["losses"]) == CKPT_STEPS and all(np.isfinite(a["losses"])),
          "checkpoint (a): losses %s" % a["losses"])
    res = {"losses": a["losses"]}
    env = ("MXNET_TPU_CKPT_DIR", "MXNET_TPU_CKPT_EVERY_N_STEPS",
           "MXNET_TPU_CKPT_RESUME")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tel.reset()
        tel.enable()
        # (b) the cadence: saving perturbs nothing
        os.environ.update({env[0]: os.path.join(tmp, "b"),
                           env[1]: str(CKPT_EVERY), env[2]: "0"})
        b = ckpt_fit(torch, mx, images, labels)
        check(b["losses"] == a["losses"], "checkpoint (b): losses with "
              "snapshots %s, without %s" % (b["losses"], a["losses"]))
        _check_params_equal("checkpoint (b)", b, a)
        saves = tel.peek("ckpt.saves")
        check(saves == CKPT_STEPS // CKPT_EVERY, "checkpoint (b): %s saves"
              % saves)
        snap = tel.snapshot()["ckpt"]
        saving = [b["steps_ms"][i - 2] for i in range(CKPT_EVERY,
                                                      CKPT_STEPS + 1,
                                                      CKPT_EVERY)]
        plain = [v for i, v in enumerate(b["steps_ms"])
                 if i > 0 and (i + 2) % CKPT_EVERY]
        res["cadence"] = {
            "saves": saves, "bytes": snap["bytes"],
            "snapshot_mb": snap["bytes"] / saves / 1e6,
            "save_ms": snap["save_ms"], "capture_ms": snap["snapshot_ms"],
            "save_ms_median": float(np.median([snap["save_ms"]["min"],
                                               snap["save_ms"]["max"]])),
            "saving_step_ms": saving, "other_step_ms": plain,
            "other_step_ms_median": float(np.median(plain)),
            "steps_ms": b["steps_ms"], "uninterrupted_steps_ms":
                a["steps_ms"]}
        cad = res["cadence"]
        print("checkpoint (b) cadence every %d steps: losses bit-equal to "
              "the uninterrupted run; ckpt.saves %d, ckpt.bytes %d (%.1f MB "
              "a snapshot), ckpt.save_ms median %.1f (min %.1f, max %.1f; "
              "serialise, hash, write), capture (device fetch and param "
              "digests) %.1f ms a save; host "
              "step of the saving steps %s ms against the median of the "
              "other replays %.3f ms  [%s]"
              % (CKPT_EVERY, saves, snap["bytes"], cad["snapshot_mb"],
                 cad["save_ms_median"], snap["save_ms"]["min"],
                 snap["save_ms"]["max"],
                 snap["snapshot_ms"]["sum"] / snap["snapshot_ms"]["count"],
                 ["%.3f" % v for v in saving], cad["other_step_ms_median"],
                 card))
        # (c) a fresh module resumes from the step-3 snapshot
        _keep_only_step(ckpt, os.path.join(tmp, "b"), CKPT_EVERY)
        os.environ.update({env[1]: "0", env[2]: "1"})
        tel.reset()
        kernels.reset_launch_counts()
        c = ckpt_fit(torch, mx, images, labels)
        launches = kernels.launch_counts()
        step = c["mod"]._fused_step
        counters = (step.eager_steps, step.captures, step.dispatches)
        restore_ms = tel.peek("ckpt.restore_ms", "hist_sum")
        print("checkpoint (c) resume from step %d: ckpt.restores %s, "
              "restore %.1f ms (read, check, unpickle, copy in), losses %s, "
              "step counters (eager, captures, replays) %s, launches %s  "
              "[%s]" % (CKPT_EVERY, tel.peek("ckpt.restores"), restore_ms,
                        ["%.4f" % v for v in c["losses"]], counters,
                        launches, card))
        check(tel.peek("ckpt.restores") == 1, "checkpoint (c): restores")
        check(c["losses"] == a["losses"][CKPT_EVERY:], "checkpoint (c): "
              "resumed losses %s, uninterrupted %s"
              % (c["losses"], a["losses"][CKPT_EVERY:]))
        _check_params_equal("checkpoint (c)", c, a)
        check(counters == (1, 1, CKPT_STEPS - CKPT_EVERY - 1),
              "checkpoint (c): step counters %s" % (counters,))
        want = dict(_resnet_launches(2), rtc=0)
        check(launches == want, "checkpoint (c): launches %s, want %s (the "
              "eager step and the capture)" % (launches, want))
        res["resume"] = {"restore_ms": restore_ms, "losses": c["losses"],
                         "counters": counters, "launches": launches}
        # (d) a rollback into the live graph
        os.environ.update({env[0]: os.path.join(tmp, "d"),
                           env[1]: str(CKPT_EVERY), env[2]: "0"})
        ims = np.concatenate([images[:4 * BATCH],
                              images[3 * BATCH:4 * BATCH]])
        labs = np.concatenate([labels[:4 * BATCH],
                               labels[3 * BATCH:4 * BATCH]])
        rolled = {}

        def roll_back(param, mod):
            if param.nbatch == 3:
                rolled["info"] = param.locals["ckpt"].rollback()

        d = ckpt_fit(torch, mx, ims, labs, roll_back)
        step = d["mod"]._fused_step
        counters = (step.eager_steps, step.captures, step.dispatches)
        print("checkpoint (d) rollback to step %s after b3, then b3 again: "
              "losses %s, step counters %s  [%s]"
              % (rolled.get("info", {}).get("step"),
                 ["%.4f" % v for v in d["losses"]], counters, card))
        check(rolled.get("info", {}).get("step") == CKPT_EVERY,
              "checkpoint (d): rollback %s" % rolled)
        check(d["losses"][:4] == a["losses"][:4]
              and d["losses"][4] == a["losses"][3],
              "checkpoint (d): losses %s, want %s then %r"
              % (d["losses"], a["losses"][:4], a["losses"][3]))
        _check_params_equal("checkpoint (d)", d, four)
        check(counters == (1, 1, 4), "checkpoint (d): step counters %s"
              % (counters,))
        res["rollback"] = {"losses": d["losses"], "counters": counters}
        res["files"] = checkpoint_files(mx, c["mod"], tmp)
    finally:
        for k in env:
            os.environ.pop(k, None)
        tel.disable()
        tel.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    res["sigterm"] = checkpoint_sigterm(card)
    print("checkpoint phase, ResNet-50 NHWC batch 32 f32, fused step: "
          "snapshot %.1f MB, save %.1f ms (median of %d; capture "
          "%.1f ms more), restore %.1f ms, saving step %.3f ms against "
          "the median step %.3f ms  [%s]"
          % (res["cadence"]["snapshot_mb"], res["cadence"]["save_ms_median"],
             res["cadence"]["saves"],
             res["cadence"]["capture_ms"]["sum"]
             / res["cadence"]["capture_ms"]["count"],
             res["resume"]["restore_ms"], res["cadence"]["saving_step_ms"][0],
             res["cadence"]["other_step_ms_median"], card))
    return res


def checkpoint_files(mx, mod, tmp):
    """(e): save_checkpoint with the optimizer states on the card, loaded
    into a Module on the CPU; params and momenta bit-equal."""
    prefix = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    save_s = time.perf_counter() - t0
    cpu = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                             context=mx.cpu())
    cpu.bind(data_shapes=[("data", (1,) + IMAGE)],
             label_shapes=[("softmax_label", (1,))])
    cpu.init_optimizer(optimizer_params=TRAIN_OPT)
    cpu.load_optimizer_states(prefix + "-0001.states")
    want = dict(zip(("args", "aux"), (_host(p) for p in mod.get_params())))
    got = dict(zip(("args", "aux"), (_host(p) for p in cpu.get_params())))
    _check_params_equal("checkpoint (e) files on the CPU", got, want)
    states = mod._updater.states
    unequal = [i for i, s in states.items()
               if not np.array_equal(cpu._updater.states[i].asnumpy(),
                                     s.asnumpy())]
    check(sorted(cpu._updater.states) == sorted(states) and not unequal,
          "checkpoint (e): momenta differ at %s" % unequal[:5])
    sizes = {ext: os.path.getsize("%s-0001.%s" % (prefix, ext))
             for ext in ("params", "states")}
    print("checkpoint (e) files: save_checkpoint with optimizer states in "
          "%.2f s (%s bytes), loaded by a Module on the CPU: params and %d "
          "momenta bit-equal" % (save_s, sizes, len(states)))
    return {"save_s": save_s, "bytes": sizes, "momenta": len(states)}


def checkpoint_sigterm(card):
    """(f): a child trains the MNIST MLP on the card through
    fit(fused_step=True) with MXNET_TPU_CKPT_DIR set and sends itself
    SIGTERM after step CKPT_DIE_AT: it must end by the signal with a
    "preempt" snapshot of that step; a second child resumes from it and
    runs the epoch to its end."""
    import signal

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sigterm_")
    try:
        write_mnist_idx(tmp)
        snaps = os.path.join(tmp, "snaps")
        env = dict(os.environ, MXNET_TPU_CKPT_DIR=snaps,
                   MXNET_TPU_CKPT_EVERY_N_STEPS="0",
                   MXNET_TPU_CRASH_DIR=os.path.join(tmp, "crash"),
                   CKPT_CHILD_DIE_AT=str(CKPT_DIE_AT))
        cmd = [sys.executable, os.path.abspath(__file__), "--ckpt-child",
               tmp]
        runs = []
        for die in (True, False):
            if not die:
                env.pop("CKPT_CHILD_DIE_AT")
            t0 = time.perf_counter()
            try:
                r = subprocess.run(cmd, env=env, capture_output=True,
                                   text=True, timeout=CKPT_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                check(False, "checkpoint (f): the child ran past %d s"
                      % CKPT_CHILD_TIMEOUT_S)
            runs.append((r, time.perf_counter() - t0))
            with open(os.path.join(snaps, "MANIFEST.json")) as f:
                last = json.load(f)["snapshots"][-1]
            if die:
                check(r.returncode == -signal.SIGTERM, "checkpoint (f): the "
                      "child ended with %s, not by SIGTERM: %s"
                      % (r.returncode, r.stderr[-2000:]))
                check(last["reason"] == "preempt"
                      and last["step"] == CKPT_DIE_AT, "checkpoint (f): "
                      "newest snapshot %s" % last)
                preempt = last
        r = runs[-1][0]
        check(r.returncode == 0, "checkpoint (f): the resumed child ended "
              "with %s: %s" % (r.returncode, r.stderr[-2000:]))
        with open(os.path.join(tmp, "stream.txt")) as f:
            seen = [tuple(map(int, line.split()[:2])) for line in f]
        batches = MNIST_TRAIN // MNIST_BATCH
        check(seen == [(0, i) for i in range(CKPT_DIE_AT)]
              + [(0, i) for i in range(CKPT_DIE_AT, batches)],
              "checkpoint (f): the steps the two children ran: %s" % seen)
        check(os.path.exists(os.path.join(tmp, "completed")),
              "checkpoint (f): the resumed child did not finish")
        print("checkpoint (f) SIGTERM: the child ended by the signal (rc %d) "
              "after step %d with a \"%s\" snapshot of step %d (%d bytes); "
              "a second child resumed and ran steps %d-%d; %.1f s and %.1f s "
              "of wall time  [%s]"
              % (runs[0][0].returncode, CKPT_DIE_AT, preempt["reason"],
                 preempt["step"], preempt["bytes"], CKPT_DIE_AT + 1,
                 batches, runs[0][1], runs[1][1], card))
        return {"rc": runs[0][0].returncode, "snapshot": preempt,
                "wall_s": [t for _, t in runs]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ckpt_child(data_dir):
    """The SIGTERM phase's child: the MNIST MLP on the card through
    Module.fit(fused_step=True) over MNISTIter for one epoch, the
    checkpoint manager armed by MXNET_TPU_CKPT_*; each step appends
    ``epoch nbatch`` to ``stream.txt``; with CKPT_CHILD_DIE_AT it sends
    itself SIGTERM after that step; at the end it writes ``completed``."""
    import signal

    import mxnet_tpu_torch as mx

    die_at = int(os.environ.get("CKPT_CHILD_DIE_AT", "0"))
    steps = [0]

    def on_batch(param):
        steps[0] += 1
        with open(os.path.join(data_dir, "stream.txt"), "a") as f:
            f.write("%d %d\n" % (param.epoch, param.nbatch))
        if steps[0] == die_at:
            os.kill(os.getpid(), signal.SIGTERM)

    mod = mx.mod.Module(mx.models.get_mlp(), context=mx.gpu(0))
    mod.fit(mnist_iter(mx, data_dir, "train", "mlp", MNIST_BATCH),
            num_epoch=1, initializer=mx.init.Xavier(magnitude=2.0, seed=3),
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            batch_end_callback=on_batch, fused_step=True)
    with open(os.path.join(data_dir, "completed"), "w") as f:
        f.write("ok")
    return 0


# ---------------------------------------------------------------------------
# phase 9: fit's health and input plane through the fused step
# ---------------------------------------------------------------------------

PLANE_STEPS = 9                # batches of 32 a phase-9 fit
PLANE_WINDOW = (2, 6)          # timed: the steps after batch 2 to batch 6;
#                                profiled: the last two (batches 7 and 8)
PLANE_ENV = ("MXNET_TPU_DEVICE_STAGING", "MXNET_TPU_FEED_DEPTH",
             "MXNET_TPU_NUMWATCH", "MXNET_TPU_NUMWATCH_EVERY_N",
             "MXNET_TPU_NUMWATCH_GUARD", "MXNET_TPU_CKPT_DIR",
             "MXNET_TPU_METRICS_PORT", "MXNET_TPU_FLIGHT_RECORDER",
             "MXNET_TPU_CRASH_DIR")


def plane_fit(torch, mx, kernels, images, labels, env, sync=True,
              after_batch=None, monitor=None, profile=True):
    """One fit(fused_step=True) of ResNet-50 NHWC at batch 32 from
    train_module's seed-0 weights over the batches of ``images``, with
    ``env`` set for the fit and telemetry on; launch counts zeroed just
    before and read just after. ``sync``: the batch-end callback
    synchronises the card every batch; otherwise only at the timing
    window's ends. Measured: the window's wall ms a step, the host ms a
    step spent copying batches in on the training thread (the executor
    group's load_data_batch, plus device staging's ``_stage`` where it
    runs on this thread), io.feed_stall_ms a step, and the device's busy
    share over the last two steps under torch.profiler (started after
    the timing window, stopped at the last batch-end callback after a
    synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    tel = mx.telemetry
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    group = mod._exec_group
    load = group.load_data_batch
    copy_in = []

    def timed_load(batch):
        t0 = time.perf_counter()
        load(batch)
        copy_in.append(time.perf_counter() - t0)

    group.load_data_batch = timed_load
    losses, marks, window = [], [], {}
    prof = tprofile(activities=[ProfilerActivity.CUDA]) if profile else None
    n = len(labels) // BATCH
    # on the card before the fit: a pageable upload in the callback would
    # wait for the card, a synchronise in disguise
    lab_all = torch.from_numpy(labels).to(torch.device("cuda", 0),
                                          torch.int64)

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = lab_all[param.nbatch * BATCH:(param.nbatch + 1) * BATCH]
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        if sync or param.nbatch in PLANE_WINDOW:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if param.nbatch in PLANE_WINDOW:
            window[param.nbatch] = (
                marks[-1], tel.peek("io.feed_stall_ms", "hist_sum") or 0.0,
                tel.peek("io.staging.h2d_ms", "hist_sum") or 0.0,
                len(copy_in))
        if after_batch is not None:
            after_batch(param, mod)
        if prof is not None and param.nbatch == n - 3:
            torch.cuda.synchronize()
            window["prof_t0"] = time.perf_counter()
            prof.start()
        if prof is not None and param.nbatch == n - 1:
            torch.cuda.synchronize()
            window["prof_wall"] = time.perf_counter() - window["prof_t0"]
            prof.stop()

    saved = {k: os.environ.get(k) for k in PLANE_ENV}
    os.environ.update(env)
    mx.tracing.shutdown()   # a fresh step ring, server and recorder a fit
    tel.reset()
    tel.enable()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
                num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
                eval_metric=mx.metric.Accuracy(), batch_end_callback=on_batch,
                fused_step=True, monitor=monitor)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        busy = None
        if prof is not None:
            busy_us = sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA)
            busy = busy_us / 1e6 / window["prof_wall"]
        snap = tel.snapshot()
        records = mx.tracing.step_trace().records()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tel.disable()
    steps = PLANE_WINDOW[1] - PLANE_WINDOW[0]
    # a fit shorter than the window times nothing
    a, b = (window.get(PLANE_WINDOW[0]),
            window.get(PLANE_WINDOW[1], window.get(PLANE_WINDOW[0])))
    # device staging stages on this thread; a feed scheduler on its worker
    staged_here = env.get("MXNET_TPU_FEED_DEPTH", "0") == "0"
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(counters == (1, 1, n - 1), "plane fit %s: step counters %s" %
          (env, counters))
    want = dict(_resnet_launches(2), rtc=0)
    check(launches == want, "plane fit %s: launches %s, want %s (the eager "
          "step and the capture)" % (env, launches, want))
    losses = [float(v) for v in losses]
    args, aux = (_host(p) for p in mod.get_params())
    return {
        "mod": mod, "losses": losses, "args": args, "aux": aux,
        "launches": launches, "counters": counters, "snapshot": snap,
        "records": records,
        "wall_ms_per_step": 1e3 * (b[0] - a[0]) / steps,
        "host_step_ms_median": 1e3 * float(np.median(np.diff(marks))),
        "copy_in_ms_per_step": 1e3 * sum(copy_in[a[3]:b[3]]) / steps
        + ((b[2] - a[2]) / steps if staged_here else 0.0),
        "feed_stall_ms_per_step": (b[1] - a[1]) / steps,
        "busy_share": busy}


def _drop(run):
    """Free a fit's module on the card before the next one."""
    import gc

    run.pop("mod", None)
    gc.collect()


def _replay_device_ms(torch, mx, kernels, step, images, labels, reps=10):
    """Device ms a step by CUDA events over ``reps`` back-to-back calls of
    the captured step, and the kernel events a replay under
    torch.profiler (two replays)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    metric = step._fold or mx.metric.Accuracy()
    step.step(batch, metric)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        step.step(batch, metric)
    end.record()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step.step(batch, metric)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (start.elapsed_time(end) / reps, len(names) / 2,
            kernels.launches_in(names))


def plane_main_path(torch, mx, kernels, card):
    """Phase 9 on ResNet-50 NHWC at batch 32 through fit(fused_step=True):
    (1) plain, device staging and feed depth 2, each with and without a
    synchronising batch-end callback, params bit-equal; (2) the numerics
    plane at EVERY_N=1 against unarmed (params bit-equal, one capture,
    launches unchanged, device ms and kernel events a replay, fetch ms,
    the pack against a recomputation on the card), with device staging,
    the metrics server and the flight recorder armed, /metrics and
    /healthz fetched over loopback, the step ring checked and a
    FlightRecorder dump; (3) the skip guard across a NaN batch; (4) the
    rollback guard into the live graph; (5) a default Monitor's rows."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    images, labels = train_data(PLANE_STEPS)
    res = {"configs": {}}
    base = None
    # the profiler's first start sets up its tracing: not in a window
    with tprofile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    # (1) staging and the feed scheduler, with and without a sync callback
    for name, env in (("plain", {}),
                      ("staging", {"MXNET_TPU_DEVICE_STAGING": "1"}),
                      ("feed_depth_2", {"MXNET_TPU_FEED_DEPTH": "2"})):
        for sync in (True, False):
            run = plane_fit(torch, mx, kernels, images, labels, env, sync)
            key = "%s_%s" % (name, "sync" if sync else "nosync")
            if base is None:
                base = run
            else:
                _check_params_equal("plane (1) %s" % key, run, base)
                check(run["losses"] == base["losses"], "plane (1) %s: "
                      "losses %s, plain %s" % (key, run["losses"],
                                               base["losses"]))
            res["configs"][key] = {k: run[k] for k in (
                "wall_ms_per_step", "host_step_ms_median",
                "copy_in_ms_per_step", "feed_stall_ms_per_step",
                "busy_share", "launches")}
            c = res["configs"][key]
            print("plane (1) %-22s wall %.3f ms a step (host step median "
                  "%.3f), copy-in on the training thread %.3f ms a step, "
                  "io.feed_stall_ms %.3f a step, busy %.1f%%  [%s]"
                  % (key, c["wall_ms_per_step"], c["host_step_ms_median"],
                     c["copy_in_ms_per_step"], c["feed_stall_ms_per_step"],
                     100 * c["busy_share"], card))
            if run is not base:
                _drop(run)
    print("plane (1): staging and feed depth 2 leave params, moving "
          "statistics and losses bit-equal to the plain fit")
    # (2) the numerics plane at EVERY_N=1 against unarmed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plane_")
    recomputed = {}

    def recompute(param, mod):
        # after the timing window: the recomputation syncs per parameter
        ex = mod._exec_group.executor
        plane = param.locals["numwatch"]
        if param.nbatch == PLANE_STEPS - 2:
            recomputed["w"] = [ex.arg_dict[n].handle.double().clone()
                               for n in plane.names]
        if param.nbatch == PLANE_STEPS - 1:
            worst = 0.0
            body = plane._last_body
            for i, name in enumerate(plane.names):
                g = ex.grad_dict[name].handle.double()
                w_old = recomputed["w"][i]
                upd = ex.arg_dict[name].handle.double() - w_old
                want = [float(g.norm()), float(g.abs().max()),
                        float(upd.norm() / w_old.norm())]
                got = [float(np.sqrt(body[i, 0])), float(body[i, 1]),
                       float(np.sqrt(body[i, 6] / body[i, 4]))]
                for gv, wv in zip(got, want):
                    worst = max(worst, abs(gv - wv) / max(abs(wv), 1e-30))
            recomputed["worst_rel"] = worst
            recomputed["names"] = len(plane.names)

    armed_env = {"MXNET_TPU_NUMWATCH": "1", "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                 "MXNET_TPU_DEVICE_STAGING": "1",
                 "MXNET_TPU_METRICS_PORT": "0",
                 "MXNET_TPU_FLIGHT_RECORDER": "1",
                 "MXNET_TPU_CRASH_DIR": os.path.join(tmp, "crash")}
    try:
        armed = plane_fit(torch, mx, kernels, images, labels, armed_env,
                          after_batch=recompute, profile=False)
        _check_params_equal("plane (2) numwatch armed", armed, base)
        check(armed["losses"] == base["losses"], "plane (2): losses")
        check(recomputed.get("worst_rel", 1.0) <= 1e-5, "plane (2): the "
              "pack's grad l2, max-abs and update/weight ratio against the "
              "recomputation: worst rel err %s" % recomputed.get("worst_rel"))
        step = armed["mod"]._fused_step
        plane = step._numwatch
        fetch = []
        for _ in range(5):
            t0 = time.perf_counter()
            plane.fetch()
            fetch.append(1e3 * (time.perf_counter() - t0))
        # unarmed, armed, unarmed, armed, unarmed, armed in one process
        timed = {False: [], True: []}
        for _ in range(3):
            for is_armed, st in ((False, base["mod"]._fused_step),
                                 (True, step)):
                timed[is_armed].append(_replay_device_ms(
                    torch, mx, kernels, st, images, labels))
        u_ms, u_events, u_launch = (
            float(np.median([t[0] for t in timed[False]])),
            timed[False][0][1], timed[False][0][2])
        a_ms, a_events, a_launch = (
            float(np.median([t[0] for t in timed[True]])),
            timed[True][0][1], timed[True][0][2])
        _drop(base)
        check(a_launch == u_launch, "plane (2): kernel events of the "
              "compiled kernels a replay %s armed, %s unarmed"
              % (a_launch, u_launch))
        res["numwatch"] = {
            "unarmed_device_ms": u_ms, "armed_device_ms": a_ms,
            "device_ms_runs": {"unarmed": [t[0] for t in timed[False]],
                               "armed": [t[0] for t in timed[True]]},
            "unarmed_kernel_events": u_events,
            "armed_kernel_events": a_events,
            "fetch_ms_median": float(np.median(fetch)),
            "pack_worst_rel_err": recomputed["worst_rel"],
            "params": recomputed["names"],
            "wall_ms_per_step": armed["wall_ms_per_step"],
            "unarmed_wall_ms_per_step":
                res["configs"]["staging_sync"]["wall_ms_per_step"],
            "launches": armed["launches"]}
        nw = res["numwatch"]
        print("plane (2) numwatch EVERY_N=1: params bit-equal to unarmed, "
              "captures 1, launches %s; device %.3f ms a step armed against "
              "%.3f unarmed (+%.1f%%; medians of 3 interleaved runs of 10 "
              "replays), kernel events a replay %d against "
              "%d, fetch %.3f ms, pack vs recomputation over %d params "
              "worst rel err %.3g (bound 1e-5); wall a step with staging "
              "%.3f against %.3f ms unarmed  [%s]"
              % (armed["launches"], a_ms, u_ms, 100 * (a_ms / u_ms - 1),
                 a_events, u_events, nw["fetch_ms_median"], nw["params"],
                 nw["pack_worst_rel_err"], nw["wall_ms_per_step"],
                 nw["unarmed_wall_ms_per_step"], card))
        res["server"] = plane_server_checks(mx, armed)
        res["flight"] = plane_flight_dump(mx, tmp)
        _drop(armed)
        res["skip"] = plane_skip_guard(torch, mx, kernels, images, labels,
                                       card)
        res["rollback"] = plane_rollback_guard(torch, mx, kernels, images,
                                               labels, tmp, card)
        res["monitor"] = plane_monitor(torch, mx, kernels, images, labels,
                                       card)
    finally:
        mx.tracing.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def plane_server_checks(mx, armed):
    """(2) cont.: /metrics and /healthz over loopback while the metrics
    server from MXNET_TPU_METRICS_PORT=0 runs; the step ring."""
    import urllib.request

    server = mx.tracing.metrics_server()
    check(server is not None, "plane (2): no metrics server")
    url = "http://127.0.0.1:%d" % server.port
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        health = json.loads(r.read().decode())
    names = {line.split("{")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    for want in ("mxnet_tpu_step_dispatches", "mxnet_tpu_numwatch_fetches",
                 "mxnet_tpu_numwatch_grad_norm",
                 "mxnet_tpu_io_staging_batches",
                 "mxnet_tpu_io_staging_h2d_ms_count"):
        check(want in names, "plane (2): /metrics lacks %s" % want)
    recs = armed["records"]
    check(len(recs) == PLANE_STEPS and [r["nbatch"] for r in recs]
          == list(range(PLANE_STEPS)), "plane (2): step ring %s"
          % [r.get("nbatch") for r in recs])
    labels = [r["dominant"] for r in recs]
    check(labels[1] == "recompile" and "recompile" not in labels[2:],
          "plane (2): dominant labels %s (the capturing step is the "
          "second)" % labels)
    check(health["status"] == "ok" and health["steps"] == PLANE_STEPS,
          "plane (2): /healthz %s" % health)
    print("plane (2) metrics server :%d: /metrics %d samples with "
          "step.dispatches, numwatch.*, io.staging.*; /healthz %s; step "
          "ring %d records, "
          "dominant %s" % (server.port, len(names), health, len(recs),
                           labels))
    return {"samples": len(names), "healthz": health, "dominant": labels}


def plane_flight_dump(mx, tmp):
    d = mx.tracing.flight_recorder().dump("chip_smoke")
    check(d is not None, "plane (2): the flight recorder did not dump")
    files = sorted(os.listdir(d))
    for want in ("steps.jsonl", "numwatch.jsonl", "meta.json"):
        check(want in files, "plane (2): dump lacks %s: %s" % (want, files))
    with open(os.path.join(d, "steps.jsonl")) as f:
        steps = sum(1 for _ in f)
    with open(os.path.join(d, "numwatch.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    check(steps == PLANE_STEPS and meta["steps_recorded"] == PLANE_STEPS
          and rows and rows[-1]["nonfinite"] == 0,
          "plane (2): dump steps %d, meta %s, rows %d"
          % (steps, meta.get("steps_recorded"), len(rows)))
    print("plane (2) flight recorder dump: %s; steps.jsonl %d records, "
          "numwatch.jsonl %d rows" % (files, steps, len(rows)))
    return {"files": files, "steps": steps, "numwatch_rows": len(rows)}


def plane_skip_guard(torch, mx, kernels, images, labels, card):
    """(3): GUARD=skip, batch 3 all NaN: the weights, momenta and metric
    sums after it bit-identical to before it; one skip; one capture."""
    ims = images.copy()
    ims[3 * BATCH:4 * BATCH] = np.nan
    kept = {}

    def keep(param, mod):
        ex = mod._exec_group.executor
        state = ([ex.arg_dict[n].handle.clone() for n in mod._param_names]
                 + [s.handle.clone() for s in mod._updater.states.values()]
                 + [param.eval_metric._acc.clone()])
        if param.nbatch == 2:
            kept["before"] = state
        if param.nbatch == 3:
            kept["same"] = all(torch.equal(a, b) for a, b in
                               zip(state, kept["before"]))
            kept["skips"] = mx.telemetry.peek("numwatch.skipped_steps")

    run = plane_fit(torch, mx, kernels, ims, labels,
                    {"MXNET_TPU_NUMWATCH": "1",
                     "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                     "MXNET_TPU_NUMWATCH_GUARD": "skip"},
                    after_batch=keep, profile=False)
    check(kept.get("same"), "plane (3): the state moved across the NaN "
          "batch")
    check(kept.get("skips") == 1, "plane (3): numwatch.skipped_steps %s"
          % kept.get("skips"))
    check(all(np.isfinite(run["losses"][4:])), "plane (3): losses after "
          "the skip %s" % run["losses"])
    print("plane (3) skip guard: weights, momenta and metric sums "
          "bit-identical across the NaN batch, numwatch.skipped_steps 1, "
          "captures 1, launches %s, losses after %s  [%s]"
          % (run["launches"], ["%.4f" % v for v in run["losses"][4:]],
             card))
    _drop(run)
    return {"skips": 1, "launches": run["launches"]}


def plane_rollback_guard(torch, mx, kernels, images, labels, tmp, card):
    """(4): GUARD=rollback with MXNET_TPU_CKPT_DIR: a weight poisoned with
    NaN in place after batch 1; the next fetch names it (kind "param")
    and rolls back into the live graph (the same storage, one capture);
    the following steps have finite losses."""
    seen = {}

    def poison(param, mod):
        plane = param.locals["numwatch"]
        ex = mod._exec_group.executor
        if param.nbatch == 1:
            seen["ptrs"] = [a.handle.data_ptr() for a in ex.arg_arrays]
            ex.arg_dict["fc1_weight"].handle.fill_(float("nan"))
            rollback = plane._rollback

            def spy(extras):
                seen["prov"] = plane.provenance()
                t0 = time.perf_counter()
                rollback(extras)
                seen["ms"] = 1e3 * (time.perf_counter() - t0)
            plane._rollback = spy
        if param.nbatch == 2:
            seen["rollbacks"] = mx.telemetry.peek("numwatch.rollbacks")
            seen["same"] = seen["ptrs"] == [a.handle.data_ptr()
                                            for a in ex.arg_arrays]

    run = plane_fit(torch, mx, kernels, images[:5 * BATCH],
                    labels[:5 * BATCH],
                    {"MXNET_TPU_NUMWATCH": "1",
                     "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                     "MXNET_TPU_NUMWATCH_GUARD": "rollback",
                     "MXNET_TPU_CKPT_DIR": os.path.join(tmp, "ckpt")},
                    after_batch=poison, profile=False)
    check(seen.get("prov") == ("fc1_weight", "param", 3),
          "plane (4): provenance %s" % (seen.get("prov"),))
    check(seen.get("rollbacks") == 1 and seen.get("same"),
          "plane (4): rollbacks %s, storage unchanged %s"
          % (seen.get("rollbacks"), seen.get("same")))
    check(all(np.isfinite(run["losses"][3:])), "plane (4): losses after "
          "the rollback %s" % run["losses"])
    saves = run["snapshot"]["ckpt"]["saves"]
    print("plane (4) rollback guard: provenance %s, numwatch.rollbacks 1, "
          "rollback %.1f ms, storage unchanged, captures 1, losses after "
          "%s, healthy saves %d (%.1f ms median)  [%s]"
          % (seen["prov"], seen["ms"],
             ["%.4f" % v for v in run["losses"][3:]], saves,
             run["snapshot"]["ckpt"]["save_ms"]["p50"], card))
    _drop(run)
    return {"provenance": list(seen["prov"]), "rollback_ms": seen["ms"],
            "healthy_saves": saves, "launches": run["launches"],
            "save_ms_p50": run["snapshot"]["ckpt"]["save_ms"]["p50"]}


def plane_monitor(torch, mx, kernels, images, labels, card):
    """(5): a default Monitor through the fused step (it arms the plane
    by itself): at batch 4 its rows equal norm(x)/sqrt(size) of the
    weights before that step's update and of its gradients, recomputed
    on the card."""
    got = {}

    class Keeping(mx.monitor.Monitor):
        def toc_print(self):
            got[self.step] = self.toc()

    mon = Keeping(interval=1)
    pre = {}

    def recompute(param, mod):
        ex = mod._exec_group.executor
        if param.nbatch == 3:
            pre.update({n: a.handle.double().clone()
                        for n, a in ex.arg_dict.items()})
        if param.nbatch == 4:
            pre["grads"] = {n: g.handle.double().clone()
                            for n, g in ex.grad_dict.items()}

    run = plane_fit(torch, mx, kernels, images[:5 * BATCH],
                    labels[:5 * BATCH], {}, after_batch=recompute,
                    monitor=mon, profile=False)
    rows = got[5]
    worst = 0.0
    for _, name, stat in rows:
        t = (pre["grads"][name[:-5]] if name.endswith("_grad")
             else pre[name])
        want = float(t.norm() / t.numel() ** 0.5)
        # the row prints 6 decimals: half a unit of the last, and rtol 1e-5
        worst = max(worst, abs(float(stat) - want) / (5e-7 + 1e-5 * want))
    n_params = len(pre["grads"])
    check(len(rows) == 2 * n_params and worst <= 1.0, "plane (5): %d rows "
          "for %d params, worst error %g of the bound against the "
          "recomputation" % (len(rows), n_params, worst))
    print("plane (5) default Monitor through the fused step: %d rows at "
          "batch 4 equal norm(x)/sqrt(size) recomputed on the card (worst "
          "%.3g of the bound 5e-7 + 1e-5 x value, the rows' 6 decimals); "
          "captures 1, launches %s" % (len(rows), worst, run["launches"]))
    _drop(run)
    return {"rows": len(rows), "worst_rel_err": worst,
            "launches": run["launches"]}


# ---------------------------------------------------------------------------
# 10. the ImageNet models at scale, NCHW
# ---------------------------------------------------------------------------
# name, the models function, its keyword arguments, input side; the K3 launches a
# step (2 x convolutions - 1: the first convolution reads the data,
# which needs no gradient) and the convolutions, from the reference's
# symbols
MODELS = [("alexnet", "get_alexnet", {}, 224, 9, 5),
          ("vgg16", "get_vgg", {"num_layers": 16}, 224, 25, 13),
          ("googlenet", "get_googlenet", {}, 224, 113, 57),
          ("inception_v3", "get_inception_v3", {}, 299, 187, 94),
          ("resnet50_nchw", "get_resnet50", {"layout": "NCHW"}, 224, 105,
           53)]
MODEL_STEPS = 5                # batches of 32 a phase-10 fit
MODEL_CLASSES = 1000
MODEL_GATE_BETA = 2.0          # see model_gate
RECORDIO_RECORDS = 64


def model_symbol(mx, fn, kwargs):
    return getattr(mx.models, fn)(num_classes=MODEL_CLASSES, **kwargs)


def model_convs(mx, sym, data_shape):
    """Every convolution of ``sym`` at ``data_shape`` (NCHW): its input
    and output shapes, kernel, and whether its input is the data; and
    the K3 products of one training step, (M, N, K, transpose_a) ->
    count, as conv_gemm_shapes reads them off ResNet-50 NHWC."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=data_shape)
    shape_of = dict(zip(internals.list_outputs(), outs))
    nodes = json.loads(sym.tojson())["nodes"]
    convs, counts = [], {}
    for node in nodes:
        if node["op"] != "Convolution":
            continue
        src = nodes[node["inputs"][0][0]]
        is_data = src["op"] == "null"
        n, c, h, w = shape_of[src["name"] if is_data
                              else src["name"] + "_output"]
        kh, kw = _shape_param(node["param"]["kernel"])
        out = shape_of[node["name"] + "_output"]
        _, o, ho, wo = out
        convs.append({"x": (n, c, h, w), "g": tuple(out), "is_data": is_data})
        keys = [(kh * kw * c, o, n * ho * wo, True)]
        if not is_data:
            keys.append((n * h * w, c, kh * kw * o, False))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    return convs, counts


def _model_group(name):
    low = name.lower()
    if "conv_gemm" in low:
        return "conv_gemm (K3)"
    if "norm_act" in low:
        return "norm_act (K4/K5)"
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transforms (cuDNN)"
    if "catarray" in low:
        return "concat"
    if "copy" in low:
        return "copies (layout, im2col, pads)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach SGD)"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd", "dgrad", "wgrad", "sm90_")):
        return "convolution forward (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "other elementwise/reductions"


def layout_copy_ms(torch, convs):
    """The NCHW -> channels-last copies that K3's wrapper makes in one
    training step (``_Conv2d.backward``: the output cotangent and the
    input of every convolution), each timed alone by CUDA events at its
    shape (median of 5, L2 flushed), summed."""
    flush = torch.empty(64 << 20, device="cuda")
    cache = {}
    total = 0.0
    for conv in convs:
        for shape in (conv["x"], conv["g"]):
            if shape not in cache:
                t = torch.randn(*shape, device="cuda")
                cache[shape] = time_ms(torch, lambda: t.movedim(1, -1)
                                       .contiguous(), flush, reps=5)
                del t
            total += cache[shape]
    return total


def model_data(name, side, steps=MODEL_STEPS):
    """``steps`` batches of 32 seeded synthetic images (NCHW) and labels."""
    rng = np.random.default_rng(sum(map(ord, name)))
    images = rng.standard_normal((steps * BATCH, 3, side, side),
                                 dtype=np.float32)
    labels = rng.integers(0, MODEL_CLASSES, steps * BATCH).astype(np.float32)
    return images, labels


def model_module(mx, sym, ctx, shape, seed=0):
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))], for_training=True)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    return mod


def _same_run(what, got, want):
    for name in ("args", "aux"):
        unequal = [k for k in want[name]
                   if not np.array_equal(got[name][k], want[name][k])]
        check(not unequal, "%s: %s differ at %s" % (what, name, unequal[:5]))
    check(got["losses"] == want["losses"], "%s: losses %s against %s"
          % (what, got["losses"], want["losses"]))
    check(got["accuracy"] == want["accuracy"], "%s: metric %r against %r"
          % (what, got["accuracy"], want["accuracy"]))


def _mask_keyed_dropout(torch, mx, sym):
    """Patch the port's Dropout so that, in train mode, each node draws
    its keep-mask from numpy seeded by its name, on the CPU and on the
    card alike (the card's Philox and the CPU generator draw different
    masks). Returns the function that undoes the patch."""
    import zlib

    nn = mx.ops.nn
    names = {id(n.op): n.name for n in sym._topo()
             if not n.is_variable and type(n.op).__name__ == "Dropout"}
    saved = nn.Dropout.apply

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not ctx.is_train or self.p <= 0.0:
            return [x], []
        rng = np.random.RandomState(zlib.crc32(names[id(self)].encode()))
        keep = torch.from_numpy(rng.rand(*x.shape) < 1.0 - self.p)
        return [torch.where(keep.to(x.device), x / (1.0 - self.p),
                            torch.zeros_like(x))], []

    nn.Dropout.apply = apply

    def undo():
        nn.Dropout.apply = saved
    return undo


def model_gate(torch, mx, sym, images, labels):
    """One classic training step at batch 2 on the card (the kernels)
    against the port on the CPU (their plain versions), the same seed-1
    weights, data and Dropout masks (keyed by node name, see
    _mask_keyed_dropout). Conditioned as the CPU parity tests are
    (tests/torch_vision_helpers.py): every BatchNorm beta at 2, and
    ResNet's residual blocks' last BatchNorm gamma at 0.25, so that few
    ReLU inputs sit within rounding of zero. Bound: the loss within rtol
    1e-4, the update of all params together within 1e-2 of its norm."""
    res = []
    undo = _mask_keyed_dropout(torch, mx, sym)
    try:
        for ctx in (mx.gpu(0), mx.cpu()):
            mod = model_module(mx, sym, ctx, (2,) + images.shape[1:], seed=1)
            args, aux = mod.get_params()
            start = {}
            for name, arr in args.items():
                if name.endswith("_bn_beta"):
                    arr[:] = np.full(arr.shape, MODEL_GATE_BETA, np.float32)
                if name.endswith("_b3_bn_gamma"):
                    arr[:] = np.full(arr.shape, GATE_GAMMA_B3, np.float32)
                start[name] = arr.asnumpy().copy()
            mod.set_params(args, aux)
            mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
            mod.forward_backward(mx.io.DataBatch([images[:2]], [labels[:2]]))
            mod.update()
            probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
            loss = float(-np.log(probs[np.arange(2),
                                       labels[:2].astype(int)]).mean())
            res.append((loss, _host(mod.get_params()[0]), start))
            del mod
    finally:
        undo()
    (lg, pg, s0), (lc, pc, _) = res
    diff = np.concatenate([(pg[k] - pc[k]).ravel() for k in pc])
    upd = np.concatenate([(pc[k] - s0[k]).ravel() for k in pc])
    rel = float(np.linalg.norm(diff) / np.linalg.norm(upd))
    check(abs(lg - lc) <= 1e-4 * abs(lc), "gate loss %g on the card, %g on "
          "the CPU" % (lg, lc))
    check(rel <= 1e-2, "gate: the card's update differs from the CPU's by "
          "%.3g of its norm (bound 1e-2)" % rel)
    return {"loss_card": lg, "loss_cpu": lc, "update_rel_err": rel}


def model_path(torch, mx, kernels, card, spec):
    """Phase 10 for one network: the classic loop and the fused step
    (bit-equal, launches, one capture), profiled replays, the batch-2
    gate, K3 alone over the step's products beside torch.matmul, and the
    layout copies."""
    name, fn, kwargs, side, k3_step, n_convs = spec
    sym = model_symbol(mx, fn, kwargs)
    shape = (BATCH, 3, side, side)
    convs, gemms = model_convs(mx, sym, shape)
    check(len(convs) == n_convs and sum(gemms.values()) == k3_step,
          "%s: %d convolutions and %d K3 products a step, want %d and %d"
          % (name, len(convs), sum(gemms.values()), n_convs, k3_step))
    images, labels = model_data(name, side)
    zero = {"norm_act_fwd": 0, "norm_act_bwd": 0, "linear": 0,
            "flash_attn": 0, "rtc": 0}

    def fit(fused, wrap=None):
        mod = model_module(mx, sym, mx.gpu(0), shape)
        return fit_module(torch, mx, kernels, mod, images, labels, fused,
                          wrap)

    classic = fit(False)
    classic.pop("mod")
    classic.pop("metric")
    check(classic["launches"] == dict(zero, conv_gemm=k3_step * MODEL_STEPS),
          "%s classic launches %s, want K3 %d a step and no other"
          % (name, classic["launches"], k3_step))
    check(all(np.isfinite(classic["losses"])), "%s: losses %s"
          % (name, classic["losses"]))
    fused = fit(True)
    mod, metric = fused.pop("mod"), fused.pop("metric")
    step = mod._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": MODEL_STEPS - 1},
          "%s fused counters %s" % (name, counters))
    check(fused["launches"] == dict(zero, conv_gemm=2 * k3_step),
          "%s fused launches %s, want K3 %d (the eager step and the "
          "capture) and no other" % (name, fused["launches"], 2 * k3_step))
    _same_run("%s fused against classic" % name, fused, classic)
    out = {"model": name, "input": list(shape), "convolutions": len(convs),
           "k3_per_step": k3_step, "counters": counters,
           "launches_classic": classic["launches"],
           "launches_fused": fused["launches"], "losses": fused["losses"]}
    if name == "alexnet":
        wrapped = fit(True, wrap=lambda it: mx.io.PrefetchingIter(
            mx.io.ResizeIter(it, MODEL_STEPS)))
        wrapped.pop("mod")
        wrapped.pop("metric")
        _same_run("alexnet through PrefetchingIter(ResizeIter(NDArrayIter)) "
                  "against NDArrayIter", wrapped, fused)
        out["prefetch_resize_bit_equal"] = True
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    step.step(batch, metric)
    torch.cuda.synchronize()
    prof = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                          group=_model_group)
    check(prof["launches"] == dict(
        {k: 0 for k in kernels.LAUNCH_KERNELS}, conv_gemm=2 * k3_step),
        "%s: two profiled replays ran %s, want K3 %d"
        % (name, prof["launches"], 2 * k3_step))
    del mod, step, metric, batch
    torch.cuda.empty_cache()
    out.update(
        step_ms_classic=classic["step_ms"], step_ms_fused=fused["step_ms"],
        img_per_s_classic=classic["img_per_s"],
        img_per_s_fused=fused["img_per_s"],
        peak_gb_classic=classic["peak_bytes"] / 1e9,
        peak_gb_fused=fused["peak_bytes"] / 1e9,
        peak_above_start_gb_classic=classic["peak_above_start_bytes"] / 1e9,
        peak_above_start_gb_fused=fused["peak_above_start_bytes"] / 1e9,
        replays_profiled=prof)
    out["gate"] = model_gate(torch, mx, sym, images, labels)
    _, out["k3_alone"] = conv_gemm_timing(torch, kernels, gemms, reps=10,
                                          verbose=False)
    out["layout_copies_ms"] = layout_copy_ms(torch, convs)
    out["gemms"] = sorted(gemms)
    groups = prof["by_group_ms"]
    print("phase 10 %s NCHW %dx%d batch %d f32: host step %.3f / %.3f ms "
          "(classic / fused), %.1f / %.1f img/s, device %.3f ms a step, busy "
          "%.1f%%, peak %.3f / %.3f GB (%.3f / %.3f above the fit's start); "
          "K3 %.3f ms a step in the replay over "
          "%d launches (alone %.3f, torch.matmul %.3f, bound %.3f); cuDNN "
          "forward %.3f ms; copies %.3f ms (the NCHW layout copies alone "
          "%.3f), cuDNN layout transforms %.3f ms; gate loss %.6f / %.6f, "
          "update %.3g of its norm  [%s]"
          % (name, side, side, BATCH, classic["step_ms"], fused["step_ms"],
             classic["img_per_s"], fused["img_per_s"],
             prof["device_ms_per_step"], 100 * prof["busy_share"],
             classic["peak_bytes"] / 1e9, fused["peak_bytes"] / 1e9,
             classic["peak_above_start_bytes"] / 1e9,
             fused["peak_above_start_bytes"] / 1e9,
             groups.get("conv_gemm (K3)", 0.0), k3_step,
             out["k3_alone"]["ms"], out["k3_alone"]["library_ms"],
             out["k3_alone"]["bound_ms"],
             groups.get("convolution forward (cuDNN)", 0.0),
             groups.get("copies (layout, im2col, pads)", 0.0),
             out["layout_copies_ms"],
             groups.get("layout transforms (cuDNN)", 0.0),
             out["gate"]["loss_card"], out["gate"]["loss_cpu"],
             out["gate"]["update_rel_err"], card))
    return out


def recordio_roundtrip(mx, tmp):
    """MXRecordIO and MXIndexedRecordIO round trips of packed records
    (scalar and vector labels, payloads of every length mod 4) on the
    card's host: no PIL."""
    rio = mx.recordio
    rng = np.random.RandomState(11)
    recs = []
    for i in range(RECORDIO_RECORDS):
        label = float(i) if i % 2 else [float(i), 0.5 * i, -1.0]
        recs.append((label, rng.bytes(int(rng.randint(0, 4096)))))
    rec, idx = os.path.join(tmp, "r.rec"), os.path.join(tmp, "r.idx")
    with rio.MXIndexedRecordIO(idx, rec, "w") as w:
        for i, (label, payload) in enumerate(recs):
            w.write_idx(i, rio.pack(rio.IRHeader(0, label, i, 0), payload))
    seq = []
    with rio.MXRecordIO(rec, "r") as r:
        while True:
            buf = r.read()
            if buf is None:
                break
            seq.append(rio.unpack(buf))
    check([p for _, p in seq] == [p for _, p in recs],
          "recordio: the sequential read differs from what was written")
    with rio.MXIndexedRecordIO(idx, rec, "r") as r:
        for i in rng.permutation(RECORDIO_RECORDS)[:16]:
            header, payload = rio.unpack(r.read_idx(int(i)))
            check(payload == recs[i][1] and header.id == i
                  and np.array_equal(np.asarray(header.label, np.float32),
                                     np.asarray(recs[i][0], np.float32)),
                  "recordio: record %d read by key differs" % i)
    return {"records": RECORDIO_RECORDS, "bytes": os.path.getsize(rec)}


def models_main_path(torch, mx, kernels, card):
    """Phase 10: every network of MODELS through model_path, then K3
    against a float64 product at each of their step's products that
    phase 3 did not check, and the RecordIO round trips."""
    runs = {}
    for spec in MODELS:
        runs[spec[0]] = model_path(torch, mx, kernels, card, spec)
        torch.cuda.empty_cache()
    phase3 = set(conv_gemm_shapes(mx))
    new = sorted({tuple(g) for r in runs.values() for g in r["gemms"]}
                 - phase3)
    worst, cases = conv_gemm_parity(torch, kernels, new)
    print("phase 10 conv_gemm parity: %d cases (%d products of the five "
          "steps that phase 3 does not hold, f32 and bf16), reruns "
          "bit-identical, max abs err vs float64 f32 %g; max %.3g of "
          "sum|a||b| (bound 1e-6)" % (cases, len(new),
                                       worst["abs_float32"], worst["rel"]))
    with tempfile.TemporaryDirectory() as tmp:
        rec = recordio_roundtrip(mx, tmp)
    print("phase 10 recordio: %d packed records written and read back, "
          "sequentially and by key (%d bytes)" % (rec["records"],
                                                 rec["bytes"]))
    return {"models": runs, "k3_parity": dict(worst, cases=cases,
                                              products=len(new)),
            "recordio": rec}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", help="write the full record here (JSON)")
    parser.add_argument("--ckpt-child", metavar="DIR",
                        help="run phase 8's SIGTERM child over DIR (the "
                        "phase starts it)")
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
    if opts.ckpt_child:
        return ckpt_child(opts.ckpt_child)

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
    sass = {name: _build.tf32_mma_count(name) for name in TF32_KERNELS}
    print("TF32 tensor-core MMA instructions (cuobjdump -sass, HMMA ... "
          "TF32): %s" % sass)
    check(all(sass.values()), "a kernel that must run on the tensor cores "
          "holds no TF32 MMA instruction: %s" % sass)

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
    print("linear parity: %d cases, one launch a call, reruns "
          "bit-identical, max abs err vs float64 %g; max %.3g of "
          "sum|x||w|+|b| (bound 1e-6)"
          % (cases, linear_worst["abs"], linear_worst["rel"]))
    digests = linear_digests(torch, kernels)
    print("linear digests (sha256 of the output, seed 15): %s"
          % json.dumps(digests))
    rtc_check = rtc_parity(torch, mx)
    print("rtc parity: axpy and its float4 and ldg bodies bit-equal to "
          "2*x+y, gelu_ish max rel err %.3g (bound 1e-4), an in-place push "
          "equal to 2*x, bad body refused: %s"
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
          "%.4f ms, torch.matmul %.4f ms, bound %.4f ms (%s; simt %.4f), "
          "%.1f TFLOP  [%s]"
          % (gemm_tot["ms"], gemm_tot["plain_ms"], gemm_tot["library_ms"],
             gemm_tot["bound_ms"], gemm_tot["bound_by"],
             gemm_tot["simt_bound_ms"], gemm_tot["flops"] / 1e12, card))
    flash_rows = flash_timing(torch, kernels)
    linear_rows = linear_timing(torch, kernels)
    rtc_time = rtc_timing(torch, mx)
    print("timed on [%s]" % card)

    # 5. serving, 6. training: the main paths
    serve = serve_main_path(torch, mx, kernels, card)
    images, labels = train_data()
    train = train_main_path(torch, mx, kernels, card, images, labels)
    fused = fused_train_path(torch, mx, kernels, card, images, labels, train)
    for run in (train, fused):
        del run["args"], run["aux"]
    print("classic vs fused, ResNet-50 NHWC batch 32 f32: host step %.3f / "
          "%.3f ms, %.1f / %.1f img/s, device busy %.1f%% / %.1f%%, device "
          "%.3f / %.3f ms a step, peak allocated %.3f / %.3f GB  [%s]"
          % (train["step_ms"], fused["step_ms"], train["img_per_s"],
             fused["img_per_s"], 100 * train["breakdown"]["busy_share"],
             100 * fused["breakdown"]["busy_share"],
             train["breakdown"]["device_ms_per_step"],
             fused["breakdown"]["device_ms_per_step"],
             train["peak_bytes"] / 1e9, fused["peak_bytes"] / 1e9, card))
    mnist = mnist_main_path(torch, mx, kernels, card)

    # 7. the slice's entry points at full width
    entry = entry_points_main_path(torch, mx, kernels)

    # 8. checkpoints through the fused step at full width
    ckpt_run = checkpoint_main_path(torch, mx, kernels, card)

    # 9. fit's health and input plane through the fused step at full width
    plane = plane_main_path(torch, mx, kernels, card)

    # 10. the ImageNet models at scale, NCHW, through the fused step
    models = models_main_path(torch, mx, kernels, card)
    model_paths = {}
    for name, run in models["models"].items():
        for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
            model_paths.setdefault(kernel, {}).update({
                "models_%s_classic" % name: run["launches_classic"][kernel],
                "models_%s_fused" % name: run["launches_fused"][kernel],
                "models_%s_fused_2_replays_profiled" % name:
                    run["replays_profiled"]["launches"][kernel]})

    # 11. report
    train_scope = "%d launches of one ResNet-50 NHWC training step, batch " \
        "32, f32"
    fused_note = ("*_fused: the wrappers' counts over the fused fit, its "
                  "eager step and the launches its CUDA graph capture "
                  "recorded (a replay runs no wrapper); "
                  "*_2_replays_profiled: the launches the card ran in two "
                  "replays, counted from torch.profiler's kernel events; "
                  "train_fused_ckpt_resume: the wrappers' counts over the "
                  "checkpoint phase's resumed fit (its eager step and its "
                  "capture); train_fused_plane_numwatch: the same over "
                  "phase 9's fit with the numerics plane, the metrics "
                  "server and the flight recorder armed (every phase-9 "
                  "fit is checked to count the same); models_<net>_*: "
                  "phase 10's fits of AlexNet, VGG-16, GoogLeNet, "
                  "Inception-v3 and ResNet-50 in NCHW at batch 32 (classic: "
                  "5 steps; fused: the eager step and the capture; "
                  "replays: two, from the kernel events)")
    records = [{
        "name": "norm_act_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:579",
        "launches": train["launches"]["norm_act_fwd"],
        "launches_by_path": {
            "serve": serve["launches"],
            "train": train["launches"]["norm_act_fwd"],
            "train_fused": fused["launches"]["norm_act_fwd"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["norm_act_fwd"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["norm_act_fwd"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["norm_act_fwd"],
            **model_paths["norm_act_fwd"]},
        "launches_note": fused_note,
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
        "launches_by_path": {
            "train": train["launches"]["norm_act_bwd"],
            "train_fused": fused["launches"]["norm_act_bwd"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["norm_act_bwd"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["norm_act_bwd"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["norm_act_bwd"],
            **model_paths["norm_act_bwd"]},
        "launches_note": fused_note,
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
        "launches_by_path": {
            "train": train["launches"]["conv_gemm"],
            "train_fused": fused["launches"]["conv_gemm"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["conv_gemm"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["conv_gemm"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["conv_gemm"],
            "mnist_lenet_fused": mnist["lenet"]["launches"]["conv_gemm"],
            "mnist_lenet_fused_2_replays_profiled":
                mnist["lenet"]["replay_launches"]["conv_gemm"],
            **model_paths["conv_gemm"]},
        "launches_note": fused_note,
        "max_abs_err": max(gemm_worst["abs_float32"],
                           models["k3_parity"]["abs_float32"]),
        "max_err_bf16": max(gemm_worst["abs_bfloat16"],
                            models["k3_parity"]["abs_bfloat16"]),
        "max_err_of_abs_product": max(gemm_worst["rel"],
                                      models["k3_parity"]["rel"]),
        "ms": gemm_tot["ms"], "plain_ms": gemm_tot["plain_ms"],
        "bound_ms": gemm_tot["bound_ms"], "bound_by": gemm_tot["bound_by"],
        "simt_bound_ms": gemm_tot["simt_bound_ms"],
        "tf32_mma_sass": sass["conv_gemm"],
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
        "simt_bound_ms": linear_rows[1]["simt_bound_ms"],
        "tf32_mma_sass": sass["linear"],
        "library_ms": linear_rows[1]["library_ms"],
        "library_call": "torch.addmm (plus the activation)",
        "small_layer_ms": linear_rows[0]["ms"],
        "small_layer_library_ms": linear_rows[0]["library_ms"],
        "small_layer_bound_ms": linear_rows[0]["bound_ms"],
        "digests": digests,
        "scope": "one call at ResNet-50's head, (%d, 2048) -> 1000, f32, "
                 "the entry-point path's shape; small_layer_*: (128, 256) "
                 "-> 128" % BATCH,
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:154",
        "launches": entry["launches"]["flash_attn"],
        "max_abs_err": flash_worst,
        "ms": flash_rows[1]["ms"], "plain_ms": flash_rows[1]["plain_ms"],
        "bound_ms": flash_rows[1]["bound_ms"], "bound_by": "operations",
        "simt_bound_ms": flash_rows[1]["simt_bound_ms"],
        "tf32_mma_sass": sass["flash_attn"],
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
        "yardstick_ms": rtc_time["yardstick_ms"],
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
                       "train_fused_path": fused, "mnist_path": mnist,
                       "entry_points": entry,
                       "checkpoint_path": {k: v for k, v in ckpt_run.items()
                                           if k != "mod"},
                       "plane_path": plane, "models_path": models}, f,
                      indent=1)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
