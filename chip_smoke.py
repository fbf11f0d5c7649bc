#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (nvidia-smi), CUDA and
   torch versions; TF32 off for convolutions and matmuls.
2. build: every hand-written kernel from mxnet_tpu_torch/csrc, one nvcc
   per source, all at once.
3. kernel parity on the card: each kernel against its plain PyTorch
   version, at the shapes the main path gives it plus ragged ones.
4. kernel timing: median of CUDA-event times with the L2 cache flushed
   between launches, beside the plain version, the one-call PyTorch
   yardstick and the memory-bandwidth bound.
5. the main path at full width: ResNet-50, 224x224, 1000 classes, NHWC,
   random seeded weights, served through Module -> InferenceServer ->
   FusedInfer from two client threads; kernel launch counts are zeroed
   just before and read just after; served argmax against a direct
   Executor.forward; card probabilities against the port on the CPU.
6. report: one JSON line of kernel records, the card line, then
   {"ok": true, "device": {...}} as the last line.

``--report PATH`` also writes the per-shape record and the main path's
breakdown to PATH as JSON.
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
REQUEST_ROWS = [1, 3, 8, 17, 32, 1, 3, 8, 17, 32, 3, 8]
# (rows, channels, element offset): ragged edges, the scalar path, the
# no-shared-memory path (C > 4096) and a misaligned pointer
RAGGED_SHAPES = [(1000, 100, 0), (7, 3, 0), (4096, 66, 0), (64, 5000, 0),
                 (4096, 64, 1)]


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


def parity(torch, kernels, shapes):
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
                    ulp = torch.exp2(torch.floor(torch.log2(
                        torch.clamp(mag, min=2.0 ** -126))) - 7)
                    bound = ulp
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
    events with the L2 cache flushed before it."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timing(torch, kernels, counts):
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
    worst, cases = parity(torch, kernels, shapes)
    print("norm_act_fwd parity: %d cases, max abs err f32 %g, bf16 %g"
          % (cases, worst["float32"], worst["bfloat16"]))

    # 4. timing at the main path's shapes
    per_shape, tot = timing(torch, kernels, counts)
    print("norm_act_fwd per forward (53 launches, f32): kernel %.4f ms, "
          "plain %.4f ms, addcmul %.4f ms, bound %.4f ms  [%s]"
          % (tot["ms"], tot["plain_ms"], tot["library_ms"], tot["bound_ms"],
             card))

    # 5. the main path
    main_path = serve_main_path(torch, mx, kernels, card)

    # 6. report
    record = {
        "name": "norm_act_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:579",
        "launches": main_path["launches"],
        "max_abs_err": worst["float32"],
        "max_err_f32": worst["float32"], "max_err_bf16": worst["bfloat16"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "bytes",
        "library_ms": tot["library_ms"],
        "scope": "53 launches of one ResNet-50 NHWC forward, batch 32, f32",
    }
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": [record],
                       "norm_act_fwd_shapes": per_shape,
                       "main_path": main_path}, f, indent=1)
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
