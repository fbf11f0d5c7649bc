#!/usr/bin/env python3
"""Data parallelism of the PyTorch port in one process over several
cards: ResNet-50 NHWC trained through ``Module.fit`` over every card at
once, against one card at the same global batch.

    python3 tools/torch_dp_check.py                   # every visible card
    python3 tools/torch_dp_check.py --cards 4 --report dp.json
    python3 tools/torch_dp_check.py --cpu --cards 4 --per-card 2 --image 32

Builds ResNet-50 NHWC (1000 classes, 224 x 224) with Xavier weights from
seed 0 and the residual blocks' last BatchNorm gamma at 0.25 (as
chip_smoke's training gate: fewer near-tie ReLUs to flip, see
ROADMAP.md "A limit of the comparison"), then trains it for 5 batches of
``--per-card`` x ``--cards`` images from seed 0, float32 with TF32 off,
SGD (lr 0.0125, momentum 0.9, wd 1e-4, rescale 1 / the global batch):

1. on one card: ``fit(fused_step=True)`` over ``context=[gpu(0)]`` at
   the global batch;
2. over ``--cards`` cards: ``fit`` over ``context=[gpu(0), ...]`` with
   ``kvstore="device_sync"``, which takes the fused step by default.

Checks, after the 5 steps: the multi-card fit's params and moving
statistics as close to the one-card fit's as float32 allows, normwise
as a share of the one-card fit's update: within 4 times the float32
floor, the larger distance that the one-card fit moves when its images
are scaled by 1 + 2^-23 or 1 - 2^-23 (one rounding of the input: the
multi-card fit differs from the one-card fit only by the order of its
sums, NCCL's ring and BatchNorm's per-card partial sums, and training
a random ResNet-50 in float32 amplifies any such difference; see
ROADMAP.md "A limit of the comparison"), and at least 1e-4; every
replica bit-identical to the first; the step one eager step, one
capture (one CUDA graph over every card) and a replay a batch after
the first; K3, K4 and K5 launched on every card, 105, 53 and 53 times a
replay (torch.profiler's kernel events by device, over two replays);
the exchange's cross-card sum (``Replicas.sum_``) over gradients that
differ by card (each replica's executor run alone on its own slice of
one more batch): bit-identical on every card and within
4 * 2^-24 * sum|g_k| of the float64 sum, elementwise. Then the control:
the multi-card fit once more with a fault planted in this process only
(``per_card_statistics``: each card's BatchNorms use its own slice's
statistics, as independent replicas would), which must break the
bound.

Prints the host ms a step (median of steps 2-5, the cards synchronised
at each batch end), the device ms a replay on card 0 and of the one-card
step (CUDA events over 10 replays), img/s on N cards against one, each
card's kernel ms a replay (profiler), the gradient exchange's ms
(one all-reduce of the flat gradient buffers, by CUDA events, alone and
as a one-collective graph), the synchronised statistics' ms (53 forward
and 53 backward all-reduces of 2C floats, one a BatchNorm, replayed as
one graph), the NCCL kernels' device time a replay on card 0 from the
profiler, and the peak memory a card; then one JSON object as the last
line. Exits non-zero when a check fails. ``--cpu`` rehearses the same
path over CPU contexts (no timing, no profiler). Imports neither jax
nor the JAX package.
"""
import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PER_CARD = 32
STEPS = 5
IMAGE = 224
OPT = (("learning_rate", 0.0125), ("momentum", 0.9), ("wd", 1e-4))
GAMMA_B3 = 0.25
FLOOR_FACTOR = 4               # the bound: this many float32 floors ...
MIN_BOUND = 1e-4               # ... and at least this, normwise
EXCHANGE_ULPS = 4              # the exchanged gradient, in units of 2^-24
PER_REPLAY = {"conv_gemm": 105, "norm_act_fwd": 53, "norm_act_bwd": 53}


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def initial_params(mx, image, seed=0):
    """Xavier ResNet-50 NHWC params from ``seed`` (numpy), the residual
    blocks' last BatchNorm gamma at GAMMA_B3."""
    mod = resnet_module(mx, [mx.cpu()], 1, image)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    args, aux = mod.get_params()
    args = {k: v.asnumpy().copy() for k, v in args.items()}
    for k in args:
        if k.endswith("_b3_bn_gamma"):
            args[k][:] = GAMMA_B3
    return args, {k: v.asnumpy().copy() for k, v in aux.items()}


def resnet_module(mx, ctxs, batch, image):
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    mod = mx.mod.Module(sym, context=ctxs)
    mod.bind(data_shapes=[("data", (batch, image, image, 3))],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    return mod


def _sync(torch, cuda):
    if cuda:
        torch.cuda.synchronize()


def fit(torch, mx, kernels, ctxs, kvstore, args, aux, images, labels,
        batch, cuda):
    """The fit of the check: launches counted over it, per-step losses,
    host ms a step, the params and aux after it (numpy), the peak
    memory a card."""
    mod = resnet_module(mx, ctxs, batch, images.shape[1])
    metric = mx.metric.Accuracy()
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = labels[param.nbatch * batch:(param.nbatch + 1) * batch]
        losses.append(float(-np.log(probs.astype(np.float64)[
            np.arange(batch), lab.astype(int)]).mean()))
        _sync(torch, cuda)
        marks.append(time.perf_counter())

    devices = [c.torch_device() for c in ctxs]
    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    kernels.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=batch),
            num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=OPT, eval_metric=metric,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()},
            batch_end_callback=on_batch,
            fused_step=True if len(ctxs) == 1 else None)
    launches = kernels.launch_counts()
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    a, x = mod.get_params()
    out = {"mod": mod, "metric": metric, "losses": losses,
           "launches": {k: launches[k] for k in PER_REPLAY},
           "steps_ms": steps_ms,
           "step_ms": float(np.median(steps_ms)) if steps_ms else None,
           "args": {k: v.asnumpy().copy() for k, v in a.items()},
           "aux": {k: v.asnumpy().copy() for k, v in x.items()}}
    if cuda:
        out["peak_gb"] = [torch.cuda.max_memory_allocated(d) / 1e9
                          for d in devices]
    return out


def _normwise(got, want, start):
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum((want[k].astype(np.float64) - start[k]) ** 2))
              for k in want)
    return (num / den) ** 0.5 if den else float("inf")


def replicas_identical(mod):
    execs = mod._exec_group.execs
    bad = []
    for ex in execs[1:]:
        for name in list(ex.arg_dict) + list(ex.aux_dict):
            if name in ("data", "softmax_label"):
                continue
            mine = (ex.arg_dict[name] if name in ex.arg_dict
                    else ex.aux_dict[name]).handle.cpu()
            first = (execs[0].arg_dict[name] if name in execs[0].arg_dict
                     else execs[0].aux_dict[name]).handle.cpu()
            if not bool((mine == first).all()):
                bad.append(name)
    return bad


def exchange_check(torch, mx, mod, images, labels, batch):
    """The cross-card sum of the exchange (``Replicas.sum_``) on gradients
    that differ by card: each replica's executor runs one forward and
    backward alone on its own slice of a batch (its BatchNorms over that
    slice), filling its flat gradient buffer; copies of those buffers are
    then summed across the cards. The worst elementwise error of card
    0's sum against the float64 sum, in units of 2^-24 * sum|g_k|, and
    whether every card got the same bytes. The replicas' moving
    statistics are put back afterwards."""
    group = mod._exec_group
    reps = group.replicas
    group.load_data_batch(mx.io.DataBatch(
        [mx.nd.array(images[:batch], ctx=mx.cpu())],
        [mx.nd.array(labels[:batch], ctx=mx.cpu())]))
    kept = [[a.handle.clone() for a in ex.aux_arrays] for ex in group.execs]
    own = []
    for k, ex in enumerate(group.execs):
        with reps.device(k):
            ex.forward(is_train=True)
            ex.backward()
            own.append(group.replicated.flats[k][0].clone())
    for ex, saved in zip(group.execs, kept):
        for a, v in zip(ex.aux_arrays, saved):
            a.handle.copy_(v)
    home = own[0].device
    as64 = [g.to(home, torch.float64) for g in own]
    exact = sum(as64)
    scale = sum(g.abs() for g in as64)
    reps.begin()
    reps.sum_(own)
    got = own[0].to(torch.float64)
    tiny = torch.finfo(torch.float32).tiny
    ulps = float(((got - exact).abs() / (scale * 2.0 ** -24 + tiny)).max())
    same = all(bool(torch.equal(g.to(home), own[0])) for g in own[1:])
    differ = not all(bool(torch.equal(g, as64[0])) for g in as64[1:])
    return {"worst_in_2^-24_sum_abs": ulps, "identical_on_cards": same,
            "inputs_differ_by_card": differ,
            "elements": int(own[0].numel())}


def per_card_statistics():
    """The control's planted fault, for this process only: every
    BatchNorm in train mode normalises each card's slice by that slice's
    own statistics, with no cross-card sum (what a port made of
    independent replicas computes). Returns the function that undoes
    it."""
    from mxnet_tpu_torch.ops import nn

    cross = nn.BatchNorm.apply_replicas

    def each_alone(self, ctxs, inputs, aux, layouts):
        return ctxs[0].replicas.each(self.apply, ctxs, inputs, aux)

    nn.BatchNorm.apply_replicas = each_alone

    def undo():
        nn.BatchNorm.apply_replicas = cross
    return undo


def profile_replays(torch, kernels, step, batch, metric, reps=2):
    """The compiled kernels' launches on each card and the NCCL kernels'
    time on card 0 over ``reps`` replays (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step.step(batch, metric)
        torch.cuda.synchronize()
    names, nccl, busy = {}, [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = float(e.time_range.elapsed_us()) / 1e3
        names.setdefault(e.device_index, []).append(e.name)
        busy[e.device_index] = busy.get(e.device_index, 0.0) + ms
        if e.device_index == 0 and "nccl" in e.name.lower():
            nccl.append(ms)
    nccl.sort(reverse=True)
    return ({d: kernels.launches_in(n) for d, n in sorted(names.items())},
            {"nccl_kernels_a_replay": len(nccl) / reps,
             "nccl_ms_a_replay": sum(nccl) / reps,
             "largest_nccl_ms": nccl[:reps],
             "kernel_ms_a_replay_by_card": {
                 d: ms / reps for d, ms in sorted(busy.items())}})


def _event_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def collective_times(torch, mod):
    """The gradient exchange alone (eager and as a one-collective graph)
    and the synchronised statistics (two all-reduces of 2C floats a
    BatchNorm, as one graph), by CUDA events on card 0."""
    from mxnet_tpu_torch.replicas import CardGraph

    group = mod._exec_group
    reps = group.replicas
    size = group.replicated.flats[0][0].numel()
    # buffers of the exchange's size, the tool's own: the module's
    # buffers stay out of these graphs
    flats = [torch.zeros(size, device=d) for d in reps.devices]
    reps.begin()
    out = {"exchange_eager_ms": _event_ms(torch, lambda: reps.sum_(flats)),
           "exchange_mb": flats[0].numel() * 4 / 1e6}
    channels = [a.shape[0] for n, a in zip(group.aux_names,
                                           group.executor.aux_arrays)
                if n.endswith("moving_mean")]
    stats = [[torch.zeros(2 * c, device=d) for d in reps.devices]
             for c in channels]

    def graph_of(work):
        streams = [torch.cuda.Stream(d) for d in reps.devices]
        graph = CardGraph(reps, streams)

        def body():
            reps.begin()
            work()
        graph.capture(body)
        return graph

    g_ex = graph_of(lambda: reps.sum_(flats))
    g_stats = graph_of(lambda: [reps.sum_(t) for _ in range(2)
                                for t in stats])
    reps.begin()
    out["exchange_graph_ms"] = _event_ms(torch, g_ex.replay)
    out["statistics_graph_ms"] = _event_ms(torch, g_stats.replay)
    g_ex.close()
    g_stats.close()
    out["statistics_collectives"] = 2 * len(channels)
    out["statistics_floats"] = 2 * sum(2 * c for c in channels)
    return out


def run(torch, mx, kernels, n_cards, per_card=PER_CARD, steps=STEPS,
        image=IMAGE, cpu=False, log=print):
    """The check over ``n_cards``; returns the record with ``failed``
    (the failed checks' messages, empty when all pass). Last, the control:
    the multi-card fit again with :func:`per_card_statistics` planted,
    which must break the bound."""
    cuda = not cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: " + msg)

    batch = per_card * n_cards
    rng = np.random.RandomState(0)
    images = rng.randn(steps * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, steps * batch).astype(np.float32)
    args0, aux0 = initial_params(mx, image)
    ctx = mx.cpu if cpu else mx.gpu
    rec = {"cards": n_cards, "per_card": per_card, "global_batch": batch,
           "steps": steps, "image": image}

    data = mx.io.DataBatch([mx.nd.array(images[:batch], ctx=mx.cpu())],
                           [mx.nd.array(labels[:batch], ctx=mx.cpu())])
    one = fit(torch, mx, kernels, [ctx(0)], "local", args0, aux0, images,
              labels, batch, cuda)
    rec["one_card"] = {"losses": one["losses"], "step_ms": one["step_ms"],
                       "peak_gb": one.get("peak_gb"),
                       "launches": one["launches"]}
    if cuda:
        rec["one_card"]["device_ms_a_replay"] = _event_ms(
            torch, lambda: one["mod"]._fused_step.step(data, one["metric"]))
    del one["mod"]
    floors = {"params": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        moved = fit(torch, mx, kernels, [ctx(0)], "local", args0, aux0,
                    images * np.float32(scale), labels, batch, cuda)
        del moved["mod"]
        floors["params"] = max(floors["params"], _normwise(
            moved["args"], one["args"], args0))
        floors["aux"] = max(floors["aux"], _normwise(moved["aux"],
                                                     one["aux"], aux0))
    rec["float32_floor_normwise"] = floors
    multi = fit(torch, mx, kernels, [ctx(i) for i in range(n_cards)],
                "device_sync", args0, aux0, images, labels, batch, cuda)
    mod = multi["mod"]
    step = mod._fused_step
    rec["multi"] = {"losses": multi["losses"], "step_ms": multi["step_ms"],
                    "peak_gb": multi.get("peak_gb"),
                    "launches_counted_by_wrappers": multi["launches"]}
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    rec["multi"]["counters"] = counters
    want = ({"eager_steps": 1, "captures": 1, "dispatches": steps - 1}
            if cuda else {"eager_steps": steps, "captures": 0,
                          "dispatches": 0})
    check(counters == want, "fused step counters %s, want %s"
          % (counters, want))
    check(mod._fused_step_active, "device_sync did not take the fused step")
    check(len(multi["losses"]) == steps
          and all(np.isfinite(multi["losses"])),
          "multi-card losses %s" % multi["losses"])
    if cuda:
        # the wrappers count the eager step and the capture, every card
        want_l = {k: v * 2 * n_cards for k, v in PER_REPLAY.items()}
        check(multi["launches"] == want_l, "wrapper launches %s, want %s"
              % (multi["launches"], want_l))
    for what, got in (("params", _normwise(multi["args"], one["args"],
                                           args0)),
                      ("aux", _normwise(multi["aux"], one["aux"], aux0))):
        bound = max(FLOOR_FACTOR * floors[what], MIN_BOUND)
        rec["%s_vs_one_card_normwise" % what] = got
        rec["%s_bound" % what] = bound
        check(got <= bound, "%s differ from the one-card fit by %g of its "
              "update, bound %g (%d x the float32 floor %g)"
              % (what, got, bound, FLOOR_FACTOR, floors[what]))
    bad = replicas_identical(mod)
    rec["replicas_identical"] = not bad
    check(not bad, "replicas differ from the first at %s" % bad[:5])

    metric = multi["metric"]
    if cuda:
        per_device, nccl = profile_replays(torch, kernels, step, data,
                                           metric)
        rec["launches_per_card_2_replays"] = per_device
        rec.update(nccl)
        for d in range(n_cards):
            got = {k: per_device.get(d, {}).get(k, 0) for k in PER_REPLAY}
            want_d = {k: 2 * v for k, v in PER_REPLAY.items()}
            check(got == want_d, "card %d ran %s in two replays, want %s"
                  % (d, got, want_d))
        rec["device_ms_a_replay_card0"] = _event_ms(
            torch, lambda: step.step(data, metric))
        rec.update(collective_times(torch, mod))
        rec["img_per_s"] = batch * 1e3 / multi["step_ms"]
        rec["img_per_s_one_card"] = batch * 1e3 / one["step_ms"]
        rec["speedup"] = rec["img_per_s"] / rec["img_per_s_one_card"]
        rec["device_speedup"] = (rec["one_card"]["device_ms_a_replay"]
                                 / rec["device_ms_a_replay_card0"])
    ex = exchange_check(torch, mx, mod, images, labels, batch)
    rec["exchange_check"] = ex
    check(ex["identical_on_cards"], "the exchanged gradient differs "
          "between cards")
    check(ex["inputs_differ_by_card"], "the exchange check's per-card "
          "gradients are equal: it would test nothing")
    check(ex["worst_in_2^-24_sum_abs"] <= EXCHANGE_ULPS,
          "exchanged gradient off the float64 sum by %g x 2^-24 sum|g| "
          "(bound %d)" % (ex["worst_in_2^-24_sum_abs"], EXCHANGE_ULPS))
    del mod, step, multi
    undo = per_card_statistics()
    try:
        ctl = fit(torch, mx, kernels, [ctx(i) for i in range(n_cards)],
                  "device_sync", args0, aux0, images, labels, batch, cuda)
    finally:
        undo()
    del ctl["mod"]
    rec["control"] = {
        "fault": "per-card BatchNorm statistics",
        "params_vs_one_card_normwise": _normwise(ctl["args"], one["args"],
                                                 args0),
        "aux_vs_one_card_normwise": _normwise(ctl["aux"], one["aux"],
                                              aux0)}
    caught = (rec["control"]["params_vs_one_card_normwise"]
              > rec["params_bound"]
              or rec["control"]["aux_vs_one_card_normwise"]
              > rec["aux_bound"])
    rec["control"]["caught"] = caught
    check(caught, "the control (per-card BatchNorm statistics) stayed "
          "within the bound: %s" % rec["control"])
    rec["failed"] = failed
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="cards (default: every visible one)")
    parser.add_argument("--per-card", type=int, default=PER_CARD)
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--image", type=int, default=IMAGE)
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse over CPU contexts")
    parser.add_argument("--report", help="write the record here (JSON)")
    opts = parser.parse_args()
    faulthandler.enable()
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    if not opts.cpu:
        mx.profiler.keep_cupti()     # it profiles CUDA graph replays
        if not torch.cuda.is_available():
            print("torch_dp_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = opts.cards or (torch.cuda.device_count() if not opts.cpu else 4)
    card = card_line() if not opts.cpu else "cpu"
    print(card)
    t0 = time.perf_counter()
    rec = run(torch, mx, kernels, n, opts.per_card, opts.steps, opts.image,
              opts.cpu)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    rec["torch"] = torch.__version__
    if not opts.cpu:
        print("%d cards x %d, ResNet-50 NHWC f32 fused: host %.3f ms a step "
              "(one card at batch %d: %.3f), %.1f img/s against %.1f "
              "(x%.3f); card 0 device %.3f ms a replay (one card %.3f); "
              "exchange %.3f ms "
              "(%.1f MB; graph %.3f); statistics %.3f ms (%d collectives, "
              "graph); NCCL on card 0 %.3f ms a replay; peak %s GB  [%s]"
              % (n, opts.per_card, rec["multi"]["step_ms"],
                 rec["global_batch"], rec["one_card"]["step_ms"],
                 rec["img_per_s"], rec["img_per_s_one_card"], rec["speedup"],
                 rec["device_ms_a_replay_card0"],
                 rec["one_card"]["device_ms_a_replay"],
                 rec["exchange_eager_ms"],
                 rec["exchange_mb"], rec["exchange_graph_ms"],
                 rec["statistics_graph_ms"], rec["statistics_collectives"],
                 rec["nccl_ms_a_replay"],
                 ["%.3f" % g for g in rec["multi"]["peak_gb"]], card))
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(json.dumps(rec, default=str))
    return 1 if rec["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
