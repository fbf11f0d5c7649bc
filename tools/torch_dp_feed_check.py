#!/usr/bin/env python3
"""The PyTorch port's fused train step in one process over several
cards, with the uint8 device feed and with Dropout.

    python3 tools/torch_dp_feed_check.py                  # every visible card
    python3 tools/torch_dp_feed_check.py --part a --report dp_feed.json
    python3 tools/torch_dp_feed_check.py --cpu --cards 4 --per-card 2 \\
        --crop 32 --models alexnet:67

(a) The device feed: ResNet-50 NHWC (1000 classes) with Xavier weights
from seed 0 and the residual blocks' last BatchNorm gamma at 0.25 (as
tools/torch_dp_check.py), trained for one epoch (``--frames`` /
the global batch steps) from a decoded uint8 cache written here from
seed 0 (``--frames`` frames of ``--store``^2 x 3: 1024 of 256^2, 201 MB,
nothing downloaded): ``CachedImageRecordIter(device_feed=True)``, crop
``--crop`` (224), random crops and mirrors, the upstream means,
``aug_replicas`` = the cards, float32 with TF32 off, SGD (lr 0.0125,
momentum 0.9, wd 1e-4):

1. one card, ``fit(fused_step=True)`` at the global batch, and twice
   more with the iterator's scale moved by one rounding (1 +- 2^-23): the
   float32 floor, the larger distance those fits move;
2. over the cards, ``fit`` under ``device_sync`` (the fused step: each
   card crops its rows inside the one CUDA graph) with the feed
   scheduler at depth 2 (each card's rows staged on that card), and the
   classic loop over the same cards without it;
3. the fused fit again under ``MXNET_TPU_MESH_FSDP`` = the cards.

Checks: each card's cropped data equals its rows of the one-card crop
(``materialize_device_feed`` of the whole batch) bit for bit at the
first and the last step; the fused fit equals the classic loop bit for
bit (params, moving statistics, losses); params and moving statistics of
the fused and the fsdp fit within 4 float32 floors (at least 1e-4) of
one card's, normwise; the replicas bit-identical; one capture; a replay
launches crop_norm 1, K3 105, K4 53 and K5 53 times on every card
(torch.profiler's kernel events by device, two replays after one
uncounted replay in the same session, whose launches are recorded).
Control: the fused fit with each card cropping the first card's rows (a
planted fault), which must break the bound. Printed, nothing claimed:
img/s on the cards against one (host step, median of the middle steps),
the uint8 bytes a batch a card against its float32 crop's, the device ms
a replay on card 0 (CUDA events) and crop_norm's share of card 0's
kernel time, crop_norm's ms a replay on each card, and whether one
cross-card sum of each of four sizes gives the same bytes eagerly and
replayed from a CardGraph (``nccl_eager_equals_captured``).

(b) Dropout: AlexNet, VGG-16 and Inception-v3 in NCHW at full width
(224 x 224, Inception-v3 299 x 299, 1000 classes, Dropout as the zoo
builds them), Xavier weights from seed 0 (drawn on the CPU), 3 steps of
``--per-card`` x the cards seeded images, ``mx.random.seed(0)`` before
each fit (each replica's generator takes its seed from that stream): the
fused step over the cards, and the classic loop over the same cards.
Each Dropout's input and output are copied into buffers after the node
(a tap planted in this process): a keep mask is read where the input is
not zero. Checks: one capture; each card's masks differ between the two
replays and differ across the cards (at least a quarter of the positions
known in both disagree); the fused fit equals the classic loop bit for
bit (params, moving statistics, outputs, losses); each card's keep rate
within 5 standard errors of 1 - p; K3 launched 9, 25 and 187 times a
replay on every card. Control: every card's generator seeded as the
first card's (a clone of it), which must fail "masks differ across
cards".

Then one JSON object as the last line; exits non-zero when a check
fails. ``--cpu`` rehearses over CPU contexts (no timing, no profiler;
``--models name:side`` picks smaller inputs there). Imports neither jax
nor the JAX package.
"""
import argparse
import contextlib
import faulthandler
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_check as dpc  # noqa: E402

PER_CARD = 32
FRAMES = 1024
STORE = 256
CROP = 224
MEAN = (123.68, 116.779, 103.939)
SCALE = 1.0
FEED_DEPTH = "2"
PER_REPLAY_FEED = dict(dpc.PER_REPLAY, crop_norm=1)
MODELS = (("alexnet", "get_alexnet", {}, 224, 9),
          ("vgg16", "get_vgg", {"num_layers": 16}, 224, 25),
          ("inception_v3", "get_inception_v3", {}, 299, 187))
MODEL_STEPS = 3
MIN_DISAGREE = 0.25            # of the positions known in both masks
KEEP_SE = 5                    # the keep rate's bound, standard errors


def write_cache(prefix, frames=FRAMES, store=STORE, seed=0, classes=1000):
    """``frames`` seeded uint8 frames of ``store``^2 x 3, labels
    ``i % classes``, in the decoded cache's layout (what
    ``io_cache.build_decoded_cache`` writes, without the JPEG decode).
    Returns ``prefix``."""
    rng = np.random.RandomState(seed)
    shape = (frames, store, store, 3)
    data = np.lib.format.open_memmap(prefix + ".data", mode="w+",
                                     dtype=np.uint8, shape=shape)
    for lo in range(0, frames, 128):
        rows = min(128, frames - lo)
        data[lo:lo + rows] = rng.randint(0, 256, (rows,) + shape[1:],
                                         dtype=np.uint8)
    data.flush()
    del data
    with open(prefix + ".label", "wb") as f:
        np.save(f, (np.arange(frames) % classes).astype(np.float32)
                .reshape(-1, 1))
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"num": frames, "height": store, "width": store,
                   "channels": 3, "label_width": 1, "version": 1}, f)
    return prefix


def fed_iter(mx, prefix, batch, crop, aug_replicas, scale=SCALE):
    with mx.cpu():
        return mx.io_cache.CachedImageRecordIter(
            prefix, (3, crop, crop), batch, shuffle=True, rand_crop=True,
            rand_mirror=True, seed=0, output_layout="NHWC", mean_r=MEAN[0],
            mean_g=MEAN[1], mean_b=MEAN[2], scale=scale, device_feed=True,
            aug_replicas=aug_replicas)


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _progress(log, msg):
    """A progress line, flushed at once: a crash in native code loses
    what the buffer holds."""
    log("%s  [%.1f s]" % (msg, time.perf_counter() - _T0))
    sys.stdout.flush()


_T0 = time.perf_counter()


def _sync(torch, cuda):
    if cuda:
        torch.cuda.synchronize()


def _losses_of(mod, batch):
    probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
    lab = batch.label[0].asnumpy().astype(int)
    return float(-np.log(probs[np.arange(len(lab)), lab]).mean())


def fed_fit(torch, mx, kernels, ctxs, kvstore, fused, args, aux, it, batch,
            crop, cuda, on_batch=None):
    """One epoch of ``it`` through fit: losses, host ms a step, params
    and aux (numpy), the module and the metric."""
    mod = dpc.resnet_module(mx, ctxs, batch, crop)
    metric = mx.metric.Accuracy()
    losses, marks = [], []

    def record(param):
        losses.append(_losses_of(param.locals["self"],
                                 param.locals["data_batch"]))
        _sync(torch, cuda)
        marks.append(time.perf_counter())
        if on_batch is not None:
            on_batch(param)

    kernels.reset_launch_counts()
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=dpc.OPT, eval_metric=metric,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()},
            batch_end_callback=record, fused_step=fused)
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    middle = steps_ms[1:-1] or steps_ms
    a, x = mod.get_params()
    return {"mod": mod, "metric": metric, "losses": losses,
            "launches": kernels.launch_counts(),
            "step_ms": float(np.median(middle)) if middle else None,
            "args": {k: v.asnumpy().copy() for k, v in a.items()},
            "aux": {k: v.asnumpy().copy() for k, v in x.items()}}


def crop_checker(mx, torch, steps, bad):
    """A batch-end callback that holds each card's bound data array to
    its rows of the whole batch's crop on that card, at the first and the
    last step; a mismatch goes into ``bad``."""
    def check(param):
        if param.nbatch not in (0, steps - 1):
            return
        group = param.locals["self"]._exec_group
        batch = param.locals["data_batch"]
        rows = group.batch_size // len(group.execs)
        for k, ex in enumerate(group.execs):
            want = mx.io_cache.materialize_device_feed(
                batch, group.contexts[k]).data[0].handle
            got = ex.arg_dict["data"].handle
            if not bool(torch.equal(got, want[k * rows:(k + 1) * rows])):
                bad.append((param.nbatch, k))
    return check


def first_rows_everywhere():
    """The control's planted fault, for this process only: every card
    loads and crops the first card's rows of a device-feed batch.
    Returns the function that undoes it."""
    from mxnet_tpu_torch.io_cache import load_device_feed
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup as Group

    real = Group.load_feed

    def load_feed(self, data_batch, feeds=None):
        rows = self.batch_size // len(self.execs)
        feeds = feeds or [None] * len(self.execs)
        out = []
        for k, (ex, feed) in enumerate(zip(self.execs, feeds)):
            with self.replicas.device(k):
                out.append(load_device_feed(feed, data_batch, ex._device,
                                            slice(0, rows)))
        return out

    Group.load_feed = load_feed

    def undo():
        Group.load_feed = real
    return undo


def profile_by_card(torch, kernels, fn, reps=2):
    """Over ``reps`` calls of ``fn`` (a replay of a fused step; under
    torch.profiler): the compiled kernels' launches on each card, each
    card's kernel ms a call, and crop_norm's ms a call on each card; and
    the launches on each card of one more call run first in the same
    session and not counted.

    Late in a long process the profiler can miss the first kernels of a
    session's first CUDA graph replay (crop_norm, the graph's first node
    on each card; chip_smoke's ``_profile_steps`` met it in phase 15b).
    So only the kernel events after a spin kernel launched on each card
    after that first call are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = range(torch.cuda.device_count())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        for d in cards:
            torch.cuda.synchronize(d)
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(1000)     # the marker: a kernel of its own
        for _ in range(reps):
            fn()
        for d in cards:
            torch.cuda.synchronize(d)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = {e.device_index: e.time_range.start for e in events
             if "spin_kernel" in e.name}
    names, first, busy, crop = {}, {}, {}, {}
    for e in events:
        d = e.device_index
        if "spin_kernel" in e.name:
            continue
        if d not in marks or e.time_range.start < marks[d]:
            first.setdefault(d, []).append(e.name)
            continue
        ms = float(e.time_range.elapsed_us()) / 1e3
        names.setdefault(d, []).append(e.name)
        busy[d] = busy.get(d, 0.0) + ms
        if "crop_norm_kernel" in e.name:
            crop[d] = crop.get(d, 0.0) + ms
    return ({d: kernels.launches_in(n) for d, n in sorted(names.items())},
            {d: ms / reps for d, ms in sorted(busy.items())},
            {d: ms / reps for d, ms in sorted(crop.items())},
            {d: kernels.launches_in(n) for d, n in sorted(first.items())})


def nccl_eager_against_captured(torch, reps,
                                sizes=(128, 4096, 1 << 20, 1 << 24)):
    """Whether one cross-card sum (``Replicas.sum_``, NCCL) gives the
    same bytes run eagerly and replayed from a :class:`CardGraph`, a size
    (float32 elements) at a time, over seeded values that differ by
    card: ``{size: bool}``."""
    from mxnet_tpu_torch.replicas import CardGraph

    out = {}
    for n in sizes:
        gen = torch.Generator().manual_seed(n)
        host = [torch.randn(n, generator=gen) for _ in reps.devices]
        eager = [h.to(d) for h, d in zip(host, reps.devices)]
        reps.begin()
        reps.sum_(eager)
        bufs = [torch.empty(n, device=d) for d in reps.devices]
        graph = CardGraph(reps, [torch.cuda.Stream(d) for d in reps.devices])

        def body():
            reps.begin()
            reps.sum_(bufs)

        graph.capture(body)
        for b, h in zip(bufs, host):
            b.copy_(h.to(b.device))
        graph.replay()
        torch.cuda.synchronize()
        out[n] = all(bool(torch.equal(a.cpu(), b.cpu()))
                     for a, b in zip(eager, bufs))
        graph.close()
    reps.begin()
    return out


def run_a(torch, mx, kernels, n_cards, per_card=PER_CARD, frames=FRAMES,
          store=STORE, crop=CROP, cpu=False, log=print):
    """Part (a) over ``n_cards``; the record, with ``failed``."""
    cuda = not cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: " + msg)

    batch = per_card * n_cards
    steps = frames // batch
    ctx = mx.cpu if cpu else mx.gpu
    ctxs = [ctx(i) for i in range(n_cards)]
    args0, aux0 = dpc.initial_params(mx, crop)
    rec = {"cards": n_cards, "per_card": per_card, "global_batch": batch,
           "steps": steps, "crop": crop, "store": store, "frames": frames,
           "aug_replicas": n_cards}
    tmp = tempfile.mkdtemp(prefix="dp_feed_")
    prefix = write_cache(os.path.join(tmp, "cache"), frames, store)

    def iterator(scale=SCALE):
        return fed_iter(mx, prefix, batch, crop, n_cards, scale)

    def fit(ctxs_, kvstore, fused, it=None, on_batch=None, depth="0"):
        _progress(log, "(a) fit over %d card(s), %s, fused_step=%s, feed "
                  "depth %s" % (len(ctxs_), kvstore, fused, depth))
        with _env(MXNET_TPU_FEED_DEPTH=depth):
            return fed_fit(torch, mx, kernels, ctxs_, kvstore, fused, args0,
                           aux0, it or iterator(), batch, crop, cuda,
                           on_batch)

    one = fit([ctx(0)], "local", True)
    rec["one_card"] = {"losses": one["losses"], "step_ms": one["step_ms"]}
    del one["mod"]
    floors = {"params": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        moved = fit([ctx(0)], "local", True, iterator(SCALE * scale))
        del moved["mod"]
        floors["params"] = max(floors["params"], dpc._normwise(
            moved["args"], one["args"], args0))
        floors["aux"] = max(floors["aux"], dpc._normwise(
            moved["aux"], one["aux"], aux0))
    rec["float32_floor_normwise"] = floors
    bounds = {w: max(dpc.FLOOR_FACTOR * floors[w], dpc.MIN_BOUND)
              for w in floors}
    rec["bounds"] = bounds

    def hold(what, got):
        out = {}
        for part, start in (("params", args0), ("aux", aux0)):
            key = "args" if part == "params" else "aux"
            dist = dpc._normwise(got[key], one[key], start)
            out[part] = dist
            check(dist <= bounds[part], "%s: %s differ from the one-card "
                  "fit by %g of its update, bound %g" % (what, part, dist,
                                                         bounds[part]))
        return out

    bad_crops = []
    multi = fit(ctxs, "device_sync", None,
                on_batch=crop_checker(mx, torch, steps, bad_crops),
                depth=FEED_DEPTH)
    mod = multi["mod"]
    step = mod._fused_step
    check(mod._fused_step_active, "device_sync did not take the fused step")
    check(not bad_crops, "a card's crop differs from its rows of the "
          "one-card crop at (step, card) %s" % bad_crops[:5])
    rec["crops_bit_equal_to_one_card_rows"] = not bad_crops
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    want = ({"eager_steps": 1, "captures": 1, "dispatches": steps - 1}
            if cuda else {"eager_steps": steps, "captures": 0,
                          "dispatches": 0})
    check(counters == want, "fused counters %s, want %s" % (counters, want))
    rec["multi"] = {"losses": multi["losses"], "step_ms": multi["step_ms"],
                    "counters": counters,
                    "vs_one_card_normwise": hold("fused", multi)}
    bad = dpc.replicas_identical(mod)
    rec["replicas_identical"] = not bad
    check(not bad, "replicas differ from the first at %s" % bad[:5])
    feeds = step._feed
    rec["uint8_bytes_a_batch_a_card"] = int(feeds[0].bufs["x"].numel())
    rec["float32_crop_bytes_a_batch_a_card"] = int(
        4 * mod._exec_group.execs[0].arg_dict["data"].handle.numel())
    if cuda:
        fed = next(iter(iterator()))
        metric = multi["metric"]
        launches, busy, crop_ms, first = profile_by_card(
            torch, kernels, lambda: step.step(fed, metric))
        rec["launches_per_card_2_replays"] = launches
        # the session's first replay, not counted: whether the profiler
        # saw its first node on each card
        rec["launches_per_card_first_replay_uncounted"] = first
        for d in range(n_cards):
            got = {k: launches.get(d, {}).get(k, 0) for k in PER_REPLAY_FEED}
            want_d = {k: 2 * v for k, v in PER_REPLAY_FEED.items()}
            check(got == want_d, "card %d ran %s in two replays, want %s"
                  % (d, got, want_d))
        rec["kernel_ms_a_replay_by_card"] = busy
        rec["crop_norm_ms_a_replay_by_card"] = crop_ms
        rec["crop_norm_share_card0"] = crop_ms.get(0, 0.0) / busy[0]
        rec["device_ms_a_replay_card0"] = dpc._event_ms(
            torch, lambda: step.step(fed, metric))
        rec["img_per_s"] = batch * 1e3 / multi["step_ms"]
        rec["img_per_s_one_card"] = batch * 1e3 / one["step_ms"]
        rec["nccl_eager_equals_captured"] = nccl_eager_against_captured(
            torch, mod._exec_group.replicas)
    del mod, step, feeds
    multi.pop("mod")
    classic = fit(ctxs, "device_sync", False)
    del classic["mod"]
    unequal = [k for k in multi["args"]
               if not np.array_equal(multi["args"][k], classic["args"][k])]
    unequal += [k for k in multi["aux"]
                if not np.array_equal(multi["aux"][k], classic["aux"][k])]
    same = not unequal and multi["losses"] == classic["losses"]
    rec["fused_equals_classic"] = same
    check(same, "the fused fit differs from the classic loop at %s "
          "(losses %s / %s)" % (unequal[:5], multi["losses"],
                                classic["losses"]))
    with _env(MXNET_TPU_MESH_FSDP=n_cards):
        sharded = fit(ctxs, "device_sync", None)
    check(sharded["mod"]._exec_group.shards is not None,
          "MXNET_TPU_MESH_FSDP sharded nothing")
    rec["fsdp"] = {"losses": sharded["losses"],
                   "vs_one_card_normwise": hold("fsdp", sharded)}
    del sharded["mod"]
    undo = first_rows_everywhere()
    try:
        ctl = fit(ctxs, "device_sync", None)
    finally:
        undo()
    del ctl["mod"]
    dist = {"params": dpc._normwise(ctl["args"], one["args"], args0),
            "aux": dpc._normwise(ctl["aux"], one["aux"], aux0)}
    caught = dist["params"] > bounds["params"] or dist["aux"] > bounds["aux"]
    rec["control"] = {"fault": "every card crops the first card's rows",
                      "vs_one_card_normwise": dist, "caught": caught}
    check(caught, "the control (every card crops the first card's rows) "
          "stayed within the bound: %s" % dist)
    os.remove(prefix + ".data")
    rec["failed"] = failed
    return rec


# ---------------------------------------------------------------------------
# (b) Dropout
# ---------------------------------------------------------------------------
def tap_dropout(torch):
    """Copy each Dropout's input and output, in train mode, into buffers
    of its own (one a node a replica, keyed by the replica's generator,
    allocated at the first step, so a captured graph writes the same ones
    on every replay). Returns the taps ``{(node, generator id): (input,
    output, p)}`` and the function that undoes the tap."""
    from mxnet_tpu_torch.ops import nn

    real = nn.Dropout.apply
    taps = {}

    def apply(self, ctx, inputs, aux):
        out, new_aux = real(self, ctx, inputs, aux)
        if ctx.is_train and self.p > 0.0:
            x, y = inputs[0].detach(), out[0].detach()
            key = (id(self), id(ctx.rng))
            if key not in taps:
                taps[key] = (torch.empty_like(x), torch.empty_like(y),
                             self.p)
            with torch.no_grad():
                taps[key][0].copy_(x)
                taps[key][1].copy_(y)
        return out, new_aux

    nn.Dropout.apply = apply

    def undo():
        nn.Dropout.apply = real
    return taps, undo


def masks_of(taps, execs):
    """Each replica's keep masks (one a Dropout node, in the order of
    the nodes) and where they are known (the input is not zero), as host
    arrays, with the node's p: ``[[(keep, known, p), ...] a replica]``
    (``execs``: the replicas' executors)."""
    out = []
    for ex in execs:
        gen = id(ex._generator())
        out.append([((y != 0).cpu().numpy(), (x != 0).cpu().numpy(), p)
                    for (node, g), (x, y, p) in sorted(
                        taps.items(), key=lambda kv: kv[0][0])
                    if g == gen])
    return out


def disagreement(a, b):
    """The share of the positions known in both masks where they
    differ, over every Dropout node."""
    n = diff = 0
    for (ka, na, _), (kb, nb, _) in zip(a, b):
        both = na & nb
        n += int(both.sum())
        diff += int((both & (ka != kb)).sum())
    return diff / n if n else 0.0


def same_seed_everywhere():
    """The control's planted fault, for this process only: every
    executor that takes a seed from mx.random's stream takes the first
    one it gave, so every card draws from a clone of the first card's
    generator. Returns the function that undoes it."""
    from mxnet_tpu_torch import random as rnd

    real = rnd.next_seed
    first = []

    def one_seed():
        if not first:
            first.append(real())
        return first[0]

    rnd.next_seed = one_seed

    def undo():
        rnd.next_seed = real
    return undo


def start_params(mx, sym, side, seed=0):
    """Xavier params of ``sym`` from ``seed`` (numpy), bound on the CPU."""
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (1, 3, side, side))],
             label_shapes=[("softmax_label", (1,))], for_training=True)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    args, aux = mod.get_params()
    return ({k: v.asnumpy().copy() for k, v in args.items()},
            {k: v.asnumpy().copy() for k, v in aux.items()})


def model_fit(torch, mx, kernels, sym, ctxs, fused, images, labels, batch,
              taps, start):
    """3 steps of ``sym`` through fit from ``start`` (params, aux) after
    ``mx.random.seed(0)``: losses, outputs, params, aux, each step's
    masks, the module and the wrappers' launch counts."""
    taps.clear()
    masks, losses, outs = [], [], []

    def record(param):
        mod = param.locals["self"]
        losses.append(_losses_of(mod, param.locals["data_batch"]))
        outs.append(mod.get_outputs()[0].asnumpy().copy())
        masks.append(masks_of(taps, mod._exec_group.execs))

    mx.random.seed(0)
    mod = mx.mod.Module(sym, context=ctxs)
    kernels.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=batch),
            num_epoch=1, kvstore="device_sync", optimizer="sgd",
            optimizer_params=dpc.OPT,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in start[0].items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in start[1].items()},
            batch_end_callback=record, fused_step=fused)
    a, x = mod.get_params()
    return {"mod": mod, "losses": losses, "masks": masks, "outputs": outs,
            "launches": kernels.launch_counts(),
            "args": {k: v.asnumpy().copy() for k, v in a.items()},
            "aux": {k: v.asnumpy().copy() for k, v in x.items()}}


def run_b(torch, mx, kernels, n_cards, per_card=PER_CARD, models=None,
          cpu=False, log=print):
    """Part (b) over ``n_cards``; ``models`` ``{name: side}`` (default
    every network at its full input); the record, with ``failed``. On
    one card (chip_smoke's 21a) it holds the fused fit to the classic
    loop, outputs included, and each replay's masks to be fresh; the
    checks across cards and the control need two."""
    cuda = not cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: " + msg)

    batch = per_card * n_cards
    ctx = mx.cpu if cpu else mx.gpu
    ctxs = [ctx(i) for i in range(n_cards)]
    taps, undo = tap_dropout(torch)
    rec = {"cards": n_cards, "per_card": per_card, "global_batch": batch,
           "steps": MODEL_STEPS, "models": {}}
    try:
        for name, fn, kwargs, side, k3 in MODELS:
            if models is not None and name not in models:
                continue
            side = (models or {}).get(name) or side
            sym = getattr(mx.models, fn)(num_classes=1000, **kwargs)
            rng = np.random.default_rng(sum(map(ord, name)))
            images = rng.standard_normal((MODEL_STEPS * batch, 3, side, side),
                                         dtype=np.float32)
            labels = rng.integers(0, 1000, MODEL_STEPS * batch).astype(
                np.float32)

            start = start_params(mx, sym, side)

            def fit(fused):
                _progress(log, "(b) %s over %d card(s), fused_step=%s"
                          % (name, n_cards, fused))
                return model_fit(torch, mx, kernels, sym, ctxs, fused,
                                 images, labels, batch, taps, start)

            out = {"input": [batch, 3, side, side]}
            fused = fit(None)
            mod = fused.pop("mod")
            step = mod._fused_step
            counters = {"eager_steps": step.eager_steps,
                        "captures": step.captures,
                        "dispatches": step.dispatches}
            want = ({"eager_steps": 1, "captures": 1,
                     "dispatches": MODEL_STEPS - 1} if cuda else
                    {"eager_steps": MODEL_STEPS, "captures": 0,
                     "dispatches": 0})
            check(counters == want, "%s: fused counters %s, want %s"
                  % (name, counters, want))
            out["counters"] = counters
            m = fused["masks"]
            between = [disagreement(m[-2][k], m[-1][k])
                       for k in range(n_cards)]
            across = [disagreement(m[-1][0], m[-1][k])
                      for k in range(1, n_cards)]
            out["mask_disagreement_between_replays"] = between
            out["mask_disagreement_across_cards"] = across
            check(min(between) >= MIN_DISAGREE, "%s: a card's masks "
                  "repeat between replays: %s" % (name, between))
            check(not across or min(across) >= MIN_DISAGREE, "%s: masks "
                  "differ across cards by %s only" % (name, across))
            rates = []
            for per_node in m[-1]:
                for keep, known, p in per_node:
                    r = float((keep & known).sum() / known.sum())
                    rates.append(r)
                    check(abs(r - (1 - p)) <= KEEP_SE * np.sqrt(
                        p * (1 - p) / known.sum()), "%s: keep rate %g "
                        "over %d positions, p %g" % (name, r,
                                                     known.sum(), p))
            out["keep_rate_by_card_and_node"] = rates
            if cuda:
                data = mx.io.DataBatch(
                    [mx.nd.array(images[:batch], ctx=mx.cpu())],
                    [mx.nd.array(labels[:batch], ctx=mx.cpu())])
                metric = mx.metric.Accuracy()
                step.step(data, metric)
                launches, busy, _, _ = profile_by_card(
                    torch, kernels, lambda: step.step(data, metric))
                out["launches_per_card_2_replays"] = launches
                out["kernel_ms_a_replay_by_card"] = busy
                for d in range(n_cards):
                    got = launches.get(d, {}).get("conv_gemm", 0)
                    check(got == 2 * k3, "%s: card %d ran K3 %d times in "
                          "two replays, want %d" % (name, d, got, 2 * k3))
            del mod, step
            classic = fit(False)
            del classic["mod"]
            unequal = [k for part in ("args", "aux")
                       for k in fused[part]
                       if not np.array_equal(fused[part][k],
                                             classic[part][k])]
            unequal += ["outputs of step %d" % i for i, (a, b) in enumerate(
                zip(fused["outputs"], classic["outputs"]))
                if not np.array_equal(a, b)]
            same = not unequal and fused["losses"] == classic["losses"]
            out["fused_equals_classic"] = same
            check(same, "%s: the fused fit differs from the classic loop "
                  "at %s (losses %s / %s)" % (name, unequal[:5],
                                              fused["losses"],
                                              classic["losses"]))
            out["losses"] = fused["losses"]
            if name == MODELS[0][0] and n_cards > 1:
                plant = same_seed_everywhere()
                try:
                    ctl = fit(None)
                finally:
                    plant()
                del ctl["mod"]
                m = ctl["masks"]
                across = [disagreement(m[-1][0], m[-1][k])
                          for k in range(1, n_cards)]
                caught = min(across) < MIN_DISAGREE
                out["control"] = {
                    "fault": "every card draws from a clone of the first "
                             "card's generator",
                    "mask_disagreement_across_cards": across,
                    "caught": caught}
                check(caught, "%s: the control (cloned generators) passed "
                      "\"masks differ across cards\": %s" % (name, across))
            rec["models"][name] = out
            if cuda:
                torch.cuda.empty_cache()
    finally:
        undo()
    rec["failed"] = failed
    return rec


def run(torch, mx, kernels, n_cards, part="ab", **kw):
    """Parts ``part`` over ``n_cards``: ``{"a": record, "b": record,
    "failed": [...]}``."""
    out = {"failed": []}
    if "a" in part:
        out["a"] = run_a(torch, mx, kernels, n_cards,
                         **{k: v for k, v in kw.items() if k != "models"})
        out["failed"] += ["(a) " + f for f in out["a"]["failed"]]
    if "b" in part:
        out["b"] = run_b(torch, mx, kernels, n_cards,
                         per_card=kw.get("per_card", PER_CARD),
                         models=kw.get("models"), cpu=kw.get("cpu", False),
                         log=kw.get("log", print))
        out["failed"] += ["(b) " + f for f in out["b"]["failed"]]
    return out


def summary(rec, card):
    """The printed lines of a run."""
    lines = []
    a = rec.get("a")
    if a is not None and "img_per_s" in a:
        lines.append(
            "(a) %d cards x %d, ResNet-50 NHWC f32 from the uint8 cache: "
            "crops bit-equal to the one-card rows %s, fused == classic %s, "
            "vs one card %.3g / %.3g (bounds %.3g / %.3g), fsdp %.3g / "
            "%.3g; %.1f img/s against %.1f on one card; uint8 %d bytes a "
            "batch a card against %d of float32; card 0 device %.3f ms a "
            "replay, crop_norm %.4f ms (%.2f%% of card 0's kernel time); "
            "crop_norm ms a replay by card %s; crop_norm in the session's "
            "uncounted first replay by card %s; control %.3g, caught %s  "
            "[%s]"
            % (a["cards"], a["per_card"],
               a["crops_bit_equal_to_one_card_rows"],
               a["fused_equals_classic"],
               a["multi"]["vs_one_card_normwise"]["params"],
               a["multi"]["vs_one_card_normwise"]["aux"],
               a["bounds"]["params"], a["bounds"]["aux"],
               a["fsdp"]["vs_one_card_normwise"]["params"],
               a["fsdp"]["vs_one_card_normwise"]["aux"], a["img_per_s"],
               a["img_per_s_one_card"], a["uint8_bytes_a_batch_a_card"],
               a["float32_crop_bytes_a_batch_a_card"],
               a["device_ms_a_replay_card0"],
               a["crop_norm_ms_a_replay_by_card"].get(0, 0.0),
               100 * a["crop_norm_share_card0"],
               ["%.4f" % v for v in
                a["crop_norm_ms_a_replay_by_card"].values()],
               {d: c["crop_norm"] for d, c in
                a["launches_per_card_first_replay_uncounted"].items()},
               a["control"]["vs_one_card_normwise"]["params"],
               a["control"]["caught"], card))
    b = rec.get("b")
    for name, m in (b or {}).get("models", {}).items():
        lines.append(
            "(b) %s %s: captures %d, masks differ between replays by %s "
            "and across cards by %s, keep rates %s, fused == classic %s%s"
            "  [%s]" % (name, "x".join(map(str, m["input"])),
                        m["counters"]["captures"],
                        ["%.3f" % v for v in
                         m["mask_disagreement_between_replays"]],
                        ["%.3f" % v for v in
                         m["mask_disagreement_across_cards"]],
                        ["%.4f" % v for v in
                         m["keep_rate_by_card_and_node"]],
                        m["fused_equals_classic"],
                        "; control %s caught %s" % (
                            ["%.3f" % v for v in m["control"][
                                "mask_disagreement_across_cards"]],
                            m["control"]["caught"])
                        if "control" in m else "", card))
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="cards (default: every visible one)")
    parser.add_argument("--part", default="ab", help="a, b or ab")
    parser.add_argument("--per-card", type=int, default=PER_CARD)
    parser.add_argument("--frames", type=int, default=FRAMES)
    parser.add_argument("--store", type=int, default=0,
                        help="stored side (default: 256, or crop * 8 / 7)")
    parser.add_argument("--crop", type=int, default=CROP)
    parser.add_argument("--models", default="",
                        help="name:side,... (default: every network at "
                        "its full input)")
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
            print("torch_dp_feed_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = opts.cards or (torch.cuda.device_count() if not opts.cpu else 4)
    card = dpc.card_line() if not opts.cpu else "cpu"
    print(card)
    models = None
    if opts.models:
        models = {}
        for item in opts.models.split(","):
            name, _, side = item.partition(":")
            models[name] = int(side) if side else None
    store = opts.store or (STORE if opts.crop == CROP
                           else -(-opts.crop * 8 // 7))
    t0 = time.perf_counter()
    rec = run(torch, mx, kernels, n, opts.part, per_card=opts.per_card,
              frames=opts.frames, store=store, crop=opts.crop, cpu=opts.cpu,
              models=models)
    rec.update(card=card, seconds=time.perf_counter() - t0,
               torch=torch.__version__)
    for line in summary(rec, card):
        print(line)
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(json.dumps(rec, default=str))
    return 1 if rec["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
