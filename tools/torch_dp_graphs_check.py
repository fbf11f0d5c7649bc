#!/usr/bin/env python3
"""Every graph that trains on one card trains over several: the PyTorch
port's last item-10a paths in one process over every visible card,
each against one card at the same global batch.

    python3 tools/torch_dp_graphs_check.py              # every visible card
    python3 tools/torch_dp_graphs_check.py --paths ab --report g.json
    python3 tools/torch_dp_graphs_check.py --cpu --cards 4 --per-card 2 \\
        --image 32 --lm small --rcnn-hw 64,96 --fc-width 256

Float32 with TF32 off unless a path says otherwise; seeded weights and
data, nothing downloaded. The bound of a fit against one card is, as in
tools/torch_dp_check.py, four floors (at least 1e-4), normwise as a
share of the one-card fit's update: the floor is the larger distance the
one-card fit moves when its input is moved by one rounding (the images,
or the LM's embedding, scaled by 1 +- 2^-23); (c) takes its floor from
reordering the batch instead.

(a) ResNet-50 NHWC (1000 classes, 224 x 224, the residual blocks' last
    BatchNorm gamma at 0.25), ``--per-card`` x the cards, the fused step
    with ``MXNET_TPU_NUMWATCH=1`` and ``MXNET_TPU_NUMWATCH_GUARD=skip``,
    at dp N and then at fsdp N: three batches, the second with NaN in
    card 2's rows only (the last card's with fewer than three). After it
    every card's weights (its shards under fsdp) and optimizer states
    are bit-equal to before it, the pack's skip count is 1 on every card,
    and each fit captured once; the fsdp pack equals the dp pack at the
    first two steps, which fold the same weights (counts and stamps
    exact, sums rtol 1e-5); at the third, whose weights differ by the two
    exchanges' summation orders, the two share the nonfinite counts and
    the stamps, and each pack equals the whole-array fold of its own
    fit's step recomputed on the first card (counts exact, sums rtol
    1e-5), with the two fits' differing inputs recorded; a replay
    launches K3 105, K4 53 and K5 53 times on every card.
(b) the same network and batch, fused, under ``MXNET_BACKWARD_DO_MIRROR=1``
    against the plain four-card fit: params, moving statistics and losses
    bit-equal; K4 106 a replay on every card (53 recomputed); the peak
    allocation above the start a card and the device ms a replay on card
    0 of both.
(c) the same network under ``compute_dtype="bfloat16"``: the fused fit
    bit-equal to the classic loop over the cards, and after its first
    step within the bfloat16 bound of one card's bf16 first step at the
    global batch, with cuDNN off on both sides (cuDNN's algorithm for a
    convolution depends on the batch, and its bfloat16 rows with it: that
    distance is recorded), within four floors, the floor being how far
    the same batch reordered (rows rolled by a card's share, and
    reversed) moves one card's first step; the bound must stay below
    0.5, so that a fit that never moved (it reads 1.0) or a halved
    update fails it.
(d) the bucketed LSTM LM of chip_smoke's phase 12a (lstm_unroll, 2 x
    200, vocabulary 10000, buckets 10-60, a batch a bucket in a seeded
    order), ``BucketingModule`` forward, backward and update over the
    cards at ``--per-card`` x the cards, classic loop: the six buckets'
    modules share one set of arrays a card; the joined time-major
    outputs within rtol 1e-5 of one card's at the global batch and the
    NLL metric within rel 1e-5; the params within the bound.
(e) Fast R-CNN on VGG-16 (chip_smoke's phase 13 graph) at 600 x 1000,
    4 images x 128 rois a card's image (the rois of every card name the
    images of the others too), the classic loop over the cards against
    one card: the cards run the port's own Dropout (each card its own
    generator), a tap in this process records each card's keep masks and
    the one-card fits take those masks joined over the global rows, so
    both sides drop the same units; the params within the bound;
    roi_pool 2 and K3 17 launches a step on every card (torch.profiler's
    kernel events by device).

A replay's launches on a card are counted from torch.profiler's kernel
events; a session whose counts miss on a card (the profiler can drop a
record, a replay cannot skip a node) is counted once more, and both are
recorded. Each path prints the host ms a step (five steps after each
fit, every card synchronised) and, where fused, the device ms a replay
on card 0; nothing is claimed from them. ``--cpu`` rehearses the
same paths over CPU contexts (no timing, no profiler). Imports neither
jax nor the JAX package.
"""
import argparse
import faulthandler
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_check as dpc  # noqa: E402
import torch_dp_feed_check as dfc  # noqa: E402

PER_CARD = 32
IMAGE = 224
STEPS = 3
OPT = dpc.OPT
FLOOR_FACTOR = dpc.FLOOR_FACTOR
MIN_BOUND = dpc.MIN_BOUND
PER_REPLAY = dpc.PER_REPLAY
PACK_RTOL = 1e-5
LM_OUT_RTOL = 1e-5
LM_METRIC_REL = 1e-5
RCNN_IMAGES_A_CARD = 1
RCNN_ROIS_AN_IMAGE = 128
RCNN_STEPS = 2
RCNN_HW = (600, 1000)
RCNN_K3_STEP = 17
F32_ROUNDING = 2.0 ** -23
BF16_SEPARATES = 0.5


def _cs():
    """chip_smoke's model builders (the repo's root is on the path)."""
    import chip_smoke

    return chip_smoke


def _sync(torch, cuda):
    """Wait for every card (the classic loop over several queues work on
    each)."""
    if cuda:
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _ctxs(mx, n, cpu):
    return [mx.cpu(i) if cpu else mx.gpu(i) for i in range(n)]


def _one(mx, cpu):
    return [mx.cpu() if cpu else mx.gpu(0)]


def _host(d):
    return {k: v.asnumpy().copy() for k, v in d.items()}


def _bound(floor):
    return max(FLOOR_FACTOR * floor, MIN_BOUND)


def _median(xs):
    return float(np.median(xs)) if xs else None


# ---------------------------------------------------------------------------
# ResNet-50 fits: (a), (b), (c)
# ---------------------------------------------------------------------------
def resnet_fit(torch, mx, kernels, ctxs, args, aux, images, labels, batch,
               cuda, fused, dtype=None, on_batch=None, timed=True):
    """Module.fit of ResNet-50 NHWC over ``ctxs`` (fused or the classic
    loop, ``device_sync`` over several): the module, its step, the losses,
    host ms a step (``timed``), params and aux after it, the peak
    allocation above the start a card (GB) and the wrappers' launch
    counts."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    kw = {} if dtype is None else {"compute_dtype": dtype}
    mod = mx.mod.Module(sym, context=ctxs, **kw)
    mod.bind(data_shapes=[("data", (batch,) + images.shape[1:])],
             label_shapes=[("softmax_label", (batch,))])
    losses = []

    def cb(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = labels[param.nbatch * batch:(param.nbatch + 1) * batch]
        losses.append(float(-np.log(np.maximum(probs.astype(np.float64)[
            np.arange(batch), lab.astype(int)], 1e-300)).mean()))
        if on_batch is not None:
            on_batch(param)

    devices = [c.torch_device() for c in ctxs]
    start = []
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            start.append(torch.cuda.memory_allocated(d))
    kernels.reset_launch_counts()
    metric = mx.metric.Accuracy()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=batch),
            num_epoch=1, kvstore="device_sync" if len(ctxs) > 1 else "local",
            optimizer="sgd", optimizer_params=OPT, eval_metric=metric,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()},
            batch_end_callback=cb, fused_step=fused)
    a, x = mod.get_params()
    step = mod._fused_step
    out = {"mod": mod, "step": step, "metric": metric,
           "losses": losses, "launches": dict(kernels.launch_counts()),
           "args": _host(a), "aux": _host(x), "step_ms": None,
           "counters": None if step is None else {
               "eager_steps": step.eager_steps, "captures": step.captures,
               "dispatches": step.dispatches}}
    if cuda:
        out["peak_above_start_gb"] = [
            (torch.cuda.max_memory_allocated(d) - s) / 1e9
            for d, s in zip(devices, start)]
    if cuda and timed:
        # the fit's own steps include the first (eager) one and the
        # capture: time steps after it, on its first batch
        data = _batch0(mx, images, labels, batch)
        if fused:
            out["step_ms"] = host_step_ms(
                torch, lambda: step.step(data, metric))
        else:
            out["step_ms"] = host_step_ms(
                torch, lambda: (mod.forward_backward(data), mod.update()))
    return out


def host_step_ms(torch, fn, reps=5):
    """The median host ms of ``reps`` calls of ``fn``, the cards
    synchronised after each."""
    fn()
    _sync(torch, True)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(torch, True)
        times.append(1e3 * (time.perf_counter() - t0))
    return _median(times)


_INIT = {}


def initial_params(mx, image):
    """tools/torch_dp_check.py's ResNet-50 start, drawn once a size."""
    if image not in _INIT:
        _INIT[image] = dpc.initial_params(mx, image)
    return _INIT[image]


def _batch0(mx, images, labels, batch):
    return mx.io.DataBatch([mx.nd.array(images[:batch], ctx=mx.cpu())],
                           [mx.nd.array(labels[:batch], ctx=mx.cpu())])


def _per_card_replay(torch, kernels, step, batch, metric, want, n):
    """A replay's compiled-kernel launches on each card: two replays
    counted after an uncounted one (``profile_by_card``), halved. The
    profiler can drop a kernel record (PERF.md, Queue C 15),
    while a replay runs every node of its graph: where a card's count
    misses ``want``, one more session counts again, and the first
    session's counts are kept beside it. Returns ``(per card, the
    uncounted replay's, the missed session's or None)``."""
    missed = None
    for _ in range(2):
        per, _, _, first = dfc.profile_by_card(
            torch, kernels, lambda: step.step(batch, metric))
        per = {d: {k: c.get(k, 0) // 2 for k in PER_REPLAY}
               for d, c in per.items()}
        first = {d: {k: c.get(k, 0) for k in PER_REPLAY}
                 for d, c in first.items()}
        if all(per.get(d) == want for d in range(n)):
            break
        if missed is None:
            missed = per
    return per, first, missed


def _card_state(mod):
    """Every card's weights (its shards under fsdp) and optimizer state
    tensors, cloned on their cards."""
    from mxnet_tpu_torch.optimizer import _state_tensors

    out = []
    for updater, items in zip(mod._updaters, mod._update_items()):
        for i, _, w in items:
            out.append(w.handle.clone())
            out.extend(t.clone() for t in _state_tensors(
                updater.states.get(i)))
    return out


def _worst_rel(a, b):
    """The largest relative difference of ``b`` from ``a`` and its row;
    a NaN on either side counts as infinite, so it fails any bound."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-30)
    rel[np.isnan(rel)] = np.inf
    i = int(np.argmax(rel))
    return float(rel[i]), i


def _whole_weights(mod, names):
    """The weights of ``names`` over their whole shapes on the first
    card (joined from the master shards under fsdp), cloned."""
    group = mod._exec_group
    return [group.param_value(n).clone() for n in names]


def _own_fold(mod, names, w_pre):
    """The step's per-tensor columns (``NumWatch.partials``) recomputed
    on the first card over the fit's own whole arrays: the weights
    before the step (``w_pre``), the summed gradients (joined from their
    shards under fsdp) and the weights after it. Also the gradients as
    host arrays."""
    from mxnet_tpu_torch.numwatch import NumWatch

    group = mod._exec_group
    rex = group.replicated
    grads = dict(zip(rex.arg_names, rex.grad_arrays))
    w_new = [group.param_value(n) for n in names]
    dev = w_new[0].device
    gs = [grads[n].handle.to(dev) for n in names]
    part = NumWatch.partials([w.to(dev) for w in w_pre], gs, w_new)
    return part.cpu().numpy(), [g.cpu().numpy() for g in gs]


def path_a(torch, mx, kernels, n, per_card, image, cuda, check):
    """The skip guard and the fold at dp N, then fsdp N."""
    batch = per_card * n
    rng = np.random.RandomState(0)
    images = rng.randn(STEPS * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, STEPS * batch).astype(np.float32)
    poisoned = min(2, n - 1)
    images[batch + poisoned * per_card:batch + (poisoned + 1) * per_card] \
        = np.nan
    args, aux = initial_params(mx, image)
    rec = {"poisoned_card": poisoned}
    packs, third = {}, {}
    env = {"MXNET_TPU_NUMWATCH": "1", "MXNET_TPU_NUMWATCH_GUARD": "skip",
           "MXNET_TPU_NUMWATCH_EVERY_N": "1"}
    for mesh in ("dp", "fsdp"):
        seen = {"packs": [], "skips": []}

        def on_batch(param):
            mod = param.locals["self"]
            plane = mod._fused_step._numwatch
            _sync(torch, cuda)
            seen["packs"].append(plane._pack.cpu().numpy().copy())
            seen["skips"].append([int(p[-1, 3]) for p in
                                  [plane._pack.cpu().numpy()]
                                  + [c.cpu().numpy() for c in
                                     plane._copies.values()]])
            if param.nbatch == 0:
                seen["before"] = _card_state(mod)
            if param.nbatch == 1:
                seen["equal_after_nan"] = all(
                    bool(torch.equal(a, b)) for a, b in
                    zip(seen["before"], _card_state(mod)))
                seen["before"] = None
                seen["w_pre"] = _whole_weights(mod, plane.names)
            if param.nbatch == 2:
                w_pre = seen.pop("w_pre")
                seen["own"], seen["grads"] = _own_fold(mod, plane.names,
                                                       w_pre)
                seen["w_pre_host"] = [w.cpu().numpy() for w in w_pre]

        menv = dict(env, MXNET_TPU_MESH_FSDP=str(n)) if mesh == "fsdp" \
            else env
        with dfc._env(**menv):
            fit = resnet_fit(torch, mx, kernels, _ctxs(mx, n, not cuda),
                             args, aux, images, labels, batch, cuda, True,
                             on_batch=on_batch)
        step = fit["step"]
        r = {"step_ms": fit["step_ms"],
             "state_bit_equal_after_nan_batch": seen["equal_after_nan"],
             "skips_by_step_and_card": seen["skips"],
             "counters": fit["counters"],
             "sharded": fit["mod"]._exec_group.shards is not None}
        packs[mesh] = seen["packs"]
        third[mesh] = seen
        check(seen["equal_after_nan"], "(a) %s: a card's weights or "
              "optimizer states moved on the NaN batch" % mesh)
        check([s for s in seen["skips"][1]] == [1] * n
              and all(s == [1] * n for s in seen["skips"][2:]),
              "(a) %s: skips by step and card %s, want 1 on every card "
              "from the NaN batch on" % (mesh, seen["skips"]))
        check(r["sharded"] == (mesh == "fsdp"), "(a) %s: sharded %s"
              % (mesh, r["sharded"]))
        want = ({"eager_steps": 1, "captures": 1, "dispatches": STEPS - 1}
                if cuda else {"eager_steps": STEPS, "captures": 0,
                              "dispatches": 0})
        check(r["counters"] == want, "(a) %s: counters %s, want %s"
              % (mesh, r["counters"], want))
        if cuda:
            data = _batch0(mx, images, labels, batch)
            per, first, missed = _per_card_replay(
                torch, kernels, step, data, fit["metric"], PER_REPLAY, n)
            r["launches_a_replay_by_card"] = per
            r["launches_first_replay_uncounted"] = first
            r["launches_session_recounted"] = missed
            for d in range(n):
                check(per.get(d) == PER_REPLAY, "(a) %s: card %d ran %s a "
                      "replay, want %s" % (mesh, d, per.get(d), PER_REPLAY))
            r["device_ms_a_replay_card0"] = dpc._event_ms(
                torch, lambda: step.step(data, fit["metric"]))
        rec[mesh] = r
        del fit, step
    from mxnet_tpu_torch import numwatch as nw

    exact = [nw.G_NONFIN, nw.G_ZERO, nw.W_NONFIN, nw.FB_PARAM, nw.FB_GRAD]
    close = [nw.G_SUMSQ, nw.G_MAXABS, nw.W_SUMSQ, nw.UPD_SUMSQ]
    sticky = [nw.G_NONFIN, nw.W_NONFIN, nw.FB_PARAM, nw.FB_GRAD]
    counts = [nw.G_NONFIN, nw.G_ZERO, nw.W_NONFIN]
    # the first step folds the same weights and batch in both fits, the
    # second (the NaN batch) NaN gradients over the same weights: there
    # the fsdp pack must equal the dp pack. The third step's weights are
    # one update apart by the exchanges' summation orders (all-reduce
    # against reduce-scatter), so there the two packs share only the
    # nonfinite counts, the stamps and the META step and skips; each
    # pack is held instead against the whole-array fold of its own fit's
    # step (counts exact), and how far the two fits' inputs differ is
    # recorded as the witness
    worst, same, by_col = 0.0, True, {}
    for step, (d, f) in enumerate(zip(packs["dp"], packs["fsdp"])):
        cols = exact if step < 2 else sticky
        same &= bool(np.array_equal(d[:-1, cols], f[:-1, cols])
                     and np.array_equal(d[-1, [0, 2, 3]], f[-1, [0, 2, 3]]))
        for col in close + [nw.G_ZERO]:
            r, i = _worst_rel(d[:-1, col], f[:-1, col])
            key = "%s_step%d" % (nw.COLS[col], step + 1)
            by_col[key] = [r, i, float(d[i, col]), float(f[i, col])]
            if step < 2 and col != nw.G_ZERO:
                worst = max(worst, r)
    rec["fsdp_pack_counts_equal_dp"] = same
    rec["fsdp_pack_sums_worst_rel"] = worst
    rec["fsdp_pack_worst_rel_row_dp_fsdp_by_column"] = by_col
    check(same, "(a) the fsdp pack's counts or stamps differ from dp's")
    check(worst <= PACK_RTOL, "(a) the fsdp pack's sums differ from dp's "
          "by %g relative at the first two steps (bound %g)"
          % (worst, PACK_RTOL))
    own = {}
    for mesh in ("dp", "fsdp"):
        pack, mine = packs[mesh][2][:-1], third[mesh]["own"]
        eq = bool(np.array_equal(pack[:, counts], mine[:, counts]))
        sums = max(_worst_rel(mine[:, c], pack[:, c])[0] for c in close)
        own[mesh] = {"counts_equal": eq, "sums_worst_rel": sums,
                     "g_zero_total": float(mine[:, nw.G_ZERO].sum())}
        check(eq, "(a) %s: the third step's pack counts differ from the "
              "whole-array fold of its own step" % mesh)
        check(sums <= PACK_RTOL, "(a) %s: the third step's pack sums "
              "differ from the whole-array fold of its own step by %g "
              "relative (bound %g)" % (mesh, sums, PACK_RTOL))
    rec["step3_pack_vs_own_whole_fold"] = own
    wd, wf = third["dp"]["w_pre_host"], third["fsdp"]["w_pre_host"]
    gd, gf = third["dp"]["grads"], third["fsdp"]["grads"]
    rec["step3_inputs_dp_vs_fsdp"] = {
        "weights_elements_differ": int(sum(np.sum(a != b)
                                           for a, b in zip(wd, wf))),
        "weights_max_abs_diff": float(max(np.max(np.abs(a - b))
                                          for a, b in zip(wd, wf))),
        "elements": int(sum(a.size for a in wd)),
        "grad_zero_pattern_differs": int(sum(np.sum((a == 0) != (b == 0))
                                             for a, b in zip(gd, gf)))}
    return rec


def _bit_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def path_b(torch, mx, kernels, n, per_card, image, cuda, check):
    """The mirrored backward against the plain four-card fit."""
    batch = per_card * n
    rng = np.random.RandomState(1)
    images = rng.randn(STEPS * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, STEPS * batch).astype(np.float32)
    args, aux = initial_params(mx, image)
    data = _batch0(mx, images, labels, batch)
    rec = {}
    fits = {}
    for mirror in ("0", "1"):
        with dfc._env(MXNET_BACKWARD_DO_MIRROR=mirror):
            fit = resnet_fit(torch, mx, kernels, _ctxs(mx, n, not cuda),
                             args, aux, images, labels, batch, cuda, True)
        r = {"step_ms": fit["step_ms"], "losses": fit["losses"],
             "peak_above_start_gb": fit.get("peak_above_start_gb"),
             "mirror": fit["mod"]._exec_group.executor.mirror}
        if cuda:
            want = (PER_REPLAY if mirror == "0" else dict(
                PER_REPLAY, norm_act_fwd=2 * PER_REPLAY["norm_act_fwd"]))
            per, first, missed = _per_card_replay(
                torch, kernels, fit["step"], data, fit["metric"], want, n)
            r["launches_a_replay_by_card"] = per
            r["launches_first_replay_uncounted"] = first
            r["launches_session_recounted"] = missed
            r["device_ms_a_replay_card0"] = dpc._event_ms(
                torch, lambda: fit["step"].step(data, fit["metric"]))
        fits[mirror] = fit
        rec["mirror" if mirror == "1" else "plain"] = r
        fit.pop("mod"), fit.pop("step")
    check(rec["mirror"]["mirror"], "(b) the mirror was not armed")
    same = (_bit_equal(fits["1"]["args"], fits["0"]["args"])
            and _bit_equal(fits["1"]["aux"], fits["0"]["aux"])
            and fits["1"]["losses"] == fits["0"]["losses"])
    rec["mirror_bit_equal_plain"] = same
    check(same, "(b) the mirrored fit differs from the plain one")
    if cuda:
        want = dict(PER_REPLAY, norm_act_fwd=2 * PER_REPLAY["norm_act_fwd"])
        for d in range(n):
            got = rec["mirror"]["launches_a_replay_by_card"].get(d)
            check(got == want, "(b) card %d ran %s a mirrored replay, want "
                  "%s" % (d, got, want))
    return rec


def _first_step(snap, key):
    """A batch-end callback that keeps the params and aux after the
    fit's first step as ``snap[key]``."""
    def cb(param):
        if param.nbatch == 0:
            a, x = param.locals["self"].get_params()
            snap[key] = {"args": _host(a), "aux": _host(x)}
    return cb


def path_c(torch, mx, kernels, n, per_card, image, cuda, check):
    """bfloat16: fused against classic over the cards, and the cards'
    first step against one card's bf16 first step at the global batch."""
    batch = per_card * n
    rng = np.random.RandomState(2)
    images = rng.randn(STEPS * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, STEPS * batch).astype(np.float32)
    args, aux = initial_params(mx, image)
    ctxs = _ctxs(mx, n, not cuda)
    rec = {}
    snap = {}
    fused = resnet_fit(torch, mx, kernels, ctxs, args, aux, images, labels,
                       batch, cuda, True, dtype="bfloat16",
                       on_batch=_first_step(snap, "cards"))
    rec["step_ms_fused"] = fused["step_ms"]
    if cuda:
        data = _batch0(mx, images, labels, batch)
        rec["device_ms_a_replay_card0"] = dpc._event_ms(
            torch, lambda: fused["step"].step(data, fused["metric"]))
    fused.pop("mod"), fused.pop("step")
    classic = resnet_fit(torch, mx, kernels, ctxs, args, aux, images,
                         labels, batch, cuda, False, dtype="bfloat16")
    rec["step_ms_classic"] = classic["step_ms"]
    classic.pop("mod"), classic.pop("step")
    same = (_bit_equal(fused["args"], classic["args"])
            and _bit_equal(fused["aux"], classic["aux"])
            and fused["losses"] == classic["losses"])
    rec["fused_bit_equal_classic"] = same
    check(same, "(c) the bf16 fused fit differs from its classic loop")
    # against one card after the first step. cuDNN picks a convolution's
    # algorithm by its shape, the batch included, so a card's 32 rows
    # may round differently in bfloat16 from the same rows among 128 (two
    # of ResNet-50's 23 shapes on an H100, tools/torch_bf16_cards_probe.py),
    # and the network amplifies that to a fifth of the first update: that
    # distance is recorded. The check runs both sides with cuDNN off, so
    # every row's convolution is the same computation at any batch size;
    # then the cards differ from one card only in the order and grouping
    # of their sums over the batch, whose floor is how far reordering the
    # same batch moves one card's first step (rows rolled by a card's
    # share, and reversed)
    first = images[:batch], labels[:batch]
    one = resnet_fit(torch, mx, kernels, _one(mx, not cuda), args, aux,
                     *first, batch, cuda, True, dtype="bfloat16",
                     timed=False)
    one.pop("mod"), one.pop("step")
    for what, start, key in (("params", args, "args"), ("aux", aux, "aux")):
        rec["%s_vs_one_card_normwise_step1_cudnn" % what] = dpc._normwise(
            snap["cards"][key], one[key], start)
    floors = {"params": 0.0, "aux": 0.0}
    torch.backends.cudnn.enabled = False
    try:
        fits = {}
        for name, on, order in (
                ("cards", ctxs, np.arange(batch)),
                ("one", _one(mx, not cuda), np.arange(batch)),
                ("rolled", _one(mx, not cuda),
                 np.roll(np.arange(batch), per_card)),
                ("reversed", _one(mx, not cuda), np.arange(batch)[::-1])):
            fits[name] = resnet_fit(torch, mx, kernels, on, args, aux,
                                    first[0][order], first[1][order], batch,
                                    cuda, True, dtype="bfloat16",
                                    timed=False)
            fits[name].pop("mod"), fits[name].pop("step")
    finally:
        torch.backends.cudnn.enabled = True
    one = fits["one"]
    for moved in (fits["rolled"], fits["reversed"]):
        floors["params"] = max(floors["params"], dpc._normwise(
            moved["args"], one["args"], args))
        floors["aux"] = max(floors["aux"], dpc._normwise(
            moved["aux"], one["aux"], aux))
    rec["bf16_floor_normwise_step1"] = floors
    for what, start, key in (("params", args, "args"), ("aux", aux, "aux")):
        got = dpc._normwise(fits["cards"][key], one[key], start)
        bound = _bound(floors[what])
        # a fit that never moved reads 1.0, a halved update about 0.5
        unmoved = dpc._normwise(start, one[key], start)
        rec["%s_vs_one_card_normwise_step1" % what] = got
        rec["%s_bound" % what] = bound
        rec["%s_unmoved_reads" % what] = unmoved
        check(bound < BF16_SEPARATES, "(c) the bf16 %s bound %g does not "
              "separate a halved update (about %g)"
              % (what, bound, BF16_SEPARATES))
        check(got <= bound, "(c) bf16 %s differ from one card's after the "
              "first step by %g of its update, bound %g" % (what, got,
                                                            bound))
    return rec


# ---------------------------------------------------------------------------
# (d) the bucketed LSTM LM
# ---------------------------------------------------------------------------
LM = {"full": (2, 200, 200, 10000, (10, 20, 30, 40, 50, 60)),
      "small": (1, 16, 16, 50, (3, 5))}


def lm_batches(mx, size, batch, seed=0):
    """A batch of ``batch`` seeded sentences a bucket, in a seeded order:
    ``[(bucket, ids, labels)]`` (chip_smoke's lm_sentences' draws)."""
    layers, hidden, _, vocab, buckets = LM[size]
    rng = np.random.RandomState(seed)
    plan, prev = [], 0
    for bucket in buckets:
        ids = np.zeros((batch, bucket), np.float32)
        for row in ids:
            k = rng.randint(prev + 1, bucket + 1)
            row[:k] = rng.randint(1, vocab, k)
        lab = np.zeros_like(ids)
        lab[:, :-1] = ids[:, 1:]
        plan.append((bucket, ids, lab))
        prev = bucket
    return [plan[i] for i in rng.permutation(len(plan))]


def _nll(label, pred):
    lab = label.T.reshape(-1).astype(int)
    return (float(-np.log(np.maximum(pred[np.arange(len(lab)), lab],
                                     1e-300)).sum()), len(lab))


def lm_run(torch, mx, ctxs, size, plan, params, batch, cuda):
    """The LM over ``plan`` through BucketingModule's forward, backward
    and update: joined outputs a batch, the NLL, the params after, host
    ms a step, and the module."""
    layers, hidden, embed, vocab, buckets = LM[size]
    init = ["l%d_init_%s" % (i, k) for i in range(layers) for k in "ch"]

    def sym_gen(seq_len):
        return (mx.models.lstm_unroll(layers, seq_len, vocab, hidden, embed,
                                      vocab),
                tuple(["data"] + init), ("softmax_label",))

    def batch_of(bucket, ids, lab):
        data = [mx.nd.array(ids, ctx=mx.cpu())] + [
            mx.nd.zeros((batch, hidden), ctx=mx.cpu()) for _ in init]
        return mx.io.DataBatch(
            data, [mx.nd.array(lab, ctx=mx.cpu())], bucket_key=bucket,
            provide_data=[mx.io.DataDesc("data", (batch, bucket))] + [
                mx.io.DataDesc(n, (batch, hidden)) for n in init],
            provide_label=[mx.io.DataDesc("softmax_label", (batch, bucket))])

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=buckets[-1],
                                 context=ctxs)
    empty = np.zeros((batch, buckets[-1]), np.float32)
    first = batch_of(buckets[-1], empty, empty)
    mod.bind(first.provide_data, first.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()},
                    initializer=None)
    mod.init_optimizer(kvstore="device_sync" if len(ctxs) > 1 else "local",
                       optimizer="sgd", optimizer_params=(
                           ("learning_rate", 0.01), ("momentum", 0.0),
                           ("wd", 1e-5)))
    metric = mx.metric.CustomMetric(_nll, name="nll")
    outs = []
    batches = [batch_of(*p) for p in plan]
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
        mod.update_metric(metric, b.label)
    out = {"mod": mod, "outs": outs, "nll": metric.get()[1],
           "args": _host(mod.get_params()[0]), "step_ms": None}
    if cuda:
        # the first pass binds a bucket's module at its first batch: time
        # a second pass, every bucket bound
        times = []
        for b in batches:
            t0 = time.perf_counter()
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            _sync(torch, True)
            times.append(1e3 * (time.perf_counter() - t0))
        out["step_ms"] = _median(times)
    return out


def lm_params(mx, size, seed=0):
    layers, hidden, embed, vocab, buckets = LM[size]
    sym = mx.models.lstm_unroll(layers, buckets[-1], vocab, hidden, embed,
                                vocab)
    shapes = {"data": (2, buckets[-1]), "softmax_label": (2, buckets[-1])}
    shapes.update({"l%d_init_%s" % (i, k): (2, hidden)
                   for i in range(layers) for k in "ch"})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def path_d(torch, mx, kernels, n, per_card, size, cuda, check):
    batch = per_card * n
    plan = lm_batches(mx, size, batch)
    params = lm_params(mx, size)
    multi = lm_run(torch, mx, _ctxs(mx, n, not cuda), size, plan, params,
                   batch, cuda)
    mod = multi.pop("mod")
    owner = mod._buckets[LM[size][4][-1]]._exec_group
    shared = all(
        m._exec_group.execs[k].arg_dict[name] is
        owner.execs[k].arg_dict[name]
        and m._exec_group.replicated.flats is owner.replicated.flats
        for m in mod._buckets.values() for k in range(n) for name in params)
    rec = {"buckets": sorted(mod._buckets), "arrays_shared": shared,
           "step_ms": multi["step_ms"]}
    del mod
    check(shared, "(d) the buckets do not share the owner's arrays")
    check(len(rec["buckets"]) == len(LM[size][4]), "(d) buckets bound %s"
          % rec["buckets"])
    one = lm_run(torch, mx, _one(mx, not cuda), size, plan, params, batch,
                 cuda)
    one.pop("mod")
    rec["step_ms_one_card"] = one["step_ms"]
    worst = max(float(np.max(np.abs(a.astype(np.float64) - b)
                             / np.maximum(np.abs(b), 1e-6)))
                for a, b in zip(multi["outs"], one["outs"]))
    out_ok = all(np.allclose(a, b, rtol=LM_OUT_RTOL, atol=0)
                 for a, b in zip(multi["outs"], one["outs"]))
    rec["outputs_worst_rel"] = worst
    rec["outputs_within_rtol"] = out_ok
    check(out_ok, "(d) joined outputs differ from one card's (worst rel "
          "%g, rtol %g)" % (worst, LM_OUT_RTOL))
    rel = abs(multi["nll"] - one["nll"]) / abs(one["nll"])
    rec["nll"], rec["nll_one_card"], rec["nll_rel"] = (multi["nll"],
                                                       one["nll"], rel)
    rec["perplexity"] = float(np.exp(multi["nll"]))
    check(rel <= LM_METRIC_REL, "(d) NLL %g against one card's %g"
          % (multi["nll"], one["nll"]))
    floor = 0.0
    for scale in (1 + F32_ROUNDING, 1 - F32_ROUNDING):
        moved = dict(params, embed_weight=params["embed_weight"]
                     * np.float32(scale))
        m = lm_run(torch, mx, _one(mx, not cuda), size, plan, moved, batch,
                   cuda)
        m.pop("mod")
        floor = max(floor, dpc._normwise(m["args"], one["args"], params))
    got = dpc._normwise(multi["args"], one["args"], params)
    rec.update(float32_floor_normwise=floor, params_bound=_bound(floor),
               params_vs_one_card_normwise=got)
    check(got <= _bound(floor), "(d) params differ from one card's by %g "
          "of its update, bound %g" % (got, _bound(floor)))
    return rec


# ---------------------------------------------------------------------------
# (e) Fast R-CNN
# ---------------------------------------------------------------------------
def rcnn_batches(images, hw, rois_an_image, steps, classes, seed=0):
    """Seeded images (images, 3, h, w), and ``rois_an_image`` rois an
    image with labels and bbox targets; roi ``r`` of the rows a card
    gets names image ``(card + r) % images``, so every card's rois name
    the other cards' images too."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    n_rois = images * rois_an_image
    for _ in range(steps):
        bw = rng.uniform(0.05 * w, 0.6 * w, n_rois)
        bh = rng.uniform(0.05 * h, 0.6 * h, n_rois)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        card = np.repeat(np.arange(images), rois_an_image)
        idx = (card + np.arange(n_rois)) % images
        rois = np.stack([idx, x1, y1, x1 + bw, y1 + bh], 1)
        label = rng.randint(0, classes, n_rois)
        target = np.zeros((n_rois, 4 * classes), np.float32)
        weight = np.zeros_like(target)
        for i, c in enumerate(label):
            if c:
                target[i, 4 * c:4 * c + 4] = rng.randn(4)
                weight[i, 4 * c:4 * c + 4] = 1.0
        out.append({"data": rng.standard_normal((images, 3) + tuple(hw))
                    .astype(np.float32),
                    "rois": rois.astype(np.float32),
                    "label": label.astype(np.float32),
                    "bbox_target": target, "bbox_weight": weight})
    return out


def dropout_masks(torch, mx, sym):
    """A tap on the port's Dropout (train mode) for ``sym``'s nodes. In
    ``"record"`` mode the port's own Dropout runs (each replica draws from
    its own generator) and each call's keep mask is kept by node and
    replica; :func:`global_masks` then joins each step's masks over the
    global rows. In ``"replay"`` mode each node takes its next joined mask
    in place of a draw, with the port's arithmetic (``where(keep, x /
    (1 - p), 0)``), so one card drops the units the cards dropped. A mask
    is read as ``output != 0``: where the input is zero it is unknown,
    and there it changes nothing, since each Dropout here follows a ReLU
    (its output 0 either way, and the ReLU passes no gradient there).
    Returns the tap's state and the function that undoes it."""
    nn = mx.ops.nn
    names = {id(n.op): n.name for n in sym._topo()
             if not n.is_variable and type(n.op).__name__ == "Dropout"}
    real = nn.Dropout.apply
    state = {"mode": None, "calls": {}, "masks": {}, "next": {}}

    def apply(self, ctx, inputs, aux):
        name = names.get(id(self))
        live = name is not None and ctx.is_train and self.p > 0.0
        if live and state["mode"] == "replay":
            i = state["next"].get(name, 0)
            state["next"][name] = i + 1
            x = inputs[0]
            keep = state["masks"][name][i].to(x.device)
            return [torch.where(keep, x / (1.0 - self.p),
                                torch.zeros_like(x))], []
        out, new_aux = real(self, ctx, inputs, aux)
        if live and state["mode"] == "record":
            state["calls"].setdefault(name, []).append(
                (id(ctx.rng), out[0].detach() != 0, inputs[0].detach() != 0))
        return out, new_aux

    nn.Dropout.apply = apply

    def undo():
        nn.Dropout.apply = real
    return state, undo


def global_masks(state, mod):
    """The recorded masks joined in the global row order, a node a list
    over the steps, and the record cleared. Also whether every step's
    replicas drew different masks (each card has its own generator) and
    the share of units kept where the input was not zero."""
    gens = {id(ex._generator()): k for k, ex in
            enumerate(mod._exec_group.execs)}
    n = len(gens)
    out, differ, kept, known = {}, True, 0, 0
    for name, calls in state["calls"].items():
        steps = []
        for i in range(0, len(calls), n):
            part = sorted(calls[i:i + n], key=lambda c: gens[c[0]])
            masks = [(m.cpu(), x.cpu()) for _, m, x in part]
            differ &= not all(bool((m == masks[0][0]).all())
                              for m, _ in masks[1:])
            kept += sum(int((m & x).sum()) for m, x in masks)
            known += sum(int(x.sum()) for _, x in masks)
            steps.append(np.concatenate([m.numpy() for m, _ in masks], 0))
        out[name] = steps
    state["calls"] = {}
    return out, differ, kept / max(known, 1)


def rcnn_run(torch, mx, kernels, ctxs, sym, batches, init, cuda,
             scale=1.0):
    cs = _cs()
    mod = mx.mod.Module(sym, data_names=cs.RCNN_DATA,
                        label_names=cs.RCNN_LABELS, context=ctxs,
                        fixed_param_names=cs.RCNN_FIXED)
    b0 = batches[0]
    mod.bind(data_shapes=[(k, b0[k].shape) for k in cs.RCNN_DATA],
             label_shapes=[(k, b0[k].shape) for k in cs.RCNN_LABELS])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in init.items()}, initializer=None)
    mod.init_optimizer(kvstore="device_sync" if len(ctxs) > 1 else "local",
                       optimizer="sgd", optimizer_params=cs.RCNN_OPT)
    kernels.reset_launch_counts()
    marks = []
    for b in batches:
        data = dict(b, data=b["data"] * np.float32(scale))
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(data[k], ctx=mx.cpu()) for k in cs.RCNN_DATA],
            [mx.nd.array(data[k], ctx=mx.cpu()) for k in cs.RCNN_LABELS]))
        mod.update()
        _sync(torch, cuda)
        marks.append(time.perf_counter())
    launches = dict(kernels.launch_counts())
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return {"mod": mod, "args": _host(mod.get_params()[0]),
            "launches": launches, "step_ms": _median(steps_ms)}


def rcnn_profile(torch, kernels, mod, mx, batch):
    """One classic step's compiled-kernel launches on each card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs = _cs()
    db = mx.io.DataBatch(
        [mx.nd.array(batch[k], ctx=mx.cpu()) for k in cs.RCNN_DATA],
        [mx.nd.array(batch[k], ctx=mx.cpu()) for k in cs.RCNN_LABELS])
    mod.forward_backward(db)
    _sync(torch, True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(db)
        _sync(torch, True)
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names.setdefault(e.device_index, []).append(e.name)
    return {d: kernels.launches_in(v) for d, v in sorted(names.items())}


def rcnn_symbol(mx, fc_width):
    """chip_smoke's Fast R-CNN graph, its fc6 and fc7 ``fc_width`` wide
    (4096 as built; narrower only to rehearse on the CPU)."""
    cs = _cs()
    if fc_width == 4096:
        return mx.sym.Group(cs.vgg16_fast_rcnn(mx))
    full = mx.sym.FullyConnected

    def narrow(*a, **kw):
        if kw.get("num_hidden") == 4096:
            kw["num_hidden"] = fc_width
        return full(*a, **kw)

    mx.sym.FullyConnected = narrow
    try:
        return mx.sym.Group(cs.vgg16_fast_rcnn(mx))
    finally:
        mx.sym.FullyConnected = full


def path_e(torch, mx, kernels, n, hw, fc_width, cuda, check):
    cs = _cs()
    sym = rcnn_symbol(mx, fc_width)
    batches = rcnn_batches(n * RCNN_IMAGES_A_CARD, hw, RCNN_ROIS_AN_IMAGE,
                           RCNN_STEPS, cs.RCNN_CLASSES)
    init_mod = mx.mod.Module(sym, data_names=cs.RCNN_DATA,
                             label_names=cs.RCNN_LABELS, context=mx.cpu())
    init_mod.bind(data_shapes=[(k, batches[0][k].shape)
                               for k in cs.RCNN_DATA],
                  label_shapes=[(k, batches[0][k].shape)
                                for k in cs.RCNN_LABELS])
    init_mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                        seed=0))
    init = _host(init_mod.get_params()[0])
    del init_mod
    rec = {"images": n * RCNN_IMAGES_A_CARD, "hw": list(hw),
           "rois": int(batches[0]["rois"].shape[0])}
    per = batches[0]["rois"].shape[0] // n
    rec["rois_naming_other_cards_images_by_card"] = [
        int(np.sum(batches[0]["rois"][k * per:(k + 1) * per, 0]
                   != k * RCNN_IMAGES_A_CARD)) for k in range(n)]
    tap, undo = dropout_masks(torch, mx, sym)
    try:
        tap["mode"] = "record"
        multi = rcnn_run(torch, mx, kernels, _ctxs(mx, n, not cuda), sym,
                         batches, init, cuda)
        tap["mode"] = None
        masks, differ, kept = global_masks(tap, multi["mod"])
        rec["dropout_masks_differ_by_card"] = differ
        rec["dropout_kept_share"] = kept
        check(differ and all(len(v) == RCNN_STEPS for v in masks.values())
              and len(masks) == 2, "(e) the port's Dropout over the cards: "
              "%d nodes, masks differ by card %s" % (len(masks), differ))
        tap["masks"] = {k: [torch.from_numpy(m) for m in v]
                        for k, v in masks.items()}
        rec["step_ms"] = multi["step_ms"]
        rec["launches_counted_by_wrappers"] = {
            k: multi["launches"][k] for k in ("conv_gemm", "roi_pool")}
        if cuda:
            by_card = rcnn_profile(torch, kernels, multi["mod"], mx,
                                   batches[0])
            rec["launches_a_step_by_card"] = {
                d: {k: c.get(k, 0) for k in ("conv_gemm", "roi_pool")}
                for d, c in by_card.items()}
            for d in range(n):
                got = rec["launches_a_step_by_card"].get(d)
                want = {"conv_gemm": RCNN_K3_STEP, "roi_pool": 2}
                check(got == want, "(e) card %d ran %s a step, want %s"
                      % (d, got, want))
        multi.pop("mod")
        tap["mode"] = "replay"
        tap["next"] = {}
        one = rcnn_run(torch, mx, kernels, _one(mx, not cuda), sym, batches,
                       init, cuda)
        one.pop("mod")
        rec["step_ms_one_card"] = one["step_ms"]
        floor = 0.0
        for scale in (1 + F32_ROUNDING, 1 - F32_ROUNDING):
            tap["next"] = {}
            m = rcnn_run(torch, mx, kernels, _one(mx, not cuda), sym,
                         batches, init, cuda, scale)
            m.pop("mod")
            floor = max(floor, dpc._normwise(m["args"], one["args"], init))
    finally:
        undo()
    got = dpc._normwise(multi["args"], one["args"], init)
    rec.update(float32_floor_normwise=floor, params_bound=_bound(floor),
               params_vs_one_card_normwise=got)
    check(got <= _bound(floor), "(e) params differ from one card's by %g "
          "of its update, bound %g" % (got, _bound(floor)))
    check(all(rec["rois_naming_other_cards_images_by_card"]),
          "(e) a card's rois name only its own image")
    return rec


def run(torch, mx, kernels, n_cards, paths="abcde", per_card=PER_CARD,
        image=IMAGE, lm="full", rcnn_hw=RCNN_HW, fc_width=4096, cpu=False,
        log=print):
    """Paths ``paths`` over ``n_cards``: the record, with ``failed``
    listing every check that failed."""
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            log("FAILED: " + msg)

    cuda = not cpu
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"cards": n_cards, "per_card": per_card, "image": image}
    t0 = time.perf_counter()
    runs = {
        "a": lambda: path_a(torch, mx, kernels, n_cards, per_card, image,
                            cuda, check),
        "b": lambda: path_b(torch, mx, kernels, n_cards, per_card, image,
                            cuda, check),
        "c": lambda: path_c(torch, mx, kernels, n_cards, per_card, image,
                            cuda, check),
        "d": lambda: path_d(torch, mx, kernels, n_cards, per_card, lm, cuda,
                            check),
        "e": lambda: path_e(torch, mx, kernels, n_cards, rcnn_hw, fc_width,
                            cuda, check)}
    for p in paths:
        try:
            rec[p] = runs[p]()
        except Exception:       # recorded as a failure: the run exits 1
            import traceback

            check(False, "(%s) raised: %s" % (p, traceback.format_exc()))
            continue
        rec[p]["seconds"] = time.perf_counter() - t0
        dfc._progress(log, "(%s) passed its checks so far: %s"
                      % (p, not failed))
    rec["failed"] = failed
    return rec


def summary(rec, card):
    """The printed lines of a run."""
    lines = []
    a = rec.get("a")
    if a and "fsdp" in a:
        for mesh in ("dp", "fsdp"):
            r = a[mesh]
            lines.append(
                "(a) %s %d x %d ResNet-50 skip guard: state bit-equal after "
                "the NaN batch on card %d %s, skips %s, counters %s, K3/K4/K5 "
                "a replay by card %s (recounted: %s), host %s ms a step, card "
                "0 device %s ms a replay  [%s]"
                % (mesh, rec["cards"], rec["per_card"], a["poisoned_card"],
                   r["state_bit_equal_after_nan_batch"],
                   r["skips_by_step_and_card"][-1], r["counters"],
                   r.get("launches_a_replay_by_card"),
                   r.get("launches_session_recounted"), _f(r["step_ms"]),
                   _f(r.get("device_ms_a_replay_card0")), card))
        lines.append("(a) fsdp pack against dp: counts equal %s, sums worst "
                     "rel %.3g" % (a["fsdp_pack_counts_equal_dp"],
                                   a["fsdp_pack_sums_worst_rel"]))
    b = rec.get("b")
    if b and "mirror" in b:
        lines.append(
            "(b) mirror bit-equal to plain %s; K4 a replay by card %s "
            "(recounted: %s, %s); peak "
            "above start GB mirror %s plain %s; card 0 device ms a replay "
            "mirror %s plain %s; host ms a step mirror %s plain %s  [%s]"
            % (b["mirror_bit_equal_plain"],
               {d: c["norm_act_fwd"] for d, c in
                b["mirror"].get("launches_a_replay_by_card", {}).items()},
               b["mirror"].get("launches_session_recounted"),
               b["plain"].get("launches_session_recounted"),
               _fl(b["mirror"].get("peak_above_start_gb")),
               _fl(b["plain"].get("peak_above_start_gb")),
               _f(b["mirror"].get("device_ms_a_replay_card0")),
               _f(b["plain"].get("device_ms_a_replay_card0")),
               _f(b["mirror"]["step_ms"]), _f(b["plain"]["step_ms"]), card))
    c = rec.get("c")
    if c and "params_bound" in c:
        lines.append(
            "(c) bf16 fused == classic %s; vs one card after step 1, "
            "cuDNN off: params %.4g (bound %.4g, floor %.4g, unmoved reads "
            "%.4g) aux %.4g (bound %.4g); cuDNN on: params %.4g aux %.4g; "
            "host ms a step fused %s classic %s; card 0 device %s ms a "
            "replay  [%s]"
            % (c["fused_bit_equal_classic"],
               c["params_vs_one_card_normwise_step1"], c["params_bound"],
               c["bf16_floor_normwise_step1"]["params"],
               c["params_unmoved_reads"],
               c["aux_vs_one_card_normwise_step1"], c["aux_bound"],
               c["params_vs_one_card_normwise_step1_cudnn"],
               c["aux_vs_one_card_normwise_step1_cudnn"],
               _f(c["step_ms_fused"]), _f(c["step_ms_classic"]),
               _f(c.get("device_ms_a_replay_card0")), card))
    d = rec.get("d")
    if d and "params_bound" in d:
        lines.append(
            "(d) bucketed LM buckets %s shared %s; outputs worst rel %.3g; "
            "NLL %.6f vs %.6f (perplexity %.2f); params %.4g (bound %.4g); "
            "host ms a step %s (one card %s)  [%s]"
            % (d["buckets"], d["arrays_shared"], d["outputs_worst_rel"],
               d["nll"], d["nll_one_card"], d["perplexity"],
               d["params_vs_one_card_normwise"], d["params_bound"],
               _f(d["step_ms"]), _f(d["step_ms_one_card"]), card))
    e = rec.get("e")
    if e and "params_bound" in e:
        lines.append(
            "(e) Fast R-CNN %d images %s, %d rois (naming other cards' "
            "images by card %s): params %.4g (bound %.4g); launches a step "
            "by card %s; host ms a step %s (one card %s)  [%s]"
            % (e["images"], e["hw"], e["rois"],
               e["rois_naming_other_cards_images_by_card"],
               e["params_vs_one_card_normwise"], e["params_bound"],
               e.get("launches_a_step_by_card"), _f(e["step_ms"]),
               _f(e["step_ms_one_card"]), card))
    return lines


def _f(x):
    return "n/a" if x is None else "%.3f" % x


def _fl(xs):
    return None if xs is None else ["%.3f" % x for x in xs]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="cards (default: every visible one)")
    parser.add_argument("--paths", default="abcde")
    parser.add_argument("--per-card", type=int, default=PER_CARD)
    parser.add_argument("--image", type=int, default=IMAGE)
    parser.add_argument("--lm", default="full", choices=sorted(LM))
    parser.add_argument("--rcnn-hw", default="%d,%d" % RCNN_HW)
    parser.add_argument("--fc-width", type=int, default=4096,
                        help="Fast R-CNN's fc6/fc7 (narrower to rehearse)")
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
            print("torch_dp_graphs_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        _build.build_all()
    n = opts.cards or (torch.cuda.device_count() if not opts.cpu else 4)
    card = dpc.card_line() if not opts.cpu else "cpu"
    print(card)
    t0 = time.perf_counter()
    rec = run(torch, mx, kernels, n, opts.paths, opts.per_card, opts.image,
              opts.lm, tuple(int(v) for v in opts.rcnn_hw.split(",")),
              opts.fc_width, opts.cpu)
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
