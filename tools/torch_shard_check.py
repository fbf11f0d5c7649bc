#!/usr/bin/env python3
"""The fsdp recipe and the sharding API of the PyTorch port, on several
cards: ResNet-50 NHWC with its params and optimizer state sharded.

    python3 tools/torch_shard_check.py                    # every card
    python3 tools/torch_shard_check.py --report shard.json
    python3 tools/torch_shard_check.py --cpu --cards 4 --per-card 2 \\
        --image 64 --steps 2                              # rehearsal

The model and data are ``tools/torch_dp_check.py``'s: ResNet-50 NHWC
(1000 classes, 224 x 224, f32, TF32 off) with Xavier weights from seed 0
and the residual blocks' last BatchNorm gamma at 0.25, and global batches
of ``--per-card`` x ``--cards`` images from seed 0.

(a) One process over the cards: ``Module.fit`` under ``device_sync``
(the fused step, one CUDA graph over every card) with
``MXNET_TPU_MESH_FSDP`` at the number of cards and at 2 (the ``(dp,
fsdp)`` mesh), against dp over the same cards and against one card at
the global batch, 5 steps of SGD (lr 0.0125, momentum 0.9, wd 1e-4).
Checks of each fsdp fit: params and moving statistics within 4 float32
floors (normwise, as a share of the one-card fit's update; the floor is
the larger distance the one-card fit moves when its images are scaled by
1 +- 2^-23, and the bound is at least 1e-4) of the one-card fit and of
the dp fit; after a gather, every replica's full-width params bit-equal
to the first's and to the joined shards; one eager step, one capture
and a replay a batch after it; K3, K4 and K5 launched 105, 53 and 53
times a replay on every card (torch.profiler's kernel events over two
replays); optimizer-state bytes a card 1/fsdp of dp's. It records each
fit's allocated bytes a card at its end and at its peak, above what was
live before it, and card 0's device ms a replay (CUDA events) with the
NCCL kernels' share (profiler).

(b) Processes through ``tools/launch.py``, one a card:
``parallel.build_sgd_train_step`` over a ``{"dp": D, "fsdp": F}``
DeviceMesh (``--mesh D,F``, default 2,2) with ``fsdp_param_spec`` rules
(``make_param_shardings``, ``shard_args``), each rank stepping on its
local shard of the global batch, 3 steps (lr 0.0125 / the global batch:
the step sums the gradients), against one card's unsharded step at the
global batch in the parent. Checks: every rank's gathered params and
moving statistics bit-equal to rank 0's; rank 0's within 4 float32
floors of the reference's; each rank's local shard of every param whose
dim 0 divides by F holds 1/F of it; K3, K4 and K5 launched 105, 53 and
53 times a step on every rank.

Prints a line a fit, then one JSON object as the last line; exits
non-zero when a check fails. ``--cpu`` rehearses (a) over CPU contexts
and (b) over gloo (no timing, no profiler, no launch counts);
``--part a`` or ``--part b`` runs one part; ``--net small`` swaps in a
two-stage NHWC ResNet for quick rehearsals. Imports neither jax nor the
JAX package.
"""
import argparse
import faulthandler
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, REPO)
sys.path.insert(0, TOOLS)

import torch_dp_check as dp  # noqa: E402

STEPS_B = 3
WORKER_TIMEOUT = 900           # seconds for one launch of the world
PER_STEP = dp.PER_REPLAY       # K3, K4, K5 a ResNet-50 training step


def _env(name, value):
    """Set (or, with None, unset) one environment variable; returns the
    function that puts it back."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)

    def undo():
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
    return undo


def small_symbol(mx):
    """The two-stage NHWC ResNet of the CPU tests (10 classes)."""
    return mx.models.get_resnet([1, 1], [8, 16, 16], num_classes=10,
                                small_input=True, layout="NHWC")


def _symbol(mx, net):
    if net == "small":
        return small_symbol(mx)
    return mx.models.get_resnet50(num_classes=1000, layout="NHWC")


def initial_params(mx, image, net):
    """Seed-0 Xavier params (numpy), the residual blocks' last BatchNorm
    gamma at 0.25."""
    if net != "small":
        return dp.initial_params(mx, image)
    mod = mx.mod.Module(small_symbol(mx), context=[mx.cpu()])
    mod.bind(data_shapes=[("data", (1, image, image, 3))],
             label_shapes=[("softmax_label", (1,))])
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0, seed=0))
    args, aux = mod.get_params()
    args = {k: v.asnumpy().copy() for k, v in args.items()}
    for k in args:
        if k.endswith("_b3_bn_gamma"):
            args[k][:] = dp.GAMMA_B3
    return args, {k: v.asnumpy().copy() for k, v in aux.items()}


def data(steps, batch, image, classes):
    rng = np.random.RandomState(0)
    images = rng.randn(steps * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, classes, steps * batch).astype(np.float32)
    return images, labels


def _classes(net):
    return 10 if net == "small" else 1000


# ---------------------------------------------------------------------------
# (a) one process over the cards
# ---------------------------------------------------------------------------
def _state_bytes(mod, k):
    """Bytes of card ``k``'s optimizer states."""
    from mxnet_tpu_torch.optimizer import _state_tensors

    return sum(t.numel() * t.element_size()
               for s in mod._updaters[k].states.values()
               for t in _state_tensors(s))


def gathered_replicas_equal(torch, mod):
    """After one gather of the shards: the params every replica holds
    that differ from the first replica's, and those where the first
    replica's differ from the shards joined."""
    group = mod._exec_group
    if group.shards is not None:
        group.replicas.begin()
        with torch.no_grad():
            group.shards.gather()
        for d in group.replicas.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    bad = dp.replicas_identical(mod)
    joined = [n for n in group.param_names
              if not torch.equal(group.param_value(n).cpu(),
                                 group.executor.arg_dict[n].handle.cpu())]
    return bad, joined


def fit_a(torch, mx, kernels, ctxs, fsdp, args, aux, images, labels, batch,
          cuda, net):
    """One fit of (a) under ``MXNET_TPU_MESH_FSDP=fsdp`` (None: dp), with
    each card's allocated bytes at its end (``resident_gb``) and at its
    peak (``peak_gb``), both above what was live before it (the earlier
    fits' garbage collected first)."""
    devs = [c.torch_device() for c in ctxs]
    if cuda:
        gc.collect()
        for d in devs:
            torch.cuda.synchronize(d)
        base = [torch.cuda.memory_allocated(d) for d in devs]
    undo = _env("MXNET_TPU_MESH_FSDP", fsdp)
    try:
        if net == "small":
            run = _fit_small(torch, mx, kernels, ctxs, args, aux, images,
                             labels, batch, cuda)
        else:
            run = dp.fit(torch, mx, kernels, ctxs, "device_sync", args, aux,
                         images, labels, batch, cuda)
    finally:
        undo()
    mod = run["mod"]
    run["state_bytes"] = [_state_bytes(mod, k) for k in range(len(ctxs))]
    if cuda:
        run["resident_gb"] = [(torch.cuda.memory_allocated(d) - b) / 1e9
                              for d, b in zip(devs, base)]
        run["peak_gb"] = [(torch.cuda.max_memory_allocated(d) - b) / 1e9
                          for d, b in zip(devs, base)]
    return run


def _fit_small(torch, mx, kernels, ctxs, args, aux, images, labels, batch,
               cuda):
    """``dp.fit`` with the small network."""
    orig = dp.resnet_module

    def small_module(mx_, ctxs_, batch_, image):
        mod = mx_.mod.Module(small_symbol(mx_), context=ctxs_)
        mod.bind(data_shapes=[("data", (batch_, image, image, 3))],
                 label_shapes=[("softmax_label", (batch_,))],
                 for_training=True)
        return mod

    dp.resnet_module = small_module
    try:
        return dp.fit(torch, mx, kernels, ctxs, "device_sync" if
                      len(ctxs) > 1 else "local", args, aux, images, labels,
                      batch, cuda)
    finally:
        dp.resnet_module = orig


def run_a(torch, mx, kernels, n_cards, per_card=dp.PER_CARD, steps=dp.STEPS,
          image=dp.IMAGE, cpu=False, net="resnet50", log=print):
    """Part (a) over ``n_cards``; the record with ``failed``."""
    cuda = not cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: (a) " + msg)

    batch = per_card * n_cards
    images, labels = data(steps, batch, image, _classes(net))
    args0, aux0 = initial_params(mx, image, net)
    ctx = mx.cpu if cpu else mx.gpu
    one_ctx = [ctx(0)]
    cards = [ctx(i) for i in range(n_cards)]
    rec = {"cards": n_cards, "per_card": per_card, "global_batch": batch,
           "steps": steps, "image": image, "net": net}
    one = fit_a(torch, mx, kernels, one_ctx, None, args0, aux0, images,
                labels, batch, cuda, net)
    del one["mod"]
    floors = {"args": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        moved = fit_a(torch, mx, kernels, one_ctx, None, args0, aux0,
                      images * np.float32(scale), labels, batch, cuda, net)
        del moved["mod"]
        for what, start in (("args", args0), ("aux", aux0)):
            floors[what] = max(floors[what], dp._normwise(
                moved[what], one[what], start))
    bounds = {w: max(dp.FLOOR_FACTOR * f, dp.MIN_BOUND)
              for w, f in floors.items()}
    rec["float32_floor_normwise"] = floors
    rec["bounds"] = bounds
    rec["one_card"] = {"step_ms": one["step_ms"],
                       "peak_gb": one.get("peak_gb")}
    fsdps = [None] + sorted({f for f in (n_cards, 2)
                             if f > 1 and n_cards % f == 0}, reverse=True)
    runs = {}
    for fsdp in fsdps:
        name = "dp%d" % n_cards if fsdp is None else \
            "dp%d_fsdp%d" % (n_cards // fsdp, fsdp)
        run = fit_a(torch, mx, kernels, cards, fsdp, args0, aux0, images,
                    labels, batch, cuda, net)
        mod, step = run["mod"], run["mod"]._fused_step
        r = {"fsdp": fsdp or 1, "step_ms": run["step_ms"],
             "losses": run["losses"], "state_bytes": run["state_bytes"],
             "peak_gb": run.get("peak_gb"),
             "resident_gb": run.get("resident_gb"),
             "launches_counted_by_wrappers": run["launches"]}
        counters = {"eager_steps": step.eager_steps,
                    "captures": step.captures,
                    "dispatches": step.dispatches}
        r["counters"] = counters
        want = ({"eager_steps": 1, "captures": 1, "dispatches": steps - 1}
                if cuda else {"eager_steps": steps, "captures": 0,
                              "dispatches": 0})
        check(counters == want, "%s: fused step counters %s, want %s"
              % (name, counters, want))
        sharded = mod._exec_group.shards
        check((sharded is not None) == (fsdp is not None),
              "%s: sharded params %s" % (name, sharded is not None))
        if cuda:
            want_l = {k: v * 2 * n_cards for k, v in PER_STEP.items()}
            check(run["launches"] == want_l, "%s: wrapper launches %s, "
                  "want %s" % (name, run["launches"], want_l))
        for what, start in (("args", args0), ("aux", aux0)):
            got = dp._normwise(run[what], one[what], start)
            r["%s_vs_one_card_normwise" % what] = got
            check(got <= bounds[what], "%s: %s %g of the one-card update "
                  "away, bound %g" % (name, what, got, bounds[what]))
            if fsdp is not None:
                got = dp._normwise(run[what], runs["dp"][what], start)
                r["%s_vs_dp_normwise" % what] = got
                check(got <= bounds[what], "%s: %s %g of the update away "
                      "from dp's, bound %g" % (name, what, got,
                                               bounds[what]))
        bad, joined = gathered_replicas_equal(torch, mod)
        r["replicas_identical_after_gather"] = not bad and not joined
        check(not bad, "%s: replicas differ after the gather at %s"
              % (name, bad[:5]))
        check(not joined, "%s: the workspace differs from the joined shards "
              "at %s" % (name, joined[:5]))
        if cuda:
            batch0 = mx.io.DataBatch(
                [mx.nd.array(images[:batch], ctx=mx.cpu())],
                [mx.nd.array(labels[:batch], ctx=mx.cpu())])
            per_device, nccl = dp.profile_replays(torch, kernels, step,
                                                  batch0, run["metric"])
            r["launches_per_card_2_replays"] = per_device
            r.update(nccl)
            for d in range(n_cards):
                got = {k: per_device.get(d, {}).get(k, 0) for k in PER_STEP}
                want_d = {k: 2 * v for k, v in PER_STEP.items()}
                check(got == want_d, "%s: card %d ran %s in two replays, "
                      "want %s" % (name, d, got, want_d))
            r["device_ms_a_replay_card0"] = dp._event_ms(
                torch, lambda: step.step(batch0, run["metric"]))
            r["nccl_share"] = (r["nccl_ms_a_replay"]
                               / r["device_ms_a_replay_card0"])
            r["img_per_s"] = batch * 1e3 / run["step_ms"]
        runs["dp" if fsdp is None else name] = run
        rec[name] = r
        log("(a) %s: params %.4g / moving statistics %.4g of the one-card "
            "update away (bounds %.4g / %.4g), state bytes card 0 %d, "
            "counters %s%s"
            % (name, r["args_vs_one_card_normwise"],
               r["aux_vs_one_card_normwise"], bounds["args"], bounds["aux"],
               r["state_bytes"][0], counters,
               "" if not cuda else ", host %.3f ms a step, card 0 %.3f ms a "
               "replay (NCCL %.3f), above the start: resident %s GB, peak "
               "%s GB"
               % (r["step_ms"], r["device_ms_a_replay_card0"],
                  r["nccl_ms_a_replay"],
                  ["%.3f" % g for g in r["resident_gb"]],
                  ["%.3f" % g for g in r["peak_gb"]])))
        del mod, step
        run.pop("mod")
    dp_bytes = rec["dp%d" % n_cards]["state_bytes"]
    for fsdp in fsdps[1:]:
        name = "dp%d_fsdp%d" % (n_cards // fsdp, fsdp)
        ratios = [b / d for b, d in zip(rec[name]["state_bytes"], dp_bytes)]
        rec[name]["state_bytes_vs_dp"] = ratios
        # every ResNet-50 param's dim 0 divides by 4 (and 2)
        if net != "small":
            check(all(abs(x - 1.0 / fsdp) < 1e-12 for x in ratios),
                  "%s: optimizer-state bytes a card %s of dp's, want 1/%d"
                  % (name, ratios, fsdp))
    rec["failed"] = failed
    return rec


# ---------------------------------------------------------------------------
# (b) processes over a DeviceMesh
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lr(batch):
    return dp.OPT[0][1] / batch


def worker(work, opts):
    """One rank of (b): the sharded steps, its results to ``work``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops import kernels

    rank = int(os.environ["MXTPU_WORKER_RANK"])
    world = int(os.environ["MXTPU_NUM_WORKERS"])
    cuda = not opts.cpu
    if cuda:
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", card)
    else:
        dev = torch.device("cpu")
    d_size, f_size = (int(v) for v in opts.mesh.split(","))
    mesh = parallel.make_mesh({"dp": d_size, "fsdp": f_size},
                              device_type=dev.type)
    params = np.load(os.path.join(work, "params.npz"))
    args = {k[4:]: params[k] for k in params.files if k.startswith("arg:")}
    aux = {k[4:]: params[k] for k in params.files if k.startswith("aux:")}
    images = np.load(os.path.join(work, "images.npy"), mmap_mode="r")
    labels = np.load(os.path.join(work, "labels.npy"))
    sym = _symbol(mx, opts.net)
    shardings = parallel.make_param_shardings(
        mesh, {k: v.shape for k, v in args.items()},
        [parallel.ShardingRule(".*", parallel.fsdp_param_spec((f_size,),
                                                               mesh))])
    p = parallel.shard_args(mesh, args, shardings)
    aux_t = [torch.from_numpy(aux[n]).to(dev)
             for n in sym.list_auxiliary_states()]
    batch = opts.per_card * world
    step, names = parallel.build_sgd_train_step(
        sym, ["data"], ["softmax_label"], lr=_lr(batch))
    # the batch shards over (dp, fsdp) in mesh order: rank r's rows
    mine = slice(rank * opts.per_card, (rank + 1) * opts.per_card)
    kernels.reset_launch_counts()
    for s in range(STEPS_B):
        x = images[s * batch:(s + 1) * batch][mine]
        y = labels[s * batch:(s + 1) * batch][mine]
        _, p, aux_t = step(p, {"data": torch.from_numpy(np.array(x)).to(dev),
                               "softmax_label": torch.from_numpy(y).to(dev)},
                           aux_t, s)
    launches = kernels.launch_counts()
    local = {n: [int(v.to_local().numel()), int(v.numel())]
             for n, v in p.items()}
    full = {n: v.full_tensor().cpu().numpy() for n, v in p.items()}
    rec = {"rank": rank, "world": world, "mesh": opts.mesh,
           "launches": {k: launches[k] for k in PER_STEP},
           "local_numel": local,
           "placements": {n: str(v.placements) for n, v in p.items()}}
    np.savez(os.path.join(work, "rank%d.npz" % rank),
             **{"arg:" + k: v for k, v in full.items()},
             **{"aux:" + n: a.cpu().numpy() for n, a in
                zip(sym.list_auxiliary_states(), aux_t)})
    with open(os.path.join(work, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    from mxnet_tpu_torch.parallel import distributed

    distributed.barrier()
    sys.stdout.flush()
    # skip interpreter teardown, where gloo's C++ teardown can abort after
    # the work is done (tests/torch_sp_ranks.py)
    os._exit(0)


def launch(work, world, opts):
    """Run (b)'s world through tools/launch.py: (rc, records, arrays,
    ranks that left no result, the tail of stderr)."""
    cmd = [sys.executable, os.path.join(TOOLS, "launch.py"), "-n",
           str(world), "--coordinator", "127.0.0.1:%d" % _free_port(),
           sys.executable, os.path.abspath(__file__), "--worker", work,
           "--per-card", str(opts.per_card), "--image", str(opts.image),
           "--mesh", opts.mesh, "--net", opts.net]
    if opts.cpu:
        cmd.append("--cpu")
    env = dict(os.environ, PYTHONPATH=REPO)
    if opts.cpu:
        env["OMP_NUM_THREADS"] = "1"
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=WORKER_TIMEOUT)
        rc, err = proc.returncode, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = 124
        err = e.stderr.decode(errors="replace") \
            if isinstance(e.stderr, bytes) else (e.stderr or "")
    recs, arrays, missing = [], [], []
    for r in range(world):
        path = os.path.join(work, "rank%d.json" % r)
        if not os.path.exists(path):
            missing.append(r)
            continue
        with open(path) as f:
            recs.append(json.load(f))
        arrays.append(dict(np.load(os.path.join(work, "rank%d.npz" % r))))
    return rc, recs, arrays, missing, err[-3000:]


def reference_steps(torch, mx, dev, sym, args, aux, images, labels, batch):
    """One card's unsharded ``build_sgd_train_step`` at the global batch,
    STEPS_B steps: (params, aux) as numpy."""
    from mxnet_tpu_torch import parallel

    step, _ = parallel.build_sgd_train_step(sym, ["data"], ["softmax_label"],
                                            lr=_lr(batch))
    p = {k: torch.from_numpy(v).to(dev) for k, v in args.items()}
    a = [torch.from_numpy(aux[n]).to(dev) for n in sym.list_auxiliary_states()]
    for s in range(STEPS_B):
        x = torch.from_numpy(images[s * batch:(s + 1) * batch]).to(dev)
        y = torch.from_numpy(labels[s * batch:(s + 1) * batch]).to(dev)
        _, p, a = step(p, {"data": x, "softmax_label": y}, a, s)
    return ({k: v.cpu().numpy() for k, v in p.items()},
            {n: t.cpu().numpy() for n, t in
             zip(sym.list_auxiliary_states(), a)})


def run_b(torch, mx, kernels, opts, log=print):
    """Part (b): the world, then the reference in this process."""
    cuda = not opts.cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: (b) " + msg)

    d_size, f_size = (int(v) for v in opts.mesh.split(","))
    world = d_size * f_size
    batch = opts.per_card * world
    images, labels = data(STEPS_B, batch, opts.image, _classes(opts.net))
    args0, aux0 = initial_params(mx, opts.image, opts.net)
    rec = {"mesh": {"dp": d_size, "fsdp": f_size}, "per_rank": opts.per_card,
           "global_batch": batch, "steps": STEPS_B}
    work = tempfile.mkdtemp(prefix="mxtpu_shard_")
    try:
        np.savez(os.path.join(work, "params.npz"),
                 **{"arg:" + k: v for k, v in args0.items()},
                 **{"aux:" + k: v for k, v in aux0.items()})
        np.save(os.path.join(work, "images.npy"), images)
        np.save(os.path.join(work, "labels.npy"), labels)
        t0 = time.perf_counter()
        rc, recs, arrays, missing, err = launch(work, world, opts)
        rec["world_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["launch_rc"] = rc
    check(rc == 0 and not missing, "the world failed (launch.py rc %d); "
          "ranks that left no result: %s; stderr: %s" % (rc, missing, err))
    if missing:
        rec["failed"] = failed
        return rec
    rec["ranks"] = recs
    first = arrays[0]
    differ = sorted({k for a in arrays[1:] for k in a
                     if not np.array_equal(a[k], first[k])})
    check(not differ, "ranks differ from rank 0 at %s" % differ[:5])
    for r in recs:
        for n, (mine, whole) in r["local_numel"].items():
            shape = args0[n].shape
            want = whole // f_size if shape[0] % f_size == 0 else whole
            if mine != want:
                check(False, "rank %d holds %d of %s's %d elements, want %d"
                      % (r["rank"], mine, n, whole, want))
        if cuda:
            want_l = {k: v * STEPS_B for k, v in PER_STEP.items()}
            check(r["launches"] == want_l, "rank %d launches %s, want %s"
                  % (r["rank"], r["launches"], want_l))
    rec["divisible_params"] = sum(1 for v in args0.values()
                                  if v.shape[0] % f_size == 0)
    rec["params"] = len(args0)
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sym = _symbol(mx, opts.net)
    ref_a, ref_x = reference_steps(torch, mx, dev, sym, args0, aux0, images,
                                   labels, batch)
    floors = {"args": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        a, x = reference_steps(torch, mx, dev, sym, args0, aux0,
                               images * np.float32(scale), labels, batch)
        floors["args"] = max(floors["args"], dp._normwise(a, ref_a, args0))
        floors["aux"] = max(floors["aux"], dp._normwise(x, ref_x, aux0))
    got_a = {k[4:]: v for k, v in first.items() if k.startswith("arg:")}
    got_x = {k[4:]: v for k, v in first.items() if k.startswith("aux:")}
    rec["float32_floor_normwise"] = floors
    for what, got, want, start in (("args", got_a, ref_a, args0),
                                   ("aux", got_x, ref_x, aux0)):
        dist_ = dp._normwise(got, want, start)
        bound = max(dp.FLOOR_FACTOR * floors[what], dp.MIN_BOUND)
        rec["%s_vs_reference_normwise" % what] = dist_
        rec["%s_bound" % what] = bound
        check(dist_ <= bound, "rank 0's %s %g of the reference's update "
              "away, bound %g" % (what, dist_, bound))
    log("(b) %d ranks over dp %d x fsdp %d: params %.4g / moving "
        "statistics %.4g of the one-card step's update away (bounds %.4g / "
        "%.4g), ranks bit-equal, shards 1/%d of %d divisible params, "
        "world %.1f s"
        % (world, d_size, f_size, rec["args_vs_reference_normwise"],
           rec["aux_vs_reference_normwise"], rec["args_bound"],
           rec["aux_bound"], f_size, rec["divisible_params"],
           rec["world_seconds"]))
    rec["failed"] = failed
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="cards of (a) (default: every visible one; 4 "
                        "with --cpu)")
    parser.add_argument("--per-card", type=int, default=dp.PER_CARD)
    parser.add_argument("--steps", type=int, default=dp.STEPS,
                        help="steps of (a)")
    parser.add_argument("--image", type=int, default=dp.IMAGE)
    parser.add_argument("--mesh", default="2,2",
                        help="(b)'s dp,fsdp sizes (their product ranks)")
    parser.add_argument("--part", choices=("a", "b", "ab"), default="ab")
    parser.add_argument("--net", choices=("resnet50", "small"),
                        default="resnet50")
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse over CPU contexts and gloo")
    parser.add_argument("--report", help="write the record here (JSON)")
    parser.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    faulthandler.enable()
    if opts.worker:
        worker(opts.worker, opts)
        return 0
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    if not opts.cpu:
        if not torch.cuda.is_available():
            print("torch_shard_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        mx.profiler.keep_cupti()     # it profiles CUDA graph replays
        from mxnet_tpu_torch import _build

        # built once here: the workers load the libraries
        _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = opts.cards or (4 if opts.cpu else torch.cuda.device_count())
    card = "cpu" if opts.cpu else dp.card_line()
    print(card)
    t0 = time.perf_counter()
    rec = {"card": card, "torch": torch.__version__, "failed": []}
    if "a" in opts.part:
        rec["a"] = run_a(torch, mx, kernels, n, opts.per_card, opts.steps,
                         opts.image, opts.cpu, opts.net)
        rec["failed"] += rec["a"]["failed"]
    if "b" in opts.part:
        rec["b"] = run_b(torch, mx, kernels, opts)
        rec["failed"] += rec["b"]["failed"]
    rec["seconds"] = time.perf_counter() - t0
    print("torch_shard_check: %s in %.1f s  [%s]"
          % ("FAILED %d" % len(rec["failed"]) if rec["failed"] else "passed",
             rec["seconds"], card))
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(json.dumps(rec, default=str))
    return 1 if rec["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
