#!/usr/bin/env python3
"""Data parallelism of the PyTorch port over several processes: ResNet-50
NHWC trained under the ``dist_sync`` kvstore by ``tools/launch.py``
workers, one card each, against one card that runs the same shards in
turn.

    python3 tools/torch_dist_check.py                     # every card
    python3 tools/torch_dist_check.py --world 4 --report dist.json
    python3 tools/torch_dist_check.py --cpu --world 4 --per-card 2 \\
        --image 32 --steps 2                              # rehearsal

The model and data are ``tools/torch_dp_check.py``'s: ResNet-50 NHWC
(1000 classes, 224 x 224, f32, TF32 off) with Xavier weights from seed 0
and the residual blocks' last BatchNorm gamma at 0.25, and 5 global
batches of ``--per-card`` x ``--world`` images from seed 0. Worker r
(``tools/launch.py -n WORLD``, one process a rank; the launcher sets no
local rank, so this tool maps rank r to card r % the visible cards)
takes rows r::WORLD of each global batch and trains through
``Module(context=gpu(r)).fit(kvstore="dist_sync")`` in the classic loop,
SGD (lr 0.0125, momentum 0.9, wd 1e-4, rescale 1 / the global batch, set
by the Module from the store's workers). Each step every worker pushes
its gradients as one list (one NCCL all-reduce of a flat buffer), and
every worker's store applies the same update to the same sum on its
card, then the weights are pulled into the module. BatchNorm is per
worker, as in the reference.

The reference runs in this process on one card: each step it runs the
WORLD shards' forward and backward in turn, each with its own moving
statistics (BatchNorm over its own rows), adds the gradients in rank
order, and applies the same update once.

Checks: every rank's params bit-identical after the fit (the same update
of the same all-reduced sum); rank 0's params, and each rank's moving
statistics against the reference's shard of that rank, within 4 float32
floors normwise as a share of the reference's update (the floor: the
larger distance that the reference moves when its images are scaled by
1 + 2^-23 or 1 - 2^-23; NCCL's reduction order is not rank order, so
this is a bound and not bit equality) and at least 1e-4; K3, K4 and K5
launched 105, 53 and 53 times a step on every card by the wrappers'
counts; a profiled step on each card running them and naming its NCCL
kernels. Then the control: the same run with one rank planted to keep
its own gradient where the all-reduce's sum belongs (the collective
still runs, so no rank hangs; the rescale stays 1 / the global batch),
which must land outside the bound.

Prints each rank's host ms a step (median of steps 2-5, the card
synchronised at each batch end), img/s over the world (the global batch
over the slowest rank's step) against one card at ``--per-card`` (the
classic loop, this process), the exchange's ms a step (161 per-key
all-reduces against one flat all-reduce, CUDA events, each rank), the
store's update ms, the peak memory a card; then one JSON object as the
last line. Exits non-zero when a check fails or a worker dies (naming
the ranks that left no result). ``--cpu`` rehearses the same path over
gloo with CPU contexts (no timing, no profiler, no launch counts).
Imports neither jax nor the JAX package.
"""
import argparse
import faulthandler
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

WORKER_TIMEOUT = 900           # seconds for one launch of the world


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shard(x, rank, world, batch, steps):
    """Rank ``rank``'s rows of each of ``steps`` global batches of
    ``batch``: rows rank::world of each, in step order."""
    return np.concatenate([x[s * batch:(s + 1) * batch][rank::world]
                           for s in range(steps)])


# ---------------------------------------------------------------------------
# a worker
# ---------------------------------------------------------------------------
def plant_local_gradient(kv):
    """The control's fault, on this rank only: every all-reduce of the
    store still runs (so that no rank waits forever), but the store
    updates with this rank's own gradient in place of the sum. The store
    is patched in place."""
    real = kv.all_reduce

    def keep_own(tensors):
        real(tensors)
        return [t.detach().clone() for t in tensors]
    kv.all_reduce = keep_own


def profile_step(torch, kernels, mod, batch):
    """One classic step (forward, backward, update) under torch.profiler:
    the compiled kernels' launches and the NCCL kernels on this rank's
    card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
    names, nccl, busy = [], {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = float(e.time_range.elapsed_us()) / 1e3
        names.append(e.name)
        busy += ms
        if "nccl" in e.name.lower():
            nccl[e.name] = nccl.get(e.name, 0.0) + ms
    return {"launches": kernels.launches_in(names), "kernel_ms": busy,
            "nccl_kernels": sorted(nccl), "nccl_ms": sum(nccl.values())}


def exchange_times(torch, kv, mod):
    """The exchange alone on copies of this rank's gradients: 161 per-key
    all-reduces in place against the store's (one flat copy, one
    all-reduce, views of it), and the store's update of the summed
    gradients (its multi-tensor SGD on the card), CUDA events, ms a
    call."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import distributed

    ex = mod._exec_group.execs[0]
    named = [(i, n) for i, n in enumerate(mod._param_names)
             if n in ex.grad_dict]
    grads = [ex.grad_dict[n].handle.clone() for _, n in named]
    out = {"keys": len(grads),
           "mb": sum(g.numel() * g.element_size() for g in grads) / 1e6}
    for what, exchange in (("per_key", distributed.all_reduce),
                           ("flat", kv.all_reduce)):
        kv.barrier()
        out["%s_ms" % what] = dp._event_ms(torch, lambda: exchange(grads))
    keys = [i for i, _ in named]
    sums = [mx.nd.NDArray(g, kv._store[k].context)
            for k, g in zip(keys, grads)]
    kv.barrier()
    out["update_ms"] = dp._event_ms(torch, lambda: kv._update(keys, sums))
    return out


def worker(work, opts):
    """One rank of the world: the fit, its results to ``work``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    rank = int(os.environ["MXTPU_WORKER_RANK"])
    world = int(os.environ["MXTPU_NUM_WORKERS"])
    cuda = not opts.cpu
    if cuda:
        mx.profiler.keep_cupti()      # it profiles a step
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx = mx.gpu(card)
    else:
        ctx = mx.cpu()
    params = np.load(os.path.join(work, "params.npz"))
    args = {k[4:]: params[k] for k in params.files if k.startswith("arg:")}
    aux = {k[4:]: params[k] for k in params.files if k.startswith("aux:")}
    images = np.load(os.path.join(work, "images.npy"), mmap_mode="r")
    labels = np.load(os.path.join(work, "labels.npy"))
    batch = opts.per_card * world
    x = _shard(images, rank, world, batch, opts.steps)
    y = _shard(labels, rank, world, batch, opts.steps)

    kv = mx.kv.create("dist_sync")
    if kv.rank != rank or kv.num_workers != world:
        raise RuntimeError("store rank %d of %d, launcher %d of %d"
                           % (kv.rank, kv.num_workers, rank, world))
    planted = opts.plant_rank == rank
    if planted:
        plant_local_gradient(kv)
    marks = []

    def on_batch(_):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.torch_device())
    mod = dp.resnet_module(mx, [ctx], opts.per_card, opts.image)
    kernels.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=opts.per_card), num_epoch=1,
            kvstore=kv, optimizer="sgd", optimizer_params=dp.OPT,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()},
            batch_end_callback=on_batch)
    launches = kernels.launch_counts()
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    rec = {"rank": rank, "world": world, "planted": planted,
           "context": str(ctx),
           "update_on_kvstore": mod._update_on_kvstore,
           "fused": mod._fused_step_active,
           "rescale_grad": mod._optimizer.rescale_grad,
           "launches": {k: launches[k] for k in dp.PER_REPLAY},
           "steps_ms": steps_ms,
           "step_ms": float(np.median(steps_ms)) if steps_ms else None}
    if cuda:
        rec["device"] = torch.cuda.get_device_name(card)
        rec["peak_gb"] = torch.cuda.max_memory_allocated(card) / 1e9
    a, b = mod.get_params()
    np.savez(os.path.join(work, "rank%d.npz" % rank),
             **{"arg:" + k: v.asnumpy() for k, v in a.items()},
             **{"aux:" + k: v.asnumpy() for k, v in b.items()})
    if cuda and opts.plant_rank < 0:
        last = slice(len(x) - opts.per_card, len(x))
        step = mx.io.DataBatch([mx.nd.array(x[last], ctx=mx.cpu())],
                               [mx.nd.array(y[last], ctx=mx.cpu())])
        kv.barrier()
        rec["profiled_step"] = profile_step(torch, kernels, mod, step)
        rec["exchange"] = exchange_times(torch, kv, mod)
    with open(os.path.join(work, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    # every rank's results on disk before any rank leaves the world
    kv.barrier()
    sys.stdout.flush()
    # skip interpreter teardown, where gloo's C++ teardown can abort after
    # the work is done (tests/torch_sp_ranks.py)
    os._exit(0)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
def launch(work, world, opts, plant_rank=-1):
    """Run the world through tools/launch.py; (rc, per-rank records and
    arrays, the ranks that left no result, the tail of stderr)."""
    for r in range(world):
        for ext in ("json", "npz"):
            path = os.path.join(work, "rank%d.%s" % (r, ext))
            if os.path.exists(path):
                os.remove(path)
    cmd = [sys.executable, os.path.join(TOOLS, "launch.py"), "-n",
           str(world), "--coordinator", "127.0.0.1:%d" % _free_port(),
           sys.executable, os.path.abspath(__file__), "--worker", work,
           "--per-card", str(opts.per_card), "--steps", str(opts.steps),
           "--image", str(opts.image), "--plant-rank", str(plant_rank)]
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
        rc, err = 124, (e.stderr or b"").decode(errors="replace") \
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


def reference_fit(torch, mx, ctx, args, aux, images, labels, world,
                  per_card, steps, image):
    """One card, the shards in turn: each step every shard's forward and
    backward with its own moving statistics, the gradients added in rank
    order, one update at rescale 1 / the global batch. Returns the params
    and each shard's moving statistics (numpy)."""
    batch = per_card * world
    mod = dp.resnet_module(mx, [ctx], per_card, image)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()},
                    aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params=dp.OPT + (("rescale_grad",
                                                   1.0 / batch),))
    ex = mod._exec_group.executor
    grads = [ex.grad_dict[n].handle for n in mod._param_names
             if n in ex.grad_dict]
    stats = [[a.handle.clone() for a in ex.aux_arrays]
             for _ in range(world)]
    shards = [(_shard(images, r, world, batch, steps),
               _shard(labels, r, world, batch, steps)) for r in range(world)]
    for s in range(steps):
        rows = slice(s * per_card, (s + 1) * per_card)
        total = None
        for r, (x, y) in enumerate(shards):
            for a, v in zip(ex.aux_arrays, stats[r]):
                a.handle.copy_(v)
            mod.forward_backward(mx.io.DataBatch(
                [mx.nd.array(x[rows], ctx=mx.cpu())],
                [mx.nd.array(y[rows], ctx=mx.cpu())]))
            for a, v in zip(ex.aux_arrays, stats[r]):
                v.copy_(a.handle)
            if total is None:
                total = [g.clone() for g in grads]
            else:
                for t, g in zip(total, grads):
                    t += g
        for g, t in zip(grads, total):
            g.copy_(t)
        mod.update()
    a, _ = mod.get_params()
    names = mod._exec_group.aux_names
    return ({k: v.asnumpy().copy() for k, v in a.items()},
            [{n: v.cpu().numpy() for n, v in zip(names, st)}
             for st in stats])


def one_card_step_ms(torch, mx, ctx, args, aux, images, labels, per_card,
                     steps, image, cuda):
    """The classic loop on one card at ``per_card`` (no store): host ms a
    step, median of steps 2 on, the card synchronised at each batch
    end."""
    marks = []

    def on_batch(_):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mod = dp.resnet_module(mx, [ctx], per_card, image)
    mod.fit(mx.io.NDArrayIter(images[:steps * per_card],
                              labels[:steps * per_card],
                              batch_size=per_card),
            num_epoch=1, kvstore="local", optimizer="sgd",
            optimizer_params=dp.OPT, fused_step=False,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()},
            batch_end_callback=on_batch)
    return float(np.median([1e3 * (b - a)
                            for a, b in zip(marks, marks[1:])]))


def _normwise_ranks(got, want, start):
    """The distance over every rank's moving statistics from the
    reference's shard of that rank, as a share of the reference's moves:
    sqrt(sum |got - want|^2 / sum |want - start|^2) over ranks and
    arrays."""
    num = den = 0.0
    for g, w in zip(got, want):
        for k in w:
            num += float(np.sum((g[k].astype(np.float64) - w[k]) ** 2))
            den += float(np.sum((w[k].astype(np.float64) - start[k]) ** 2))
    return (num / den) ** 0.5 if den else float("inf")


def _split(arrays):
    return ({k[4:]: v for k, v in arrays.items() if k.startswith("arg:")},
            {k[4:]: v for k, v in arrays.items() if k.startswith("aux:")})


def run(torch, mx, kernels, world, per_card=dp.PER_CARD, steps=dp.STEPS,
        image=dp.IMAGE, cpu=False, log=print):
    """The check over ``world`` processes; the record, with ``failed``
    (the failed checks' messages, empty when all pass)."""
    cuda = not cpu
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log("FAILED: " + msg)

    if cuda and world > torch.cuda.device_count():
        raise SystemExit("torch_dist_check: %d workers need %d cards (NCCL "
                         "refuses two ranks on one card); %d visible"
                         % (world, world, torch.cuda.device_count()))
    batch = per_card * world
    rng = np.random.RandomState(0)
    images = rng.randn(steps * batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, steps * batch).astype(np.float32)
    args0, aux0 = dp.initial_params(mx, image)
    opts = argparse.Namespace(per_card=per_card, steps=steps, image=image,
                              cpu=cpu)
    rec = {"world": world, "per_card": per_card, "global_batch": batch,
           "steps": steps, "image": image}
    work = tempfile.mkdtemp(prefix="torch_dist_check_")
    try:
        np.savez(os.path.join(work, "params.npz"),
                 **{"arg:" + k: v for k, v in args0.items()},
                 **{"aux:" + k: v for k, v in aux0.items()})
        np.save(os.path.join(work, "images.npy"), images)
        np.save(os.path.join(work, "labels.npy"), labels)
        t0 = time.perf_counter()
        rc, recs, arrays, missing, err = launch(work, world, opts)
        rec["launch_seconds"] = time.perf_counter() - t0
        rec["launch_rc"] = rc
        check(rc == 0 and not missing,
              "the world failed (launch.py rc %d); ranks that left no "
              "result: %s; stderr: %s" % (rc, missing, err))
        if missing:
            rec["failed"] = failed
            return rec
        rec["ranks"] = recs
        ctl = launch(work, world, opts, plant_rank=world - 1)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ctx = mx.cpu() if cpu else mx.gpu(0)
    want, want_stats = reference_fit(torch, mx, ctx, args0, aux0, images,
                                     labels, world, per_card, steps, image)
    floors = {"params": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        moved, moved_stats = reference_fit(
            torch, mx, ctx, args0, aux0, images * np.float32(scale), labels,
            world, per_card, steps, image)
        floors["params"] = max(floors["params"],
                               dp._normwise(moved, want, args0))
        floors["aux"] = max(floors["aux"], _normwise_ranks(
            moved_stats, want_stats, aux0))
    rec["float32_floor_normwise"] = floors
    bounds = {k: max(dp.FLOOR_FACTOR * v, dp.MIN_BOUND)
              for k, v in floors.items()}
    rec["bounds"] = bounds

    params = [_split(a)[0] for a in arrays]
    stats = [_split(a)[1] for a in arrays]
    unequal = [(r, k) for r in range(1, world) for k in params[0]
               if not np.array_equal(params[r][k], params[0][k])]
    rec["ranks_identical"] = not unequal
    check(not unequal, "ranks' params differ from rank 0's at %s"
          % unequal[:5])
    rec["params_vs_reference_normwise"] = dp._normwise(params[0], want,
                                                       args0)
    rec["aux_vs_reference_normwise"] = _normwise_ranks(stats, want_stats,
                                                       aux0)
    for what in ("params", "aux"):
        got = rec["%s_vs_reference_normwise" % what]
        check(got <= bounds[what], "%s differ from the one-card reference "
              "by %g of its update, bound %g (%d x the float32 floor %g)"
              % (what, got, bounds[what], dp.FLOOR_FACTOR, floors[what]))
    for r in recs:
        check(r["update_on_kvstore"] and not r["fused"],
              "rank %d: the update did not run on the store (classic "
              "loop, dist_sync)" % r["rank"])
        check(abs(r["rescale_grad"] - 1.0 / batch) < 1e-12,
              "rank %d: rescale_grad %g, want 1/%d" % (r["rank"],
                                                       r["rescale_grad"],
                                                       batch))
    if cuda:
        for r in recs:
            want_l = {k: v * steps for k, v in dp.PER_REPLAY.items()}
            check(r["launches"] == want_l, "rank %d: wrapper launches %s, "
                  "want %s" % (r["rank"], r["launches"], want_l))
            prof = r["profiled_step"]
            got = {k: prof["launches"][k] for k in dp.PER_REPLAY}
            check(got == dp.PER_REPLAY, "rank %d: the profiled step ran %s, "
                  "want %s" % (r["rank"], got, dp.PER_REPLAY))
            check(prof["nccl_kernels"], "rank %d: the profiled step names "
                  "no NCCL kernel" % r["rank"])
        slowest = max(r["step_ms"] for r in recs)
        rec["img_per_s"] = batch * 1e3 / slowest
        one_ms = one_card_step_ms(torch, mx, ctx, args0, aux0, images,
                                  labels, per_card, steps, image, cuda)
        rec["one_card_step_ms"] = one_ms
        rec["img_per_s_one_card"] = per_card * 1e3 / one_ms
        rec["speedup"] = rec["img_per_s"] / rec["img_per_s_one_card"]

    rc, ctl_recs, ctl_arrays, missing, err = ctl
    check(rc == 0 and not missing, "the control's world failed (rc %d); "
          "ranks that left no result: %s; stderr: %s" % (rc, missing, err))
    if not missing:
        planted = _split(ctl_arrays[world - 1])[0]
        dist_ctl = dp._normwise(planted, want, args0)
        caught = dist_ctl > bounds["params"]
        rec["control"] = {"fault": "rank %d keeps its own gradient where "
                                   "the all-reduce's sum belongs"
                                   % (world - 1),
                          "params_vs_reference_normwise": dist_ctl,
                          "caught": caught}
        check(caught, "the control (rank %d without the all-reduce) "
              "stayed within the bound: %g <= %g"
              % (world - 1, dist_ctl, bounds["params"]))
    rec["failed"] = failed
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=0,
                        help="worker processes (default: every visible "
                             "card; 4 with --cpu)")
    parser.add_argument("--per-card", type=int, default=dp.PER_CARD)
    parser.add_argument("--steps", type=int, default=dp.STEPS)
    parser.add_argument("--image", type=int, default=dp.IMAGE)
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse over gloo and CPU contexts")
    parser.add_argument("--report", help="write the record here (JSON)")
    parser.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--plant-rank", type=int, default=-1,
                        help=argparse.SUPPRESS)
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
            print("torch_dist_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        # built once here: the workers load the libraries
        _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    world = opts.world or (4 if opts.cpu else torch.cuda.device_count())
    card = "cpu" if opts.cpu else dp.card_line()
    print(card)
    t0 = time.perf_counter()
    rec = run(torch, mx, kernels, world, opts.per_card, opts.steps,
              opts.image, opts.cpu)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    rec["torch"] = torch.__version__
    if not opts.cpu and "ranks" in rec:
        for r in rec["ranks"]:
            ex = r.get("exchange", {})
            print("rank %d on %s: host %.3f ms a step, peak %.3f GB; "
                  "exchange of %d keys (%.1f MB): per key %.3f ms, flat "
                  "%.3f ms; store update %.3f ms; NCCL in a profiled step "
                  "%.3f ms (%s)"
                  % (r["rank"], r["device"], r["step_ms"], r["peak_gb"],
                     ex.get("keys", 0), ex.get("mb", 0.0),
                     ex.get("per_key_ms", float("nan")),
                     ex.get("flat_ms", float("nan")),
                     ex.get("update_ms", float("nan")),
                     r["profiled_step"]["nccl_ms"],
                     ", ".join(r["profiled_step"]["nccl_kernels"])[:200]))
        if "img_per_s" in rec:
            print("%d workers x %d, ResNet-50 NHWC f32 dist_sync classic: "
                  "%.1f img/s against %.1f on one card at %d (x%.3f); params "
                  "%.4g of the reference's update away (bound %.4g), moving "
                  "statistics %.4g (bound %.4g); control %.4g  [%s]"
                  % (world, opts.per_card, rec["img_per_s"],
                     rec["img_per_s_one_card"], opts.per_card,
                     rec["speedup"], rec["params_vs_reference_normwise"],
                     rec["bounds"]["params"],
                     rec["aux_vs_reference_normwise"],
                     rec["bounds"]["aux"],
                     rec.get("control", {}).get(
                         "params_vs_reference_normwise", float("nan")),
                     card))
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(json.dumps(rec, default=str))
    return 1 if rec["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
