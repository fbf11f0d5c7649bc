#!/usr/bin/env python3
"""The PyTorch port's InferenceServer over several cards in one process:
dp replicas and the (dp, tp) grid.

    python3 tools/torch_tp_serve_check.py                 # every visible card
    python3 tools/torch_tp_serve_check.py --report tp_serve.json
    python3 tools/torch_tp_serve_check.py --cpu --cards 4 --per-group 2 \\
        --image 32 --vgg-image 32

The factorings of N cards: dp N, dp N/2 x tp 2 and tp N (dp 4, dp 2 x
tp 2 and tp 4 on four cards). Weights are seeded numpy draws (He-scaled
normals, BatchNorm gamma U(0.5, 1), beta and the moving means N(0, 0.1),
the moving variances U(0.5, 2)), float32 with TF32 off.

(a) ResNet-50 NHWC (1000 classes) at full width, ``--per-group`` (32)
seeded images of ``--image``^2 x 3 (224) a dp group, served through
``InferenceServer(tp=)`` at each factoring, against one card's
``FusedInfer`` on the same rows. Checks: the outputs within ``BOUND``
(1e-4) of one card's, normwise over the batch; the argmax equal on every
row whose top-2 log-probability margin exceeds ``BOUND``; K4
(``norm_act_fwd``) launched 53 times a forward on each card (the
profiler's kernel events by device, and the wrapper's count 53 x N); the
resident param bytes a card (the packed params, labels excepted) as
``tp_param_spec`` predicts them: every split param's 1/tp, the rest
whole, against dp's.

(b) VGG-16 (NCHW, 1000 classes, full width, ``--vgg-image`` 224) at tp N
on 32 rows: its fc6 of 25088 x 4096 holds 102.8M of its 138.4M params.
The param bytes a card against dp's (the predicted number is computed
from the shapes and printed beside it) and the outputs against one
card's, as in (a).

(c) Seeded requests (1 to the rows of a batch each) through each
factoring's server: every rung of the ladder a multiple of dp, the
compiles at most the number of buckets, no error, each request's rows
within ``BOUND`` of one card's ``FusedInfer`` on them; then the module
bound again (``force_rebind``) and the server refreshed twice: exactly
one rebuild, and the next batch within ``BOUND`` of the first's.

(d) Recorded, nothing claimed: img/s and host ms a batch at each
factoring against one card on the same rows (host clock, every card
synchronised after each call, median of ``TIMED``; with the ms until
the call returned, what the host spent enqueueing), each card's kernel
ms in a profiled forward, and ``infer.tp_gathers`` a forward (the
transient whole params gathered).

Then one JSON object as the last line; exits non-zero when a check
fails. ``--cpu`` rehearses over CPU contexts (no profiler, no timing).
Imports neither jax nor the JAX package.
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
import torch_dp_feed_check as dpf  # noqa: E402

BOUND = 1e-4                   # normwise on the outputs; the argmax margin
PER_GROUP = 32                 # rows a dp group
IMAGE = 224
BN_LAYERS = 53                 # K4 launches a ResNet-50 NHWC forward
REQUESTS = 12                  # (c) a factoring
TIMED = 10                     # (d) calls timed a factoring


def factorings(n):
    """``(dp, tp)`` of ``n`` cards: dp n, dp n/2 x tp 2, tp n."""
    out = [(n, 1)]
    if n % 2 == 0 and n > 2:
        out.append((n // 2, 2))
    if n > 1:
        out.append((1, n))
    return out


def tag(dp, tp):
    return "dp%d_tp%d" % (dp, tp)


def seeded_params(sym, data_shape, seed):
    """Seeded numpy args and aux states of ``sym`` at ``data_shape``."""
    rng = np.random.default_rng(seed)
    shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        elif name.endswith("beta") or name.endswith("bias"):
            v = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(np.sqrt(2.0 / fan_in))
        args[name] = v
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (rng.uniform(0.5, 2.0, shape).astype(np.float32)
                     if name.endswith("var")
                     else 0.1 * rng.standard_normal(shape,
                                                    dtype=np.float32))
    return args, aux


def bind(mx, sym, ctxs, batch_shape, args, aux):
    mod = mx.mod.Module(sym, context=ctxs)
    mod.bind(data_shapes=[("data", batch_shape)], for_training=False)
    mod.init_params(None, arg_params={
        n: mx.nd.array(v, ctx=mx.cpu()) for n, v in args.items()},
        aux_params={n: mx.nd.array(v, ctx=mx.cpu())
                    for n, v in aux.items()})
    return mod


def predicted_bytes(mx, sym, data_shape, dp, tp):
    """Param bytes a card on a (dp, tp) grid, from the shapes and
    ``tp_param_spec``: each split param's 1/tp, the rest whole."""
    from mxnet_tpu_torch.parallel.sharding import make_mesh, tp_shard_dim

    mesh = make_mesh({"dp": dp, "tp": tp},
                     devices=[mx.cpu(i) for i in range(dp * tp)])
    shapes, _, _ = sym.infer_shape(data=data_shape)
    total = 0
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        size = 4 * int(np.prod(shape))
        total += size // tp if tp_shard_dim(shape, mesh) is not None \
            else size
    return total


def normwise(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def argmax_rows(got, ref, bound):
    """``(decisive rows, rows among them whose argmax differs)``: a row
    is decisive when its top-2 log-probability margin exceeds
    ``bound``."""
    logp = np.log(np.maximum(ref.astype(np.float64), 1e-300))
    top2 = np.sort(logp, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > bound
    bad = decisive & (got.argmax(1) != ref.argmax(1))
    return int(decisive.sum()), [int(i) for i in np.flatnonzero(bad)]


def sync_all(torch, cuda):
    if cuda:
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def host_ms(torch, fn, cuda, reps=TIMED):
    """Median host ms of ``fn`` with every card synchronised after each
    call, and the median ms until ``fn`` returned (what the host spent
    enqueueing; two calls first, untimed)."""
    for _ in range(2):
        fn()
        sync_all(torch, cuda)
    times, enqueue = [], []
    for _ in range(reps):
        sync_all(torch, cuda)
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync_all(torch, cuda)
        times.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    return float(np.median(times)), float(np.median(enqueue))


def serve_factoring(torch, mx, kernels, sym, ctxs, dp, tp, args, aux,
                    images, ref_fused, cuda, check, requests=True,
                    log=print):
    """One factoring of the cards: the server's outputs, launches, param
    bytes, requests and rebuild, and its timing."""
    n = len(ctxs)
    rows = images.shape[0]
    shape = images.shape
    out = {"dp": dp, "tp": tp, "rows": rows}
    # bound at a batch the contexts divide; the server serves any rows
    bound = (-(-rows // n) * n,) + shape[1:]
    mod = bind(mx, sym, ctxs, bound, args, aux)
    srv = mx.serving.InferenceServer(mod, top_k=0, max_batch=rows, tp=tp,
                                     max_wait_ms=1.0, slo_ms=0.0)
    name = tag(dp, tp)
    try:
        check((srv.dp, srv.tp) == (dp, tp), "%s: the server serves dp %d "
              "tp %d" % (name, srv.dp, srv.tp))
        fused = srv._fused
        (got,) = srv.infer([images], timeout=600)
        (ref,) = ref_fused([images])[0]
        ref = ref.cpu().numpy()
        out["vs_one_card_normwise"] = normwise(got, ref)
        out["finite"] = bool(np.isfinite(got).all())
        check(out["finite"], "%s: outputs not finite" % name)
        check(out["vs_one_card_normwise"] <= BOUND, "%s: outputs %.3g of "
              "one card's, normwise (bound %g)"
              % (name, out["vs_one_card_normwise"], BOUND))
        decisive, flipped = argmax_rows(got, ref, BOUND)
        out["decisive_rows"] = decisive
        out["argmax_flipped_rows"] = flipped
        check(not flipped, "%s: argmax differs from one card's on "
              "decisive rows %s" % (name, flipped))
        out["param_bytes_by_card"] = [fused.param_bytes(k)
                                      for k in range(n)]
        out["param_bytes_predicted"] = predicted_bytes(mx, sym, shape, dp,
                                                       tp)
        check(out["param_bytes_by_card"] ==
              [out["param_bytes_predicted"]] * n,
              "%s: param bytes by card %s, predicted %d"
              % (name, out["param_bytes_by_card"],
                 out["param_bytes_predicted"]))
        g0 = fused.tp_gathers
        kernels.reset_launch_counts()
        fused([images])
        sync_all(torch, cuda)
        out["wrapper_launches_a_forward"] = kernels.launch_counts()
        out["tp_gathers_a_forward"] = fused.tp_gathers - g0
        if cuda:
            by_card, busy, _, _ = dpf.profile_by_card(
                torch, kernels, lambda: fused([images]), reps=1)
            out["launches_a_forward_by_card"] = by_card
            out["k4_a_forward_by_card"] = [
                by_card.get(d, {}).get("norm_act_fwd", 0) for d in range(n)]
            out["kernel_ms_a_forward_by_card"] = [busy.get(d, 0.0)
                                                  for d in range(n)]
            out["host_ms_a_batch"], out["enqueue_ms_a_batch"] = host_ms(
                torch, lambda: fused([images]), cuda)
            out["img_per_s"] = rows * 1e3 / out["host_ms_a_batch"]
            (out["one_card_host_ms_a_batch"],
             out["one_card_enqueue_ms_a_batch"]) = host_ms(
                torch, lambda: ref_fused([images]), cuda)
            out["one_card_img_per_s"] = rows * 1e3 / \
                out["one_card_host_ms_a_batch"]
        if requests:
            out["requests"] = serve_requests(mx, srv, mod, bound, images,
                                             ref_fused, dp, args, aux,
                                             check, name)
        log("%s: %.3g of one card's outputs, gathers %d a forward"
            % (name, out["vs_one_card_normwise"],
               out["tp_gathers_a_forward"]))
    finally:
        srv.close()
    del mod, srv
    if cuda:
        torch.cuda.empty_cache()
    return out


def serve_requests(mx, srv, mod, bound, images, ref_fused, dp, args, aux,
                   check, name):
    """(c): seeded requests through the server, then a re-bind."""
    rng = np.random.RandomState(5)
    rows = images.shape[0]
    sizes = [int(rng.randint(1, rows + 1)) for _ in range(REQUESTS)]
    starts = [int(rng.randint(0, rows - s + 1)) for s in sizes]
    compiles0 = srv.compiles
    reqs = [srv.submit([images[a:a + s]]) for a, s in zip(starts, sizes)]
    got = [r.get(600)[0] for r in reqs]
    stats = srv.stats()
    ref = [ref_fused([images[a:a + s]])[0][0].cpu().numpy()
           for a, s in zip(starts, sizes)]
    err = normwise(np.concatenate(got), np.concatenate(ref))
    rec = {"sizes": sizes, "buckets": list(srv.buckets),
           "batches_by_bucket": stats["batches_by_bucket"],
           "errors": stats["errors"], "compiles": srv.compiles,
           "compiles_before": compiles0, "vs_one_card_normwise": err}
    check(all(b % dp == 0 for b in srv.buckets), "%s: ladder %s has a "
          "rung that is not a multiple of dp %d" % (name, srv.buckets, dp))
    check(srv.compiles <= len(srv.buckets), "%s: %d compiles for %d "
          "buckets" % (name, srv.compiles, len(srv.buckets)))
    check(stats["errors"] == 0, "%s: serving errors %s" % (name, stats))
    check(all(g.shape[0] == s for g, s in zip(got, sizes)),
          "%s: a request's rows came back short" % name)
    check(err <= BOUND, "%s: requests %.3g of one card's (bound %g)"
          % (name, err, BOUND))
    (before,) = srv.infer([images], timeout=600)
    mod.bind(data_shapes=[("data", bound)], for_training=False,
             force_rebind=True)
    mod.init_params(None, force_init=True, arg_params={
        n: mx.nd.array(v, ctx=mx.cpu()) for n, v in args.items()},
        aux_params={n: mx.nd.array(v, ctx=mx.cpu())
                    for n, v in aux.items()})
    srv.refresh_params()
    srv.refresh_params()
    (after,) = srv.infer([images], timeout=600)
    rec["rebuilds"] = srv.executable_rebuilds
    rec["mesh_key_after"] = srv._fused.mesh_key
    rec["after_rebind_vs_before_normwise"] = normwise(after, before)
    check(srv.executable_rebuilds == 1, "%s: %d rebuilds after a re-bind "
          "and two refreshes, want 1" % (name, srv.executable_rebuilds))
    check(rec["after_rebind_vs_before_normwise"] <= BOUND,
          "%s: the rebuilt server's outputs %.3g of the first's"
          % (name, rec["after_rebind_vs_before_normwise"]))
    return rec


def run(torch, mx, kernels, n_cards, per_group=PER_GROUP, image=IMAGE,
        vgg_image=IMAGE, cpu=False, log=print):
    """(a)-(d) over ``n_cards``: the record, with ``failed`` listing
    every check that failed."""
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            log("FAILED: " + msg)

    cuda = not cpu
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ctxs = [mx.cpu(k) if cpu else mx.gpu(k) for k in range(n_cards)]
    one = mx.cpu() if cpu else mx.gpu(0)
    rec = {"cards": n_cards, "bound": BOUND, "per_group": per_group,
           "image": image, "factorings": [tag(*f) for f in
                                          factorings(n_cards)]}
    rng = np.random.default_rng(1)

    # (a), (c), (d): ResNet-50 NHWC
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    img = (image, image, 3)
    args, aux = seeded_params(sym, (per_group,) + img, seed=0)
    one_mod = bind(mx, sym, one, (per_group,) + img, args, aux)
    ref_fused = mx.fused_step.make_fused_infer(
        one_mod._exec_group.executor, ["data"])
    res = {"dp_param_bytes": ref_fused.param_bytes(0), "factorings": {}}
    for dp, tp in factorings(n_cards):
        images = rng.standard_normal((per_group * dp,) + img,
                                     dtype=np.float32)
        out = serve_factoring(torch, mx, kernels, sym, ctxs, dp, tp, args,
                              aux, images, ref_fused, cuda, check, log=log)
        k4 = out.get("k4_a_forward_by_card")
        if k4 is not None:
            check(k4 == [BN_LAYERS] * n_cards, "%s: K4 %s a forward by "
                  "card, want %d on each" % (tag(dp, tp), k4, BN_LAYERS))
        wrapped = out["wrapper_launches_a_forward"]["norm_act_fwd"]
        # on the CPU the wrapper runs K4's plain version and counts nothing
        want = BN_LAYERS * n_cards if cuda else 0
        check(wrapped == want, "%s: K4's wrapper counted %d a forward, "
              "want %d" % (tag(dp, tp), wrapped, want))
        res["factorings"][tag(dp, tp)] = out
    rec["resnet50"] = res
    del one_mod, ref_fused
    if cuda:
        torch.cuda.empty_cache()

    # (b): VGG-16 at tp n
    if n_cards > 1:
        vsym = mx.models.get_vgg(num_classes=1000, num_layers=16)
        vimg = (3, vgg_image, vgg_image)
        vargs, vaux = seeded_params(vsym, (per_group,) + vimg, seed=2)
        vone = bind(mx, vsym, one, (per_group,) + vimg, vargs, vaux)
        vref = mx.fused_step.make_fused_infer(vone._exec_group.executor,
                                              ["data"])
        images = rng.standard_normal((per_group,) + vimg, dtype=np.float32)
        out = serve_factoring(torch, mx, kernels, vsym, ctxs, 1, n_cards,
                              vargs, vaux, images, vref, cuda, check,
                              requests=False, log=log)
        out["dp_param_bytes"] = vref.param_bytes(0)
        out["params"] = int(sum(v.size for v in vargs.values()))
        out["fc6_params"] = int(vargs["fc6_weight"].size
                                + vargs["fc6_bias"].size)
        rec["vgg16"] = out
        del vone, vref
    rec["failed"] = failed
    return rec


def summary(rec, card):
    """The printed lines of a run."""
    lines = []
    res = rec.get("resnet50", {})
    for name, f in res.get("factorings", {}).items():
        req = f.get("requests", {})
        lines.append(
            "(a) ResNet-50 NHWC %s, %d rows: %.3g of one card's outputs "
            "(bound %g), %d decisive rows, argmax flips %s; K4 a forward "
            "by card %s; param bytes a card %d (dp %d); gathers %d a "
            "forward; (c) ladder %s, compiles %d, requests %.3g of one "
            "card's, rebuilds %d; (d) %.3f host ms a batch (%.3f until "
            "the call returned; kernel ms by card %s), %.1f img/s against "
            "one card's %.3f ms (%.3f), %.1f img/s  [%s]"
            % (name, f["rows"], f["vs_one_card_normwise"], rec["bound"],
               f["decisive_rows"], f["argmax_flipped_rows"],
               f.get("k4_a_forward_by_card"), f["param_bytes_by_card"][0],
               res["dp_param_bytes"], f["tp_gathers_a_forward"],
               req.get("buckets"), req.get("compiles", -1),
               req.get("vs_one_card_normwise", float("nan")),
               req.get("rebuilds", -1), f.get("host_ms_a_batch", 0.0),
               f.get("enqueue_ms_a_batch", 0.0),
               ["%.3f" % v for v in f.get("kernel_ms_a_forward_by_card",
                                          ())],
               f.get("img_per_s", 0.0), f.get("one_card_host_ms_a_batch",
                                              0.0),
               f.get("one_card_enqueue_ms_a_batch", 0.0),
               f.get("one_card_img_per_s", 0.0), card))
    v = rec.get("vgg16")
    if v is not None:
        lines.append(
            "(b) VGG-16 NCHW %s, %d rows: %.3g of one card's outputs, "
            "argmax flips %s; param bytes a card %d (predicted %d) against "
            "dp's %d (%.4f); %d params, fc6 %d; gathers %d a forward; %.3f "
            "host ms a batch (%.3f until the call returned; kernel ms by "
            "card %s) against one card's %.3f  [%s]"
            % (tag(v["dp"], v["tp"]), v["rows"], v["vs_one_card_normwise"],
               v["argmax_flipped_rows"], v["param_bytes_by_card"][0],
               v["param_bytes_predicted"], v["dp_param_bytes"],
               v["param_bytes_by_card"][0] / v["dp_param_bytes"],
               v["params"], v["fc6_params"], v["tp_gathers_a_forward"],
               v.get("host_ms_a_batch", 0.0), v.get("enqueue_ms_a_batch",
                                                    0.0),
               ["%.3f" % x for x in v.get("kernel_ms_a_forward_by_card",
                                          ())],
               v.get("one_card_host_ms_a_batch", 0.0), card))
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="cards (default: every visible one)")
    parser.add_argument("--per-group", type=int, default=PER_GROUP)
    parser.add_argument("--image", type=int, default=IMAGE)
    parser.add_argument("--vgg-image", type=int, default=IMAGE)
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse over CPU contexts")
    parser.add_argument("--report", help="write the record here (JSON)")
    opts = parser.parse_args()
    faulthandler.enable()
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    if not opts.cpu:
        mx.profiler.keep_cupti()
        if not torch.cuda.is_available():
            print("torch_tp_serve_check: no card; pass --cpu to rehearse",
                  file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        _build.build_all()
    n = opts.cards or (torch.cuda.device_count() if not opts.cpu else 4)
    card = dpc.card_line() if not opts.cpu else "cpu"
    print(card)
    t0 = time.perf_counter()
    rec = run(torch, mx, kernels, n, per_group=opts.per_group,
              image=opts.image, vgg_image=opts.vgg_image, cpu=opts.cpu)
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
