#!/usr/bin/env python3
"""Where a ResNet-50 train step over several cards departs from one
card's: one forward and backward of the PyTorch port's ResNet-50 NHWC
(seeded weights as tools/torch_dp_check.py draws them, seeded images) at
``--per-card`` x the cards, against one card at the same global batch,
in bfloat16 and in float32 (TF32 off), and one card against itself on
the batch's rows reordered (the summation-order floor); on the card
also the bfloat16 pair with cuDNN off, and each distinct convolution of
the network through ``F.conv2d`` in bfloat16 on the global batch against
its first ``--per-card`` rows alone.

    python3 tools/torch_bf16_cards_probe.py --report probe.json
    python3 tools/torch_bf16_cards_probe.py --cpu --cards 4 --per-card 2 \\
        --image 32

For each pair it records the outputs' normwise relative distance, each
parameter gradient's and each moving statistic's (after the step), in
the graph's order, and the first and the largest of them. Imports
neither jax nor the JAX package.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_check as dpc  # noqa: E402


def _rel(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(
        np.linalg.norm(a))


def one_step(mx, ctxs, args, aux, images, labels, dtype):
    """Outputs, gradients and moving statistics of one train forward and
    backward over ``ctxs`` (host arrays)."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    kw = {} if dtype is None else {"compute_dtype": dtype}
    mod = mx.mod.Module(sym, context=ctxs, **kw)
    mod.bind(data_shapes=[("data", images.shape)],
             label_shapes=[("softmax_label", labels.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()},
                    aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in aux.items()}, initializer=None)
    mod.forward(mx.io.DataBatch([mx.nd.array(images, ctx=mx.cpu())],
                                [mx.nd.array(labels, ctx=mx.cpu())]),
                is_train=True)
    out = mod.get_outputs()[0].asnumpy().copy()
    mod.backward()
    group = mod._exec_group
    ex = group.replicated or group.executor
    grads = {n: g.asnumpy().copy() for n, g in zip(ex.arg_names,
                                                   ex.grad_arrays)
             if g is not None and n in args}
    mod._params_dirty = True
    _, aux_after = mod.get_params()
    return {"out": out, "grads": grads,
            "aux": {k: v.asnumpy().copy() for k, v in aux_after.items()}}


def compare(got, want, order):
    """The distances of ``got`` from ``want``: outputs, and each gradient
    and moving statistic in ``order`` (the graph's)."""
    rec = {"outputs": _rel(got["out"], want["out"])}
    for what in ("grads", "aux"):
        rows = [(k, _rel(got[what][k], want[what][k]))
                for k in order if k in want[what]]
        worst = sorted(rows, key=lambda r: -r[1])[:8]
        first = next((r for r in rows if r[1] > 1e-4), None)
        rec[what] = {"worst": worst, "first_above_1e-4": first,
                     "in_order": rows}
    return rec


def conv_rows(torch, mx, per_card, n, image, cpu):
    """Each distinct convolution of ResNet-50 NHWC in bfloat16, through
    ``F.conv2d`` (the port's forward) on the global batch and on its
    first ``per_card`` rows: how many of the shapes give those rows other
    bits, and the largest relative difference there (cuDNN picks its
    algorithm by shape, the batch included)."""
    import torch.nn.functional as F

    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    batch = n * per_card
    _, outs, _ = internals.infer_shape(data=(batch, image, image, 3),
                                       softmax_label=(batch,))
    shapes = dict(zip(internals.list_outputs(), outs))
    seen, rec = set(), {"shapes": 0, "differ": 0, "worst_rel": 0.0}
    dev = "cpu" if cpu else "cuda:0"
    gen = torch.Generator(device="cpu").manual_seed(0)
    for node in sym._topo():
        if node.is_variable or node.op.op_name != "Convolution":
            continue
        src, i = node.inputs[0]
        name = src.name if src.is_variable else \
            "%s_%s" % (src.name, src.op.list_outputs()[i])
        x_shape = shapes.get(name) or (batch, image, image, 3)
        op = node.op
        key = (tuple(x_shape), op.num_filter, tuple(op.kernel),
               tuple(op.stride or (1, 1)), tuple(op.pad or (0, 0)))
        if key in seen:
            continue
        seen.add(key)
        x = torch.randn(x_shape, generator=gen).to(dev, torch.bfloat16)
        x = x.permute(0, 3, 1, 2)           # NCHW view, channels-last
        w = (torch.randn((op.num_filter, x_shape[-1]) + tuple(op.kernel),
                         generator=gen) * 0.05).to(dev, torch.bfloat16)
        w = w.contiguous(memory_format=torch.channels_last)
        kw = dict(stride=tuple(op.stride or (1, 1)),
                  padding=tuple(op.pad or (0, 0)))
        whole = F.conv2d(x, w, **kw)[:per_card].float()
        part = F.conv2d(x[:per_card], w, **kw).float()
        rec["shapes"] += 1
        if not torch.equal(whole, part):
            rec["differ"] += 1
            rel = float((whole - part).norm() / whole.norm())
            rec["worst_rel"] = max(rec["worst_rel"], rel)
    return rec


def run(torch, mx, n, per_card, image, cpu):
    batch = n * per_card
    rng = np.random.RandomState(2)
    images = rng.randn(batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, 1000, batch).astype(np.float32)
    args, aux = dpc.initial_params(mx, image)
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    order = [n_ for n_ in sym.list_arguments()] + \
        sym.list_auxiliary_states()
    cards = [mx.cpu(i) if cpu else mx.gpu(i) for i in range(n)]
    one = [mx.cpu() if cpu else mx.gpu(0)]
    roll = np.roll(np.arange(batch), per_card)
    rec = {}
    for dtype in ("bfloat16", None):
        key = dtype or "float32"
        ref = one_step(mx, one, args, aux, images, labels, dtype)
        multi = one_step(mx, cards, args, aux, images, labels, dtype)
        moved = one_step(mx, one, args, aux, images[roll], labels[roll],
                         dtype)
        moved["out"] = moved["out"][np.argsort(roll)]
        rec[key] = {"cards_vs_one": compare(multi, ref, order),
                    "reordered_vs_one": compare(moved, ref, order)}
    # the same bfloat16 pair with cuDNN off: F.conv2d then computes each
    # row alike at any batch size
    if not cpu:
        torch.backends.cudnn.enabled = False
        try:
            ref = one_step(mx, one, args, aux, images, labels, "bfloat16")
            multi = one_step(mx, cards, args, aux, images, labels,
                             "bfloat16")
        finally:
            torch.backends.cudnn.enabled = True
        rec["bfloat16_cudnn_off"] = {
            "cards_vs_one": compare(multi, ref, order)}
    rec["conv_rows_bfloat16"] = conv_rows(torch, mx, per_card, n, image,
                                          cpu)
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=0)
    parser.add_argument("--per-card", type=int, default=32)
    parser.add_argument("--image", type=int, default=224)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--report")
    opts = parser.parse_args()
    import torch

    import mxnet_tpu_torch as mx

    if not opts.cpu:
        if not torch.cuda.is_available():
            print("no card; pass --cpu", file=sys.stderr)
            return 2
        from mxnet_tpu_torch import _build

        _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = opts.cards or (4 if opts.cpu else torch.cuda.device_count())
    card = "cpu" if opts.cpu else dpc.card_line()
    print(card)
    rec = run(torch, mx, n, opts.per_card, opts.image, opts.cpu)
    rec["card"] = card
    print("conv rows, bfloat16:", rec["conv_rows_bfloat16"])
    for key in ("bfloat16", "float32", "bfloat16_cudnn_off"):
        for pair in ("cards_vs_one", "reordered_vs_one"):
            if pair not in rec.get(key, {}):
                continue
            r = rec[key][pair]
            print("%s %s: outputs %.4g; grads worst %s first>1e-4 %s; aux "
                  "worst %s first>1e-4 %s"
                  % (key, pair, r["outputs"], r["grads"]["worst"][:4],
                     r["grads"]["first_above_1e-4"], r["aux"]["worst"][:4],
                     r["aux"]["first_above_1e-4"]))
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
