#!/usr/bin/env python3
"""K3 (the convolution-backward GEMM, ``conv_gemm``) with 16-bit operands
on the card: the 105 products of one ResNet-50 NHWC training step at
batch 32, timed and held against a float64 product, for one tree of the
port or for two in turns.

    python3 tools/torch_k3_16bit.py                 # this tree
    python3 tools/torch_k3_16bit.py --ab _parent    # parent, this, this, parent

Each tree runs in its own process (``--tree PATH`` imports
``mxnet_tpu_torch`` from PATH): it builds ``conv_gemm``, prints its
tensor-core MMA instructions by type, checks every product (bfloat16,
and float16 where the tree's wrapper takes it) within 1e-6 * sum|a||b|
of float64, then times each product (CUDA events, L2 flushed, as
``chip_smoke.time_ms``) and prints one JSON line: the step's summed ms by
dtype, beside the card's name and power limit. ``--ab`` compares an
older tree (a ``git archive`` of the parent commit) with this one on the
same card, in the order parent, this, this, parent.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(root, reps, check):
    import torch

    sys.path.insert(0, root)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import kernels

    sys.path.insert(1, HERE)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["conv_gemm"])
    counts_fn = getattr(_build, "mma_counts", None)
    sass = (counts_fn("conv_gemm") if counts_fn is not None
            else {"tf32": _build.tf32_mma_count("conv_gemm")})
    shapes = cs.conv_gemm_shapes(mx)
    dtypes = [torch.bfloat16]
    if torch.float16 in kernels._DTYPES:
        dtypes.append(torch.float16)
    out = {"tree": root, "card": cs.card_line(), "sass": sass,
           "products": sum(shapes.values()), "ms": {}, "worst_rel": {}}
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in dtypes:
        name = str(dtype).replace("torch.", "")
        total, worst = 0.0, 0.0
        for (m, n, k, trans), cnt in sorted(shapes.items()):
            a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            if check:
                got = kernels.matmul_f32acc(a, b, trans)
                ad = a.double().t() if trans else a.double()
                err = (got.double() - ad @ b.double()).abs()
                mag = ad.abs() @ b.double().abs()
                rel = float((err / mag.clamp(min=1e-30)).max())
                cs.check(rel <= 1e-6, "conv_gemm %s %s: %g of sum|a||b|"
                         % ((m, n, k, trans), name, rel))
                worst = max(worst, rel)
                del got, ad, err, mag
            total += cnt * cs.time_ms(
                torch, lambda: kernels.matmul_f32acc(a, b, trans), flush,
                reps)
            del a, b
        out["ms"][name] = total
        out["worst_rel"][name] = worst
    print(json.dumps(out))
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", help="time the port under this root")
    parser.add_argument("--ab", metavar="PARENT",
                        help="time PARENT and this tree in turns")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-check", action="store_true")
    opts = parser.parse_args()
    if opts.tree:
        return run_tree(os.path.abspath(opts.tree), opts.reps,
                        not opts.no_check)
    trees = [HERE] if not opts.ab else [os.path.abspath(opts.ab), HERE,
                                        HERE, os.path.abspath(opts.ab)]
    rows = []
    for root in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", root,
               "--reps", str(opts.reps)]
        if opts.no_check:
            cmd.append("--no-check")
        res = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print("tree %s failed (rc %d)" % (root, res.returncode))
            return 1
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    if opts.ab:
        print("bfloat16, 105 products a step, ms: parent %.4f / %.4f, this "
              "%.4f / %.4f  [%s]" % (rows[0]["ms"]["bfloat16"],
                                     rows[3]["ms"]["bfloat16"],
                                     rows[1]["ms"]["bfloat16"],
                                     rows[2]["ms"]["bfloat16"],
                                     rows[1]["card"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
