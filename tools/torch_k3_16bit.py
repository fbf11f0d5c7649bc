#!/usr/bin/env python3
"""K3 (the convolution-backward GEMM, ``conv_gemm``) with 16-bit operands
on the card: the 105 products of one ResNet-50 NHWC training step at
batch 32, timed and held against a float64 product, for one tree of the
port or for two in turns.

    python3 tools/torch_k3_16bit.py                 # this tree
    python3 tools/torch_k3_16bit.py --ab _parent    # parent, this, this, parent
    python3 tools/torch_k3_16bit.py --sweep         # each split count, this tree

Each tree runs in its own process (``--tree PATH`` imports
``mxnet_tpu_torch`` from PATH): it builds ``conv_gemm``, prints its
tensor-core MMA instructions by type, checks every product (bfloat16,
and float16 where the tree's wrapper takes it) within 1e-6 * sum|a||b|
of float64, then times each product beside ``torch.mm(out_dtype=
float32)`` on the same operands (CUDA events, L2 flushed, as
``chip_smoke.time_ms``) and prints one JSON line: the step's summed ms by
dtype and each product's times, beside the card's name and power limit.
Operands are laid out as the tree's convolution path hands them to K3:
where the tree has ``kernels.pitched16`` (the 16-bit mainloop reads rows
at a pitch of a multiple of 8 elements), an operand of odd width (the
stem's M = 147) comes at a padded pitch, as ``_patches`` writes it, and
the padded copy that a contiguous caller would pay is timed apart.
``--ab`` compares an older tree (a ``git archive`` of the parent commit)
with this one on the same card, in the order parent, this, this, parent,
and prints the per-product table of both. ``--sweep`` times each product
in bf16 at every split count of whole 64-deep K blocks from 1 to
min(k // 256, 256) (at most 64 of them, spread evenly), beside the count
that the library's rule (``conv_gemm16_k_chunk``) picks: the data the
rule's cost model is held to.
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
    pitched = getattr(kernels, "pitched16", None)
    mm32 = cs._mm_f32_out(torch)
    out = {"tree": root, "card": cs.card_line(), "sass": sass,
           "products": sum(shapes.values()), "ms": {}, "library_ms": {},
           "bound_ms": {}, "worst_rel": {}, "shapes": {}}
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in dtypes:
        name = str(dtype).replace("torch.", "")
        total, lib_total, worst = 0.0, 0.0, 0.0
        nbytes_total, flops_total = 0, 0
        rows = out["shapes"][name] = []
        for (m, n, k, trans), cnt in sorted(shapes.items()):
            a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            row = {"m": m, "n": n, "k": k, "transpose_a": trans,
                   "per_step": cnt}
            if pitched is not None and a.shape[1] % 8:
                row["pad_copy_ms"] = cs.time_ms(torch, lambda: pitched(a),
                                                flush, reps)
                a = pitched(a)
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
            at = a.t() if trans else a
            row["ms"] = cs.time_ms(
                torch, lambda: kernels.matmul_f32acc(a, b, trans), flush,
                reps)
            row["library_ms"] = (cs.time_ms(torch, lambda: mm32(at, b),
                                            flush, reps)
                                 if mm32 is not None else None)
            nbytes = (m * k + k * n) * 2 + m * n * 4
            flops = 2 * m * n * k
            row["bound_ms"] = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                                        flops / cs.F16_FLOPS_PER_S)
            row["tflops"] = flops / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            total += cnt * row["ms"]
            lib_total += cnt * (row["library_ms"] or 0.0)
            nbytes_total += cnt * nbytes
            flops_total += cnt * flops
            del a, b, at
        out["ms"][name] = total
        out["library_ms"][name] = lib_total if mm32 is not None else None
        out["bound_ms"][name] = 1e3 * max(nbytes_total / cs.HBM_BYTES_PER_S,
                                          flops_total / cs.F16_FLOPS_PER_S)
        out["worst_rel"][name] = worst
    print(json.dumps(out))
    return 0


def sweep(reps):
    """Each product's bf16 time at each split count (the chunk handed to
    ``conv_gemm`` directly), the fastest and the rule's pick; one JSON
    line."""
    import torch

    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import kernels

    import chip_smoke as cs

    lib = _build.load("conv_gemm")
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": cs.card_line(), "shapes": []}
    for (m, n, k, trans), cnt in sorted(cs.conv_gemm_shapes(mx).items()):
        a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                        device="cuda").to(torch.bfloat16)
        if a.shape[1] % 8:
            a = kernels.pitched16(a)
        b = torch.randn(k, n, generator=gen, device="cuda").to(
            torch.bfloat16)
        c = torch.empty((m, n), dtype=torch.float32, device="cuda")
        chunks = sorted({-(-(-(-k // s)) // 64) * 64
                         for s in range(1, min(max(k // 256, 1), 256) + 1)})
        rule_chunk = lib.conv_gemm16_k_chunk(m, n, k)
        if len(chunks) > 64:
            chunks = chunks[::-(-len(chunks) // 64)] + [chunks[-1]]
        chunks = sorted(set(chunks) | {rule_chunk})
        times = {}
        for chunk in chunks:
            splits = -(-k // chunk)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device="cuda") if splits > 1 else None)

            def run():
                rc = lib.conv_gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                   None if ws is None else ws.data_ptr(),
                                   m, n, k, a.stride(0), b.stride(0),
                                   int(trans), 1, chunk, splits, stream)
                cs.check(rc == 0, "conv_gemm rc %d" % rc)
            times[splits] = cs.time_ms(torch, run, flush, reps)
            del ws
        rule = -(-k // rule_chunk)
        best = min(times, key=times.get)
        out["shapes"].append({"m": m, "n": n, "k": k, "transpose_a": trans,
                              "per_step": cnt, "ms_by_splits": times,
                              "rule_splits": rule, "best_splits": best})
        print("(%6d, %4d, %6d, %s) x%-2d rule %3d: %.4f ms, best %3d: %.4f ms"
              % (m, n, k, "T" if trans else "N", cnt, rule, times[rule],
                 best, times[best]))
        del a, b, c
    rule_sum = sum(r["per_step"] * r["ms_by_splits"][r["rule_splits"]]
                   for r in out["shapes"])
    best_sum = sum(r["per_step"] * r["ms_by_splits"][r["best_splits"]]
                   for r in out["shapes"])
    print("bf16 step sum: rule %.4f ms, best split per product %.4f ms  [%s]"
          % (rule_sum, best_sum, out["card"]))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", help="time the port under this root")
    parser.add_argument("--ab", metavar="PARENT",
                        help="time PARENT and this tree in turns")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-check", action="store_true")
    parser.add_argument("--report", help="write every tree's rows here")
    parser.add_argument("--sweep", action="store_true",
                        help="time every split count of each product")
    opts = parser.parse_args()
    if opts.sweep:
        res = sweep(opts.reps)
        if opts.report:
            with open(opts.report, "w") as f:
                json.dump(res, f, indent=1)
        return 0
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
        if opts.report:
            with open(opts.report, "w") as f:
                json.dump(rows, f, indent=1)
    for row in rows:
        print("%s: ms %s, torch.mm %s, bound %s, sass %s, worst %s"
              % (row["tree"], row["ms"], row.get("library_ms"),
                 row.get("bound_ms"), row["sass"], row["worst_rel"]))
    if opts.ab:
        for name in rows[1]["ms"]:
            if name not in rows[0]["ms"]:
                continue
            print_table(name, rows)
            print("%s, %d products a step, ms: parent %.4f / %.4f, this "
                  "%.4f / %.4f, torch.mm(out_dtype=float32) %.4f / %.4f, "
                  "bound %.4f  [%s]"
                  % (name, rows[1]["products"], rows[0]["ms"][name],
                     rows[3]["ms"][name], rows[1]["ms"][name],
                     rows[2]["ms"][name], rows[1]["library_ms"][name],
                     rows[2]["library_ms"][name], rows[1]["bound_ms"][name],
                     rows[1]["card"]))
    return 0


def print_table(name, rows):
    """Each product's kernel ms for the parent and this tree (the mean of
    their two runs), torch.mm's, the bound, this tree's TFLOP/s and share
    of the bound, and the padded copy where this tree makes one."""
    print("%s: (M, N, K, A^T) x per step: parent ms, this ms, torch.mm ms, "
          "bound ms, TFLOP/s, share of bound [, padded copy ms]" % name)
    parent = {(r["m"], r["n"], r["k"]): r for r in rows[0]["shapes"][name]}
    parent2 = {(r["m"], r["n"], r["k"]): r for r in rows[3]["shapes"][name]}
    this2 = {(r["m"], r["n"], r["k"]): r for r in rows[2]["shapes"][name]}
    for r in rows[1]["shapes"][name]:
        key = (r["m"], r["n"], r["k"])
        old = (parent[key]["ms"] + parent2[key]["ms"]) / 2
        new = (r["ms"] + this2[key]["ms"]) / 2
        lib = (r["library_ms"] + this2[key]["library_ms"]) / 2
        pad = r.get("pad_copy_ms")
        print("  (%6d, %4d, %6d, %s) x%-2d %.4f %.4f %.4f %.4f %6.1f %.2f%s"
              % (r["m"], r["n"], r["k"], "T" if r["transpose_a"] else "N",
                 r["per_step"], old, new, lib, r["bound_ms"],
                 2e-9 * r["m"] * r["n"] * r["k"] / new, r["bound_ms"] / new,
                 "" if pad is None else "  pad %.4f" % pad))


if __name__ == "__main__":
    sys.exit(main())
