#!/usr/bin/env python3
"""Ring and Ulysses attention of the PyTorch port across ranks, against
reference attention on the whole sequence.

    python3 tools/torch_sp_check.py --world 4 --backend nccl    # 4 cards
    python3 tools/torch_sp_check.py --world 4 --backend gloo --seq 256

Spawns ``--world`` ranks through tests/torch_sp_ranks.py (the harness of
the gloo parity test), NCCL on one card each or gloo on the CPU, on
seeded inputs of shape (1, --seq, 8, 32), the long-context demo's heads
and width. Each rank runs ``parallel.make_ring_attention`` on its
sequence shard for impl ring and ulysses, causal and not, and one causal
backward through each. Here the shards, concatenated along T, must lie
within rtol 2e-4 / atol 2e-5 of ``reference_attention`` on the whole
sequence, and the gradients of the summed squared output within rtol
1e-3 / atol 1e-4 of autograd through the reference; ulysses must have
launched the flash kernel once a call on each card and the ring never.
Each impl's forward is timed on the host clock (mean of 5 calls after
the checked one, the card synchronised). Prints one JSON object; exits
non-zero when a check fails. Imports neither jax nor the JAX package.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_sp_ranks  # noqa: E402

HEADS, DIM, SEED = 8, 32, 0
TIMED_CALLS = 5
TIMEOUT_S = 600


def _within(got, want, rtol, atol):
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--backend", choices=sorted(torch_sp_ranks.BACKENDS),
                        default="nccl")
    parser.add_argument("--seq", type=int, default=4096)
    opts = parser.parse_args()
    world = opts.world
    if opts.seq % world or HEADS % world:
        parser.error("--seq and the %d heads must be multiples of --world"
                     % HEADS)
    import torch

    from mxnet_tpu_torch import parallel

    cuda = torch_sp_ranks.BACKENDS[opts.backend] == "cuda"
    card = None
    if cuda:
        if torch.cuda.device_count() < world:
            print("torch_sp_check: %d ranks need %d cards, %d visible"
                  % (world, world, torch.cuda.device_count()),
                  file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    rng = np.random.RandomState(SEED)
    full = [rng.randn(1, opts.seq, HEADS, DIM).astype(np.float32)
            for _ in range(3)]
    with tempfile.TemporaryDirectory() as d:
        in_path = os.path.join(d, "in.npz")
        np.savez(in_path, q=full[0], k=full[1], v=full[2], gq=full[0],
                 gk=full[1], gv=full[2])
        codes, res = torch_sp_ranks.spawn(world, opts.backend, in_path, d,
                                          TIMEOUT_S, TIMED_CALLS)
    checks = {}
    if res:
        # the reference on the whole sequence, after the ranks have let
        # the card go
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = "cuda" if cuda else "cpu"
        ref = [torch.from_numpy(x).to(dev).requires_grad_() for x in full]
        for causal in (False, True):
            with torch.no_grad():
                want = parallel.reference_attention(*ref, causal=causal)
            for impl in torch_sp_ranks.IMPLS:
                key = "%s_%d" % (impl, causal)
                ok, err = _within(torch.from_numpy(res["out_" + key]).to(dev),
                                  want, 2e-4, 2e-5)
                launches = res["launches_" + key]
                ok = ok and launches == [int(impl == "ulysses" and cuda)] * world
                checks["%s causal=%s" % (impl, causal)] = {
                    "ok": ok, "max_abs_err": err,
                    "flash_attn_launches": launches}
        (parallel.reference_attention(*ref, causal=True) ** 2).sum().backward()
        for impl in torch_sp_ranks.IMPLS:
            worst, ok = 0.0, True
            for n, r in zip("qkv", ref):
                got = torch.from_numpy(res["grad_%s_%s" % (impl, n)]).to(dev)
                good, err = _within(got, r.grad, 1e-3, 1e-4)
                ok, worst = ok and good, max(worst, err)
            checks["%s grads" % impl] = {"ok": ok, "max_abs_err": worst}
    ok = codes == [0] * world and bool(checks) and \
        all(c["ok"] for c in checks.values())
    summary = {"ok": ok, "exitcodes": codes, "card": card,
               "shape": [1, opts.seq, HEADS, DIM], "world": world,
               "backend": opts.backend, "checks": checks,
               "host_ms_slowest_rank": {
                   key[len("host_ms_"):]: max(res[key])
                   for key in res if key.startswith("host_ms_")}}
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
