"""Rank side of the port's sequence-parallel checks, shared by the gloo
parity test (tests/test_torch_parallel.py) and the check across cards
(tools/torch_sp_check.py); this file holds no tests. It imports neither
jax nor the JAX package, so the spawned ranks stay light.

:func:`spawn` starts ``world`` ranks joined through a file rendezvous,
gloo on the CPU or NCCL on one card each. Every rank takes its sequence
shard of the saved inputs, runs the port's ring and Ulysses attention,
causal and not, and one causal backward through each, and saves its
output and gradient shards, its flash-kernel launches and, when asked,
host times; :func:`spawn` hands them back concatenated along T for the
parent to compare."""
import multiprocessing
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops import kernels

IMPLS = ("ring", "ulysses")
BACKENDS = {"gloo": "cpu", "nccl": "cuda"}


def _shard(x, rank, world, dev):
    t = x.shape[1] // world
    return torch.from_numpy(x[:, rank * t:(rank + 1) * t]).contiguous().to(dev)


def run_rank(rank, world, backend, init_file, in_path, out_dir, timed_calls):
    cuda = BACKENDS[backend] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    dist.init_process_group(backend, init_method="file://" + init_file,
                            rank=rank, world_size=world)
    try:
        data = np.load(in_path)
        mesh = parallel.make_mesh({"sp": world}, device_type=BACKENDS[backend])
        res = {}
        q, k, v = (_shard(data[n], rank, world, dev) for n in ("q", "k", "v"))
        for impl in IMPLS:
            for causal in (False, True):
                key = "%s_%d" % (impl, causal)
                attn = parallel.make_ring_attention(mesh, "sp", causal=causal,
                                                    impl=impl)
                before = kernels.flash_attn_launches
                res["out_" + key] = attn(q, k, v).cpu().numpy()
                res["launches_" + key] = kernels.flash_attn_launches - before
                if timed_calls:
                    dist.barrier()
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(timed_calls):
                        attn(q, k, v)
                    sync()
                    res["host_ms_" + key] = \
                        1e3 * (time.perf_counter() - t0) / timed_calls
        for impl in IMPLS:
            leaves = [_shard(data[n], rank, world, dev).requires_grad_()
                      for n in ("gq", "gk", "gv")]
            attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                                impl=impl)
            (attn(*leaves) ** 2).sum().backward()
            for n, leaf in zip("qkv", leaves):
                res["grad_%s_%s" % (impl, n)] = leaf.grad.cpu().numpy()
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
        # every rank's sends done before any rank tears its group down
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # the results are on disk: skip interpreter teardown, where gloo's C++
    # teardown can abort ("terminate called without an active exception")
    # after all work is done, in about one two-rank run in twenty on a
    # loaded host
    os._exit(0)


def spawn(world, backend, in_path, out_dir, timeout, timed_calls=0):
    """Run ``world`` ranks over ``backend`` on the inputs saved at
    ``in_path`` (q, k, v and the gradient case's gq, gk, gv, each
    (B, T, H, D) with T divisible by ``world``); return (the ranks' exit
    codes, a dict of their results). Output and gradient shards come
    back concatenated along T; launches and host times per rank, as a
    list. Ranks still running after ``timeout`` seconds are killed."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank,
                         args=(r, world, backend,
                               os.path.join(out_dir, "init"), in_path,
                               out_dir, timed_calls))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        return codes, {}
    ranks = [np.load(os.path.join(out_dir, "rank%d.npz" % r))
             for r in range(world)]
    return codes, {key: (np.concatenate([r[key] for r in ranks], axis=1)
                         if ranks[0][key].ndim
                         else [r[key].item() for r in ranks])
                   for key in ranks[0].files}
