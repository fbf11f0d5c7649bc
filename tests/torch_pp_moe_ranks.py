"""Rank side of the port's pipeline and expert-parallel checks, shared by
the gloo parity test (tests/test_torch_pipeline_moe.py) and the check
across cards (tools/torch_pp_moe_check.py); this file holds no tests. It
imports neither jax nor the JAX package, so the spawned ranks stay
light.

:func:`spawn` starts ``world`` ranks joined through a file rendezvous,
gloo on the CPU or NCCL on one card each, over a plan of cases saved
beside the inputs (:func:`save_plan`). Every rank runs every case in
plan order on its part of the inputs (its stage, its slice of the batch,
its tokens and experts) and saves what it got; :func:`spawn` hands each
rank's results back for the parent to compare.

A case is a dict with ``kind`` ``"pp"`` or ``"moe"``, a ``tag`` (the
prefix of its inputs and results) and a ``mesh`` (axis -> size over the
world, in order). A ``pp`` case's inputs are ``w`` (stages, N, K: the
K1 layout), ``b`` (stages, N), ``mb`` (microbatches, rows, K) and, for
``step``, ``lab``; it runs ``pipeline_forward`` (``out``, ``launches``:
K1's launches on this rank), with ``grad`` one backward of the sum of
the squared outputs (``gw``, ``gb``: this rank's stage) and with
``step`` one ``build_pipeline_train_step`` step of the mean squared
error (``loss``, ``w_new``, ``b_new``), on DTensors when ``dtensor``. A
``moe`` case's inputs are the JAX package's params (``router``, ``w1``,
``b1``, ``w2``, ``b2``, all experts) and ``x`` (every rank's tokens in
rank order along ``ep``); it runs ``moe_ffn_local`` (``y``, ``aux``),
with ``grad`` one backward of this rank's share of the JAX test's loss
``mean((y - target)^2) + aux_weight * aux`` (``g_<name>``: this rank's
experts, and its router gradient before (``g_router_local``) and after
the sum over the axis (``g_router``)) and with ``train`` that many SGD
steps of it (``losses``). ``timed`` adds host-clock times with the
device synchronised (``ms_*``).
"""
import json
import multiprocessing
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops import kernels

BACKENDS = {"gloo": "cpu", "nccl": "cuda"}
MOE_NAMES = ("router", "w1", "b1", "w2", "b2")
TIMED_REPS = 10


def stage_fn(params, x):
    """One pipeline stage: tanh(x @ w.T + b) through K1 (the JAX tests'
    ``tanh(x @ w + b)`` with ``w`` kept in K1's (N, K) layout)."""
    return kernels.fused_linear(x, params["w"], params["b"], "tanh")


def mse(out, lab):
    return torch.mean((out - lab) ** 2)


def save_plan(out_dir, cases, arrays):
    """Write the plan (a list of case dicts) and its inputs (a dict of
    ``"<tag>.<name>"`` -> array) into ``out_dir``; return the inputs'
    path."""
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump(cases, f)
    path = os.path.join(out_dir, "in.npz")
    np.savez(path, **arrays)
    return path


class _Rank:
    def __init__(self, backend, rank, world):
        self.cuda = BACKENDS[backend] == "cuda"
        self.dev = torch.device("cuda", rank) if self.cuda \
            else torch.device("cpu")
        self.rank, self.world = rank, world

    def tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def ms(self, fn):
        """:func:`host_ms` of ``fn``, every rank starting together."""
        return host_ms(fn, self.sync, dist.barrier)


def host_ms(fn, sync, before=None, reps=TIMED_REPS):
    """Host ms a call of ``fn``, the mean of ``reps`` after one warm
    call, ``sync()`` (the device's) after the warm call and the last;
    ``before()`` runs just before the clock starts."""
    fn()
    sync()
    if before is not None:
        before()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def _pp_case(r, mesh, case, data, res):
    tag = case["tag"]
    pp = mesh.get_local_rank("pp")
    dp_n = case["mesh"].get("dp", 1)
    dp = mesh.get_local_rank("dp") if dp_n > 1 else 0
    mb_all = data[tag + ".mb"]
    rows = mb_all.shape[1] // dp_n
    cut = slice(dp * rows, (dp + 1) * rows)
    mb = r.tensor(mb_all[:, cut])
    stage = {"w": r.tensor(data[tag + ".w"][pp:pp + 1]),
             "b": r.tensor(data[tag + ".b"][pp:pp + 1])}
    before = kernels.linear_launches
    out = parallel.pipeline_forward(stage_fn, stage, mb, "pp", mesh=mesh)
    res[tag + ".launches"] = kernels.linear_launches - before
    res[tag + ".out"] = out.cpu().numpy()
    if case.get("grad"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in stage.items()}
        out = parallel.pipeline_forward(stage_fn, leaves, mb, "pp",
                                        mesh=mesh)
        (out ** 2).sum().backward()
        res[tag + ".gw"] = leaves["w"].grad.cpu().numpy()
        res[tag + ".gb"] = leaves["b"].grad.cpu().numpy()
    if case.get("step"):
        lab = r.tensor(data[tag + ".lab"][:, cut])
        step = parallel.build_pipeline_train_step(
            stage_fn, mse, mesh, mb.shape[0], pp_axis="pp",
            dp_axis="dp" if dp_n > 1 else None, lr=case["lr"])
        params = stage
        if case.get("dtensor"):
            spec = parallel.sharding.NamedSharding(
                mesh, parallel.sharding.PartitionSpec("pp"))
            params = parallel.shard_args(
                mesh, {k: data[tag + "." + k] for k in ("w", "b")},
                {"w": spec, "b": spec})
        loss, new = step(params, mb, lab)
        kinds = sorted({type(v).__name__ for v in new.values()})
        res[tag + ".kinds"] = np.array(",".join(kinds))
        for k, v in new.items():
            v = v.to_local() if hasattr(v, "to_local") else v
            res["%s.%s_new" % (tag, k)] = v.cpu().numpy()
        res[tag + ".loss"] = loss.item()
        if case.get("timed"):
            group = mesh.get_group("pp")
            y = out.detach()[0]
            res[tag + ".ms_step"] = r.ms(lambda: step(stage, mb, lab))
            with torch.no_grad():
                res[tag + ".ms_forward"] = r.ms(
                    lambda: parallel.pipeline_forward(stage_fn, stage, mb,
                                                      group=group))
                res[tag + ".ms_stage"] = r.ms(lambda: stage_fn(
                    {"w": stage["w"][0], "b": stage["b"][0]}, mb[0]))
                res[tag + ".ms_exchange"] = r.ms(
                    lambda: parallel._collectives._shift(group, y))
            x0 = mb[0].clone().requires_grad_(True)
            leaves = {"w": stage["w"][0].clone().requires_grad_(True),
                      "b": stage["b"][0].clone().requires_grad_(True)}

            def stage_fwd_bwd():
                stage_fn(leaves, x0).sum().backward()

            res[tag + ".ms_stage_fwd_bwd"] = r.ms(stage_fwd_bwd)


def _moe_case(r, mesh, case, data, res):
    tag = case["tag"]
    ep_n = case["mesh"]["ep"]
    ep = mesh.get_local_rank("ep")
    full = {k: data["%s.%s" % (tag, k)] for k in MOE_NAMES}
    local_e = full["w1"].shape[0] // ep_n
    mine = slice(ep * local_e, (ep + 1) * local_e)
    params = {k: r.tensor(full[k] if k == "router" else full[k][mine])
              for k in MOE_NAMES}
    x_all = data[tag + ".x"]
    s = x_all.shape[0] // ep_n
    x = r.tensor(x_all[ep * s:(ep + 1) * s])
    top_k, cf = case["top_k"], case["capacity_factor"]

    def layer(p):
        return parallel.moe_ffn_local(p, x, "ep", top_k, cf, mesh=mesh)

    y, aux = layer(params)
    res[tag + ".y"] = y.cpu().numpy()
    res[tag + ".aux"] = aux.item()
    if not (case.get("grad") or case.get("timed")):
        return
    target = r.tensor(data[tag + ".target"][ep * s:(ep + 1) * s])
    group = mesh.get_group("ep")

    def loss_and_grads(p):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, aux = layer(leaves)
        # this rank's share of the global loss: the sum over the axis is
        # mean((y - target)^2) over every token + aux_weight * aux
        loss = (mse(y, target) + case["aux_weight"] * aux) / ep_n
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        return total, grads

    if case.get("grad"):
        _, grads = loss_and_grads(params)
        # .numpy() of a CPU tensor shares its memory: copy before the sum
        res[tag + ".g_router_local"] = grads["router"].cpu().numpy().copy()
        dist.all_reduce(grads["router"], group=group)
        for k in MOE_NAMES:
            res["%s.g_%s" % (tag, k)] = grads[k].cpu().numpy()
        losses = []
        p = params
        for _ in range(case.get("train", 0)):
            loss, grads = loss_and_grads(p)
            dist.all_reduce(grads["router"], group=group)
            p = {k: p[k] - case["lr"] * grads[k] for k in MOE_NAMES}
            losses.append(loss.item())
        res[tag + ".losses"] = np.array(losses)
    if case.get("timed"):
        with torch.no_grad():
            res[tag + ".ms_forward"] = r.ms(lambda: layer(params))
        res[tag + ".ms_forward_backward"] = r.ms(
            lambda: loss_and_grads(params))
        from mxnet_tpu_torch.parallel.moe import expert_capacity

        cap = expert_capacity(s, local_e * ep_n, top_k, cf)
        buf = torch.zeros((ep_n, local_e, cap, x.shape[1]), device=r.dev)
        res[tag + ".ms_all_to_all"] = r.ms(
            lambda: parallel._collectives._all_to_all(buf, group))


def run_rank(rank, world, backend, init_file, out_dir):
    r = _Rank(backend, rank, world)
    if r.cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        # the ranks share the host's cores: with a compute thread a core
        # in every rank, the tool's rehearsal at its smallest spent 17 s
        # in its ranks against 6 s
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method="file://" + init_file,
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "plan.json")) as f:
            cases = json.load(f)
        data = np.load(os.path.join(out_dir, "in.npz"))
        res = {}
        for case in cases:
            mesh = parallel.make_mesh(case["mesh"],
                                      device_type=BACKENDS[backend])
            {"pp": _pp_case, "moe": _moe_case}[case["kind"]](
                r, mesh, case, data, res)
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
        # every rank's sends done before any rank tears its group down
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # the results are on disk: skip interpreter teardown, where gloo's C++
    # teardown can abort after all work is done (tests/torch_sp_ranks.py)
    os._exit(0)


def spawn(world, backend, out_dir, timeout):
    """Run ``world`` ranks over ``backend`` on the plan saved in
    ``out_dir``; return (the ranks' exit codes, a list of each rank's
    results as a dict). Ranks still running after ``timeout`` seconds
    are killed."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank,
                         args=(r, world, backend,
                               os.path.join(out_dir, "init"), out_dir))
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
        return codes, []
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, "rank%d.npz" % r)) as f:
            out.append({k: (f[k].item() if f[k].ndim == 0 else f[k])
                        for k in f.files})
    return codes, out
