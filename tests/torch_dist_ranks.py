"""Rank side of the port's dist-store tests (tests/test_torch_kvstore_dist.py);
this file holds no tests. ``tools/launch.py -n 2`` starts it, one process a
rank, on the CPU:

    python tools/launch.py -n 2 --coordinator 127.0.0.1:PORT \\
        python tests/torch_dist_ranks.py DIR

It reads ``DIR/inputs.npz`` (the parent's seeded params and data) and runs,
in one world, every case of the test file that needs several processes:

* a one-rank mesh made before the world (it gives way), then a mesh over
  the world (which it reuses);
* ``dist_sync``'s push/pull arithmetic (the JAX package's
  tests/test_dist_kvstore.py: rank 0's init broadcast, the push sums);
* fits under ``dist_sync``: the MLP on one context, the MLP over two
  contexts a rank, the two-stage NHWC ResNet; each rank's params (and
  moving statistics) after the fit;
* ``fit(fused_step=True)`` under a two-worker ``dist_sync``, which must
  raise naming the store;
* ``dist_async`` (rank 0 hosts the server thread): a push without an
  optimizer assigns, a server-side SGD over both ranks' pushes, a
  Module fit through the server, ``num_dead_node``, ``close``.

Each rank saves ``DIR/rank<r>.npz`` and ``DIR/rank<r>.json``. It imports
neither jax nor the JAX package.
"""
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import mxnet_tpu_torch as mx  # noqa: E402

MLP_BATCH = 16
RESNET_BATCH = 4
RESNET_HW = 16
OPT = {"learning_rate": 0.1, "momentum": 0.9}
RESNET_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


def mlp(pkg):
    """The MLP of the JAX package's tests/dist_util.py."""
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(data=net, act_type="relu")
    net = pkg.sym.FullyConnected(data=net, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def two_stage_resnet(pkg):
    with pkg.name.NameManager():
        return pkg.models.get_resnet([1, 1], [8, 16, 16], num_classes=10,
                                     small_input=True, layout="NHWC")


def _nd(arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def _fit(net, ctxs, kv, x, y, batch, args, aux, opt):
    mod = mx.mod.Module(net, context=ctxs)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
            kvstore=kv, optimizer="sgd", optimizer_params=opt,
            arg_params=_nd(args), aux_params=_nd(aux) if aux else None,
            initializer=None)
    a, b = mod.get_params()
    return mod, ({k: v.asnumpy().copy() for k, v in a.items()},
                 {k: v.asnumpy().copy() for k, v in b.items()})


def mesh_then_world(meta):
    """A one-rank group made by make_mesh (no launcher in sight) gives way
    to the launcher's world, and make_mesh then reuses the world."""
    from mxnet_tpu_torch import parallel

    launcher = {k: os.environ.pop(k) for k in
                ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS",
                 "MXTPU_WORKER_RANK")}
    meta["mesh_alone"] = parallel.mesh_axis_sizes(
        parallel.make_mesh({"sp": 1}, device_type="cpu"))
    os.environ.update(launcher)
    kv = mx.kv.create("dist_sync")
    meta["mesh_world"] = parallel.mesh_axis_sizes(
        parallel.make_mesh({"dp": kv.num_workers}, device_type="cpu"))


def sync_arithmetic(res):
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    res["sync_rank"], res["sync_workers"] = rank, kv.num_workers
    res["sync_type"] = type(kv).__name__
    kv.init(7, mx.nd.array(np.full((3, 3), 42.0 if rank == 0 else -1.0,
                                   np.float32), ctx=mx.cpu()))
    out = mx.nd.zeros((3, 3), ctx=mx.cpu())
    kv.pull(7, out=out)
    res["init_pulled"] = out.asnumpy().copy()
    kv.push(7, mx.nd.array(np.full((3, 3), rank + 1.0, np.float32),
                           ctx=mx.cpu()))
    kv.pull(7, out=out)
    res["push_sum"] = out.asnumpy().copy()
    kv.init(11, mx.nd.zeros((64, 64), ctx=mx.cpu()))
    kv.push(11, mx.nd.array(np.full((64, 64), (rank + 1) * 0.5, np.float32),
                            ctx=mx.cpu()))
    big = mx.nd.zeros((64, 64), ctx=mx.cpu())
    kv.pull(11, out=big)
    res["big_sum"] = big.asnumpy().copy()
    # a list of keys: one flat all-reduce, the same sums
    kv.init([20, 21], [mx.nd.zeros((5,), ctx=mx.cpu()),
                       mx.nd.zeros((2, 3), ctx=mx.cpu())])
    kv.push([20, 21], [mx.nd.array(np.arange(5, dtype=np.float32) * (rank + 1),
                                   ctx=mx.cpu()),
                       mx.nd.array(np.full((2, 3), rank + 2.0, np.float32),
                                   ctx=mx.cpu())])
    outs = [mx.nd.zeros((5,), ctx=mx.cpu()), mx.nd.zeros((2, 3), ctx=mx.cpu())]
    kv.pull([20, 21], out=outs)
    res["list_sum_a"], res["list_sum_b"] = (o.asnumpy().copy() for o in outs)
    kv.barrier()
    res["sync_barrier"] = True


def sync_fits(res, data, meta):
    rank = meta["rank"]
    x, y = data["mlp_x"][rank::2], data["mlp_y"][rank::2]
    args = {k[8:]: data[k] for k in data.files if k.startswith("mlp_arg_")}
    mod, (a, _) = _fit(mlp(mx), [mx.cpu()], mx.kv.create("dist_sync"), x, y,
                       MLP_BATCH, args, None, OPT)
    meta["mlp_update_on_kvstore"] = mod._update_on_kvstore
    meta["mlp_fused"] = mod._fused_step_active
    meta["mlp_rescale_grad"] = mod._optimizer.rescale_grad
    res.update({"mlp_" + k: v for k, v in a.items()})
    _, (a, _) = _fit(mlp(mx), [mx.cpu(0), mx.cpu(1)],
                     mx.kv.create("dist_sync"), x, y, MLP_BATCH, args, None,
                     OPT)
    res.update({"mlp2ctx_" + k: v for k, v in a.items()})

    x, y = data["resnet_x"][rank::2], data["resnet_y"][rank::2]
    args = {k[7:]: data[k] for k in data.files if k.startswith("rn_arg_")}
    aux = {k[7:]: data[k] for k in data.files if k.startswith("rn_aux_")}
    _, (a, b) = _fit(two_stage_resnet(mx), [mx.cpu()],
                     mx.kv.create("dist_sync"), x, y, RESNET_BATCH, args, aux,
                     RESNET_OPT)
    res.update({"rn_arg_" + k: v for k, v in a.items()})
    res.update({"rn_aux_" + k: v for k, v in b.items()})

    x, y = data["mlp_x"][rank::2], data["mlp_y"][rank::2]
    mod = mx.mod.Module(mlp(mx), context=mx.cpu())
    try:
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=MLP_BATCH), num_epoch=1,
                kvstore=mx.kv.create("dist_sync"), optimizer_params=OPT,
                fused_step=True)
        meta["fused_refusal"] = None
    except mx.MXNetError as e:
        meta["fused_refusal"] = str(e)


def async_cases(res, data, meta, out_dir):
    rank = meta["rank"]
    kv = mx.kv.create("dist_async")
    meta["async_type"] = type(kv).__name__
    meta["async_rank"], meta["async_workers"] = kv.rank, kv.num_workers
    meta["async_fused_compatible"] = kv.fused_step_compatible
    # without an optimizer a push assigns: the last writer wins
    kv.init(0, mx.nd.zeros((3,), ctx=mx.cpu()))
    kv.push(0, mx.nd.array(np.full((3,), rank + 1.0, np.float32),
                           ctx=mx.cpu()))
    kv.barrier()
    out = mx.nd.zeros((3,), ctx=mx.cpu())
    kv.pull(0, out)
    res["async_assigned"] = out.asnumpy().copy()
    # the server's SGD on each push: 5 pushes of ones from each rank
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    kv.init(1, mx.nd.zeros((2,), ctx=mx.cpu()))
    for _ in range(5):
        kv.push(1, mx.nd.array(np.ones((2,), np.float32), ctx=mx.cpu()))
    kv.barrier()
    w = mx.nd.zeros((2,), ctx=mx.cpu())
    kv.pull(1, w)
    res["async_sgd"] = w.asnumpy().copy()
    kv.barrier()
    # a Module through the server: its optimizer runs there
    x, y = data["mlp_x"][rank::2], data["mlp_y"][rank::2]
    args = {k[8:]: data[k] for k in data.files if k.startswith("mlp_arg_")}
    mod, (a, _) = _fit(mlp(mx), [mx.cpu()], mx.kv.create("dist_async"), x,
                       y, MLP_BATCH, args, None, {"learning_rate": 0.1})
    meta["async_update_on_kvstore"] = mod._update_on_kvstore
    meta["async_fit_finite"] = bool(all(np.isfinite(v).all()
                                        for v in a.values()))
    meta["async_fit_moved"] = bool(any(
        not np.array_equal(a[k], args[k]) for k in args))
    kv.barrier()
    meta["async_dead_before_close"] = kv.num_dead_node()
    kv.barrier()
    closed = os.path.join(out_dir, "closed_1")
    if rank == 1:
        mod._kvstore.close()
        kv.close()
        open(closed, "w").close()
    else:
        deadline = time.monotonic() + 30
        while not os.path.exists(closed) and time.monotonic() < deadline:
            time.sleep(0.05)
        meta["async_dead_after_close"] = kv.num_dead_node()
        mod._kvstore.close()
        kv.close()


def main(out_dir):
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    res, first = {}, {}
    mesh_then_world(first)
    sync_arithmetic(res)
    meta = {"rank": int(res["sync_rank"]), "workers": int(res["sync_workers"]),
            "store": res.pop("sync_type"), **first}
    sync_fits(res, data, meta)
    async_cases(res, data, meta, out_dir)
    rank = meta["rank"]
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(meta, f)
    # every rank's results are on disk before any rank leaves the world
    from mxnet_tpu_torch.parallel import distributed

    distributed.barrier()
    # skip interpreter teardown, where gloo's C++ teardown can abort after
    # the work is done (tests/torch_sp_ranks.py)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
