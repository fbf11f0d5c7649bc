"""The dist stores of the port (``dist_sync`` over torch.distributed,
``dist_async`` with its parameter server and ``kvstore_server``) against
the JAX package's.

Two ranks run as two processes under ``tools/launch.py`` on the CPU (gloo),
every case of that world in one spawn (``tests/torch_dist_ranks.py``,
jax-free), on OS-chosen free ports. The JAX references run here, in one
process: a two-process ``dist_sync`` fit of the JAX package computes, on
every rank, the SGD update of g0 + g1 (each rank's gradient of its own
shard, BatchNorm over its own rows); here two JAX modules take the two
shards from the same params and push their gradients as one list into a
JAX ``local`` store with the optimizer at rescale_grad 1 / (2 x batch),
whose tree sum of two is the same single addition. Bounds: rtol 1e-5 /
atol 1e-6 against the JAX package; the ranks bit-identical; the
push/pull arithmetic exact. The parameter servers run in this process on
port 0 (the OS picks)."""
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import ps as jps
from mxnet_tpu_torch.parallel import ps as tps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_ranks as ranks  # noqa: E402

MLP_ROWS = 128             # 64 a rank: 4 steps of 16
RN_ROWS = 24               # 12 a rank: 3 steps of 4
SECRET = "test-token"


def _free_port_pair():
    """A port p with p and p + 1 free (the coordinator and dist_async's
    parameter server, which the launcher puts at the coordinator's port
    + 1)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            if p >= 65535:
                continue
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
                return p
    raise RuntimeError("no free port pair")


def _inputs():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, MLP_ROWS).astype(np.float32)
    x = (rng.randn(MLP_ROWS, 8).astype(np.float32) * 0.5 + y[:, None])
    out = {"mlp_x": x, "mlp_y": y}
    rng = np.random.RandomState(1)
    mlp_args = {"fc1_weight": rng.randn(8, 8) * 0.3, "fc1_bias": np.zeros(8),
                "fc2_weight": rng.randn(2, 8) * 0.3, "fc2_bias": np.zeros(2)}
    out.update({"mlp_arg_" + k: v.astype(np.float32)
                for k, v in mlp_args.items()})
    from test_torch_common import random_params

    net = ranks.two_stage_resnet(tmx)
    hw = ranks.RESNET_HW
    args, aux = random_params(net, (ranks.RESNET_BATCH, hw, hw, 3), seed=2)
    for k in args:
        if k.endswith("_b3_bn_gamma"):
            args[k] = np.full_like(args[k], 0.25)
    out.update({"rn_arg_" + k: v for k, v in args.items()})
    out.update({"rn_aux_" + k: v for k, v in aux.items()})
    rng = np.random.RandomState(9)
    out["resnet_x"] = rng.randn(RN_ROWS, hw, hw, 3).astype(np.float32)
    out["resnet_y"] = rng.randint(0, 10, RN_ROWS).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results: (inputs, [rank 0's arrays, rank 1's],
    [their metadata])."""
    out = tmp_path_factory.mktemp("dist_world")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               MXTPU_PS_SECRET=SECRET)
    for k in ("MXTPU_PS_PORT", "MXTPU_PS_SECRET_FILE", "MXTPU_PS_INSECURE"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n", "2",
         "--coordinator", "127.0.0.1:%d" % port, sys.executable,
         os.path.join(REPO, "tests", "torch_dist_ranks.py"), str(out)],
        capture_output=True, text=True, env=env, timeout=180)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    arrays = [dict(np.load(out / ("rank%d.npz" % r))) for r in range(2)]
    metas = [json.loads((out / ("rank%d.json" % r)).read_text())
             for r in range(2)]
    return inputs, arrays, metas


# ---------------------------------------------------------------------------
# the JAX reference of a two-process dist_sync fit
# ---------------------------------------------------------------------------
def _jax_dist_fit(net, args, aux, x, y, batch, opt):
    """Two JAX modules on the two ranks' shards (rows r::2) from the same
    params; each step their gradients go into a JAX ``local`` store as
    one list (the sum g0 + g1) with SGD at rescale_grad 1 / (2 x batch),
    and the weights are pulled into both. Returns the params (equal on
    both) and each rank's moving statistics."""
    mods = []
    for r in range(2):
        mod = jmx.mod.Module(net, context=jmx.cpu())
        mod.bind([("data", (batch,) + x.shape[1:])],
                 [("softmax_label", (batch,))])
        mod.init_params(arg_params={k: jmx.nd.array(v)
                                    for k, v in args.items()},
                        aux_params={k: jmx.nd.array(v)
                                    for k, v in aux.items()} or None)
        mods.append(mod)
    names = mods[0]._param_names
    kv = jmx.kv.create("local")
    kv.set_optimizer(jmx.optimizer.create(
        "sgd", rescale_grad=1.0 / (2 * batch),
        param_idx2name=dict(enumerate(names)), **opt))
    for i, n in enumerate(names):
        kv.init(i, mods[0]._exec_group.executor.arg_dict[n])
    shards = [(x[r::2], y[r::2]) for r in range(2)]
    for s in range(len(shards[0][0]) // batch):
        for mod, (xs, ys) in zip(mods, shards):
            sl = slice(s * batch, (s + 1) * batch)
            mod.forward_backward(jmx.io.DataBatch([jmx.nd.array(xs[sl])],
                                                  [jmx.nd.array(ys[sl])]))
        for i, n in enumerate(names):
            execs = [m._exec_group.executor for m in mods]
            kv.push(i, [e.grad_dict[n] for e in execs])
            kv.pull(i, out=[e.arg_dict[n] for e in execs])
    ex = [m._exec_group.executor for m in mods]
    params = {n: ex[0].arg_dict[n].asnumpy() for n in names}
    stats = [{n: a.asnumpy() for n, a in e.aux_dict.items()} for e in ex]
    return params, stats


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _close(got, want, rtol=1e-5, atol=1e-6):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# dist_sync over two processes
# ---------------------------------------------------------------------------
def test_dist_sync_push_pull_arithmetic_is_exact(world):
    """The JAX package's tests/test_dist_kvstore.py arithmetic: rank 0's
    init broadcast (42), the push sums (1 + 2 = 3; 0.5 + 1.0 = 1.5), a
    list of keys summed through one flat buffer, the barrier."""
    _, arrays, metas = world
    for r, (res, meta) in enumerate(zip(arrays, metas)):
        assert meta["rank"] == r and meta["workers"] == 2
        assert meta["store"] == "KVStoreDist"
        # make_mesh's one-rank group gave way to the world, then a mesh
        # over the world reused it
        assert meta["mesh_alone"] == {"sp": 1}
        assert meta["mesh_world"] == {"dp": 2}
        np.testing.assert_array_equal(res["init_pulled"],
                                      np.full((3, 3), 42.0))
        np.testing.assert_array_equal(res["push_sum"], np.full((3, 3), 3.0))
        np.testing.assert_array_equal(res["big_sum"],
                                      np.full((64, 64), 1.5))
        np.testing.assert_array_equal(res["list_sum_a"],
                                      np.arange(5, dtype=np.float32) * 3)
        np.testing.assert_array_equal(res["list_sum_b"],
                                      np.full((2, 3), 5.0))
        assert res["sync_barrier"]


def test_host_numpy_sum_and_broadcast_over_two_processes(world):
    """Queue C item 14 at two ranks: ``all_reduce_np`` sums the ranks'
    arrays (0 1 2 and 0 2 4), ``broadcast_np`` gives rank 1's array to
    both, dtype kept, after a named barrier."""
    _, arrays, _ = world
    for res in arrays:
        np.testing.assert_array_equal(res["all_reduce_np"], [0.0, 3.0, 6.0])
        assert res["broadcast_np"].dtype == np.float32
        np.testing.assert_array_equal(res["broadcast_np"], [6.0, 6.0])


def test_mlp_fit_matches_the_jax_package(world):
    """The dist_util MLP, 2 ranks x batch 16, SGD momentum 0.9: the update
    runs on the store, rescale_grad is 1 / 32, the ranks are
    bit-identical and match the JAX package's two-process result."""
    inputs, arrays, metas = world
    for meta in metas:
        assert meta["mlp_update_on_kvstore"] and not meta["mlp_fused"]
        assert meta["mlp_rescale_grad"] == 1.0 / 32
    got = [_prefixed(a, "mlp_") for a in arrays]
    _identical(got[0], got[1])
    want, _ = _jax_dist_fit(ranks.mlp(jmx), _prefixed(inputs, "mlp_arg_"),
                            {}, inputs["mlp_x"], inputs["mlp_y"],
                            ranks.MLP_BATCH, ranks.OPT)
    start = _prefixed(inputs, "mlp_arg_")
    assert any(not np.allclose(want[k], start[k]) for k in start)
    _close(got[0], want)


def test_two_stage_resnet_fit_matches_the_jax_package(world):
    """A two-stage NHWC ResNet (BatchNorm per rank, the plain versions of
    K3 and K5 on the path): params bit-identical on the ranks and each
    rank's moving statistics its own shard's, against the JAX package."""
    inputs, arrays, _ = world
    args = [_prefixed(a, "rn_arg_") for a in arrays]
    aux = [_prefixed(a, "rn_aux_") for a in arrays]
    _identical(args[0], args[1])
    want, stats = _jax_dist_fit(
        ranks.two_stage_resnet(jmx), _prefixed(inputs, "rn_arg_"),
        _prefixed(inputs, "rn_aux_"), inputs["resnet_x"],
        inputs["resnet_y"], ranks.RESNET_BATCH, ranks.RESNET_OPT)
    _close(args[0], want)
    for r in range(2):
        _close(aux[r], stats[r])
    # per worker, as in the reference: the two ranks' statistics differ
    assert any(not np.array_equal(aux[0][k], aux[1][k]) for k in aux[0])


def test_update_over_two_contexts_counts_the_batch_once(world):
    """Module.update over 2 CPU contexts x 2 ranks pushes one context's
    copy of the exchanged gradient: the fit equals 1 context x 2 ranks on
    the same global batch."""
    _, arrays, _ = world
    one = _prefixed(arrays[0], "mlp_")
    two = [_prefixed(a, "mlp2ctx_") for a in arrays]
    _identical(two[0], two[1])
    _close(two[0], one)


def test_two_workers_refuse_the_fused_step_naming_the_store(world):
    _, _, metas = world
    for meta in metas:
        msg = meta["fused_refusal"]
        assert msg is not None and "kvstore 'dist_sync'" in msg, msg
        assert "2 workers" in msg and "all-reduces" in msg, msg


def test_dist_async_over_two_processes(world):
    """dist_async: rank 0 hosts the server; a push without an optimizer
    assigns (the last writer wins); the server's SGD takes all 10 pushes
    (w = -0.5 x 10); a Module fits through it; no dead node before or
    after both ranks close."""
    _, arrays, metas = world
    for r, (res, meta) in enumerate(zip(arrays, metas)):
        assert meta["async_type"] == "KVStoreDistAsync"
        assert (meta["async_rank"], meta["async_workers"]) == (r, 2)
        assert meta["async_fused_compatible"] is False
        assert res["async_assigned"][0] in (1.0, 2.0)
        np.testing.assert_allclose(res["async_sgd"], [-5.0, -5.0],
                                   atol=1e-6)
        assert meta["async_update_on_kvstore"]
        assert meta["async_fit_finite"] and meta["async_fit_moved"]
        assert meta["async_dead_before_close"] == 0
    assert metas[0]["async_dead_after_close"] == 0


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
@pytest.fixture
def no_launcher(monkeypatch):
    for k in ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("name", ["dist_sync", "dist", "dist_sync_all",
                                  "DIST_SYNC"])
def test_create_routes_dist_names_as_the_reference(no_launcher, name):
    mine, theirs = tmx.kv.create(name), jmx.kv.create(name)
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.type == theirs.type
    assert (mine.rank, mine.num_workers) == (theirs.rank,
                                             theirs.num_workers) == (0, 1)
    assert mine.fused_step_compatible == theirs.fused_step_compatible
    assert mine.in_jit_gradient_exchange == theirs.in_jit_gradient_exchange
    assert mine.fused_fallback == theirs.fused_fallback is None
    assert mine.num_dead_node() == theirs.num_dead_node() == 0
    mine.barrier()
    mine.send_command_to_servers(0, "x")


def test_create_labels_telemetry_with_the_rank(no_launcher, monkeypatch):
    from mxnet_tpu_torch import telemetry, tracing

    labels = []
    monkeypatch.setattr(telemetry, "enabled", lambda: True)
    monkeypatch.setattr(tracing, "set_worker_rank", labels.append)
    tmx.kv.create("dist_sync")
    assert labels == [0]


def _fit_mlp(kvstore, fused):
    inputs = _inputs()
    mod = tmx.mod.Module(ranks.mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(inputs["mlp_x"], inputs["mlp_y"],
                               batch_size=ranks.MLP_BATCH),
            num_epoch=1, kvstore=kvstore, optimizer_params=ranks.OPT,
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in
                        _prefixed(inputs, "mlp_arg_").items()},
            initializer=None, fused_step=fused)
    return mod, {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def test_one_worker_dist_sync_takes_the_fused_step(no_launcher):
    """Without a launcher dist_sync is a one-worker world: fit takes the
    fused step by default, bit-equal to the classic loop; the update stays
    on the worker (no push/pull)."""
    fused_mod, fused = _fit_mlp("dist_sync", None)
    classic_mod, classic = _fit_mlp("dist_sync", False)
    assert fused_mod._fused_step_active and not classic_mod._fused_step_active
    assert not fused_mod._update_on_kvstore
    assert fused_mod._optimizer.rescale_grad == 1.0 / ranks.MLP_BATCH
    _identical(fused, classic)


def test_set_optimizer_checks_the_pickle_with_several_workers(no_launcher,
                                                              monkeypatch):
    kv = tmx.kv.create("dist_sync")
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1))
    monkeypatch.setattr(type(kv), "num_workers", property(lambda self: 2))

    class Unpicklable(tmx.optimizer.SGD):
        def __reduce__(self):
            raise TypeError("no pickle")

    with pytest.raises(tmx.MXNetError, match="serializable"):
        kv.set_optimizer(Unpicklable(learning_rate=0.1))


def test_barrier_before_exit_registers_and_unregisters(no_launcher,
                                                       monkeypatch):
    import atexit

    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", registered.remove)
    kv = tmx.kv.create("dist_sync")
    kv.set_barrier_before_exit(True)
    kv.set_barrier_before_exit(True)
    assert len(registered) == 1
    registered[0]()                    # a one-worker barrier returns
    kv.set_barrier_before_exit(False)
    assert registered == []


def test_store_side_optimizer_states_are_not_snapshotted_yet(no_launcher,
                                                             monkeypatch,
                                                             tmp_path):
    """Under a dist store of several workers (``_update_on_kvstore``, set
    here on a one-worker module) the optimizer states live on the store:
    the checkpoint manager and save_checkpoint's states raise naming the
    ROADMAP item instead of saving the module's empty ones."""
    from mxnet_tpu_torch.checkpoint import maybe_manager

    mod, _ = _fit_mlp("dist_sync", False)
    mod._update_on_kvstore = True
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", str(tmp_path / "snaps"))
    with pytest.raises(tmx.MXNetError, match="item 10b"):
        maybe_manager(mod)
    with pytest.raises(tmx.MXNetError, match="item 10b"):
        mod.save_checkpoint(str(tmp_path / "m"), 1,
                            save_optimizer_states=True)
    mod.save_checkpoint(str(tmp_path / "m"), 1)


# ---------------------------------------------------------------------------
# the parameter server, in process
# ---------------------------------------------------------------------------
@pytest.fixture
def secret(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_SECRET", SECRET)
    monkeypatch.delenv("MXTPU_PS_INSECURE", raising=False)
    monkeypatch.setattr(tps, "_SECRET_CACHE", False)
    monkeypatch.setattr(jps, "_SECRET_CACHE", False)


def _ordered_pushes(ps, opt_blob, grads):
    server = ps.ParameterServer("127.0.0.1", 0, num_workers=2)
    port = server._sock.getsockname()[1]
    try:
        c0 = ps.PSClient("127.0.0.1", port)
        c1 = ps.PSClient("127.0.0.1", port)
        c0.call("set_optimizer", opt_blob)
        c0.call("init", 0, 3, np.linspace(-1, 1, 12, dtype=np.float32)
                .reshape(3, 4))
        for i, g in enumerate(grads):
            (c0 if i % 2 == 0 else c1).call("push", 3, g)
        got = c1.call("pull", 3)
        c0.close()
        c1.close()
        return got
    finally:
        server.close()


def test_servers_of_both_packages_agree_on_ordered_pushes(secret):
    """The same six pushes, alternating two clients, through each
    package's server with SGD momentum 0.9 and wd: rtol 1e-6."""
    rng = np.random.RandomState(5)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(6)]
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5)
    mine = _ordered_pushes(tps, pickle.dumps(tmx.optimizer.SGD(**kw)), grads)
    theirs = _ordered_pushes(jps, pickle.dumps(jmx.optimizer.SGD(**kw)),
                             grads)
    np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=1e-7)
    assert not np.allclose(mine, np.linspace(-1, 1, 12).reshape(3, 4))


def _serial_adam(n_steps, lr=0.1):
    opt = tmx.optimizer.Adam(learning_rate=lr)
    w = tmx.nd.zeros((2,), ctx=tmx.cpu())
    state = opt.create_state(0, w)
    for _ in range(n_steps):
        opt.update(0, w, tmx.nd.ones((2,), ctx=tmx.cpu()), state)
    return w.asnumpy().copy()


def test_repeated_set_optimizer_and_late_joiner_keep_adam_state(secret):
    """A late worker's set_optimizer with the same blob is a no-op: the
    server keeps its Adam moments across both workers' pushes; a new
    blob starts fresh state. The server never touches CUDA: its weights
    come back as numpy."""
    server = tps.ParameterServer("127.0.0.1", 0, num_workers=2)
    try:
        blob = pickle.dumps(tmx.optimizer.Adam(learning_rate=0.1))
        c0 = tps.PSClient("127.0.0.1", server.port)
        c0.call("hello", 0)
        c0.call("set_optimizer", blob)
        c0.call("init", 0, 0, np.zeros(2, np.float32))
        for _ in range(3):
            c0.call("push", 0, np.ones(2, np.float32))
        c1 = tps.PSClient("127.0.0.1", server.port)
        c1.call("hello", 1)
        c1.call("set_optimizer", blob)
        for _ in range(3):
            c1.call("push", 0, np.ones(2, np.float32))
        got = c1.call("pull", 0)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, _serial_adam(6), rtol=1e-6)
        c1.call("set_optimizer", pickle.dumps(
            tmx.optimizer.Adam(learning_rate=0.2)))
        assert server._opt_states == {}
        with pytest.raises(tmx.MXNetError, match="uninitialized"):
            c1.call("push", 9, np.ones(2, np.float32))
        c0.close()
        c1.close()
    finally:
        server.close()


def test_worker_restart_keeps_the_server_state(secret):
    server = tps.ParameterServer("127.0.0.1", 0, num_workers=1)
    try:
        c = tps.PSClient("127.0.0.1", server.port)
        c.call("hello", 0)
        c.call("set_optimizer",
               pickle.dumps(tmx.optimizer.Adam(learning_rate=0.1)))
        c.call("init", 0, 0, np.zeros(2, np.float32))
        for _ in range(3):
            c.call("push", 0, np.ones(2, np.float32))
        c.close()
        c2 = tps.PSClient("127.0.0.1", server.port)
        c2.call("hello", 0)
        for _ in range(3):
            c2.call("push", 0, np.ones(2, np.float32))
        np.testing.assert_allclose(c2.call("pull", 0), _serial_adam(6),
                                   rtol=1e-6)
        c2.close()
    finally:
        server.close()


def test_hmac_framing_drops_a_mistagged_frame(secret):
    import hashlib
    import hmac
    import struct

    server = tps.ParameterServer("127.0.0.1", 0, num_workers=1)
    try:
        c = tps.PSClient("127.0.0.1", server.port)
        c.call("init", 0, 0, np.arange(3, dtype=np.float32))
        payload = pickle.dumps(("pull", 0))
        bad = hmac.new(b"wrong-token", payload, hashlib.sha256).digest()
        raw = socket.create_connection(("127.0.0.1", server.port),
                                       timeout=10)
        raw.sendall(struct.pack("!Q", len(payload)) + bad + payload)
        assert raw.recv(1) == b"", "server answered a mistagged frame"
        raw.close()
        np.testing.assert_array_equal(c.call("pull", 0), [0.0, 1.0, 2.0])
        c.close()
    finally:
        server.close()


def test_server_refuses_to_start_without_a_secret(monkeypatch):
    for k in ("MXTPU_PS_SECRET", "MXTPU_PS_SECRET_FILE",
              "MXTPU_PS_INSECURE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tps, "_SECRET_CACHE", False)
    with pytest.raises(tmx.MXNetError, match="refuses to start"):
        tps.ParameterServer("127.0.0.1", 0, num_workers=1)
    with pytest.raises(tmx.MXNetError, match="refuses to start"):
        tmx.kv.create("dist_async")
    monkeypatch.setenv("MXTPU_PS_INSECURE", "1")
    monkeypatch.setattr(tps, "_SECRET_CACHE", False)
    tps.ParameterServer("127.0.0.1", 0, num_workers=1).close()


def test_dead_node_count(secret):
    """A rank that said hello and lost its connection is dead; one that
    said bye is not."""
    server = tps.ParameterServer("127.0.0.1", 0, num_workers=3)
    try:
        c0 = tps.PSClient("127.0.0.1", server.port)
        c0.call("hello", 0)
        peer = tps.PSClient("127.0.0.1", server.port)
        peer.call("hello", 1)
        assert c0.call("num_dead") == 0
        peer.close()
        deadline = time.monotonic() + 10
        while c0.call("num_dead") != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert c0.call("num_dead") == 1
        polite = tps.PSClient("127.0.0.1", server.port)
        polite.call("hello", 2)
        polite.call("bye", 2)
        polite.close()
        time.sleep(0.3)
        assert c0.call("num_dead") == 1
        c0.close()
    finally:
        server.close()


def test_server_process_serves_two_workers_then_stops(monkeypatch):
    """A DMLC_ROLE=server process (``import mxnet_tpu_torch.kvstore_server``)
    owns the address: rank 0 finds it served and is a client like rank 1.
    Both ranks init, set the optimizer (rank 0 ships it), push and pull
    from two threads; rank 0's close stops the server process."""
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=REPO, DMLC_ROLE="server",
               MXTPU_COORDINATOR="127.0.0.1:%d" % port,
               MXTPU_NUM_WORKERS="2", MXTPU_PS_SECRET=SECRET,
               OMP_NUM_THREADS="1")
    env.pop("MXTPU_PS_PORT", None)
    server = subprocess.Popen(
        [sys.executable, "-c", "import mxnet_tpu_torch.kvstore_server"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port + 1), 1).close()
                break
            except OSError:
                assert server.poll() is None, server.communicate()
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.1)
        monkeypatch.setenv("MXTPU_COORDINATOR", "127.0.0.1:%d" % port)
        monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
        monkeypatch.setenv("MXTPU_PS_SECRET", SECRET)
        monkeypatch.delenv("MXTPU_PS_PORT", raising=False)
        monkeypatch.setattr(tps, "_SECRET_CACHE", False)
        stores = []
        for r in range(2):
            monkeypatch.setenv("MXTPU_WORKER_RANK", str(r))
            stores.append(tmx.kv.create("dist_async"))
        assert stores[0]._server is None
        pulled, errors = [None, None], []

        def work(r):
            try:
                kv = stores[r]
                kv.init(5, tmx.nd.array(np.full(4, float(r), np.float32),
                                        ctx=tmx.cpu()))
                kv.set_optimizer(tmx.optimizer.SGD(learning_rate=1.0))
                kv.push(5, tmx.nd.array(np.full(4, r + 1.0, np.float32),
                                        ctx=tmx.cpu()))
                kv.barrier()
                out = tmx.nd.zeros((4,), ctx=tmx.cpu())
                kv.pull(5, out)
                pulled[r] = out.asnumpy().copy()
            except Exception as e:      # reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        # rank 0's init (0) minus both pushes (1 + 2) at lr 1
        for got in pulled:
            np.testing.assert_array_equal(got, np.full(4, -3.0))
        assert stores[0].num_dead_node() == 0
        stores[1].close()
        stores[0].close()
        assert server.wait(timeout=30) == 0
    finally:
        if server.poll() is None:
            server.kill()
        server.communicate()


def test_the_dist_modules_and_tool_import_no_jax():
    """The port's new modules are covered by tests/test_torch_isolation.py;
    the four-card tool and the rank script import neither jax nor the JAX
    package either."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(jax\b|jaxlib\b|"
                         r"mxnet_tpu(?!_torch)\b)")
    for rel in ("tools/torch_dist_check.py", "tests/torch_dist_ranks.py"):
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            bad = [line for line in f if pattern.match(line)]
        assert not bad, (rel, bad)
