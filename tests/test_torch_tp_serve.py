"""Serving over several contexts, the port (mxnet_tpu_torch) against the
JAX package: dp replicas and the ``(dp, tp)`` grid, as
tests/test_tp_serve.py holds the JAX package's. The port runs on
``cpu(0..7)`` contexts, the reference on its forced 8-device CPU
platform.

* The spec helpers (``tp_param_spec``, ``batch_shard_extent``) and
  ``bucket_ladder(dp=, mesh=)``, case for case against the JAX functions.
* The exact regime (integer data, half-integer weights, power-of-two
  sizes; reference ``test_tp_serve.py:27-35``): the port's tp 2 server
  over 8 contexts serves the JAX tp 2 server's bits and its own tp 1's;
  its dp 8 server the JAX dp 8 server's. The logits are exact there; the
  two packages' softmax rounds differently in the last bit, so the
  servers compared across packages end at the logits, and the port's
  tp 2 and tp 1 are also compared through SoftmaxOutput.
* A small NHWC ResNet whose convolutions split on both dims, at dp 2 x
  tp 2, within 1e-5 normwise of the JAX server from the same params.
* Resident param bytes, the env knob, ``stale_for`` and the server's
  rebuild on a re-bind, the delta refresh on shards, the refusals.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)
import mxnet_tpu.module  # noqa: F401  (jmx.mod)
import mxnet_tpu.serving  # noqa: F401  (jmx.serving)
import mxnet_tpu_torch as tmx
from mxnet_tpu.checkpoint import param_digest
from mxnet_tpu.parallel import sharding as jsh
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.parallel import sharding as tsh
from mxnet_tpu_torch.replicas import Replicas

DIM, CLASSES, HID, BATCH = 8, 4, 16, 8
RESNET = dict(units=[1, 1, 1, 1], filter_list=[16, 32, 32, 64, 64],
              num_classes=3, small_input=True, layout="NHWC")
IMAGE = (8, 8, 3)


def _mlp(pkg, softmax=True):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=HID, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax") if softmax else net


def _exact_params(seed=3):
    """Half-integer weights: every logit is a dyadic rational."""
    shapes, _, _ = _mlp(tmx).infer_shape(data=(BATCH, DIM),
                                         softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    names = _mlp(tmx).list_arguments()
    return {n: (rng.randint(-2, 3, s) * 0.5).astype(np.float32)
            for n, s in zip(names, shapes)
            if n not in ("data", "softmax_label")}


def _rows(n, seed=11):
    return np.random.RandomState(seed).randint(-3, 4, (n, DIM)) \
        .astype(np.float32)


def _mlp_module(pkg, n_dev=8, params=None, softmax=True):
    ctx = [pkg.cpu(i) for i in range(n_dev)] if n_dev > 1 else pkg.cpu()
    labels = ("softmax_label",) if softmax else ()
    mod = pkg.mod.Module(_mlp(pkg, softmax), context=ctx,
                         label_names=labels)
    mod.bind(data_shapes=[("data", (BATCH, DIM))],
             label_shapes=[(n, (BATCH,)) for n in labels] or None,
             for_training=False)
    params = _exact_params() if params is None else params
    mod.init_params(initializer=None, aux_params={}, arg_params={
        n: pkg.nd.array(v, ctx=pkg.cpu()) for n, v in params.items()})
    return mod


def _server(pkg, tp, n_dev=8, softmax=True, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("slo_ms", 0.0)
    return pkg.serving.InferenceServer(
        _mlp_module(pkg, n_dev, softmax=softmax), max_batch=BATCH, tp=tp,
        **kw)


def _serve_rows(srv, x):
    return [np.asarray(srv.infer([x[i:i + 1]])[0]) for i in range(len(x))]


@pytest.fixture
def tel():
    telemetry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.reset()
    telemetry.disable()


# ---------------------------------------------------------------------------
# the spec layer and the ladder, case for case
# ---------------------------------------------------------------------------
def _meshes(axes):
    import jax

    return (jsh.make_mesh(axes, devices=jax.devices()[:8]),
            tsh.make_mesh(axes, devices=[tmx.cpu(i) for i in range(8)]))


@pytest.mark.multichip
@pytest.mark.parametrize("axes", [{"dp": 4, "tp": 2}, {"dp": 2, "tp": 4},
                                  {"dp": 8}, {"dp": 2, "fsdp": 4}])
def test_spec_helpers_and_ladder_match_jax(axes):
    jmesh, tmesh = _meshes(axes)
    assert isinstance(tmesh, tsh.ContextMesh)
    assert tsh.mesh_axis_sizes(tmesh) == dict(axes)
    for shape in [(16, 8), (8, 16), (8, 8), (16,), (7, 3), (), (64, 256, 1,
                  1), (256, 64, 1, 1), (1000, 2048), (4096, 25088), (3,)]:
        want = jsh.tp_param_spec(shape, jmesh)
        got = tsh.tp_param_spec(shape, tmesh)
        assert (got is None) == (want is None), shape
        if want is not None:
            assert tuple(got) == tuple(want), shape
    assert tsh.batch_shard_extent(tmesh) == jsh.batch_shard_extent(jmesh)
    for max_batch in (1, 6, 16, 24, 64):
        assert tmx.serving.bucket_ladder(max_batch, mesh=tmesh) == \
            jmx.serving.bucket_ladder(max_batch, mesh=jmesh), max_batch


@pytest.mark.parametrize("args,kw", [
    ((64,), {}), ((6,), {}), ((16,), {"dp": 8}), ((64,), {"dp": 8}),
    ((24,), {"dp": 4}), ((64,), {"spec": "3,17,64"}),
    ((64,), {"dp": 4, "spec": "3,17"}), ((10,), {"dp": 4}),
    ((16,), {"dp": 4, "spec": "1,2,4"})])
def test_bucket_ladder_matches_jax(args, kw):
    """Reference tests/test_serving.py:78-93's cases and a few more; every
    rung a multiple of dp."""
    got = tmx.serving.bucket_ladder(*args, **kw)
    assert got == jmx.serving.bucket_ladder(*args, **kw)
    assert all(r % kw.get("dp", 1) == 0 for r in got)


def test_batch_scheduler_rounds_to_dp():
    """Reference serving.py:361-380: max_batch rounds up to a multiple of
    dp and the ladder is built with it."""
    def infer(placed):
        return (placed[0],), ()

    for pkg in (jmx, tmx):
        sch = pkg.serving.BatchScheduler(infer, [(BATCH, DIM)],
                                         max_batch=10, dp=4,
                                         max_wait_ms=1.0, slo_ms=0.0,
                                         autostart=False)
        assert sch.max_batch == 12
        assert sch.buckets == (4, 8, 12)
        sch.close()


def test_grid_helpers_on_contexts():
    mesh = tsh.make_mesh({"dp": 2, "tp": 2},
                         devices=[tmx.cpu(i) for i in range(4)])
    assert mesh.groups("tp") == [[0, 1], [2, 3]]
    assert [tsh.batch_shard_index(mesh, k) for k in range(4)] == [0, 0, 1, 1]
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert np.array_equal(tsh.tp_shard(w, mesh, 3), w[4:])
    t = torch.from_numpy(w.T.copy())          # (4, 8): split on dim 1
    assert torch.equal(tsh.tp_shard(t, mesh, 1), t[:, 4:])
    odd = np.zeros((3, 5), np.float32)
    assert tsh.tp_shard(odd, mesh, 1) is odd   # nothing divides: whole
    fsdp = tsh.make_mesh({"dp": 2, "fsdp": 2},
                         devices=[tmx.cpu(i) for i in range(4)])
    assert [tsh.batch_shard_index(fsdp, k) for k in range(4)] == [0, 1, 2, 3]


def test_tp_collectives_over_cpu_contexts():
    reps = Replicas([torch.device("cpu")] * 4)
    parts = [torch.full((2, 3), float(k)) for k in range(4)]
    joined = reps.gather_along(parts, -1, [[0, 1], [2, 3]])
    assert torch.equal(joined[1], torch.cat(parts[:2], dim=-1))
    assert torch.equal(joined[2], torch.cat(parts[2:], dim=-1))
    sums = [p.clone() for p in parts]
    reps.sum_groups(sums, [[0, 1], [2, 3]])
    assert [float(s[0, 0]) for s in sums] == [1.0, 1.0, 5.0, 5.0]


# ---------------------------------------------------------------------------
# the exact regime: bit for bit against the JAX servers
# ---------------------------------------------------------------------------
@pytest.mark.multichip
def test_tp2_server_is_bit_identical_to_jax_and_to_tp1():
    x = _rows(6)
    with _server(jmx, tp=2, softmax=False) as jsrv:
        ref = _serve_rows(jsrv, x)
    with _server(tmx, tp=2, softmax=False) as srv:
        assert (srv.dp, srv.tp) == (4, 2)
        assert srv.buckets == (4, 8)
        got = _serve_rows(srv, x)
        stats = srv.stats()
    assert (stats["dp"], stats["tp"]) == (4, 2)
    for i in range(len(x)):
        assert np.array_equal(got[i], ref[i]), i
    with _server(tmx, tp=1) as one:
        assert (one.dp, one.tp) == (8, 1)
        tp1 = _serve_rows(one, x)
    with _server(tmx, tp=2) as srv:
        tp2 = _serve_rows(srv, x)
    for i in range(len(x)):
        assert np.array_equal(tp2[i], tp1[i]), i


@pytest.mark.multichip
def test_dp8_server_is_bit_identical_to_jax_dp8():
    x = _rows(5, seed=4)
    with _server(jmx, tp=0, softmax=False) as jsrv:
        ref = _serve_rows(jsrv, x)
        # a whole bucket of 8 rows, one row a context
        (jfull,) = jsrv.infer([_rows(BATCH, seed=5)])
    with _server(tmx, tp=None, softmax=False) as srv:
        assert (srv.dp, srv.tp) == (8, 1)
        assert srv.buckets == (8,)
        got = _serve_rows(srv, x)
        (full,) = srv.infer([_rows(BATCH, seed=5)])
    for i in range(len(x)):
        assert np.array_equal(got[i], ref[i]), i
    assert np.array_equal(full, np.asarray(jfull))


# ---------------------------------------------------------------------------
# a small ResNet whose convolutions split both ways
# ---------------------------------------------------------------------------
def _resnet_params(sym, batch):
    rng = np.random.RandomState(7)
    shapes, _, aux_shapes = sym.infer_shape(data=(batch,) + IMAGE)
    args = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            v = rng.uniform(0.5, 1.0, shape)
        elif name.endswith("beta") or name.endswith("bias"):
            v = rng.randn(*shape) * 0.1
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        args[name] = v.astype(np.float32)
    aux = {name: (rng.uniform(0.5, 2.0, shape) if name.endswith("var")
                  else rng.randn(*shape) * 0.1).astype(np.float32)
           for name, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.multichip
def test_small_resnet_at_dp2_tp2_against_jax(tel):
    batch = 4
    tsym = tmx.models.get_resnet(**RESNET)
    args, aux = _resnet_params(tsym, batch)
    x = np.random.RandomState(9).randn(batch, *IMAGE).astype(np.float32)

    jsym = jmx.models.get_resnet(**RESNET)
    jmod = jmx.mod.Module(jsym, context=[jmx.cpu(i) for i in range(4)])
    jmod.bind(data_shapes=[("data", (batch,) + IMAGE)], for_training=False)
    jmod.init_params(initializer=None, arg_params={
        n: jmx.nd.array(v) for n, v in args.items()},
        aux_params={n: jmx.nd.array(v) for n, v in aux.items()})
    with jmx.serving.InferenceServer(jmod, max_batch=batch, tp=2,
                                     max_wait_ms=1.0, slo_ms=0.0) as jsrv:
        (ref,) = jsrv.infer([x])
    ref = np.asarray(ref)

    mod = tmx.mod.Module(tsym, context=[tmx.cpu(i) for i in range(4)])
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)], for_training=False)
    targs, taux = tmx.interop.params_from_numpy(
        tsym, args, aux, ctx=tmx.cpu(),
        input_shapes={"data": (batch,) + IMAGE})
    mod.init_params(initializer=None, arg_params=targs, aux_params=taux)
    with tmx.serving.InferenceServer(mod, max_batch=batch, tp=2,
                                     max_wait_ms=1.0, slo_ms=0.0) as srv:
        assert (srv.dp, srv.tp) == (2, 2)
        plan = srv._fused._grid.plan
        (got,) = srv.infer([x])
        gathers = srv._fused.tp_gathers
    # both conv splits and the classifier's row split occur
    dims = {n: plan.split_dim(n) for n in args}
    assert dims["stage0_unit0_b1_conv_weight"] == 1      # (8, 16, 1, 1)
    assert dims["stage0_unit0_b3_conv_weight"] == 0      # (32, 8, 1, 1)
    assert dims["fc1_weight"] == 1                        # (3, 64)
    assert dims["fc1_bias"] is None                       # (3,): whole
    # every BatchNorm's gamma and beta gathered once a forward
    n_bn = sum(1 for n in args if n.endswith("_gamma"))
    assert gathers == 2 * n_bn
    assert tel.peek("infer.tp_gathers") == gathers
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= 1e-5, err
    assert np.array_equal(got.argmax(1), ref.argmax(1))


# ---------------------------------------------------------------------------
# resident bytes, the env knob, stale_for and rebuilds, the delta refresh
# ---------------------------------------------------------------------------
def test_tp_halves_resident_param_bytes():
    with _server(tmx, tp=1) as rep:
        whole = rep._fused.param_bytes(0)
    with _server(tmx, tp=2) as srv:
        half = [srv._fused.param_bytes(k) for k in range(8)]
    # every param's largest dim divides by 2: context 0 holds half
    assert whole == 4 * (HID * DIM + HID + CLASSES * HID + CLASSES)
    assert half == [whole // 2] * 8


def test_env_knob_one_dispatch_a_batch(tel, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_TP", "2")
    with _server(tmx, tp=None) as srv:
        assert (srv.dp, srv.tp) == (4, 2)
        for b in srv.buckets:
            srv._fused([np.zeros((b, DIM), np.float32)])
        compiles = srv.compiles
        assert compiles == len(srv.buckets)
        d0, b0 = srv._fused.dispatches, tel.peek("serve.batches") or 0
        rc0 = tel.peek("infer.recompiles")
        for row in _rows(10):
            srv.infer([row[None]])
        batches = tel.peek("serve.batches") - b0
        assert batches > 0
        assert srv._fused.dispatches - d0 == batches
        assert srv.compiles == compiles
        assert tel.peek("infer.recompiles") == rc0


def test_stale_for_across_factorings():
    mod = _mlp_module(tmx)
    rex = mod._exec_group.replicated
    ctxs = [tmx.cpu(i) for i in range(8)]
    dp_mesh = tsh.make_mesh({"dp": 8}, devices=ctxs)
    tp_mesh = tsh.make_mesh({"dp": 4, "tp": 2}, devices=ctxs)
    fused = tmx.fused_step.make_fused_infer(rex, ["data"], mesh=dp_mesh)
    assert fused.mesh_key == (("dp", 8),)
    assert not fused.stale_for(rex, dp_mesh)
    assert not fused.stale_for(rex, tsh.make_mesh({"dp": 8}, devices=ctxs))
    assert fused.stale_for(rex, tp_mesh)
    assert fused.stale_for(rex, None)
    assert fused.stale_for(_mlp_module(tmx)._exec_group.replicated, dp_mesh)
    assert tmx.fused_step.FusedInfer.factoring_key(tp_mesh) == \
        (("dp", 4), ("tp", 2))


def test_server_rebuilds_once_on_a_rebind(tel):
    with _server(tmx, tp=2) as srv:
        old = srv._fused
        srv._module.bind(data_shapes=[("data", (BATCH, DIM))],
                         label_shapes=[("softmax_label", (BATCH,))],
                         for_training=False, force_rebind=True)
        srv._module.init_params(initializer=None, aux_params={},
                                force_init=True, arg_params={
                                    n: tmx.nd.array(v, ctx=tmx.cpu())
                                    for n, v in _exact_params().items()})
        srv.refresh_params()
        assert srv._fused is not old
        assert srv._fused.mesh_key == (("dp", 4), ("tp", 2))
        srv.refresh_params()
        assert srv.executable_rebuilds == 1
        assert tel.peek("serve.executable_rebuilds") == 1
        (out,) = srv.infer([_rows(1)])
        assert np.asarray(out).shape == (1, CLASSES)


def _host_pack(mod):
    args, _ = mod.get_params()
    return {n: a.asnumpy().copy() for n, a in args.items()}


def test_delta_refresh_on_shards_equals_a_full_repack(tel):
    x = _rows(4)
    with _server(tmx, tp=2) as full:
        host2 = _host_pack(full._module)
        host2["fc1_weight"] = host2["fc1_weight"] * 2.0
        full._module.set_params({n: tmx.nd.array(v, ctx=tmx.cpu())
                                 for n, v in host2.items()}, {},
                                force_init=True)
        full.refresh_params()
        ref = _serve_rows(full, x)
    with _server(tmx, tp=2) as srv:
        fused = srv._fused
        host = _host_pack(srv._module)
        digests = {n: param_digest(v) for n, v in host.items()}
        srv.refresh_params(host_params=host, digests=digests)
        assert fused.last_refresh_changed == len(host)
        host2 = dict(host, fc1_weight=host["fc1_weight"] * 2.0)
        digests2 = dict(digests, fc1_weight=param_digest(
            host2["fc1_weight"]))
        srv.refresh_params(host_params=host2, digests=digests2)
        assert fused.last_refresh_changed == 1
        assert fused.last_refresh_skipped == len(host) - 1
        assert fused.last_refresh_bytes == host2["fc1_weight"].nbytes
        # each context's shard of the new weight, and the executors'
        # whole arrays written through
        for k in range(8):
            pos = [fused._execs[0].arg_names[i]
                   for i in fused._p_idx].index("fc1_weight")
            np.testing.assert_array_equal(
                fused._param_vals[k][pos].numpy(),
                tsh.tp_shard(host2["fc1_weight"], fused._mesh, k))
            np.testing.assert_array_equal(
                fused._execs[k].arg_dict["fc1_weight"].asnumpy(),
                host2["fc1_weight"])
        got = _serve_rows(srv, x)
        srv.refresh_params(host_params=host2, digests=digests2)
        assert fused.last_refresh_changed == 0
        assert fused.last_refresh_bytes == 0
    for i in range(len(x)):
        assert np.array_equal(got[i], ref[i]), i


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_indivisible_tp_raises_naming_the_knob():
    mod = _mlp_module(tmx)
    with pytest.raises(tmx.MXNetError,
                       match="MXNET_TPU_SERVE_TP=3 does not divide the "
                             "8-device group"):
        tmx.serving.InferenceServer(mod, tp=3, max_wait_ms=1.0, slo_ms=0.0)


def test_a_convolution_split_on_its_kernel_raises():
    """(2, 3, 8, 8) at tp 2: tp_param_spec picks the kernel's height, a
    dim the split rule does not take; the server names op and param."""
    net = tmx.sym.Convolution(tmx.sym.Variable("data"), kernel=(8, 8),
                              num_filter=2, no_bias=True, name="conv")
    mod = tmx.mod.Module(net, label_names=(),
                         context=[tmx.cpu(0), tmx.cpu(1)])
    mod.bind([("data", (2, 3, 8, 8))], for_training=False)
    mod.init_params(tmx.init.Zero())
    with pytest.raises(tmx.MXNetError,
                       match="Convolution conv's weight conv_weight splits "
                             "along dim 2"):
        tmx.serving.InferenceServer(mod, tp=2)
