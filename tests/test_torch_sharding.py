"""The sharding API and the fsdp recipe of the port (ROADMAP.md Queue A
item 10c) against the JAX package on the suite's forced 8-device CPU
platform:

* the spec layer (``batch_spec``, ``fsdp_param_spec``, ``tp_param_spec``
  with its ties, ``batch_shard_extent``, ``_spec_fits``,
  ``make_param_shardings``' first matching rule) on the same meshes and
  shapes, compared as tuples;
* a Module over 8 ``cpu(i)`` contexts under ``MXNET_TPU_MESH_FSDP=4``
  against the JAX package's ``tests/test_fsdp.py::_fit_mesh`` in its
  exact-arithmetic regime (integer data, binary labels, quarter-integer
  weights, power-of-two batch, lr and momentum): the params and each
  batch's loss (its mse from the outputs) ``==`` while the arithmetic is
  exact (the first three batches), within rtol 1e-6 after it (see the
  test); against the port's own dp 8 ``==`` (the CPU's cross-card
  sums add in context order whatever the mesh); the classic loop against
  the fused step ``==``; shard and optimizer-state bytes on context 0;
  the escape hatch and the indivisible count; a dp 8 -> fsdp 4 -> dp 8
  checkpoint resume as ``tests/test_elastic_recovery.py`` runs it;
* ``build_sgd_train_step`` on a one-rank DeviceMesh against the JAX step
  of ``tests/test_mixed_precision.py``: float32 within rtol 1e-5 / atol
  1e-5 (the conv bias ahead of a BatchNorm gets a gradient of rounding
  only, ~1e-6 either way), bfloat16 within that file's bound (outputs
  atol 0.06, params 0.12) and within bfloat16's own: each update and
  each moving statistic's move within 2**-6 normwise of JAX's bfloat16
  step, a bound the port's float32 step, a skipped update and stale
  statistics each fail;
* the tool's part (b) rehearsed over two gloo processes, and
  ``ring_attention(q, k, v, "sp")`` with the axis positional in a
  one-rank world."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import sharding as jsh
from mxnet_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_fsdp.py's exact-arithmetic regime
BATCH, DIM, HID = 8, 4, 8
SHAPES = [(8, 4), (6, 4), (), (4,), (12, 8, 3), (1000, 2048), (7, 16),
          (16, 16), (2, 6)]


@pytest.fixture(autouse=True)
def _no_world_left():
    """A test that builds a one-rank mesh joins a process group; it is
    torn down after the test, so the worker's later tests (those of
    ``tests/test_torch_parallel.py`` among them) start with none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    tsh._Last.mesh = None


def _jmesh(sizes):
    return jsh.make_mesh(sizes)


def _tmesh(sizes):
    return tsh.ContextMesh(sizes, [tmx.cpu(i) for i in range(8)])


def _spec(s):
    return None if s is None else tuple(s)


@pytest.mark.parametrize("sizes", [{"dp": 2, "fsdp": 4}, {"dp": 8},
                                   {"dp": 2, "tp": 4},
                                   {"dp": 2, "fsdp": 2, "tp": 2}])
def test_spec_helpers_match_jax(sizes):
    """The same answers on the same mesh for every shape: the batch over
    every data axis, dim 0 along fsdp only where it divides, the tp dim,
    the batch's extent and whether a spec fits."""
    jm, tm = _jmesh(sizes), _tmesh(sizes)
    assert tsh.mesh_axis_sizes(tm) == jsh.mesh_axis_sizes(jm) == sizes
    if "dp" in sizes:
        for axis in (0, 1):
            assert tuple(tsh.batch_spec(tm, axis)) == \
                tuple(jsh.batch_spec(jm, axis))
    assert tsh.batch_shard_extent(tm) == jsh.batch_shard_extent(jm)
    assert tsh.batch_shard_extent(None) == jsh.batch_shard_extent(None) == 1
    for shape in SHAPES:
        assert _spec(tsh.fsdp_param_spec(shape, tm)) == \
            _spec(jsh.fsdp_param_spec(shape, jm)), shape
        assert _spec(tsh.tp_param_spec(shape, tm)) == \
            _spec(jsh.tp_param_spec(shape, jm)), shape
        for axis in sizes:
            spec = (axis,) + (None,) * max(0, len(shape) - 1)
            if not shape:
                continue
            assert tsh._spec_fits(shape, tsh.PartitionSpec(*spec), tm) == \
                jsh._spec_fits(shape, _jp(*spec), jm), (shape, axis)


def _jp(*parts):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*parts)


def test_tp_param_spec_takes_the_largest_dividing_dim_earliest_on_ties():
    sizes = {"dp": 2, "tp": 4}
    jm, tm = _jmesh(sizes), _tmesh(sizes)
    cases = {(8, 8): ("tp", None), (4, 8): (None, "tp"),
             (8, 4): ("tp", None), (6, 6): (), (3, 12, 12): (None, "tp",
                                                             None),
             (10, 7, 4): (None, None, "tp")}
    for shape, want in cases.items():
        assert tuple(tsh.tp_param_spec(shape, tm)) == want, shape
        assert tuple(jsh.tp_param_spec(shape, jm)) == want, shape
    one = {"tp": 1, "dp": 8}
    assert tuple(tsh.tp_param_spec((8, 8), _tmesh(one))) == \
        tuple(jsh.tp_param_spec((8, 8), _jmesh(one))) == ()


def test_make_param_shardings_first_fitting_rule_and_placements():
    """The first rule whose pattern matches and whose spec divides wins;
    a rule that does not divide falls through; the rest replicate. The
    port's sharding carries the DTensor placements of its spec."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"dp": 2, "fsdp": 4}
    jm, tm = _jmesh(sizes), _tmesh(sizes)
    shapes = {"fc1_weight": (8, 4), "bias": (6,), "fc2_weight": (6, 12),
              "conv_weight": (16, 3, 3, 8), "other": (5, 5)}
    rules_t = [tsh.ShardingRule(r"fc\d_weight", tsh.PartitionSpec("fsdp",
                                                                   None)),
               tsh.ShardingRule(r"fc.*", tsh.PartitionSpec(None, "fsdp")),
               tsh.ShardingRule(r"fc.*", tsh.PartitionSpec("fsdp")),
               tsh.ShardingRule(r"conv", tsh.PartitionSpec(("dp", "fsdp")))]
    rules_j = [jsh.ShardingRule(r.pattern, _jp(*r.spec)) for r in rules_t]
    mine = tsh.make_param_shardings(tm, shapes, rules_t)
    theirs = jsh.make_param_shardings(jm, shapes, rules_j)
    assert {k: tuple(v.spec) for k, v in mine.items()} == \
        {k: tuple(v.spec) for k, v in theirs.items()}
    assert tuple(mine["fc1_weight"].spec) == ("fsdp", None)
    assert tuple(mine["fc2_weight"].spec) == (None, "fsdp")
    assert tuple(mine["bias"].spec) == ()
    assert mine["fc1_weight"].placements == (Replicate(), Shard(0))
    assert mine["fc2_weight"].placements == (Replicate(), Shard(1))
    assert mine["conv_weight"].placements == (Shard(0), Shard(0))
    assert mine["other"].placements == (Replicate(), Replicate())


def test_shard_args_on_a_one_rank_device_mesh():
    from torch.distributed.tensor import DTensor, Shard

    mesh = tsh.make_mesh({"dp": 1, "fsdp": 1}, device_type="cpu")
    assert tsh.mesh_axis_sizes(mesh) == {"dp": 1, "fsdp": 1}
    arrays = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
              "b": np.ones(3, np.float32)}
    sh = tsh.make_param_shardings(
        mesh, {k: v.shape for k, v in arrays.items()},
        [tsh.ShardingRule("w", tsh.PartitionSpec("fsdp", None))])
    out = tsh.shard_args(mesh, arrays, sh)
    assert isinstance(out["w"], DTensor)
    assert out["w"].placements[1] == Shard(0)
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k].full_tensor().numpy(), v)
    # devices: the world ranks the mesh spans
    listed = tsh.make_mesh({"dp": 1}, devices=[0], device_type="cpu")
    assert tsh.mesh_axis_sizes(listed) == {"dp": 1}
    assert listed.mesh.tolist() == [0]
    with pytest.raises(tmx.MXNetError, match="not in the world"):
        tsh.make_mesh({"dp": 1}, devices=[3], device_type="cpu")


# ---------------------------------------------------------------------------
# the Module over 8 contexts under MXNET_TPU_MESH_FSDP
# ---------------------------------------------------------------------------
def _lin_sym(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=HID, name="fc1")
    return pkg.sym.LinearRegressionOutput(net, name="lro")


def _synthetic(n, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 2, (n, DIM)).astype(np.float32)
    y = rng.randint(0, 2, (n, HID)).astype(np.float32)
    return X, y


def _seed_params(net, seed=9):
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, DIM),
                                       lro_label=(BATCH, HID))
    rng = np.random.RandomState(seed)
    return {name: (rng.randint(-2, 3, shape) * 0.5).astype(np.float32)
            for name, shape in zip(net.list_arguments(), arg_shapes)
            if name not in ("data", "lro_label")}


def _fit(pkg, monkeypatch, fsdp=0, nbatches=4, num_epoch=2, fused=None,
         momentum=0.5, lr=0.25):
    """``tests/test_fsdp.py::_fit_mesh`` in either package: one fused run
    over 8 CPU contexts under ``device_sync``; returns the module and the
    (epoch, nbatch, metric mse, the batch's own mse from its outputs)
    stream. The outputs' mse is exact in this regime; the metric's
    running mean is the package's own sum (float32 in the JAX package,
    float64 in the port)."""
    if fsdp:
        monkeypatch.setenv("MXNET_TPU_MESH_FSDP", str(fsdp))
    else:
        monkeypatch.delenv("MXNET_TPU_MESH_FSDP", raising=False)
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    net = _lin_sym(pkg)
    X, y = _synthetic(BATCH * nbatches)
    data = pkg.io.NDArrayIter(X, y, batch_size=BATCH,
                              label_name="lro_label")
    mod = pkg.mod.Module(net, context=[pkg.cpu(i) for i in range(8)],
                         label_names=("lro_label",))
    stream = []

    def cb(p):
        out = p.locals["self"].get_outputs()[0].asnumpy().astype(np.float64)
        lab = y[p.nbatch * BATCH:(p.nbatch + 1) * BATCH]
        stream.append((p.epoch, p.nbatch,
                       dict(p.eval_metric.get_name_value())["mse"],
                       float(np.mean((out - lab) ** 2))))

    kwargs = {} if fused is None else {"fused_step": fused}
    mod.fit(data, num_epoch=num_epoch, kvstore="device_sync",
            eval_metric="mse", optimizer="sgd",
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in _seed_params(net).items()},
            initializer=None,
            optimizer_params={"learning_rate": lr, "momentum": momentum},
            batch_end_callback=cb, **kwargs)
    return mod, stream


def _fit_port(monkeypatch, fsdp=0, **kwargs):
    return _fit(tmx, monkeypatch, fsdp, **kwargs)


def _losses(stream):
    """The batches' own (exact) mse of a stream."""
    return [(e, b, loss) for e, b, _, loss in stream]


def _params(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def test_fsdp4_fit_over_8_contexts_matches_jax_bit_for_bit_while_exact(
        monkeypatch):
    """The (dp 2, fsdp 4) mesh of the contexts in the reference's grid
    order, every param sharded along dim 0 with momentum of the shard's
    shape. While the arithmetic is exact the port equals the JAX
    package's (dp, fsdp) fit bit for bit: a two-step fit's params and
    losses, and the first three losses of the eight-step fit. From the
    third update on the regime's values need more than float32's 24 bits
    and round (the next test replays it in exact rationals), and the
    packages' summation orders (XLA's and torch's matmuls) part by an
    ulp: the rest of the stream and the final params agree within rtol
    1e-6 (the JAX package is bit-equal to itself across meshes there
    because its order does not depend on the mesh, as the port's CPU sums
    do not)."""
    for nbatches, num_epoch in ((2, 1), (4, 2)):
        jmod, ref = _fit(jmx, monkeypatch, fsdp=4, nbatches=nbatches,
                         num_epoch=num_epoch)
        mod, got = _fit_port(monkeypatch, fsdp=4, nbatches=nbatches,
                             num_epoch=num_epoch)
        assert mod._fused_step_active
        assert len(got) == nbatches * num_epoch == len(ref)
        assert _losses(got)[:3] == _losses(ref)[:3]
        np.testing.assert_allclose([m for _, _, m, _ in got],
                                   [m for _, _, m, _ in ref], rtol=1e-6)
        jargs, _ = jmod.get_params()
        mine = _params(mod)
        for k, v in jargs.items():
            if nbatches * num_epoch <= 2:
                np.testing.assert_array_equal(mine[k], v.asnumpy(),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(mine[k], v.asnumpy(), rtol=1e-6,
                                           err_msg=k)
    group = mod._exec_group
    assert tsh.mesh_axis_sizes(group._mesh) == {"dp": 2, "fsdp": 4}
    assert group._mesh.coords(5) == {"dp": 1, "fsdp": 1}
    sharding = group.param_sharding("fc1_weight")
    assert tuple(sharding.spec) == \
        tuple(jmod._exec_group.param_sharding("fc1_weight").spec)
    assert group.shards.weight("fc1_weight", 5).shape == (HID // 4, DIM)
    i = mod._param_names.index("fc1_weight")
    for k, updater in enumerate(mod._updaters):
        assert updater.states[i].shape == (HID // 4, DIM)


def _bits(value):
    """Significant bits of a dyadic rational: from its highest set bit
    to its lowest."""
    n = abs(value.numerator)
    if n == 0:
        return 0
    while n % 2 == 0:
        n //= 2
    return n.bit_length()


def _exact_replay(nsteps):
    """The regime's fit replayed in exact rationals: each batch's loss,
    the most significant bits any param or momentum holds after each
    update, and the most any output of each batch needs."""
    from fractions import Fraction

    X, y = _synthetic(BATCH * nsteps)
    net = _lin_sym(tmx)
    seed = _seed_params(net)
    w = [[Fraction(float(v)) for v in row] for row in seed["fc1_weight"]]
    b = [Fraction(float(v)) for v in seed["fc1_bias"]]
    mw = [[Fraction(0)] * DIM for _ in range(HID)]
    mb = [Fraction(0)] * HID
    # SGD's rescale (1 / batch) times the regression output's own
    # (1 / outputs per row), lr 0.25, momentum 0.5
    scale, lr, mom = Fraction(1, BATCH * HID), Fraction(1, 4), Fraction(1, 2)
    losses, param_bits, out_bits = [], [], []
    for k in range(nsteps):
        xs = [[Fraction(float(v)) for v in r]
              for r in X[k * BATCH:(k + 1) * BATCH]]
        ys = [[Fraction(float(v)) for v in r]
              for r in y[k * BATCH:(k + 1) * BATCH]]
        out = [[sum(w[h][j] * xs[i][j] for j in range(DIM)) + b[h]
                for h in range(HID)] for i in range(BATCH)]
        err = [[out[i][h] - ys[i][h] for h in range(HID)]
               for i in range(BATCH)]
        losses.append(sum(e * e for r in err for e in r) / (BATCH * HID))
        out_bits.append(max(_bits(o) for r in out for o in r))
        for h in range(HID):
            for j in range(DIM):
                g = sum(err[i][h] * xs[i][j] for i in range(BATCH))
                mw[h][j] = mom * mw[h][j] - lr * scale * g
                w[h][j] += mw[h][j]
            mb[h] = mom * mb[h] - lr * scale * sum(err[i][h]
                                                   for i in range(BATCH))
            b[h] += mb[h]
        param_bits.append(max(_bits(v) for v in
                              [*b, *mb] + [v for r in w + mw for v in r]))
    return losses, param_bits, out_bits


def test_the_exact_regime_rounds_from_the_third_update(monkeypatch):
    """The witness for the bound of the test above: replayed in exact
    rationals, the third update leaves a param that needs 25 significant
    bits, more than float32's 24, and the fourth batch's outputs need
    27. The first three losses are exact in float32 and the port's equal
    them; the fourth is rounded (the packages' matmuls round it in their
    own orders, so from there they agree within rtol 1e-6, not ==)."""
    losses, param_bits, out_bits = _exact_replay(4)
    assert [i for i, n in enumerate(param_bits) if n > 24][0] == 2
    assert param_bits[2] == 25 and max(out_bits[:3]) <= 24
    assert out_bits[3] == 27
    _, got = _fit_port(monkeypatch, nbatches=4, num_epoch=1)
    mine = [loss for _, _, _, loss in got]
    assert mine[:3] == [float(v) for v in losses[:3]]
    assert mine[3] != float(losses[3])
    np.testing.assert_allclose(mine[3], float(losses[3]), rtol=1e-6)


def test_fsdp4_equals_the_ports_own_dp8_bit_for_bit(monkeypatch):
    ref_mod, ref = _fit_port(monkeypatch)
    mod, got = _fit_port(monkeypatch, fsdp=4)
    assert got == ref
    want = _params(ref_mod)
    for k, v in _params(mod).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert ref_mod._exec_group.shards is None
    assert tuple(ref_mod._exec_group.param_sharding("fc1_weight").spec) == ()


def test_custom_monitor_reads_the_joined_shards_under_fsdp(monkeypatch):
    """A Monitor with a custom stat_func reads a sharded param's weight
    and reduced gradient joined from the shards (its bound arrays are
    the walk's workspace, which holds the packed gradients after a
    backward): its rows under fsdp 4 equal dp 8's, and every sharded
    workspace differs from its weight there."""
    def stat(arr):
        return tmx.nd.array(np.abs(arr.asnumpy()).sum(keepdims=True)
                            .reshape(1), ctx=tmx.cpu())

    X, y = _synthetic(BATCH * 2)
    rows = []
    for fsdp in (0, 4):
        mod, _ = _fit_port(monkeypatch, fsdp=fsdp, nbatches=2, num_epoch=1,
                           fused=False)
        mon = tmx.monitor.Monitor(interval=1, stat_func=stat, sort=True)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward_backward(next(iter(tmx.io.NDArrayIter(
            X, y, batch_size=BATCH, label_name="lro_label"))))
        rows.append(mon.toc())
    names = [r[1] for r in rows[1]]
    assert "fc1_weight" in names and "fc1_weight_grad" in names
    assert rows[1] == rows[0]
    group = mod._exec_group
    for name in group.shards.index:
        assert not torch.equal(group.executor.arg_dict[name].handle,
                               group.param_value(name)), name


def test_fsdp_classic_loop_equals_the_fused_step(monkeypatch):
    fused_mod, fused = _fit_port(monkeypatch, fsdp=4)
    classic_mod, classic = _fit_port(monkeypatch, fsdp=4, fused=False)
    assert fused_mod._fused_step_active and not classic_mod._fused_step_active
    assert classic == fused
    want = _params(fused_mod)
    for k, v in _params(classic_mod).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("kvstore", ["device", "tpu_sync", "local"])
def test_fsdp_classic_loop_under_each_store_equals_dp(monkeypatch, kvstore):
    """The stores that leave the exchange to the group train fsdp 4 in
    the classic loop as dp 8 under ``device_sync`` does, exactly (the
    JAX package's stores refuse none of them under a (dp, fsdp) mesh)."""
    _, want = _fit_port(monkeypatch, nbatches=2, num_epoch=1)
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "4")
    net = _lin_sym(tmx)
    X, y = _synthetic(BATCH * 2)
    mod = tmx.mod.Module(net, context=[tmx.cpu(i) for i in range(8)],
                         label_names=("lro_label",))
    got = []
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=BATCH,
                               label_name="lro_label"),
            num_epoch=1, kvstore=kvstore, eval_metric="mse", optimizer="sgd",
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in _seed_params(net).items()},
            initializer=None, fused_step=False,
            optimizer_params={"learning_rate": 0.25, "momentum": 0.5},
            batch_end_callback=lambda p: got.append(
                dict(p.eval_metric.get_name_value())["mse"]))
    assert mod._exec_group.shards is not None
    assert got == [m for _, _, m, _ in want]


def _shard_state_bytes(mod, k):
    """Bytes of context ``k``'s params (its shard where sharded) and
    optimizer states."""
    from mxnet_tpu_torch.optimizer import _state_tensors

    group = mod._exec_group
    total = 0
    for name, w, _ in group.update_arrays(k):
        total += w.handle.numel() * w.handle.element_size()
    for s in mod._updaters[k].states.values():
        total += sum(t.numel() * t.element_size() for t in _state_tensors(s))
    return total


def test_fsdp4_shard_and_state_bytes_are_a_quarter_of_dp(monkeypatch):
    rep, _ = _fit_port(monkeypatch, nbatches=2, num_epoch=1)
    sh, _ = _fit_port(monkeypatch, fsdp=4, nbatches=2, num_epoch=1)
    for k in range(8):
        assert _shard_state_bytes(sh, k) * 4 == _shard_state_bytes(rep, k)


def test_fsdp_params_0_keeps_the_mesh_and_replicates(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FSDP_PARAMS", "0")
    mod, got = _fit_port(monkeypatch, fsdp=4, nbatches=2, num_epoch=1)
    group = mod._exec_group
    assert tsh.mesh_axis_sizes(group._mesh) == {"dp": 2, "fsdp": 4}
    assert group.shards is None
    assert tuple(group.param_sharding("fc1_weight").spec) == ()
    monkeypatch.delenv("MXNET_TPU_FSDP_PARAMS")
    _, want = _fit_port(monkeypatch, nbatches=2, num_epoch=1)
    assert got == want


def test_fsdp_that_does_not_divide_the_contexts_raises_in_both(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "3")
    for pkg in (tmx, jmx):
        mod = pkg.mod.Module(_lin_sym(pkg), label_names=("lro_label",),
                             context=[pkg.cpu(i) for i in range(8)])
        with pytest.raises(pkg.MXNetError,
                           match="MXNET_TPU_MESH_FSDP=3 does not divide"):
            mod.bind([("data", (BATCH, DIM))], [("lro_label", (BATCH, HID))])


def test_indivisible_params_replicate_under_fsdp(monkeypatch):
    """A param whose dim 0 does not divide by fsdp stays whole on every
    card (fc2's (6, 8) weight and its bias at fsdp 4) beside sharded ones
    (fc1's), and the mix trains as dp does, exactly."""
    def fit(fsdp):
        monkeypatch.setenv("MXNET_TPU_MESH_FSDP", str(fsdp))
        net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=8,
                                     name="fc1")
        net = tmx.sym.LinearRegressionOutput(tmx.sym.FullyConnected(
            net, num_hidden=6, name="fc2"), name="lro")
        rng = np.random.RandomState(1)
        x = rng.randint(0, 2, (2 * BATCH, DIM)).astype(np.float32)
        y = rng.randint(0, 2, (2 * BATCH, 6)).astype(np.float32)
        args = {n: (rng.randint(-2, 3, s) * 0.5).astype(np.float32)
                for n, s in zip(net.list_arguments(), net.infer_shape(
                    data=(BATCH, DIM))[0]) if n not in ("data", "lro_label")}
        mod = tmx.mod.Module(net, context=[tmx.cpu(i) for i in range(8)],
                             label_names=("lro_label",))
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH,
                                   label_name="lro_label"),
                num_epoch=1, kvstore="device_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.25, "momentum": 0.5},
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in args.items()}, initializer=None)
        return mod

    sh, rep = fit(4), fit(1)
    group = sh._exec_group
    assert sorted(group.shards.index) == ["fc1_bias", "fc1_weight"]
    assert tuple(group.param_sharding("fc2_weight").spec) == ()
    assert tuple(group.param_sharding("fc1_weight").spec) == ("fsdp", None)
    i = sh._param_names.index("fc2_weight")
    assert sh._updaters[3].states[i].shape == (6, 8)
    want = _params(rep)
    for k, v in _params(sh).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_the_legacy_executor_manager_refuses_fsdp(monkeypatch):
    """The manager hands out the replicas' arrays for the caller to
    update; under fsdp those are the workspace, so it raises naming the
    variable (under dp it binds as before)."""
    import mxnet_tpu_torch.executor_manager as tman

    X, y = _synthetic(BATCH)
    it = tmx.io.NDArrayIter(X, y, batch_size=BATCH, label_name="lro_label")
    ctxs = [tmx.cpu(i) for i in range(8)]
    tman.DataParallelExecutorManager(_lin_sym(tmx), ctxs, it)
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "4")
    with pytest.raises(tmx.MXNetError, match="MXNET_TPU_MESH_FSDP"):
        tman.DataParallelExecutorManager(_lin_sym(tmx), ctxs, it)


def _keep_only_step(d, step):
    path = os.path.join(d, "MANIFEST.json")
    with open(path) as f:
        man = json.load(f)
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == step]
    assert man["snapshots"]
    with open(path, "w") as f:
        json.dump(man, f)


def test_checkpoint_dp8_to_fsdp4_and_back_resumes_the_stream(tmp_path,
                                                            monkeypatch):
    """As ``tests/test_elastic_recovery.py::test_elastic_reshard_dp8_to_
    fsdp4_and_back``: a dp 8 snapshot at step 3 resumes onto the (dp 2,
    fsdp 4) mesh (params and momentum re-enter as shards) and an fsdp 4
    snapshot back onto dp 8; both continue the uninterrupted stream
    exactly, and the manifest records each mesh."""
    _, ref = _fit_port(monkeypatch)
    tail = [r for r in ref if (r[0], r[1]) > (0, 2)]
    for saved, resumed, name in ((0, 4, "a"), (4, 0, "b")):
        d = str(tmp_path / name)
        monkeypatch.setenv("MXNET_TPU_CKPT_DIR", d)
        monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
        monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")
        _fit_port(monkeypatch, fsdp=saved)
        _keep_only_step(d, 3)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            entry = json.load(f)["snapshots"][0]
        assert entry["dp"] == 8
        assert entry["mesh"] == ({"dp": 2, "fsdp": 4} if saved
                                 else {"dp": 8})
        monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "1")
        monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "0")
        mod, got = _fit_port(monkeypatch, fsdp=resumed)
        assert got == tail, name
        assert (mod._exec_group.shards is not None) == bool(resumed)


def test_module_optimizer_states_file_joins_the_shards(tmp_path,
                                                       monkeypatch):
    """``save_checkpoint``'s states file holds whole-shape momenta under
    fsdp, equal to dp's, and loads back onto either mesh."""
    rep, _ = _fit_port(monkeypatch, nbatches=2, num_epoch=1)
    sh, _ = _fit_port(monkeypatch, fsdp=4, nbatches=2, num_epoch=1)
    rep.save_checkpoint(str(tmp_path / "rep"), 1, save_optimizer_states=True)
    sh.save_checkpoint(str(tmp_path / "sh"), 1, save_optimizer_states=True)
    import pickle

    with open(str(tmp_path / "rep-0001.states"), "rb") as f:
        want = pickle.load(f)
    with open(str(tmp_path / "sh-0001.states"), "rb") as f:
        got = pickle.load(f)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sh.load_optimizer_states(str(tmp_path / "rep-0001.states"))
    i = sh._param_names.index("fc1_weight")
    for k in range(8):
        rows = sh._exec_group.shard_rows("fc1_weight", k)
        np.testing.assert_array_equal(
            sh._updaters[k].states[i].asnumpy(), want[i][rows])


# ---------------------------------------------------------------------------
# build_sgd_train_step
# ---------------------------------------------------------------------------
def _bn_net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                              pad=(1, 1), name="c1")
    net = pkg.sym.BatchNorm(data=net, name="bn1")
    net = pkg.sym.Activation(data=net, act_type="relu")
    net = pkg.sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    net = pkg.sym.Flatten(data=net)
    net = pkg.sym.FullyConnected(data=net, num_hidden=2, name="fc")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


# bfloat16 against bfloat16: the bound on each param's update (new -
# old) and each moving statistic's move, normwise. Measured on the CPU at
# this size the port is within 0.009 of JAX on every update and 0.0006 on
# the moves; the port's float32 step is 0.019-0.020 off on c1_weight and
# bn1_beta, a step that skips the update 1.0, a step that returns the old
# statistics 1.0 on them.
BF16_UPDATE_BOUND = 2.0 ** -6


def _bf16_misfit(got, want, params, aux):
    """The names whose update (or whose statistic's move) differs from
    the reference's by more than :data:`BF16_UPDATE_BOUND` normwise. The
    conv bias ahead of a BatchNorm is left out: its gradient is rounding
    only (zero in exact arithmetic), noise of either package's bf16
    sums. A param the reference leaves as it was (BatchNorm's fixed
    gamma) must stay exactly as it was."""
    (_, tp, ta), (_, jp, ja) = got, want
    out = []
    for k, p0 in params.items():
        if k == "c1_bias":
            continue
        mine, ref = tp[k] - p0, jp[k] - p0
        scale = np.linalg.norm(ref)
        if scale == 0:
            if np.any(mine != 0):
                out.append(k)
        elif np.linalg.norm(mine - ref) > BF16_UPDATE_BOUND * scale:
            out.append(k)
    for i, (a0, mine, ref) in enumerate(zip(aux, ta, ja)):
        if np.linalg.norm(mine - ref) > \
                BF16_UPDATE_BOUND * np.linalg.norm(ref - a0):
            out.append("aux%d" % i)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_sgd_train_step_matches_jax_on_a_one_rank_mesh(dtype):
    import jax
    import jax.numpy as jnp

    jn, tn = _bn_net(jmx), _bn_net(tmx)
    b = 16
    arg_shapes, _, aux_shapes = jn.infer_shape(data=(b, 1, 8, 8))
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(jn.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        params[name] = (np.ones(shape, np.float32) if name.endswith("gamma")
                        else (rng.randn(*shape) * 0.1).astype(np.float32))
    aux = [np.zeros(s, np.float32) if i % 2 == 0 else np.ones(s, np.float32)
           for i, s in enumerate(aux_shapes)]
    y = rng.randint(0, 2, b).astype(np.float32)
    x = (rng.randn(b, 1, 8, 8) * 0.5 + y[:, None, None, None]) \
        .astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    js, jnames = jsh.build_sgd_train_step(jn, ["data"], ["softmax_label"],
                                          lr=0.1, compute_dtype=jdt)
    jo, jp, ja = jax.jit(js)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {"data": jnp.asarray(x), "softmax_label": jnp.asarray(y)},
        [jnp.asarray(a) for a in aux], jax.random.PRNGKey(0))
    want = (np.asarray(jo[0], np.float32),
            {k: np.asarray(v) for k, v in jp.items()},
            [np.asarray(a) for a in ja])
    mesh = tsh.make_mesh({"dp": 1, "fsdp": 1}, device_type="cpu")
    sh = tsh.make_param_shardings(
        mesh, {k: v.shape for k, v in params.items()},
        [tsh.ShardingRule(".*", tsh.fsdp_param_spec((8,), mesh))])

    def port(compute_dtype):
        ts, tnames = tsh.build_sgd_train_step(
            tn, ["data"], ["softmax_label"], lr=0.1,
            compute_dtype=compute_dtype)
        assert tnames == jnames
        to, tp, ta = ts(tsh.shard_args(mesh, params, sh),
                        {"data": torch.from_numpy(x),
                         "softmax_label": torch.from_numpy(y)},
                        [torch.from_numpy(a) for a in aux],
                        torch.Generator())
        assert all(tp[k].dtype == torch.float32 for k in tp)
        assert all(a.dtype == torch.float32 for a in ta)
        return (to[0].numpy(),
                {k: v.full_tensor().numpy() for k, v in tp.items()},
                [a.numpy() for a in ta])

    got = port(None if dtype == "float32" else torch.bfloat16)
    if dtype == "float32":
        rtol, atol, out_atol = 1e-5, 1e-5, 1e-5
    else:
        # tests/test_mixed_precision.py's bound, then bf16's own below
        rtol, atol, out_atol = 0.0, 0.12, 0.06
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=out_atol)
    for k in params:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol,
                                   atol=atol, err_msg=k)
    for mine, ref in zip(got[2], want[2]):
        np.testing.assert_allclose(mine, ref, rtol=rtol, atol=atol)
    if dtype == "float32":
        return
    # the softmax outputs (at most 1) within two bfloat16 ulps
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2.0 ** -7)
    assert _bf16_misfit(got, want, params, aux) == []
    # the bound tells a bf16 step from a float32 one, from a step that
    # skips the update and from one that returns the old statistics
    f32 = port(None)
    assert {"c1_weight", "bn1_beta"} <= set(
        _bf16_misfit(f32, want, params, aux))
    assert {"c1_weight", "bn1_beta", "fc_weight", "fc_bias"} <= set(
        _bf16_misfit((got[0], params, got[2]), want, params, aux))
    assert _bf16_misfit((got[0], got[1], aux), want, params, aux) == \
        ["aux0", "aux1"]


def test_shard_check_part_b_over_two_gloo_processes():
    """The tool's part (b) at a small size: two ranks of a (dp 1, fsdp 2)
    DeviceMesh, each holding half of every param whose dim 0 divides,
    BatchNorm over the global batch, against one process's unsharded
    step within 4 float32 floors."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_shard_check.py"),
         "--cpu", "--part", "b", "--net", "small", "--mesh", "1,2",
         "--per-card", "2", "--image", "32"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])["b"]
    assert rec["launch_rc"] == 0 and not rec["failed"]
    assert rec["args_vs_reference_normwise"] <= rec["args_bound"]
    assert rec["divisible_params"] == rec["params"]
    for r in rec["ranks"]:
        assert all(mine * 2 == whole
                   for mine, whole in r["local_numel"].values())


def test_the_sharding_tool_imports_no_jax():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax\b|jaxlib\b|"
                         r"mxnet_tpu(?!_torch)\b)")
    with open(os.path.join(REPO, "tools", "torch_shard_check.py"),
              encoding="utf-8") as f:
        assert not [line for line in f if pattern.match(line)]


# ---------------------------------------------------------------------------
# the attention's axis name
# ---------------------------------------------------------------------------
def test_attention_takes_the_axis_name_positionally_in_a_one_rank_world():
    from mxnet_tpu_torch import parallel

    mesh = parallel.make_mesh({"sp": 1}, device_type="cpu")
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    want = parallel.reference_attention(q, k, v, causal=True)
    for fn in (parallel.ring_attention, parallel.ulysses_attention):
        for got in (fn(q, k, v, "sp", True), fn(q, k, v, "sp", causal=True,
                                                mesh=mesh),
                    fn(q, k, v, causal=True, group=mesh.get_group("sp"))):
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    with pytest.raises(tmx.MXNetError, match="not an axis"):
        parallel.ring_attention(q, k, v, "tp", mesh=mesh)
