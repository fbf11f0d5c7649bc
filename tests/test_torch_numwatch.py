"""The port's numerics plane (mxnet_tpu_torch/numwatch.py, the fold and
the guards inside the fused step, the Monitor facade) against the JAX
package's (mxnet_tpu/numwatch.py), on the CPU.

The fold is held to the JAX fold on identical inputs (the MLP's and a
two-stage NHWC ResNet's parameter lists, with NaN and Inf planted), and
both packages' fused steps run the MLP of tests/test_numwatch.py from
the same params and batches with the same MXNET_TPU_* variables (set by
monkeypatch). Counts, first_bad_* stamps, step numbers and provenance
are exact; sums of squares, max-abs and the loss are within rtol 1e-5 /
atol 1e-7 (the two packages sum in different orders)."""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import numwatch as jnw
from mxnet_tpu.fused_step import make_fused_step as jmake
from mxnet_tpu_torch import numwatch as tnw
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.fused_step import make_fused_step as tmake

from test_torch_common import (CKPT_BATCH, CKPT_DIM, ckpt_data, ckpt_mlp,
                               ckpt_params, fresh_names, random_params)

RTOL, ATOL = 1e-5, 1e-7
EXACT = [tnw.G_NONFIN, tnw.G_ZERO, tnw.W_NONFIN, tnw.FB_PARAM, tnw.FB_GRAD]
CLOSE = [tnw.G_SUMSQ, tnw.G_MAXABS, tnw.W_SUMSQ, tnw.UPD_SUMSQ]


@pytest.fixture
def tel():
    for pkg in (jmx, tmx):
        pkg.telemetry.reset()
        pkg.telemetry.enable()
    yield
    for pkg in (jmx, tmx):
        pkg.telemetry.reset()
        pkg.telemetry.disable()


def assert_packs_match(mine, theirs, what=""):
    """The port's pack against the JAX package's: counts, stamps and the
    META step/out_nonfinite/skips exact, sums and the loss close."""
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape
    n = mine.shape[0] - 1
    np.testing.assert_array_equal(mine[:n, EXACT], theirs[:n, EXACT],
                                  err_msg=what)
    np.testing.assert_allclose(mine[:n, CLOSE], theirs[:n, CLOSE],
                               rtol=RTOL, atol=ATOL, err_msg=what)
    for col in (tnw.M_STEP, tnw.M_OUT_NONFIN, tnw.M_SKIPS):
        assert mine[n, col] == theirs[n, col], (what, tnw.META[col])
    np.testing.assert_allclose(mine[n, tnw.M_LOSS], theirs[n, tnw.M_LOSS],
                               rtol=RTOL, atol=ATOL, err_msg=what)


# -- the fold on identical inputs --------------------------------------

def _resnet2(pkg):
    with fresh_names(pkg):
        return pkg.models.get_resnet([1, 1], [16, 32, 64], num_classes=10,
                                     small_input=True, layout="NHWC")


def _fold_inputs(net, data_shape, plant, seed=0):
    """(names, pre-update weights, gradients, post-update weights,
    probabilities, labels) as numpy, with NaN/Inf planted by ``plant``."""
    args, _ = random_params(net, data_shape, seed=seed)
    names = [n for n in net.list_arguments() if n in args]
    rng = np.random.RandomState(seed + 1)
    w = [args[n] for n in names]
    g = [(rng.randn(*a.shape) * 0.01).astype(np.float32) for a in w]
    g[0].flat[::3] = 0.0
    if plant == "grad":
        g[1].flat[0] = np.nan
        g[-1].flat[-1] = np.inf
    elif plant == "weight":
        w[2] = w[2].copy()
        w[2].flat[1] = np.nan
        w[2].flat[2] = -np.inf
    new = [a - 0.1 * b for a, b in zip(w, g)]
    logits = rng.randn(data_shape[0], 10)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    labels = rng.randint(0, 10, data_shape[0]).astype(np.float32)
    return names, w, g, new, probs.astype(np.float32), labels


def _jax_fold(names, sizes, inputs, n_folds):
    import jax.numpy as jnp

    plane = jnw.NumWatch(names, sizes)
    pack = jnp.zeros((len(names) + 1, jnw.NCOLS), jnp.float32)
    w, g, new, probs, labels = ([jnp.asarray(a) for a in arrs]
                                for arrs in inputs)
    packs = []
    for _ in range(n_folds):
        pack, ok = plane.fold(pack, w, g, new, probs, labels)
        packs.append((np.asarray(pack), bool(ok)))
    return packs


def _port_fold(names, sizes, inputs, n_folds):
    plane = tnw.NumWatch(names, sizes)
    w, g, new, probs, labels = ([torch.from_numpy(np.array(a)) for a in arrs]
                                for arrs in inputs)
    packs = []
    for _ in range(n_folds):
        ok = plane.fold(w, g, new, probs, labels)
        packs.append((plane._pack.numpy().copy(), bool(ok)))
    return packs


@pytest.mark.parametrize("model", ["mlp", "resnet2"])
@pytest.mark.parametrize("plant", ["none", "grad", "weight"])
@pytest.mark.parametrize("guard", ["", "skip"])
def test_fold_matches_jax_fold(model, plant, guard, monkeypatch):
    """Two folds of the same inputs through both packages' NumWatch.fold:
    the pack after each (the second sees the first's stamps and step)
    and the skip predicate."""
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", guard)
    if model == "mlp":
        net, shape = ckpt_mlp(tmx), (CKPT_BATCH, CKPT_DIM)
    else:
        net, shape = _resnet2(tmx), (4, 16, 16, 3)
    names, w, g, new, probs, labels = _fold_inputs(net, shape, plant)
    sizes = [a.size for a in w]
    inputs = (w, g, new, [probs], [labels])
    theirs = _jax_fold(names, sizes, inputs, 2)
    mine = _port_fold(names, sizes, inputs, 2)
    for k, ((p_m, ok_m), (p_t, ok_t)) in enumerate(zip(mine, theirs)):
        assert_packs_match(p_m, p_t, "fold %d" % k)
        assert ok_m == ok_t == (plant != "grad")
    assert mine[-1][0][-1, tnw.M_SKIPS] == \
        (2 if guard and plant == "grad" else 0)
    prov = [tnw.NumWatch(names, sizes)._provenance(p[:-1]) for p, _ in mine]
    assert prov == [jnw.NumWatch(names, sizes)._provenance(p[:-1])
                    for p, _ in theirs]


# -- both packages' fused steps -----------------------------------------

def _env(monkeypatch, guard=None, every_n=1):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", str(every_n))
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", guard or "")


def _manual(pkg, make, nbatches=2):
    """A module bound and fused by hand (the fit loop's fused path without
    the loop), from ckpt_params over ckpt_data: (mod, step, plane,
    metric, batches)."""
    net = ckpt_mlp(pkg)
    x, y = ckpt_data(nbatches)
    data = pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data.provide_data, data.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in ckpt_params(net).items()},
                    initializer=None)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    metric = pkg.metric.create("acc")
    step = make(mod, metric)
    return mod, step, step._numwatch, metric, list(data)


def _nan_batch(pkg):
    x = np.full((CKPT_BATCH, CKPT_DIM), np.nan, np.float32)
    y = np.zeros((CKPT_BATCH,), np.float32)
    return next(iter(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)))


def _poison_jax(step, name):
    import jax.numpy as jnp
    from mxnet_tpu.analysis import sanitizers

    nd = step._executor.arg_dict[name]
    with sanitizers.intentional_transfer():
        nd._data = jnp.full(nd.shape, jnp.nan, jnp.float32)


def _poison_port(step, name):
    """NaN into one bound weight, in place (the graph's own storage)."""
    step._ex.arg_dict[name].handle.fill_(float("nan"))


def _params(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


@pytest.mark.parametrize("scenario", ["clean", "poison_param", "nan_batch"])
def test_pack_follows_jax_through_fused_steps(scenario, tel, monkeypatch):
    """Three fused steps (b0, the scenario's batch, b1) through both
    packages with a fetch each step: the packs, the step-record extras
    and the provenance verdict agree (tests/test_numwatch.py's
    provenance cases: a poisoned weight is named as kind "param" at step
    2, a NaN batch stamps the first gradient in argument order)."""
    _env(monkeypatch)
    runs = []
    for pkg, make, poison in ((jmx, jmake, _poison_jax),
                              (tmx, tmake, _poison_port)):
        mod, step, plane, metric, batches = _manual(pkg, make)
        assert plane is not None
        out = []
        for k, batch in enumerate([batches[0], batches[1], batches[1]]):
            if k == 1 and scenario == "poison_param":
                poison(step, "fc2_weight")
            if k == 1 and scenario == "nan_batch":
                batch = _nan_batch(pkg)
            step.step(batch, metric)
            extras = plane.after_step()
            out.append((np.asarray(plane._pack).copy(), extras,
                        plane.provenance(), plane.names))
        runs.append(out)
    for k, (theirs, mine) in enumerate(zip(*runs)):
        assert mine[3] == theirs[3]
        assert_packs_match(mine[0], theirs[0], "step %d" % (k + 1))
        assert mine[2] == theirs[2]
        assert mine[1].keys() == theirs[1].keys()
        for key, v in theirs[1].items():
            if isinstance(v, float):
                np.testing.assert_allclose(mine[1][key], v, rtol=RTOL,
                                           atol=ATOL, err_msg=key)
            else:
                assert mine[1][key] == v, key
    want = {"clean": None, "poison_param": ("fc2_weight", "param", 2),
            "nan_batch": ("fc1_weight", "grad", 2)}[scenario]
    assert runs[1][-1][2] == want


def test_skip_guard_holds_the_state_bit_for_bit(tel, monkeypatch):
    """skip: after a NaN batch the weights, the momenta and the metric's
    device sums are bit-identical to before it, the skip counter moves
    as the JAX package's, and a clean batch after it trains again."""
    _env(monkeypatch, guard="skip")
    skips = []
    for pkg, make in ((jmx, jmake), (tmx, tmake)):
        mod, step, plane, metric, batches = _manual(pkg, make)
        step.step(batches[0], metric)
        plane.after_step()
        if pkg is tmx:
            before = _params(mod)
            moms = {i: s.asnumpy().copy()
                    for i, s in mod._updater.states.items()}
            acc = metric._acc.clone()
        step.step(_nan_batch(pkg), metric)
        extras = plane.after_step()
        skips.append((extras["numwatch_skips"],
                      pkg.telemetry.peek("numwatch.skipped_steps")))
    after = _params(mod)
    for name in before:
        assert np.array_equal(before[name], after[name]), name
    for i, m in mod._updater.states.items():
        assert np.array_equal(moms[i], m.asnumpy()), i
    assert torch.equal(acc, metric._acc)
    assert skips[0] == skips[1] == (1, 1)
    step.step(batches[1], metric)
    plane.after_step()
    resumed = _params(mod)
    assert any(not np.array_equal(after[n], resumed[n]) for n in after)
    assert all(np.isfinite(v).all() for v in resumed.values())


@pytest.mark.parametrize("case", ["restores", "cooldown"])
def test_rollback_guard(case, tel, monkeypatch, tmp_path):
    """rollback: a fetch that sees a nonfinite weight restores the last
    healthy snapshot into the bound tensors (same storage), zeroes the
    pack in place and training goes on finite; a second poisoning inside
    the cooldown raises NumericsError, as in the JAX package."""
    _env(monkeypatch, guard="rollback")
    mod, step, plane, metric, batches = _manual(tmx, tmake)
    plane.bind_ckpt(CheckpointManager(mod, metric, None,
                                      directory=str(tmp_path)))
    step.step(batches[0], metric)
    plane.after_step()   # clean: saves the healthy snapshot
    healthy = _params(mod)
    ptrs = {n: a.handle.data_ptr() for n, a in step._ex.arg_dict.items()}
    pack = plane._pack.data_ptr()
    _poison_port(step, "fc1_weight")
    step.step(batches[1], metric)
    if case == "cooldown":
        plane.after_step()
        _poison_port(step, "fc1_weight")
        step.step(batches[0], metric)
        with pytest.raises(tnw.NumericsError, match="cooldown"):
            plane.after_step()
        return
    extras = plane.after_step()
    assert extras["numwatch_rollback"] and extras["numwatch_rollbacks"] == 1
    assert tmx.telemetry.peek("numwatch.rollbacks") == 1
    restored = _params(mod)
    for name in healthy:
        assert np.array_equal(healthy[name], restored[name]), name
    assert {n: a.handle.data_ptr()
            for n, a in step._ex.arg_dict.items()} == ptrs
    assert plane._pack.data_ptr() == pack
    assert not plane._pack.any()
    step.step(batches[0], metric)
    assert plane.after_step()["numwatch_nonfinite"] == 0


def test_guard_env_validation(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "explode")
    with pytest.raises(ValueError, match="explode"):
        tnw.NumWatch(["w"], [4])


def test_numwatch_off_is_off(monkeypatch):
    """No variable, no monitor: the step carries no plane, and the
    per-batch hook is one None check (pinned below 2 us, as the JAX
    package's test pins its own)."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    monkeypatch.delenv("MXNET_TPU_NUMWATCH", raising=False)
    assert _manual(tmx, tmake)[2] is None
    n = 20000
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            tnw.after_step(None)
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 2e-6, "disabled numwatch hook costs %.2fus" % (best * 1e6)


def test_armed_fit_fetches_on_the_cadence(tel, monkeypatch):
    """fit with MXNET_TPU_NUMWATCH_EVERY_N=2 over 6 batches fetches 3
    times in both packages, and the step trace carries the extras."""
    _env(monkeypatch, every_n=2)
    fetches = []
    for pkg in (jmx, tmx):
        net = ckpt_mlp(pkg)
        x, y = ckpt_data(6)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=1, optimizer="sgd", initializer=None,
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in ckpt_params(net).items()},
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        assert mod._fused_step_active
        fetches.append(pkg.telemetry.peek("numwatch.fetches"))
        assert pkg.telemetry.peek("numwatch.grad_norm", kind="gauge") > 0
    assert fetches == [3, 3]
    recs = tmx.tracing.step_trace().records()
    assert [("numwatch_grad_norm" in r) for r in recs] == \
        [False, True] * 3
    tmx.tracing.shutdown()
    jmx.tracing.shutdown()


def test_resnet2_fit_pack_against_its_own_tensors(tel, monkeypatch):
    """The two-stage NHWC ResNet (K3, K4 and K5 through their plain
    versions) through fit(fused_step=True), skip guard armed, a NaN batch
    second: the exact fields of every step's pack (nonfinite counts,
    stamps, step, skips) and the provenance equal the JAX package's; the
    port's first pack holds the sums of squares of the weights it started
    from, and its last the gradients the step left in the bound arrays
    (plain recomputations, rtol 1e-5 / atol 1e-7)."""
    _env(monkeypatch, guard="skip")
    batch, hw = 4, 16
    x = np.random.RandomState(9).randn(3 * batch, hw, hw, 3).astype(
        np.float32)
    x[batch:2 * batch] = np.nan
    y = (np.arange(3 * batch) % 10).astype(np.float32)
    args, aux = random_params(_resnet2(tmx), (batch, hw, hw, 3), seed=2)
    seen = []
    for pkg in (jmx, tmx):
        packs = []

        def cb(param, packs=packs):
            plane = param.locals["numwatch"]
            packs.append((np.asarray(plane._pack).copy(),
                          plane.provenance()))

        mod = pkg.mod.Module(_resnet2(pkg), context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
                optimizer="sgd", initializer=None,
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in args.items()},
                aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in aux.items()},
                optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
                batch_end_callback=cb)
        seen.append(packs)
    exact = [tnw.G_NONFIN, tnw.W_NONFIN, tnw.FB_PARAM, tnw.FB_GRAD]
    assert len(seen[0]) == len(seen[1]) == 3
    for (p_t, prov_t), (p_m, prov_m) in zip(*seen):
        n = p_m.shape[0] - 1
        np.testing.assert_array_equal(p_m[:n, exact], p_t[:n, exact])
        for col in (tnw.M_STEP, tnw.M_SKIPS):
            assert p_m[n, col] == p_t[n, col]
        assert prov_m == prov_t
    assert seen[1][1][1][1] == "grad" and seen[1][2][0][-1, tnw.M_SKIPS] == 1
    plane = mod._fused_step._numwatch
    ex = mod._exec_group.executor
    first, last = seen[1][0][0], seen[1][2][0]
    for i, name in enumerate(plane.names):
        g = ex.grad_dict[name].asnumpy().astype(np.float64)
        np.testing.assert_allclose(
            [first[i, tnw.W_SUMSQ], last[i, tnw.G_SUMSQ],
             last[i, tnw.G_MAXABS]],
            [np.sum(args[name].astype(np.float64) ** 2), np.sum(g * g),
             np.abs(g).max()], rtol=RTOL, atol=ATOL, err_msg=name)


# -- the Monitor facade ------------------------------------------------

def _rows_match(mine, theirs):
    assert [r[:2] for r in mine] == [r[:2] for r in theirs]
    np.testing.assert_allclose([float(r[2]) for r in mine],
                               [float(r[2]) for r in theirs],
                               rtol=1e-5, atol=1e-6)


def test_default_monitor_rides_the_pack_as_in_jax(tel, monkeypatch):
    """A default-stat Monitor installed on the executor rides the pack
    in both packages (no fallback, no refusal): tic, one fused step, toc
    give the same rows."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    monkeypatch.delenv("MXNET_TPU_NUMWATCH", raising=False)
    rows = []
    for pkg, make in ((jmx, jmake), (tmx, tmake)):
        net = ckpt_mlp(pkg)
        x, y = ckpt_data(1)
        data = pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data.provide_data, data.provide_label)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in ckpt_params(net).items()},
                        initializer=None)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05})
        mon = pkg.monitor.Monitor(interval=1, sort=True)
        mod.install_monitor(mon)
        step = make(mod, pkg.metric.create("acc"))
        assert step._numwatch is not None and step._numwatch._monitor is mon
        mon.tic()
        step.step(next(iter(data)), pkg.metric.create("acc"))
        rows.append(mon.toc())
    names = {name for _, name, _ in rows[1]}
    assert {"fc1_weight", "fc1_weight_grad"} <= names
    _rows_match(rows[1], rows[0])


def test_custom_monitor_through_the_classic_loop_as_in_jax(monkeypatch):
    """A Monitor with a custom stat_func: fit's classic loop feeds it
    every op output by the executor's callback and every argument and
    gradient at toc, in both packages alike; the port's fused step
    refuses it, naming the reason."""
    monkeypatch.delenv("MXNET_TPU_FUSED_STEP", raising=False)
    rows = []
    for pkg in (jmx, tmx):
        def stat(arr, pkg=pkg):
            v = np.abs(arr.asnumpy()).max(keepdims=True).reshape(1)
            return pkg.nd.array(v, ctx=pkg.cpu())

        net = ckpt_mlp(pkg)
        x, y = ckpt_data(2)
        mon = pkg.monitor.Monitor(interval=1, stat_func=stat, sort=True)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=1, optimizer="sgd", initializer=None,
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in ckpt_params(net).items()},
                optimizer_params={"learning_rate": 0.05}, monitor=mon)
        mon.tic()
        mod.forward_backward(next(iter(pkg.io.NDArrayIter(
            x, y, batch_size=CKPT_BATCH))))
        rows.append(mon.toc())
    names = [r[1] for r in rows[1]]
    assert "fc1_output" in names and "fc1_weight_grad" in names
    _rows_match(rows[1], rows[0])
    mod = pkg.mod.Module(ckpt_mlp(tmx), context=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="custom stat_func"):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=1, monitor=tmx.monitor.Monitor(1, stat),
                fused_step=True)


def test_flight_recorder_dumps_the_health_ring(tel, monkeypatch, tmp_path):
    """A dump carries the model's numeric trajectory (numwatch.jsonl)."""
    import json
    import os

    _env(monkeypatch)
    mod, step, plane, metric, batches = _manual(tmx, tmake)
    step.step(batches[0], metric)
    plane.after_step()
    d = tmx.tracing.FlightRecorder(crash_dir=str(tmp_path)).dump("test")
    rows = [json.loads(line)
            for line in open(os.path.join(d, "numwatch.jsonl"))]
    assert rows and rows[-1]["grad_norm"] > 0 and rows[-1]["step"] == 1
    assert set(rows[-1]) == {"step", "host_step", "loss", "grad_norm",
                             "uw_max", "nonfinite", "bad_tensor", "skips",
                             "rollbacks"}
