"""Every fusable optimizer through the port's fused train step on the CPU
(the eager step function a CUDA graph captures on the card), on the
small MLP of tests/test_torch_common.py: bit-equal to the classic loop
(params, every optimizer state tensor, the loss stream), and close to
the JAX package's fused step; optimizers without a fusable plan raise;
Adam's states under the skip guard, in the numerics pack and across the
packages in a snapshot.

Bounds against the JAX package: losses, metric values, params and states
within rtol 1e-5 / atol 1e-6 after five steps (the two packages'
forwards differ by about 5e-6 relative, ROADMAP.md Queue C, the bound of
tests/test_torch_checkpoint_parity.py); the numerics pack as
tests/test_torch_numwatch.py holds it."""
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.fused_step import make_fused_step as jmake
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch.fused_step import make_fused_step as tmake
from mxnet_tpu_torch.optimizer import _state_tensors

from test_torch_common import (CKPT_BATCH, CKPT_DIM, ckpt_data, ckpt_mlp,
                               ckpt_params, ckpt_stream_callback)
from test_torch_numwatch import assert_packs_match

RTOL, ATOL = 1e-5, 1e-6
NBATCHES = 5


def _optimizer_params(pkg, kind):
    """Each kind with the settings chip_smoke's phase 11 trains with."""
    base = {"wd": 1e-4}
    extra = {"ccsgd": {"learning_rate": 0.05, "momentum": 0.9},
             "nag": {"learning_rate": 0.05, "momentum": 0.9},
             "adam": {"learning_rate": 1e-3, "clip_gradient": 5.0},
             "adagrad": {"learning_rate": 0.01},
             "rmsprop": {"learning_rate": 0.002, "lr_scheduler":
                         pkg.lr_scheduler.FactorScheduler(step=2,
                                                          factor=0.5)},
             "adadelta": {}, "sgld": {"learning_rate": 0.01},
             "test": {}}[kind]
    return dict(base, **extra)


FUSABLE = ["ccsgd", "nag", "adam", "adagrad", "rmsprop", "adadelta"]


def _fit(pkg, kind, fused, stream=None, nbatches=NBATCHES, num_epoch=1):
    net = ckpt_mlp(pkg)
    x, y = ckpt_data(nbatches)
    ctx = pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx, logger=logging)
    kw = {"fused_step": fused} if pkg is tmx else {}
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
            num_epoch=num_epoch, eval_metric=["acc", "ce"],
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in ckpt_params(net).items()},
            initializer=None, optimizer=kind,
            optimizer_params=_optimizer_params(pkg, kind),
            batch_end_callback=ckpt_stream_callback(
                [] if stream is None else stream), **kw)
    return mod


def _params(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def _states(mod):
    out = {}
    for i, s in mod._updater.states.items():
        parts = () if s is None else (s if isinstance(s, tuple) else (s,))
        out[i] = [np.asarray(p.asnumpy()).copy() for p in parts]
    return out


@pytest.mark.parametrize("kind", FUSABLE)
def test_fused_equals_classic_bit_for_bit(kind):
    streams = ([], [])
    mods = [_fit(tmx, kind, fused, s) for fused, s in zip((False, True),
                                                           streams)]
    assert mods[1]._fused_step_active and mods[1]._fused_step.eager_steps \
        == NBATCHES
    assert streams[0] == streams[1]
    a, b = _params(mods[0]), _params(mods[1])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    sa, sb = _states(mods[0]), _states(mods[1])
    assert sa.keys() == sb.keys()
    for i in sa:
        assert len(sa[i]) == len(sb[i]) == mods[1]._optimizer._n_states()
        for x, y in zip(sa[i], sb[i]):
            assert np.array_equal(x, y), i
    assert any(not np.array_equal(v, ckpt_params(mods[0].symbol)[k])
               for k, v in a.items())


@pytest.mark.parametrize("kind", FUSABLE)
def test_fused_follows_the_jax_fused_step(kind, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    theirs, mine = [], []
    jmod = _fit(jmx, kind, None, theirs)
    assert jmod._fused_step_active
    tmod = _fit(tmx, kind, True, mine)
    assert [m[:2] for m in mine] == [t[:2] for t in theirs]
    for m, t in zip(mine, theirs):
        np.testing.assert_allclose(np.array(m[2] + (m[3],)),
                                   np.array(t[2] + (t[3],)), rtol=RTOL,
                                   atol=ATOL)
    a, b = _params(tmod), _params(jmod)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    sa, sb = _states(tmod), _states(jmod)
    for i in sb:
        for x, y in zip(sa[i], sb[i]):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                       err_msg=str(i))


class _OwnUpdate(tmx.optimizer.Adam):
    def update(self, index, weight, grad, state):
        super().update(index, weight, grad, state)


@pytest.mark.parametrize("optimizer", ["sgld", "test", "own_update",
                                       "fused_update_off"])
def test_not_fusable_raises_naming_the_optimizer(optimizer, monkeypatch):
    net = ckpt_mlp(tmx)
    x, y = ckpt_data(2)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    opt, name = optimizer, {"sgld": "SGLD", "test": "Test"}.get(optimizer)
    if optimizer == "own_update":
        opt, name = _OwnUpdate(), "_OwnUpdate"
    elif optimizer == "fused_update_off":
        monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
        opt, name = "adam", "Adam"
    with pytest.raises(tmx.MXNetError,
                       match="optimizer %s has no fusable update" % name):
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
                num_epoch=1, optimizer=opt, fused_step=True)


@pytest.mark.parametrize("kind", ["sgld", "test"])
def test_not_fusable_trains_in_the_classic_loop(kind):
    tmx.random.seed(0)
    mod = _fit(tmx, kind, False)
    before = ckpt_params(mod.symbol)
    after = _params(mod)
    assert all(np.isfinite(v).all() for v in after.values())
    assert any(not np.array_equal(after[k], before[k]) for k in before)


def _manual(pkg, make, kind="adam"):
    net = ckpt_mlp(pkg)
    x, y = ckpt_data(2)
    data = pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data.provide_data, data.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in ckpt_params(net).items()},
                    initializer=None)
    mod.init_optimizer(optimizer=kind,
                       optimizer_params=_optimizer_params(pkg, kind))
    metric = pkg.metric.create("acc")
    step = make(mod, metric)
    return mod, step, step._numwatch, metric, list(data)


def _nan_batch(pkg):
    x = np.full((CKPT_BATCH, CKPT_DIM), np.nan, np.float32)
    y = np.zeros((CKPT_BATCH,), np.float32)
    return next(iter(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)))


def test_adam_states_survive_the_skip_guard(monkeypatch):
    """skip: across an all-NaN batch the weights, both of Adam's states
    (in their own storage) and the metric's device sums stay bit for
    bit; the next clean batch trains."""
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "skip")
    mod, step, plane, metric, batches = _manual(tmx, tmake)
    step.step(batches[0], metric)
    plane.after_step()
    before, states, acc = _params(mod), _states(mod), metric._acc.clone()
    ptrs = {i: [t.data_ptr() for t in _state_tensors(s)]
            for i, s in mod._updater.states.items()}
    step.step(_nan_batch(tmx), metric)
    assert plane.after_step()["numwatch_skips"] == 1
    after = _params(mod)
    for k in before:
        assert np.array_equal(before[k], after[k]), k
    for i, parts in _states(mod).items():
        assert len(parts) == 2
        for x, y in zip(parts, states[i]):
            assert np.array_equal(x, y), i
    assert {i: [t.data_ptr() for t in _state_tensors(s)]
            for i, s in mod._updater.states.items()} == ptrs
    assert torch.equal(acc, metric._acc)
    step.step(batches[1], metric)
    plane.after_step()
    assert any(not np.array_equal(after[k], v)
               for k, v in _params(mod).items())


@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_numwatch_update_norm_follows_jax(kind, monkeypatch):
    """The numerics pack's update sum of squares (and the rest of the
    pack) after Adam's and RMSProp's fused steps, against the JAX
    package's pack."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "")
    packs = []
    for pkg, make in ((jmx, jmake), (tmx, tmake)):
        mod, step, plane, metric, batches = _manual(pkg, make, kind)
        out = []
        for batch in batches:
            step.step(batch, metric)
            plane.after_step()
            out.append(np.asarray(plane._pack).copy())
        packs.append(out)
    for k, (theirs, mine) in enumerate(zip(*packs)):
        assert_packs_match(mine, theirs, "step %d" % (k + 1))
        assert (mine[:-1, tmx.numwatch.UPD_SUMSQ] > 0).all()


@pytest.mark.parametrize("saver,resumer", [(jmx, tmx), (tmx, jmx)],
                         ids=["jax_snapshot_port_resumes",
                              "port_snapshot_jax_resumes"])
def test_adam_snapshot_crosses_the_packages(tmp_path, monkeypatch, saver,
                                            resumer):
    """An Adam run snapshotted at step 3 by one package is resumed by the
    other from the same store: the rest of the stream and the final
    params follow the saver's uninterrupted run (both states and the
    update counts, so the bias correction, carried across)."""
    def fit(pkg, stream):
        return _fit(pkg, "adam", True if pkg is tmx else None, stream,
                    nbatches=4, num_epoch=2)

    ref = []
    ref_params = _params(fit(saver, ref))
    d = str(tmp_path / "snaps")
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")
    fit(saver, [])
    mp = os.path.join(d, ckpt.MANIFEST)
    with open(mp) as f:
        man = json.load(f)
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == 3]
    with open(mp, "w") as f:
        json.dump(man, f)
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "1")
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "0")
    got = []
    mod = fit(resumer, got)
    want = [r for r in ref if (r[0], r[1]) > (0, 2)]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.array(g[2] + (g[3],)),
                                   np.array(w[2] + (w[3],)), rtol=RTOL,
                                   atol=ATOL)
    for k, v in _params(mod).items():
        np.testing.assert_allclose(v, ref_params[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
