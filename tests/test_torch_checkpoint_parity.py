"""Checkpoints across the two packages, in each direction: a JAX-package
snapshot resumed by the port and a port snapshot resumed by the JAX
package through the same snapshot store, each held to the other
package's uninterrupted run; ``Module.save_checkpoint`` files
(``-symbol.json``, ``.params``, ``.states``) loaded by the other
package; and the iterator and optimizer checkpoint states.

Both runs start from the same numpy params with a fixed data order. The
two packages' forwards differ by about 5e-6 relative (ROADMAP.md Queue
C), so streams and params are held within rtol 1e-5 / atol 1e-6, the
bound this file uses throughout."""
import json
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ckpt

from test_torch_common import (CKPT_BATCH, ckpt_data, ckpt_mlp, ckpt_params,
                               ckpt_stream_callback)

RTOL, ATOL = 1e-5, 1e-6
NBATCHES, NUM_EPOCH = 4, 2


def _opt_params(pkg):
    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": pkg.lr_scheduler.FactorScheduler(step=3,
                                                             factor=0.5)}


def _fit(pkg, stream):
    """One fit of ckpt_mlp in ``pkg`` on the CPU (the port through its
    fused step, the JAX package through its classic loop)."""
    net = ckpt_mlp(pkg)
    x, y = ckpt_data(NBATCHES)
    ctx = pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx, logger=logging)
    kw = {"fused_step": True} if pkg is tmx else {}
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH),
            num_epoch=NUM_EPOCH, eval_metric=["acc", "ce"],
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in ckpt_params(net).items()},
            initializer=None, optimizer_params=_opt_params(pkg),
            batch_end_callback=ckpt_stream_callback(stream), **kw)
    return mod


def _host_params(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_streams_close(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        _close(np.array(g[2] + (g[3],)), np.array(w[2] + (w[3],)))


@pytest.mark.parametrize("saver,resumer", [(jmx, tmx), (tmx, jmx)],
                         ids=["jax_snapshot_port_resumes",
                              "port_snapshot_jax_resumes"])
def test_resume_from_the_other_packages_snapshot(tmp_path, monkeypatch,
                                                 caplog, saver, resumer):
    """``saver`` trains with snapshots every 3 steps; ``resumer`` restores
    the step-3 snapshot from the same store and runs the rest; the rest
    of its (epoch, nbatch, metrics, loss) stream and its final params
    match the saver's uninterrupted run."""
    caplog.set_level(logging.INFO, logger="mxnet_tpu_torch.checkpoint")
    jmx.random.seed(0)
    ref = []
    ref_params = _host_params(_fit(saver, ref))
    d = str(tmp_path / "snaps")
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")
    _fit(saver, [])
    mp = os.path.join(d, ckpt.MANIFEST)
    with open(mp) as f:
        man = json.load(f)
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == 3]
    with open(mp, "w") as f:
        json.dump(man, f)
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "1")
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "0")
    got = []
    got_params = _host_params(_fit(resumer, got))
    _assert_streams_close(got, [r for r in ref if (r[0], r[1]) > (0, 2)])
    if resumer is tmx:
        assert "RNG stream is not carried across" in caplog.text
    assert got_params.keys() == ref_params.keys()
    for k in ref_params:
        _close(got_params[k], ref_params[k])


def _bound_for_optimizer(mod):
    mod.bind(data_shapes=[("data", (CKPT_BATCH, 6))],
             label_shapes=[("softmax_label", (CKPT_BATCH,))])
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    return mod


@pytest.mark.parametrize("saver,loader", [(tmx, jmx), (jmx, tmx)],
                         ids=["port_files_jax_loads", "jax_files_port_loads"])
def test_checkpoint_files_load_in_the_other_package(tmp_path, saver,
                                                    loader):
    jmx.random.seed(0)
    mod = _fit(saver, [])
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    other = loader.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                   context=loader.cpu())
    _bound_for_optimizer(other)
    other.load_optimizer_states(prefix + "-0001.states")
    want, got = _host_params(mod), _host_params(other)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert sorted(other._updater.states) == sorted(mod._updater.states)
    for i, s in mod._updater.states.items():
        assert np.array_equal(other._updater.states[i].asnumpy(),
                              s.asnumpy()), i


def _idx_files(tmp_path):
    rng = np.random.RandomState(0)
    img = tmp_path / "img-idx3-ubyte"
    lab = tmp_path / "lab-idx1-ubyte"
    img.write_bytes(bytes([0, 0, 8, 3, 0, 0, 0, 40, 0, 0, 0, 28, 0, 0, 0,
                           28]) + rng.randint(0, 256, 40 * 784,
                                              dtype=np.uint8).tobytes())
    lab.write_bytes(bytes([0, 0, 8, 1, 0, 0, 0, 40])
                    + rng.randint(0, 10, 40, dtype=np.uint8).tobytes())
    return str(img), str(lab)


def _csv_file(tmp_path):
    path = tmp_path / "d.csv"
    np.savetxt(str(path), np.arange(40, dtype=np.float32).reshape(10, 4),
               delimiter=",")
    return str(path)


@pytest.mark.parametrize("kind", ["NDArrayIter", "MNISTIter", "CSVIter"])
def test_iterator_checkpoint_state_matches_jax(tmp_path, kind):
    """A seek to batch 2 yields the JAX package's third batch; the
    NDArrayIter state equals the JAX package's (its MNISTIter and CSVIter
    have no checkpoint state)."""
    def make(pkg):
        if kind == "NDArrayIter":
            x, y = ckpt_data(3)
            return pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)
        if kind == "MNISTIter":
            img, lab = _idx_files(tmp_path)
            return pkg.io.MNISTIter(image=img, label=lab, batch_size=8,
                                    flat=True, seed=1)
        return pkg.io.CSVIter(data_csv=_csv_file(tmp_path),
                              data_shape=(4,), batch_size=3)
    theirs, mine = make(jmx), make(tmx)
    state = mine.get_checkpoint_state()
    assert state["kind"] == kind
    if kind == "NDArrayIter":
        assert state == theirs.get_checkpoint_state()
    for _ in range(3):
        want = theirs.next()
    mine.next()
    mine.set_checkpoint_state({"batches": 2})
    got = mine.next()
    assert np.array_equal(got.data[0].asnumpy(), want.data[0].asnumpy())
    assert np.array_equal(got.label[0].asnumpy(), want.label[0].asnumpy())


def test_optimizer_checkpoint_state_matches_jax():
    jmx.random.seed(0)
    states = [_fit(pkg, [])._optimizer.get_checkpoint_state()
              for pkg in (jmx, tmx)]
    assert states[0] == states[1]
