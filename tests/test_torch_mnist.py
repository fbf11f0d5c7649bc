"""The MNIST path of the port on the CPU against the JAX package: the
model builders, the DataIter protocol, MNISTIter and CSVIter batch for
batch, a short last batch through score and predict, MLP and LeNet
training on tools/make_mnist_synth.py data (through the fused step in
the port), checkpoints read across the packages, and FeedForward."""
import gzip
import importlib.util
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx

from test_torch_common import fresh_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth_tool():
    spec = importlib.util.spec_from_file_location(
        "make_mnist_synth", os.path.join(REPO, "tools", "make_mnist_synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a):
    return a.asnumpy()


@pytest.mark.parametrize("name,shape", [
    ("get_mlp", (2, 784)), ("get_lenet", (2, 1, 28, 28)),
    ("get_inception_bn_28_small", (2, 3, 28, 28)),
    ("get_inception_bn", (2, 3, 224, 224))])
def test_model_builders_match_jax(name, shape):
    """The same graph as the JAX package's builder: byte-equal JSON and
    equal inferred shapes."""
    syms = []
    for pkg in (jmx, tmx):
        with fresh_names(pkg):
            syms.append(getattr(pkg.models, name)())
    assert syms[1].tojson() == syms[0].tojson()
    for a, b in zip(syms[0].infer_shape(data=shape),
                    syms[1].infer_shape(data=shape)):
        assert [tuple(s) for s in a] == [tuple(s) for s in b]


def _walk_next(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((_np(b.data[0]), _np(b.label[0]), b.pad, b.index))


def _walk_protocol(it):
    out = []
    while it.iter_next():
        out.append((_np(it.getdata()[0]), _np(it.getlabel()[0]),
                    it.getpad(), it.getindex()))
    return out


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_data_iter_protocol_matches_jax(handle):
    """NDArrayIter walked through next(), through iter_next/getdata/
    getlabel/getpad/getindex after a reset, and through the for loop:
    the same batches, pads and indices as the JAX package's, each a CPU
    NDArray."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    walks = []
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=4,
                                last_batch_handle=handle)
        assert isinstance(it, pkg.io.DataIter)
        first = _walk_next(it)
        it.reset()
        second = _walk_protocol(it)
        it.reset()
        third = [(_np(b.data[0]), _np(b.label[0]), b.pad, b.index)
                 for b in it]
        walks.append((first, second, third, it.provide_data,
                      it.provide_label))
    batch = tmx.io.NDArrayIter(x, y, batch_size=4).next()
    assert isinstance(batch.data[0], tmx.nd.NDArray)
    assert batch.data[0].context == tmx.cpu()
    (jf, js, jt, jd, jl), (tf, ts, tt, td, tl) = walks
    assert [tuple(d) for d in td] == [tuple(d) for d in jd]
    assert [tuple(d) for d in tl] == [tuple(d) for d in jl]
    assert len(jf) == (3 if handle == "pad" else 2)
    for ref, got in ((jf, tf), (js, ts), (jt, tt), (jf, ts)):
        assert len(ref) == len(got)
        for (dj, lj, pj, ij), (dt, lt, pt, it_) in zip(ref, got):
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(lt, lj)
            assert (pt, it_) == (pj, ij)


@pytest.mark.parametrize("dtype,view", [
    (np.float32, True), (np.uint8, True), (np.float64, False),
    (np.int64, False)])
def test_ndarray_iter_batches_copy_only_to_convert(dtype, view):
    """A full batch of NDArrayIter is a view of the iterator's rows where
    nd.array would keep their dtype, so the executor group's copy onto
    the card is the batch's one host copy; float64 and int64 rows become
    a float32 copy, as nd.array makes them, with the JAX package's
    values and dtype."""
    x = np.arange(6 * 2).reshape(6, 2).astype(dtype)
    it = tmx.io.NDArrayIter(x, np.zeros(6, np.float32), batch_size=4)
    batch = it.next()
    ref = jmx.io.NDArrayIter(x, np.zeros(6, np.float32), batch_size=4)
    want = ref.next().data[0].asnumpy()
    got = batch.data[0].asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    source = it.data[0][1]
    assert np.shares_memory(got, source) == view
    wrapped = it.next().data[0].asnumpy()    # the short batch wraps
    np.testing.assert_array_equal(wrapped, ref.next().data[0].asnumpy())
    assert not np.shares_memory(wrapped, source)


def _write_idx(tmp_path, n, gz, seed=0):
    tool = _synth_tool()
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n)
    paths = []
    for name, write, arr in (("images", tool.write_idx_images, images),
                             ("labels", tool.write_idx_labels, labels)):
        path = str(tmp_path / name)
        write(path, arr)
        if gz:
            with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
                g.write(f.read())
            path += ".gz"
        paths.append(path)
    return paths


@pytest.mark.parametrize("gz,kwargs", [
    (True, {"batch_size": 7, "shuffle": True, "seed": 3}),
    (False, {"batch_size": 5, "shuffle": False, "flat": True,
             "num_parts": 2, "part_index": 1}),
    (False, {"batch_size": 8, "shuffle": True, "seed": 0,
             "input_shape": (28, 28, 1)})],
    ids=["gzip_shuffled", "flat_sharded", "input_shape"])
def test_mnist_iter_matches_jax(tmp_path, gz, kwargs):
    image, label = _write_idx(tmp_path, 43, gz)
    walks = [_walk_next(pkg.io.MNISTIter(image=image, label=label, **kwargs))
             for pkg in (jmx, tmx)]
    assert len(walks[0]) == len(walks[1]) > 0
    for (dj, lj, pj, _), (dt, lt, pt, _) in zip(*walks):
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        assert pt == pj == 0


@pytest.mark.parametrize("with_label", [True, False])
def test_csv_iter_matches_jax(tmp_path, with_label):
    rng = np.random.RandomState(4)
    data = rng.randn(11, 6).astype(np.float32)
    np.savetxt(tmp_path / "data.csv", data, delimiter=",")
    kwargs = {"data_csv": str(tmp_path / "data.csv"), "data_shape": (2, 3),
              "batch_size": 4}
    if with_label:
        np.savetxt(tmp_path / "label.csv", np.arange(11.0), delimiter=",")
        kwargs["label_csv"] = str(tmp_path / "label.csv")
    walks = [_walk_next(pkg.io.CSVIter(**kwargs)) for pkg in (jmx, tmx)]
    assert len(walks[1]) == 3 and walks[1][-1][2] == 1
    for (dj, lj, pj, _), (dt, lt, pt, _) in zip(*walks):
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        assert pt == pj


def _short_iter(pkg, x, y, batch):
    """Batches of ``batch`` rows with a short last one (the reference's
    NDArrayIter wraps instead)."""

    class Short(pkg.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = batch
            self.cur = -batch

        @property
        def provide_data(self):
            return [pkg.io.DataDesc("data", (batch,) + x.shape[1:])]

        @property
        def provide_label(self):
            return [pkg.io.DataDesc("softmax_label", (batch,))]

        def reset(self):
            self.cur = -batch

        def iter_next(self):
            self.cur += batch
            return self.cur < len(x)

        def getdata(self):
            return [pkg.nd.array(x[self.cur:self.cur + batch],
                                 ctx=pkg.cpu())]

        def getlabel(self):
            return [pkg.nd.array(y[self.cur:self.cur + batch],
                                 ctx=pkg.cpu())]

    return Short()


def test_short_last_batch_through_score_and_predict_matches_jax():
    """An iterator whose last batch has 4 of 8 rows: predict returns all
    20 rows and score's metrics cover the 20 real rows, equal to the JAX
    package's (forwards within rtol 1e-5 / atol 1e-5, as
    test_torch_train.py's BatchNorm forward)."""
    rng = np.random.RandomState(2)
    x = rng.randn(20, 6).astype(np.float32)
    y = rng.randint(0, 3, 20).astype(np.float32)
    args = {"fc1_weight": rng.randn(16, 6), "fc1_bias": rng.randn(16),
            "fc2_weight": rng.randn(3, 16), "fc2_bias": rng.randn(3)}
    res = []
    for pkg in (jmx, tmx):
        with fresh_names(pkg):
            net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
                pkg.sym.Activation(pkg.sym.FullyConnected(
                    pkg.sym.Variable("data"), num_hidden=16, name="fc1"),
                    act_type="relu"), num_hidden=3, name="fc2"),
                name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        it = _short_iter(pkg, x, y, 8)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.set_params({k: pkg.nd.array(v.astype(np.float32),
                                        ctx=pkg.cpu())
                        for k, v in args.items()}, {})
        probs = mod.predict(it).asnumpy()
        scores = dict(mod.score(it, ["acc", "ce"]))
        res.append((probs, scores))
    (pj, sj), (pt, st) = res
    assert pt.shape == pj.shape == (20, 3)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    assert st["accuracy"] == sj["accuracy"]
    np.testing.assert_allclose(st["cross-entropy"], sj["cross-entropy"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def synth_mnist(tmp_path_factory):
    """24 training and 8 test digits rendered by tools/make_mnist_synth.py
    (PIL glyphs, seed 0)."""
    out = str(tmp_path_factory.mktemp("mnist"))
    _synth_tool().generate(out, n_train=24, n_test=8, seed=0)
    return out


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_mnist_training_follows_jax(synth_mnist, net):
    """3 SGD steps (lr 0.1, momentum 0.9) of the MLP and of LeNet over
    MNISTIter batches of 8, from params the JAX package initialised: the
    port's fused step follows the JAX package's loop, per-step losses
    within rtol 1e-4, params within rtol 1e-3 / atol 1e-5."""
    batch, flat = 8, net == "mlp"
    image = os.path.join(synth_mnist, "train-images-idx3-ubyte")
    label = os.path.join(synth_mnist, "train-labels-idx1-ubyte")
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jmx.random.seed(0)
    with fresh_names(jmx):
        jsym = getattr(jmx.models, "get_" + net)()
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    shape = (batch, 784) if flat else (batch, 1, 28, 28)
    jmod.bind(data_shapes=[("data", shape)], for_training=False)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    a0 = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    res = []
    for pkg in (jmx, tmx):
        with fresh_names(pkg):
            sym = getattr(pkg.models, "get_" + net)()
        losses = []

        def record(param, losses=losses):
            probs = param.locals["self"].get_outputs()[0].asnumpy()
            lab = param.locals["data_batch"].label[0].asnumpy()
            losses.append(-np.log(probs.astype(np.float64)[
                np.arange(batch), lab.astype(int)]).mean())

        mod = pkg.mod.Module(sym, context=pkg.cpu(), logger=logging)
        kwargs = {"fused_step": True} if pkg is tmx else {}
        mod.fit(pkg.io.MNISTIter(image=image, label=label, batch_size=batch,
                                 flat=flat, seed=1),
                num_epoch=1, initializer=None, optimizer_params=opt,
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in a0.items()},
                batch_end_callback=record, **kwargs)
        res.append((np.array(losses),
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()}))
    (lj, pj), (lt, pt) = res
    assert len(lt) == 3 and np.all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
        assert not np.array_equal(pt[k], a0[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_written_by_either_package_loads_in_the_other(tmp_path,
                                                                 writer):
    """save_checkpoint/load_checkpoint across the packages: the symbol's
    JSON and every param and aux array arrive unchanged; the write leaves
    no temporary file behind."""
    rng = np.random.RandomState(7)
    pkgs = {"jax": jmx, "port": tmx}
    src = pkgs[writer]
    dst = pkgs["port" if writer == "jax" else "jax"]
    with fresh_names(src):
        sym = src.models.get_inception_bn_28_small()
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, 28, 28))
    args = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: rng.rand(*s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / "ck")
    src.model.save_checkpoint(
        prefix, 3, sym, {k: src.nd.array(v, ctx=src.cpu())
                         for k, v in args.items()},
        {k: src.nd.array(v, ctx=src.cpu()) for k, v in aux.items()})
    assert sorted(os.listdir(tmp_path)) == ["ck-0003.params",
                                            "ck-symbol.json"]
    sym2, args2, aux2 = dst.model.load_checkpoint(prefix, 3)
    assert sym2.tojson() == sym.tojson()
    assert args2.keys() == args.keys() and aux2.keys() == aux.keys()
    for want, got in ((args, args2), (aux, aux2)):
        for k in want:
            np.testing.assert_array_equal(got[k].asnumpy(), want[k])


@pytest.mark.parametrize("fused", [False, True])
def test_feedforward_matches_jax(tmp_path, fused):
    """FeedForward.create (2 epochs of momentum SGD on numpy arrays,
    shuffled from the same numpy seed), then predict and score, equal to
    the JAX package's within the training tolerances; the port's model
    saved and loaded back predicts the same."""
    rng = np.random.RandomState(3)
    x = rng.randn(40, 6).astype(np.float32)
    y = x.dot(rng.randn(6, 3)).argmax(1).astype(np.float32)
    args = {"fc1_weight": rng.randn(16, 6) * 0.3, "fc1_bias": np.zeros(16),
            "fc2_weight": rng.randn(3, 16) * 0.3, "fc2_bias": np.zeros(3)}
    res = []
    for pkg in (jmx, tmx):
        with fresh_names(pkg):
            net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
                pkg.sym.Activation(pkg.sym.FullyConnected(
                    pkg.sym.Variable("data"), num_hidden=16, name="fc1"),
                    act_type="relu"), num_hidden=3, name="fc2"),
                name="softmax")
        kwargs = {"fused_step": fused} if pkg is tmx else {}
        np.random.seed(11)
        model = pkg.model.FeedForward.create(
            net, x, y, ctx=pkg.cpu(), num_epoch=2, numpy_batch_size=8,
            learning_rate=0.1, momentum=0.9,
            arg_params={k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
                        for k, v in args.items()}, **kwargs)
        probs = model.predict(x[:13])
        score = model.score(x, y)
        res.append((model, probs, score))
    (jm, jp, js), (tm, tp, ts) = res
    assert tm._module._fused_step_active == fused
    for k in jm.arg_params:
        np.testing.assert_allclose(tm.arg_params[k].asnumpy(),
                                   jm.arg_params[k].asnumpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    assert tp.shape == jp.shape == (13, 3)
    np.testing.assert_allclose(tp, jp, rtol=1e-3, atol=1e-5)
    assert ts == js
    tm.save(str(tmp_path / "ff"))
    back = tmx.model.FeedForward.load(str(tmp_path / "ff"), 2,
                                      ctx=tmx.cpu(), numpy_batch_size=8)
    np.testing.assert_array_equal(back.predict(x[:13]), tp)
