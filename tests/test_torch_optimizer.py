"""The port's optimizers (mxnet_tpu_torch/optimizer.py) against the JAX
package's on the CPU: every kind for 1 and 3 steps through ``update``
(one parameter at a time) and ``update_multi`` (the multi-tensor plan),
with rescale_grad, weight decay, mixed lr/wd multipliers, a factor
schedule and ``begin_num_update``, and gradient clipping in the 3-step
cases; the same seeded numpy weights and gradients go to both packages.

Bound: weights and every state tensor within rtol 1e-5 / atol 1e-7 of
the JAX package's (both packages round each elementwise product in
float32, but XLA may contract a multiply and an add into one fused
operation, which rounds once). Inside the port, ``update`` and
``update_multi`` run the same kernels and agree bit for bit. SGLD's
noise is held by distribution and by replay; the pickled states cross
the packages in both directions."""
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-7
NAMES = ["fc_weight", "fc_bias", "conv_weight"]
SHAPES = [(4, 5), (5,), (2, 3, 3)]

KINDS = [("sgd", {"momentum": 0.9}), ("sgd", {}), ("ccsgd", {"momentum": 0.9}),
         ("nag", {"momentum": 0.9}), ("nag", {}),
         ("adam", {"learning_rate": 0.01}), ("adagrad", {"learning_rate": 0.1}),
         ("rmsprop", {}), ("adadelta", {})]
KIND_IDS = ["sgd", "sgd_nomom", "ccsgd", "nag", "nag_nomom", "adam",
            "adagrad", "rmsprop", "adadelta"]


def _optimizer(pkg, kind, kw, clip, begin=3):
    opt = pkg.optimizer.create(
        kind, rescale_grad=0.5, wd=1e-3, clip_gradient=clip,
        lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        param_idx2name=dict(enumerate(NAMES)), begin_num_update=begin,
        **kw)
    opt.set_lr_mult({"fc_bias": 2.0})
    opt.set_wd_mult({"conv_weight": 0.5})
    return opt


def _arrays(pkg, seed):
    rng = np.random.RandomState(seed)
    return [pkg.nd.array(rng.randn(*s).astype(np.float32), ctx=pkg.cpu())
            for s in SHAPES]


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _states_np(states):
    """The updater's states by index as flat lists of numpy arrays."""
    out = {}
    for i, s in states.items():
        parts = () if s is None else (s if isinstance(s, tuple) else (s,))
        out[i] = [p.asnumpy() for p in parts]
    return out


def _run(pkg, kind, kw, clip, steps, path, order=None):
    """``steps`` updates of the three params; returns (weights, states)
    as numpy. ``order`` (a list of index lists, one a step) picks which
    params each step updates."""
    opt = _optimizer(pkg, kind, kw, clip)
    upd = pkg.optimizer.get_updater(opt)
    ws = _arrays(pkg, 0)
    for step in range(steps):
        gs = [pkg.nd.array(g, ctx=pkg.cpu()) for g in _grads(step)]
        idx = order[step] if order else range(len(ws))
        if path == "update_multi":
            upd.update_multi([(i, gs[i], ws[i]) for i in idx])
        else:
            for i in idx:
                upd(i, gs[i], ws[i])
    return [w.asnumpy() for w in ws], _states_np(upd.states)


def _assert_close(got, want):
    gw, gs = got
    ww, ws = want
    for a, b in zip(gw, ww):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert sorted(gs) == sorted(ws)
    for i in ws:
        assert len(gs[i]) == len(ws[i]), i
        for a, b in zip(gs[i], ws[i]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["update", "update_multi"])
@pytest.mark.parametrize("steps,clip", [(1, None), (3, 0.5)],
                         ids=["1step", "3steps_clip"])
@pytest.mark.parametrize("kind,kw", KINDS, ids=KIND_IDS)
def test_kind_matches_jax(kind, kw, steps, clip, path):
    _assert_close(_run(tmx, kind, kw, clip, steps, path),
                  _run(jmx, kind, kw, clip, steps, path))


@pytest.mark.parametrize("kind,kw", KINDS, ids=KIND_IDS)
def test_update_and_update_multi_agree_bit_for_bit(kind, kw):
    a = _run(tmx, kind, kw, 0.5, 3, "update")
    b = _run(tmx, kind, kw, 0.5, 3, "update_multi")
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    for i in a[1]:
        for x, y in zip(a[1][i], b[1][i]):
            assert np.array_equal(x, y)


def test_adam_groups_by_update_count():
    """An index updated once more than the others gets its own bias
    correction: the plan's groups split by count, and the result matches
    the JAX package's per-parameter plan."""
    order = [[0], [0, 1, 2], [0, 1, 2]]
    kw = {"learning_rate": 0.01}
    got = _run(tmx, "adam", kw, None, 3, "update_multi", order)
    _assert_close(got, _run(jmx, "adam", kw, None, 3, "update_multi", order))
    opt = _optimizer(tmx, "adam", kw, None)
    opt._update_count(0)
    groups = opt.structure([0, 1, 2])[0]
    assert sorted(groups) == [(0,), (1,), (2,)]   # counts 4/3/3, mults 2/1/1


@pytest.mark.parametrize("kind,attr", [("adam", "epsilon"),
                                       ("adagrad", "float_stable_eps"),
                                       ("adadelta", "epsilon")])
def test_epsilon_is_a_constant_of_the_structure(kind, attr):
    """The epsilon is added as a Python number (a device scalar would
    make torch._foreach_add synchronise inside a graph capture), so it
    is part of the structure: a new value makes the fused step capture
    again instead of replaying a stale one."""
    opt = tmx.optimizer.create(kind)
    before = opt.structure([0, 1])
    assert before[3] == float(np.float32(getattr(opt, attr)))
    setattr(opt, attr, 1e-3)
    assert opt.structure([0, 1]) != before
    assert len(tmx.optimizer.create("rmsprop").structure([0])) == 3


def test_sequential_path_under_fused_update_off(monkeypatch):
    """MXNET_TPU_FUSED_UPDATE=0: update_multi updates one parameter at a
    time, with the same result."""
    want = _run(tmx, "adam", {}, 0.5, 3, "update_multi")
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    got = _run(tmx, "adam", {}, 0.5, 3, "update_multi")
    for x, y in zip(got[0], want[0]):
        assert np.array_equal(x, y)


def _custom_classes(pkg):
    class OwnUpdate(pkg.optimizer.SGD):
        def update(self, index, weight, grad, state):
            super().update(index, weight, grad, state)

    class OwnPlan(OwnUpdate):
        def _plan(self, index, weight, grad, state):
            return super()._plan(index, weight, grad, state)

    class OwnMulti(pkg.optimizer.SGD):
        def update_multi(self, items):
            super().update_multi(items)

    return OwnUpdate, OwnPlan, OwnMulti


def test_fusable_contract_matches_jax():
    """A plan describes the update unless a subclass overrides update
    below the class that defines _plan; SGLD and Test have no plan."""
    for pkg in (jmx, tmx):
        own_update, own_plan, _ = _custom_classes(pkg)
        got = {name: pkg.optimizer.create(name)._fusable()
               for name in ("sgd", "ccsgd", "nag", "adam", "adagrad",
                            "rmsprop", "adadelta", "sgld", "test")}
        assert got == {"sgd": True, "ccsgd": True, "nag": True, "adam": True,
                       "adagrad": True, "rmsprop": True, "adadelta": True,
                       "sgld": False, "test": False}, pkg
        assert not own_update()._fusable()
        assert own_plan()._fusable()
    # the port's fused step runs the plan in place of update_multi too
    assert not _custom_classes(tmx)[2]()._fusable()
    assert _custom_classes(jmx)[2]()._fusable()


def test_custom_update_runs_sequentially():
    """A subclass with its own update goes through it, once a param."""
    calls = []

    class Counting(tmx.optimizer.SGD):
        def update(self, index, weight, grad, state):
            calls.append(index)
            super().update(index, weight, grad, state)

    upd = tmx.optimizer.get_updater(Counting(learning_rate=0.1))
    ws = _arrays(tmx, 0)
    gs = [tmx.nd.array(g, ctx=tmx.cpu()) for g in _grads(0)]
    upd.update_multi([(i, gs[i], ws[i]) for i in range(3)])
    assert calls == [0, 1, 2]
    np.testing.assert_allclose(ws[1].asnumpy(), _arrays(tmx, 0)[1].asnumpy()
                               - np.float32(0.1) * _grads(0)[1], rtol=1e-6)


def test_test_optimizer_matches_jax():
    got = _run(tmx, "test", {}, None, 3, "update")
    want = _run(jmx, "test", {}, None, 3, "update")
    _assert_close(got, want)


def test_register_and_create():
    @tmx.optimizer.register
    class Halving(tmx.optimizer.SGD):
        pass

    assert isinstance(tmx.optimizer.create("halving"), Halving)
    with pytest.raises(tmx.MXNetError, match="already registered"):
        tmx.optimizer.register("sgd")(Halving)
    assert tmx.optimizer.register("sgd", override=True)(Halving) is Halving
    tmx.optimizer.register("sgd", override=True)(tmx.optimizer.SGD)
    assert tmx.optimizer.create("sgd").__class__ is tmx.optimizer.SGD


@pytest.mark.parametrize("name,defaults", [
    ("sgd", {"momentum": 0.0, "lr": 0.01}),
    ("adam", {"lr": 0.001, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adagrad", {"lr": 0.01, "float_stable_eps": 1e-7}),
    ("rmsprop", {"lr": 0.002, "gamma1": 0.95, "gamma2": 0.9}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5})])
def test_constructor_defaults_match_jax(name, defaults):
    mine, theirs = tmx.optimizer.create(name), jmx.optimizer.create(name)
    for k, v in defaults.items():
        assert getattr(mine, k) == getattr(theirs, k) == v, k


def _sgld_step(lr):
    tmx.random.seed(11)
    opt = tmx.optimizer.create("sgld", learning_rate=lr)
    rng = np.random.RandomState(5)
    w0 = rng.randn(200_000).astype(np.float32)
    g = rng.randn(200_000).astype(np.float32)
    w = tmx.nd.array(w0, ctx=tmx.cpu())
    tmx.optimizer.get_updater(opt)(0, tmx.nd.array(g, ctx=tmx.cpu()), w)
    return w0, g, w.asnumpy()


def test_sgld_noise_is_standard_normal_and_replays():
    """(w1 - w0 + lr/2 g) / sqrt(lr) is a standard normal draw: |mean| <
    0.01 and std within 1% of 1 over 200k elements (6 and 4.5 standard
    errors); the same seed gives the same step, bit for bit."""
    lr = 0.01
    w0, g, w1 = _sgld_step(lr)
    z = (w1.astype(np.float64) - w0 + lr / 2 * g) / np.sqrt(lr)
    assert abs(z.mean()) < 0.01
    assert abs(z.std() - 1) < 0.01
    assert np.array_equal(_sgld_step(lr)[2], w1)
    assert not tmx.optimizer.create("sgld")._fusable()


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind,kw", [("adam", {}), ("rmsprop", {}),
                                     ("sgd", {"momentum": 0.9}), ("sgd", {})],
                         ids=["adam", "rmsprop", "sgd", "sgd_nomom"])
def test_tuple_states_cross_the_packages(writer, reader, kind, kw):
    """Updater.get_states of one package loads into the other's updater
    (tuples of arrays for Adam and RMSProp), and both go on to the same
    next step."""
    src = writer.optimizer.get_updater(
        _optimizer(writer, kind, kw, None, begin=0))
    ws = _arrays(writer, 0)
    for step in range(2):
        gs = [writer.nd.array(g, ctx=writer.cpu()) for g in _grads(step)]
        src.update_multi([(i, gs[i], ws[i]) for i in range(3)])
    blob = src.get_states()
    raw = pickle.loads(blob)
    if kind in ("adam", "rmsprop"):
        assert all(isinstance(v, tuple) for v in raw.values())
    dst = reader.optimizer.get_updater(
        _optimizer(reader, kind, kw, None, begin=2))
    # a copy: on the CPU the port's asnumpy shares the tensor's memory,
    # which the writer's next update writes in place
    wr = [reader.nd.array(w.asnumpy().copy(), ctx=reader.cpu()) for w in ws]
    if reader is tmx:
        for i, w in enumerate(wr):
            dst._state(i, w)   # states that exist are written in place
        before = {i: [t.data_ptr() for t in
                      tmx.optimizer._state_tensors(s)]
                  for i, s in dst.states.items()}
    dst.set_states(blob)
    assert _states_np(dst.states).keys() == _states_np(src.states).keys()
    for i, parts in _states_np(src.states).items():
        for a, b in zip(_states_np(dst.states)[i], parts):
            assert np.array_equal(a, b)
    if reader is tmx:
        assert {i: [t.data_ptr() for t in tmx.optimizer._state_tensors(s)]
                for i, s in dst.states.items()} == before
    gs = _grads(2)
    src.update_multi([(i, writer.nd.array(gs[i], ctx=writer.cpu()), ws[i])
                      for i in range(3)])
    dst.update_multi([(i, reader.nd.array(gs[i], ctx=reader.cpu()), wr[i])
                      for i in range(3)])
    for a, b in zip(wr, ws):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def test_set_states_checks_the_form():
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("adam"))
    w = tmx.nd.array(np.ones((2, 2), np.float32), ctx=tmx.cpu())
    upd._state(0, w)
    with pytest.raises(tmx.MXNetError, match="a tuple of 2"):
        upd.set_states(pickle.dumps({0: np.zeros((2, 2), np.float32)}))
    with pytest.raises(tmx.MXNetError, match="saved shape"):
        upd.set_states(pickle.dumps({0: (np.zeros((2, 2), np.float32),
                                         np.zeros(3, np.float32))}))
