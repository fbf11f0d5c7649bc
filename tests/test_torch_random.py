"""mx.random in the port (mxnet_tpu_torch/random.py): the stream's
state has the JAX package's ``(seed, draws)`` meaning, set_state replays
the draws after it, and the draws follow their distributions. The
numbers differ from the JAX package's threefry draws, so they are held
against it by the state's meaning and by moments (mean within 5
standard errors, standard deviation within 2%, over 200k draws)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

N = 200_000


def _draw(kind, pkg=tmx, **kw):
    fn = {"uniform": lambda: pkg.random.uniform(-1.0, 3.0, shape=(N,),
                                                 ctx=pkg.cpu(), **kw),
          "normal": lambda: pkg.random.normal(2.0, 0.5, shape=(N,),
                                               ctx=pkg.cpu(), **kw),
          "randint": lambda: pkg.random.randint(-3, 9, shape=(N,),
                                                ctx=pkg.cpu())}[kind]
    return fn().asnumpy()


@pytest.mark.parametrize("kind", ["uniform", "normal", "randint"])
def test_state_has_the_jax_meaning(kind):
    for pkg in (tmx, jmx):
        pkg.random.seed(5)
        assert pkg.random.get_state() == (5, 0)
        _draw(kind, pkg)
        _draw(kind, pkg)
        assert pkg.random.get_state() == (5, 2)


@pytest.mark.parametrize("kind", ["uniform", "normal", "randint"])
def test_set_state_replays_the_draws(kind):
    tmx.random.seed(5)
    _draw(kind)
    state = tmx.random.get_state()
    a, b = _draw(kind), _draw(kind)
    assert not np.array_equal(a, b)
    tmx.random.set_state(state)
    assert np.array_equal(_draw(kind), a)
    assert np.array_equal(_draw(kind), b)
    tmx.random.seed(6)
    assert not np.array_equal(_draw(kind), a)


@pytest.mark.parametrize("kind", ["uniform", "normal", "randint"])
def test_moments_match_jax(kind):
    tmx.random.seed(0)
    jmx.random.seed(0)
    mine, theirs = _draw(kind).astype(np.float64), \
        _draw(kind, jmx).astype(np.float64)
    se = theirs.std() / np.sqrt(N)
    assert abs(mine.mean() - theirs.mean()) < 5 * se
    np.testing.assert_allclose(mine.std(), theirs.std(), rtol=0.02)
    assert mine.min() >= theirs.min() and mine.max() <= theirs.max() \
        or kind == "normal"
    if kind == "randint":
        assert set(np.unique(mine)) == set(range(-3, 9))


def test_out_shape_dtype_and_context():
    tmx.random.seed(1)
    out = tmx.nd.zeros((3, 4), ctx=tmx.cpu())
    h = out.handle
    res = tmx.random.uniform(0.0, 1.0, out=out)
    assert res is out and out.handle is h
    assert (out.asnumpy() > 0).all()
    tmx.random.normal(0.0, 1.0, out=out)
    assert out.shape == (3, 4)
    with tmx.cpu():
        assert tmx.random.uniform().shape == (1,)
        assert tmx.random.normal(shape=5).shape == (5,)
        assert tmx.random.randint(0, 2, shape=(2, 2)).dtype == np.int32
    assert tmx.random.gaussian is tmx.random.normal


def test_executor_and_initializer_draw_from_the_stream():
    """An executor bound without a seed takes its Dropout seed from the
    stream at its first train forward (as the JAX package's takes its
    key), so the same stream state gives the same masks."""
    net = tmx.sym.Dropout(tmx.sym.Variable("data"), p=0.5)
    x = tmx.nd.array(np.ones((16, 16), np.float32), ctx=tmx.cpu())

    def masks():
        ex = net.bind(tmx.cpu(), {"data": x})
        ex.forward(is_train=True)
        return ex.outputs[0].asnumpy()

    tmx.random.seed(2)
    a = masks()
    b = masks()
    tmx.random.seed(2)
    assert np.array_equal(masks(), a)
    assert not np.array_equal(a, b)
    assert tmx.random.get_state() == (2, 1)
