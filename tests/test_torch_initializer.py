"""The port's initializers (mxnet_tpu_torch/initializer.py) against the
JAX package's.

Dispatch by name (a fault the port had: ``upsampling*`` drew from the
distribution, and ``*parameters``, ``*state``, ``*state_cell``,
``*init_h`` and ``*init_c`` raised): every name pattern through both
packages, deterministic values (the bilinear kernel, zeros, ones,
constants, Orthogonal from one numpy seed, Load) compared exactly and
the error's type and message compared where both raise. Random draws
come from different generators (threefry in the JAX package), so they
are held by their moments: over 200k draws the mean within 5 standard
errors of the JAX package's and the standard deviation within 2%."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

DETERMINISTIC = [
    ("upsampling0_weight", (2, 3, 4, 4)), ("upsampling_up_weight", (1, 1, 5, 5)),
    ("h_init_h", (2, 8)), ("h_init_c", (2, 8)), ("h_state", (2, 8)),
    ("h_state_cell", (2, 8)), ("fc_bias", (7,)), ("bn_gamma", (7,)),
    ("bn_beta", (7,)), ("bn_moving_mean", (7,)), ("bn_moving_var", (7,)),
    ("bn_moving_avg", (7,)), ("foo_unknown", (3, 2))]


def _inits(pkg):
    return {"xavier": pkg.init.Xavier(), "uniform": pkg.init.Uniform(),
            "normal": pkg.init.Normal(), "zero": pkg.init.Zero(),
            "one": pkg.init.One(), "constant": pkg.init.Constant(0.25),
            "msraprelu": pkg.init.MSRAPrelu()}


def _apply(pkg, init, name, shape):
    arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
    try:
        init(name, arr)
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return arr.asnumpy()


@pytest.mark.parametrize("init", sorted(_inits(tmx)))
@pytest.mark.parametrize("name,shape", DETERMINISTIC,
                         ids=[n for n, _ in DETERMINISTIC])
def test_name_dispatch_matches_jax(name, shape, init):
    mine = _apply(tmx, _inits(tmx)[init], name, shape)
    theirs = _apply(jmx, _inits(jmx)[init], name, shape)
    if isinstance(theirs, tuple):
        assert mine == theirs
        assert theirs[0] == "MXNetError"
    else:
        assert np.array_equal(mine, theirs)


def _moments_close(mine, theirs):
    n = mine.size
    se = max(mine.std(), theirs.std()) / np.sqrt(n)
    assert abs(mine.mean() - theirs.mean()) < 5 * se
    np.testing.assert_allclose(mine.std(), theirs.std(), rtol=0.02)


@pytest.mark.parametrize("name", ["fc_weight", "lstm_parameters"])
@pytest.mark.parametrize("init", ["xavier", "uniform", "normal",
                                  "msraprelu", "xavier_gaussian_in"])
def test_random_draws_match_jax_by_moments(init, name):
    shape = (400, 500) if name == "fc_weight" else (200_000,)
    jmx.random.seed(0)
    tmx.random.seed(0)
    make = {"xavier_gaussian_in": lambda pkg: pkg.init.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2.0)}.get(
        init, lambda pkg: _inits(pkg)[init])
    mine = _apply(tmx, make(tmx), name, shape)
    theirs = _apply(jmx, make(jmx), name, shape)
    _moments_close(mine, theirs)


def test_orthogonal_matches_jax_from_one_numpy_seed():
    for shape in ((6, 4), (4, 6), (3, 2, 2)):
        got = []
        for pkg in (tmx, jmx):
            np.random.seed(7)
            got.append(_apply(pkg, pkg.init.Orthogonal(), "w_weight", shape))
        assert np.array_equal(got[0], got[1])
    q = got[0].reshape(3, 4)
    np.testing.assert_allclose(q @ q.T, 1.414 ** 2 * np.eye(3), atol=1e-5)


def test_load_and_mixed_match_jax(tmp_path):
    with tmx.cpu():   # Load reads the file onto the current context
        _load_and_mixed(tmp_path)


def _load_and_mixed(tmp_path):
    rng = np.random.RandomState(1)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_var": rng.rand(4).astype(np.float32)}
    path = str(tmp_path / "p.params")
    tmx.nd.save(path, {k: tmx.nd.array(v, ctx=tmx.cpu())
                       for k, v in saved.items()})
    cases = [("fc_weight", (3, 4)), ("bn_moving_var", (4,)),
             ("fc_bias", (3,)), ("other_weight", (2, 2))]
    for name, shape in cases:
        mine = _apply(tmx, tmx.init.Load(path, tmx.init.Constant(0.5)),
                      name, shape)
        theirs = _apply(jmx, jmx.init.Load(path, jmx.init.Constant(0.5)),
                        name, shape)
        assert np.array_equal(mine, theirs), name
    for pkg in (tmx, jmx):
        assert _apply(pkg, pkg.init.Load(path), "fc_weight", (4, 3))[0] \
            == "MXNetError"
        assert _apply(pkg, pkg.init.Load(path), "nope", (1,))[0] \
            == "MXNetError"
    for name in ("fc_weight", "fc_bias", "zz"):
        got = [_apply(pkg, pkg.init.Mixed(["fc_.*", ".*"],
                                          [pkg.init.One(), pkg.init.Zero()]),
                      name, (2, 3)) for pkg in (tmx, jmx)]
        assert np.array_equal(got[0], got[1]), name
    for pkg in (tmx, jmx):
        assert _apply(pkg, pkg.init.Mixed(["fc_.*"], [pkg.init.One()]),
                      "zz", (1,))[0] == "MXNetError"


def test_registry_names_and_defaults_match_jax():
    from mxnet_tpu.base import Registry as JReg
    from mxnet_tpu_torch.base import Registry as TReg

    mine = {k for k, _ in TReg.get_registry("initializer").items()}
    theirs = {k for k, _ in JReg.get_registry("initializer").items()}
    assert mine == theirs == {"uniform", "normal", "xavier", "msraprelu",
                              "orthogonal", "zero", "one"}
    for name, attrs in (("Uniform", ["scale"]), ("Normal", ["sigma"]),
                        ("Xavier", ["rnd_type", "factor_type", "magnitude"]),
                        ("MSRAPrelu", ["rnd_type", "factor_type",
                                       "magnitude"]),
                        ("Orthogonal", ["scale", "rand_type"])):
        a, b = getattr(tmx.init, name)(), getattr(jmx.init, name)()
        for attr in attrs:
            assert getattr(a, attr) == getattr(b, attr), (name, attr)


def test_the_stream_and_an_explicit_seed():
    """Without seed= the draws come from mx.random's stream (the same
    state gives the same weights); with seed= from the initializer's own
    generator, the same on every call of a fresh initializer."""
    def draw(init):
        return _apply(tmx, init, "fc_weight", (5, 6))

    tmx.random.seed(4)
    a = draw(tmx.init.Xavier())
    b = draw(tmx.init.Xavier())
    tmx.random.seed(4)
    assert np.array_equal(draw(tmx.init.Xavier()), a)
    assert not np.array_equal(a, b)
    assert np.array_equal(draw(tmx.init.Xavier(seed=3)),
                          draw(tmx.init.Xavier(seed=3)))
