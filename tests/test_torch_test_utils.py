"""The port's ``test_utils`` against the JAX package's on the CPU: the
distance helpers on the same arrays, finite differences on the same
graph (within 1e-3 of each other), and each check passing where it
should and raising where it should."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.test_utils as jtu
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import test_utils as ttu

CPU = tmx.cpu()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_distance_helpers_match_jax():
    a, b = _x(3, 4), _x(3, 4, seed=1)
    assert ttu.reldiff(a, b) == pytest.approx(jtu.reldiff(a, b), rel=1e-12)
    assert ttu.reldiff(a, a) == 0.0
    assert ttu.same(a, a.copy()) and not ttu.same(a, b)
    assert ttu.assert_almost_equal(a, a + 1e-7) <= 1e-5
    with pytest.raises(AssertionError, match="reldiff"):
        ttu.assert_almost_equal(a, b, name="ab")
    np.random.seed(0)
    x, y = ttu.random_arrays((2, 3), (4,))
    assert x.shape == (2, 3) and y.shape == (4,) and x.dtype == np.float32
    assert ttu.rand_ndarray((2, 2), ctx=CPU).context == CPU


def test_default_context_is_the_card_unless_a_cpu_scope_is_open():
    assert ttu.default_context() == tmx.gpu(0)
    with tmx.cpu():
        assert ttu.default_context() == tmx.cpu()


def test_numeric_grad_matches_jax():
    x = _x(3, 4)
    got = {}
    for pkg, tu in ((tmx, ttu), (jmx, jtu)):
        net = pkg.sym.Activation(pkg.sym.Variable("data"), act_type="tanh")
        ex = net.simple_bind(pkg.cpu(), data=x.shape)
        got[pkg] = tu.numeric_grad(ex, {"data": x}, eps=1e-3)["data"]
    np.testing.assert_allclose(got[tmx], got[jmx], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[tmx], 1 - np.tanh(x) ** 2, atol=1e-3)


@pytest.mark.parametrize("case", ["tanh", "l2norm", "flatten", "deconv",
                                  "crop_assign", "leaky", "rnn"])
def test_check_numeric_gradient_passes_on_true_gradients(case):
    rng = np.random.RandomState(13)
    data = tmx.sym.Variable("data")
    if case == "tanh":
        sym, loc = tmx.sym.Activation(data, act_type="tanh"), \
            {"data": rng.randn(3, 4)}
    elif case == "l2norm":
        sym, loc = tmx.sym.L2Normalization(data), {"data": rng.randn(3, 4)}
    elif case == "flatten":
        sym, loc = tmx.sym.Flatten(data) * 2.0, {"data": rng.randn(3, 4)}
    elif case == "deconv":
        sym = tmx.sym.Deconvolution(data, kernel=(3, 3), num_filter=2,
                                    no_bias=True, name="deconv")
        loc = {"data": rng.randn(1, 2, 3, 3),
               "deconv_weight": rng.randn(2, 2, 3, 3) * 0.3}
    elif case == "crop_assign":
        sym = tmx.sym._crop_assign(tmx.sym.Variable("lhs"),
                                   tmx.sym.Variable("rhs"), begin=(1,),
                                   end=(3,))
        loc = {"lhs": rng.rand(4), "rhs": rng.rand(2)}
    elif case == "leaky":
        sym = tmx.sym.LeakyReLU(data, act_type="elu", slope=0.4)
        loc = {"data": rng.randn(3, 4) + 0.05}
    else:
        sym = tmx.sym.RNN(data, tmx.sym.Variable("p"), tmx.sym.Variable("s"),
                          state_size=2, num_layers=1, mode="gru")
        loc = {"data": rng.randn(3, 1, 2), "p": rng.randn(36) * 0.5,
               "s": rng.randn(1, 1, 2)}
    loc = {k: v.astype(np.float32) for k, v in loc.items()}
    ttu.check_numeric_gradient(sym, loc, numeric_eps=1e-2, check_eps=0.05,
                               ctx=CPU)


def test_check_numeric_gradient_catches_a_gradient_that_is_not_true():
    """MakeLoss's gradient is grad_scale, not the identity's head
    gradient of sum(outputs): the finite differences see 1, autograd
    0.3."""
    sym = tmx.sym.MakeLoss(tmx.sym.Variable("data"), grad_scale=0.3)
    with pytest.raises(AssertionError, match="numeric gradient"):
        ttu.check_numeric_gradient(sym, {"data": _x(2, 3)}, ctx=CPU)


def test_symbolic_forward_and_backward_checks():
    x = np.array([-2.0, -0.5, 0.5, 2.0], np.float32)
    s = tmx.sym.smooth_l1(tmx.sym.Variable("data"), scalar=1.0)
    want = np.where(np.abs(x) < 1, 0.5 * x ** 2, np.abs(x) - 0.5)
    outs = ttu.check_symbolic_forward(s, {"data": x}, [want], ctx=CPU)
    np.testing.assert_allclose(outs[0], want, rtol=1e-6)
    with pytest.raises(AssertionError):
        ttu.check_symbolic_forward(s, {"data": x}, [want + 1], ctx=CPU)
    g = np.ones(4, np.float32) * 2
    grads = ttu.check_symbolic_backward(
        s, {"data": x}, [g], {"data": 2 * np.clip(x, -1, 1)}, ctx=CPU)
    np.testing.assert_allclose(grads["data"], [-2.0, -1.0, 1.0, 2.0])
    lro = tmx.sym.LinearRegressionOutput(tmx.sym.Variable("data"),
                                         name="lro")
    d = np.array([[1.0], [2.0]], np.float32)
    lab = np.array([[1.5], [1.0]], np.float32)
    ttu.check_symbolic_backward(
        lro, [d, lab], [np.ones((2, 1), np.float32)], [d - lab, None],
        grad_req={"data": "write", "lro_label": "null"}, ctx=CPU)


def test_check_consistency_across_dtypes_and_against_jax():
    """One deconvolution + FC graph bound in float32 and float64 on the
    CPU: every output and gradient within the float32 tolerance of each
    other, and the float32 results equal to the JAX package's
    check_consistency's first config. (A 2-D Convolution's backward is
    the float32/bfloat16 GEMM kernel's, so it takes no float64.)"""
    def net(pkg):
        with pkg.name.NameManager():
            d = pkg.sym.Variable("data")
            c = pkg.sym.Deconvolution(d, kernel=(3, 3), num_filter=4,
                                      pad=(1, 1), name="conv")
            return pkg.sym.FullyConnected(pkg.sym.Flatten(c), num_hidden=3,
                                          name="fc")

    res = ttu.check_consistency(net(tmx), [
        {"ctx": CPU, "data": (2, 2, 5, 5)},
        {"ctx": CPU, "data": (2, 2, 5, 5),
         "type_dict": {"data": np.float64}}])
    assert len(res) == 2 and res[1][2] == 1e-5
    jres = jtu.check_consistency(net(jmx), [
        {"ctx": jmx.cpu(), "data": (2, 2, 5, 5)},
        {"ctx": jmx.cpu(), "data": (2, 2, 5, 5)}])
    np.testing.assert_allclose(res[0][0][0], jres[0][0][0], rtol=1e-5,
                               atol=1e-5)
    for name, g in jres[0][1].items():
        np.testing.assert_allclose(res[0][1][name], g, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_check_speed():
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4)
    loc = {"data": _x(8, 5), "fullyconnected0_weight": _x(4, 5),
           "fullyconnected0_bias": _x(4)}
    s = tmx.sym.load_json(s.tojson())
    names = s.list_arguments()
    loc = dict(zip(names, loc.values()))
    for typ in ("whole", "forward"):
        assert ttu.check_speed(s, loc, ctx=CPU, N=3, typ=typ) > 0
    with pytest.raises(tmx.MXNetError, match="typ"):
        ttu.check_speed(s, loc, ctx=CPU, N=1, typ="bogus")
    with pytest.raises(tmx.MXNetError, match="location"):
        ttu.check_speed(s, None, ctx=CPU)
