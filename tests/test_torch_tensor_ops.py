"""Parity of the port's tensor and nn operators with the JAX package's
(CPU, small seeded inputs): each case builds one graph in both
packages, runs a train-mode forward and a backward with the same seeded
head gradients, and holds the port's outputs (rtol 1e-5 / atol 1e-6),
gradients (rtol 1e-4 / atol 1e-6) and aux states to the JAX package's.
The cases are those of tests/test_operator.py and
tests/test_operator_extra.py for these ops, plus every parameter form
the ops take. dot, batch_dot and Deconvolution sum in another order
than XLA: their forward bound is rtol 1e-5 / atol 1e-5, stated per
case."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_common import assert_parity, both_fwd_bwd


def _x(*shape, seed=0, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _one(op, **params):
    """A one-input op over Variable "data"."""
    return lambda pkg: getattr(pkg.sym, op)(pkg.sym.Variable("data"),
                                            name="op", **params)


def _two(op, **params):
    return lambda pkg: getattr(pkg.sym, op)(
        pkg.sym.Variable("lhs"), pkg.sym.Variable("rhs"), name="op",
        **params)


def _block_grad(pkg):
    data = pkg.sym.Variable("data")
    return pkg.sym.BlockGrad(data, name="op") * 2 + data


X = _x(2, 3, 4)
X_POS = _x(2, 3, 4, lo=0.5, hi=2.0)
X_SPREAD = _x(3, 5, seed=1, lo=-2.5, hi=2.5) + np.float32(0.3)

# name: (build, args, extra kwargs for assert_parity)
CASES = {
    # elementwise unary
    "exp": (_one("exp"), {"data": X}, {}),
    "log": (_one("log"), {"data": X_POS}, {}),
    "sqrt": (_one("sqrt"), {"data": X_POS}, {}),
    "rsqrt": (_one("rsqrt"), {"data": X_POS}, {}),
    "square": (_one("square"), {"data": X}, {}),
    "abs": (_one("abs"), {"data": X}, {}),
    "sign": (_one("sign"), {"data": X}, {}),
    "round": (_one("round"), {"data": X_SPREAD}, {}),
    "ceil": (_one("ceil"), {"data": X_SPREAD}, {}),
    "floor": (_one("floor"), {"data": X_SPREAD}, {}),
    "cos": (_one("cos"), {"data": X}, {}),
    "sin": (_one("sin"), {"data": X}, {}),
    "negative": (_one("negative"), {"data": X}, {}),
    "clip": (_one("clip", a_min=-0.5, a_max=0.7), {"data": X}, {}),
    "argmax_channel": (_one("argmax_channel"), {"data": X}, {}),
    "smooth_l1": (_one("smooth_l1", scalar=1.0),
                  {"data": np.array([-2.0, -0.5, 0.5, 2.0], np.float32)},
                  {}),
    "smooth_l1_s2": (_one("smooth_l1", scalar=2.0), {"data": X}, {}),
    # broadcast binary
    "broadcast_plus": (_two("broadcast_plus"),
                       {"lhs": _x(2, 1, 4), "rhs": _x(1, 3, 4, seed=1)}, {}),
    "broadcast_minus": (_two("broadcast_minus"),
                        {"lhs": _x(2, 3, 1), "rhs": _x(2, 1, 4, seed=1)}, {}),
    "broadcast_mul": (_two("broadcast_mul"),
                      {"lhs": _x(2, 3, 4), "rhs": _x(1, 3, 1, seed=1)}, {}),
    "broadcast_div": (_two("broadcast_div"),
                      {"lhs": _x(2, 3, 4), "rhs": _x(2, 1, 1, seed=1,
                                                     lo=0.5, hi=2.0)}, {}),
    "broadcast_power": (_two("broadcast_power"),
                        {"lhs": _x(2, 3, 1, lo=0.5, hi=2.0),
                         "rhs": _x(1, 3, 4, seed=1)}, {}),
    "broadcast_axis": (_one("broadcast_axis", axis=(0, 2), size=(3, 4)),
                       {"data": _x(1, 3, 1)}, {}),
    # structural
    "Reshape_shape": (_one("Reshape", shape=(0, -1)), {"data": X}, {}),
    "Reshape_reverse": (_one("Reshape", shape=(0, 0, -1), reverse=True),
                        {"data": _x(2, 3, 5, 5)}, {}),
    "Reshape_target_shape": (_one("Reshape", target_shape=(2, 0)),
                             {"data": X}, {}),
    "Cast": (_one("Cast", dtype="float64"), {"data": X}, {}),
    "transpose": (_one("transpose"), {"data": X}, {}),
    "transpose_axes": (_one("transpose", axes=(1, 0, 2)), {"data": X}, {}),
    "SwapAxis": (_one("SwapAxis", dim1=0, dim2=2), {"data": X}, {}),
    "expand_dims": (_one("expand_dims", axis=1), {"data": X}, {}),
    "expand_dims_neg": (_one("expand_dims", axis=-1), {"data": X}, {}),
    "SliceChannel": (_one("SliceChannel", num_outputs=3), {"data": X}, {}),
    "SliceChannel_squeeze": (_one("SliceChannel", num_outputs=4, axis=2,
                                  squeeze_axis=True), {"data": X}, {}),
    "Crop_h_w": (_one("Crop", h_w=(2, 3), offset=(1, 1)),
                 {"data": _x(2, 3, 5, 5)}, {}),
    "Crop_center": (_one("Crop", h_w=(2, 3), center_crop=True),
                    {"data": _x(2, 3, 5, 6)}, {}),
    "Crop_like": (lambda pkg: pkg.sym.Crop(
        pkg.sym.Variable("data"), pkg.sym.Variable("like"), num_args=2,
        offset=(1, 2), name="op"),
        {"data": _x(2, 3, 6, 6), "like": _x(2, 3, 3, 4, seed=1)}, {}),
    "crop_begin_end": (_one("crop", begin=(0, 1, 1), end=(2, 3, 4)),
                       {"data": X}, {}),
    "element_mask": (_two("element_mask"),
                     {"lhs": X, "rhs": np.array([1.0, 0.0], np.float32)}, {}),
    "_crop_assign": (_two("_crop_assign", begin=(0, 1, 1), end=(2, 3, 3)),
                     {"lhs": X, "rhs": _x(2, 2, 2, seed=1)}, {}),
    "_CropAssign": (_two("_CropAssign", begin=(1, 0, 0), end=(2, 3, 2)),
                    {"lhs": X, "rhs": _x(1, 3, 2, seed=1)}, {}),
    "_crop_assign_scalar": (_one("_crop_assign_scalar", scalar=5.0,
                                 begin=(0, 1, 0), end=(1, 3, 2)),
                            {"data": X}, {}),
    "_CrossDeviceCopy": (_one("_CrossDeviceCopy"), {"data": X}, {}),
    "slice_axis": (_one("slice_axis", axis=1, begin=1, end=3), {"data": X},
                   {}),
    "slice_axis_neg": (_one("slice_axis", axis=-1, begin=0, end=2),
                       {"data": X}, {}),
    "Flip": (_one("Flip", axis=1), {"data": X}, {}),
    "flip_neg": (_one("flip", axis=-1), {"data": X}, {}),
    # reductions
    "sum_all": (_one("sum"), {"data": X}, {}),
    "sum_axis": (_one("sum_axis", axis=(1,)), {"data": X}, {}),
    "sum_keepdims": (_one("sum", axis=(0, 2), keepdims=True), {"data": X},
                     {}),
    "max_all": (_one("max"), {"data": X}, {}),
    "max_axis": (_one("max_axis", axis=(2,)), {"data": X}, {}),
    "min_axis": (_one("min", axis=(0, 1), keepdims=True), {"data": X}, {}),
    "min_all": (_one("min_axis"), {"data": X}, {}),
    # matrix
    "dot": (_two("dot"), {"lhs": _x(3, 4), "rhs": _x(4, 5, seed=1)},
            {"atol": 1e-5}),
    "dot_transpose": (_two("dot", transpose_a=True, transpose_b=True),
                      {"lhs": _x(4, 3), "rhs": _x(5, 4, seed=1)},
                      {"atol": 1e-5}),
    "dot_vec": (_two("dot"), {"lhs": _x(4), "rhs": _x(4, seed=1)},
                {"atol": 1e-5}),
    "dot_3d": (_two("dot"), {"lhs": _x(2, 3, 4), "rhs": _x(4, 5, seed=1)},
               {"atol": 1e-5}),
    "batch_dot": (_two("batch_dot"),
                  {"lhs": _x(2, 3, 4), "rhs": _x(2, 4, 5, seed=1)},
                  {"atol": 1e-5}),
    "batch_dot_transpose": (_two("batch_dot", transpose_a=True,
                                 transpose_b=True),
                            {"lhs": _x(2, 4, 3), "rhs": _x(2, 5, 4, seed=1)},
                            {"atol": 1e-5}),
    # gradient control
    "BlockGrad": (lambda pkg: _block_grad(pkg), {"data": X}, {}),
    "MakeLoss": (_one("MakeLoss", grad_scale=0.5), {"data": X}, {}),
    # nn
    "LeakyReLU_leaky": (_one("LeakyReLU", act_type="leaky", slope=0.1),
                        {"data": X}, {}),
    "LeakyReLU_elu": (_one("LeakyReLU", act_type="elu", slope=0.3),
                      {"data": X}, {}),
    "LeakyReLU_prelu": (lambda pkg: pkg.sym.LeakyReLU(
        pkg.sym.Variable("data"), pkg.sym.Variable("gamma"),
        act_type="prelu", name="op"),
        {"data": _x(2, 3, 4, 4), "gamma": _x(3, seed=1, lo=0.1, hi=0.5)},
        {}),
    "Deconvolution": (lambda pkg: pkg.sym.Deconvolution(
        pkg.sym.Variable("data"), pkg.sym.Variable("w"),
        pkg.sym.Variable("b"), kernel=(3, 3), num_filter=4, stride=(2, 2),
        pad=(1, 1), name="op"),
        {"data": _x(2, 3, 5, 5), "w": _x(3, 4, 3, 3, seed=1) * 0.3,
         "b": _x(4, seed=2)}, {"atol": 1e-5}),
    "Deconvolution_no_bias": (lambda pkg: pkg.sym.Deconvolution(
        pkg.sym.Variable("data"), pkg.sym.Variable("w"), kernel=(3, 3),
        num_filter=4, no_bias=True, name="op"),
        {"data": _x(2, 3, 5, 5), "w": _x(3, 4, 3, 3, seed=1) * 0.3},
        {"atol": 1e-5}),
    "Deconvolution_nhwc": (lambda pkg: pkg.sym.Deconvolution(
        pkg.sym.Variable("data"), pkg.sym.Variable("w"),
        pkg.sym.Variable("b"), kernel=(2, 2), num_filter=5, stride=(2, 2),
        layout="NHWC", name="op"),
        {"data": _x(2, 4, 4, 3), "w": _x(3, 5, 2, 2, seed=1) * 0.3,
         "b": _x(5, seed=2)}, {"atol": 1e-5}),
    "Deconvolution_1d": (lambda pkg: pkg.sym.Deconvolution(
        pkg.sym.Variable("data"), pkg.sym.Variable("w"), kernel=(3,),
        num_filter=2, stride=(2,), pad=(1,), no_bias=True, name="op"),
        {"data": _x(2, 3, 6), "w": _x(3, 2, 3, seed=1) * 0.3},
        {"atol": 1e-5}),
    "SoftmaxActivation": (_one("SoftmaxActivation"), {"data": _x(3, 5)}, {}),
    "SoftmaxActivation_channel": (_one("SoftmaxActivation", mode="channel"),
                                  {"data": _x(2, 4, 3, 3)}, {}),
    "SVMOutput_l2": (lambda pkg: pkg.sym.SVMOutput(
        pkg.sym.Variable("data"), pkg.sym.Variable("label"), margin=1.0,
        regularization_coefficient=0.5, name="op"),
        {"data": _x(4, 5), "label": np.array([0, 3, 1, 4], np.float32)},
        {}),
    "SVMOutput_l1": (lambda pkg: pkg.sym.SVMOutput(
        pkg.sym.Variable("data"), pkg.sym.Variable("label"), margin=0.5,
        use_linear=True, name="op"),
        {"data": _x(4, 5), "label": np.array([2, 0, 4, 1], np.float32)},
        {}),
    "Embedding": (lambda pkg: pkg.sym.Embedding(
        pkg.sym.Variable("data"), pkg.sym.Variable("w"), input_dim=5,
        output_dim=3, name="op"),
        {"data": np.array([[0, 4, 2], [2, 2, 1]], np.float32),
         "w": _x(5, 3)}, {}),
    "L2Normalization_instance": (_one("L2Normalization"),
                                 {"data": _x(2, 3, 4, 4)}, {}),
    "L2Normalization_channel": (_one("L2Normalization", mode="channel"),
                                {"data": _x(2, 3, 4, 4)}, {}),
    "L2Normalization_spatial": (_one("L2Normalization", mode="spatial"),
                                {"data": _x(2, 3, 4, 4)}, {}),
    "UpSampling_2": (_one("UpSampling", scale=2, sample_type="nearest",
                          num_args=1), {"data": _x(1, 2, 3, 3)}, {}),
    "UpSampling_3": (_one("UpSampling", scale=3, sample_type="nearest",
                          num_args=1), {"data": _x(1, 2, 3, 3)}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    build, args, tol = CASES[case]
    grad_names = [k for k in args if k != "label"]
    if case == "Embedding":
        grad_names = ["w"]
    want, got = both_fwd_bwd(build, args, grad_names)
    assert_parity(got, want, **tol)


@pytest.mark.parametrize("case", [
    # (source shape, shape, reverse, expected): the reference's cases
    ((2, 3, 5, 5), (0, -1), False, (2, 75)),
    ((2, 3, 5, 5), (0, 0, -1), False, (2, 3, 25)),
    ((5, 3, 4, 5), (0, -1, 0), False, (5, 15, 4)),
    ((2, 3, 5, 4), (-1, 0, 0), False, (8, 3, 5)),
    ((2, 3, 5, 5), (0, 0, 0, 0), False, (2, 3, 5, 5)),
    ((2, 4, 5, 3), (-1, 2, 2, 1), False, (30, 2, 2, 1)),
    ((2, 3, 5, 5), (0, -1), True, (5, 30)),
    ((2, 3, 5, 5), (0, 0, -1), True, (3, 5, 10)),
    ((5, 3, 4, 5), (0, -1, 0), True, (3, 20, 5)),
    ((2, 3, 5, 4), (-1, 0, 0), True, (6, 5, 4)),
    ((2, 3, 4, 5), (3, -1, 0), True, (3, 8, 5)),
    ((2, 3, 5, 5), (5, 3, 0, -1), True, (5, 3, 5, 2)),
    ((2, 3, 5, 5), (0, 0, 0, 0), True, (2, 3, 5, 5))])
def test_reshape_cases_match_jax(case):
    src, shape, reverse, dst = case
    net = tmx.sym.load_json(tmx.sym.Reshape(
        tmx.sym.Variable("data"), shape=shape, reverse=reverse).tojson())
    assert net.infer_shape(data=src)[1][0] == dst
    want, got = both_fwd_bwd(
        lambda pkg: pkg.sym.Reshape(pkg.sym.Variable("data"), shape=shape,
                                    reverse=reverse),
        {"data": _x(*src, seed=15)})
    assert_parity(got, want)


@pytest.mark.parametrize("groups", [1, 2])
def test_deconvolution_groups_match_a_per_group_reference(groups):
    """Grouped Deconvolution: the port against its own ungrouped op run
    on each group's channels (weight (C_in, F / G, kh, kw)); the JAX op
    at G = 1, and the shape rule of tests/test_operator_extra.py."""
    x = _x(2, 4, 5, 5)
    w = _x(4, 6 // groups, 3, 3, seed=1) * 0.3
    out = tmx.sym.Deconvolution(tmx.sym.Variable("data"),
                                tmx.sym.Variable("w"), kernel=(3, 3),
                                num_filter=6, stride=(2, 2), pad=(1, 1),
                                num_group=groups, no_bias=True)
    ctx = tmx.cpu()
    got = out.bind(ctx, {"data": tmx.nd.array(x, ctx=ctx),
                         "w": tmx.nd.array(w, ctx=ctx)}).forward()[0]
    cin, cout = 4 // groups, 6 // groups
    parts = []
    for g in range(groups):
        one = tmx.sym.Deconvolution(tmx.sym.Variable("data"),
                                    tmx.sym.Variable("w"), kernel=(3, 3),
                                    num_filter=cout, stride=(2, 2),
                                    pad=(1, 1), no_bias=True)
        parts.append(one.bind(ctx, {
            "data": tmx.nd.array(x[:, g * cin:(g + 1) * cin], ctx=ctx),
            "w": tmx.nd.array(w[g * cin:(g + 1) * cin], ctx=ctx)})
            .forward()[0].asnumpy())
    np.testing.assert_allclose(got.asnumpy(), np.concatenate(parts, 1),
                               rtol=1e-5, atol=1e-6)
    assert got.shape == (2, 6, 9, 9)
    if groups == 1:
        want = jmx.sym.Deconvolution(
            jmx.sym.Variable("data"), jmx.sym.Variable("w"), kernel=(3, 3),
            num_filter=6, stride=(2, 2), pad=(1, 1), no_bias=True).bind(
            jmx.cpu(), {"data": jmx.nd.array(x), "w": jmx.nd.array(w)})
        np.testing.assert_allclose(got.asnumpy(),
                                   want.forward()[0].asnumpy(),
                                   rtol=1e-5, atol=1e-5)
    for kernel, stride, pad in [((3, 3), (2, 2), (1, 1)),
                                ((5, 5), (1, 1), (2, 2))]:
        conv = tmx.sym.Convolution(tmx.sym.Variable("data"), kernel=kernel,
                                   stride=stride, pad=pad, num_filter=4)
        dc = tmx.sym.Deconvolution(conv, kernel=kernel, stride=stride,
                                   pad=pad, num_filter=3)
        assert dc.infer_shape(data=(2, 3, 9, 9))[1][0] == (2, 3, 9, 9)


def test_embedding_out_of_range_ids_match_jax():
    """Float ids truncate toward zero; id -1 reads the last row (as
    jnp.take) and an id >= input_dim or < -input_dim gives a NaN row
    without a device assert; their gradient rows are zero."""
    ids = np.array([[0.0, 4.7, -1.0], [5.0, -6.0, 2.0]], np.float32)
    want, got = both_fwd_bwd(
        lambda pkg: pkg.sym.Embedding(pkg.sym.Variable("data"),
                                      pkg.sym.Variable("w"), input_dim=5,
                                      output_dim=3),
        {"data": ids, "w": _x(5, 3)}, grad_names=["w"])
    out = got[0][0]
    assert np.isnan(out[1, 0]).all() and np.isnan(out[1, 1]).all()
    assert not np.isnan(out[0]).any() and not np.isnan(out[1, 2]).any()
    np.testing.assert_array_equal(out[0, 2], _x(5, 3)[4])
    assert_parity(got, want)


def test_identity_attach_kl_sparse_reg_matches_jax():
    """The KL penalty's gradient and the moving average aux state."""
    x = _x(4, 3, 2, 2, lo=0.05, hi=0.6)
    want, got = both_fwd_bwd(
        lambda pkg: pkg.sym.IdentityAttachKLSparseReg(
            pkg.sym.Variable("data"), sparseness_target=0.2, penalty=0.01,
            momentum=0.8, name="kl"),
        {"data": x}, aux={"kl_moving_avg": np.full(3, 0.3, np.float32)})
    assert_parity(got, want)
    assert not np.allclose(got[2]["kl_moving_avg"], 0.3)


def test_rrelu_draws_slopes_from_the_executor_generator():
    """rrelu in train mode: each negative element's slope is a draw from
    U(lower, upper) (checked by distribution), repeatable from the
    executor's seed; at inference the mean slope."""
    x = -np.ones((64, 64), np.float32)
    net = tmx.sym.LeakyReLU(tmx.sym.Variable("data"), act_type="rrelu",
                            lower_bound=0.1, upper_bound=0.3)
    assert net._outputs[0][0].op.draws_random
    ctx = tmx.cpu()

    def run(seed, is_train):
        ex = tmx.executor.Executor(net, ctx, [tmx.nd.array(x, ctx=ctx)],
                                   seed=seed)
        return -ex.forward(is_train=is_train)[0].asnumpy()

    a, b = run(3, True), run(3, True)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0.1 and a.max() <= 0.3
    assert abs(a.mean() - 0.2) < 0.005 and abs(a.std() - 0.2 / 12 ** 0.5) \
        < 0.005
    np.testing.assert_allclose(run(3, False), 0.2, rtol=1e-6)
    y = _x(2, 3, 4)
    jnet = jmx.sym.LeakyReLU(jmx.sym.Variable("data"), act_type="rrelu",
                             lower_bound=0.1, upper_bound=0.3)
    want = jnet.bind(jmx.cpu(), {"data": jmx.nd.array(y)}).forward()
    got = net.bind(ctx, {"data": tmx.nd.array(y, ctx=ctx)}).forward()
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_symbol_and_ndarray_functions_agree():
    """mx.sym.<name> exists for the names PR 10 made NDArray functions,
    and the registry's dot, clip and argmax_channel give the NDArray
    functions' results."""
    rng = np.random.RandomState(4)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(4, 2).astype(
        np.float32)
    ctx = tmx.cpu()
    A, B = tmx.nd.array(a, ctx=ctx), tmx.nd.array(b, ctx=ctx)
    for name in ("dot", "clip", "argmax_channel", "exp", "sum", "max",
                 "transpose", "square", "negative", "batch_dot"):
        assert callable(getattr(tmx.sym, name)), name
    dot = tmx.sym.dot(tmx.sym.Variable("a"), tmx.sym.Variable("b"))
    got = dot.bind(ctx, {"a": A, "b": B}).forward()[0].asnumpy()
    np.testing.assert_array_equal(got, tmx.nd.dot(A, B).asnumpy())
    clip = tmx.sym.clip(tmx.sym.Variable("a"), a_min=-0.3, a_max=0.4)
    np.testing.assert_array_equal(
        clip.bind(ctx, {"a": A}).forward()[0].asnumpy(),
        tmx.nd.clip(A, -0.3, 0.4).asnumpy())
    am = tmx.sym.argmax_channel(tmx.sym.Variable("a"))
    np.testing.assert_array_equal(
        am.bind(ctx, {"a": A}).forward()[0].asnumpy(),
        tmx.nd.argmax_channel(A).asnumpy())
    # the imperative op of a registry name ndarray does not define
    np.testing.assert_allclose(
        tmx.nd.Reshape(A, shape=(2, -1)).asnumpy(), a.reshape(2, 6))


def test_argmax_channel_and_cast_have_no_float_gradient():
    """argmax_channel's input gets a zero gradient (it has none); an
    integer Cast output takes no head gradient."""
    x = _x(3, 4)
    want, got = both_fwd_bwd(
        lambda pkg: pkg.sym.argmax_channel(pkg.sym.Variable("data")) * 2.0,
        {"data": x})
    assert_parity(got, want)
    assert not got[1]["data"].any()


# the reference names the port does not register yet: the Caffe plugin
# of ROADMAP.md Queue A item 13; a later slice may only shrink this set
NOT_YET_PORTED = {"caffeop", "caffeloss"}


def test_registry_resolves_every_reference_name_but_the_remainder():
    ref = set(jmx.ops.OP_REGISTRY.list_names())
    port = set(tmx.ops.OP_REGISTRY.list_names())
    assert port <= ref
    assert ref - port == NOT_YET_PORTED
    assert len(ref) == 117
    for _, cls in tmx.ops.OP_REGISTRY.items():
        for name in (cls.op_name,) + cls.op_aliases:
            assert callable(getattr(tmx.sym, name)), name
            assert callable(getattr(tmx.nd, name)), name
    # the snake-case aliases the JAX side pins (test_op_registry_parity.py)
    reg = tmx.ops.registry.get_operator_class
    for snake, camel in [("_plus_scalar", "_PlusScalar"),
                         ("_rdiv_scalar", "_RDivScalar"),
                         ("_rpower_scalar", "_RPowerScalar"),
                         ("_crop_assign", "_CropAssign"),
                         ("_crop_assign_scalar", "_CropAssignScalar"),
                         ("crop", "Crop"), ("flip", "Flip"),
                         ("sum_axis", "sum"), ("max_axis", "max"),
                         ("min_axis", "min"), ("CuDNNBatchNorm",
                                               "BatchNorm")]:
        assert reg(snake) is reg(camel), snake
